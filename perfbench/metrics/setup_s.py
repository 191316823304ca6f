"""Process start to the first timed call: imports, JAX's start, the data
from the seed, compilation or the compile cache, and the warm-up calls."""


def read(r):
    return r.setup_s
