"""Persistent compilation cache + plan warmup.

The reference's plans compiled at plan time (nvcc on a kernel string —
SURVEY.md §3.1 "hot spot"); here XLA compiles each executable on its first
call.  Two remedies keep that off the hot path:

* ``enable_compile_cache()`` — turns on JAX's persistent compilation cache
  so an executable is compiled once per cache directory, not once per
  process.  Called automatically by the first ``Plan`` (opt out with
  ``PYFFT_TPU_NO_CACHE=1``).  The directory is ``JAX_COMPILATION_CACHE_DIR``
  when that is set, else one the host application configured first, else
  ``.jax_cache/`` at the root of this checkout — a fixed path, because the
  path is part of what makes a later process find the entries again.
* ``warmup(shapes, ...)`` — precompiles the executables for given transform
  shapes (both directions) so first real ``execute`` calls are instant;
  run it once at deploy time to populate the cache.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "warmup", "DEFAULT_DIR"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

_enabled = False


def enable_compile_cache(path: str | None = None) -> str | None:
    """Enable JAX's persistent compilation cache (idempotent).

    Returns the cache directory in use, or None if caching was declined
    (``PYFFT_TPU_NO_CACHE`` is set).  ``JAX_COMPILATION_CACHE_DIR`` wins
    over everything, ``path`` included; a directory the host application
    configured first is respected.

    Only the directory is set: JAX's default thresholds (min compile time
    ~1 s) keep the host application's cheap compiles out of the cache.
    """
    global _enabled
    if _enabled:
        return jax.config.jax_compilation_cache_dir
    if os.environ.get("PYFFT_TPU_NO_CACHE"):
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    elif jax.config.jax_compilation_cache_dir:
        path = jax.config.jax_compilation_cache_dir
    else:
        path = path or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    _enabled = True
    return path


def warmup(shapes, dtypes=("complex64",), batches=(1,),
           inverse_too: bool = True) -> int:
    """Precompile plan executables for the given transform shapes.

    ``shapes``: iterable of ints or tuples (as accepted by ``Plan``).
    ``batches``: leading batch sizes to compile (the batch shape is part
    of the executable's key).
    Returns the number of executables compiled.
    """
    import numpy as np

    from pyfft_tpu.plan import Plan

    enable_compile_cache()
    count = 0
    for shape in shapes:
        if isinstance(shape, int):
            shape = (shape,)
        for dt in dtypes:
            dtype = np.dtype(dt)
            plan = Plan(shape, dtype=dtype)
            real = np.float32 if dtype == np.dtype("complex64") else np.float64
            for b in batches:
                lead = (b,) if b and b > 1 else ()
                ex = jax.ShapeDtypeStruct(lead + tuple(shape), real)
                dirs = (False, True) if inverse_too else (False,)
                for inv in dirs:
                    fn = plan._get_callable(inv, "planar")
                    fn.lower(ex, ex).compile()   # fn is already jitted (AOT)
                    count += 1
    return count
