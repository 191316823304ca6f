"""The least time one chip could take for its share of a call (the larger
of one read and one write of the complex data over peak bandwidth, and
5·N·log2(N)·batch over the vector peak; work.py) over the call's device
time (``exe_device_us``), in percent.  It reads the transform's own work,
whatever kernels implement it."""

from perfbench.metrics import exe_device_us


def read(r):
    device_us = exe_device_us.read(r)
    if device_us is None:
        return None
    return 100.0 * r.least_s_per_call * 1e6 / device_us
