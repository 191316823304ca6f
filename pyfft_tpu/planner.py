"""Plan validation: the transform shape and dtype a ``Plan`` accepts.

The reference decided at plan time, per axis, between a shared-memory
kernel and a chain of global radix passes (``pyfft/plan.py`` +
``pyfft/kernel.py`` — SURVEY.md §2.2/§2.3/§3.1).  Here every transform is
one XLA FFT op over all of the plan's axes, and on an NVIDIA GPU XLA hands
it to cuFFT, which makes that same decision itself.  What is left at plan
time is checking that the request is one this library supports.
"""

from __future__ import annotations

import numpy as np

from pyfft_tpu.utils.radix import is_power_of_two

__all__ = ["validate"]

_DTYPES = (np.dtype(np.complex64), np.dtype(np.complex128))


def validate(shape, dtype) -> tuple[tuple[int, ...], np.dtype]:
    """Normalise ``shape`` and ``dtype``; raise ValueError if unsupported.

    Supported: rank 1-3, every axis a power of two, complex64 or
    complex128 (the reference's scope, SURVEY.md §2.9-bis).
    """
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"FFT rank must be 1..3, got shape {shape}")
    for s in shape:
        if not is_power_of_two(s):
            raise ValueError(f"transform size {s} is not a power of two")
    dtype = np.dtype(dtype)
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be complex64 or complex128, got {dtype}")
    return shape, dtype
