"""Twiddle-factor and DFT-matrix tables.

Host-computed replacement for the reference's in-kernel twiddle generation
(``pyfft/kernels.mako``: ``complexMul`` + ``sincos``-based twiddles,
SURVEY.md §2.5), used by the plain einsum reference (``reference.py``) and
the cross-device DFT of ``parallel/dist.py``.

All tables are computed on the host in float64 with exact integer phase
reduction (j*k mod n is exact in int64 for every n this library accepts),
then rounded *once* to the target dtype — this is what keeps deep multi-stage
chains inside the ~1e-6 (c64) / ~1e-12 (c128) parity gates (SURVEY.md §6).

Everything here returns *planar* (real, imag) float pairs, the form the
einsum reference works in.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["dft_matrix", "twiddle_table", "FORWARD", "INVERSE"]

FORWARD = -1
INVERSE = +1


@functools.lru_cache(maxsize=None)
def _phase_table(rows: int, cols: int, n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of sign*2*pi*(r*c mod n)/n as float64 (rows, cols) arrays."""
    r = np.arange(rows, dtype=np.int64)[:, None]
    c = np.arange(cols, dtype=np.int64)[None, :]
    k = (r * c) % n  # exact: rows*cols <= 2**44 << 2**53
    theta = (2.0 * np.pi / n) * k.astype(np.float64)
    if sign < 0:
        theta = -theta
    return np.cos(theta), np.sin(theta)


def dft_matrix(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Planar DFT matrix W[j, k] = exp(sign * 2*pi*i * j*k / n).

    Contracting an (..., n) planar signal against this matrix along its first
    axis computes the length-n DFT:  X[k] = sum_j x[j] * W[j, k].
    """
    wr, wi = _phase_table(n, n, n, sign)
    return wr.astype(dtype), wi.astype(dtype)


def twiddle_table(rows: int, cols: int, n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Planar twiddle table T[a, b] = exp(sign * 2*pi*i * a*b / n).

    Used between the two half-size transforms of a four-step level
    (the analog of the reference's per-pass twiddle multiply in the
    generated global kernels, SURVEY.md §3.3).
    """
    tr, ti = _phase_table(rows, cols, n, sign)
    return tr.astype(dtype), ti.astype(dtype)
