"""The plain discrete Fourier transform: one dense matrix product per axis.

    X[k] = sum_j x[j] · exp(∓2πi·j·k/n)         (inverse: +, and 1/n)

over each of the last ``rank`` axes in turn, on (re, im) planes.  The
matrix entries come from the exact integer j·k mod n, so each is as near
the true root of unity as the mode's precision allows.  No FFT and no
library transform: this shares nothing with cuFFT or with the program.

Modes:
    f64     float64 planes and matrix: the reference (error ~1e-15).
    bf16x3  float32 planes and matrix, each product computed as
            hi·hi + hi·lo + lo·hi of bfloat16 halves, summed in float32:
            the three-pass ("high") matrix product that stands one
            precision step below the configurations' float32 at highest.
            Products of bfloat16 values are exact in float32, so float32
            matrix products at HIGHEST compute each pass exactly.

The dense matrix holds n² entries, so one axis may have at most
``MAX_AXIS`` points.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_AXIS = 8192
_HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("inverse", "dtype"))
def _matrix(j, inverse: bool, dtype):
    """(re, im) planes of the n-point DFT matrix (n = len(j), j = 0..n-1),
    with the inverse's 1/n.  ``j`` is an argument, so that the compiler
    cannot fold an n² constant into the program."""
    n = j.shape[0]
    phase = ((j[:, None] * j[None, :]) % n).astype(dtype) * (2.0 * np.pi / n)
    sign, scale = (1.0, 1.0 / n) if inverse else (-1.0, 1.0)
    return jnp.cos(phase) * scale, sign * jnp.sin(phase) * scale


def _bf16(a):
    """``a`` rounded to bfloat16 (nearest, ties to even), kept in float32.
    Done on the bits: a compiler may drop a float32 -> bfloat16 -> float32
    round trip as excess precision (XLA on GPUs does)."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & 1)) & np.uint32(
        0xFFFF0000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _split(a):
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def _matmul_f64(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


def _matmul_bf16x3(a, b):
    (ah, al), (bh, bl) = _split(a), _split(b)
    mm = functools.partial(jnp.matmul, precision=_HIGHEST)
    return mm(ah, bh) + mm(ah, bl) + mm(al, bh)


_MODES = {"f64": (jnp.float64, _matmul_f64),
          "bf16x3": (jnp.float32, _matmul_bf16x3)}


@functools.partial(jax.jit, static_argnames=("axis", "mode"))
def _axis(re, im, wr, wi, axis: int, mode: str):
    dtype, mm = _MODES[mode]
    xr = jnp.moveaxis(re.astype(dtype), axis, -1)
    xi = jnp.moveaxis(im.astype(dtype), axis, -1)
    yr = mm(xr, wr) - mm(xi, wi)            # the matrix is symmetric
    yi = mm(xr, wi) + mm(xi, wr)
    return jnp.moveaxis(yr, -1, axis), jnp.moveaxis(yi, -1, axis)


def transform(re, im, rank: int, inverse: bool, mode: str):
    """The DFT over the last ``rank`` axes of (re, im) planes.  ``mode``
    "f64" needs 64-bit types enabled (``jax.enable_x64``)."""
    dtype = _MODES[mode][0]
    for axis in range(re.ndim - rank, re.ndim):
        n = re.shape[axis]
        if n > MAX_AXIS:
            raise ValueError(f"a dense DFT axis of {n} points is over "
                             f"{MAX_AXIS}")
        wr, wi = _matrix(jnp.arange(n, dtype=jnp.int32), inverse, dtype)
        re, im = _axis(re, im, wr, wi, axis, mode)
    return re, im
