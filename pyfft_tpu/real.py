"""Real-to-complex transforms (rfft family) — beyond the reference's scope.

The reference handled complex transforms only (SURVEY.md non-goals); these
wrappers add the classic half-size trick on top of the existing complex
machinery: a length-n real FFT runs as one length-n/2 complex FFT (through
a cached ``Plan``, i.e. one XLA FFT op) plus an elementwise planar untangle
that XLA fuses into a single extra pass.

    X[k] = E[k] + w_n^k * O[k],            k = 0..n/2
    E[k] = (Z[k] + conj(Z[-k])) / 2        (FFT of even samples)
    O[k] = (Z[k] - conj(Z[-k])) / (2i)     (FFT of odd samples)

with Z the n/2-point FFT of z[t] = x[2t] + i*x[2t+1].  The untangle works
on planar (re, im) float pairs; complex arrays appear only at the API
boundary.

Device residency and jit composability: the ``*_planar`` forms take and
return JAX arrays and are pure traceable functions — they compose under
``jax.jit`` with no host round trips.  The complex-returning wrappers
(`rfft`, `rfftn`, ...) assemble a complex JAX array on the device.

N-D: ``rfft2``/``rfftn`` run the real trick over the LAST axis and plain
complex (planar) FFTs over the leading transform axes — the same axis
factorization as ``numpy.fft.rfftn`` (transforms over distinct axes
commute), so results match numpy's layout exactly.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from pyfft_tpu.utils.radix import is_power_of_two

__all__ = ["rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
           "rfft_planar", "irfft_planar", "rfftn_planar", "irfftn_planar"]

# Plan kwargs safe to forward to the internal half-size complex plan.
# normalize=False or scale=... would silently break the rfft/irfft
# untangle algebra (irfft relies on the inverse's exact 1/m factor), so
# they are rejected rather than forwarded (ADVICE r2).
_ALLOWED_KW = frozenset({"fast_math"})


def _check_kw(kw: dict) -> dict:
    bad = sorted(set(kw) - _ALLOWED_KW)
    if bad:
        raise ValueError(
            f"rfft/irfft do not accept plan kwargs {bad}: only "
            f"{sorted(_ALLOWED_KW)} are forwarded (normalize/scale would "
            f"break the half-size untangle algebra)")
    # internal plans never block mid-pipeline: the public wrappers stay
    # traceable, and the caller syncs on the final output if they need to
    return dict(kw, wait_for_finish=False)


@functools.lru_cache(maxsize=None)
def _half_twiddle(n: int, sign: int):
    """(wr, wi) of w_n^(sign*k) for k = 0..n/2, f64-exact then rounded."""
    k = np.arange(n // 2 + 1, dtype=np.int64)
    theta = sign * 2.0 * np.pi * k / n
    return (np.cos(theta).astype(np.float32),
            np.sin(theta).astype(np.float32))


def _get_plan(m: int, **kw):
    from pyfft_tpu.api import get_plan
    return get_plan((m,), np.complex64, **kw)


def _fft_axis_planar(xr, xi, axis: int, inverse: bool, kw: dict):
    """Planar complex FFT over one (power-of-two) axis via a cached Plan."""
    axis = axis % xr.ndim
    if axis != xr.ndim - 1:
        xr = jnp.moveaxis(xr, axis, -1)
        xi = jnp.moveaxis(xi, axis, -1)
    plan = _get_plan(xr.shape[-1], **kw)
    xr, xi = plan.execute(xr, xi, inverse=inverse)
    if axis != xr.ndim - 1:
        xr = jnp.moveaxis(xr, -1, axis)
        xi = jnp.moveaxis(xi, -1, axis)
    return xr, xi


# --------------------------------------------------------------------- 1D


def rfft_planar(x, **kw):
    """Planar rfft: real (..., n) -> ((..., n//2+1) re, im) JAX arrays.

    Pure traceable function (composes under jax.jit, no host transfers);
    the planar form of :func:`rfft`.
    """
    kw = _check_kw(kw)
    x = jnp.asarray(x)
    n = x.shape[-1]
    if not (is_power_of_two(n) and n >= 4):
        raise ValueError(f"rfft length must be a power of two >= 4, got {n}")
    m = n // 2
    x = x.astype(jnp.float32)
    ze = x[..., 0::2]
    zo = x[..., 1::2]
    plan = _get_plan(m, **kw)
    zr, zi = plan.execute(ze, zo)          # split mode: planar in/out

    # Z[-k] with wraparound: index (m - k) % m for k = 0..m
    idx = (-jnp.arange(m + 1)) % m
    zr_e = jnp.concatenate([zr, zr[..., :1]], axis=-1)   # Z[k], k=0..m
    zi_e = jnp.concatenate([zi, zi[..., :1]], axis=-1)
    vr = jnp.take(zr, idx, axis=-1)                       # Re Z[-k]
    vi = -jnp.take(zi, idx, axis=-1)                      # Im conj(Z[-k])
    er = 0.5 * (zr_e + vr)
    ei = 0.5 * (zi_e + vi)
    onr = 0.5 * (zi_e - vi)                # O = (Z - conj(Z[-k]))/(2i)
    oni = -0.5 * (zr_e - vr)
    wr, wi = (jnp.asarray(t) for t in _half_twiddle(n, -1))
    return er + wr * onr - wi * oni, ei + wr * oni + wi * onr


def irfft_planar(xr, xi, n: int | None = None, **kw):
    """Planar irfft: half-spectrum planes (..., n//2+1) -> real (..., n).

    Pure traceable function; inverse of :func:`rfft_planar`.
    """
    kw = _check_kw(kw)
    xr = jnp.asarray(xr, jnp.float32)
    xi = jnp.asarray(xi, jnp.float32)
    if n is None:
        n = 2 * (xr.shape[-1] - 1)
    if not (is_power_of_two(n) and n >= 4) or xr.shape[-1] != n // 2 + 1:
        raise ValueError(
            f"irfft needs a (..., n//2+1) half-spectrum with n a power of "
            f"two >= 4; got {xr.shape[-1]} columns for n={n}")
    m = n // 2

    # E[k] = (X[k] + conj(X[m-k]))/2, O[k] = w_n^{-k} (X[k] - conj(X[m-k]))/2
    rev_r = xr[..., ::-1]                  # X[m-k] for k=0..m
    rev_i = xi[..., ::-1]
    er = 0.5 * (xr + rev_r)
    ei = 0.5 * (xi - rev_i)
    dr = 0.5 * (xr - rev_r)
    di = 0.5 * (xi + rev_i)
    wr, wi = (jnp.asarray(t) for t in _half_twiddle(n, +1))
    onr = wr * dr - wi * di
    oni = wr * di + wi * dr
    # z spectrum: Z[k] = E[k] + i O[k], k = 0..m-1
    zr = (er + -oni)[..., :m]              # Re(E + iO) = Er - Oi
    zi = (ei + onr)[..., :m]               # Im(E + iO) = Ei + Or
    plan = _get_plan(m, **kw)
    br, bi = plan.execute(zr, zi, inverse=True)   # 1/m normalized
    return jnp.stack([br, bi], axis=-1).reshape(*br.shape[:-1], n)


def rfft(x, **kw):
    """FFT of a real array over its last axis (power-of-two length >= 4).

    Returns the complex half-spectrum of length n//2 + 1 (numpy.fft.rfft
    layout) as a complex64 JAX array; :func:`rfft_planar` is the planar
    form.
    """
    xr, xi = rfft_planar(x, **kw)
    return jax.lax.complex(xr, xi)


def _split_complex(X):
    """Complex input -> planar (re, im) float32 JAX planes."""
    X = jnp.asarray(X)
    return jnp.real(X).astype(jnp.float32), jnp.imag(X).astype(jnp.float32)


def irfft(X, n: int | None = None, **kw):
    """Inverse of :func:`rfft`: half-spectrum (..., n//2+1) -> real (..., n).

    Returns a real JAX array.
    """
    xr, xi = _split_complex(X)
    return irfft_planar(xr, xi, n, **kw)


# --------------------------------------------------------------------- N-D


def rfftn_planar(x, ndim: int | None = None, **kw):
    """Planar N-D real FFT over the last ``ndim`` axes (default: all, up
    to 3).  Real trick on the last axis, complex FFTs over the rest."""
    x = jnp.asarray(x)
    nd = ndim if ndim is not None else min(x.ndim, 3)
    if not 1 <= nd <= min(x.ndim, 3):
        raise ValueError(f"rfftn rank must be 1..3 within the array rank, "
                         f"got ndim={nd} for shape {x.shape}")
    xr, xi = rfft_planar(x, **kw)
    fkw = _check_kw(kw)
    for ax in range(x.ndim - nd, x.ndim - 1):
        xr, xi = _fft_axis_planar(xr, xi, ax, False, fkw)
    return xr, xi


def irfftn_planar(xr, xi, ndim: int | None = None, n: int | None = None,
                  **kw):
    """Planar inverse of :func:`rfftn_planar` (real output)."""
    xr = jnp.asarray(xr, jnp.float32)
    xi = jnp.asarray(xi, jnp.float32)
    nd = ndim if ndim is not None else min(xr.ndim, 3)
    if not 1 <= nd <= min(xr.ndim, 3):
        raise ValueError(f"irfftn rank must be 1..3 within the array rank, "
                         f"got ndim={nd} for shape {xr.shape}")
    fkw = _check_kw(kw)
    for ax in range(xr.ndim - nd, xr.ndim - 1):
        xr, xi = _fft_axis_planar(xr, xi, ax, True, fkw)   # 1/n per axis
    return irfft_planar(xr, xi, n, **kw)


def rfftn(x, ndim: int | None = None, **kw):
    """N-D FFT of a real array (numpy.fft.rfftn layout over the last
    ``ndim`` axes; every transform length a power of two)."""
    xr, xi = rfftn_planar(x, ndim, **kw)
    return jax.lax.complex(xr, xi)


def irfftn(X, ndim: int | None = None, n: int | None = None, **kw):
    """Inverse of :func:`rfftn`: half-spectrum -> real array (JAX)."""
    xr, xi = _split_complex(X)
    return irfftn_planar(xr, xi, ndim, n, **kw)


def rfft2(x, **kw):
    """2D FFT of a real array over its last two axes (rfftn with ndim=2)."""
    return rfftn(x, 2, **kw)


def irfft2(X, n: int | None = None, **kw):
    """Inverse of :func:`rfft2`."""
    return irfftn(X, 2, n, **kw)
