"""Planar (split re/im) matmul-form FFT in pure ``jax.numpy``.

This is the framework's plain reference (SURVEY.md §7 ``reference.py``): a
certain-by-construction implementation that shares no code with the
``Plan`` path (which is one XLA FFT op) and runs on every JAX backend and
float dtype (f32, f64 under x64).  It is

* an independent oracle the ``Plan`` path is cross-checked against in the
  tests and, at full size on the card, in ``chip_smoke.py``, and
* the einsum chain the ``Plan`` path is timed against there.

Design: a length-n transform along any axis is a **mixed-radix chain of
einsum contractions**: with the axis reshaped to factors (f_1, ..., f_m),
stage i contracts factor i against the f_i-point DFT matrix and moves the
new spectral digit to the front of the factor block,

    x[..., k_{i-1}, ..., k_1, j_i, rest...]
      -> sum_j W_fi[k_i, j_i] * x[...]        (einsum)
      -> * twiddle[k_i, rest]                 (broadcast)

so after m stages the factor block reads (k_m, ..., k_1) — exactly the DFT
output digit order: no bit-reversal permutation and no explicit transpose.
Every contraction runs at ``Precision.HIGHEST`` by default, so a float32
product is never rounded to TF32 on a GPU.

Everything is planar: complex z is carried as (Re z, Im z) float arrays and
a complex contraction is 4 real einsums.
"""

from __future__ import annotations

import functools
import string
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

from pyfft_tpu.ops.twiddle import dft_matrix, twiddle_table
from pyfft_tpu.utils.radix import is_power_of_two

__all__ = ["fft_planar", "fftn_planar", "DEFAULT_BASE"]

# Largest DFT factor contracted in one einsum.
DEFAULT_BASE = 128

Array = jax.Array


def _factorize(n: int, base: int) -> tuple[int, ...]:
    """Split n into balanced power-of-two factors, each <= base."""
    if n <= base:
        return (n,)
    p = n.bit_length() - 1
    pb = base.bit_length() - 1
    m = -(-p // pb)
    q, r = divmod(p, m)
    return tuple(1 << (q + (1 if i < r else 0)) for i in range(m))


@functools.lru_cache(maxsize=None)
def _consts(kind: str, *args) -> tuple[np.ndarray, np.ndarray]:
    if kind == "dft":
        return dft_matrix(*args)
    return twiddle_table(*args)


def _cmul_tables(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _fft_factors(re: Array, im: Array, lead: int, factors: tuple[int, ...],
                 trail: int, sign: int, precision) -> tuple[Array, Array]:
    """DFT over the factor block of (lead..., f_1, ..., f_m, trail...).

    ``lead``/``trail`` are the number of leading/trailing spectator dims.
    """
    dt = np.dtype(re.dtype)
    m = len(factors)
    letters = string.ascii_lowercase
    for i, f in enumerate(factors):
        # axes: [lead] + [k_{i-1}..k_1] (i-1 of them) + [j_i] + rest + [trail]
        ndim = re.ndim
        pos = lead + i                       # position of the j_i axis
        spec = letters[:ndim]
        j = spec[pos]
        rest = spec[:pos] + spec[pos + 1:]
        out = spec[:lead] + "z" + spec[lead:pos] + spec[pos + 1:]
        eq = f"z{j},{spec}->{out}"
        wr, wi = _consts("dft", f, sign, dt.name)
        wr = jnp.asarray(wr)
        wi = jnp.asarray(wi)
        es = functools.partial(jnp.einsum, eq, precision=precision)
        re, im = (es(wr, re) - es(wi, im), es(wr, im) + es(wi, re))
        if i < m - 1:
            rest_n = 1
            for g in factors[i + 1:]:
                rest_n *= g
            tr, ti = _consts("tw", f, rest_n, f * rest_n, sign, dt.name)
            shape = (f,) + (1,) * i + tuple(factors[i + 1:]) + (1,) * trail
            tr = jnp.asarray(tr).reshape(shape)
            ti = jnp.asarray(ti).reshape(shape)
            re, im = _cmul_tables(re, im, tr, ti)
    return re, im


def fft_planar(re: Array, im: Array, sign: Literal[-1, 1], axis: int = -1,
               base: int = DEFAULT_BASE,
               precision=jax.lax.Precision.HIGHEST) -> tuple[Array, Array]:
    """Unnormalized DFT of a planar complex array along ``axis``.

    sign=-1 is the forward transform, sign=+1 the inverse kernel (the caller
    applies 1/N normalization per the reference's semantics, SURVEY.md
    §2.9-bis).
    """
    n = re.shape[axis]
    if not is_power_of_two(n):
        raise ValueError(f"transform length {n} is not a power of two")
    if re.shape != im.shape:
        raise ValueError("re/im shape mismatch")
    if n == 1:
        return re, im
    axis = axis % re.ndim
    factors = _factorize(n, base)
    lead_shape = re.shape[:axis]
    trail_shape = re.shape[axis + 1:]
    new_shape = lead_shape + factors + trail_shape
    re = re.reshape(new_shape)
    im = im.reshape(new_shape)
    re, im = _fft_factors(re, im, len(lead_shape), factors, len(trail_shape),
                          sign, precision)
    out_shape = lead_shape + (n,) + trail_shape
    return re.reshape(out_shape), im.reshape(out_shape)


def fftn_planar(re: Array, im: Array, sign: Literal[-1, 1],
                axes: tuple[int, ...],
                base: int = DEFAULT_BASE,
                precision=jax.lax.Precision.HIGHEST) -> tuple[Array, Array]:
    """Unnormalized multi-axis DFT (separable: one pass per axis)."""
    for ax in axes:
        re, im = fft_planar(re, im, sign, axis=ax, base=base, precision=precision)
    return re, im
