"""Functional convenience API over cached Plans.

The reference exposed only the Plan class; these wrappers
(``fft``/``ifft``/``fft2``/``fftn``) are the natural JAX-flavored surface on
top of it, with an internal plan cache so repeat shapes reuse traced
executables.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pyfft_tpu.plan import Plan

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "get_plan",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq"]

_PLAN_CACHE: dict = {}


def get_plan(shape, dtype=np.complex64, **kwargs) -> Plan:
    """Memoized ``Plan`` for the functional wrappers.

    The cache is unbounded by design: a Plan is a handful of Python
    objects plus its jitted executables, and FFT workloads reuse
    a small set of shapes (the reference likewise expected plans to be
    built once and reused — SURVEY.md §3.1 "hot spot").  Applications
    cycling through unbounded distinct shapes should construct ``Plan``
    directly and manage lifetimes themselves, or clear
    ``pyfft_tpu.api._PLAN_CACHE``.
    """
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    key = (tuple(shape), np.dtype(dtype).name, tuple(sorted(kwargs.items())))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = _PLAN_CACHE[key] = Plan(tuple(shape), dtype, **kwargs)
    return plan


def _transform(x, ndim, inverse, axes=None, **kwargs):
    x = np.asanyarray(x) if isinstance(x, (list, tuple)) else x
    moved = None
    if axes is not None:
        axes = (axes,) if isinstance(axes, int) else tuple(axes)
        for a in axes:
            if not -x.ndim <= a < x.ndim:
                raise ValueError(
                    f"axis {a} is out of bounds for array of dimension "
                    f"{x.ndim}")
        axes = tuple(a % x.ndim for a in axes)
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated axes {axes}")
        if ndim is not None and len(axes) != ndim:
            raise ValueError(f"axes should be of length {ndim}, "
                             f"got {axes}")
        ndim = len(axes)
        if not 1 <= ndim <= 3:
            raise ValueError(f"FFT rank must be 1..3, got axes {axes}")
        trailing = tuple(range(x.ndim - ndim, x.ndim))
        if axes != trailing:
            # transform arbitrary axes by moving them to the trailing
            # positions (XLA fuses/elides the transposes where it can)
            mover = np if isinstance(x, np.ndarray) else jnp
            x = mover.moveaxis(x, axes, trailing)
            moved = (trailing, axes)
    shape = tuple(x.shape[-ndim:])
    xdt = np.dtype(x.dtype)
    if xdt.kind == "c":
        dtype = x.dtype
    elif xdt == np.float64:
        # real f64 input keeps full precision through a complex128 plan
        # (previously this silently downcast to a complex64 plan)
        dtype = np.complex128
    else:
        dtype = np.complex64
    plan = get_plan(shape, dtype, **kwargs)
    out = plan.execute(x, inverse=inverse)
    if moved is not None:
        trailing, axes = moved
        out = jnp.moveaxis(out, trailing, axes)
    return out


def fft(x, axis: int = -1, **kw):
    """1D FFT over ``axis`` (power-of-two length; default last)."""
    return _transform(x, 1, False, axes=(axis,), **kw)


def ifft(x, axis: int = -1, **kw):
    return _transform(x, 1, True, axes=(axis,), **kw)


def fft2(x, axes=(-2, -1), **kw):
    """2D FFT over ``axes`` (default last two)."""
    return _transform(x, 2, False, axes=axes, **kw)


def ifft2(x, axes=(-2, -1), **kw):
    return _transform(x, 2, True, axes=axes, **kw)


def fftn(x, ndim=None, axes=None, **kw):
    """N-D FFT over ``axes`` (or the last ``ndim`` axes; default all, up
    to 3)."""
    if axes is None:
        nd = ndim if ndim is not None else min(x.ndim, 3)
        return _transform(x, nd, False, **kw)
    return _transform(x, ndim, False, axes=axes, **kw)


def ifftn(x, ndim=None, axes=None, **kw):
    if axes is None:
        nd = ndim if ndim is not None else min(x.ndim, 3)
        return _transform(x, nd, True, **kw)
    return _transform(x, ndim, True, axes=axes, **kw)


def fftshift(x, axes=None):
    """Shift the zero-frequency component to the center (numpy-compatible;
    works on numpy or JAX arrays without a host round trip)."""
    mover = np if isinstance(x, np.ndarray) else jnp
    return mover.fft.fftshift(x, axes=axes)


def ifftshift(x, axes=None):
    mover = np if isinstance(x, np.ndarray) else jnp
    return mover.fft.ifftshift(x, axes=axes)


def fftfreq(n, d=1.0):
    """Sample frequencies for a length-n transform (numpy-compatible
    layout, returned as a JAX array so it composes into jitted pipelines;
    ``np.asarray`` it for a host copy)."""
    return jnp.fft.fftfreq(n, d)


def rfftfreq(n, d=1.0):
    """Sample frequencies for a length-n real transform (JAX array)."""
    return jnp.fft.rfftfreq(n, d)
