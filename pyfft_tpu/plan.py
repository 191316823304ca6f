"""The ``Plan`` facade — the framework's public API.

Mirrors the reference's user surface (``pyfft/cuda.py`` / ``pyfft/cl.py``
``Plan`` and ``FFTPlan.execute`` — SURVEY.md §2.9-bis) while being a thin
stateful wrapper over pure jitted functions, the idiomatic JAX shape:

    plan = Plan((1024, 1024))            # validate once
    out  = plan.execute(data)            # jitted forward
    back = plan.execute(out, inverse=True)

Every transform is one XLA FFT op (``lax.fft``) over all of the plan's
axes, in the data's complex dtype.  On an NVIDIA GPU XLA lowers it to
cuFFT: C2C for complex64, Z2Z for complex128.  cuFFT computes in the
data's own precision, so no matrix-unit (TF32) rounding enters.

Differences from the reference, by design (JAX is functional):

* ``execute`` **returns** the transformed array instead of mutating a GPU
  buffer in place; ``data_out`` arguments are therefore not part of the API.
* ``stream=`` / ``queue=`` / ``context=`` are accepted for familiarity and
  only influence the async default (JAX dispatch is always async; the
  ``wait_for_finish`` semantics are preserved via ``Plan._wait``).

Split-complex mode follows the reference's dispatch-by-arity:
``plan.execute(re, im)`` takes and returns separate real/imag planes.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pyfft_tpu.planner import validate
from pyfft_tpu.utils.cache import enable_compile_cache

__all__ = ["Plan"]


class Plan:
    """Batched power-of-two complex FFT plan for 1D/2D/3D transforms.

    Parameters (reference parity — SURVEY.md §2.9-bis):
      shape: int or tuple of 1–3 ints, each a power of two.
      dtype: numpy.complex64 (default) or numpy.complex128.
      normalize: inverse transform scales by 1/(x*y*z) (default True).
      scale: extra user scale folded into both directions' output.
      fast_math: accepted for API familiarity with the reference, where it
        chose native over precise trigonometry.  cuFFT has no fast-math
        switch, so it changes nothing.
      wait_for_finish: default sync behavior of execute(); if None it is
        inferred — async when a stream/queue was supplied, sync otherwise.
      context/stream/queue: accepted for API familiarity (see module doc).
      donate: reuse input buffers for outputs (in-place memory behavior;
        device-array inputs are invalidated after the call).

    The first Plan also enables JAX's persistent compilation cache (see
    ``utils/cache.py``); set ``PYFFT_TPU_NO_CACHE=1`` to opt out of that
    global-config side effect.
    """

    def __init__(self, shape, dtype=np.complex64, *, normalize: bool = True,
                 scale: float = 1.0, fast_math: bool = True,
                 wait_for_finish: bool | None = None,
                 context: Any = None, stream: Any = None, queue: Any = None,
                 donate: bool = False):
        self.shape, self.dtype = validate(shape, dtype)
        self._real_dtype = np.float32 if self.dtype == np.complex64 else np.float64
        if self._real_dtype == np.float64 and not jax.config.jax_enable_x64:
            raise ValueError(
                "complex128 plans need float64 support: enable it with "
                "jax.config.update('jax_enable_x64', True)")
        self.normalize = bool(normalize)
        self.scale = float(scale)
        if wait_for_finish is None:
            wait_for_finish = stream is None and queue is None
        self.wait_for_finish = bool(wait_for_finish)
        # donate=True reuses input buffers for outputs (halves peak device
        # memory for huge transforms) — the analog of the reference's
        # in-place execute, which overwrote the input GPU buffer.
        self.donate = bool(donate)
        enable_compile_cache()
        self._jit_cache: dict = {}

    @property
    def total_n(self) -> int:
        return math.prod(self.shape)

    # ------------------------------------------------------------- executors

    def _build_callable(self, inverse: bool, split: str):
        fft_type = jax.lax.FftType.IFFT if inverse else jax.lax.FftType.FFT
        # lax.fft's IFFT already divides by N (numpy's convention); the rest
        # of the scaling is one multiply that XLA fuses into the
        # neighbouring conversion where there is one.
        factor = self.scale
        if inverse and not self.normalize:
            factor *= self.total_n

        def transform(x):
            y = jax.lax.fft(x, fft_type, self.shape)
            return y if factor == 1.0 else y * factor

        if split == "planar":
            def fn(re, im):
                y = transform(jax.lax.complex(re, im))
                return jnp.real(y), jnp.imag(y)
            donate = (0, 1)
        else:
            fn = transform
            donate = (0,)
        return jax.jit(fn, donate_argnums=donate if self.donate else ())

    def _get_callable(self, inverse: bool, split: str):
        """The jitted executable for one direction and storage mode
        (``split``: "planar" or "complex")."""
        key = (inverse, split)
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = self._jit_cache[key] = self._build_callable(inverse, split)
        return fn

    # ------------------------------------------------------------ data prep

    def _canonicalize(self, data, batch, planar: bool):
        """Reshape user data to (batch?, *shape); returns (array, unflatten)."""
        want_dtype = self._real_dtype if planar else self.dtype
        x = data if isinstance(data, jax.Array) else jnp.asarray(data)
        if x.dtype != want_dtype:
            x = x.astype(want_dtype)
        orig_shape = x.shape
        ndim = len(self.shape)
        if x.ndim >= ndim and x.shape[-ndim:] == self.shape:
            return x, orig_shape
        # flat buffer + batch, reference-style: execute(buf, batch=k)
        b = int(batch) if batch else 1
        if math.prod(x.shape) != b * self.total_n:
            raise ValueError(
                f"data of shape {orig_shape} does not match transform shape "
                f"{self.shape} with batch={b}")
        x = x.reshape((b,) + self.shape if b > 1 else self.shape)
        return x, orig_shape

    # -------------------------------------------------------------- execute

    def execute(self, data, data_imag=None, *, inverse: bool = False,
                batch: int | None = None, wait_for_finish: bool | None = None):
        """Run the transform.

        Interleaved mode: ``execute(x)`` with complex ``x`` → complex array.
        Split mode: ``execute(re, im)`` → ``(re, im)`` pair (dispatch by
        arity, as in the reference — SURVEY.md §3.4).
        ``batch=k`` accepts a flat buffer holding k contiguous transforms.
        """
        if data_imag is not None:
            re, re_shape = self._canonicalize(data, batch, planar=True)
            im, _ = self._canonicalize(data_imag, batch, planar=True)
            if re.shape != im.shape:
                raise ValueError("real/imag planes must have the same shape")
            out = self._get_callable(inverse, "planar")(re, im)
            if re.shape != re_shape:
                out = tuple(a.reshape(re_shape) for a in out)
        else:
            x, x_shape = self._canonicalize(data, batch, planar=False)
            out = self._get_callable(inverse, "complex")(x)
            if x.shape != x_shape:
                out = out.reshape(x_shape)
        wait = self.wait_for_finish if wait_for_finish is None else wait_for_finish
        if wait:
            self._wait(out)
        return out

    @staticmethod
    def _wait(out) -> None:
        """Block until the device has finished (the reference's
        ``wait_for_finish`` contract)."""
        jax.block_until_ready(out)

    # ------------------------------------------------------------- niceties

    def __repr__(self):
        return f"Plan(shape={self.shape}, dtype={self.dtype.name})"
