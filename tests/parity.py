"""Shared check for the Plan parity matrices: one Plan call against
numpy.fft in complex128."""

import numpy as np

from pyfft_tpu import Plan

from helpers import TOL, rand_complex, rel_err


def check_plan_parity(shape, dtype, split: bool, inverse: bool,
                      batch: int = 2, seed: int = 0) -> None:
    x = rand_complex((batch,) + tuple(shape), dtype, seed=seed)
    plan = Plan(shape, dtype)
    if split:
        real_dt = np.float32 if dtype == np.complex64 else np.float64
        rr, ii = plan.execute(x.real.astype(real_dt), x.imag.astype(real_dt),
                              inverse=inverse)
        assert rr.dtype == real_dt and ii.dtype == real_dt
        got = np.asarray(rr) + 1j * np.asarray(ii)
    else:
        out = plan.execute(x, inverse=inverse)
        assert out.dtype == dtype
        got = np.asarray(out)
    assert got.shape == x.shape
    axes = tuple(range(1, 1 + len(shape)))
    op = np.fft.ifftn if inverse else np.fft.fftn
    ref = op(x.astype(np.complex128), axes=axes)
    assert rel_err(got, ref) < TOL[dtype]
