"""2D/3D Plan parity matrix, and the normalisation, scale and batch forms
of execute, each against numpy.fft in complex128."""

import numpy as np
import pytest

from pyfft_tpu import Plan

from helpers import TOL, rand_complex, rel_err
from parity import check_plan_parity

SHAPES = [(2, 4), (16, 16), (64, 128), (256, 32), (4, 8, 16), (16, 16, 16),
          (32, 8, 64)]


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("split", [False, True], ids=["interleaved", "split"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_nd_parity(shape, dtype, split, inverse):
    check_plan_parity(shape, dtype, split, inverse, seed=sum(shape))


@pytest.mark.parametrize("form", ["flat_batch3", "lead_2x3"])
@pytest.mark.parametrize("scale", [1.0, 0.25])
@pytest.mark.parametrize("normalize", [True, False])
def test_normalize_scale_batch_forms(normalize, scale, form):
    """Forward and inverse under every normalize/scale pair, for a flat
    buffer with batch=3 and for leading dims (2, 3)."""
    n = 64
    lead = (3,) if form == "flat_batch3" else (2, 3)
    x = rand_complex(lead + (n,), seed=int(scale * 8) + normalize)
    plan = Plan((n,), normalize=normalize, scale=scale)
    if form == "flat_batch3":
        fwd = plan.execute(x.reshape(-1), batch=3)
        inv = plan.execute(x.reshape(-1), batch=3, inverse=True)
        assert fwd.shape == inv.shape == (3 * n,)
        fwd, inv = (np.asarray(a).reshape(x.shape) for a in (fwd, inv))
    else:
        fwd = np.asarray(plan.execute(x))
        inv = np.asarray(plan.execute(x, inverse=True))
        assert fwd.shape == inv.shape == x.shape
    xd = x.astype(np.complex128)
    want_inv = np.fft.ifft(xd, axis=-1) * (1.0 if normalize else n)
    assert rel_err(fwd, scale * np.fft.fft(xd, axis=-1)) < TOL[np.complex64]
    assert rel_err(inv, scale * want_inv) < TOL[np.complex64]
