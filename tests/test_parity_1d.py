"""1D Plan parity matrix: n = 2^1..2^14 x {c64, c128} x {interleaved,
split} x {forward, inverse}, each against numpy.fft in complex128."""

import numpy as np
import pytest

from parity import check_plan_parity


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("split", [False, True], ids=["interleaved", "split"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("p", range(1, 15))
def test_plan_1d_parity(p, dtype, split, inverse):
    check_plan_parity((1 << p,), dtype, split, inverse, seed=p)
