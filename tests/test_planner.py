"""Plan validation (pyfft_tpu.planner.validate): pure functions, no
devices touched."""

import numpy as np
import pytest

from pyfft_tpu.planner import validate


@pytest.mark.parametrize("shape,want", [
    (1024, (1024,)),
    (np.int64(8), (8,)),
    ([16, 32], (16, 32)),
    ((2, 4, 8), (2, 4, 8)),
    ((1,), (1,)),
])
def test_shape_normalised(shape, want):
    got, dtype = validate(shape, np.complex64)
    assert got == want and all(type(s) is int for s in got)
    assert dtype == np.dtype(np.complex64)


@pytest.mark.parametrize("shape", [(), (2, 2, 2, 2), (24,), (16, 24), (0,),
                                   (-4,)])
def test_bad_shape_raises(shape):
    with pytest.raises(ValueError):
        validate(shape, np.complex64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   "complex256" if hasattr(np, "complex256")
                                   else np.bool_])
def test_bad_dtype_raises(dtype):
    with pytest.raises(ValueError):
        validate((16,), dtype)


def test_complex128_accepted():
    assert validate((16,), "complex128")[1] == np.dtype(np.complex128)
