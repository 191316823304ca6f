import math

import numpy as np
import pytest

from perfbench import work


@pytest.mark.parametrize("shape,batch,want", [
    ((4096,), 16384, 5 * 4096 * 12 * 16384),
    ((256, 256, 256), 4, 5 * 2 ** 24 * 24 * 4),
    ((512, 512, 512), 2, 5 * 2 ** 27 * 27 * 2),
    ((4096,), 1, 5 * 4096 * 12),
])
def test_flops_are_5_n_log2_n_batch(shape, batch, want):
    assert work.flops(shape, batch) == want


@pytest.mark.parametrize("dtype,itemsize", [(np.complex64, 8),
                                            (np.complex128, 16)])
def test_bytes_are_one_read_and_one_write(dtype, itemsize):
    assert work.io_bytes((4096,), 16384, dtype) == 2 * 2 ** 26 * itemsize


def test_least_seconds_is_the_larger_bound_per_chip():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    # 1D c64 N=4096: 3.75 flop/byte, under the ridge: bound by bandwidth
    t = work.least_seconds((4096,), 16384, np.complex64, 1, peak)
    assert t == pytest.approx(2 * 2 ** 26 * 8 / 3.35e12)
    # four chips share the work
    t4 = work.least_seconds((512,) * 3, 2, np.complex64, 4, peak)
    assert t4 == pytest.approx(2 * 2 ** 28 * 8 / 4 / 3.35e12)
    # compute bound where the peak rate is the smaller one
    slow = dict(peak, fp32_flops_per_s=1e9)
    assert work.least_seconds((4096,), 1, np.complex64, 1, slow) == \
        pytest.approx(5 * 4096 * 12 / 1e9)
    assert math.isfinite(t)


def test_unknown_device_is_an_error():
    with pytest.raises(KeyError):
        work.peaks("cpu")
