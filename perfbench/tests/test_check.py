"""The check that decides ``correct``, driven through the harness on the
CPU at small sizes: the program passes, and the control and each fault a
cell can have fail."""

import time

import jax
import numpy as np
import pytest

from perfbench import check, harness, spec
from perfbench.references import dft
from perfbench.traffic import Traffic

BENCH = spec.benchmark()

# Each cell at a size a test run holds, with its own limits.  The batch-1
# cell is measured but not in BENCHMARK.json (PERF.md, Open questions); it
# covers the check of an array without a batch axis.
SMALL = {
    "fft1d_c64_n4096.split_rt_b16384": ({"shape": [256]}, {"batch": 8}),
    "fft3d_c64_256.il_rt_b4": ({"shape": [8, 8, 8]}, {"batch": 2}),
    "fft1d_c64_n4096.split_rt_b1": ({"shape": [256]}, {"check_pairs": 4}),
    "dist3d_c64_512.rt_b2_4chip": ({"shape": [8, 8, 8]}, {}),
}


def small_cell(name):
    config, mix = name.split(".")
    base = spec.make_cell(name, config, mix, 4 if "4chip" in mix else 1)
    config, traffic = SMALL[name]
    return spec.Cell(name=name, chips=base.chips,
                     config={**base.config, **config},
                     traffic=Traffic.from_dict({**vars(base.traffic),
                                                **traffic}),
                     limits=base.limits)


def run(name, wrap=None, seed=2 ** 31 + 11):
    cell = small_cell(name)
    devices = jax.devices()[:cell.chips]
    return harness.run(cell, seed, 0.2, False, devices, time.perf_counter(),
                       BENCH, wrap=wrap)


class Fault:
    """The timed path broken underneath the harness."""

    def __init__(self, target, kind):
        self.base, self.kind = target, kind
        self.devices, self.shape, self.rank = (target.devices, target.shape,
                                               target.rank)
        self.make_input, self.planes = target.make_input, target.planes
        self.from_planes = target.from_planes

    def call(self, inverse, arrays):
        out = self.base.call(inverse, arrays)
        if self.kind == "unchanged":            # returns its state unchanged
            return arrays
        re, im = self.base.planes(out)
        if self.kind == "half_batch":           # half the batch left out
            half = re.shape[0] // 2
            re, im = re.at[half:].set(0), im.at[half:].set(0)
        elif self.kind == "altered":            # one answer altered
            mid = np.unravel_index(re.size // 2, re.shape)
            re = re.at[mid].multiply(-1.0)
        return self.base.from_planes(re, im)


@pytest.mark.parametrize("name", list(SMALL))
def test_the_program_passes(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 4
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert 0 < c["value"] < c["limit"]


@pytest.mark.parametrize("name", list(SMALL))
def test_the_control_fails(name):
    ref = spec.module("references", "dft")
    r = run(name, wrap=lambda t: check.Control(t, ref))
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name,kind", [
    (n, k) for n in SMALL for k in ("unchanged", "half_batch", "altered")
    if not (k == "half_batch" and "b1" in n)])
def test_a_fault_fails(name, kind):
    r = run(name, wrap=lambda t: Fault(t, kind))
    assert not r["correct"]


def test_the_exchange_left_out_fails(monkeypatch):
    from pyfft_tpu.parallel import dist
    monkeypatch.setattr(dist, "_a2a", lambda x, *args: x)
    assert not run("dist3d_c64_512.rt_b2_4chip")["correct"]


def test_a_call_that_raises_is_counted_and_fails():
    class Raises(Fault):
        calls = 0

        def call(self, inverse, arrays):
            Raises.calls += 1
            if Raises.calls > 30:               # inside the window
                raise RuntimeError("device lost")
            return self.base.call(inverse, arrays)

    r = run("fft1d_c64_n4096.split_rt_b1", wrap=lambda t: Raises(t, None))
    assert r["failed"] == 1 and not r["correct"]


@pytest.mark.parametrize("shape", [(3, 64), (2, 8, 16), (2, 4, 8, 8)])
@pytest.mark.parametrize("inverse", [False, True])
def test_the_reference_is_the_dft(shape, inverse):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    rank = len(shape) - 1
    axes = tuple(range(1, len(shape)))
    want = (np.fft.ifftn if inverse else np.fft.fftn)(x, axes=axes)
    with jax.enable_x64(True):
        re, im = dft.transform(x.real, x.imag, rank, inverse, "f64")
        got = np.asarray(re) + 1j * np.asarray(im)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13
    re, im = dft.transform(x.real.astype(np.float32),
                           x.imag.astype(np.float32), rank, inverse, "bf16x3")
    err = np.abs(np.asarray(re) + 1j * np.asarray(im) - want).max() \
        / np.abs(want).max()
    assert 1e-7 < err < 1e-4          # three bfloat16 passes: ~2^-17


def test_nan_fails():
    assert not check.passes({"fwd_err": float("nan"), "inv_err": 0.0},
                            {"fwd_err": 1.0, "inv_err": 1.0})
    assert not check.passes({"fwd_err": 0.0}, {"fwd_err": 1.0,
                                               "inv_err": 1.0})
