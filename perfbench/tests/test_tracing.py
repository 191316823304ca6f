"""The reduction from a profiler trace to the per-layer metrics: on traces
recorded on H100s by record_trace.py (16 calls of
fft1d_c64_n4096.split_rt_b16384 on one card, 4 calls of
dist3d_c64_512.rt_b2_4chip on four) and on small made-up traces."""

from types import SimpleNamespace as NS

import jax
import pytest

from perfbench import spec, tracing
from perfbench.harness import Readings

TESTDATA = spec.HERE / "testdata"
RECORDED = TESTDATA / "fft1d_c64_n4096.split_rt_b16384.xplane.pb"
RECORDED_4 = TESTDATA / "dist3d_c64_512.rt_b2_4chip.xplane.pb"
LEAST_S = 2 * 2 ** 26 * 8 / 3.35e12       # work.least_seconds, H100 SXM


def read(name, view, least=LEAST_S):
    r = Readings(call_s=[], window_s=0.0, flops_per_call=0.0, setup_s=0.0,
                 memory_peak_bytes=None, least_s_per_call=least, trace=view)
    return spec.module("metrics", name).read(r)


@pytest.fixture(scope="module")
def recorded():
    return tracing.from_profile(jax.profiler.ProfileData.from_file(
        str(RECORDED)))


def test_recorded_trace_has_the_calls_and_the_kernels(recorded):
    v = recorded
    assert [k for k, _, _ in v.calls] == ["fwd", "inv"] * 8
    assert len(v.devices) == 1 and len(v.devices[0].ops) == 72
    names = {n for n, _ in v.device_ops()}
    assert {"wrapped_complex", "wrapped_real", "wrapped_imag"} <= names
    assert any(n.startswith("void vector_fft<4096u") for n in names)
    assert any("scal_kernel" in n for n in names)      # inverse's 1/N


def test_recorded_trace_per_call_device_time(recorded):
    busy = recorded.per_call_busy_s(recorded.fullest())
    fwd, inv = busy[0::2], busy[1::2]
    # forward: complex + FFT + real + imag; inverse adds cuBLAS scal
    assert all(1.2e-3 < b < 1.3e-3 for b in fwd)
    assert all(1.6e-3 < b < 1.7e-3 for b in inv)
    assert read("exe_device_us", recorded) == pytest.approx(
        sum(busy) / 16 * 1e6)
    assert read("exe_device_us", recorded) == pytest.approx(1440.4, abs=1)


def test_recorded_trace_shares_add_up(recorded):
    v = recorded
    span = sum(e - s for _, s, e in v.calls) * 1e-9 / len(v.calls)
    gap, exe = read("host_gap_us", v), read("exe_device_us", v)
    assert gap + exe == pytest.approx(span * 1e6)
    assert 0 < read("idle_share", v) < 100
    idle = sum(t for _, t in v.idle_gaps())
    assert idle == pytest.approx(v.window_s - v.mean_busy_s())
    roof = read("fft_roofline", v)
    assert roof == pytest.approx(100 * LEAST_S / (exe * 1e-6))
    assert 0 < roof < 100
    assert read("collective_us", v) is None        # one chip: no NCCL


def test_recorded_four_card_trace():
    v = tracing.from_profile(jax.profiler.ProfileData.from_file(
        str(RECORDED_4)))
    assert [k for k, _, _ in v.calls] == ["fwd", "inv"] * 2
    assert len(v.devices) == 4
    # two all_to_all exchanges a call, on streams of their own
    for dev in v.devices:
        nccl = [n for n, _, _ in dev.ops if "nccl" in n.lower()]
        assert len(nccl) == 8
    # per card: one read and one write of its quarter of 2^28 points
    least = 2 * 2 ** 28 * 8 / 4 / 3.35e12
    exe = read("exe_device_us", v, least)
    assert exe == pytest.approx(5926.4, abs=1)
    assert read("collective_us", v) == pytest.approx(2605.4, abs=1)
    assert read("collective_us", v) < exe
    assert 0 < read("fft_roofline", v, least) < 100
    assert 0 < read("idle_share", v) < 100


def _plane(name, lines):
    return NS(name=name, lines=[
        NS(name=ln, events=[NS(name=n, start_ns=s, duration_ns=d)
                            for n, s, d in evs]) for ln, evs in lines])


def made_up():
    """Two chips, two calls; chip 1 is the fuller one."""
    host = _plane("/host:CPU", [("python3", [
        ("perfbench.fwd", 0, 100), ("other", 5, 1), ("perfbench.inv", 110, 90)])])
    gpu0 = _plane("/device:GPU:0", [
        ("Stream #1(Compute)", [("fft", 10, 30), ("fft", 120, 30)]),
        ("Stream #2(nccl)", [("ncclDevKernel_AllToAll", 30, 20)])])
    gpu1 = _plane("/device:GPU:1", [
        ("Stream #1(Compute)", [("fft", 10, 60), ("fft", 120, 60)]),
        ("Stream #2(nccl)", [("ncclDevKernel_AllToAll", 80, 10)]),
        ("Launch stats", [("not a kernel", 0, 200)])])
    return tracing.from_profile(NS(planes=[host, gpu0, gpu1]))


def test_made_up_trace():
    v = made_up()
    assert v.window == (0, 200) and v.window_s == pytest.approx(200e-9)
    g0, g1 = v.devices
    assert g0.merged == [[10, 50], [120, 150]]      # overlap merged
    assert v.fullest() is g1
    assert v.mean_busy_s() == pytest.approx((70 + 130) / 2 * 1e-9)
    assert read("exe_device_us", v) == pytest.approx((70 + 60) / 2 * 1e-3)
    assert read("host_gap_us", v) == pytest.approx((30 + 30) / 2 * 1e-3)
    assert read("collective_us", v) == pytest.approx(10 / 2 * 1e-3)
    assert read("idle_share", v) == pytest.approx(100 * (1 - 100 / 200))
    gaps = dict(v.idle_gaps())
    assert gaps["between calls"] == pytest.approx(10e-9)
    assert gaps["fwd call, before first op"] == pytest.approx(10e-9)
    assert gaps["fwd call, after last op"] == pytest.approx(
        (50 + 10) / 2 * 1e-9)
    assert gaps["inv call, after last op"] == pytest.approx(
        (50 + 20) / 2 * 1e-9)
    assert sum(gaps.values()) == pytest.approx(200e-9 - v.mean_busy_s())


def test_a_trace_without_device_planes_reads_nothing():
    host = _plane("/host:CPU", [("python3", [("perfbench.fwd", 0, 10)])])
    v = tracing.from_profile(NS(planes=[host]))
    for name in ("exe_device_us", "host_gap_us", "fft_roofline",
                 "idle_share", "collective_us"):
        assert read(name, v) is None


def test_a_trace_without_call_spans_is_an_error():
    with pytest.raises(ValueError):
        tracing.from_profile(NS(planes=[_plane("/device:GPU:0", [])]))
