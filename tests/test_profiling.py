"""Timing/observability utilities (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyfft_tpu import Plan
from pyfft_tpu.utils.profiling import (HBM_PEAK_BYTES_PER_S, card_info,
                                       effective_gflops,
                                       hbm_peak_bytes_per_s, summarize,
                                       time_calls)


def test_time_calls_and_summarize():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b, a - b

    a = jnp.ones((64, 64))
    times = time_calls(fn, (a, a), reps=5, warmup=2)
    assert len(times) == 5 and len(calls) == 7
    assert all(t > 0 for t in times)
    s = summarize([3.0, 1.0, 2.0])
    assert s == {"median_s": 2.0, "min_s": 1.0, "max_s": 3.0, "n": 3}


def test_performance_harness():
    """CPU-runnable smoke: the timing machinery works end to end on a
    Plan's executable."""
    plan = Plan((1024,))
    fn = plan._get_callable(False, "planar")
    rng = np.random.RandomState(0)
    args = (jnp.asarray(rng.standard_normal((32, 1024)).astype(np.float32)),
            jnp.asarray(rng.standard_normal((32, 1024)).astype(np.float32)))
    dt = summarize(time_calls(fn, args, reps=3))["median_s"]
    assert effective_gflops((1024,), 32, dt) > 0


def test_effective_gflops():
    # 5 * 1024 * 10 * 1 / 1e-3 / 1e9 = 0.0512 GFLOP/s
    assert abs(effective_gflops((1024,), 1, 1e-3) - 0.0512) < 1e-9
    assert effective_gflops(1024, 2, 1e-3) == 2 * effective_gflops(
        (1024,), 1, 1e-3)


def test_hbm_peak_table():
    assert hbm_peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert all(v > 1e12 for v in HBM_PEAK_BYTES_PER_S.values())
    with pytest.raises(ValueError, match="no published"):
        hbm_peak_bytes_per_s("cpu")


def test_card_info_needs_nvidia_smi(monkeypatch):
    """card_info raises where nvidia-smi is absent (no silent default)."""
    monkeypatch.setenv("PATH", "")
    with pytest.raises(OSError):
        card_info()
