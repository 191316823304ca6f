"""chip_smoke.py and bench.py: the device guards on a CPU-only host, and
chip_smoke's phase functions at tiny sizes on the CPU.  The full-size run
on the card is ``python chip_smoke.py`` (and the ``gpu``-marked test)."""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_cpu_host(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""                      # no result line
    assert "no GPU" in out.err


def test_bench_refuses_cpu_host(capsys):
    assert _load_bench().main() != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


TINY = [
    cs.Config("t1", (64,), 1, np.complex64, True),
    cs.Config("t2i", (128,), 8, np.complex64, False),
    cs.Config("t3", (16, 32), 3, np.complex64, True),
    cs.Config("t4", (8, 16, 8), 1, np.complex64, True),
    cs.Config("t5", (1 << 12,), 4, np.complex128, True),
]


@pytest.mark.parametrize("cfg", TINY, ids=lambda c: c.name)
def test_check_config_tiny(cfg, capsys):
    out = cs.check_config(cfg)
    assert out["err"] < out["gate"] and out["roundtrip_err"] < out["gate"]
    assert f"config {cfg.name}" in capsys.readouterr().out


def test_check_config_catches_wrong_result(monkeypatch):
    """A transform off by a scale must fail phase 1, not pass silently."""
    from pyfft_tpu import plan as planmod

    orig = planmod.Plan._build_callable

    def scaled(self, inverse, split):
        fn = orig(self, inverse, split)
        if split == "planar":
            return lambda re, im: tuple(1.001 * a for a in fn(re, im))
        return lambda x: 1.001 * fn(x)

    monkeypatch.setattr(planmod.Plan, "_build_callable", scaled)
    with pytest.raises(RuntimeError, match="error"):
        cs.check_config(TINY[0])


def test_check_api_tiny(capsys):
    cs.check_api(n=64)
    assert capsys.readouterr().out.count("[phase1] api") == 5


def test_time_config_tiny(capsys):
    cfg = TINY[2]
    out = cs.time_config(cfg, peak_bytes_per_s=3.35e12, card="card, 1 W",
                         reps=3)
    assert out["execute"]["n"] == out["lax_fft"]["n"] == out["einsum"]["n"] == 3
    assert out["bound_s"] == cfg.io_bytes / 3.35e12
    assert cfg.io_bytes == 2 * 3 * 16 * 32 * 8
    text = capsys.readouterr().out
    assert "card, 1 W" in text and "memory_analysis" in text


@pytest.mark.parametrize("case", [
    cs.MultiCase("1D c64", 1, (256,), 2, np.complex64),
    cs.MultiCase("2D c64", 2, (16, 32), 2, np.complex64),
    cs.MultiCase("3D c64", 3, (8, 8, 16), 1, np.complex64),
    cs.MultiCase("1D c128", 1, (1024,), 2, np.complex128),
], ids=lambda c: c.name)
def test_check_multi_tiny(case):
    out = cs.check_multi(case, jax.devices()[:4], reps=2)
    assert out["err"] < cs.GATES[np.dtype(case.dtype)]


def test_configs_are_the_baseline_set():
    names = [c.name for c in cs.CONFIGS]
    assert names == ["1", "2", "2i", "3", "4", "5", "6+"]
    five = cs.CONFIGS[names.index("5")]
    assert five.io_bytes == 2 * (1 << 22) * 64 * 16
    assert [c.rank for c in cs.MULTI_CASES] == [1, 2, 3, 1]


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_device, capsys):
    assert cs.main([]) == 0
    assert '"ok": true' in capsys.readouterr().out.splitlines()[-1]
