"""Profiling & timing utilities.

The reference had no built-in observability — timing lived only in its
performance test script (SURVEY.md §5 "tracing/profiling: none built in").
This module is the upgrade the survey prescribes: `jax.profiler` trace
capture, wall-clock timing of calls that end in ``block_until_ready``,
the card's published memory bandwidth for roofline bounds, and the card's
name and power limit to print beside every number.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import subprocess
import time

import jax

__all__ = ["trace", "time_calls", "summarize", "effective_gflops",
           "HBM_PEAK_BYTES_PER_S", "hbm_peak_bytes_per_s", "card_info"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_calls(fn, args, reps: int = 20, warmup: int = 2) -> list[float]:
    """Seconds of each of ``reps`` calls ``fn(*args)``, each ending in
    ``block_until_ready``, after ``warmup`` untimed calls (the first call
    compiles).  ``fn`` must not donate ``args``: every call reuses them."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def summarize(times: list[float]) -> dict:
    """Median and spread (min, max) of a list of seconds."""
    return {"median_s": statistics.median(times), "min_s": min(times),
            "max_s": max(times), "n": len(times)}


def effective_gflops(shape, batch: int, seconds: float) -> float:
    """The reference's throughput metric: 5*N*log2(N)*batch / t (SURVEY §4)."""
    n = math.prod(shape) if not isinstance(shape, int) else shape
    return 5.0 * n * math.log2(n) * batch / seconds / 1e9


# Published device-memory bandwidth by ``jax.Device.device_kind``, from
# NVIDIA's data sheets (H100 SXM5 80 GB: 3.35 TB/s; H100 PCIe 80 GB:
# 2.0 TB/s; H200 SXM 141 GB: 4.8 TB/s).  The rates assume the card's full
# power limit, so print the limit beside any share of them.
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H200": 4.8e12,
}


def hbm_peak_bytes_per_s(device_kind: str) -> float:
    """The table's peak for ``device_kind``; a device not in the table is
    an error, never a default."""
    try:
        return HBM_PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind "
            f"{device_kind!r}; add it to HBM_PEAK_BYTES_PER_S with its "
            f"source") from None


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (one line per card).  Runs as a child process that stays off JAX.
    Raises OSError / CalledProcessError where nvidia-smi is missing or
    fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
