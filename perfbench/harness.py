"""One run of one cell: set-up, the measured window, the check, the result.

Set-up builds the cell's target (entries/<entry>.py), makes its inputs on
the chips from the seed (one jitted call each), and warms up the only two
executables the window calls (forward and inverse).  The window then calls
the target back to back for the given seconds, each call timed on the host
clock up to ``block_until_ready``.  Right after it the allocator's peak is
read; then the kept pairs are compared with the reference (check.py), then
the trace is reduced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import traceback

import jax
import numpy as np

from perfbench import check, spec, tracing, work

CACHE_DIR = spec.REPO / ".jax_cache"
TRACE_DIR = spec.HERE / ".traces"
TRACE_SECONDS = 1.0        # a traced run traces at most this much window
WARM_ROUNDTRIPS = 2
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/backend_compile_duration")


def use_compile_cache() -> str:
    """JAX's persistent compilation cache: ``JAX_COMPILATION_CACHE_DIR``
    where it is set, else ``.jax_cache/`` at the root of the checkout (a
    fixed path: the path is part of the cache's key).  Every executable is
    cached, however short its compile, so that a cell's second run in a
    checkout compiles nothing."""
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax.config.jax_compilation_cache_dir


def seed_key(seed: int):
    """A PRNG key from any whole number (64 bits are kept)."""
    seed %= 1 << 64
    return jax.random.fold_in(jax.random.key(seed & 0xFFFFFFFF), seed >> 32)


@contextlib.contextmanager
def count_compiles():
    """Counts traces and compilations (persistent-cache loads included)
    while inside; yields a one-element list holding the count."""
    count = [0]

    def listener(event, duration, **kwargs):
        if event in COMPILE_EVENTS:
            count[0] += 1

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield count
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)


def warm_up(target, first) -> None:
    """Compile and run the window's two executables (and let cuFFT plan
    and NCCL connect) before anything is timed."""
    for _ in range(WARM_ROUNDTRIPS):
        y = jax.block_until_ready(target.call(False, first))
        jax.block_until_ready(target.call(True, y))


@dataclasses.dataclass
class Window:
    call_s: list            # wall seconds of each completed call
    seconds: float          # first call's start to last call's end
    samples: list           # check.Sample pairs kept for the check
    failed: int             # calls that raised
    compiles: int


def make_inputs(target, traffic, seed: int) -> list:
    """The window's inputs from the seed: the first call's, and one for
    each kept pair (the first of them is the first call's)."""
    key = seed_key(seed)
    return jax.block_until_ready(
        [target.make_input(key)] + [target.make_input(jax.random.fold_in(
            key, k)) for k in range(1, traffic.check_pairs)])


def run_window(target, traffic, inputs, seed: int, seconds: float,
               traced: bool = False) -> Window:
    """Calls back to back for ``seconds``, each fed the previous call's
    output, from ``inputs[0]``; then on until every pair due is kept (which
    matters only where calls are slow against the window).  At each time
    drawn for a kept pair the next forward call takes the pair's own input
    from the seed instead, so that every pair compared starts from data the
    program did not make; the chain goes on from that pair's inverse.  A
    call that raises ends the window."""
    due = traffic.sample_times(seed, seconds)
    call_s, samples, failed = [], [], 0
    pending = None
    x, i = inputs[0], 0
    with count_compiles() as compiles:
        start = end = time.perf_counter()
        while end - start < seconds or pending is not None or due:
            inverse = traffic.inverse(i)
            keep = (not inverse and pending is None and due
                    and end - start >= due[0])
            if keep:
                due.pop(0)
                x = inputs[len(samples)]
            span = (jax.profiler.TraceAnnotation(
                tracing.SPAN_PREFIX + ("inv" if inverse else "fwd"))
                if traced else contextlib.nullcontext())
            t0 = time.perf_counter()
            try:
                with span:
                    y = jax.block_until_ready(target.call(inverse, x))
            except Exception:                 # reported, and fails the run
                traceback.print_exc()
                failed += 1
                break
            end = time.perf_counter()
            call_s.append(end - t0)
            if pending is not None:
                pending.inv, pending = y, None
            elif keep:
                pending = check.Sample(inp=x, fwd=y)
                samples.append(pending)
            x, i = y, i + 1
    return Window(call_s, end - start, samples, failed, compiles[0])


@dataclasses.dataclass
class Readings:
    """What the metric readers read (metrics/<name>.py)."""
    call_s: list
    window_s: float
    flops_per_call: float
    setup_s: float
    memory_peak_bytes: int | None
    least_s_per_call: float | None
    trace: tracing.TraceView | None


def card_info() -> str:
    """nvidia-smi's name, power limit and SM clocks of each card; a child
    process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def say(msg: str) -> None:
    print(msg, flush=True)


def memory_peak(devices) -> int | None:
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    return None if None in peaks else max(peaks)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        devices, t_start: float, bench: dict, wrap=None) -> dict:
    """One run; returns the result line's object.  ``wrap`` (tests only)
    replaces the target by ``wrap(target)``."""
    config, traffic = cell.config, cell.traffic
    entry = spec.module("entries", config["entry"])
    reference = spec.module("references", config["reference"])
    target = entry.build(config, traffic, devices)
    if wrap is not None:
        target = wrap(target)
    inputs = make_inputs(target, traffic, seed)
    warm_up(target, inputs[0])
    gc.collect()
    gc.disable()
    setup_s = time.perf_counter() - t_start
    logdir = str(TRACE_DIR / cell.name)
    try:
        with tracing.capture(logdir) if traced else contextlib.nullcontext():
            w = run_window(target, traffic, inputs, seed,
                           min(seconds, TRACE_SECONDS) if traced else seconds,
                           traced)
    finally:
        gc.enable()
    peak = memory_peak(devices)
    ms = np.percentile(w.call_s, (50, 95, 99)) * 1e3 if w.call_s else ()
    say(f"[window] {len(w.call_s)} calls in {w.seconds!r} s, {w.failed} "
        f"failed, compilations inside the window: {w.compiles}; call ms "
        f"p50/p95/p99 {' '.join(map(repr, map(float, ms)))}")
    say(f"[card] {card_info()}")

    del inputs
    t0 = time.perf_counter()
    numbers = check.compare(target, w.samples, reference)
    correct = w.failed == 0 and check.passes(numbers, cell.limits)
    say(f"[check] {len(w.samples)} forward/inverse pairs compared with the "
        f"float64 reference ({config['reference']}) in "
        f"{time.perf_counter() - t0!r} s; correct: {correct}")

    view = None
    if traced:
        t0 = time.perf_counter()
        view = tracing.load(logdir)
        empty = sum(not d.busy(s, e) for d in view.devices
                    for _, s, e in view.calls)
        say(f"[trace] {len(view.calls)} calls, {empty} call spans without a "
            f"device op (dropped events); read in "
            f"{time.perf_counter() - t0!r} s")
    shape, batch = config["shape"], traffic.batch
    least = None
    if view is not None and view.devices:
        least = work.least_seconds(shape, batch, config["dtype"], cell.chips,
                                   work.peaks(devices[0].device_kind))
    readings = Readings(call_s=w.call_s, window_s=w.seconds,
                        flops_per_call=work.flops(shape, batch),
                        setup_s=setup_s, memory_peak_bytes=peak,
                        least_s_per_call=least, trace=view)
    metrics = {}
    for m in spec.cell_metrics(bench, cell.name, traced):
        value = spec.module("metrics", m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(w.call_s) + w.failed,
              "failed": w.failed, "metrics": metrics, "device": device}
    if view is not None and view.devices:
        device["busy_s"] = view.mean_busy_s()
        device["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.device_ops(),
                               "idle_gaps": view.idle_gaps()}
    result["checks"] = {
        k: {"value": v if math.isfinite(v) else None,
            "limit": cell.limits.get(k)} for k, v in numbers.items()}
    return result


def report(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
