"""The traced run: capture a ``jax.profiler`` trace of the window, and reduce
it to what the per-layer readers need.

The harness wraps each call of the window in a host span named
``perfbench.fwd`` or ``perfbench.inv`` (``jax.profiler.TraceAnnotation``),
on the profiler's own clock.  The device planes (``/device:GPU:<n>``) hold
one line per CUDA stream (``Stream #<k>(...)``), and each event on them is a
kernel or a copy with its start and duration in nanoseconds.  Busy time is
the union of those intervals; the traced window runs from the first span's
start to the last span's end.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import glob
import os
import shutil

import jax

SPAN_PREFIX = "perfbench."
DEVICE_PLANE_PREFIX = "/device:"
STREAM_LINE_PREFIX = "Stream"
TOP = 10            # entries of each breakdown list
NAME_CHARS = 96     # kernel names are cut to this many characters


@contextlib.contextmanager
def capture(logdir: str):
    """Trace what runs inside; ``logdir`` is emptied first.  The Python
    tracer is off: it would record every Python call of the window."""
    shutil.rmtree(logdir, ignore_errors=True)
    options = jax.profiler.ProfileOptions()
    options.python_tracer_level = 0
    options.host_tracer_level = 1
    options.enable_hlo_proto = False
    jax.profiler.start_trace(logdir, profiler_options=options)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Device:
    ops: list                 # (name, start_ns, end_ns) on every stream
    merged: list = dataclasses.field(init=False)
    starts: list = dataclasses.field(init=False)

    def __post_init__(self):
        self.merged = _merge((s, e) for _, s, e in self.ops)
        self.starts = [s for s, _ in self.merged]

    def busy(self, lo: float, hi: float) -> float:
        return sum(e - s for s, e in self.inside(lo, hi))

    def inside(self, lo: float, hi: float) -> list:
        """The busy intervals clipped to [lo, hi], in order."""
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        out = []
        while i < len(self.merged) and self.merged[i][0] < hi:
            s, e = self.merged[i]
            if e > lo:
                out.append((max(s, lo), min(e, hi)))
            i += 1
        return out


@dataclasses.dataclass
class TraceView:
    """The traced window: the harness's call spans and each device's ops,
    both in nanoseconds on the profiler's clock."""
    calls: list               # (kind, start_ns, end_ns), kind "fwd"/"inv"
    devices: list             # Device per chip, in plane order

    @property
    def window(self) -> tuple[float, float]:
        return self.calls[0][1], self.calls[-1][2]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) * 1e-9

    def busy_s(self, dev: Device) -> float:
        return dev.busy(*self.window) * 1e-9

    def mean_busy_s(self) -> float:
        """Busy seconds in the window, averaged over the chips."""
        return sum(map(self.busy_s, self.devices)) / len(self.devices)

    def fullest(self) -> Device:
        return max(self.devices, key=self.busy_s)

    def per_call_busy_s(self, dev: Device) -> list[float]:
        return [dev.busy(s, e) * 1e-9 for _, s, e in self.calls]

    def op_seconds(self, dev: Device, match) -> float:
        """Seconds of ``dev``'s ops inside the window whose name
        satisfies ``match``."""
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for n, s, e in dev.ops if match(n)) * 1e-9

    def device_ops(self) -> list:
        """[name, seconds]: the ops that took most time in the window,
        averaged over the chips."""
        lo, hi = self.window
        total = collections.Counter()
        for dev in self.devices:
            for n, s, e in dev.ops:
                total[n[:NAME_CHARS]] += max(0.0, min(e, hi) - max(s, lo))
        k = len(self.devices)
        return [[n, t * 1e-9 / k] for n, t in total.most_common(TOP)]

    def idle_gaps(self) -> list:
        """[label, seconds]: the device's idle time in the window, by what
        the harness was doing (inside a call: before its first op,
        between ops, after its last op; or between calls), averaged over
        the chips, longest first."""
        total = collections.Counter()
        for dev in self.devices:
            prev_end = None
            for kind, s, e in self.calls:
                if prev_end is not None:
                    total["between calls"] += (s - prev_end) - dev.busy(
                        prev_end, s)
                prev_end = e
                inside = dev.inside(s, e)
                if not inside:
                    total[f"{kind} call, no op"] += e - s
                    continue
                total[f"{kind} call, before first op"] += inside[0][0] - s
                total[f"{kind} call, after last op"] += e - inside[-1][1]
                total[f"{kind} call, between ops"] += sum(
                    b[0] - a[1] for a, b in zip(inside, inside[1:]))
        k = len(self.devices)
        return [[n, t * 1e-9 / k] for n, t in total.most_common(TOP)]


def load(logdir: str) -> TraceView:
    """Read the one ``.xplane.pb`` under ``logdir``."""
    (path,) = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                        recursive=True)
    return from_profile(jax.profiler.ProfileData.from_file(path))


def from_profile(data) -> TraceView:
    calls, devices = [], []
    for plane in data.planes:
        if plane.name.startswith(DEVICE_PLANE_PREFIX):
            devices.append(Device([
                (ev.name, ev.start_ns, ev.start_ns + ev.duration_ns)
                for line in plane.lines
                if line.name.startswith(STREAM_LINE_PREFIX)
                for ev in line.events]))
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name.startswith(SPAN_PREFIX):
                    calls.append((ev.name[len(SPAN_PREFIX):], ev.start_ns,
                                  ev.start_ns + ev.duration_ns))
    calls.sort(key=lambda c: c[1])
    if not calls:
        raise ValueError("the trace holds no call span of the harness")
    return TraceView(calls=calls, devices=devices)
