"""The one traffic generator: it reads a mix from ``traffic/<mix>.json``.

A mix says how the measured window calls the transform:

    batch        transforms per call (the leading axis; 1 means no batch axis
                 for a single-device entry, as upstream pyfft's batch=1)
    storage      "split" (separate real and imaginary float planes) or
                 "interleaved" (one complex array)
    directions   "roundtrip": forward, inverse, forward, ... with each call
                 fed the previous call's output
    loop         "sync": every call waits for its result (upstream pyfft's
                 default ``wait_for_finish``), so calls never overlap
    check_pairs  forward/inverse pairs of the window kept for the check;
                 where in the window they fall is drawn from the seed

Every seed gives the same sizes and the same call pattern; the seed moves
only the data and where the checked pairs fall.
"""

from __future__ import annotations

import dataclasses

import numpy as np

STORAGES = ("split", "interleaved")
DIRECTIONS = ("roundtrip",)
LOOPS = ("sync",)
# Checked pairs fall in this part of the window, so that each is a call of
# the steady window, neither its first nor its last.
SAMPLE_SPAN = (0.1, 0.9)


@dataclasses.dataclass(frozen=True)
class Traffic:
    batch: int
    storage: str
    directions: str
    loop: str
    check_pairs: int

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        fields = {f.name for f in dataclasses.fields(cls)}
        if set(d) != fields:
            raise ValueError(f"a traffic mix has exactly the keys "
                             f"{sorted(fields)}; got {sorted(d)}")
        t = cls(**d)
        for value, allowed in ((t.storage, STORAGES),
                               (t.directions, DIRECTIONS),
                               (t.loop, LOOPS)):
            if value not in allowed:
                raise ValueError(f"{value!r} is not one of {allowed}")
        if t.batch < 1 or t.check_pairs < 1:
            raise ValueError("batch and check_pairs must be at least 1")
        return t

    def inverse(self, i: int) -> bool:
        """Whether call ``i`` of the window runs the inverse transform."""
        return i % 2 == 1

    def sample_times(self, seed: int, seconds: float) -> list[float]:
        """Seconds into the window after which the next forward call and
        the inverse that follows it are kept for the check."""
        rng = np.random.default_rng(seed)
        lo, hi = SAMPLE_SPAN
        return sorted(float(f) * seconds
                      for f in rng.uniform(lo, hi, self.check_pairs))
