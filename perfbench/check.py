"""The comparison that decides ``correct``.

The window keeps a few forward/inverse pairs of its own calls, at times
drawn from the seed: the forward call's input (fresh data from the seed,
not the previous call's output, so that no fault can hide in data it made
itself) and output, and the output of the inverse call that follows it
(which took that output as its input).  Once the window has closed, each
output is compared with the plain reference (``references/<ref>.py`` in
float64) applied to the input that call received, at the timed size:

    fwd_err   max |forward output - DFT(input)| / max |DFT(input)|
    inv_err   max |inverse output - IDFT(forward output)| / max |IDFT(...)|

each the largest over the pairs kept.  A run is correct when every number is
finite and at most its limit (``limits/<cell>.json``).  An identity, a
transform of part of the batch, a missing exchange or an altered element
fails; a roundtrip that returns its input does not pass for a transform.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

BLOCK_POINTS = 1 << 25      # points per block of the float64 reference


@dataclasses.dataclass
class Sample:
    inp: tuple                  # the forward call's input arrays
    fwd: tuple                  # its output
    inv: tuple | None = None    # the next (inverse) call's output


@jax.jit
def _gaps(gr, gi, rr, ri):
    """max |got - ref| and max |ref|, in float64."""
    gr, gi = gr.astype(rr.dtype), gi.astype(rr.dtype)
    return (jnp.max(jnp.hypot(gr - rr, gi - ri)), jnp.max(jnp.hypot(rr, ri)))


def rel_err(target, got, given, inverse: bool, reference) -> float:
    """max |got - ref| / max |ref| where ref is the reference transform of
    ``given``; computed where the arrays lie (over the mesh for a sharded
    cell), in blocks of the batch axis."""
    gr, gi = target.planes(got)
    xr, xi = target.planes(given)
    if len(target.shape) > target.rank:         # blocks of the batch axis
        step = max(1, BLOCK_POINTS // math.prod(target.shape[1:]))
        blocks = [slice(lo, lo + step)
                  for lo in range(0, target.shape[0], step)]
    else:
        blocks = [slice(None)]
    gaps, tops = [], []
    with jax.enable_x64(True):
        for sl in blocks:
            rr, ri = reference.transform(xr[sl], xi[sl], target.rank,
                                         inverse, "f64")
            g, t = _gaps(gr[sl], gi[sl], rr, ri)
            gaps.append(float(g))
            tops.append(float(t))
    return _worst(gaps) / max(tops)


def _worst(values) -> float:
    """The largest value; NaN if there is none or any is NaN."""
    if not values or any(math.isnan(v) for v in values):
        return math.nan
    return max(values)


def compare(target, samples, reference) -> dict:
    """The numbers compared, each the largest over the kept pairs; NaN
    where the window kept none, which fails."""
    fwd = [rel_err(target, s.fwd, s.inp, False, reference) for s in samples]
    inv = [rel_err(target, s.inv, s.fwd, True, reference)
           for s in samples if s.inv is not None]
    return {"fwd_err": _worst(fwd), "inv_err": _worst(inv)}


def passes(numbers: dict, limits: dict) -> bool:
    """Every number finite and at most its limit; a number without a limit
    or a limit without a number fails."""
    return set(numbers) == set(limits) and all(
        math.isfinite(numbers[k]) and numbers[k] <= limits[k]
        for k in numbers)


class Control:
    """The control: the reference in the program's place, computed one
    precision step below what the configuration states (``bf16x3``).  A
    sound limit fails it."""

    MODE = "bf16x3"

    def __init__(self, target, reference):
        self.base, self.reference = target, reference
        self.devices, self.shape = target.devices, target.shape
        self.rank, self.make_input = target.rank, target.make_input
        self.planes, self.from_planes = target.planes, target.from_planes

    def call(self, inverse: bool, arrays):
        re, im = self.base.planes(arrays)
        return self.base.from_planes(*self.reference.transform(
            re, im, self.rank, inverse, self.MODE))
