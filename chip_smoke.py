"""On-card smoke test: the main path of pyfft_tpu at the BASELINE sizes.

    python chip_smoke.py            # one NVIDIA GPU: phases 0-2 below
    python chip_smoke.py --multi    # four GPUs: the multi-device path only

It refuses to run without a GPU: there is no CPU fallback.

Phase 0  the card: JAX's device kind and count, and ``nvidia-smi``'s name
         and power limit.
Phase 1  ``Plan.execute`` on device-resident data, forward then inverse,
         at every BASELINE config.  The first two batch rows are compared
         with ``numpy.fft`` in complex128 (max abs error / max |ref| under
         2e-6 for complex64, 1e-11 for complex128); the whole array's
         roundtrip error is computed on the device; the output is compared
         with the plain einsum reference (``reference.fft_planar``) at full
         size.  Then the functional API once each at a small size.
Phase 2  timing per config: median and spread of calls that end in
         ``block_until_ready``: ``Plan.execute`` end to end, and the jitted
         executables of the XLA FFT route and of the einsum chain called
         directly; the single device-memory round-trip bound at the
         card's published bandwidth; ``memory_analysis`` of the compiled
         forward executable and the device's ``peak_bytes_in_use``.

cuFFT computes in the data's own precision (no TF32), and the einsum
reference runs every contraction at ``Precision.HIGHEST``.

Every phase prints on lines of its own; any failure ends the run with a
non-zero exit.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

GATES = {np.dtype(np.complex64): 2e-6, np.dtype(np.complex128): 1e-11}


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    shape: tuple[int, ...]
    batch: int
    dtype: type
    split: bool              # planar (re, im) planes, else interleaved complex

    @property
    def full_shape(self) -> tuple[int, ...]:
        return ((self.batch,) if self.batch > 1 else ()) + self.shape

    @property
    def real_dtype(self):
        return np.float32 if self.dtype == np.complex64 else np.float64

    @property
    def io_bytes(self) -> int:
        """Bytes one transform must read and write: the single
        device-memory round trip."""
        return 2 * math.prod(self.full_shape) * np.dtype(self.dtype).itemsize

    def describe(self) -> str:
        dims = "x".join(map(str, self.shape))
        kind = "split" if self.split else "interleaved"
        return (f"{len(self.shape)}D {np.dtype(self.dtype).name} {dims} "
                f"batch {self.batch} {kind}")


# BASELINE.md configs 1-5, the interleaved twin of 2 and the large-N c64 case
CONFIGS = (
    Config("1", (1024,), 1, np.complex64, True),
    Config("2", (4096,), 4096, np.complex64, True),
    Config("2i", (4096,), 4096, np.complex64, False),
    Config("3", (1024, 1024), 16, np.complex64, True),
    Config("4", (256, 256, 256), 1, np.complex64, True),
    Config("5", (1 << 22,), 64, np.complex128, True),
    Config("6+", (1 << 22,), 8, np.complex64, True),
)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(ok: bool, msg: str) -> None:
    """A failed check ends the run (a raise, not an ``assert``: the checks
    hold under ``python -O`` too)."""
    if not ok:
        raise RuntimeError(msg)


def make_data(cfg: Config, seed: int = 0):
    """Device-resident input from ``seed``: (re, im) planes, or one complex
    array for an interleaved config."""
    import jax

    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    re = jax.random.normal(kr, cfg.full_shape, cfg.real_dtype)
    im = jax.random.normal(ki, cfg.full_shape, cfg.real_dtype)
    return (re, im) if cfg.split else (jax.lax.complex(re, im),)


def _to_complex(arrs):
    """(re, im) or (z,) device arrays -> one complex device array."""
    import jax

    return arrs[0] if len(arrs) == 1 else jax.lax.complex(*arrs)


def _head(z, cfg: Config, rows: int = 2):
    """The first ``rows`` batch rows of a batched config's array, else all
    of it."""
    return z[:rows] if cfg.batch > 1 else z


def _rel_err_device(got, want) -> float:
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))


def reference_fn(cfg: Config):
    """The plain einsum chain over the config's axes: a jitted forward
    transform of (re, im) planes."""
    import jax

    from pyfft_tpu.reference import fftn_planar

    axes = tuple(range(-len(cfg.shape), 0))
    return jax.jit(lambda re, im: fftn_planar(re, im, -1, axes=axes))


def check_config(cfg: Config, seed: int = 0) -> dict:
    """Phase 1 for one config; raises RuntimeError past a gate."""
    import jax
    import jax.numpy as jnp

    from pyfft_tpu import Plan

    gate = GATES[np.dtype(cfg.dtype)]
    plan = Plan(cfg.shape, cfg.dtype)
    data = make_data(cfg, seed)
    fwd = plan.execute(*data)
    fwd = fwd if cfg.split else (fwd,)
    back = plan.execute(*fwd, inverse=True)
    back = back if cfg.split else (back,)

    x, y = _to_complex(data), _to_complex(fwd)
    axes = tuple(range(-len(cfg.shape), 0))
    ref = np.fft.fftn(np.asarray(_head(x, cfg)).astype(np.complex128),
                      axes=axes)
    err = float(np.abs(np.asarray(_head(y, cfg)) - ref).max()
                / np.abs(ref).max())
    rt_err = _rel_err_device(_to_complex(back), x)
    del back

    re, im = (jnp.real(x), jnp.imag(x)) if not cfg.split else data
    rr, ri = reference_fn(cfg)(re, im)
    einsum_err = _rel_err_device(y, jax.lax.complex(rr, ri))
    stats = jax.devices()[0].memory_stats() or {}
    out = dict(config=cfg.name, err=err, roundtrip_err=rt_err,
               vs_einsum=einsum_err, gate=gate,
               peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    say("phase1", f"config {cfg.name} ({cfg.describe()}): fwd err vs "
        f"numpy.fft {err:.3e}, roundtrip err {rt_err:.3e}, vs einsum "
        f"reference {einsum_err:.3e} (gate {gate:g}; vs einsum 2x gate); "
        f"process peak_bytes_in_use so far {out['peak_bytes_in_use']}")
    require(err < gate, f"config {cfg.name}: forward error {err} >= {gate}")
    require(rt_err < gate,
            f"config {cfg.name}: roundtrip error {rt_err} >= {gate}")
    require(einsum_err < 2 * gate, f"config {cfg.name}: einsum "
            f"disagreement {einsum_err} >= {2 * gate}")
    return out


def check_api(n: int = 256, seed: int = 0) -> None:
    """The functional wrappers once each, against numpy.fft."""
    from pyfft_tpu import fft, fftn, ifft, irfft, rfft

    rng = np.random.RandomState(seed)
    z = (rng.standard_normal((4, n))
         + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    r = rng.standard_normal((4, n)).astype(np.float32)
    z3 = z.reshape(4, 16, n // 16)
    cases = (
        ("fft", fft(z), np.fft.fft(z.astype(np.complex128))),
        ("ifft", ifft(z), np.fft.ifft(z.astype(np.complex128))),
        ("fftn", fftn(z3), np.fft.fftn(z3.astype(np.complex128))),
        ("rfft", rfft(r), np.fft.rfft(r.astype(np.float64))),
        ("irfft", irfft(np.fft.rfft(r).astype(np.complex64)),
         r.astype(np.float64)),
    )
    gate = GATES[np.dtype(np.complex64)]
    for name, got, want in cases:
        err = float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())
        say("phase1", f"api {name} n={n}: err {err:.3e} (gate {gate:g})")
        require(err < gate, f"api {name}: error {err} >= {gate}")


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:.4f} ms"


def _fmt_times(label: str, t: dict) -> str:
    return (f"{label} median {_fmt_ms(t['median_s'])} (min "
            f"{_fmt_ms(t['min_s'])}, max {_fmt_ms(t['max_s'])}, n={t['n']})")


def time_config(cfg: Config, peak_bytes_per_s: float, card: str,
                reps: int = 20, seed: int = 0) -> dict:
    """Phase 2 for one config: ``Plan.execute`` end to end, and the two
    routes' jitted executables called directly (the same harness for both,
    so host overhead does not decide between them)."""
    import jax
    import jax.numpy as jnp

    from pyfft_tpu import Plan
    from pyfft_tpu.utils.profiling import summarize, time_calls

    plan = Plan(cfg.shape, cfg.dtype)
    data = make_data(cfg, seed)
    exe_t = summarize(time_calls(plan.execute, data, reps=reps))
    fn = plan._get_callable(False, "planar" if cfg.split else "complex")
    lax_t = summarize(time_calls(fn, data, reps=reps))
    mem = fn.lower(*data).compile().memory_analysis()
    planes = data if cfg.split else (jnp.real(data[0]), jnp.imag(data[0]))
    del data
    ref_t = summarize(time_calls(reference_fn(cfg), planes, reps=reps))
    del planes
    bound = cfg.io_bytes / peak_bytes_per_s
    stats = jax.devices()[0].memory_stats() or {}
    out = dict(config=cfg.name, execute=exe_t, lax_fft=lax_t, einsum=ref_t,
               bound_s=bound, share_of_bound=bound / exe_t["median_s"],
               peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    say("phase2", f"config {cfg.name} ({cfg.describe()}): "
        + _fmt_times("Plan.execute", exe_t) + "; "
        + _fmt_times("lax.fft executable", lax_t) + "; "
        + _fmt_times("einsum chain executable", ref_t)
        + f"; round-trip bound {_fmt_ms(bound)} at "
        f"{peak_bytes_per_s / 1e12:g} TB/s = {out['share_of_bound']:.3f} of "
        f"the execute median; card {card}")
    if mem is not None:
        say("phase2", f"config {cfg.name}: memory_analysis args "
            f"{mem.argument_size_in_bytes} B, outputs "
            f"{mem.output_size_in_bytes} B, temps {mem.temp_size_in_bytes} B;"
            f" peak_bytes_in_use {out['peak_bytes_in_use']}")
    return out


# ------------------------------------------------------------ multi-device

@dataclasses.dataclass(frozen=True)
class MultiCase:
    name: str
    rank: int
    shape: tuple[int, ...]       # transform shape
    batch: int
    dtype: type


MULTI_CASES = (
    MultiCase("1D c64 n=2^26 batch 8", 1, (1 << 26,), 8, np.complex64),
    MultiCase("2D c64 8192^2 batch 4", 2, (8192, 8192), 4, np.complex64),
    MultiCase("3D c64 512^3", 3, (512, 512, 512), 1, np.complex64),
    MultiCase("1D c128 n=2^22 batch 8", 1, (1 << 22,), 8, np.complex128),
)


def check_multi(case: MultiCase, devices, reps: int = 10,
                seed: int = 0) -> dict:
    """One distributed transform on a (dp=1, sp=len(devices)) mesh:
    forward vs numpy.fft on the first two batch rows, the roundtrip on the
    device, and the forward's median time."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pyfft_tpu.parallel import (make_dist_fft, make_dist_fft2,
                                    make_dist_fft3)
    from pyfft_tpu.utils.profiling import summarize, time_calls

    mesh = Mesh(np.array(devices).reshape(1, len(devices)), ("dp", "sp"))
    make = {1: make_dist_fft, 2: make_dist_fft2, 3: make_dist_fft3}[case.rank]
    arg = case.shape[0] if case.rank == 1 else case.shape
    fwd = make(mesh, arg, sign=-1)
    inv = make(mesh, arg, sign=+1, normalize=True)
    spec = P("dp", "sp", *([None] * (case.rank - 1)))
    sharding = NamedSharding(mesh, spec)
    full = (case.batch,) + case.shape
    rdt = np.float32 if case.dtype == np.complex64 else np.float64
    gate = GATES[np.dtype(case.dtype)]

    def gen(key):
        kr, ki = jax.random.split(key)
        return (jax.random.normal(kr, full, rdt),
                jax.random.normal(ki, full, rdt))

    re, im = jax.jit(gen, out_shardings=(sharding, sharding))(
        jax.random.PRNGKey(seed))
    fr, fi = fwd(re, im)
    rows = min(2, case.batch)
    axes = tuple(range(1, 1 + case.rank))
    x_head = (np.asarray(re[:rows]).astype(np.float64)
              + 1j * np.asarray(im[:rows]))
    ref = np.fft.fftn(x_head, axes=axes)
    got = np.asarray(fr[:rows]) + 1j * np.asarray(fi[:rows])
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    br, bi = inv(fr, fi)
    rt_err = float(jnp.maximum(jnp.max(jnp.abs(br - re)),
                               jnp.max(jnp.abs(bi - im)))
                   / jnp.maximum(jnp.max(jnp.abs(re)), jnp.max(jnp.abs(im))))
    del fr, fi, br, bi
    t = summarize(time_calls(fwd, (re, im), reps=reps))
    say("multi", f"{case.name} on mesh (dp=1, sp={len(devices)}): fwd err "
        f"vs numpy.fft {err:.3e}, roundtrip err {rt_err:.3e} (gate "
        f"{gate:g}); " + _fmt_times("fwd", t))
    require(err < gate, f"{case.name}: forward error {err} >= {gate}")
    require(rt_err < gate, f"{case.name}: roundtrip error {rt_err} >= {gate}")
    return dict(case=case.name, err=err, roundtrip_err=rt_err, time=t)


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-device path, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)     # config 5 is complex128
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); this check runs only on the card",
              file=sys.stderr)
        return 1
    from pyfft_tpu.utils.profiling import card_info, hbm_peak_bytes_per_s

    kind = devices[0].device_kind
    count = 4 if args.multi else 1
    say("phase0", f"JAX devices: {len(devices)} x {kind} "
        f"(platform {devices[0].platform}); using {count}")
    if len(devices) < count:
        print(f"chip_smoke: --multi needs {count} GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    card = card_info()
    say("phase0", f"nvidia-smi name, power.limit: {card}")
    peak = hbm_peak_bytes_per_s(kind)

    if args.multi:
        for case in MULTI_CASES:
            check_multi(case, devices[:count])
    else:
        for cfg in CONFIGS:
            check_config(cfg)
        check_api()
        for cfg in CONFIGS:
            time_config(cfg, peak, card.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
