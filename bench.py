"""Headline benchmark — prints ONE JSON line on standard output.

Metric (BASELINE.md): effective GFLOP/s = 5*N*log2(N)*batch / t on the
headline config (#2: 1D complex64, N=4096, batch=4096), with t the median
of 20 ``Plan.execute`` calls on device-resident planar data, each ending in
``block_until_ready``, after warm-up — the same timing ``chip_smoke.py``
prints for config 2.

vs_baseline: ratio against the BASELINE north-star target, 70% of the
single device-memory round-trip roofline for this config at the card's
published bandwidth (``utils.profiling.HBM_PEAK_BYTES_PER_S``, keyed by
device kind; a card not in that table is an error).  1.0 means the target
is met.

Runs only on a GPU: on any other platform it exits non-zero and prints no
result.  The card's name and power limit go to standard error.
"""

from __future__ import annotations

import json
import sys

import chip_smoke


def main() -> int:
    import jax

    from pyfft_tpu import Plan
    from pyfft_tpu.utils.profiling import (card_info, effective_gflops,
                                           hbm_peak_bytes_per_s, summarize,
                                           time_calls)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    peak = hbm_peak_bytes_per_s(dev.device_kind)
    card = card_info()
    print(f"card (nvidia-smi name, power.limit): {card}", file=sys.stderr)

    cfg = next(c for c in chip_smoke.CONFIGS if c.name == "2")
    plan = Plan(cfg.shape, cfg.dtype)
    t = summarize(time_calls(plan.execute, chip_smoke.make_data(cfg)))
    gflops = effective_gflops(cfg.shape, cfg.batch, t["median_s"])
    bound = cfg.io_bytes / peak
    roof = effective_gflops(cfg.shape, cfg.batch, bound)
    target = 0.70 * roof
    print(json.dumps({
        "metric": (f"effective GFLOP/s, 1D c64 FFT N={cfg.shape[0]} "
                   f"batch={cfg.batch} (5N·log2N/t)"),
        "value": gflops,
        "unit": "GFLOP/s",
        "vs_baseline": gflops / target,
        "extra": {
            "device_kind": dev.device_kind, "card": card,
            "median_ms": t["median_s"] * 1e3, "min_ms": t["min_s"] * 1e3,
            "max_ms": t["max_s"] * 1e3, "n": t["n"],
            "bound_ms": bound * 1e3, "roofline_gflops": roof,
            "target_gflops_70pct_roofline": target,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
