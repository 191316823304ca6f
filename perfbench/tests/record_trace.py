"""Record a short traced window of a cell for the reduction's tests.

    python3 perfbench/tests/record_trace.py --workload <cell> \\
        --seconds 0.05 --out perfbench/testdata/<cell>.xplane.pb

Runs on the cell's chips like run.py (set-up, warm-up, then the window
under the profiler, each call in the harness's span) and copies the
profiler's ``.xplane.pb`` to ``--out``.
"""

import argparse
import glob
import os
import shutil
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import jax

    from perfbench import harness, spec, tracing

    harness.use_compile_cache()
    cell = spec.load_cell(args.workload)
    devices = jax.devices()[:cell.chips]
    target = spec.module("entries", cell.config["entry"]).build(
        cell.config, cell.traffic, devices)
    inputs = harness.make_inputs(target, cell.traffic, args.seed)
    harness.warm_up(target, inputs[0])
    logdir = str(harness.TRACE_DIR / "record")
    with tracing.capture(logdir):
        w = harness.run_window(target, cell.traffic, inputs, args.seed,
                               args.seconds, traced=True)
    (path,) = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                        recursive=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    shutil.copy(path, args.out)
    print(f"{len(w.call_s)} calls traced; {os.path.getsize(args.out)} bytes "
          f"in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
