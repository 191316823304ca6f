"""Readings that set a cell's limits: the numbers check.py compares, from
the program over many seeds and from the control over a few, in one
process (one set-up), each through a short window at the cell's own size.

    python3 perfbench/limits.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 --seconds 2

Prints one JSON line per seed and, last, the lower reading (largest of the
program) and the upper reading (smallest of the control) of each number.
A limit lies between them (limits/<cell>.json).  The benchmark's own runs
never run the control.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import jax

    from perfbench import check, harness, spec

    harness.use_compile_cache()
    cell = spec.load_cell(args.workload)
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < cell.chips:
        print(f"limits.py: {cell.name} needs {cell.chips} GPU(s)",
              file=sys.stderr)
        return 2
    devices = devices[:cell.chips]
    reference = spec.module("references", cell.config["reference"])
    program = spec.module("entries", cell.config["entry"]).build(
        cell.config, cell.traffic, devices)
    readings = {}
    for side, target, seeds in (
            ("program", program, args.seeds),
            ("control", check.Control(program, reference),
             args.control_seeds)):
        for i, seed in enumerate(map(int, seeds.split(","))):
            t0 = time.perf_counter()
            inputs = harness.make_inputs(target, cell.traffic, seed)
            if i == 0:
                harness.warm_up(target, inputs[0])
            w = harness.run_window(target, cell.traffic, inputs, seed,
                                   args.seconds)
            del inputs
            numbers = check.compare(target, w.samples, reference)
            readings.setdefault(side, []).append(numbers)
            print(json.dumps({"side": side, "seed": seed, **numbers,
                              "calls": len(w.call_s),
                              "pairs": len(w.samples),
                              "compiles": w.compiles,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            del w
    # A control reading that is no number has failed and sets no upper end.
    summary = {k: {"lower": max(r[k] for r in readings["program"]),
                   "upper": min((r[k] for r in readings["control"]
                                 if math.isfinite(r[k])), default=None)}
               for k in cell.limits}
    print(json.dumps({"workload": cell.name, "kind": devices[0].device_kind,
                      "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
