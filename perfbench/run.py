"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiler trace of the window.  The run needs as
many GPUs as the cell asks for; without them it exits non-zero and prints
no result.
"""

import time

T_START = time.perf_counter()     # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root: the program under test and this package.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import jax

    from perfbench import harness, spec

    harness.use_compile_cache()
    bench = spec.benchmark()
    cell = spec.load_cell(args.workload, bench)
    spec.module("entries", cell.config["entry"])     # the program under test
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} GPU(s); JAX has "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 2
    devices = devices[:cell.chips]
    print(f"[run] {cell.name} seed {args.seed} on {len(devices)} x "
          f"{devices[0].device_kind}; compile cache "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         devices, T_START, bench)
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
