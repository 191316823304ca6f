"""The benchmark of pyfft_tpu: one cell (a transform configuration under one
traffic mix) per run, found by name in BENCHMARK.json.  See README.md."""
