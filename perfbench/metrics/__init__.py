"""One reader per metric, named as in BENCHMARK.json.

``read(r)`` takes the run's ``harness.Readings`` and returns the metric's
value, or None where the run holds nothing to read (the harness then leaves
the metric out of the result line).
"""
