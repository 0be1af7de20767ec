"""One reader per metric, found by the metric's name in BENCHMARK.json:
``read(record)`` returns the value, or None where the run has nothing to
read (the harness then leaves the metric out)."""
