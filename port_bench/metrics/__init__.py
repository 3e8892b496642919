"""One reader a metric, found by the metric's name in BENCHMARK.json: a
module `<name>.py` whose `read(window)` returns the metric's value for the
run (`run.Window`), or None where the run gives it nothing to read (the
metric is then left out of the result line)."""
