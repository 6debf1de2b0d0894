"""One reader a metric, named as in BENCHMARK.json (``spec``): each file
defines ``read(ctx)``, which returns the metric's number from a
``harness.Context``, or None where it finds nothing to read."""
