"""Metric readers, one file a metric of ``BENCHMARK.json``: each has
``read(run)``, which returns the metric from the run
(``nmfbench.harness.Run``) or None where it finds nothing to read."""
