"""The readers of the benchmark's metrics, one module a metric, found by its name."""
