"""entries of the benchmark, found by name."""
