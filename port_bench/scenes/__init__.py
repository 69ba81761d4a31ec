"""scenes of the benchmark, found by name."""
