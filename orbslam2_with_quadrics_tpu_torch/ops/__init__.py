"""Device compute ops on torch tensors (no host state)."""
