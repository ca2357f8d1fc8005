"""Token pipelines: deterministic, step-addressable batches (numpy)."""
