"""Episode-batched runs: sweeps and evidence-raced replicas."""
