"""Multi-device runs: particle data-parallelism over torch.distributed."""
