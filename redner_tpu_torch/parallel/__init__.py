"""Multi-GPU rendering over torch.distributed (see parallel.sharding)."""
