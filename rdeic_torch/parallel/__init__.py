"""Multi-device: the dp x tp mesh, data-parallel rows and torch.distributed."""
