"""Training: the trainer, its EMA, and the CLI (`python -m rdeic_torch.train`)."""
