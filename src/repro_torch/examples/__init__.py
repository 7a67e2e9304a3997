"""The port's example drivers (``python -m repro_torch.examples.<name>``)."""
