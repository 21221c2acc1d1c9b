"""Command-line entry points of the port (``python -m
hpvaegan_tpu_torch.cli.<name>``)."""
