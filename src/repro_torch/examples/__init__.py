"""Runnable end-to-end consumers of the port (``python -m
repro_torch.examples.<name>``)."""
