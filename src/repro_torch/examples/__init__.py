"""Runnable examples of the port, as ``python -m repro_torch.examples.<name>``."""
