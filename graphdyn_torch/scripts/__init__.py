"""Measurement scripts of the port, run as ``python -m
graphdyn_torch.scripts.<name>``."""
