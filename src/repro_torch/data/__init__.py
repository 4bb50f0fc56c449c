"""Synthetic training data of the port (port of repro/data)."""
from .pipeline import DataLoader, make_batch

__all__ = ["DataLoader", "make_batch"]
