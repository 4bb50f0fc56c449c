"""Optimizer of the port (port of repro/optim)."""
from .adamw import AdamW, AdamWState, cosine_schedule

__all__ = ["AdamW", "AdamWState", "cosine_schedule"]
