"""Optimizer of the port (port of repro/optim)."""
from .adamw import AdamW, AdamWState, cosine_schedule
from .compression import EFState, compress, decompress, init_ef

__all__ = ["AdamW", "AdamWState", "EFState", "compress", "cosine_schedule",
           "decompress", "init_ef"]
