"""Optimizer of the port (port of repro/optim)."""
from .adamw import AdamW, AdamWState, ZeroPlan, cosine_schedule, zero_pspec, zero_plan
from .compression import EFState, compress, decompress, init_ef

__all__ = ["AdamW", "AdamWState", "EFState", "ZeroPlan", "compress",
           "cosine_schedule", "decompress", "init_ef", "zero_plan",
           "zero_pspec"]
