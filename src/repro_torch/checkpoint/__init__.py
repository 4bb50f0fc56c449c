"""Checkpointing of the port (port of repro/checkpoint)."""
from .ckpt import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
