"""Core MRA-2 serving math (port of repro/core)."""
