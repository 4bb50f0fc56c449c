"""Dense decoder model (port of repro/models)."""
