"""Dense and MoE decoder models (port of repro/models)."""
