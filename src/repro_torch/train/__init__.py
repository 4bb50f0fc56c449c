"""Training loop of the port (port of repro/train)."""
from .loop import TrainConfig, make_train_step, train

__all__ = ["TrainConfig", "make_train_step", "train"]
