"""Training steps: the single-device ``TrainStep``."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
