"""Gluon layers of the port as ``torch.nn.Module``s."""
from . import nn

__all__ = ["nn"]
