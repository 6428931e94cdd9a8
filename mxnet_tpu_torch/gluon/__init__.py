"""Gluon layers (``nn``) and loss blocks (``loss``) of the port as
``torch.nn.Module``s."""
from . import loss, nn

__all__ = ["loss", "nn"]
