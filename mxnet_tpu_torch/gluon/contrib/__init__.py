"""``gluon.contrib`` of the port: the ``nn`` layers (the estimator is not
ported yet)."""
from . import nn

__all__ = ["nn"]
