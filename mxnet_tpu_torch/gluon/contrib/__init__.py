"""``gluon.contrib`` of the port: the ``nn`` layers and the ``estimator``
(the high-level fit loop with event handlers)."""
from . import estimator, nn
from .estimator import Estimator

__all__ = ["estimator", "nn", "Estimator"]
