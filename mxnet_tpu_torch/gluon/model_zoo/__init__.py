"""The model zoo of the port (``mxnet_tpu/gluon/model_zoo/``)."""
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
