"""Gluon: parameters, blocks, layers (``nn``, ``contrib.nn``, ``rnn``), losses
(``loss``), the vision ``model_zoo``, the imperative ``Trainer`` and
``utils``."""
from . import parameter
from .parameter import Constant, Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import data, loss, nn, rnn
from . import contrib, model_zoo
from . import trainer, utils
from .trainer import Trainer

__all__ = ["parameter", "Constant", "Parameter", "ParameterDict", "block",
           "Block", "HybridBlock", "SymbolBlock", "data", "loss", "nn", "rnn",
           "contrib", "model_zoo", "trainer", "utils",
           "Trainer"]
