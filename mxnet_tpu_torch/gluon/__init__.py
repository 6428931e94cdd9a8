"""Gluon: parameters, blocks, layers (``nn``), losses (``loss``) and the
imperative ``Trainer``."""
from . import parameter
from .parameter import Constant, Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import data, loss, nn
from . import trainer
from .trainer import Trainer

__all__ = ["parameter", "Constant", "Parameter", "ParameterDict", "block",
           "Block", "HybridBlock", "SymbolBlock", "data", "loss", "nn",
           "trainer",
           "Trainer"]
