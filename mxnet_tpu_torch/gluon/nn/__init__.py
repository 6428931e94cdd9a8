"""Gluon ``nn`` layers of the port."""
from .basic_layers import (Dense, Dropout, Embedding, HybridSequential,
                           LayerNorm, initialize)

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential", "LayerNorm",
           "initialize"]
