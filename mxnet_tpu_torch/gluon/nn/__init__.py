"""Gluon ``nn`` layers of the port."""
from .basic_layers import (Activation, Dense, Dropout, Embedding,
                           HybridSequential, LayerNorm, Sequential)

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "HybridSequential",
           "LayerNorm", "Sequential"]
