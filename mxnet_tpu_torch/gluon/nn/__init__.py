"""Gluon ``nn`` layers of the port."""
from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm, Dense,
                           Dropout, Embedding, Flatten, HybridLambda,
                           HybridSequential, InstanceNorm, Lambda, LayerNorm,
                           LeakyReLU, PReLU, Sequential, Swish)
from .conv_layers import (AvgPool1D, AvgPool2D, Conv1D, Conv2D,
                          Conv2DTranspose, Conv3D, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalMaxPool2D, MaxPool1D,
                          MaxPool2D)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "ELU", "Embedding",
           "Flatten", "GELU", "HybridLambda", "HybridSequential",
           "InstanceNorm", "Lambda", "LayerNorm", "LeakyReLU", "PReLU",
           "SELU", "Sequential", "Swish", "AvgPool1D", "AvgPool2D", "Conv1D",
           "Conv2D", "Conv2DTranspose", "Conv3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalMaxPool2D", "MaxPool1D", "MaxPool2D"]
