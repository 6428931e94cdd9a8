"""Operators of the port: plain PyTorch around the hand-written CUDA
kernels (``layernorm``, ``paged_attention``, ``flash_attention``,
``optimizer``) built by ``cuda_common``."""
from . import (attention, cuda_common, flash_attention, layernorm, nn,
               optimizer, paged_attention, sampling)

__all__ = ["attention", "cuda_common", "flash_attention", "layernorm", "nn",
           "optimizer", "paged_attention", "sampling"]
