"""Operators of the port: plain PyTorch around two hand-written CUDA
kernels (``layernorm``, ``paged_attention``) built by ``cuda_common``."""
from . import attention, cuda_common, layernorm, nn, paged_attention, sampling

__all__ = ["attention", "cuda_common", "layernorm", "nn", "paged_attention",
           "sampling"]
