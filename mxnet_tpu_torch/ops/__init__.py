"""Operators of the port: plain PyTorch around the hand-written CUDA
kernels (``layernorm``, ``paged_attention``, ``flash_attention``,
``optimizer``, ``softmax_xent``) built by ``cuda_common``."""
from . import (attention, contrib_vision, core, cuda_common, extra,
               flash_attention, layernorm, linalg, nn, optimizer,
               optimizer_ops, paged_attention, random_ops, sampling,
               softmax_xent)

__all__ = ["attention", "contrib_vision", "core", "cuda_common", "extra",
           "flash_attention", "layernorm", "linalg", "nn", "optimizer",
           "optimizer_ops", "paged_attention", "random_ops", "sampling",
           "softmax_xent"]
