"""PyTorch/CUDA port of ``mxnet_tpu`` for one NVIDIA H100.

The serving slice: GPT-2 (``models``) through the generation engine and
continuous batcher (``inference``), with hand-written CUDA kernels for
paged attention and LayerNorm (``ops``, sources in ``csrc/``). Imports
torch, numpy and the standard library only. Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, which runs
the kernels' plain PyTorch versions.
"""
from . import base, config, inference, models, ops, serialization
from .base import MXNetError
from .inference import ContinuousBatcher, GenerationEngine, SamplingConfig
from .models import get_gpt2

__all__ = ["base", "config", "inference", "models", "ops", "serialization",
           "MXNetError", "ContinuousBatcher", "GenerationEngine",
           "SamplingConfig", "get_gpt2"]
