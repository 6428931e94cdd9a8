"""PyTorch/CUDA port of ``mxnet_tpu`` for one NVIDIA H100.

Two slices so far: serving GPT-2 (``models``) through the generation
engine and continuous batcher (``inference``), and training it through the
single-device ``TrainStep`` (``parallel``) with ``Adam`` (``optimizer``).
The kernels on those paths are hand-written CUDA (``ops``, sources in
``csrc/``): paged attention, LayerNorm, flash attention (forward, dK/dV,
dQ) and multi-tensor Adam. Imports torch, numpy and the standard library
only. Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""
from . import (base, config, inference, models, ops, optimizer, parallel,
               serialization)
from .base import MXNetError
from .inference import ContinuousBatcher, GenerationEngine, SamplingConfig
from .models import get_gpt2
from .parallel import TrainStep

__all__ = ["base", "config", "inference", "models", "ops", "optimizer",
           "parallel", "serialization", "MXNetError", "ContinuousBatcher",
           "GenerationEngine", "SamplingConfig", "TrainStep", "get_gpt2"]
