"""Runtime feature introspection (reference: ``src/libinfo.cc`` +
``python/mxnet/runtime.py``, ``mx.runtime.Features()``).

Counterpart of ``mxnet_tpu/runtime.py``, with its key set, so
``is_enabled`` accepts every name the JAX package's accepts. On this
stack ``CUDA``, ``CUDNN`` and ``NCCL`` come from torch's own availability
calls; ``TPU``, ``XLA`` and ``PALLAS`` are false; ``FLASH_ATTENTION`` says
whether the port's hand-written kernels (built for ``sm_90a``) target the
present card, read from its compute capability: detecting it builds
nothing. ``DIST_KVSTORE`` and ``RING_ATTENTION`` are false until the
multi-device slice ports them.
"""
from __future__ import annotations

import importlib.util

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    cuda = torch.cuda.is_available()
    hopper = cuda and torch.cuda.get_device_capability() == (9, 0)
    nccl = torch.distributed.is_available() and \
        torch.distributed.is_nccl_available()
    return {
        "TPU": False,
        "XLA": False,
        "PALLAS": False,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "DIST_KVSTORE": False,
        "RECORDIO": True,
        "FLASH_ATTENTION": hopper,
        "RING_ATTENTION": False,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and nccl,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "TENSORRT": False,
        "OPENCV": importlib.util.find_spec("cv2") is not None,
    }


class Features(dict):
    def __init__(self):
        super().__init__({k: Feature(k, v) for k, v in _detect().items()})

    def is_enabled(self, name):
        return self[name.upper()].enabled

    def __repr__(self):
        return "[" + ", ".join(repr(v) for v in self.values()) + "]"


def feature_list():
    return list(Features().values())
