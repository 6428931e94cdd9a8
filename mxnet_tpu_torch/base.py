"""Core error model, dtype names and device resolution.

PyTorch counterpart of ``mxnet_tpu/base.py``: the same ``MXNetError`` and
the MXNet 1.x type-flag table (kept for ``.params`` compatibility), with
dtype names mapped onto ``torch.dtype`` instead of numpy/JAX dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "dtype_torch", "dtype_name", "dtype_flag",
           "resolve_device"]


class MXNetError(RuntimeError):
    """Root error type (analog of ``dmlc::Error`` surfaced via MXGetLastError)."""


# MXNet 1.x type-flag table (include/mxnet/base.h / mshadow kFloat32 etc.).
_DTYPE_TO_FLAG = {
    "float32": 0,
    "float64": 1,
    "float16": 2,
    "uint8": 3,
    "int32": 4,
    "int8": 5,
    "int64": 6,
    "bool": 7,
    "bfloat16": 12,
}
FLAG_TO_DTYPE = {v: k for k, v in _DTYPE_TO_FLAG.items()}

_TORCH = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAME = {v: k for k, v in _TORCH.items()}


def dtype_torch(dtype) -> torch.dtype:
    """Canonicalise a dtype spec (name, numpy dtype or torch dtype)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _TORCH:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _TORCH[name]


def dtype_name(dtype) -> str:
    """Stable string name for a dtype (bfloat16-aware)."""
    return _NAME[dtype_torch(dtype)]


def dtype_flag(dtype) -> int:
    """MXNet serialization type flag for ``dtype`` (for .params compat)."""
    return _DTYPE_TO_FLAG[dtype_name(dtype)]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; the CPU
    is taken only when the caller names it, never as a silent substitute."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("CUDA is not available; pass device='cpu' to "
                             "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
