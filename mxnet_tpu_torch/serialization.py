"""``.params`` 0x112 tensor files and the weight carry into a module.

Counterpart of ``mxnet_tpu/serialization.py`` for dense arrays: the dmlc
NDArray list stream (magic 0x112, reserved u64, count, arrays with the
per-array magic 0xF993FAC9, shape, context, type flag and raw C-order
bytes, then names). Sparse blocks are refused. :func:`load_ndarrays`
returns numpy arrays, so it reads bfloat16 payloads (flag 12) widened to
float32, which is exact; :func:`load_tensors` returns CPU tensors and
keeps bfloat16. :func:`save_ndarrays` takes numpy arrays or tensors, and
writes a bfloat16 tensor as bfloat16.

:func:`load_mxnet_params` moves a ``{structural_name: array}`` dict (from a
``.params`` file, or from the JAX package's
``net._collect_params_with_prefix()``) into a module's parameters.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np
import torch

from .base import FLAG_TO_DTYPE, MXNetError, dtype_flag

__all__ = ["save_ndarrays", "load_ndarrays", "load_tensors",
           "load_mxnet_params", "mxnet_params"]

NDARRAY_MAGIC = 0x112  # dmlc NDArray list magic
_SINGLE_MAGIC = 0xF993FAC9  # per-array magic in MXNet >= 1.0 (V2, dense)
_BF16_FLAG = 12


def _host(arr):
    """``(C-order numpy payload, type flag)`` of a numpy array or tensor."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16_FLAG
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr, dtype_flag(arr.dtype)


def _write_one(f, arr) -> None:
    arr, flag = _host(arr)
    f.write(struct.pack("<I", _SINGLE_MAGIC))
    f.write(struct.pack("<I", arr.ndim))
    for s in arr.shape:
        f.write(struct.pack("<q", s))
    f.write(struct.pack("<ii", 1, 0))  # context: cpu(0)
    f.write(struct.pack("<i", flag))
    f.write(arr.tobytes())


def _read_one(f, bf16_tensor=False):
    magic = struct.unpack("<I", f.read(4))[0]
    if magic != _SINGLE_MAGIC:
        raise MXNetError(f"unsupported NDArray block magic {magic:#x} "
                         "(only dense V2 arrays are read)")
    ndim = struct.unpack("<I", f.read(4))[0]
    shape = tuple(struct.unpack("<q", f.read(8))[0] for _ in range(ndim))
    f.read(8)  # context
    flag = struct.unpack("<i", f.read(4))[0]
    if flag not in FLAG_TO_DTYPE:
        raise MXNetError(f"unknown type flag {flag} in .params stream")
    n = int(np.prod(shape)) if shape else 1
    if flag == _BF16_FLAG:
        raw = np.frombuffer(f.read(2 * n), dtype=np.uint16)
        if bf16_tensor:
            return torch.from_numpy(raw.view(np.int16).copy()).view(
                torch.bfloat16).reshape(shape)
        return (raw.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    dt = np.dtype(FLAG_TO_DTYPE[flag])
    return np.frombuffer(f.read(n * dt.itemsize), dtype=dt).reshape(shape).copy()


def _array(v):
    return v if torch.is_tensor(v) else np.asarray(v)


def save_ndarrays(fname: str, data: Union[Dict[str, np.ndarray],
                                          List[np.ndarray]]) -> None:
    """Write a dict (named) or list of numpy arrays or tensors as a
    ``.params`` file."""
    if isinstance(data, dict):
        names, arrays = list(data.keys()), [_array(v) for v in data.values()]
    else:
        names, arrays = [], [_array(v) for v in data]
    with open(fname, "wb") as f:
        f.write(struct.pack("<Q", NDARRAY_MAGIC))
        f.write(struct.pack("<Q", 0))  # reserved
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_one(f, a)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load_ndarrays(fname: str, _bf16_tensor=False
                  ) -> Union[Dict[str, np.ndarray], List[np.ndarray]]:
    """Read a ``.params`` file: a dict if it carries names, else a list."""
    with open(fname, "rb") as f:
        magic = struct.unpack("<Q", f.read(8))[0]
        if magic != NDARRAY_MAGIC:
            raise MXNetError(f"{fname}: not an MXNet .params file "
                             f"(magic {magic:#x})")
        f.read(8)
        count = struct.unpack("<Q", f.read(8))[0]
        arrays = [_read_one(f, _bf16_tensor) for _ in range(count)]
        nname = struct.unpack("<Q", f.read(8))[0]
        names = [f.read(struct.unpack("<Q", f.read(8))[0]).decode()
                 for _ in range(nname)]
    if names:
        return dict(zip(names, arrays))
    return arrays


def load_tensors(fname: str):
    """:func:`load_ndarrays` as CPU tensors, bfloat16 kept as bfloat16."""
    loaded = load_ndarrays(fname, _bf16_tensor=True)

    def as_tensor(a):
        return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))

    if isinstance(loaded, dict):
        return {k: as_tensor(v) for k, v in loaded.items()}
    return [as_tensor(v) for v in loaded]


def load_mxnet_params(module: torch.nn.Module, arrays) -> None:
    """Copy ``{structural_name: array}`` into ``module``'s parameters, cast
    to each parameter's dtype on its device. Every name and shape is
    checked; a missing, extra or misshapen entry raises ``MXNetError`` and
    leaves the module untouched."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    host = {}
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"{name}: shape {tuple(a.shape)} does not match "
                             f"the parameter's {tuple(p.shape)}")
        host[name] = torch.from_numpy(np.array(a))  # a private copy
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(host[name].to(device=p.device, dtype=p.dtype))


def mxnet_params(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The module's parameters as ``{structural_name: float32 numpy}``,
    ready for :func:`save_ndarrays`."""
    return {n: p.detach().float().cpu().numpy()
            for n, p in module.named_parameters()}
