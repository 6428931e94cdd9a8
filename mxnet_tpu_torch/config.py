"""Runtime knobs of the port: the subset of ``mxnet_tpu/config.py`` that
the serving and training slices read, under the same names and
``MXNET_TPU_*`` aliases.

Switching a knob off is an explicit choice of the plain PyTorch version of
that kernel; it is never a fallback taken on failure.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["get", "set"]

# name -> (type, default, env aliases, doc)
_KNOBS: Dict[str, tuple] = {
    # On the TPU this knob defaults off because XLA fuses the plain
    # composition itself. Eager PyTorch fuses nothing: the plain version is
    # six launches with f32 intermediates in device memory, so the port
    # routes LayerNorm through its one-pass kernel by default.
    "fused_layernorm": (bool, True, ("MXNET_TPU_FUSED_LAYERNORM",),
                        "route LayerNorm through the CUDA kernel "
                        "(off = the plain PyTorch composition)"),
    "paged_attention_kernel": (bool, True, ("MXNET_TPU_PAGED_ATTENTION_KERNEL",),
                               "cached (dense and paged) attention reads "
                               "through the CUDA page-table kernel (off = "
                               "the plain PyTorch version)"),
    "flash_attention": (bool, True, ("MXNET_TPU_FLASH_ATTENTION",),
                        "unmasked full-sequence attention through the "
                        "flash kernels (off = the plain einsum path, "
                        "_reference_mha)"),
    "flash_pallas_bwd": (bool, True, ("MXNET_TPU_FLASH_PALLAS_BWD",),
                         "flash backward through the dK/dV and dQ CUDA "
                         "kernels (off = the plain PyTorch FlashAttention-2 "
                         "backward)"),
    # On the TPU this knob defaults off because XLA already fuses the plain
    # Adam chain into one pass. Eager PyTorch fuses nothing: the plain update
    # is about ten elementwise launches per parameter (292 parameters at
    # gpt2_345m), each a full pass over device memory, so the port routes
    # TrainStep's update through the one multi-tensor kernel by default.
    "fused_adam": (bool, True, ("MXNET_TPU_FUSED_ADAM",),
                   "Adam updates through the multi-tensor CUDA kernel, one "
                   "launch for all parameters (off = the plain per-tensor "
                   "PyTorch update)"),
}

_values: Dict[str, Any] = {}


def _parse(typ, raw):
    if typ is bool:
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    return typ(raw)


def get(name: str):
    if name not in _KNOBS:
        raise KeyError(f"unknown knob {name!r}")
    if name in _values:
        return _values[name]
    typ, default, envs, _ = _KNOBS[name]
    for env in envs:
        if env in os.environ:
            return _parse(typ, os.environ[env])
    return default


def set(name: str, value) -> None:  # noqa: A001 - mirrors mxnet_tpu.config.set
    if name not in _KNOBS:
        raise KeyError(f"unknown knob {name!r}")
    _values[name] = _parse(_KNOBS[name][0], value)
