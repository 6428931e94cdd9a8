"""The NN ops of the serving path.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``fully_connected``, the
``layer_norm`` dispatch, ``tanh_gelu``) and ``mxnet_tpu/ops/core.py``
(``embedding``). Matrix products stay ``torch.matmul``, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config as _config
from ..contrib import amp as _amp
from . import layernorm as _ln

__all__ = ["fully_connected", "layer_norm", "tanh_gelu", "embedding"]


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias``; weight is (out, in) as in MXNet and
    ``torch.nn.Linear``. Under a global ``amp.init`` dtype an f32 input is
    multiplied in that dtype with an f32 sum and an f32 result, as the JAX
    ``preferred_element_type=f32`` product: the operands are rounded to the
    low-precision dtype and their products (exact in f32) summed in f32."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    adt = _amp.compute_dtype()
    if adt is not None and data.dtype == torch.float32:
        out = torch.matmul(data.to(adt).float(), weight.to(adt).float().t())
    else:
        out = torch.matmul(data, weight.t())
    if bias is not None:
        out = out + bias
    return out


def layer_norm(data, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis: the kernel when ``fused_layernorm`` is
    on (the default) and the input is f32 or bf16, else the plain
    composition. Float16 takes the composition, as the JAX gate sends it
    there (a dispatch rule: the kernel is built for f32 and bf16)."""
    if _config.get("fused_layernorm") and data.dtype in (torch.float32,
                                                          torch.bfloat16):
        return _ln.layer_norm(data, gamma, beta, eps)
    return _ln.layer_norm_plain(data, gamma, beta, eps)


def tanh_gelu(x):
    """GELU with the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def embedding(data, weight):
    """Row lookup ``weight[data]``. Indices must lie in range: unlike
    ``jnp.take``, which fills NaN for an out-of-range index, an
    out-of-range index here is a device-side assert on the card, so
    callers clamp or validate first."""
    return F.embedding(data.long(), weight)
