"""LM decoding samplers with an explicit ``torch.Generator``.

Counterpart of ``temperature_sampling`` and ``top_k_sampling`` in
``mxnet_tpu/ops/random_ops.py``. The two frameworks draw different numbers
from the same seed, so the samplers agree with JAX in distribution, not
draw by draw.
"""
from __future__ import annotations

import torch

__all__ = ["temperature_sampling", "top_k_sampling"]


def temperature_sampling(logits, temperature=1.0, generator=None):
    """Token ids drawn from ``softmax(logits / temperature)`` over the last
    axis. ``temperature=0`` is greedy argmax (no draw)."""
    if not temperature:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / float(temperature), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(probs.shape[:-1]).to(torch.int32)


def top_k_sampling(logits, k=40, temperature=1.0, generator=None):
    """Sample among the ``k`` largest logits: the rest are masked to -inf,
    then temperature-sampled. ``k <= 0`` or ``k >= vocab`` truncates
    nothing."""
    k = int(k)
    if 0 < k < logits.shape[-1]:
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return temperature_sampling(logits, temperature=temperature,
                                generator=generator)
