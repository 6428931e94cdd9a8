"""GPT-2 as a ``HybridBlock`` (so a ``torch.nn.Module``).

Counterpart of ``mxnet_tpu/models/gpt2.py``: pre-LN decoder blocks, a
weight-tied LM head, and the cached forward that the generation engine
drives (dense ``(B, H, Tmax, Ch)`` buffers or paged pools with per-row page
tables). Structural parameter names equal the JAX package's
(``word_embed.weight``, ``blocks.{i}.qkv.weight``, ``ln_f.gamma``, ...),
and so do the Gluon names of ``collect_params()`` (``gpt2model0_layer0_
qkv_weight``, ...). ``get_gpt2(name)`` builds on ``device`` (the current
context by default) and draws the weights at once from ``seed``, so the
engine and ``TrainStep`` need no ``initialize()``; a later
``initialize()`` leaves them as they are, as for any initialized
parameter (``force_reinit=True`` draws again from ``mx.random``).
"""
from __future__ import annotations

import torch

from .. import initializer as init
from ..context import as_device
from ..contrib import amp as _amp
from ..gluon import nn as gnn
from ..gluon.block import HybridBlock
from ..ops import nn as _ops
from ..ops.attention import (alloc_kv_cache, alloc_paged_kv_cache,
                             multi_head_attention)

__all__ = ["GPT2Model", "get_gpt2", "gpt2_configs", "lm_loss"]

gpt2_configs = {
    "gpt2_tiny": dict(num_layers=2, units=128, num_heads=2, max_length=512,
                      vocab_size=50257),
    "gpt2_117m": dict(num_layers=12, units=768, num_heads=12, max_length=1024,
                      vocab_size=50257),
    "gpt2_345m": dict(num_layers=24, units=1024, num_heads=16, max_length=1024,
                      vocab_size=50257),
    "gpt2_774m": dict(num_layers=36, units=1280, num_heads=20, max_length=1024,
                      vocab_size=50257),
}


class GPT2Block(HybridBlock):
    # one rematerialization unit under ``net.hybridize(remat=True)``
    _remat_unit = True

    def __init__(self, units, num_heads, dropout=0.1, dtype="float32",
                 device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._heads = num_heads
        kw = dict(dtype=dtype, device=as_device(device))
        normal = init.Normal(0.02)
        with self.name_scope():
            self.ln1 = gnn.LayerNorm(in_channels=units, prefix="ln1_", **kw)
            self.qkv = gnn.Dense(3 * units, flatten=False, in_units=units,
                                 prefix="qkv_", weight_initializer=normal,
                                 **kw)
            self.proj = gnn.Dense(units, flatten=False, in_units=units,
                                  prefix="proj_", weight_initializer=normal,
                                  **kw)
            self.ln2 = gnn.LayerNorm(in_channels=units, prefix="ln2_", **kw)
            self.ffn1 = gnn.Dense(4 * units, flatten=False, in_units=units,
                                  prefix="ffn1_", weight_initializer=normal,
                                  **kw)
            self.ffn2 = gnn.Dense(units, flatten=False, in_units=4 * units,
                                  prefix="ffn2_", weight_initializer=normal,
                                  **kw)
            self.drop = gnn.Dropout(dropout)

    def hybrid_forward(self, F, x, cache=None, start_pos=None,
                       page_table=None):
        b, t, c = x.shape
        h = self._heads
        y = self.ln1(x)
        qkv = self.qkv(y).reshape(b, t, 3, h, c // h).permute(2, 0, 3, 1, 4)
        if cache is None:
            att = multi_head_attention(qkv[0], qkv[1], qkv[2], causal=True)
        else:
            # only the t new tokens flow through; the K/V history lives in
            # the cache (updated in place)
            att, k_buf, v_buf = multi_head_attention(
                qkv[0], qkv[1], qkv[2], cache=cache, position=start_pos,
                page_table=page_table)
        att = att.transpose(1, 2).reshape(b, t, c)
        x = x + self.drop(self.proj(att))
        y = self.ffn2(_ops.tanh_gelu(self.ffn1(self.ln2(x))))
        out = x + self.drop(y)
        return out if cache is None else (out, (k_buf, v_buf))


class GPT2Model(HybridBlock):
    """GPT-2. Weights are drawn from ``torch.Generator().manual_seed(seed)``
    (the initializers of the JAX model: Normal(0.02) for the embeddings and
    projections, Normal(0.01) for positions, ones/zeros for LayerNorm)."""

    def __init__(self, num_layers=12, units=768, num_heads=12, max_length=1024,
                 vocab_size=50257, dropout=0.1, dtype="float32", device=None,
                 seed=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._max_length = max_length
        kw = dict(dtype=dtype, device=device)
        with self.name_scope():
            self.word_embed = gnn.Embedding(
                vocab_size, units, prefix="word_embed_",
                weight_initializer=init.Normal(0.02), **kw)
            self.position_embed = gnn.Embedding(
                max_length, units, prefix="position_embed_",
                weight_initializer=init.Normal(0.01), **kw)
            self.drop = gnn.Dropout(dropout)
            self.blocks = gnn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.blocks.add(GPT2Block(units, num_heads, dropout,
                                          prefix=f"layer{i}_", **kw))
            self.ln_f = gnn.LayerNorm(in_channels=units, prefix="lnf_", **kw)
        self._draw(torch.Generator().manual_seed(int(seed)), device)

    @property
    def device(self) -> torch.device:
        return self.word_embed.weight.device

    def init_cache(self, batch_size, max_length=None, dtype="float32"):
        """Per-layer ``(k_buf, v_buf)`` decode buffers (B, H, Tmax, Ch)."""
        return alloc_kv_cache(batch_size, self._num_heads,
                              max_length or self._max_length,
                              self._units // self._num_heads,
                              self._num_layers, dtype=dtype,
                              device=self.device)

    def init_paged_cache(self, num_pages, page_size, dtype="float32"):
        """Per-layer ``(k_pool, v_pool)`` page pools
        (num_pages + 1, H, page_size, Ch); page 0 is the trash page."""
        return alloc_paged_kv_cache(num_pages, self._num_heads, page_size,
                                    self._units // self._num_heads,
                                    self._num_layers, dtype=dtype,
                                    device=self.device)

    def _positions(self, t, start_pos):
        """Position ids of a t-token chunk: ``arange(t)`` for a full
        forward, per-row ``start_pos + arange(t)`` for a cached chunk.

        A finished row that the engine still carries through decode sits
        at ``position == max_length``, one past the position table.
        ``jnp.take`` (and ``ops.nn.embedding``) gives such a row NaN
        embeddings. The ids are clamped instead, so a done row computes
        finite garbage from the last position's embedding:
        its token is replaced by pad and its K/V go to the trash page
        (paged) or the clamped last slot of its own row (dense), so no
        live row reads them."""
        ar = torch.arange(t, dtype=torch.int64, device=self.device)
        if start_pos is None:
            return ar
        pos = torch.as_tensor(start_pos, device=self.device).reshape(-1, 1) \
            .long() + ar[None, :]
        return pos.clamp(max=self._max_length - 1)

    def hybrid_forward(self, F, token_ids, cache=None, start_pos=None,
                       page_table=None):
        b, t = token_ids.shape
        pos = self._positions(t, start_pos)
        x = self.drop(self.word_embed(token_ids) + self.position_embed(pos))
        new_cache = []
        for i, blk in enumerate(self.blocks):
            if cache is None:
                x = blk(x)
            else:
                x, layer_cache = blk(x, cache=cache[i], start_pos=start_pos,
                                     page_table=page_table)
                new_cache.append(layer_cache)
        x = self.ln_f(x)
        # weight-tied LM head (GPT-2 ties input/output embeddings), under
        # the AMP rule of the JAX F.dot
        logits = _amp.matmul(x.reshape(b * t, self._units),
                             self.word_embed.weight.t()).reshape(b, t, -1)
        return logits if cache is None else (logits, new_cache)


def get_gpt2(model_name="gpt2_345m", dropout=0.1, device=None,
             dtype="float32", seed=0, **overrides):
    """``GPT2Model`` of ``gpt2_configs[model_name]`` with ``overrides`` (and
    ``prefix=``/``params=``), on ``device`` (or ``ctx=``; default the current
    context), weights drawn from ``seed``."""
    device = overrides.pop("ctx", device)
    cfg = dict(gpt2_configs[model_name])
    cfg.update(overrides)
    return GPT2Model(dropout=dropout, device=device, dtype=dtype, seed=seed,
                     **cfg)


def lm_loss(logits, labels):
    """Next-token cross entropy; labels = input shifted by the caller."""
    b, t, v = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(b * t, v)
    ll = logp.gather(1, labels.reshape(b * t, 1).long())
    return -ll.mean()
