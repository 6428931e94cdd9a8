"""The WMT Transformer encoder-decoder as ``HybridBlock``s (so
``torch.nn.Module``s).

Counterpart of ``mxnet_tpu/models/transformer.py`` (GluonNLP's
``machine_translation`` shape): post-LN encoder and decoder layers, a
learned position table, an embedding shared by source and target
(``shared_embed=True``) and an untied output projection. Parameter names
equal the JAX package's: structural names (``src_embed.weight``,
``enc_layers.{i}.attn.qkv.weight``, ``dec_layers.{i}.cross_attn.kv_proj
.weight``, ``out_proj.bias``, ...) and Gluon prefixes (``word_embed_``,
``pos_embed_``, ``enc{i}_``, ``dec{i}_``, ``attn_``/``sattn_``/``cattn_``,
``qkv_``, ``query_``, ``key_``, ``proj_``, ``ffn1_``, ``ffn2_``, ``ln1_``
.. ``ln3_``, ``outproj_``), so ``.params`` files move both ways. With the
shared embedding, ``tgt_embed`` is ``src_embed``: a ``.params`` file holds
the table under both structural names, as the JAX package writes it, and
``named_parameters()`` and ``collect_params()`` hold it once, so a
``TrainStep`` or ``Trainer`` step updates it once.

Routing: the encoder's self-attention and the decoder's cross-attention
carry a ``(B, 1, 1, Tk)`` key-padding mask from ``src_valid`` and take the
plain masked path of ``multi_head_attention``; the decoder's unmasked
causal self-attention takes the flash kernels when its head dim is one
they are built for (64 or 128; transformer_tiny's 32 takes the plain
path). The cached decode reads the
dense self-attention cache through the paged kernel
(``multi_head_attention(cache=, position=)``); cross-attention K/V are
recomputed from ``mem`` at every step, as in the JAX package.

Traced on Symbols (``HybridBlock.export``), each block takes a symbolic
branch written as the JAX model is (``slice_axis`` of the projections,
reshape codes, ``arange_like`` positions and a ``lesser`` mask), so the
exported ``symbol.json`` is the JAX package's graph; the tensor branches
are unchanged.
"""
from __future__ import annotations

import math

import torch

from .. import autograd as _ag
from .. import initializer as init
from ..context import as_device
from ..gluon import nn as gnn
from ..gluon.block import HybridBlock, _unwrap, _wrap, symbolic
from ..ndarray import NDArray
from ..ops.attention import alloc_kv_cache, multi_head_attention

__all__ = ["Transformer", "MultiHeadAttention", "EncoderLayer",
           "DecoderLayer", "get_transformer", "transformer_configs",
           "label_smoothing_loss"]

transformer_configs = {
    "transformer_tiny": dict(num_layers=2, units=64, hidden_size=128,
                             num_heads=2, vocab_size=32000, max_length=256),
    "transformer_base": dict(num_layers=6, units=512, hidden_size=2048,
                             num_heads=8, vocab_size=36500, max_length=1024),
    "transformer_big": dict(num_layers=6, units=1024, hidden_size=4096,
                            num_heads=16, vocab_size=36500, max_length=1024),
}


def _dense(units, in_units, prefix, **kw):
    return gnn.Dense(units, flatten=False, in_units=in_units, prefix=prefix,
                     weight_initializer=init.Xavier(), **kw)


class MultiHeadAttention(HybridBlock):
    """Self-attention over one fused ``qkv`` projection, or
    cross-attention with ``q_proj`` (``query_``) on the decoder state and
    ``kv_proj`` (``key_``) on the encoder memory."""

    def __init__(self, units, num_heads, dropout=0.1, self_attn=True,
                 dtype="float32", device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._heads = num_heads
        self._units = units
        self._self = self_attn
        kw = dict(dtype=dtype, device=device)
        with self.name_scope():
            if self_attn:
                self.qkv = _dense(3 * units, units, "qkv_", **kw)
            else:
                self.q_proj = _dense(units, units, "query_", **kw)
                self.kv_proj = _dense(2 * units, units, "key_", **kw)
            self.proj = _dense(units, units, "proj_", **kw)
            self.drop = gnn.Dropout(dropout)

    def _heads_of(self, z, n):
        """(B, T, n·U) -> n tensors (B, H, T, U/H)."""
        b, t, _ = z.shape
        h = self._heads
        z = z.reshape(b, t, n, h, self._units // h).permute(2, 0, 3, 1, 4)
        return z.unbind(0)

    def hybrid_forward(self, F, x, mem=None, mask=None, causal=False,
                       cache=None, start_pos=None):
        if symbolic():
            return self._symbolic_forward(F, x, mem, mask, causal)
        b, t, _ = x.shape
        if self._self:
            q, k, v = self._heads_of(self.qkv(x), 3)
        else:
            (q,) = self._heads_of(self.q_proj(x), 1)
            k, v = self._heads_of(self.kv_proj(mem), 2)
        if cache is not None:  # cached autoregressive self-attention
            out, k_buf, v_buf = multi_head_attention(
                q, k, v, cache=cache, position=start_pos)
            out = out.transpose(1, 2).reshape(b, t, self._units)
            return self.drop(self.proj(out)), (k_buf, v_buf)
        out = multi_head_attention(q, k, v, mask=mask, causal=causal)
        out = out.transpose(1, 2).reshape(b, t, self._units)
        return self.drop(self.proj(out))

    def _symbolic_forward(self, F, x, mem, mask, causal):
        """The traced graph, as the JAX block writes it: ``slice_axis`` of
        the projections and shape-free reshape codes (0/-1/-3)."""
        h, u = self._heads, self._units
        if self._self:
            qkv = self.qkv(x)  # (b, t, 3u)
            q = F.slice_axis(qkv, axis=-1, begin=0, end=u)
            k = F.slice_axis(qkv, axis=-1, begin=u, end=2 * u)
            v = F.slice_axis(qkv, axis=-1, begin=2 * u, end=3 * u)
        else:
            q = self.q_proj(x)
            kv = self.kv_proj(mem)  # (b, tk, 2u)
            k = F.slice_axis(kv, axis=-1, begin=0, end=u)
            v = F.slice_axis(kv, axis=-1, begin=u, end=2 * u)

        def heads(z):  # (b, t, u) -> (b, h, t, u//h)
            return z.reshape((0, 0, h, -1)).transpose((0, 2, 1, 3))

        out = F.multi_head_attention(heads(q), heads(k), heads(v), mask=mask,
                                     causal=causal)
        out = out.transpose((0, 2, 1, 3)).reshape((0, 0, -3))  # merge h, d
        return self.drop(self.proj(out))


class _FFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.1, dtype="float32",
                 device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        kw = dict(dtype=dtype, device=device)
        with self.name_scope():
            self.ffn1 = gnn.Dense(hidden_size, flatten=False, in_units=units,
                                  activation="relu", prefix="ffn1_",
                                  weight_initializer=init.Xavier(), **kw)
            self.ffn2 = _dense(units, hidden_size, "ffn2_", **kw)
            self.drop = gnn.Dropout(dropout)

    def hybrid_forward(self, F, x):
        return self.drop(self.ffn2(self.ffn1(x)))


class EncoderLayer(HybridBlock):
    # one rematerialization unit under ``net.hybridize(remat=True)``
    _remat_unit = True

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 dtype="float32", device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        kw = dict(dtype=dtype, device=device)
        with self.name_scope():
            self.attn = MultiHeadAttention(units, num_heads, dropout,
                                           prefix="attn_", **kw)
            self.ln1 = gnn.LayerNorm(in_channels=units, prefix="ln1_", **kw)
            self.ffn = _FFN(units, hidden_size, dropout, prefix="ffn_", **kw)
            self.ln2 = gnn.LayerNorm(in_channels=units, prefix="ln2_", **kw)

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attn(x, mask=mask))
        return self.ln2(x + self.ffn(x))


class DecoderLayer(HybridBlock):
    # one rematerialization unit under ``net.hybridize(remat=True)``
    _remat_unit = True

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 dtype="float32", device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        kw = dict(dtype=dtype, device=device)
        with self.name_scope():
            self.self_attn = MultiHeadAttention(units, num_heads, dropout,
                                                prefix="sattn_", **kw)
            self.ln1 = gnn.LayerNorm(in_channels=units, prefix="ln1_", **kw)
            self.cross_attn = MultiHeadAttention(units, num_heads, dropout,
                                                 self_attn=False,
                                                 prefix="cattn_", **kw)
            self.ln2 = gnn.LayerNorm(in_channels=units, prefix="ln2_", **kw)
            self.ffn = _FFN(units, hidden_size, dropout, prefix="ffn_", **kw)
            self.ln3 = gnn.LayerNorm(in_channels=units, prefix="ln3_", **kw)

    def hybrid_forward(self, F, x, mem, mem_mask=None, cache=None,
                       start_pos=None):
        if cache is None:
            x = self.ln1(x + self.self_attn(x, causal=True))
        else:
            att, new_cache = self.self_attn(x, cache=cache,
                                            start_pos=start_pos)
            x = self.ln1(x + att)
        x = self.ln2(x + self.cross_attn(x, mem=mem, mask=mem_mask))
        x = self.ln3(x + self.ffn(x))
        return x if cache is None else (x, new_cache)


class Transformer(HybridBlock):
    """The encoder-decoder. ``net(src_ids, tgt_ids, src_valid=None)`` gives
    the (B, Tt, vocab) logits. Weights are drawn from
    ``torch.Generator().manual_seed(seed)`` with the JAX model's
    initializers (Xavier for the projections, Normal(units^-0.5) for the
    word embedding, Normal(0.02) for positions, ones/zeros for LayerNorm,
    zero biases)."""

    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, vocab_size=36500, max_length=1024, dropout=0.1,
                 shared_embed=True, dtype="float32", device=None, seed=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self._units = units
        self._heads = num_heads
        self._max_length = max_length
        kw = dict(dtype=dtype, device=device)
        with self.name_scope():
            self.src_embed = gnn.Embedding(
                vocab_size, units, prefix="word_embed_",
                weight_initializer=init.Normal(units ** -0.5), **kw)
            self.tgt_embed = self.src_embed if shared_embed else \
                gnn.Embedding(vocab_size, units, prefix="tgt_embed_",
                              weight_initializer=init.Normal(units ** -0.5),
                              **kw)
            self.pos_embed = gnn.Embedding(
                max_length, units, prefix="pos_embed_",
                weight_initializer=init.Normal(0.02), **kw)
            self.drop = gnn.Dropout(dropout)
            self.enc_layers = gnn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.enc_layers.add(EncoderLayer(
                    units, hidden_size, num_heads, dropout, prefix=f"enc{i}_",
                    **kw))
            self.dec_layers = gnn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.dec_layers.add(DecoderLayer(
                    units, hidden_size, num_heads, dropout, prefix=f"dec{i}_",
                    **kw))
            self.out_proj = _dense(vocab_size, units, "outproj_", **kw)
        self._draw(torch.Generator().manual_seed(int(seed)), device)

    @property
    def device(self) -> torch.device:
        return self.src_embed.weight.device

    def _positions(self, t, start_pos=None):
        """Position ids of a t-token chunk: ``arange(t)``, or per-row
        ``start_pos + arange(t)`` for a cached chunk. Ids at or past
        ``max_length`` are clamped to ``max_length - 1`` (as the GPT-2
        port does) where the JAX lookup gives NaN rows: a finished row that
        a batched decode carries on computes finite values and never
        reaches ``F.embedding`` with an id outside the table."""
        ar = torch.arange(t, dtype=torch.int64, device=self.device)
        if start_pos is None:
            return ar
        pos = torch.as_tensor(start_pos, device=self.device).reshape(-1, 1) \
            .long() + ar[None, :]
        return pos.clamp(max=self._max_length - 1)

    def _embed(self, embed, ids, start_pos=None):
        pos = self._positions(ids.shape[1], start_pos)
        return self.drop(embed(ids) * math.sqrt(self._units) +
                         self.pos_embed(pos))

    def _encode(self, src_ids, src_valid=None):
        x = self._embed(self.src_embed, src_ids)
        mask = None
        if src_valid is not None:
            b, t = src_ids.shape
            steps = torch.arange(t, device=src_ids.device)
            # (B, 1, 1, Tk): broadcast over heads and queries
            mask = steps.reshape(1, 1, 1, t) < \
                src_valid.long().reshape(b, 1, 1, 1)
        for layer in self.enc_layers:
            x = layer(x, mask)
        return x, mask

    def _symbolic_embed(self, F, embed, ids):
        pos = F.arange_like(ids, axis=1, dtype="int32")
        scale = math.sqrt(self._units)
        return self.drop(embed(ids) * scale + self.pos_embed(pos))

    def _symbolic_encode(self, F, src_ids, src_valid=None):
        x = self._symbolic_embed(F, self.src_embed, src_ids)
        mask = None
        if src_valid is not None:
            steps = F.arange_like(src_ids, axis=1, dtype="int32")
            mask = (steps.reshape((1, 1, 1, -1)) <
                    src_valid.astype("int32").reshape((-1, 1, 1, 1)))
        for layer in self.enc_layers:
            x = layer(x, mask)
        return x, mask

    def hybrid_forward(self, F, src_ids, tgt_ids, src_valid=None):
        if symbolic():
            # the traced graph, as the JAX model writes it (arange_like
            # positions, a `lesser` mask); the position clamp of the tensor
            # branch is not in it, as it is not in the JAX graph
            mem, mem_mask = self._symbolic_encode(F, src_ids, src_valid)
            y = self._symbolic_embed(F, self.tgt_embed, tgt_ids)
            for layer in self.dec_layers:
                y = layer(y, mem, mem_mask)
            return self.out_proj(y)
        mem, mem_mask = self._encode(src_ids, src_valid)
        y = self._embed(self.tgt_embed, tgt_ids)
        for layer in self.dec_layers:
            y = layer(y, mem, mem_mask)
        return self.out_proj(y)

    # -- cached autoregressive decoding -------------------------------------
    def _imperative(self, fn, *args):
        """Run ``fn`` on tensors; given NDArrays, under the grad mode of
        ``autograd`` and with NDArrays out."""
        if not any(isinstance(a, NDArray) for a in args):
            return fn(*args)
        with torch.set_grad_enabled(_ag.is_recording()):
            out = fn(*_unwrap(args))
        return _wrap(out)

    def encode(self, F, src_ids, src_valid=None):
        """``(mem, mem_mask)``: the encoder's output (B, Ts, units) and the
        (B, 1, 1, Ts) key-padding mask (None without ``src_valid``).
        ``F`` is taken for the JAX signature and not used."""
        return self._imperative(self._encode, src_ids, src_valid)

    def init_decode_cache(self, batch_size, max_length=None,
                          dtype="float32"):
        """Per-decoder-layer ``(k_buf, v_buf)`` self-attention buffers
        (B, H, Tmax, units/H) on the net's device. Cross-attention K/V are
        recomputed from ``mem`` at each step."""
        return alloc_kv_cache(batch_size, self._heads,
                              max_length or self._max_length,
                              self._units // self._heads,
                              len(self.dec_layers), dtype=dtype,
                              device=self.device)

    def _decode_step(self, tgt_ids, mem, mem_mask, cache, start_pos):
        y = self._embed(self.tgt_embed, tgt_ids, start_pos)
        new_cache = []
        for i, layer in enumerate(self.dec_layers):
            y, layer_cache = layer(y, mem, mem_mask, cache=cache[i],
                                   start_pos=start_pos)
            new_cache.append(layer_cache)
        return self.out_proj(y), new_cache

    def decode_step(self, tgt_ids, mem, mem_mask=None, cache=None,
                    start_pos=None):
        """One cached decoder chunk: embeds ``tgt_ids`` (B, t) at per-row
        offsets ``start_pos`` and runs the decoder stack against the
        self-attention cache (updated in place). Returns ``(logits,
        new_cache)``."""
        cache = _unwrap(list(cache))
        return self._imperative(
            lambda ids, m, mm, sp: self._decode_step(ids, m, mm, cache, sp),
            tgt_ids, mem, mem_mask, start_pos)


def get_transformer(model_name="transformer_base", dropout=0.1, device=None,
                    dtype="float32", seed=0, **overrides):
    """A ``Transformer`` of ``transformer_configs[model_name]`` with
    ``overrides`` (and ``shared_embed=``, ``prefix=``), on ``device`` (or
    ``ctx=``; default the current context), weights drawn from ``seed``."""
    device = overrides.pop("ctx", device)
    cfg = dict(transformer_configs[model_name])
    cfg.update(overrides)
    return Transformer(dropout=dropout, device=device, dtype=dtype,
                       seed=seed, **cfg)


def _label_smoothing(logits, labels, epsilon, ignore_index):
    b, t, v = logits.shape
    logp = torch.log_softmax(logits, dim=-1).reshape(b * t, v)
    lab = labels.reshape(b * t).long()
    # ``pick`` with mode="clip": an id outside [0, V) reads the nearest end
    nll = -logp.gather(1, lab.clamp(0, v - 1)[:, None]).squeeze(1)
    smooth = -logp.mean(dim=-1)
    loss = (1 - epsilon) * nll + epsilon * smooth
    mask = lab != ignore_index
    return (loss * mask).sum() / (mask.sum() + 1e-6)


def label_smoothing_loss(logits, labels, epsilon=0.1, ignore_index=0):
    """The WMT training loss: label-smoothed cross entropy over the tokens
    whose label is not ``ignore_index``, averaged over them. Takes tensors
    (``TrainStep``) or NDArrays (recorded under ``autograd.record``)."""
    if isinstance(logits, NDArray) or isinstance(labels, NDArray):
        with torch.set_grad_enabled(_ag.is_recording()):
            return NDArray(_label_smoothing(*_unwrap((logits, labels)),
                                            epsilon, ignore_index))
    return _label_smoothing(logits, labels, epsilon, ignore_index)
