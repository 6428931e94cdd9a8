"""BERT as ``HybridBlock``s (so ``torch.nn.Module``s).

Counterpart of ``mxnet_tpu/models/bert.py``: word, token-type and position
embeddings, post-LN encoder layers (erf-GELU feed-forward), a tanh pooler,
and the pretraining heads of GluonNLP's ``BERTForPretrain`` (masked LM over
gathered positions, next-sentence classifier) with their loss. Parameter
names equal the JAX package's structural names
(``bert.word_embed.weight``, ``bert.encoder.layers.{i}.attention.qkv.weight``,
..., ``nsp.bias``), in the same order, and so are the Gluon names of
``collect_params()`` (``bertmodel0_enc_layer0_attn_qkv_weight``, ...).

The encoder's attention carries a ``(B, 1, 1, T)`` key-padding mask from
``valid_length``, so ``multi_head_attention`` takes its plain masked path,
as the JAX package's does (its flash kernel takes no mask).
"""
from __future__ import annotations

import torch

from .. import initializer as init
from ..base import MXNetError
from ..context import as_device
from ..gluon import nn as gnn
from ..gluon.block import HybridBlock
from ..ops import core as _core
from ..ops import nn as _ops
from ..ops.attention import multi_head_attention

__all__ = ["BERTModel", "BERTEncoder", "BERTForPretrain", "get_bert",
           "bert_configs", "pretrain_loss"]

bert_configs = {
    # (num_layers, units, hidden(ffn), heads, max_len, vocab)
    "bert_tiny": dict(num_layers=2, units=128, hidden_size=512, num_heads=2,
                      max_length=512, vocab_size=30522),
    "bert_mini": dict(num_layers=4, units=256, hidden_size=1024, num_heads=4,
                      max_length=512, vocab_size=30522),
    "bert_base": dict(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                      max_length=512, vocab_size=30522),
    "bert_large": dict(num_layers=24, units=1024, hidden_size=4096,
                       num_heads=16, max_length=512, vocab_size=30522),
}


def _dense(units, in_units, prefix, **kw):
    return gnn.Dense(units, flatten=False, in_units=in_units, prefix=prefix,
                     weight_initializer=init.Normal(0.02), **kw)


class BERTAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.1, dtype="float32",
                 device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._heads = num_heads
        kw = dict(dtype=dtype, device=as_device(device))
        with self.name_scope():
            self.qkv = _dense(3 * units, units, "qkv_", **kw)
            self.proj = _dense(units, units, "proj_", **kw)
            self.dropout = gnn.Dropout(dropout)

    def hybrid_forward(self, F, x, mask=None):
        b, t, c = x.shape
        h = self._heads
        qkv = self.qkv(x).reshape(b, t, 3, h, c // h).permute(2, 0, 3, 1, 4)
        out = multi_head_attention(qkv[0], qkv[1], qkv[2], mask=mask)
        out = out.transpose(1, 2).reshape(b, t, c)
        return self.dropout(self.proj(out))


class BERTEncoderLayer(HybridBlock):
    """One post-LN layer (original BERT): ``ln1(x + attention(x))``, then
    ``ln2(x + ffn2(gelu(ffn1(x))))``."""

    # one rematerialization unit under ``net.hybridize(remat=True)``
    _remat_unit = True

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 dtype="float32", device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        kw = dict(dtype=dtype, device=as_device(device))
        with self.name_scope():
            self.attention = BERTAttention(units, num_heads, dropout,
                                           prefix="attn_", **kw)
            self.ln1 = gnn.LayerNorm(in_channels=units, prefix="ln1_", **kw)
            self.ffn1 = _dense(hidden_size, units, "ffn1_", **kw)
            self.ffn2 = _dense(units, hidden_size, "ffn2_", **kw)
            self.ln2 = gnn.LayerNorm(in_channels=units, prefix="ln2_", **kw)
            self.dropout = gnn.Dropout(dropout)

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        y = self.ffn2(_ops.activation(self.ffn1(x), "gelu"))
        return self.ln2(x + self.dropout(y))


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.1, dtype="float32", device=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.layers = gnn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.layers.add(BERTEncoderLayer(
                    units, hidden_size, num_heads, dropout, dtype=dtype,
                    device=device, prefix=f"layer{i}_"))

    def hybrid_forward(self, F, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """Embeddings, encoder and pooler. Inputs follow GluonNLP:
    ``(token_ids, token_types, valid_length)``; returns the sequence
    (B, T, units) and the pooled first token (B, units). Weights are drawn
    from ``torch.Generator().manual_seed(seed)`` (the JAX model's
    initializers: Normal(0.02) for embeddings and projections, ones/zeros
    for LayerNorm, zero biases)."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, max_length=512, vocab_size=30522,
                 token_type_vocab=2, dropout=0.1, dtype="float32",
                 device=None, seed=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self._units = units
        self._max_length = max_length
        kw = dict(dtype=dtype, device=device)
        normal = init.Normal(0.02)
        with self.name_scope():
            self.word_embed = gnn.Embedding(
                vocab_size, units, prefix="word_embed_",
                weight_initializer=normal, **kw)
            self.token_type_embed = gnn.Embedding(
                token_type_vocab, units, prefix="token_type_embed_",
                weight_initializer=normal, **kw)
            self.position_embed = gnn.Embedding(
                max_length, units, prefix="position_embed_",
                weight_initializer=normal, **kw)
            self.embed_ln = gnn.LayerNorm(in_channels=units,
                                          prefix="embed_ln_", **kw)
            self.embed_dropout = gnn.Dropout(dropout)
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout, prefix="enc_",
                                       **kw)
            self.pooler = gnn.Dense(units, flatten=False, in_units=units,
                                    activation="tanh", prefix="pooler_",
                                    weight_initializer=normal, **kw)
        self._draw(torch.Generator().manual_seed(int(seed)), device)

    @property
    def device(self) -> torch.device:
        return self.word_embed.weight.device

    def hybrid_forward(self, F, token_ids, token_types=None,
                       valid_length=None):
        b, t = token_ids.shape
        if t > self._max_length:
            raise MXNetError(f"BERT: {t} tokens exceed max_length "
                             f"{self._max_length}")
        positions = _core.arange(t, dtype="int64", device=token_ids.device)
        emb = self.word_embed(token_ids) + self.position_embed(positions)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        emb = self.embed_dropout(self.embed_ln(emb))
        mask = None
        if valid_length is not None:
            # (B, 1, 1, T) key-padding mask broadcast over heads and queries
            mask = positions.reshape(1, 1, 1, t) < \
                valid_length.long().reshape(b, 1, 1, 1)
        seq = self.encoder(emb, mask)
        pooled = self.pooler(_core.slice_axis(seq, 1, 0, 1).squeeze(1))
        return seq, pooled


class BERTForPretrain(HybridBlock):
    """Masked-LM and next-sentence heads over ``bert`` (GluonNLP's
    ``BERTForPretrain``). The heads' weights are drawn from
    ``torch.Generator().manual_seed(seed + 1)``; ``bert`` keeps its own."""

    def __init__(self, bert: BERTModel, vocab_size=30522, dtype="float32",
                 seed=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        units = bert._units
        kw = dict(dtype=dtype, device=bert.device)
        with self.name_scope():
            self.bert = bert
            self.mlm_transform = _dense(units, units, "mlmt_", **kw)
            self.mlm_ln = gnn.LayerNorm(in_channels=units, prefix="mlmln_",
                                        **kw)
            self.mlm_decoder = _dense(vocab_size, units, "mlmdec_", **kw)
            self.nsp = _dense(2, units, "nsp_", **kw)
        gen = torch.Generator().manual_seed(int(seed) + 1)
        for head in (self.mlm_transform, self.mlm_ln, self.mlm_decoder,
                     self.nsp):
            head._draw(gen, bert.device)

    def hybrid_forward(self, F, token_ids, token_types, valid_length,
                       masked_positions):
        seq, pooled = self.bert(token_ids, token_types, valid_length)
        # gather the masked positions: (B, M) -> (B, M, C)
        b, m = masked_positions.shape
        batch_idx = _core.arange(b, dtype="int64", device=seq.device) \
            .reshape(b, 1).expand(b, m)
        gathered = _core.gather_nd(seq, _core.stack(
            batch_idx.reshape(-1), masked_positions.reshape(-1).long(), axis=0))
        gathered = gathered.reshape(b, m, -1)
        h = self.mlm_ln(_ops.activation(self.mlm_transform(gathered), "gelu"))
        return self.mlm_decoder(h), self.nsp(pooled)


def get_bert(model_name="bert_base", pretrain_head=True, dropout=0.1,
             device=None, dtype="float32", seed=0, **overrides):
    """A BERT of ``bert_configs[model_name]`` (with ``overrides``), with
    the pretraining heads unless ``pretrain_head=False``, on ``device`` (or
    ``ctx=``; default the current context), weights drawn from ``seed``."""
    device = overrides.pop("ctx", device)
    cfg = dict(bert_configs[model_name])
    cfg.update(overrides)
    bert = BERTModel(dropout=dropout, device=device, dtype=dtype, seed=seed,
                     **cfg)
    if pretrain_head:
        return BERTForPretrain(bert, vocab_size=cfg["vocab_size"],
                               dtype=dtype, seed=seed)
    return bert


def pretrain_loss(mlm_scores, nsp_scores, masked_labels, masked_weights,
                  nsp_labels):
    """The BERT pretraining loss: the weighted mean masked-LM negative
    log-likelihood (over ``weights.sum() + 1e-6``) plus the mean
    next-sentence one. The label's log-probability is read by a gather
    where the JAX package multiplies by a one-hot (a layout choice for its
    partitioner); a label outside ``[0, V)`` contributes 0 in both."""
    b, m, v = mlm_scores.shape
    logp = _ops.log_softmax(mlm_scores, axis=-1).reshape(b * m, v)
    labels = masked_labels.reshape(b * m).long()
    inside = (labels >= 0) & (labels < v)
    ll = logp.gather(1, labels.clamp(0, v - 1)[:, None]).squeeze(1)
    mlm_ll = torch.where(inside, ll, torch.zeros_like(ll))
    w = masked_weights.reshape(b * m)
    mlm_loss = -(mlm_ll * w).sum() / (w.sum() + 1e-6)
    nsp_logp = _ops.log_softmax(nsp_scores, axis=-1)
    nsp_loss = -_core.pick(nsp_logp, nsp_labels, axis=-1).mean()
    return mlm_loss + nsp_loss
