#!/usr/bin/env python
"""The WMT Transformer (transformer_base) trained through the PyTorch/CUDA
port, ``mxnet_tpu_torch``: the counterpart of
``examples/train_transformer_wmt.py``, with the same flags plus
``--device`` (``gpu``, the default, or ``cpu``).

Reference shape: GluonNLP ``scripts/machine_translation/train_transformer.py``
(label-smoothed cross entropy, inverse-sqrt warmup, bucketed
variable-length batches). Each batch is padded to its bucket's ceiling and
runs one ``autograd.record()`` forward, ``backward()`` and
``trainer.step(1)``, eagerly; the per-epoch line gives the token accuracy
on a fixed evaluation set. With no corpus on disk it trains on a
synthetic copy/reverse parallel corpus; ``--src/--tgt`` name tokenized id
files (one sentence of space-separated ints per line).

    python examples/torch_train_transformer_wmt.py --device cpu \\
        --n-sent 256 --vocab-size 32 --buckets 8,12 --max-len 10 \\
        --batch-size 16 --epochs 2 --num-layers 1 --units 64 \\
        --hidden-size 128 --num-heads 2 --warmup-steps 60 --lr-scale 0.25
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.models.transformer import (get_transformer,
                                                label_smoothing_loss)

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


def synthetic_corpus(n_sent, vocab_size, min_len=4, max_len=28, seed=0):
    """Toy parallel data: target = reversed source (forces real attention:
    position i of the target attends to position L-i of the source)."""
    rs = np.random.RandomState(seed)
    src, tgt = [], []
    for _ in range(n_sent):
        L = rs.randint(min_len, max_len + 1)
        s = rs.randint(N_SPECIAL, vocab_size, size=L)
        src.append(s)
        tgt.append(s[::-1].copy())
    return src, tgt


def load_corpus(src_path, tgt_path):
    def read(path):
        with open(path) as f:
            return [np.array([int(t) for t in ln.split()], np.int64)
                    for ln in f if ln.strip()]
    return read(src_path), read(tgt_path)


def bucket_batches(src, tgt, buckets, batch_size, seed):
    """Assign sentence pairs to length buckets, pad to the bucket ceiling,
    and return shuffled fixed-shape batches ``(src_ids, tgt_in, tgt_out,
    src_valid)``: one shape per bucket."""
    rs = np.random.RandomState(seed)
    by_bucket = {b: [] for b in buckets}
    for s, t in zip(src, tgt):
        # +2 on target: BOS/EOS are added below
        need = max(len(s), len(t) + 2)
        for b in buckets:
            if need <= b:
                by_bucket[b].append((s, t))
                break
    batches = []
    for b, pairs in by_bucket.items():
        rs.shuffle(pairs)
        for i in range(0, len(pairs) - batch_size + 1, batch_size):
            chunk = pairs[i:i + batch_size]
            src_ids = np.full((batch_size, b), PAD, np.int32)
            tgt_in = np.full((batch_size, b), PAD, np.int32)
            tgt_out = np.full((batch_size, b), PAD, np.int32)
            src_valid = np.zeros((batch_size,), np.int32)
            for j, (s, t) in enumerate(chunk):
                src_ids[j, :len(s)] = s
                src_valid[j] = len(s)
                tgt_in[j, 0] = BOS
                tgt_in[j, 1:len(t) + 1] = t
                tgt_out[j, :len(t)] = t
                tgt_out[j, len(t)] = EOS
            batches.append((src_ids, tgt_in, tgt_out, src_valid))
    rs.shuffle(batches)
    return batches


class InvSqrtWarmup(mx.lr_scheduler.LRScheduler):
    """Transformer LR: d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (the GluonNLP machine_translation schedule)."""

    def __init__(self, units, warmup_steps=4000, scale=1.0):
        super().__init__(base_lr=1.0)
        self.units = units
        self.warmup = warmup_steps
        self.scale = scale

    def __call__(self, num_update):
        step = max(num_update, 1)
        return self.scale * self.units ** -0.5 * min(
            step ** -0.5, step * self.warmup ** -1.5)


def build_net(args, ctx):
    overrides = {"vocab_size": args.vocab_size}
    if args.num_layers:  # small-model override for smoke runs
        overrides.update(num_layers=args.num_layers, units=args.units,
                         hidden_size=args.hidden_size,
                         num_heads=args.num_heads)
    net = get_transformer(args.model, dropout=args.dropout, ctx=ctx,
                          seed=args.seed, **overrides)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    return net


def train(args, net=None, on_step=None):
    """Train; return the logged losses. ``net`` replaces the one the flags
    describe (same device), and ``on_step(step, loss, tokens)`` is called
    after each ``trainer.step`` with the loss NDArray (not synced)."""
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu()
    mx.random.seed(args.seed)
    if args.src and args.tgt:
        src, tgt = load_corpus(args.src, args.tgt)
    else:
        src, tgt = synthetic_corpus(args.n_sent, args.vocab_size,
                                    min_len=args.min_len,
                                    max_len=args.max_len, seed=args.seed)
    buckets = [int(b) for b in args.buckets.split(",")]
    if net is None:
        net = build_net(args, ctx)

    sched = InvSqrtWarmup(net._units, args.warmup_steps, scale=args.lr_scale)
    trainer = gluon.Trainer(
        net.collect_params(), "adam",
        {"learning_rate": sched(1), "beta1": 0.9, "beta2": 0.98,
         "epsilon": 1e-9, "lr_scheduler": sched})

    def batch(*arrays):
        return [nd.array(a, ctx=ctx, dtype="int32") for a in arrays]

    step = 0
    history = []
    for epoch in range(args.epochs):
        batches = bucket_batches(src, tgt, buckets, args.batch_size,
                                 args.seed + epoch)
        t0 = time.time()
        tokens = 0
        for src_ids, tgt_in, tgt_out, src_valid in batches:
            xs, yi, yo, sv = batch(src_ids, tgt_in, tgt_out, src_valid)
            with autograd.record():
                logits = net(xs, yi, sv)
                loss = label_smoothing_loss(logits, yo,
                                            epsilon=args.label_smoothing,
                                            ignore_index=PAD)
            loss.backward()
            trainer.step(1)  # loss is already token-normalized
            step += 1
            n_tok = int((tgt_out != PAD).sum())
            tokens += n_tok
            if on_step is not None:
                on_step(step, loss, n_tok)
            if step % args.log_interval == 0:
                lval = float(loss.asnumpy())
                history.append(lval)
                wps = tokens / max(time.time() - t0, 1e-9)
                print(f"epoch {epoch} step {step} loss {lval:.4f} "
                      f"lr {sched(step):.2e} tok/s {wps:.0f}", flush=True)
        print(f"epoch {epoch} done: token_acc "
              f"{token_accuracy(net, src, tgt, buckets, args, ctx):.4f}",
              flush=True)
    if args.export:
        net.export(args.export,
                   input_names=("src_ids", "tgt_ids", "src_valid"))
    return history


def token_accuracy(net, src, tgt, buckets, args, ctx):
    """Greedy next-token accuracy, teacher-forced, on the first
    ``4 * batch_size`` pairs."""
    n = args.batch_size * 4
    ev = bucket_batches(src[:n], tgt[:n], buckets, args.batch_size, seed=999)
    correct = total = 0
    for src_ids, tgt_in, tgt_out, src_valid in ev:
        logits = net(*(nd.array(a, ctx=ctx, dtype="int32")
                       for a in (src_ids, tgt_in, src_valid)))
        pred = logits.asnumpy().argmax(-1)
        m = tgt_out != PAD
        correct += int((pred[m] == tgt_out[m]).sum())
        total += int(m.sum())
    return correct / max(total, 1)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="transformer_base")
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--src"), ap.add_argument("--tgt")
    ap.add_argument("--synthetic", action="store_true", default=True)
    ap.add_argument("--n-sent", type=int, default=4096)
    ap.add_argument("--min-len", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=28)
    ap.add_argument("--vocab-size", type=int, default=36500)
    ap.add_argument("--buckets", default="8,16,24,32")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--warmup-steps", type=int, default=4000)
    ap.add_argument("--lr-scale", type=float, default=1.0)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--export", default="",
                    help="export the trained net to <export>-symbol.json "
                         "and <export>-0000.params")
    # small-model overrides (smoke runs)
    ap.add_argument("--num-layers", type=int, default=0)
    ap.add_argument("--units", type=int, default=512)
    ap.add_argument("--hidden-size", type=int, default=2048)
    ap.add_argument("--num-heads", type=int, default=8)
    return ap


if __name__ == "__main__":
    train(build_parser().parse_args())
