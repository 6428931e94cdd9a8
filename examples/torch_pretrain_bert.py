#!/usr/bin/env python
"""BERT base/large pretraining through the PyTorch/CUDA port,
``mxnet_tpu_torch``: the counterpart of ``examples/pretrain_bert.py``
(acceptance config #3, GluonNLP's ``scripts/bert`` shape), with the same
flags plus ``--device`` (``gpu``, the default, or ``cpu``).

A synthetic corpus (each batch drawn from ``np.random.RandomState(0)``),
``get_bert(model, max_length=seq_length)`` with the pretraining heads,
``amp.init`` + ``amp.convert_model`` under ``--dtype bfloat16`` (bf16
weights; ``TrainStep`` keeps their f32 masters), LAMB (or Adam) and
``TrainStep(n_model_inputs=4)``: one captured CUDA graph a step on the
card. ``--ckpt-dir`` restores the newest checkpoint there before training
and saves one after. One device: ``--tp`` other than 1 raises.

    python examples/torch_pretrain_bert.py --device cpu --model bert_tiny \\
        --batch-size 4 --seq-length 32 --num-masked 5 --steps 3
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, optimizer
from mxnet_tpu_torch.models import bert
from mxnet_tpu_torch.parallel import TrainStep


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="bert_base",
                    choices=list(bert.bert_configs))
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-length", type=int, default=128)
    ap.add_argument("--num-masked", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--optimizer", default="lamb", choices=["lamb", "adam"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return ap


def make_batch(batch, seq, masked, vocab, rs, ctx=None):
    """The JAX example's batch from ``rs``: token ids, token types, full
    valid lengths, masked positions, their labels, unit weights and NSP
    labels, as NDArrays on ``ctx`` (the model's 4 inputs, then the loss's
    3)."""
    def ints(a):
        return nd.array(a, ctx=ctx, dtype="int32")

    return (ints(rs.randint(0, vocab, (batch, seq))),
            ints(rs.randint(0, 2, (batch, seq))),
            nd.full((batch,), seq, ctx=ctx, dtype="int32"),
            ints(rs.randint(0, seq, (batch, masked))),
            ints(rs.randint(0, vocab, (batch, masked))),
            nd.ones((batch, masked), ctx=ctx),
            ints(rs.randint(0, 2, (batch,))))


def loss_fn(out, labels, weights, nsp_labels):
    mlm, nsp = out
    return bert.pretrain_loss(mlm.float(), nsp.float(), labels, weights,
                              nsp_labels)


def make_optimizer(name, lr):
    return optimizer.LAMB(learning_rate=lr) if name == "lamb" \
        else optimizer.Adam(learning_rate=lr)


def train(args, net=None, engine_type=None):
    """Train as the JAX example does; ``net`` replaces the
    ``get_bert(args.model)`` the script builds (a test passes one at
    dropout 0). Returns a dict: the losses (0-d device tensors), the
    TrainStep, the net, seconds and sequences a second of the timed
    steps."""
    if args.tp != 1:
        raise ValueError(f"--tp {args.tp}: the port trains on one device; "
                         "tensor parallelism waits for the multi-GPU port")
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu()
    vocab = bert.bert_configs[args.model]["vocab_size"]
    if net is None:
        net = bert.get_bert(args.model, pretrain_head=True,
                            max_length=args.seq_length, ctx=ctx)
    rs = np.random.RandomState(0)
    batch = make_batch(args.batch_size, args.seq_length, args.num_masked,
                       vocab, rs, ctx)
    if args.dtype == "bfloat16":
        from mxnet_tpu_torch.contrib import amp

        amp.init("bfloat16")
        amp.convert_model(net)
    step = TrainStep(net, loss_fn, make_optimizer(args.optimizer, args.lr),
                     n_model_inputs=4, engine_type=engine_type)
    if args.ckpt_dir and step.restore(args.ckpt_dir):
        print(f"resumed from step {int(step.optimizer.num_update)}")

    losses = [step(*batch)]  # the first call builds the step
    t0 = time.time()
    for _ in range(args.steps):
        batch = make_batch(args.batch_size, args.seq_length, args.num_masked,
                           vocab, rs, ctx)
        losses.append(step(*batch))
    nd.waitall()
    dt = time.time() - t0
    seq_per_s = args.steps * args.batch_size / dt
    print(f"{args.model}: {seq_per_s:.1f} seq/s, final loss "
          f"{float(losses[-1]):.4f}")
    if args.ckpt_dir:
        step.save(args.ckpt_dir)
    return dict(losses=losses, step=step, net=net, seconds=dt,
                seq_per_s=seq_per_s)


if __name__ == "__main__":
    train(build_parser().parse_args())
