#!/usr/bin/env python
"""The word-level LSTM language model trained through the PyTorch/CUDA
port, ``mxnet_tpu_torch``: the counterpart of ``examples/train_word_lm.py``
(the reference's ``example/gluon/word_language_model/train.py``), with the
same flags plus ``--device`` (``gpu``, the default, or ``cpu``) and
``--save`` (where the trained weights go; nothing is written without it).

Embedding -> dropout -> a 2-layer ``gluon.rnn.LSTM`` -> dropout -> a
``Dense`` decoder over the vocabulary (tied to the embedding with
``--tied``), trained on time-major batches of ``--bptt`` steps by one
``autograd.record()`` / ``backward()`` / ``trainer.step`` each, with
``SoftmaxCrossEntropyLoss`` over (T·N, vocab) and Adam with
``clip_gradient``. With no ``--data`` it trains on a synthetic Zipf corpus
with a bigram rule, so it runs with no files. Zaremba et al.'s medium
model (650 units, 2 layers, vocabulary 10,000, B=20, 35 steps, tied):

    python examples/torch_train_word_lm.py --vocab 10000 --embed-size 650 \\
        --hidden-size 650 --batch-size 20 --bptt 35 --tied
    python examples/torch_train_word_lm.py --device cpu --epochs 1
"""
import argparse
import math

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn, rnn


class RNNModel(gluon.HybridBlock):
    def __init__(self, vocab_size, embed_size=200, hidden_size=200,
                 num_layers=2, dropout=0.2, tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        self.vocab_size = vocab_size
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, embed_size)
            self.rnn = rnn.LSTM(hidden_size, num_layers=num_layers,
                                dropout=dropout, layout="TNC")
            if tie_weights and embed_size != hidden_size:
                raise ValueError("tied weights need embed_size == hidden_size")
            self.decoder = nn.Dense(vocab_size, flatten=False,
                                    params=self.encoder.params
                                    if tie_weights else None)

    def hybrid_forward(self, F, inputs, state=None):
        # inputs: (T, N) int ids
        emb = self.drop(self.encoder(inputs))
        if state is None:
            out = self.rnn(emb)
        else:
            out, state = self.rnn(emb, state)
        dec = self.decoder(self.drop(out))  # (T, N, vocab)
        return dec if state is None else (dec, state)

    def begin_state(self, batch_size):
        return self.rnn.begin_state(batch_size)


def synthetic_corpus(n_tokens=200000, vocab=1000, seed=0):
    """Zipf-distributed ids with a little bigram structure so the model has
    something learnable: every odd position follows from the one before."""
    rs = np.random.RandomState(seed)
    base = rs.zipf(1.3, n_tokens) % vocab
    base[1::2] = (base[0::2][: len(base[1::2])] * 7 + 3) % vocab
    return base.astype(np.int32)


def batchify(data, batch_size):
    """The corpus as ``batch_size`` columns, time-major (T, N)."""
    n = len(data) // batch_size
    return data[: n * batch_size].reshape(batch_size, n).T


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    help="path to a tokenized id file (np.load-able); "
                         "synthetic corpus if omitted")
    ap.add_argument("--vocab", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--bptt", type=int, default=35)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--clip", type=float, default=0.25)
    ap.add_argument("--tied", action="store_true")
    ap.add_argument("--embed-size", type=int, default=200)
    ap.add_argument("--hidden-size", type=int, default=200)
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--save", default="",
                    help="write the trained weights to this .params file")
    return ap


def train(args, net=None, on_step=None):
    """Train; return the mean loss of each epoch. ``net`` replaces the model
    the flags describe (initialized, on the device), and ``on_step(step,
    loss)`` is called after each ``trainer.step`` with the step's mean loss
    (a float); when it returns True the training stops there."""
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu()
    corpus = (np.load(args.data) if args.data
              else synthetic_corpus(vocab=args.vocab))
    vocab = int(corpus.max()) + 1
    data = batchify(corpus, args.batch_size)
    with ctx:
        if net is None:
            net = RNNModel(vocab, args.embed_size, args.hidden_size,
                           tie_weights=args.tied)
            net.initialize(mx.init.Xavier(), ctx=ctx)
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": args.lr,
                                 "clip_gradient": args.clip})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        epochs, step, stop = [], 0, False
        for epoch in range(args.epochs):
            total_loss, n_batches = 0.0, 0
            for i in range(0, data.shape[0] - 1 - args.bptt, args.bptt):
                x = nd.array(data[i:i + args.bptt], ctx=ctx, dtype="int32")
                y = nd.array(data[i + 1:i + 1 + args.bptt], ctx=ctx,
                             dtype="int32")
                with autograd.record():
                    out = net(x)  # (T, N, vocab)
                    loss = loss_fn(out.reshape(-1, vocab), y.reshape(-1))
                loss.backward()
                trainer.step(x.shape[1])
                value = float(loss.mean().asnumpy())
                total_loss += value
                n_batches += 1
                step += 1
                if on_step is not None and on_step(step, value):
                    stop = True
                    break
            mean = total_loss / max(n_batches, 1)
            epochs.append(mean)
            print(f"epoch {epoch}: loss {mean:.4f} "
                  f"ppl {math.exp(min(mean, 20)):.2f}", flush=True)
            if stop:
                break
    if args.save:
        # the RNN layer keeps no symbolic graph to export: the weights go
        # to a .params file that either package loads
        net.save_parameters(args.save)
    return epochs


if __name__ == "__main__":
    train(build_parser().parse_args())
