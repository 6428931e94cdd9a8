#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure (so the script exits non-zero and never
prints its last line):

  1. build the CUDA kernels from ``mxnet_tpu_torch/csrc/`` (one nvcc per
     source, in parallel), check that the bf16 flash kernels (forward,
     dK/dV, dQ), the f32 flash kernels (forward, dK/dV, dQ, 3xTF32) and
     the paged prefill read (3xTF32) multiply on the tensor cores (HMMA in
     their SASS, TF32 HMMA for the 3xTF32 ones), and print the card's name
     and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes the serving and training paths give it (the paged read at
     decode, split over the key range, and at prefill, on the tensor
     cores, frontiers on split boundaries, the speculative verify (8 rows
     of 5 queries, ragged frontiers), the gpt2_117m draft's decode (12
     heads) and a suffix prefill after a 384-token prefix, in five (q,
     pool) dtype pairs;
     flash forward and lse, dK/dV, dQ, the bf16 kernels also against plain
     versions that round p (and ds) as they do, the f32 kernels also at a
     tight limit that one TF32 pass fails and against an f64 plain
     version, and a misaligned f32 input refused; multi-tensor Adam with its
     skip flag, inverse loss scale and f16 gradients and copies,
     LayerNorm forward and backward on both routes (one warp a row, one
     block a row: d 1000, 1023, 2048 and 8192 and misaligned bases beside
     the paths' (8 | 512 | 4096, 1024)) in the four (x, gamma) dtype pairs,
     its gradients through its autograd Function, and the
     softmax-cross-entropy forward (loss and the row statistics) and
     backward, including extreme and -inf logits, labels -1 and C, and
     rows past the TPU's 65536 cap);
  3. check that dense-cache and paged-cache logits are bit-identical
     through a small GPT-2 (2 layers at gpt2_345m width), and that they
     agree with the same engine run on the kernels' plain versions; then
     the same under ``contrib.amp.init("bfloat16")`` and
     ``contrib.amp.init("float16")`` (bf16 or f16 q over the f32 caches);
  4. training parity: 3 TrainStep steps of a 2-layer GPT-2 at gpt2_345m
     width with every kernel knob on, then off (the plain versions), with
     the same seeded weights; per-step losses and final weights agree. Then
     the same under amp="bfloat16" with SoftmaxCrossEntropyLoss and Adam
     on a warm-up schedule; then both for a 2-layer BERT at bert_large
     width (B=8, T=128, 20 masked positions, ragged valid_length, both
     token types, ``bert_loss``);
  5. the step graphs (``engine_type="graph"``, the port's default: one
     captured CUDA graph per step signature) against the eager steps
     (``"naive"``, the same steps uncaptured): seeded top-k serving at
     full width and 3 training steps (f32 and bf16, 2 layers)
     bit-identical; a host sync planted in a captured step raises and
     leaves the allocator as it was; two engines' decode graphs replayed
     at once on two streams match their replays alone;
  6. serve 16 requests through the paged engine and the continuous
     batcher with gpt2_345m at full width (seeded random weights, f32),
     with both serving kernels' launch counts read around that run and the
     engine's program count (prefill buckets used + 1) held flat, four
     times: naive, graph, graph, naive, tokens and decode logits
     bit-identical across the four; after each graph run one replay of
     each captured graph is profiled, and the port's kernels it ran must
     be the launches the graph records (``check_replay_launches``; the
     same for the training graphs in 7); then the serving features at the
     same width: speculative decoding (``spec``: the same 16 requests,
     gpt2_117m drafting k = 4 tokens a round, greedy, naive and graph
     bit-identical, the plain run's tokens under the near-tie rule,
     buckets used + 2 programs, the paged reads and LayerNorms of each
     round and prefill counted; then the target as its own draft, every
     draft accepted; then top-k sampled rounds), the prefix cache
     (``prefix``: 16 requests behind one 384-token prefix, each after the
     first adopting its 24 pages, tokens of a cold engine's under the
     near-tie rule, fewer pages at the peak) and forks (``fork``:
     ``samples=4`` top-k on two 200-token prompts, shared full pages at
     refcount 4, one ``("cow", 8)`` program, naive and graph
     bit-identical, every page free after the run); then the serving
     fleet (``[fleet]``: ``tools/torch_servedrill.py --fleet``'s
     ``fleet_plan`` with three gpt2_345m replicas and a replacement, each
     warmed, request tracing keeping everything, a replica killed and one
     wedged; ``validate_fleet`` green, the fleet report's replica states,
     every serving replica's paged and LayerNorm launches), the tracer's
     cost a batcher step (off and on in turns), and, on the timing
     phase's serve engine, ``GenerationEngine.profile(steps=8)`` (8 step
     rows, the paged and LayerNorm kernels named, the card's busy time a
     step against the decode graph's time, the step's window against the
     untraced decode step (printed), calibrated against the decode
     program's schedule: ``[calibrate]``) and ``mx.profiler`` around a few
     decode steps; then ``GenerationEngine.audit`` of its decode, prefill
     and copy-on-write programs (``[audit decode]``: the graph's nodes and
     edges, its port kernels equal to the launch counters over its capture
     and to the record's, no memcpy node in the decode graph, the carry in
     place, ``kv_pages`` the pools' and the table's bytes, the memory
     estimate's inputs equal to their storages' bytes and its temporaries
     within 25% of one eager step's measured transient, the tokens
     unchanged by audits between steps);
  7. train gpt2_345m at full width (B=4, T=1024, f32, Adam) through
     TrainStep: 2 warm-up and 10 timed steps, with the launch counts of
     every kernel read around each step; then the same in bf16
     (``train_amp``): TrainStep(net, SoftmaxCrossEntropyLoss(),
     Adam(lr_scheduler=...), amp="bfloat16"); each naive, graph, graph,
     naive from the same weights, losses, weights and Adam moments
     bit-identical across the four; ``TrainStep.profile(steps=2)`` of the
     bf16 step at 8 of its 24 layers (only replays traced; the flash, Adam
     and xent kernels named; calibrated), one periodic and one trigger-file
     step capture, the second sweeping the first, and ``TrainStep.audit``
     of that step (``[audit train]``: the checks of ``[audit decode]``, no
     f64 op, the carry unchanged by the audit, ``model_flops_per_step``
     equal to the hand count, the ``train_mfu`` gauge against 989e12);
     then bench.py's BERT step
     (``bert_amp``: bert_large, B=64, T=128, 20 masked positions,
     TrainStep(net, bert_loss, Adam(1e-4), n_model_inputs=4,
     amp="bfloat16")) the same way, with its MFU by bench.py's
     ``bert_flops``, and dropout inside its step graph: at lr 0 two
     replays give equal losses at dropout 0 and different ones at 0.1
     (a fresh mask each replay), then one timed graph run at 0.1; then
     the rest of the NN ops (``[nn_ops]``: each new op of ops/nn.py and
     ops/attention.py on the card against the same op on CPU tensors,
     the interleaved self-attention at BERT-large width also against
     ``multi_head_attention``, CTC at (400, 32, 29) timed beside
     ``F.ctc_loss``, the knob-off flash backward (the chunked attention's
     VJP) at T=8192 against the flash backward kernels with its peak
     memory beside ``flash_bwd_plain``'s, the embedding gradient's two
     routes bit for bit over 20 calls and timed,
     ``nd.softmax_cross_entropy_fused`` launching the xent kernel once,
     the samplers' moments), the
     optimizers (``[optimizers]``: SGD, NAG, Adam, AdamW, AdaGrad, RMSProp
     plain and centered, FTRL, SignSGD and LAMB on a 2-layer net, graph ==
     naive, ``run(window=2)`` == calls, the bf16 cast route == the Gluon
     Trainer with ``multi_precision``, bit for bit) and
     examples/torch_pretrain_bert.py's route (``[pretrain_bert]``:
     bert_large, B=64, T=128, M=20, bf16 by ``amp.convert_model``, LAMB:
     graph == naive, 2+10 timed graph steps with bert_amp's LayerNorm
     launches and no Adam, MFU, the LAMB update beside the Adam kernel,
     then the example itself at bert_base as a subprocess);
     between ``train_amp`` and BERT, the imperative MXNet surface
     (``gluon``): 3 steps of ``autograd.record`` / ``loss.backward()`` /
     ``gluon.Trainer.step`` on a 2-layer net in f32, bit-identical to
     TrainStep naive, and in bf16 with ``multi_precision`` f32 masters,
     kernels against plain versions; then gpt2_345m at full width through
     that loop (bf16 weights, f32 masters, 2+10 eager steps, each
     launching what a ``train_amp`` step launches), and a
     ``save_parameters``/``load_parameters`` round trip giving bitwise
     equal logits; then the training loop (``train_loop``): (a) at 2
     layers, ``TrainStep.run(steps=8, window=4)`` bit-identical to 8
     calls, graph and naive, in f32 and bf16, and ``accum=2`` graph ==
     naive; (b) gpt2_345m at full width in bf16 fed by a
     ``DevicePrefetcher`` in windows of 8 (one CUDA graph a window, 8x a
     ``train_amp`` step's launches, a profiled replay of the window graph),
     timed; (c) ``accum=2`` at microbatch B=2; (d) ``save`` and a fresh
     ``restore`` (about 4.3 GB) continuing bit-identically; (e) the first
     full-width ``amp="float16"`` run, its loss scale and skips carried
     through a checkpoint; (f) ``gluon.Trainer.run`` over a ``DataLoader``
     on the ``gluon`` net, then one ``Trainer.step`` on the states it
     left; (g) a preemption request during window 1: one valid checkpoint
     at the window boundary and ``Preempted``; then the vision path: the
     port's f32 convolution (forward and both gradients) against f64 with
     cuDNN's TF32 allowed around the call, at a limit one TF32 pass
     fails; resnet50_v1 at full width (224x224, 1000 classes, MSRAPrelu,
     SGD 0.1, momentum 0.9, wd 1e-4, examples/train_imagenet_resnet.py's
     step) through TrainStep in f32 at B=64 and after
     ``net.cast("bfloat16")`` at B=128, each naive, graph, graph, naive:
     losses, weights, BatchNorm's moving statistics and momenta
     bit-identical, every statistic moved, an inference call reading
     them, the xent kernels once a step (a profiled replay too), ms a
     step, images/s, MFU by the conv and dense shapes, peak memory; and
     LeNet through ``autograd.record`` / ``gluon.Trainer("adam")``: 3
     steps bit-identical to TrainStep naive, then 20 steps with a falling
     loss, one Adam launch and the xent pair each; then the WMT
     Transformer (``models/transformer.py``) on the example's synthetic
     reverse corpus (B=64, buckets 8, 16, 24, 32): transformer_base's
     logits, label-smoothed loss and one Adam step on the kernels against
     the plain versions (f32, one ``.params`` file, ragged src_valid),
     transformer_tiny at head dim 32 (no flash launch, the dispatch rule);
     transformer_base through ``TrainStep(amp="bfloat16")`` naive, graph,
     graph, naive (bit-identical, four programs, 6 flash and 30 LayerNorm
     launches each way and one Adam a step, MFU by ``transformer_flops``),
     the masked plain attention's device time, transformer_big as a
     graph; the greedy cached decode (6 paged reads and 18 LayerNorms a
     step) held against a teacher-forced forward; the example's own eager
     loop (a falling loss, the host share); and the MNIST example's route
     (rising accuracy, the data-wait share); then the remaining tensor,
     linalg and control-flow ops (``[extra_ops]``: every op of
     ops/extra.py and ops/linalg.py on the card against the same op on CPU
     tensors, values and gradients, at a model's shapes (GroupNorm at (32,
     256, 56, 56), the spatial transformer at (32, 64, 64, 64), im2col at a
     ResNet 3x3 layer, the linalg family batched at (64, 256, 256), gelqf
     and syevd up to row signs, potrf NaN on a matrix that is not positive
     definite), gemm and gemm2 under amp.init("bfloat16"), and which ops
     and control-flow operators a captured step can hold); and the
     word-level LSTM language model at Zaremba et al.'s medium width
     (``[word_lm]``: 2 LSTM layers of 650, tied embedding, vocabulary
     10,000, B=20, bptt 35: examples/torch_train_word_lm.py's Gluon loop
     for 50 steps (a falling loss, ms a step, the host share); TrainStep
     graph == naive bit for bit over 3 steps, then 2+10 timed graph steps
     with the xent pair and one Adam a step (ms a step, tokens/s, MFU,
     peak memory, a profiled replay, the device time by kernel group);
     cuDNN's LSTM and GRU beside the port's route, outputs, gradients and
     times; the example at its defaults as a subprocess); the detection
     ops, the SSD and the Estimator (``[detection]``, ``[ssd]``,
     ``[estimator]``); and the symbolic API: transformer_base exported to
     its symbol.json and imported as a ``SymbolBlock`` on the card (its
     forward and three ``Trainer("adam")`` steps bit for bit the Gluon
     net's, with its LayerNorm, flash and Adam launches), resnet50_v1 and
     back, a CustomOp inside a captured step and an ``Executor`` against
     the CPU (``[symbol]``), and MXNet's bucketing LSTM language model
     (example/rnn/bucketing at its widths) through ``BucketingModule.fit``
     with Adam (a falling perplexity, one Adam launch an update, ms a batch
     by bucket, the idle share of a bucket-60 batch, ``Module.load`` bit
     for bit; ``[module]``); row-sparse storage (``[sparse]``): the word LM
     untied at Zaremba-medium width with ``Embedding(10000, 650,
     sparse_grad=True)`` through ``gluon.Trainer("adam", wd > 0)`` for 20
     steps (two Adam launches a step, the lazy block and the rest, and the
     xent pair; the first 3 steps against the plain lazy update; untouched
     rows bit-identical; a falling loss; ms a step, the idle share), the
     same net under a captured ``TrainStep`` equal to its dense twin, the
     lazy update at LM1B's 793,471 x 512 table beside the dense gradient,
     ``dot(csr, dense)`` both ways at 8192 Criteo-like rows over 2^20
     columns (against a dense slice, equal run to run, beside
     ``torch.sparse.mm``), the storage casts, ``retain``, ``rsp + rsp``,
     the lazy ``adam_update`` op and a sparse ``.params`` round trip on the
     card; and a dozen ``mx.np`` names on the card against the CPU
     (``[np]``);
  8. time each kernel, its plain version and a PyTorch library yardstick
     with CUDA events, on the device (CUDA graph replay) and per eager
     call, at the shapes the paths give them (the paged read also at the
     verify's and the draft's shapes; xent at the vision heads' (64,
     1000) f32, (128, 1000) bf16 and (64, 10) f32 and Adam over LeNet's
     10 tensors; BatchNorm's composition beside ``F.batch_norm`` at
     (B, 64, 112, 112); the Transformer's flash, LayerNorm, Adam and
     decode-read shapes; the xent pair at the word LM's (700, 10000) f32
     and Adam over its 3 tensors; LayerNorm at the imported
     transformer_base's (2048, 512) f32 and Adam over the bucketing LM's 11
     tensors; Adam on the sparse word LM's lazy block and its other
     tensors, and on LM1B's lazy block and whole table), and the launch
     floor
     (``EMPTY_CU``, a kernel that does nothing on the grid and block of
     the route LayerNorm's forward takes, built here);
  9. print the kernel table as one JSON line, then the result line.

It needs one CUDA card and imports nothing of JAX or ``mxnet_tpu``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM, f32
# outside the tensor cores, dense bf16 on the tensor cores and dense TF32
# on the tensor cores, three TF32 products of which make one f32-accurate
# product (3xTF32). An operation count is held against the fastest way the
# card has to do that work at the inputs' accuracy, whichever units a kernel
# uses: bf16 matrix products at the bf16 tensor-core rate, f32 matrix
# products (the attention kernels' block products) at the 3xTF32 rate, a
# third of TF32's, and f32 work that is no matrix product (LayerNorm, Adam,
# softmax cross-entropy) at the CUDA cores' rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
TF32_TC_FLOPS_PER_S = 494.7e12
N_LAYERS = 24  # gpt2_345m

# Tolerances, |kernel - plain| <= atol + rtol * |plain|. f32: only the order
# of the f32 sums differs. bf16: the plain version rounds scores and
# weights to bf16 where the kernel keeps f32. LayerNorm's are those of
# tests/test_pallas_layernorm.py.
TOL = {
    ("paged_attention", torch.float32): 1e-5,
    ("paged_attention", torch.bfloat16): 2e-2,
    # f16 q (over f32 pools): the bf16 reasoning at f16's three more
    # mantissa bits, 2e-2 / 8, rounded up
    ("paged_attention", torch.float16): 5e-3,
    # the prefill read (3xTF32 on the tensor cores) at the same limits: its
    # products are f32-accurate, its output a convex combination of V rows
    ("paged_attention_prefill", torch.float32): 1e-5,
    ("paged_attention_prefill", torch.bfloat16): 2e-2,
    ("paged_attention_prefill", torch.float16): 5e-3,
    ("layernorm", torch.float32): 2e-5,
    ("layernorm", torch.bfloat16): 3e-2,
    # flash: tests/test_flash_attention.py's forward (2e-4 / 3e-2) and
    # backward (2e-3 / 3e-2) tolerances against the exact plain versions.
    # The f32 kernels multiply in 3xTF32 on the tensor cores, f32-accurate
    # (each product within about 2^-20 of exact). The
    # bf16 backward runs on the tensor cores and rounds p and ds to bf16
    # before the accumulating products (2^-9 relative each, on average over
    # a sum), well inside 3e-2.
    ("flash_fwd", torch.float32): 2e-4,
    ("flash_fwd", torch.bfloat16): 3e-2,
    ("flash_bwd", torch.float32): 2e-3,
    ("flash_bwd", torch.bfloat16): 3e-2,
    # ... and the f32 backward at a tight absolute limit, FLASH_TIGHT_ATOL
    # below, with no relative term: one TF32 pass instead of three (the lo
    # terms dropped) stays inside 2e-3 but not inside this.
    ("flash_bwd_tight", torch.float32): 0.0,
    ("flash_fwd_tight", torch.float32): 0.0,
    # ... and against the plain version that rounds p and ds as the kernel
    # does (``rounded=True``). The two compute the same f32 scores in
    # another order (tensor-core sums against cuBLAS's), so p and ds differ
    # by ~1e-7 relative before rounding, and their sums by ~1e-6. Both round
    # each result to bf16: one ulp apart at most, 2^-7 relative (rtol). A p
    # or ds that straddles a bf16 rounding midpoint rounds one ulp apart,
    # which moves the sums it enters by up to 2^-7 of that term; the f32
    # gaps make this rare (about 1e-4 of elements), but a row that sees few
    # keys has terms near 1. So the atol is per output row (flash_flip_atol):
    # FLASH_ROUNDED_ATOL for the sum order plus FLASH_FLIPS such flips of
    # the row's largest term (p do for dV, ds q scale for dK, ds k scale
    # for dQ, bounded by the largest |do|, |q| or |k| of the slice).
    ("flash_bwd_rounded", torch.bfloat16): 2 ** -7,
    # The bf16 forward (tensor cores) rounds the softmax numerators p to bf16
    # before P V, against the running max, where rounded=True rounds them
    # against the final max: a p may round one ulp apart (the per-row
    # flash_fwd_flip_atol); lse is f32 in both, sum order apart.
    ("flash_fwd_rounded", torch.bfloat16): 2 ** -7,
    # LayerNorm gradients: the analytic backward under the kernel's forward
    # against autograd through the plain composition; f32 sums of up to 512
    # rows in another order (rtol 1e-4 as tests/test_pallas_layernorm.py)
    ("layernorm_grad", torch.float32): 1e-4,
    ("layernorm_grad", torch.bfloat16): 3e-2,
    # softmax xent forward (loss, lse): kernel and plain version read the
    # same values and compute in f32 in both dtypes, and differ in the order
    # of the row sum and in expf only (1e-5, tests/test_pallas_softmax_xent
    # .py's f32 tolerance).
    ("xent_fwd", torch.float32): 1e-5,
    ("xent_fwd", torch.bfloat16): 1e-5,
    # The backward is held per element, at XENT_BWD_ATOL below and these
    # rtols: it recomputes softmax from the saved row max and sum where the
    # plain version takes it from scratch; both compute exp(x - max) / sum
    # in f32 (the kernel as a product with 1 / sum) and differ by a few f32
    # ulps (rtol 1e-5); in bf16 both round those f32 values, at most one
    # bf16 ulp apart (2^-8 relative, rtol 1e-2).
    ("xent_bwd", torch.float32): 1e-5,
    ("xent_bwd", torch.bfloat16): 1e-2,
}
FLASH_ROUNDED_ATOL = 1e-4
FLASH_FLIPS = 2
# The tight limit of the f32 backward: 4x the largest |kernel - plain| of
# the unmodified 3xTF32 kernels over FLASH_CASES at d 64 and 128 (dk, dv,
# dq together) on the H100 (PERF.md gives the run).
FLASH_TIGHT_ATOL = 4 * 8.06e-5
# ... and of the f32 forward (out and lse together), the same way
FLASH_FWD_TIGHT_ATOL = 4 * 6.199e-6
# At C classes a row's |dx| averages 2 g / C and most of its elements are
# far below that (the median at the LM head's shape is ~2e-7 g), so an
# absolute tolerance at the scale of the other checks would pass a backward
# that drops every probability but the largest. The xent backward's atol
# is 1e-3 * g[row] / C, per row.
XENT_BWD_ATOL = 1e-3
# Adam: tests/test_pallas_optimizer.py's (rtol, atol) for one update and
# for a 10-step trajectory; the kernel may contract a*b + c into one fma
# where the plain version rounds twice, a 1-ulp difference.
ADAM_TOL = {"step": (1e-6, 1e-7), "trajectory": (1e-5, 1e-6)}
# Training parity, kernels against plain versions, 3 steps at lr 1e-4:
# losses differ by sum order only (rtol 1e-4). Adam's first steps move a
# weight by about lr * g / (|g| + eps), close to lr * sign(g), and by at
# most 1.004 * lr in each of the first three steps; a gradient near 0 whose
# sign differs between the runs moves that weight by up to 2.008 * lr per
# step, so no weight may differ by more than 2.01 * lr * steps. Nearly all
# agree far closer: at most 1% may differ by more than 1e-2 * lr.
TRAIN_LR, TRAIN_STEPS = 1e-4, 3
TRAIN_LOSS_TOL = (1e-4, 0.0)  # (rtol, atol)
# bf16 training (amp="bfloat16", SoftmaxCrossEntropyLoss, Adam on a warm-up
# cosine schedule from AMP_LR): kernels against plain versions. The two
# round to bf16 in other places (the plain LayerNorm, the einsum attention,
# the composition's bf16 per-token losses), so the limits are multiples of
# the largest spread that tools/torch_amp_parity.py measured over seeds 1-6
# on the H100 (PERF.md): per-step loss gap 2.06e-3 (limit 3x), gap of the
# loss's fall over the steps 0.111 (limit 2.25x; the plain losses are
# multiples of 1/64, which alone moves a fall of 0.23 by up to 0.03), share
# of weights beyond 1e-2 * lr 0.0259 (limit 2x; a backward that drops every
# probability below 1e-3 gives 0.69). The f32 masters stay within the
# sign-flip bound above over the scheduled rates (2.01 · their sum).
AMP_LR = 1e-4
AMP_LOSS_RTOL = 6e-3
AMP_DROP_RTOL = 0.25
AMP_FAR_SHARE = 0.05


def amp_schedule():
    """Linear warm-up from 1e-5 to AMP_LR over 4 steps, then cosine. The
    warm-up's end is the ``base_lr`` given here: the optimizer's
    ``learning_rate`` replaces ``base_lr`` but not the warm-up's end (as in
    MXNet and the JAX package)."""
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler

    return CosineScheduler(max_update=1000, base_lr=AMP_LR, warmup_steps=4,
                           warmup_begin_lr=1e-5)
# Logits of the engine on the kernels against the same engine on their plain
# versions, f32, 2 layers: the f32 sums differ in order only (the
# tolerance of the port's CPU tests against the JAX package). Under
# amp.init("bfloat16") the two round the attention weights to bf16 against
# other maxima (the kernel the running one, the plain version the softmax's):
# the bf16 tolerance of the CPU tests against the JAX package. Under
# amp.init("float16") they round them to f16, three mantissa bits finer:
# the bf16 limit over 8.
LOGIT_TOL = {None: 1e-4, "bfloat16": 3e-2, "float16": 3e-2 / 8}


_T0 = time.perf_counter()


def log(*a):
    """A line of the run's log, after the seconds since the script
    started."""
    print(f"{time.perf_counter() - _T0:7.1f}s", *a, flush=True)


def cuda_time_ms(fn, warmup=3, iters=20, repeats=5):
    """Eager time of one call: median over ``repeats`` of the mean time of
    ``iters`` calls, by CUDA events on the current stream. A call that the
    card finishes faster than the host issues it measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_time_ms(fn, calls=8, replays=10, repeats=5):
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's cost of
    issuing each call is out of the measurement. Median over ``repeats``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, as graph capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (replays * calls))
    del graph
    return statistics.median(times)


def check_close(name, dtype, got, want, what, atol=None, failures=None):
    """|got - want| <= atol + rtol * |want| per element, rtol from TOL and
    atol the same number unless given (a float or a tensor that
    broadcasts against ``want``). Raises on a violation, or appends its
    message to ``failures`` when that is a list."""
    tol = TOL[(name, dtype)]
    atol = tol if atol is None else atol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        msg = f"{name} {what}: non-finite kernel output"
        if failures is None:
            raise AssertionError(msg)
        log(f"  FAILED {msg}")
        failures.append(msg)
    err = (got - want).abs()
    bad = err > atol + tol * want.abs()
    shown = (f"{atol:.3g}" if isinstance(atol, float)
             else f"{atol.min().item():.3g}..{atol.max().item():.3g}")
    log(f"  {name} {what}: max_abs_err={err.max().item():.3e} "
        f"(atol={shown}, rtol={tol})")
    if bad.any():
        msg = f"{name} {what}: {int(bad.sum())} elements outside tolerance"
        if failures is None:
            raise AssertionError(msg)
        log(f"  FAILED {msg}")
        failures.append(msg)
    return err.max().item()


# ---------------------------------------------------------------------------
# A kernel that does nothing, launched on the grid and block of the route
# that LayerNorm's forward takes (csrc/layernorm.cu): the warp route's
# ceil(rows / FWD_WARPS) blocks of 32 * FWD_WARPS threads, or the block
# route's one block of 256 threads a row with the row's d floats of dynamic
# shared memory. The device time of a launch itself, which LayerNorm's
# times at the serving shapes are read against. No path of the port
# launches it, so it is built here, beside the port's kernels.
EMPTY_CU = r"""
__global__ void __launch_bounds__(256) empty_kernel() {}

extern "C" int mx_empty(int grid, int threads, int smem, void* stream) {
  empty_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
_EMPTY = {}  # "lib": the loaded empty kernel


def ln_route(x, gamma, beta):
    """The route LayerNorm's forward takes for these tensors (its output,
    a fresh allocation, is aligned)."""
    from mxnet_tpu_torch.ops import layernorm as ln

    return ln._route(x.shape[-1], x.dtype,
                     (x.data_ptr(), gamma.data_ptr(), beta.data_ptr()),
                     ln.FWD_WARP_MAX_BYTES // x.element_size())


def empty_launch(x, gamma, beta):
    """Launch the empty kernel on the grid and block that LayerNorm's
    forward takes for ``x``."""
    from mxnet_tpu_torch.ops import cuda_common
    from mxnet_tpu_torch.ops import layernorm as ln

    d = x.shape[-1]
    rows = x.numel() // d
    if ln_route(x, gamma, beta) == "warp":
        shape = (-(-rows // ln.FWD_WARPS), 32 * ln.FWD_WARPS, 0)
    else:
        shape = (rows, 256, 4 * d)
    rc = _EMPTY["lib"].mx_empty(*shape, cuda_common.stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"empty kernel: CUDA error {rc}")


def phase_build():
    from mxnet_tpu_torch.ops import cuda_common

    t0 = time.perf_counter()
    cuda_common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_common.BUILD_DIR / "empty_kernel.cu"
    src.write_text(EMPTY_CU)
    empty_so = src.with_suffix(".so")
    empty = subprocess.Popen(
        [cuda_common._nvcc(), *cuda_common.NVCC_FLAGS, "-o", str(empty_so),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    libs = cuda_common.build()
    out, _ = empty.communicate(timeout=300)
    if empty.returncode != 0:
        raise RuntimeError(f"nvcc of the empty kernel failed:\n{out}")
    _EMPTY["lib"] = ctypes.CDLL(str(empty_so))
    _EMPTY["lib"].mx_empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    log(f"[build] {len(libs)} kernel libraries and the empty kernel in "
        f"{time.perf_counter() - t0:.1f}s (sm_90a)")
    for name, path in libs.items():
        log_path = path.with_suffix(".log")
        fn = spill = None
        for line in (log_path.read_text().splitlines()
                     if log_path.exists() else []):
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip().split(", ")[1]
            elif "registers" in line and fn is not None:
                regs = line.split("Used ")[1].split(",")[0]
                log(f"  {name}: {fn[:72]}: {regs}, {spill}")
            elif "Performance Loss" in line:  # e.g. serialised wgmma
                log(f"  {name}: ptxas: {line.strip()[:240]}")
    check_tensor_cores(libs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


# the kernels that must multiply on the tensor cores, by library: (name
# fragments of the kernel, what they need): the bf16 flash forward and
# backward, the f32 flash forward and backward in 3xTF32, and the paged
# prefill read in 3xTF32 (every instantiation), whose HMMA must have the
# TF32 m16n8k8 shape (.TF32, 1688: True); the int8 product's wgmma route,
# whose tensor-core instructions must be warpgroup MMAs (IGMMA: "gmma"),
# and its mma.sync route (IMMA: False)
TC_KERNELS = {
    "flash_attention": [((ns, f"{kern}ILi{d}"), ns == "tf32x3")
                        for ns in ("bf16tc", "tf32x3")
                        for kern in ("flash_fwd_tc_kernel",
                                     "flash_bwd_dkv_tc_kernel",
                                     "flash_bwd_dq_tc_kernel")
                        for d in (64, 128)],
    "paged_attention": [((f"paged_prefill_tc_kernelILi{ch}",), True)
                        for ch in (16, 32, 64, 128)],
    "int8_gemm": [((f"int8_gemm_wgmma_kernelILi{bn}",), "gmma")
                  for bn in (64, 128)]
                 + [(("16int8_gemm_kernelILi64",), False),
                    (("16int8_gemm_kernelILi128",), False)],
}


def check_tensor_cores(libs):
    """Count the tensor-core instructions (HMMA, IMMA, and the warpgroup
    HGMMA, IGMMA) of each kernel of the libraries in TC_KERNELS in their
    SASS (``cuobjdump -sass``), and among them the TF32 ones and the
    warpgroup ones, and fail unless every kernel that a TC_KERNELS entry
    names has some (TF32 or warpgroup ones where it says so): each
    instantiation of a name on its own."""
    from mxnet_tpu_torch.ops import cuda_common

    cuobjdump = Path(cuda_common._nvcc()).with_name("cuobjdump")
    for name, wants in TC_KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = [0, 0, 0]
            elif fn is not None and ("HMMA" in line or "IMMA" in line
                                     or "GMMA" in line):
                counts[fn][0] += 1
                counts[fn][1] += ".TF32" in line or "1688" in line
                counts[fn][2] += "GMMA" in line
        for fn, (n, n_tf32, n_gmma) in sorted(counts.items()):
            if n:
                log(f"  {name} SASS: {n} tensor-core instructions "
                    f"({n_tf32} TF32, {n_gmma} warpgroup) in {fn[:80]}")
        for parts, need in wants:
            fns = [fn for fn in counts if all(p in fn for p in parts)]
            col = 2 if need == "gmma" else 1 if need else 0
            bare = [fn for fn in fns if counts[fn][col] == 0]
            if not fns or bare:
                what = {2: "warpgroup ", 1: "TF32 ", 0: ""}[col]
                raise AssertionError(
                    f"no {what}tensor-core instruction in "
                    f"{'::'.join(parts)} ({bare or 'no such kernel'})")


def _paged_case(gen, b, h, tq, ch, ps, n_pages, pool_pages, qdtype, dtype,
                trash_row, dev, positions=None):
    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    k_pool = randn(pool_pages + 1, h, ps, ch).to(dtype)
    v_pool = randn(pool_pages + 1, h, ps, ch).to(dtype)
    table = torch.randint(1, pool_pages + 1, (b, n_pages), generator=gen,
                          dtype=torch.int32).to(dev)
    if trash_row:
        table[0] = 0  # a released row: every slot is the trash page
    cap = n_pages * ps
    position = torch.randint(0, cap - tq + 1, (b,), generator=gen,
                             dtype=torch.int32)
    if positions is not None:
        position = torch.tensor(positions, dtype=torch.int32)
    position = position.to(dev)
    q = randn(b, h, tq, ch).to(qdtype)
    return q, k_pool, v_pool, table, position


# (B, H, tq, positions or None for random, what): the serving shapes
# (decode and a 128-query prefill chunk at B=8, 16 heads, row 0 all trash),
# then decode rows whose frontiers sit on a split boundary (key 128 and 256
# open a split), a key past one and a key before one, spanning 1 to 8
# splits of a 1024-key capacity, a small prefill chunk, the serve path's
# largest prefill (one row of 512 queries from position 0, 16 heads), and
# a ragged prefill whose 100 queries cross a 64-query tile and whose
# frontiers cross key tiles; then the speculative path's reads: the verify
# (8 rows of k + 1 = 5 queries, frontiers that differ row by row inside
# one launch, one near the cache end), the gpt2_117m draft's decode (12
# heads) and a suffix prefill after a 384-token adopted prefix
PAGED_CASES = [(8, 16, 1, None, "(row 0 all trash)"),
               (8, 16, 128, None, "(row 0 all trash)"),
               (8, 16, 1, [127, 128, 129, 255, 256, 300, 511, 1023],
                "(frontiers at split boundaries)"),
               (2, 4, 16, [120, 500], "(small prefill)"),
               (1, 16, 512, [0], "(serve prefill from position 0)"),
               (2, 4, 100, [37, 600], "(ragged prefill across tiles)"),
               (8, 16, 5, [31, 127, 128, 129, 300, 511, 600, 1018],
                "(verify, ragged frontiers)"),
               (8, 12, 1, [31, 127, 128, 129, 300, 511, 600, 1022],
                "(draft decode, 12 heads)"),
               (1, 16, 100, [384], "(suffix prefill after a 384-token "
                                   "prefix)"),
               (64, 8, 1, list(range(0, 1024, 16)),
                "(Transformer decode, 64 rows, 8 heads)")]
#: the kernel-table rows (f32) whose max_abs_err is that of the f32 checks
#: at their shape (B, H, tq)
PAGED_ROWS = {(8, 16, 5): "paged_attention_verify",
              (8, 12, 1): "paged_attention_draft",
              (64, 8, 1): "paged_attention_transformer"}


# (q, pool) dtypes of the paged read: f32 and bf16 models, an f32 model's
# cached read under amp.init("bfloat16") or amp.init("float16") (bf16 or
# f16 q over f32 pools), and f32 q over bf16 pools
PAGED_DTYPES = [(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32),
                (torch.float16, torch.float32),
                (torch.float32, torch.bfloat16)]


def phase_paged_kernels(errs, failures=None):
    """The paged read against its plain version at PAGED_CASES and
    PAGED_DTYPES, page sizes 16 and 6, head width 64, at the tolerance of
    the output's (q's) dtype; decode (the CUDA-core kernel) checks and
    errors under ``paged_attention``, prefill (the tensor-core kernel)
    under ``paged_attention_prefill``. ``failures`` as in check_close
    (tools/torch_flash_faults.py)."""
    from mxnet_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for qdtype, dtype in PAGED_DTYPES:
        dn = str(dtype)[6:] if qdtype == dtype \
            else f"{str(qdtype)[6:]}/{str(dtype)[6:]}"
        for b, h, tq, positions, what in PAGED_CASES:
            for ps in (16, 6):
                n_pages = -(-1024 // ps)
                case = _paged_case(gen, b, h, tq, 64, ps, n_pages,
                                   b * n_pages // 2 + 1, qdtype, dtype,
                                   positions is None, dev, positions)
                got = pa.paged_attention_read(*case)
                want = pa.paged_attention_read_plain(*case)
                torch.cuda.synchronize()
                if got.dtype != qdtype or want.dtype != qdtype:
                    raise AssertionError(f"paged read {dn}: output dtypes "
                                         f"{got.dtype} / {want.dtype}")
                key = "paged_attention" + ("" if tq == 1 else "_prefill")
                err = check_close(key, qdtype, got, want,
                                  f"{dn} B={b} H={h} tq={tq} ps={ps} {what}",
                                  failures=failures)
                errs[key] = max(errs.get(key, 0.0), err)
                row = PAGED_ROWS.get((b, h, tq))
                if row is not None and qdtype == dtype == torch.float32:
                    errs[row] = max(errs.get(row, 0.0), err)


def phase_kernels():
    errs = {"adam": 0.0}
    phase_paged_kernels(errs)
    phase_layernorm_kernels(errs)
    phase_layernorm_grads(errs)
    phase_flash_kernels(errs)
    phase_flash_alignment()
    log("[flash] f32 forward against the f64 plain version: kernel "
        f"{errs['flash_fwd_f64']:.3e}, the f32 plain version "
        f"{errs['flash_fwd_plain_f64']:.3e}")
    log("[flash] f32 backward against the f64 plain version: kernels "
        f"dK/dV {errs['flash_bwd_dkv_f64']:.3e}, dQ "
        f"{errs['flash_bwd_dq_f64']:.3e}; the f32 plain version dK/dV "
        f"{errs['flash_bwd_dkv_plain_f64']:.3e}, dQ "
        f"{errs['flash_bwd_dq_plain_f64']:.3e}")
    phase_adam_kernel(errs)
    phase_adam_amp(errs)
    phase_xent_kernels(errs)
    return errs


def _flash_inputs(gen, b, h, tq, tk, d, dtype, dev, scale=1.0):
    def randn(*shape):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    return randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)


# (B, H, Tq, Tk, causal): the training shape both ways, cross lengths with
# rows that see no key (Tq > Tk), and a ragged length; then the WMT
# Transformer's short ones (B·H up to 1024, T below one 64-key tile): its
# decoder self-attention at buckets 8 and 32 (transformer_base, 8 heads)
# and 24 (transformer_big, 16 heads), and the unmasked cross-attention
# shape, 12 queries over 32 keys
FLASH_CASES = [(4, 16, 1024, 1024, True), (4, 16, 1024, 1024, False),
               (1, 16, 128, 384, True), (1, 16, 384, 128, True),
               (2, 8, 320, 320, True),
               (64, 8, 8, 8, True), (64, 8, 32, 32, True),
               (64, 16, 24, 24, True), (64, 8, 12, 32, False)]
#: the cases whose errors (at d = 64) are also kept apart, under
#: ``<kernel><sfx>@B,H,Tq,Tk,causal``: the Transformer's kernel-table rows
FLASH_ROW_CASES = {(64, 8, 32, 32, True)}


def flash_flip_atol(q, k, v, do, lse, di, causal):
    """The rounded check's atol of each output row of dk, dv and dq (see
    TOL): FLASH_ROUNDED_ATOL plus FLASH_FLIPS times 2^-7 of the row's
    largest term."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    p, ds = fa._recompute(q, k, v, do, lse, di, causal)
    ds = ds.abs()
    scale = q.shape[-1] ** -0.5

    def slice_max(t):  # per (b, h) slice, as (B, H, 1, 1)
        return t.float().abs().amax(dim=(-2, -1), keepdim=True)

    terms = {"dk": ds.amax(dim=-2).unsqueeze(-1) * slice_max(q) * scale,
             "dv": p.amax(dim=-2).unsqueeze(-1) * slice_max(do),
             "dq": ds.amax(dim=-1).unsqueeze(-1) * slice_max(k) * scale}
    return {n: FLASH_ROUNDED_ATOL + FLASH_FLIPS * 2 ** -7 * t
            for n, t in terms.items()}


def flash_fwd_flip_atol(q, k, v, causal):
    """The rounded forward check's atol of each output row: FLASH_ROUNDED_ATOL
    plus FLASH_FLIPS times 2^-7 of the row's largest p |v| term (p the
    softmax weight, |v| bounded by the largest of the slice). The kernel
    rounds exp(s - m) against the running max m, the plain version against
    the final one, so a p may round one ulp apart."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    s, _ = fa._scores(q, k, causal)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # rows with no live key
    vmax = v.float().abs().amax(dim=(-2, -1), keepdim=True)
    return FLASH_ROUNDED_ATOL + FLASH_FLIPS * 2 ** -7 * \
        p.amax(dim=-1, keepdim=True) * vmax


def _flash_bwd_f64(q, k, v, do, lse, di, causal):
    """The plain FA-2 backward (``_recompute`` and the products of
    ``_flash_bwd_dkv_plain`` / ``_flash_bwd_dq_plain``) in f64 on the same
    inputs: the witness that tells the f32 kernels' error from the f32
    plain version's. Returns (dk, dv, dq) in f64."""
    q, k, v, do, lse, di = (t.double() for t in (q, k, v, do, lse, di))
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    p = torch.exp(s - lse.unsqueeze(-1))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        live = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        p = p.masked_fill(~live, 0.0)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - di.unsqueeze(-1))
    return (torch.matmul(ds.transpose(-1, -2), q * scale),
            torch.matmul(p.transpose(-1, -2), do),
            torch.matmul(ds, k) * scale)


def _flash_fwd_f64(q, k, v, causal):
    """The plain forward (``flash_fwd_plain``) in f64 on the same inputs:
    the witness that tells the f32 kernel's error from the f32 plain
    version's. Returns (out, lse) in f64."""
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        live = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~live, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    dead = m == float("-inf")
    m = torch.where(dead, torch.zeros_like(m), m)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    lse = torch.where(dead, torch.zeros_like(m), m + torch.log(l))
    p = torch.exp(s - lse).masked_fill(dead, 0.0)
    return torch.matmul(p, v), lse.squeeze(-1)


def phase_flash_kernels(errs, dtypes=(torch.float32, torch.bfloat16),
                        failures=None):
    """Flash forward + lse, dK/dV and dQ against their plain versions, f32
    and bf16, head dims 64 and 128. The bf16 kernels are held twice:
    against the exact plain version and against the one that rounds p (and
    ds) as the tensor-core kernels do; the f32 kernels (3xTF32) twice too:
    at the f32 tolerance and at FLASH_FWD_TIGHT_ATOL / FLASH_TIGHT_ATOL.
    Errors go to ``errs`` under the kernel's name, with ``_bf16`` for bf16
    and ``_rounded`` or ``_tight`` for the second check. The f32 kernels
    and their plain versions are also measured against the f64 plain
    versions (``_f64`` and ``_plain_f64``; no limit: the witness of what
    sets the tight limits). ``failures`` as in check_close
    (tools/torch_flash_faults.py)."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)

    case = None  # the FLASH_ROW_CASES key of the case at hand, or None

    def held(key, *args, **kw):
        err = check_close(*args, failures=failures, **kw)
        for k in (key,) + ((f"{key}@{case}",) if case else ()):
            errs[k] = max(errs.get(k, 0.0), err)

    for dtype in dtypes:
        dn = str(dtype)[6:]
        sfx = "" if dtype == torch.float32 else "_bf16"
        for d in (64, 128):
            for b, h, tq, tk, causal in FLASH_CASES:
                what = f"{dn} d={d} B={b} H={h} Tq={tq} Tk={tk} causal={causal}"
                case = f"{b},{h},{tq},{tk},{int(causal)}" if d == 64 and \
                    (b, h, tq, tk, causal) in FLASH_ROW_CASES else None
                q, k, v = _flash_inputs(gen, b, h, tq, tk, d, dtype, dev)
                out, lse = fa._flash_fwd(q, k, v, causal, return_lse=True)
                ref, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
                torch.cuda.synchronize()
                held("flash_fwd" + sfx, "flash_fwd", dtype, out, ref,
                     f"out {what}")
                held("flash_fwd" + sfx, "flash_fwd", dtype, lse, ref_lse,
                     f"lse {what}")
                if not sfx:  # 3xTF32: the tight limit and the f64 witness
                    for grad, got, want in (("out", out, ref),
                                            ("lse", lse, ref_lse)):
                        held("flash_fwd_tight", "flash_fwd_tight", dtype, got,
                             want, f"{grad} {what} (tight)",
                             atol=FLASH_FWD_TIGHT_ATOL)
                    exact = _flash_fwd_f64(q, k, v, causal)
                    for key, xs in (("_f64", (out, lse)),
                                    ("_plain_f64", (ref, ref_lse))):
                        err = max((x.double() - w).abs().max().item()
                                  for x, w in zip(xs, exact))
                        errs["flash_fwd" + key] = max(
                            errs.get("flash_fwd" + key, 0.0), err)
                    del exact
                if sfx:  # the tensor-core forward rounds p as rounded=True
                    rref, rlse = fa.flash_fwd_plain(q, k, v, causal,
                                                    rounded=True)
                    atol = flash_fwd_flip_atol(q, k, v, causal)
                    torch.cuda.synchronize()
                    held("flash_fwd_bf16_rounded", "flash_fwd_rounded", dtype,
                         out, rref, f"out {what} (p rounded)", atol=atol)
                    held("flash_fwd_bf16_rounded", "flash_fwd_rounded", dtype,
                         lse, rlse, f"lse {what} (p rounded)",
                         atol=FLASH_ROUNDED_ATOL)
                    del rref, rlse, atol
                do = torch.randn(b, h, tq, d, generator=gen).to(dev, dtype)
                di = fa._row_dot(do, out).contiguous()
                dk, dv = fa._bwd_dkv(q, k, v, do, lse, di, causal)
                dq = fa._bwd_dq(q, k, v, do, lse, di, causal)
                for rounded in (False, True) if sfx else (False,):
                    rdk, rdv = fa._flash_bwd_dkv_plain(q, k, v, do, lse, di,
                                                       causal, rounded=rounded)
                    rdq = fa._flash_bwd_dq_plain(q, k, v, do, lse, di, causal,
                                                 rounded=rounded)
                    atol = flash_flip_atol(q, k, v, do, lse, di, causal) \
                        if rounded else {}
                    torch.cuda.synchronize()
                    # (check, errs key suffix, atol by grad, message tail)
                    checks = [("flash_bwd_rounded", "_rounded", atol,
                               " (p, ds rounded)") if rounded else
                              ("flash_bwd", "", {}, "")]
                    if not sfx:
                        checks.append(("flash_bwd_tight", "_tight",
                                       dict.fromkeys(("dk", "dv", "dq"),
                                                     FLASH_TIGHT_ATOL),
                                       " (tight)"))
                    for name, key, atols, tail in checks:
                        for kern, grad, got, want in (
                                ("flash_bwd_dkv", "dk", dk, rdk),
                                ("flash_bwd_dkv", "dv", dv, rdv),
                                ("flash_bwd_dq", "dq", dq, rdq)):
                            held(kern + sfx + key, name, dtype, got, want,
                                 f"{grad} {what}{tail}", atol=atols.get(grad))
                    if not sfx:
                        exact = _flash_bwd_f64(q, k, v, do, lse, di, causal)
                        for kern, got, plain, want in zip(
                                ("flash_bwd_dkv", "flash_bwd_dkv",
                                 "flash_bwd_dq"), (dk, dv, dq),
                                (rdk, rdv, rdq), exact):
                            for key, x in (("_f64", got), ("_plain_f64", plain)):
                                err = (x.double() - want).abs().max().item()
                                errs[kern + key] = max(errs.get(kern + key, 0.0),
                                                       err)
                        del exact


def phase_flash_alignment():
    """A misaligned f32 input (a contiguous view 4 bytes past a 16-byte
    boundary) is refused: by the forward's wrapper with MXNetError, and by
    the C launcher itself with cudaErrorMisalignedAddress, before any
    launch."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import cuda_common
    from mxnet_tpu_torch.ops import flash_attention as fa

    shape = (1, 2, 64, 64)
    k = torch.zeros(shape, device="cuda")
    q = torch.zeros(1 + k.numel(), device="cuda")[1:].view(shape)
    try:
        fa._flash_fwd(q, k, k, True)
    except MXNetError as e:
        log(f"  flash_fwd f32 misaligned q: refused ({e})")
    else:
        raise AssertionError("flash_fwd took a misaligned f32 q")
    out = torch.empty_like(k)
    lib = cuda_common.load("flash_attention")
    rc = lib.mx_flash_fwd(q.data_ptr(), k.data_ptr(), k.data_ptr(),
                          out.data_ptr(), None, 2, 64, 64, 64, 1,
                          cuda_common.dtype_code(torch.float32),
                          cuda_common.stream_ptr(q.device))
    msg = lib.mx_error_string(rc).decode() if rc else "success"
    if "misaligned" not in msg:
        raise AssertionError(f"mx_flash_fwd on a misaligned f32 q returned "
                             f"{rc} ({msg}), not cudaErrorMisalignedAddress")
    log(f"  mx_flash_fwd f32 misaligned q: refused ({rc}: {msg})")


def _adam_close(got, want, tol, what):
    rtol, atol = tol
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got).all() or \
            (err > atol + rtol * want.float().abs()).any():
        raise AssertionError(f"adam {what}: max abs err {err.max().item()} "
                             f"outside rtol={rtol} atol={atol}")
    return err.max().item()


def phase_adam_kernel(errs):
    """Multi-tensor Adam against the plain version per tensor: odd sizes
    around the 4096-element chunk, f32 and bf16 gradients, with and without
    the bf16 copy, clip and rescale on, per-tensor lr and wd; one step,
    then a 10-step trajectory."""
    from mxnet_tpu_torch.ops import optimizer as oo

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    sizes = [1, 7, 4095, 4096, 4097, 65537, 300 * 129, 1_000_003]
    n = len(sizes)

    def randn(size, scale=1.0):
        return (torch.randn(size, generator=gen) * scale).to(dev)

    ws = [randn(s) for s in sizes]
    ms = [randn(s, 0.1) for s in sizes]
    vs = [randn(s, 0.1).abs() * 0.1 for s in sizes]
    lows = [torch.empty(s, dtype=torch.bfloat16, device=dev) if i % 2 else None
            for i, s in enumerate(sizes)]
    pw, pm, pv = ([t.clone() for t in ts] for ts in (ws, ms, vs))
    plows = [None if t is None else t.clone() for t in lows]
    lr = (torch.rand(n, generator=gen) * 1e-2).to(dev)
    wd = (torch.rand(n, generator=gen) * 1e-2).to(dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=0.5,
              clip_gradient=1.0)
    worst = 0.0
    for step in range(10):
        gs = [randn(s, 2.0) for s in sizes]
        gs = [g.to(torch.bfloat16) if i % 3 == 1 else g
              for i, g in enumerate(gs)]
        oo.adam_update_fused(ws, gs, ms, vs, lr, wd, out_lows=lows, **kw)
        for i in range(n):
            oo.adam_update(pw[i], gs[i], pm[i], pv[i], lr[i], kw["beta1"],
                           kw["beta2"], kw["epsilon"], wd[i],
                           kw["rescale_grad"], kw["clip_gradient"], plows[i])
        torch.cuda.synchronize()
        tol = ADAM_TOL["step" if step == 0 else "trajectory"]
        for i in range(n):
            for got, want, name in ((ws[i], pw[i], "w"), (ms[i], pm[i], "m"),
                                    (vs[i], pv[i], "v")):
                worst = max(worst, _adam_close(got, want, tol,
                                               f"{name}[{sizes[i]}] step {step}"))
            if lows[i] is not None and not torch.equal(
                    lows[i], ws[i].to(torch.bfloat16)):
                raise AssertionError(f"adam bf16 copy [{sizes[i]}] is not the "
                                     f"rounding of the new weight")
        if step == 0:
            log(f"  adam one step over {n} tensors ({sum(sizes)} elements, "
                f"f32/bf16 grads, bf16 copies): max_abs_err={worst:.3e} "
                f"(rtol, atol {ADAM_TOL['step']})")
    log(f"  adam 10-step trajectory: max_abs_err={worst:.3e} "
        f"(rtol, atol {ADAM_TOL['trajectory']})")
    errs["adam"] = worst


def phase_adam_amp(errs):
    """The Adam kernel's float16-scaling additions against the plain
    version: an f16 gradient times a device inverse scale with f16 and bf16
    copies, and the skip flag, whose launch leaves weights, moments and
    copies bit-unchanged."""
    from mxnet_tpu_torch.ops import optimizer as oo

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    sizes = [7, 4097, 300 * 129, 1_000_003]
    ws = [torch.randn(s, generator=gen).to(dev) for s in sizes]
    ms = [(torch.randn(s, generator=gen) * 0.1).to(dev) for s in sizes]
    vs = [(torch.randn(s, generator=gen) * 0.01).abs().to(dev) for s in sizes]
    gs = [(torch.randn(s, generator=gen) * 512).to(dev, torch.float16)
          for s in sizes]
    lows = [torch.empty(s, dtype=(torch.float16, torch.bfloat16)[i % 2],
                        device=dev) for i, s in enumerate(sizes)]
    pw, pm, pv = ([t.clone() for t in ts] for ts in (ws, ms, vs))
    plows = [t.clone() for t in lows]
    inv = torch.tensor(1.0 / 1024, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=0.5)
    oo.adam_update_fused(ws, gs, ms, vs, 1e-3, 0.01, out_lows=lows,
                         inv_scale=inv, **kw)
    for i in range(len(sizes)):
        oo.adam_update(pw[i], gs[i], pm[i], pv[i], 1e-3, wd=0.01,
                       out_low=plows[i], inv_scale=inv, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for i, n in enumerate(sizes):
        for got, want, name in ((ws[i], pw[i], "w"), (ms[i], pm[i], "m"),
                                (vs[i], pv[i], "v")):
            worst = max(worst, _adam_close(got, want, ADAM_TOL["step"],
                                           f"{name}[{n}] f16 grad, 1/scale"))
        if not torch.equal(lows[i], ws[i].to(lows[i].dtype)):
            raise AssertionError(f"adam {lows[i].dtype} copy [{n}] is not the "
                                 f"rounding of the new weight")
    gs[1][5] = float("inf")
    keep = [t.clone() for t in ws + ms + vs + lows]
    oo.adam_update_fused(ws, gs, ms, vs, 1e-3, 0.01, out_lows=lows,
                         inv_scale=inv,
                         skip=torch.ones((), dtype=torch.int32, device=dev),
                         **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(keep, ws + ms + vs + lows)):
        raise AssertionError("adam: a skipped launch changed its tensors")
    errs["adam"] = max(errs["adam"], worst)
    log(f"  adam f16 grads x device 1/scale, f16/bf16 copies: max_abs_err="
        f"{worst:.3e} (rtol, atol {ADAM_TOL['step']}); skip flag: all "
        f"{len(keep)} tensors bit-unchanged")


# (N, C) of the xent checks: the LM head of the train_amp phase (B·T =
# 4096, vocab 50257), one row, ragged small shapes, a row wider than the
# TPU kernel's 65536 cap, and the vision heads: ResNet-50's at B=64 and
# B=128 (1000 classes), LeNet's (64, 10)
XENT_CASES = [(4096, 50257), (1, 50257), (9, 50), (300, 128), (7, 70000),
              (64, 1000), (128, 1000), (64, 10), (700, 10000)]


def _xent_inputs(gen, n, c, dtype, dev, special=False):
    """Logits ~ 3·N(0, 1), labels in [0, C), cotangent in [0.5, 1.5). With
    ``special`` (n >= 6): row 0 extreme logits, row 1 -inf on every other
    column, rows 2 and 3 labels -1 and C, row 5 all -inf (NaN in both)."""
    x = torch.randn(n, c, generator=gen) * 3
    lbl = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
    g = torch.rand(n, generator=gen) + 0.5
    if special:
        x[0] = torch.tensor([1e4, -1e4, 0.0, 50.0]).repeat(c // 4 + 1)[:c]
        lbl[0] = 1
        x[1, ::2] = float("-inf")
        lbl[1] = 1
        lbl[2], lbl[3] = -1, c
        x[5] = float("-inf")
    return x.to(dev, dtype), lbl.to(dev), g.to(dev)


def phase_xent_kernels(errs):
    """Softmax xent forward (loss, and lse from the row statistics) and
    backward against their plain versions, f32 and bf16, at XENT_CASES; the
    special rows of ``_xent_inputs`` in the (9, 50) and (7, 70000) cases.
    The backward is held per element at XENT_BWD_ATOL."""
    from mxnet_tpu_torch.ops import softmax_xent as sx

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)
    errs.setdefault("xent_fwd", 0.0)
    errs.setdefault("xent_bwd", 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for n, c in XENT_CASES:
            special = n in (9, 7)
            x, lbl, g = _xent_inputs(gen, n, c, dtype, dev, special)
            loss, stats = sx._xent_fwd(x, lbl)
            lse = stats[0] + torch.log(stats[1])
            dx = sx._xent_bwd(x, lbl, stats, g)
            rloss, rlse = sx.softmax_cross_entropy_plain(x, lbl)
            rdx = sx.softmax_cross_entropy_bwd_plain(x, lbl, g)
            torch.cuda.synchronize()
            rows = torch.ones(n, dtype=torch.bool, device=dev)
            if special:  # the all -inf row: NaN in both, as in JAX
                rows[5] = False
                if not (loss[5].isnan() and rloss[5].isnan()
                        and dx[5].isnan().all()):
                    raise AssertionError(f"xent {dn} ({n}, {c}): an all -inf "
                                         f"row must give NaN")
            what = f"{dn} ({n}, {c})" + (" with extreme/-inf logits, labels "
                                         "-1 and C" if special else "")
            errs["xent_fwd"] = max(
                errs["xent_fwd"],
                check_close("xent_fwd", dtype, loss[rows], rloss[rows],
                            f"loss {what}"),
                check_close("xent_fwd", dtype, lse[rows], rlse[rows],
                            f"lse {what}"))
            atol = (XENT_BWD_ATOL / c) * g[rows, None]
            errs["xent_bwd"] = max(errs["xent_bwd"], check_close(
                "xent_bwd", dtype, dx[rows], rdx[rows], f"dx {what}", atol))
            # each case's own errors, for the rows of other paths' shapes
            errs[f"xent_fwd {dn} ({n}, {c})"] = max(
                check_close("xent_fwd", dtype, loss[rows], rloss[rows],
                            f"loss {what}"),
                check_close("xent_fwd", dtype, lse[rows], rlse[rows],
                            f"lse {what}"))
            errs[f"xent_bwd {dn} ({n}, {c})"] = check_close(
                "xent_bwd", dtype, dx[rows], rdx[rows], f"dx {what}", atol)
            del x, dx, rdx


# LayerNorm cases held against the plain versions: (rows, d, offset, the
# routes forward and backward take, by x's dtype). The serving and training
# paths' rows of 1024 (warp route); a ragged width that is a whole number of
# 16-byte vectors (warp); one that is not (block); rows of 2048 (the
# forward's warp route takes 4 KiB rows: bf16 ones); the widest (block);
# and x starting one element into its buffer, a contiguous view at a
# misaligned address (block): as x[1:] of a (rows, 1023) tensor, and at
# d = 1024.
_WARP = {torch.float32: ("warp", "warp"), torch.bfloat16: ("warp", "warp")}
_BLOCK = {torch.float32: ("block", "block"),
          torch.bfloat16: ("block", "block")}
LN_CASES = ((8, 1024, 0, _WARP), (512, 1024, 0, _WARP),
            (4096, 1024, 0, _WARP), (8192, 1024, 0, _WARP),
            (1280, 1024, 0, _WARP), (2048, 512, 0, _WARP),
            (2048, 1024, 0, _WARP), (64, 1000, 0, _WARP),
            (64, 1023, 0, _BLOCK),
            (64, 2048, 0, {torch.float32: ("block", "block"),
                           torch.bfloat16: ("warp", "block")}),
            (64, 8192, 0, _BLOCK), (64, 1023, 1, _BLOCK),
            (64, 1024, 1, _BLOCK))
# the (x, gamma) dtype pairs the kernels take: f32 and bf16 training, and
# bf16 activations under f32 parameters or the other way round
LN_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))


def _ln_case(gen, rows, d, offset, xdt, pdt, dev):
    """x (rows, d) with mean 0.5 and std 2 (the CPU tests' inputs),
    starting ``offset`` elements into its buffer; gamma, beta and a
    cotangent."""
    buf = (torch.randn(rows * d + offset, generator=gen) * 2 + 0.5)
    x = buf.to(dev, xdt)[offset:].view(rows, d)
    g = (1 + 0.1 * torch.randn(d, generator=gen)).to(dev, pdt)
    b = (0.1 * torch.randn(d, generator=gen)).to(dev, pdt)
    cot = torch.randn(rows, d, generator=gen).to(dev, xdt)
    return x, g, b, cot


def _ln_bwd_f64(x, gamma, g, eps=1e-5):
    """layer_norm_bwd's arithmetic in f64: the witness for the f32 sums of
    dgamma and dbeta over many rows."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).double(), g.reshape(-1, d).double()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dy = gf * gamma.double()
    dx = rstd * (dy - dy.mean(dim=-1, keepdim=True)
                 - xhat * (dy * xhat).mean(dim=-1, keepdim=True))
    return dx, (gf * xhat).sum(dim=0), gf.sum(dim=0)


def phase_layernorm_kernels(errs):
    """LayerNorm's forward and backward kernels against their plain
    versions (``layer_norm_plain``, ``layer_norm_bwd``) at LN_CASES: the
    paths' shapes in every dtype pair (BERT's (8192 | 1280, 1024) also
    recorded apart, as ``layernorm<sfx>_<rows>``, and the Transformer's
    (2048, 512 | 1024) as ``layernorm<sfx>_2048x<d>``), the others in f32 and
    bf16. Each case must take its routes. The backward at (4096, 1024) f32 is also measured
    against an f64 version of the plain arithmetic, beside the f32 plain
    version (logged: the f32 sums of dgamma and dbeta over 4096 rows in
    another order)."""
    from mxnet_tpu_torch.ops import layernorm as ln

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    routes = {}
    for rows, d, offset, case_routes in LN_CASES:
        pairs = LN_PAIRS if (d, offset) == (1024, 0) else LN_PAIRS[:2]
        for xdt, pdt in pairs:
            route = case_routes[xdt]
            x, g, b, cot = _ln_case(gen, rows, d, offset, xdt, pdt, dev)
            what = (f"{str(xdt)[6:]}/{str(pdt)[6:]} ({rows}, {d})"
                    + (f" at +{offset * x.element_size()} bytes"
                       if offset else ""))
            took = ln_route(x, g, b)
            bwd_took = ln._route(d, xdt, (x.data_ptr(), g.data_ptr(),
                                          cot.data_ptr()), ln.BWD_WARP_MAX_D)
            if (took, bwd_took) != route:
                raise AssertionError(f"layernorm {what}: routes {took} / "
                                     f"{bwd_took}, expected {route}")
            routes[what] = route
            # the kernel table's rows: f32 (train), bf16 (train_amp); the
            # mixed pairs apart
            sfx = {(torch.float32, torch.float32): "",
                   (torch.bfloat16, torch.bfloat16): "_bf16"}.get(
                (xdt, pdt), f"_{str(xdt)[6:]}_{str(pdt)[6:]}")
            keys = [sfx] + ([f"{sfx}_{rows}"] if rows in (8192, 1280)
                            else []) + \
                ([f"{sfx}_{rows}x{d}"] if rows == 2048 else [])
            got = ln.layer_norm(x, g, b)
            want = ln.layer_norm_plain(x, g, b)
            grads = ln._backward(x, g, cot, 1e-5)
            wants = ln.layer_norm_bwd(x, g, cot, 1e-5)
            torch.cuda.synchronize()
            err = check_close("layernorm", xdt, got, want,
                              f"{what} {route[0]}")
            for a, r, name in zip(grads, wants, ("dx", "dgamma", "dbeta")):
                if a.dtype != r.dtype or a.shape != r.shape:
                    raise AssertionError(f"layernorm backward {what}: {name} "
                                         f"{a.dtype} {tuple(a.shape)}, plain "
                                         f"{r.dtype} {tuple(r.shape)}")
                bwd_err = check_close("layernorm_grad", a.dtype, a, r,
                                      f"backward {name} {what} {route[1]}")
                for k in keys:
                    errs["layernorm_bwd" + k] = max(
                        errs.get("layernorm_bwd" + k, 0.0), bwd_err)
            for k in keys:
                errs["layernorm" + k] = max(errs.get("layernorm" + k, 0.0),
                                            err)
            if (rows, xdt, pdt) == (4096, torch.float32, torch.float32):
                w64 = _ln_bwd_f64(x, g, cot)
                log("[layernorm] backward at (4096, 1024) f32 against the f64 "
                    "plain version, max |err| of dx, dgamma, dbeta: kernel "
                    + ", ".join(f"{(a.double() - w).abs().max().item():.3e}"
                                for a, w in zip(grads, w64))
                    + "; f32 plain version "
                    + ", ".join(f"{(a.double() - w).abs().max().item():.3e}"
                                for a, w in zip(wants, w64)))
            del x, g, b, cot, got, want, grads, wants
    log(f"[layernorm] routes held: {routes}")


def phase_layernorm_grads(errs):
    """LayerNorm gradients through the autograd Function (forward and
    backward kernels) against autograd through the plain composition."""
    from mxnet_tpu_torch.ops import layernorm as ln

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(512, 1024, generator=gen).to(dev, dtype)
        g = (1 + 0.1 * torch.randn(1024, generator=gen)).to(dev, dtype)
        b = (0.1 * torch.randn(1024, generator=gen)).to(dev, dtype)
        cot = torch.randn(512, 1024, generator=gen).to(dev, dtype)
        grads = []
        for fn in (ln.layer_norm, ln.layer_norm_plain):
            args = [t.clone().requires_grad_() for t in (x, g, b)]
            grads.append(torch.autograd.grad(fn(*args), args, cot))
        torch.cuda.synchronize()
        for a, r, name in zip(*grads, ("dx", "dgamma", "dbeta")):
            errs["layernorm_grad"] = max(errs.get("layernorm_grad", 0.0),
                                         check_close("layernorm_grad", dtype,
                                                     a, r, f"{name} "
                                                     f"{str(dtype)[6:]} "
                                                     f"(512, 1024)"))


KNOBS = ("paged_attention_kernel", "fused_layernorm", "flash_attention",
         "flash_pallas_bwd", "fused_adam", "fused_softmax_xent")


@contextlib.contextmanager
def plain_versions():
    """Every kernel knob off: the port runs the kernels' plain PyTorch
    versions (and the einsum attention for full sequences)."""
    from mxnet_tpu_torch import config

    for k in KNOBS:
        config.set(k, False)
    try:
        yield
    finally:
        for k in KNOBS:
            config.set(k, True)


def phase_dense_equals_paged(amp=None):
    """2 layers at gpt2_345m width (f32 weights and caches): the dense and
    the paged engine give bit-identical logits, and both agree with the
    same paged engine run on the plain versions (the reference) within
    LOGIT_TOL. With ``amp="bfloat16"`` or ``"float16"`` all of it under
    ``contrib.amp.init(amp)``: the cached reads then take bf16 or f16 q over
    the f32 pools."""
    from mxnet_tpu_torch.contrib import amp as _amp

    if amp is None:
        return _dense_equals_paged(None)
    _amp.init(amp)
    try:
        return _dense_equals_paged(amp)
    finally:
        _amp._reset()


def _dense_equals_paged(amp):
    from mxnet_tpu_torch.inference import GenerationEngine
    from mxnet_tpu_torch.models import get_gpt2

    tol = LOGIT_TOL[amp]
    net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2, max_length=256,
                   device="cuda", seed=1)
    kw = dict(batch_size=2, eos_id=None, device="cuda")
    dense = GenerationEngine(net, paged=False, **kw)
    paged = GenerationEngine(net, paged=True, page_size=16, **kw)
    # the reference runs eagerly: the plain paged read syncs with the host,
    # which a CUDA graph cannot capture
    plain = GenerationEngine(net, paged=True, page_size=16,
                             engine_type="naive", **kw)
    worst = 0.0

    def against_plain(what, logits, ref):
        nonlocal worst
        err = (logits - ref).abs().max().item()
        worst = max(worst, err)
        if not torch.isfinite(logits).all() or err > tol:
            raise AssertionError(f"{what}: kernel logits differ from the "
                                 f"plain versions' by {err}")

    rs = np.random.RandomState(1)
    for slot, n in enumerate((37, 100)):
        prompt = rs.randint(0, 50257, n)
        t_d, t_p = dense.prefill(prompt, slot), paged.prefill(prompt, slot)
        with plain_versions():
            plain.prefill(prompt, slot)
        plain.last_tokens[slot] = t_p
        if t_d != t_p or not torch.equal(dense._last_logits,
                                         paged._last_logits):
            raise AssertionError(f"prefill {slot}: dense and paged differ")
        against_plain(f"prefill {slot}", paged._last_logits, plain._last_logits)
    for step in range(8):
        tok_d, _, lg_d = dense.decode_step()
        tok_p, _, lg_p = paged.decode_step()
        with plain_versions():
            _, _, lg_ref = plain.decode_step()
        # the plain engine follows its own greedy tokens; feed it the
        # kernel engine's so that both see the same inputs next step
        plain.last_tokens = tok_p.copy()
        if not torch.equal(lg_d, lg_p) or not np.array_equal(tok_d, tok_p):
            diff = (lg_d - lg_p).abs().max().item()
            raise AssertionError(f"decode step {step}: dense and paged "
                                 f"logits differ (max {diff})")
        against_plain(f"decode step {step}", lg_p, lg_ref)
    log(f"[dense==paged{'' if amp is None else ' amp ' + amp}] 2 prefills + "
        f"8 decode steps: logits bit-identical; max |kernel - plain| logit "
        f"{worst:.3e} (tolerance {tol})")


def _train_batch(batch, seq, vocab=50257, seed=0):
    """modelbench's batch: seeded random ids, labels the ids rolled by one."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (batch, seq))
    return (torch.from_numpy(ids.astype(np.int32)).cuda(),
            torch.from_numpy(np.roll(ids, -1, 1).astype(np.int32)).cuda())


def phase_train_parity(amp=None, seed=1, batch_seed=0, check=True,
                       model="gpt2"):
    """3 TrainStep steps of a 2-layer model at full width, every kernel
    knob on and then off, from the same seeded weights: per-step losses
    and final weights agree. ``model="gpt2"``: GPT-2 at gpt2_345m width
    (B=4, T=1024); ``"bert"``: BERT at bert_large width (units 1024, hidden
    4096, 16 heads, vocab 30522; B=8, T=128, M=20, ragged valid_length
    and both token types, ``bert_loss``). In f32 (``amp=None``) through
    ``lm_loss`` (or ``bert_loss``) and Adam at TRAIN_LR (TRAIN_* above);
    under ``amp="bfloat16"`` through SoftmaxCrossEntropyLoss (or
    ``bert_loss``) and Adam on the warm-up schedule, the masters staying
    f32 (AMP_* above). With ``check=False`` it only measures
    (tools/torch_amp_parity.py)."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import get_bert, get_gpt2, lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    if model == "gpt2":
        batch, n_inputs = _train_batch(4, 1024, seed=batch_seed), 1
        what = "2 layers at gpt2_345m width, B=4 T=1024"
    else:
        batch, n_inputs = _bert_batch(8, BERT_T, BERT_M, seed=batch_seed,
                                      ragged=True), 4
        what = (f"2 layers at bert_large width, B=8 T={BERT_T} M={BERT_M}, "
                f"valid_length {batch[2].tolist()}")
    runs = []
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            if model == "gpt2":
                net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2,
                               device="cuda", seed=seed)
                loss_fn = lm_loss if amp is None else \
                    SoftmaxCrossEntropyLoss()
            else:
                net = get_bert("bert_large", dropout=0.0, num_layers=2,
                               max_length=BERT_T, device="cuda", seed=seed)
                loss_fn = bert_loss
            if amp is None:
                opt = Adam(learning_rate=TRAIN_LR)
            else:
                opt = Adam(learning_rate=AMP_LR, lr_scheduler=amp_schedule())
            # the kernels through the step graphs (the default), the plain
            # versions eagerly: the reference
            ts = TrainStep(net, loss_fn, opt, amp=amp,
                           n_model_inputs=n_inputs,
                           engine_type="naive" if plain else "graph")
            rates, losses = [], []
            for _ in range(TRAIN_STEPS):
                rates.append(opt.learning_rate)
                losses.append(float(ts(*batch)))
        params = {n: p.detach().clone() for n, p in net.named_parameters()}
        if any(p.dtype != torch.float32 for p in params.values()):
            raise AssertionError("training parity: the masters left f32")
        runs.append((losses, params))
        del net, ts
    (lk, pk), (lp, pp) = runs
    name = ("train" if model == "gpt2" else "bert") + \
        (" parity" if amp is None else f" {amp} parity")
    rtol, atol = TRAIN_LOSS_TOL if amp is None else (AMP_LOSS_RTOL, 0.0)
    far_limit = 1e-2 if amp is None else AMP_FAR_SHARE
    gaps = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    # what the gradients decide: the loss's fall over the steps
    drop_k, drop_p = lk[0] - lk[-1], lp[0] - lp[-1]
    drop_gap = abs(drop_k - drop_p) / abs(drop_p)
    err = torch.cat([(pk[n] - pp[n]).abs().reshape(-1) for n in pk])
    worst = err.max().item()
    far = (err > 1e-2 * opt.lr).float().mean().item()
    bound = 2.01 * sum(rates)
    log(f"[{name}] {what}, seeds "
        f"{seed}/{batch_seed}, {TRAIN_STEPS} steps at lr {rates}: losses "
        f"kernels {lk} / plain {lp}, relative gaps {gaps} (limit {rtol}); "
        f"loss falls {drop_k:.6f} / {drop_p:.6f}, relative gap "
        f"{drop_gap:.3e}" + ("" if amp is None else
                             f" (limit {AMP_DROP_RTOL})")
        + f"; max |weight diff| {worst:.3e} (bound {bound:.3e}), share "
        f"beyond 1e-2*lr {far:.2e} (limit {far_limit})")
    res = {"losses_kernels": lk, "losses_plain": lp, "loss_rel_gaps": gaps,
           "loss_drop_rel_gap": drop_gap, "max_weight_diff": worst,
           "weight_bound": bound, "share_beyond_1e-2_lr": far}
    if not check:
        return res
    for step, (a, b) in enumerate(zip(lk, lp)):
        if not (np.isfinite(a) and abs(a - b) <= atol + rtol * abs(b)):
            raise AssertionError(f"{name} step {step}: loss {a} on the "
                                 f"kernels, {b} on the plain versions")
    if amp is not None and not (drop_k > 0 and drop_gap <= AMP_DROP_RTOL):
        raise AssertionError(f"{name}: the loss fell by {drop_k} on the "
                             f"kernels, {drop_p} on the plain versions")
    if worst > bound or far > far_limit:
        raise AssertionError(f"{name}: final weights differ beyond the Adam "
                             f"sign-flip bound, or too many beyond 1e-2*lr")
    return res


def _launch_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import optimizer as oo
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.ops import softmax_xent as sx

    return {"flash_fwd": fa.launches["fwd"], "flash_bwd_dkv": fa.launches["dkv"],
            "flash_bwd_dq": fa.launches["dq"], "adam": oo.launches,
            "layernorm": ln.launches["fwd"],
            "layernorm_bwd": ln.launches["bwd"],
            "layernorm_bwd_merge": ln.launches["bwd_merge"],
            "paged_attention": pa.launches["decode"],
            "paged_attention_prefill": pa.launches["prefill"],
            "xent_fwd": sx.launches["fwd"], "xent_bwd": sx.launches["bwd"]}


def _reset_launch_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import optimizer as oo
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.ops import softmax_xent as sx
    from mxnet_tpu_torch.contrib import quantization as q8

    for counts in (fa.launches, sx.launches, pa.launches, ln.launches):
        for key in counts:
            counts[key] = 0
    oo.launches = 0
    for key in q8.launches:
        q8.launches[key] = 0


# each launch counter (chip_smoke's names, by the wrapper's module and key)
# and the names of the kernels it counts, as the profiler sees them on the
# card (one name, or a tuple: the routes of one wrapper's launch)
COUNTERS = {("flash_attention", "fwd"): ("flash_fwd", "flash_fwd_tc_kernel"),
            ("flash_attention", "dkv"): ("flash_bwd_dkv",
                                         "flash_bwd_dkv_tc_kernel"),
            ("flash_attention", "dq"): ("flash_bwd_dq",
                                        "flash_bwd_dq_tc_kernel"),
            ("optimizer", None): ("adam", "adam_kernel"),
            ("layernorm", "fwd"): ("layernorm", "layernorm_fwd_"),
            ("layernorm", "bwd"): ("layernorm_bwd",
                                   ("layernorm_bwd_warp_kernel",
                                    "layernorm_bwd_block_kernel")),
            ("layernorm", "bwd_merge"): ("layernorm_bwd_merge",
                                         "layernorm_bwd_merge_kernel"),
            ("paged_attention", "decode"): ("paged_attention",
                                            "paged_attention_kernel"),
            ("paged_attention", "prefill"): ("paged_attention_prefill",
                                             "paged_prefill_tc_kernel"),
            ("softmax_xent", "fwd"): ("xent_fwd", "xent_fwd_kernel"),
            ("softmax_xent", "bwd"): ("xent_bwd", "xent_bwd_kernel")}


# profiled replays check_replay_launches may take. On the H100 (torch
# 2.11) a replay launched as the profiler's window opened came back
# without its first 1 to 20 port kernels (the forward's LayerNorms and
# flash launches; never a backward one), from one replay to the next: the
# replay now starts REPLAY_QUIET_S after the window opens and the window
# closes that long after it ends. A replay that really launched fewer
# kernels would miss them at every attempt.
REPLAY_ATTEMPTS = 3
REPLAY_QUIET_S = 0.2


def check_replay_launches(prog, what):
    """Replay the captured step graph ``prog`` under the profiler and
    count the port's kernels the card ran in one replay, by name: they must
    equal the launches that the graph adds to the wrapper counts at every
    replay (recorded when it was captured), in one of REPLAY_ATTEMPTS
    profiled replays (a trace can lose a record; it never adds one). So the
    counts of a "graph" run are what the card launched, not only what the
    capture saw. Returns the counts."""
    from torch.profiler import ProfilerActivity, profile

    recorded = {name: 0 for name, _ in COUNTERS.values()}
    for (mod, key), n in prog.launches.items():
        recorded[COUNTERS[(mod.split(".")[-1], key)][0]] += n
    misses = []
    for _ in range(REPLAY_ATTEMPTS):
        torch.cuda.synchronize()
        # a warm-up replay that the profiler discards (a trace's first
        # kernels can be lost while tracing starts), then the replay it
        # counts
        once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=once) as prof:
            for _ in range(2):
                time.sleep(REPLAY_QUIET_S)
                prog.graph.replay()
                torch.cuda.synchronize()
                time.sleep(REPLAY_QUIET_S)
                prof.step()
        seen = dict.fromkeys(recorded, 0)
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for name, kernels in COUNTERS.values():
                if any(k in evt.key for k in ((kernels,) if isinstance(
                        kernels, str) else kernels)):
                    seen[name] += evt.count
        if seen == recorded and any(seen.values()):
            break
        misses.append(seen)
    else:
        raise AssertionError(f"{what}: {REPLAY_ATTEMPTS} profiled replays "
                             f"ran the kernels {misses}, the graph records "
                             f"{recorded} launches")
    log(f"[replay] {what}: one replay under the profiler ran "
        f"{ {k: v for k, v in seen.items() if v} }, as recorded at capture"
        + (f" (earlier profiled replays traced {misses})" if misses else ""))
    return seen


# the engine types in the order the timed phases run them: naive, graph,
# graph, naive, so that drift over the call does not favour either
MODE_TURNS = ("naive", "graph", "graph", "naive")


def _release():
    """Free what dropped engines and TrainSteps held (the serving wrappers
    below make cycles) and hand the cached memory back."""
    gc.collect()
    torch.cuda.empty_cache()


def _state(ts, host=False):
    """Copies of every parameter, optimizer state tensor and master of the
    TrainStep ``ts``, its step count and its loss-scale carry, in a fixed
    order (what bit-identity between engine types, windows and resumed
    runs is checked on); in host memory with ``host``, for the full-width
    runs."""
    copy = (lambda t: t.detach().to("cpu", copy=True)) if host else \
        (lambda t: t.detach().clone())
    out = [copy(p) for _, p in ts._plist]
    for name in sorted(ts.opt_state):
        st = ts.opt_state[name]
        out.extend(copy(t) for t in
                   (st if isinstance(st, (tuple, list)) else (st,))
                   if t is not None)
    out.extend(copy(ts._master[n]) for n in sorted(ts._master))
    out.append(copy(ts.step_count))
    if ts.amp_state is not None:
        out.extend(copy(ts.amp_state[k]) for k in sorted(ts.amp_state))
    return out


def _same_state(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _train_net(amp):
    """gpt2_345m at full width (seed 0, dropout 0) and a copy of its
    initial weights, so that every timed run starts from the same place."""
    from mxnet_tpu_torch.models import get_gpt2

    t0 = time.perf_counter()
    net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0)
    init = [p.detach().clone() for _, p in sorted(net.named_parameters())]
    log(f"[{'train' if amp is None else 'train_amp'}] gpt2_345m "
        f"{amp or 'f32'}, {len(init)} parameters, "
        f"{sum(p.numel() for p in init)} elements, built in "
        f"{time.perf_counter() - t0:.1f}s")
    return net, init


def _train_step(net, amp, engine_type, layers=N_LAYERS):
    """chip_smoke's TrainStep of the ``train`` (amp None) or ``train_amp``
    path."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    if amp is None:
        return TrainStep(net, lm_loss, Adam(learning_rate=1e-4), amp=None,
                         engine_type=engine_type)
    return TrainStep(net, SoftmaxCrossEntropyLoss(),
                     Adam(learning_rate=AMP_LR, lr_scheduler=amp_schedule()),
                     amp=amp, engine_type=engine_type)


@contextlib.contextmanager
def _ln_dtypes():
    """Count the (x, gamma) dtype pairs of the LayerNorm forward and
    backward wrapper calls made inside, by direction (under a step graph
    only its eager first call and its capture call the wrappers)."""
    from mxnet_tpu_torch.ops import layernorm as ln

    pairs = collections.Counter()
    fwd, bwd = ln._forward, ln._backward

    def counted(direction, fn):
        def call(x, gamma, *args):
            pairs[(direction, x.dtype, gamma.dtype)] += 1
            return fn(x, gamma, *args)
        return call

    ln._forward, ln._backward = counted("fwd", fwd), counted("bwd", bwd)
    try:
        yield pairs
    finally:
        ln._forward, ln._backward = fwd, bwd


def _restore(net, init):
    with torch.no_grad():
        for (_, p), w in zip(sorted(net.named_parameters()), init):
            p.copy_(w)


def phase_train(net, init, engine_type, warmup=2, steps=10, batch=4,
                seq=1024, amp=None):
    """gpt2_345m at full width through TrainStep, modelbench's setting:
    B=4, T=1024, dropout 0, seed 0, one fixed batch, from the weights
    ``init``. With ``amp=None``: f32, ``lm_loss``, Adam(1e-4). With
    ``amp="bfloat16"`` (the ``train_amp`` path): bf16 copies of the f32
    masters, SoftmaxCrossEntropyLoss through the xent kernels, Adam on the
    warm-up schedule from AMP_LR. ``engine_type`` "graph" (the default of
    the port: one captured CUDA graph per step signature) or "naive" (the
    eager step). Every step must launch each flash kernel once per layer,
    Adam once, LayerNorm's forward, backward and merge 49 times each (on
    f32 tensors, or under amp on bf16 x and the bf16 copies of gamma and
    beta) and (bf16) each xent kernel once, under either engine type
    (``_timed_steps``)."""
    name = "train" if amp is None else "train_amp"
    _restore(net, init)
    ts = _train_step(net, amp, engine_type)
    xent = 0 if amp is None else 1
    want = {"flash_fwd": N_LAYERS, "flash_bwd_dkv": N_LAYERS,
            "flash_bwd_dq": N_LAYERS, "adam": 1, "layernorm": 2 * N_LAYERS + 1,
            "layernorm_bwd": 2 * N_LAYERS + 1,
            "layernorm_bwd_merge": 2 * N_LAYERS + 1,
            "paged_attention": 0, "paged_attention_prefill": 0,
            "xent_fwd": xent, "xent_bwd": xent}
    dt = torch.float32 if amp is None else torch.bfloat16
    total, res, state = _timed_steps(
        f"{name} {engine_type}", net, ts, _train_batch(batch, seq), want, dt,
        warmup, steps, batch, seq)
    res["amp"] = amp
    return total, res, state


def _timed_steps(name, net, ts, batch, want, dt, warmup, steps, samples,
                 seq, ln_pairs=None):
    """``warmup`` + ``steps`` calls of the TrainStep ``ts`` on one fixed
    ``batch``, the launch counts read around each call and held to
    ``want``; LayerNorm's wrappers must see (x, gamma) of dtype ``dt`` only
    (in these calls, or in ``ln_pairs``, what ``_ln_dtypes`` counted where
    the caller built ``ts``'s step graph); every loss finite and the last
    below the first; one step program. The timed steps (host clock, ending in a synchronize) give ms a step,
    samples/s and tokens/s (``samples`` sequences of ``seq`` tokens a step),
    with the peak memory of the run. After a "graph" run one replay is
    profiled (``check_replay_launches``). Returns the launches of the run,
    the metrics and the final weights and Adam moments (in host memory)."""
    total = dict.fromkeys(want, 0)
    losses = []
    torch.cuda.synchronize()
    _release()  # the peaks below start from what this run holds
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with _ln_dtypes() as seen:
        for i in range(warmup + steps):
            if i == warmup:
                torch.cuda.synchronize()
                t = time.perf_counter()
            before = _launch_counts()
            losses.append(ts(*batch))
            got = {k: v - before[k] for k, v in _launch_counts().items()}
            if got != want:
                raise AssertionError(f"{name} step {i}: launches {got}, "
                                     f"expected {want}")
            for k in total:
                total[k] += got[k]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    ln_pairs = seen if ln_pairs is None else ln_pairs
    if set(ln_pairs) != {("fwd", dt, dt), ("bwd", dt, dt)}:
        raise AssertionError(f"{name}: LayerNorm ran on (x, gamma) dtypes "
                             f"{dict(ln_pairs)}")
    log(f"[{name}] LayerNorm wrapper calls by (direction, x, gamma dtype): "
        f"{dict(ln_pairs)}")
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} losses {losses}: not finite and falling")
    programs = ts.compiled_programs
    if programs != 1:
        raise AssertionError(f"{name}: {programs} programs")
    res = {"engine_type": ts.engine_type, "ms_per_step": wall / steps * 1e3,
           "samples_per_s": samples * steps / wall,
           "tokens_per_s": samples * seq * steps / wall,
           "peak_bytes": peak,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "losses": losses, "steps": steps, "warmup": warmup}
    log(f"[{name}] losses {['%.4f' % x for x in losses]}")
    log(f"[{name}] {steps} timed steps: {res['ms_per_step']:.2f} ms/step, "
        f"{res['samples_per_s']:.1f} samples/s, {res['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {peak / 2**30:.2f} GiB (reserved "
        f"{res['peak_reserved_bytes'] / 2**30:.2f}); launches per step "
        f"{want}")
    state = _state(ts, host=True)
    if ts.engine_type == "graph":  # replays more: after the state was read
        (prog, _, _), = ts._programs.values()
        check_replay_launches(prog, f"{name} step graph")
    del ts
    _release()
    return total, res, state


def _turns(name, run):
    """``run(engine_type)`` under MODE_TURNS: every run's losses, final
    weights and Adam moments bit-identical to the first's. Returns the
    launches of the first "graph" run and the runs' metrics."""
    runs, ref, launches = [], None, None
    for mode in MODE_TURNS:
        total, res, state = run(mode)
        if ref is None:
            ref = (res["losses"], state)
        elif res["losses"] != ref[0] or not _same_state(state, ref[1]):
            raise AssertionError(f"{name}: the {mode} run's losses, weights "
                                 f"or moments differ from the first run's")
        if mode == "graph" and launches is None:
            launches = total
        runs.append(res)
        del state
    del ref
    _release()
    log(f"[{name}] {' '.join(MODE_TURNS)}: losses, weights and Adam moments "
        f"bit-identical across the runs; ms/step "
        f"{[round(r['ms_per_step'], 2) for r in runs]}")
    return launches, runs


def phase_train_turns(amp=None):
    """``phase_train`` under MODE_TURNS from one start (``_turns``).
    Returns the net, the launches of the first "graph" run and the runs'
    metrics."""
    name = "train" if amp is None else "train_amp"
    net, init = _train_net(amp)
    launches, runs = _turns(name, lambda mode: phase_train(net, init, mode,
                                                           amp=amp))
    del init
    _release()
    return net, launches, runs


# ---------------------------------------------------------------------------
# The imperative MXNet surface (mx.nd, autograd, Gluon, gluon.Trainer): the
# canonical loop record -> backward -> Trainer.step, eager (no CUDA graph)
GLUON_WANT = {"flash_fwd": N_LAYERS, "flash_bwd_dkv": N_LAYERS,
              "flash_bwd_dq": N_LAYERS, "adam": 1,
              "layernorm": 2 * N_LAYERS + 1,
              "layernorm_bwd": 2 * N_LAYERS + 1,
              "layernorm_bwd_merge": 2 * N_LAYERS + 1,
              "paged_attention": 0, "paged_attention_prefill": 0,
              "xent_fwd": 1, "xent_bwd": 1}


class _ScheduleBehind:
    """``schedule`` one update behind: the Trainer counts an update before
    it reads the rate (MXNet's and the JAX package's order), TrainStep
    after, so this gives the Trainer the rates TrainStep applies, the
    ones the AMP_* limits were measured at."""

    def __init__(self, schedule):
        self._schedule = schedule

    @property
    def base_lr(self):
        return self._schedule.base_lr

    @base_lr.setter
    def base_lr(self, value):
        self._schedule.base_lr = value

    def __call__(self, num_update):
        return self._schedule(num_update - 1)


def _gluon_step(mx, net, trainer, loss_fn, x, y):
    """One step of the loop; the loss's batch mean, taken in f32 as
    TrainStep takes it, as a 0-d tensor."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss._data.detach().float().mean()


def _gluon_net(mx, layers, seed, dtype=None):
    from mxnet_tpu_torch.models import get_gpt2

    net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=layers, seed=seed,
                   ctx=mx.gpu())
    net.initialize(ctx=mx.gpu())  # the JAX idiom: the weights are drawn
    if dtype is not None:
        net.cast(dtype)
    return net


def phase_gluon_parity():
    """(a) 3 imperative steps (``autograd.record``, ``loss.backward()``,
    ``Trainer.step``, Adam at TRAIN_LR, SoftmaxCrossEntropyLoss) of a
    2-layer gpt2_345m-width net in f32 against ``TrainStep(engine_type=
    "naive", amp=None)`` with the same loss and optimizer from the same
    weights, on phase_train_parity's batch (B=4, T=1024): losses, weights
    and Adam moments bit-identical. The Trainer backpropagates the
    per-sample losses with a head gradient of ones and divides by the
    batch in Adam's ``rescale_grad``, TrainStep backpropagates their mean:
    with B=4 the two differ by an exact power of two at every step of the
    backward, so every rounding is the same.
    (b) The bf16 ``multi_precision`` route at 2 layers: ``net.cast
    ("bfloat16")``, Adam with f32 masters at the warm-up schedule's rates
    that TrainStep applies (``_ScheduleBehind``), 3 steps
    on the kernels against the same on ``plain_versions()``, held at
    AMP_LOSS_RTOL / AMP_DROP_RTOL / AMP_FAR_SHARE (the masters within the
    sign-flip bound)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.optimizer import Adam

    ids, labels = _train_batch(4, 1024)
    x, y = mx.nd.array(ids), mx.nd.array(labels)
    what = "2 layers at gpt2_345m width, B=4 T=1024"
    # (a) f32, bit-identical to TrainStep naive
    tnet = _gluon_net(mx, 2, 1)
    ts = TrainStep(tnet, SoftmaxCrossEntropyLoss(),
                   Adam(learning_rate=TRAIN_LR), amp=None,
                   engine_type="naive")
    ts_losses = [float(ts(ids, labels)) for _ in range(TRAIN_STEPS)]
    inet = _gluon_net(mx, 2, 1)
    trainer = mx.gluon.Trainer(inet.collect_params(), "adam",
                               {"learning_rate": TRAIN_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    im_losses = [float(_gluon_step(mx, inet, trainer, loss_fn, x, y))
                 for _ in range(TRAIN_STEPS)]
    by_var = {id(p.tensor()): st for p, st in zip(trainer._params,
                                                trainer._states)}
    diff = []
    for (name, a), (_, b) in zip(sorted(inet.named_parameters()),
                                 sorted(tnet.named_parameters())):
        mine, theirs = by_var[id(a)], ts.opt_state[name]
        for what_, u, v in (("weight", a, b), ("mean", mine[0], theirs[0]),
                            ("var", mine[1], theirs[1])):
            if not torch.equal(u, v):
                diff.append(f"{name} {what_} max |diff| "
                            f"{(u - v).abs().max().item():.3e}")
    log(f"[gluon f32] {what}, {TRAIN_STEPS} steps at lr {TRAIN_LR}: losses "
        f"record/backward/Trainer.step {im_losses} / TrainStep naive "
        f"{ts_losses}; weights and Adam moments that differ: "
        f"{diff[:5] or 'none'}")
    if im_losses != ts_losses or diff:
        raise AssertionError(f"gluon f32: the imperative steps are not "
                             f"bit-identical to TrainStep naive: losses "
                             f"{im_losses} / {ts_losses}, {diff[:3]}")
    del tnet, ts, inet, trainer, by_var
    _release()
    # (b) bf16 weights, f32 masters in the optimizer: kernels vs plain
    runs = []
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            net = _gluon_net(mx, 2, 1, "bfloat16")
            trainer = mx.gluon.Trainer(
                net.collect_params(), "adam",
                {"learning_rate": AMP_LR,
                 "lr_scheduler": _ScheduleBehind(amp_schedule()),
                 "multi_precision": True})
            rates, losses = [], []
            for _ in range(TRAIN_STEPS):
                losses.append(float(_gluon_step(mx, net, trainer,
                                                loss_fn, x, y)))
                rates.append(trainer.learning_rate)  # the rate applied
            names = {id(p): n for n, p in
                     net._collect_params_with_prefix().items()}
            masters = {names[id(p)]: st["master"].clone()
                       for p, st in zip(trainer._params, trainer._states)}
            low = [p for p in net.parameters() if p.dtype != torch.bfloat16]
            if low or any(m.dtype != torch.float32 for m in masters.values()):
                raise AssertionError("gluon bf16: weights left bf16 or "
                                     "masters left f32")
            for p, st in zip(trainer._params, trainer._states):
                if not torch.equal(p.tensor().detach(), st["master"].bfloat16()):
                    raise AssertionError(f"gluon bf16: {p.name} is not its "
                                         f"master rounded")
        runs.append((losses, masters))
        del net, trainer
        _release()
    (lk, mk), (lp, mp) = runs
    gaps = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    drop_k, drop_p = lk[0] - lk[-1], lp[0] - lp[-1]
    drop_gap = abs(drop_k - drop_p) / abs(drop_p)
    err = torch.cat([(mk[n] - mp[n]).abs().reshape(-1) for n in mk])
    worst = err.max().item()
    far = (err > 1e-2 * AMP_LR).float().mean().item()
    bound = 2.01 * sum(rates)
    log(f"[gluon bf16] {what}, multi_precision Adam at lr {rates}: losses "
        f"kernels {lk} / plain {lp}, relative gaps {gaps} (limit "
        f"{AMP_LOSS_RTOL}); loss falls {drop_k:.6f} / {drop_p:.6f}, "
        f"relative gap {drop_gap:.3e} (limit {AMP_DROP_RTOL}); max |master "
        f"diff| {worst:.3e} (bound {bound:.3e}), share beyond 1e-2*lr "
        f"{far:.2e} (limit {AMP_FAR_SHARE})")
    for step, (a, b) in enumerate(zip(lk, lp)):
        if not (np.isfinite(a) and abs(a - b) <= AMP_LOSS_RTOL * abs(b)):
            raise AssertionError(f"gluon bf16 step {step}: loss {a} on the "
                                 f"kernels, {b} on the plain versions")
    if not (drop_k > 0 and drop_gap <= AMP_DROP_RTOL):
        raise AssertionError(f"gluon bf16: the loss fell by {drop_k} on the "
                             f"kernels, {drop_p} on the plain versions")
    if worst > bound or far > AMP_FAR_SHARE:
        raise AssertionError("gluon bf16: masters differ beyond the Adam "
                             "sign-flip bound, or too many beyond 1e-2*lr")
    return {"f32": {"losses": im_losses, "trainstep_losses": ts_losses,
                    "bit_identical": True},
            "bf16": {"losses_kernels": lk, "losses_plain": lp,
                     "loss_rel_gaps": gaps, "loss_drop_rel_gap": drop_gap,
                     "max_master_diff": worst, "master_bound": bound,
                     "share_beyond_1e-2_lr": far}}


def phase_gluon(warmup=2, steps=10, batch=4, seq=1024):
    """(c) gpt2_345m at full width through the imperative loop, as a user
    writes it: ``get_gpt2("gpt2_345m", dropout=0.0)``, ``initialize``,
    ``cast("bfloat16")``, ``gluon.Trainer(..., "adam", {"learning_rate":
    1e-4, "multi_precision": True})``, SoftmaxCrossEntropyLoss, then
    ``record`` / ``backward`` / ``step`` on one fixed batch (B=4, T=1024),
    ``warmup`` + ``steps`` steps, eager. The launch counts are read around
    each step and held to GLUON_WANT (what a ``train_amp`` step launches:
    24 flash forwards, dK/dV and dQ, 49 LayerNorm forwards, backwards and
    merges on bf16 x and gamma, 1 xent forward and backward, 1 Adam over
    the 292 unique tensors); every loss finite. Prints ms a step, tokens/s
    and the peak memory. (d) ``save_parameters`` of the trained net, then
    ``load_parameters`` into a fresh ``get_gpt2`` on the card (taking the
    file's bf16): bitwise-equal logits on the batch. Returns the launches
    of the run and the metrics."""
    import tempfile

    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    net = _gluon_net(mx, N_LAYERS, 0, "bfloat16")
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4,
                                                "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids, labels = _train_batch(batch, seq)
    x, y = mx.nd.array(ids), mx.nd.array(labels)
    log(f"[gluon] gpt2_345m bf16 with f32 masters, {len(params)} unique "
        f"parameters ({len(list(net.parameters()))} torch parameters), "
        f"built in {time.perf_counter() - t0:.1f}s")
    if len(params) != 4 + 12 * N_LAYERS:  # 292: the tied head counts once
        raise AssertionError(f"gluon: {len(params)} unique parameters")
    total = dict.fromkeys(GLUON_WANT, 0)
    losses = []
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with _ln_dtypes() as ln_pairs:
        for i in range(warmup + steps):
            if i == warmup:
                torch.cuda.synchronize()
                t = time.perf_counter()
            before = _launch_counts()
            losses.append(_gluon_step(mx, net, trainer, loss_fn, x, y))
            got = {k: v - before[k] for k, v in _launch_counts().items()}
            if got != GLUON_WANT:
                raise AssertionError(f"gluon step {i}: launches {got}, "
                                     f"expected {GLUON_WANT}")
            for k in total:
                total[k] += got[k]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    bf = torch.bfloat16
    if set(ln_pairs) != {("fwd", bf, bf), ("bwd", bf, bf)}:
        raise AssertionError(f"gluon: LayerNorm ran on (x, gamma) dtypes "
                             f"{dict(ln_pairs)}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"gluon losses {losses}: not finite")
    res = {"ms_per_step": wall / steps * 1e3,
           "samples_per_s": batch * steps / wall,
           "tokens_per_s": batch * seq * steps / wall,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "losses": losses, "steps": steps, "warmup": warmup}
    log(f"[gluon] losses {['%.4f' % v for v in losses]}")
    log(f"[gluon] {steps} timed steps (eager): {res['ms_per_step']:.2f} "
        f"ms/step, {res['samples_per_s']:.1f} samples/s, "
        f"{res['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{res['peak_bytes'] / 2**30:.2f} GiB (reserved "
        f"{res['peak_reserved_bytes'] / 2**30:.2f}); launches per step "
        f"{GLUON_WANT}")
    # (d) the .params round trip
    with torch.no_grad(), tempfile.TemporaryDirectory(
            prefix="chip_smoke_gluon_") as d:
        path = str(Path(d) / "gpt2_345m.params")
        net.save_parameters(path)
        del trainer, params
        _release()
        fresh = _gluon_net(mx, N_LAYERS, 7)
        fresh.load_parameters(path, cast_dtype=True, dtype_source="saved")
    with torch.no_grad():
        want = net(ids)
        got = fresh(ids)
    same = torch.equal(got, want) and got.dtype == torch.bfloat16
    log(f"[gluon] .params round trip of the trained net into a fresh "
        f"get_gpt2: logits {tuple(got.shape)} {got.dtype} "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("gluon: logits after the .params round trip "
                             "differ")
    res["params_round_trip_bitwise"] = True
    del net, fresh, want, got
    _release()
    return total, res


# ---------------------------------------------------------------------------
# The training loop: TrainStep.run (window steps in one captured CUDA graph,
# accum microbatches a step), fed by io.DevicePrefetcher; save/restore,
# float16 across windows, Trainer.run over a DataLoader, preemption
LOOP_WINDOW = 8
# what one step launches under float16: LayerNorm, attention and the loss
# take their compositions on f16 (the JAX gates send f16 there), Adam its
# kernel with f16 gradients and copies
F16_WANT = dict.fromkeys(GLUON_WANT, 0) | {"adam": 1}


def _host_batches(n, batch, seq, seed, vocab=50257):
    """``n`` host batches of modelbench's form (seeded random ids, labels
    the ids rolled by one), as a DataLoader yields them."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, 1)))
    return out


def _times(counts, k):
    return {name: n * k for name, n in counts.items()}


def _window_program(ts):
    (prog, _, _), = (e for key, e in ts._programs.items()
                     if key[0] == "window")
    return prog


def _parity_runs(net, init, amp, mode, batches, micro):
    """8 calls, run(steps=8, window=4) and run(steps=4, window=2,
    accum=2) of fresh TrainSteps from ``init``: losses and states."""
    out = {}
    for what in ("calls", "window", "accum"):
        _restore(net, init)
        ts = _train_step(net, amp, mode)
        if what == "calls":
            losses = torch.stack([ts(*b) for b in batches])
        elif what == "window":
            losses = ts.run(iter(batches), steps=8, window=4)
            if ts.compiled_programs != 1 or ts._window_dispatches != 2:
                raise AssertionError(f"train_loop parity: {mode} window run "
                                     f"held {ts.compiled_programs} programs, "
                                     f"{ts._window_dispatches} dispatches")
        else:
            losses = ts.run(iter(micro), steps=4, window=2, accum=2)
        out[what] = (losses, _state(ts))
        del ts
        _release()
    return out


def phase_loop_parity():
    """(a) 2 layers at gpt2_345m width, B=4, T=1024, in f32 (``lm_loss``,
    Adam 1e-4) and under amp="bfloat16" (``train_amp``'s loss and
    schedule): ``run(steps=8, window=4)`` bit-identical to 8 calls, each
    under "graph" and "naive" (losses, weights, moments, masters, step
    count); "graph" bit-identical to "naive" for both and for
    ``run(steps=4, window=2, accum=2)`` at microbatch B=2. Then, at
    dropout 0.1 under bf16 "graph", whether the window and the calls draw
    the same masks (reported, not held: the port's recorded divergence
    if they do not)."""
    from mxnet_tpu_torch.models import get_gpt2

    batches = _host_batches(8, 4, 1024, seed=3)
    micro = _host_batches(8, 2, 1024, seed=4)
    res = {}
    for amp in (None, "bfloat16"):
        net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2, device="cuda",
                       seed=1)
        init = [p.detach().clone() for _, p in sorted(net.named_parameters())]
        runs = {mode: _parity_runs(net, init, amp, mode, batches, micro)
                for mode in ("graph", "naive")}
        name = f"train_loop parity {amp or 'f32'}"
        for mode, r in runs.items():
            (lc, sc), (lw, sw) = r["calls"], r["window"]
            if not torch.equal(lc, lw) or not _same_state(sc, sw):
                raise AssertionError(f"{name}: the {mode} window differs from "
                                     f"8 calls: losses {lc.tolist()} / "
                                     f"{lw.tolist()}")
        for what in ("calls", "window", "accum"):
            (lg, sg), (ln, sn) = runs["graph"][what], runs["naive"][what]
            if not torch.equal(lg, ln) or not _same_state(sg, sn):
                raise AssertionError(f"{name}: {what} graph differs from "
                                     f"naive: {lg.tolist()} / {ln.tolist()}")
        acc = runs["graph"]["accum"][0]
        if not torch.isfinite(acc).all():
            raise AssertionError(f"{name}: accum losses {acc.tolist()}")
        res[amp or "f32"] = {
            "losses": runs["graph"]["window"][0].tolist(),
            "accum_losses": acc.tolist(), "bit_identical": True}
        log(f"[{name}] 2 layers at gpt2_345m width, B=4 T=1024: run(steps=8,"
            f" window=4) == 8 calls under graph and naive, graph == naive "
            f"also for accum=2 (B=2 microbatches), bit for bit (losses, "
            f"weights, moments, masters, step count); losses "
            f"{['%.4f' % x for x in res[amp or 'f32']['losses']]}, accum "
            f"{['%.4f' % x for x in acc.tolist()]}")
        del runs
        _release()
    # dropout 0.1 on the bf16 net: the masks of a window against those of
    # 4 calls
    from mxnet_tpu_torch.gluon.nn import Dropout

    for m in net.modules():
        if isinstance(m, Dropout):
            m._rate = 0.1
    drawn = []
    for window in (None, 4):
        _restore(net, init)
        ts = _train_step(net, "bfloat16", "graph")
        torch.manual_seed(7)
        drawn.append(torch.stack([ts(*b) for b in batches[:4]])
                     if window is None
                     else ts.run(iter(batches[:4]), steps=4, window=window))
        del ts
    same = torch.equal(*drawn)
    res["dropout_0.1_window_equals_calls"] = same
    log(f"[train_loop parity dropout 0.1] bf16 graph: the window's losses "
        f"{'equal' if same else 'DIFFER from'} those of 4 calls "
        f"({['%.4f' % x for x in drawn[0].tolist()]} / "
        f"{['%.4f' % x for x in drawn[1].tolist()]}); not held")
    del net, init, drawn
    _release()
    return res


def _timed_run(ts, pf, steps):
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = ts.run(pf, steps=steps)
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t


def _check_counts(name, got, want):
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")


def phase_loop_window(card):
    """(b) gpt2_345m at full width, ``TrainStep(amp="bfloat16")`` with
    ``train_amp``'s loss and schedule, fed by a ``DevicePrefetcher`` of
    host batches (B=4, T=1024) in windows of LOOP_WINDOW: a warm-up run of
    two windows (the first eager, the second captured and replayed), then
    two timed windows (replays); the launch counters must read
    LOOP_WINDOW × a ``train_amp`` step's launches a window, one window
    program is held, and one profiled replay of the window graph must run
    LOOP_WINDOW × a step's kernels (``check_replay_launches``). (d) Then
    ``save`` (after window 4), window 5, and a fresh TrainStep
    ``restore``d from the checkpoint runs window 5 again (eagerly): its
    losses and state bit-identical to the uninterrupted run's. Returns the
    net, its initial weights, the launches of windows 1-4 (the
    ``train_loop`` path) and the metrics."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.io.prefetch import DevicePrefetcher

    w = LOOP_WINDOW
    net, init = _train_net("bfloat16")
    batches = _host_batches(5 * w, 4, 1024, seed=5)
    ts = _train_step(net, "bfloat16", "graph")
    pf = DevicePrefetcher(iter(batches), train_step=ts, window=w)
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    l1, eager_s = _timed_run(ts, pf, w)
    l2, capture_s = _timed_run(ts, pf, w)
    l34, wall = _timed_run(ts, pf, 2 * w)
    launches = _launch_counts()
    _check_counts("train_loop window", launches, _times(GLUON_WANT, 4 * w))
    losses = torch.cat([l1, l2, l34]).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_loop window losses {losses}")
    if ts.compiled_programs != 1 or ts._window_dispatches != 4:
        raise AssertionError(f"train_loop window: {ts.compiled_programs} "
                             f"programs, {ts._window_dispatches} dispatches")
    steps = 2 * w
    res = {"window": w, "ms_per_step": wall / steps * 1e3,
           "tokens_per_s": 4 * 1024 * steps / wall,
           "samples_per_s": 4 * steps / wall,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "eager_window_s": eager_s,
           "capture_and_replay_s": capture_s,
           "replay_window_s": wall / 2,
           "compiled_programs": ts.compiled_programs, "losses": losses}
    log(f"[train_loop] gpt2_345m bf16, windows of {w} through a "
        f"DevicePrefetcher: {res['ms_per_step']:.2f} ms/step, "
        f"{res['tokens_per_s']:.0f} tokens/s over {steps} replayed steps; "
        f"first window (eager) {eager_s:.2f} s, second (capture + replay) "
        f"{capture_s:.2f} s, a replayed window {wall / 2:.3f} s; peak memory "
        f"{res['peak_bytes'] / 2**30:.2f} GiB (reserved "
        f"{res['peak_reserved_bytes'] / 2**30:.2f}); "
        f"{ts.compiled_programs} program; launches a window "
        f"{_times(GLUON_WANT, w)}")
    log(f"[train_loop] losses {['%.4f' % x for x in losses]}")
    # (d) save after window 4, window 5, then a fresh TrainStep restored
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t = time.perf_counter()
        path = ts.save(d)
        save_s = time.perf_counter() - t
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        l5, _ = _timed_run(ts, pf, w)
        want5 = _state(ts, host=True)
        pf.close()
        prog = _window_program(ts)
        want = _times({k: v for k, v in GLUON_WANT.items() if v},
                      w)
        recorded = {COUNTERS[(m.split(".")[-1], k)][0]: n
                    for (m, k), n in prog.launches.items()}
        if recorded != want:
            raise AssertionError(f"train_loop window graph records "
                                 f"{recorded}, expected {want}")
        check_replay_launches(prog, "train_loop window graph")
        del ts, pf, prog
        _release()
        ts2 = _train_step(net, "bfloat16", "graph")
        t = time.perf_counter()
        if not ts2.restore(d):
            raise AssertionError("train_loop: no checkpoint to restore")
        restore_s = time.perf_counter() - t
        pf2 = DevicePrefetcher(iter(batches[4 * w:]), train_step=ts2,
                               window=w)
        l5b, _ = _timed_run(ts2, pf2, w)
        pf2.close()
        same = torch.equal(l5, l5b) and \
            _same_state(want5, _state(ts2, host=True))
        if not same or ts2.optimizer.num_update != 5 * w:
            raise AssertionError(f"train_loop: the restored run's window 5 "
                                 f"differs: {l5.tolist()} / {l5b.tolist()}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["checkpoint"] = {"bytes": nbytes, "save_s": save_s,
                         "restore_and_verify_s": restore_s,
                         "resumed_bit_identical": True}
    log(f"[train_loop] checkpoint after window 4: {nbytes / 1e9:.3f} GB "
        f"saved in {save_s:.2f} s, restored and verified in {restore_s:.2f} "
        f"s; window 5 of the restored TrainStep bit-identical to the "
        f"uninterrupted run (losses, weights, moments, step count)")
    del ts2, pf2, want5
    _release()
    return net, init, launches, res


def phase_loop_accum(net, init):
    """(c) ``run(window=LOOP_WINDOW, accum=2)`` at microbatch B=2 through a
    DevicePrefetcher, bf16: two warm-up windows and one timed; a step
    launches twice the forward and backward kernels and Adam once."""
    from mxnet_tpu_torch.io.prefetch import DevicePrefetcher

    w = LOOP_WINDOW
    _restore(net, init)
    ts = _train_step(net, "bfloat16", "graph")
    micro = _host_batches(3 * w * 2, 2, 1024, seed=6)
    pf = DevicePrefetcher(iter(micro), train_step=ts, window=w, accum=2)
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    warm = torch.cat([ts.run(pf, steps=w), ts.run(pf, steps=w)])
    timed, wall = _timed_run(ts, pf, w)
    per_step = {k: 2 * v for k, v in GLUON_WANT.items()} | \
        {"adam": GLUON_WANT["adam"]}
    _check_counts("train_loop accum", _launch_counts(),
                  _times(per_step, 3 * w))
    losses = torch.cat([warm, timed]).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_loop accum losses {losses}")
    check_replay_launches(_window_program(ts), "train_loop accum graph")
    pf.close()
    res = {"window": w, "accum": 2, "micro_batch": 2,
           "ms_per_step": wall / w * 1e3,
           "tokens_per_s": 4 * 1024 * w / wall,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "losses": losses}
    log(f"[train_loop accum] gpt2_345m bf16, accum=2 at B=2: "
        f"{res['ms_per_step']:.2f} ms/step, {res['tokens_per_s']:.0f} "
        f"tokens/s; peak memory {res['peak_bytes'] / 2**30:.2f} GiB "
        f"(reserved {res['peak_reserved_bytes'] / 2**30:.2f}); launches a "
        f"step {per_step}")
    del ts, pf
    _release()
    return res


def phase_loop_float16(net, init):
    """(e) The first full-width ``amp="float16"`` run: ``train_amp``'s loss
    and schedule under the float16 policy (dynamic loss scale on the card
    from 2^16), 3 windows of LOOP_WINDOW (the third timed). Every applied
    step's loss is finite, and the step count is the steps run less those
    skipped. The checkpoint carry is :func:`phase_loop_float16_resume`'s."""
    from mxnet_tpu_torch.io.prefetch import DevicePrefetcher

    w = LOOP_WINDOW
    _restore(net, init)
    batches = _host_batches(3 * w, 4, 1024, seed=7)
    ts = _train_step(net, "float16", "graph")
    pf = DevicePrefetcher(iter(batches), train_step=ts, window=w)
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    l12, _ = _timed_run(ts, pf, 2 * w)
    l3, wall = _timed_run(ts, pf, w)
    pf.close()
    _check_counts("train_loop float16", _launch_counts(),
                  _times(F16_WANT, 3 * w))
    skipped = ts.amp_skipped_steps
    scale = ts.loss_scale
    applied = int(ts.step_count)
    if applied != 3 * w - skipped:
        raise AssertionError(f"train_loop float16: step count {applied}, "
                             f"{3 * w} steps less {skipped} skipped")
    losses = torch.cat([l12, l3]).tolist()
    # a skipped step's loss may overflow; every applied one is finite
    finite = sum(np.isfinite(losses))
    if finite < 3 * w - skipped:
        raise AssertionError(f"train_loop float16: {finite} finite losses "
                             f"for {3 * w - skipped} applied steps: {losses}")
    res = {"ms_per_step": wall / w * 1e3,
           "tokens_per_s": 4 * 1024 * w / wall,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "loss_scale": scale, "amp_skipped_steps": skipped,
           "step_count": applied, "losses": losses}
    log(f"[train_loop float16] gpt2_345m, amp float16, 3 windows of {w}: "
        f"{res['ms_per_step']:.2f} ms/step, {res['tokens_per_s']:.0f} "
        f"tokens/s (third window); loss scale {scale}, skipped {skipped}, "
        f"step count {applied}; peak memory "
        f"{res['peak_bytes'] / 2**30:.2f} GiB (reserved "
        f"{res['peak_reserved_bytes'] / 2**30:.2f}); losses "
        f"{['%.3f' % x for x in losses]}")
    del ts, pf
    _release()
    return res


def phase_loop_float16_resume():
    """(e) The float16 carry through a checkpoint, at 2 layers and
    gpt2_345m width: the dynamic scale starts at 2^20, so that window 1
    may hold overflowed steps; a checkpoint after window 1 carries the
    scale, the good-step run and the skip count, and a fresh TrainStep
    restored from it runs window 2 bit-identically (losses, weights,
    moments, step count, carry)."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.contrib.amp import Policy
    from mxnet_tpu_torch.io.prefetch import DevicePrefetcher
    from mxnet_tpu_torch.models import get_gpt2

    w = LOOP_WINDOW
    net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2, device="cuda",
                   seed=3)
    pol = Policy("float16", loss_scale=2.0 ** 20)
    batches = _host_batches(2 * w, 4, 1024, seed=7)
    ts = _train_step(net, pol, "graph")
    d = tempfile.mkdtemp(prefix="chip_smoke_f16_")
    try:
        pf = DevicePrefetcher(iter(batches), train_step=ts, window=w)
        l1 = ts.run(pf, steps=w)
        ts.save(d)
        scale1, skipped1 = ts.loss_scale, ts.amp_skipped_steps
        l2 = ts.run(pf, steps=w)
        pf.close()
        want2 = _state(ts)
        ts2 = _train_step(net, pol, "graph")
        if not ts2.restore(d):
            raise AssertionError("train_loop float16: no checkpoint")
        if (ts2.loss_scale, ts2.amp_skipped_steps) != (scale1, skipped1):
            raise AssertionError("train_loop float16: the restore lost the "
                                 "loss-scale carry")
        pf2 = DevicePrefetcher(iter(batches[w:]), train_step=ts2, window=w)
        l2b = ts2.run(pf2, steps=w)
        pf2.close()
        if not torch.equal(l2, l2b) or not _same_state(want2, _state(ts2)):
            raise AssertionError(f"train_loop float16: window 2 after the "
                                 f"restore differs: {l2.tolist()} / "
                                 f"{l2b.tolist()}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res = {"after_window_1": {"loss_scale": scale1,
                              "amp_skipped_steps": skipped1},
           "after_window_2": {"loss_scale": ts.loss_scale,
                              "amp_skipped_steps": ts.amp_skipped_steps},
           "losses": torch.cat([l1, l2]).tolist(),
           "resumed_bit_identical": True}
    log(f"[train_loop float16 resume] 2 layers at gpt2_345m width, scale "
        f"from 2^20: after window 1 scale {scale1}, skipped {skipped1}; "
        f"window 2 after a restore from window 1's checkpoint bit-identical "
        f"(scale {ts.loss_scale}, skipped {ts.amp_skipped_steps})")
    del net, ts, ts2, pf, pf2, want2
    _release()
    return res


def phase_loop_trainer():
    """(f) ``gluon.Trainer.run`` on the ``gluon`` phase's net (gpt2_345m,
    ``cast("bfloat16")``, Adam 1e-4 with ``multi_precision``), fed by
    ``DataLoader.prefetch_to_device`` over an ``ArrayDataset`` of host
    batches (B=4, T=1024): two warm-up windows and one timed; each step
    launches what a ``train_amp`` step does. Then one imperative
    ``record``/``backward``/``Trainer.step``: its optimizer states are the
    step's tensors ``run`` left (master and moments), and it updates
    them."""
    import mxnet_tpu_torch as mx

    w = LOOP_WINDOW
    net = _gluon_net(mx, N_LAYERS, 0, "bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4,
                                "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    host = _host_batches(3 * w, 4, 1024, seed=8)
    ids = np.concatenate([b[0] for b in host])
    labels = np.concatenate([b[1] for b in host])
    loader = mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(ids, labels), batch_size=4)
    pf = loader.prefetch_to_device(window=w)
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    warm = torch.cat([trainer.run(net, loss_fn, pf, steps=w)
                      for _ in range(2)])
    torch.cuda.synchronize()
    t = time.perf_counter()
    timed = trainer.run(net, loss_fn, pf, steps=w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    pf.close()
    _check_counts("train_loop Trainer.run", _launch_counts(),
                  _times(GLUON_WANT, 3 * w))
    losses = torch.cat([warm, timed]).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_loop Trainer.run losses {losses}")
    ts = trainer._fused[1]
    if ts.compiled_programs != 1:
        raise AssertionError(f"Trainer.run: {ts.compiled_programs} programs")
    res = {"ms_per_step": wall / w * 1e3, "tokens_per_s": 4 * 1024 * w / wall,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "losses": losses}
    # one imperative step after the run: it takes the states run left
    by_var = {id(p): name for _, name, p in ts._train}
    for p, st in zip(trainer._params, trainer._states):
        name = by_var[id(p.tensor())]
        if st["master"] is not ts._master[name] or \
                st["base"] is not ts.opt_state[name]:
            raise AssertionError(f"Trainer.run: {p.name}'s state is not the "
                                 f"step's")
    before = [st["base"][0].clone() for st in trainer._states[:4]]
    x, y = mx.nd.array(host[0][0]), mx.nd.array(host[0][1])
    _reset_launch_counts()
    loss = float(_gluon_step(mx, net, trainer, loss_fn, x, y))
    _check_counts("train_loop imperative step", _launch_counts(), GLUON_WANT)
    moved = [not torch.equal(b, st["base"][0])
             for b, st in zip(before, trainer._states)]
    counts = set(trainer.optimizer._index_update_count.values())
    if not (np.isfinite(loss) and all(moved) and counts == {3 * w + 1}):
        raise AssertionError(f"train_loop: the step after Trainer.run: loss "
                             f"{loss}, moments moved {moved}, update counts "
                             f"{counts}")
    res["step_after_run"] = {"loss": loss, "update_count": 3 * w + 1}
    log(f"[train_loop Trainer.run] gpt2_345m bf16 with f32 masters over a "
        f"DataLoader: {res['ms_per_step']:.2f} ms/step, "
        f"{res['tokens_per_s']:.0f} tokens/s (a replayed window); peak "
        f"memory {res['peak_bytes'] / 2**30:.2f} GiB (reserved "
        f"{res['peak_reserved_bytes'] / 2**30:.2f}); then one Trainer.step "
        f"on the states run left, loss {loss:.4f}")
    del net, trainer, ts, pf, loader
    _release()
    return res


def phase_loop_preemption():
    """(g) ``install_preemption`` on a 2-layer gpt2_345m-width TrainStep
    (bf16): the source requests a preemption while window 1 is fed; the
    window completes, one checkpoint lands at its boundary (valid, step
    LOOP_WINDOW), ``Preempted`` is raised, and the checkpoint restores."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.checkpoint import validate_checkpoint
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.resilience.integrity import list_checkpoints
    from mxnet_tpu_torch.resilience import Preempted, PreemptionGuard

    w = LOOP_WINDOW
    net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2, device="cuda",
                   seed=2)
    ts = _train_step(net, "bfloat16", "graph")
    d = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    guard = ts.install_preemption(d, guard=PreemptionGuard(signals=()))
    batches = _host_batches(2 * w, 4, 1024, seed=9)

    def source():
        for i, b in enumerate(batches):
            if i == 3:
                guard.request()
            yield b

    try:
        try:
            ts.run(source(), steps=2 * w, window=w)
        except Preempted as e:
            code = e.code
        else:
            raise AssertionError("train_loop preemption: no Preempted")
        ckpts = [s for s, p in list_checkpoints(d) if validate_checkpoint(p)]
        if code != 0 or ckpts != [w] or ts._window_dispatches != 1:
            raise AssertionError(f"train_loop preemption: exit code {code}, "
                                 f"valid checkpoints {ckpts}, "
                                 f"{ts._window_dispatches} windows")
        fresh = _train_step(net, "bfloat16", "graph")
        if not fresh.restore(d) or fresh.optimizer.num_update != w:
            raise AssertionError("train_loop preemption: the checkpoint "
                                 "does not restore")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"[train_loop preemption] a request during window 1: one valid "
        f"checkpoint (step {w}) at the window boundary, Preempted (code 0) "
        f"raised, the checkpoint restores")
    del net, ts, fresh
    _release()
    return {"checkpoints": ckpts, "preempted": True}


def phase_train_loop(card):
    """(a)-(g) of the training loop; returns the launches of the main path
    (``phase_loop_window``'s windows 1-4) and the metrics, with the seconds
    of each part."""
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    parity = timed("parity", phase_loop_parity)
    net, init, launches, window = timed("window_and_checkpoint",
                                        phase_loop_window, card)
    accum = timed("accum", phase_loop_accum, net, init)
    f16 = timed("float16", phase_loop_float16, net, init)
    del net, init
    _release()
    f16["resume"] = timed("float16_resume", phase_loop_float16_resume)
    trainer = timed("trainer_run", phase_loop_trainer)
    preempt = timed("preemption", phase_loop_preemption)
    res = {"parity": parity, "window": window, "accum": accum,
           "float16": f16, "trainer_run": trainer, "preemption": preempt,
           "seconds": seconds}
    log(f"[train_loop seconds] {sum(seconds.values()):.1f} s: " +
        ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    log("[train_loop] " + json.dumps(res))
    return launches, res


# ---------------------------------------------------------------------------
# The vision path: resnet50_v1 at full width (224x224, 1000 classes) through
# TrainStep as examples/train_imagenet_resnet.py:67-77 trains it, and LeNet
# through record / backward / gluon.Trainer("adam")
RESNET_TURNS = (("float32", 64), ("bfloat16", 128))
RESNET_LR = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
# what a ResNet step launches of the port's kernels: the xent pair only
# (convolution, pooling and BatchNorm are cuDNN and plain compositions, as
# the JAX package leaves them to XLA)
VISION_WANT = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
               "adam": 0, "layernorm": 0, "layernorm_bwd": 0,
               "layernorm_bwd_merge": 0, "paged_attention": 0,
               "paged_attention_prefill": 0, "xent_fwd": 1, "xent_bwd": 1}
# an f32 convolution against f64 on the card, as a share of the largest
# |f64| value: one TF32 pass (operands rounded to 10 mantissa bits) errs by
# ~2.6e-4 to 3.4e-4 here; the forward and the input gradient (sums of 576
# or 256 products) by ~1e-6 in f32, the weight gradient (sums of 50176 or
# 12544, cuDNN's deterministic FFT algorithm at the 3x3 shape) by 3.6e-5
# (measured on an H100)
CONV_F64_RTOL = {"forward": 2e-5, "input gradient": 2e-5,
                 "weight gradient": 1e-4}
LENET_B, LENET_STEPS, LENET_LR = 64, 20, 2e-3
# a LeNet step: the xent pair and one Adam launch over its 10 tensors
LENET_WANT = dict(VISION_WANT, adam=1)


def _tf32(t):
    """``t`` (f64) rounded to TF32 as the tensor cores read an f32 operand
    (mantissa cut to 10 bits, to nearest)."""
    f = t.float().contiguous().view(torch.int32)
    f = (f + 0x1000) & ~0x1FFF
    return f.view(torch.float32).double()


def _conv_f64(conv, x, w, g):
    """``conv(x, w)`` and its input and weight gradients for the cotangent
    ``g``, all in f64."""
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = conv(x, w)
    dx, dw = torch.autograd.grad(out, (x, w), g)
    return out.detach(), dx, dw


def phase_conv_precision():
    """The port's f32 convolution (forward, input and weight gradients) at
    two ResNet-50 shapes against the same in f64 on the card, with
    ``torch.backends.cudnn.allow_tf32`` True (PyTorch's default) around the
    call: each error within CONV_F64_RTOL of the largest |f64| value, a
    limit that one TF32 pass (the operands rounded to TF32, then f64) must
    fail. cuDNN's own TF32 error at the same call is printed beside it.
    Every case is measured and printed before any failure is raised."""
    from mxnet_tpu_torch.ops import nn as tnn

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(21)
    res, failures = {}, []
    for xs, ws, kw in (((16, 64, 56, 56), (64, 64, 3, 3), dict(pad=(1, 1))),
                       ((16, 256, 28, 28), (512, 256, 1, 1),
                        dict(stride=(2, 2)))):
        x = torch.randn(xs, generator=gen).cuda()
        w = (torch.randn(ws, generator=gen) * 0.05).cuda()
        stride, pad = kw.get("stride", (1, 1)), kw.get("pad", (0, 0))
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = tnn.convolution(xg, wg, stride=stride, pad=pad)
            g = torch.randn(out.shape, generator=gen).cuda()
            dx, dw = torch.autograd.grad(out, (xg, wg), g)
            cudnn_tf32 = F.conv2d(x, w, stride=stride, padding=pad)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        conv = lambda a, b: F.conv2d(a, b, stride=stride,  # noqa: E731
                                     padding=pad)
        xd, wd_, gd = (t.double() for t in (x, w, g))
        ref, rdx, rdw = _conv_f64(conv, xd, wd_, gd)
        # one TF32 pass: the operands of each product rounded to TF32
        tf32, rtx, rtw = _conv_f64(conv, _tf32(xd), _tf32(wd_), _tf32(gd))
        shape = f"x {xs} w {ws} {kw}"
        for what, got, want, tf in (("forward", out, ref, tf32),
                                    ("input gradient", dx, rdx, rtx),
                                    ("weight gradient", dw, rdw, rtw)):
            scale = want.abs().max().item()
            err = (got.double() - want).abs().max().item() / scale
            tf_err = (tf - want).abs().max().item() / scale
            res[f"{shape} {what}"] = {"err": err, "tf32_pass_err": tf_err}
            if what == "forward":
                res[f"{shape} {what}"]["cudnn_tf32_err"] = (
                    cudnn_tf32.double() - want).abs().max().item() / scale
            limit = CONV_F64_RTOL[what]
            if err > limit or tf_err <= limit:
                failures.append(f"{shape} {what}: error {err:.3e} of the "
                                f"largest |f64| value (limit {limit}); one "
                                f"TF32 pass {tf_err:.3e} must exceed it")
        del x, w, xg, wg, out, g, dx, dw, xd, wd_, gd, ref, rdx, rdw, tf32
    log(f"[conv f32] against f64 with cudnn.allow_tf32 on, errors over the "
        f"largest |f64| value (limits {CONV_F64_RTOL}; a TF32 pass fails "
        f"them): " + json.dumps({k: {a: f"{b:.2e}" for a, b in v.items()}
                                 for k, v in res.items()}))
    if failures:
        raise AssertionError("conv f32: " + "; ".join(failures))
    return res


def _vision_flops(net, x):
    """Multiply-adds of one image's forward, counted from the convolution
    and dense shapes by forward hooks during one inference call on ``x``:
    ``(total, first conv's)``. A training step does the forward, the
    weight gradients (as many) and the input gradients (as many, less the
    first convolution's, whose input needs none): 2 operations a
    multiply-add."""
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv

    macs = []

    def hook(mod, inp, out):
        w = mod._parameters["weight"]
        per_out = w[0].numel() if isinstance(mod, _Conv) else w.shape[1]
        macs.append(out[0].numel() * per_out)

    mods = [m for m in net.modules() if isinstance(m, (_Conv, Dense))]
    handles = [m.register_forward_hook(hook) for m in mods]
    try:
        import mxnet_tpu_torch as mx

        net(mx.nd.array(x[:1]))
    finally:
        for h in handles:
            h.remove()
    return sum(macs), macs[0]


def _resnet_net(dtype, batch):
    """resnet50_v1 (classes 1000) on the card, MSRAPrelu weights from seed
    0, its shapes resolved by one inference call, cast to ``dtype``; the
    example's synthetic batch (``rs.rand`` images, ``randint`` labels,
    seed 0); a copy of the initial parameters, running statistics
    included; and the training flops of a step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    t0 = time.perf_counter()
    mx.random.seed(0)
    net = get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.MSRAPrelu())
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(batch, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, batch).astype(np.int32))
    x, y = x.cuda(), y.cuda()
    macs, macs0 = _vision_flops(net, x)
    if dtype == "bfloat16":
        net.cast("bfloat16")
        x = x.to(torch.bfloat16)
        for k, p in net.collect_params().items():
            want = torch.float32 if "batchnorm" in k else torch.bfloat16
            if p.tensor().dtype != want:
                raise AssertionError(f"resnet cast: {k} is {p.tensor().dtype}")
    init = [p.detach().clone() for _, p in sorted(net.named_parameters())]
    flops = 2 * (3 * macs - macs0) * batch
    log(f"[resnet] resnet50_v1 {dtype} B={batch}: {len(init)} parameters "
        f"({sum(p.numel() for p in init)} elements), built in "
        f"{time.perf_counter() - t0:.1f}s; a forward {macs / 1e9:.4f} G "
        f"multiply-adds an image, a training step {flops / 1e12:.4f} "
        f"TFLOP (2 a multiply-add; tools/modelbench.py counts 3 x 4.09e9 "
        f"an image, a multiply-add as one: {3 * 4.09e9 * batch / 1e12:.4f})")
    return net, init, (x, y), flops


def _resnet_step(net, engine_type):
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.optimizer import SGD

    return TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**RESNET_LR),
                     engine_type=engine_type)


def phase_resnet_run(net, init, batch, flops, dtype, engine_type, warmup=2,
                     steps=10):
    """``warmup`` + ``steps`` TrainStep calls of resnet50_v1 on the fixed
    batch from the weights ``init``, the launch counts read around each
    call and held to VISION_WANT (the xent kernels once each); every loss
    finite; one program. Returns the launches, the metrics (ms a step,
    images/s, MFU over the peak for ``dtype``, peak memory) and the final
    state (weights, moving statistics, momenta, masters; in host
    memory)."""
    name = f"resnet {dtype} {engine_type}"
    _restore(net, init)
    ts = _resnet_step(net, engine_type)
    if any("running" in n for n in ts._low) or \
            any(p.requires_grad for n, p in ts._plist if "running" in n):
        raise AssertionError(f"{name}: a moving statistic is trained or "
                             f"has a low-precision copy")
    total = dict.fromkeys(VISION_WANT, 0)
    losses = []
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t = time.perf_counter()
        before = _launch_counts()
        losses.append(ts(*batch))
        got = {k: v - before[k] for k, v in _launch_counts().items()}
        if got != VISION_WANT:
            raise AssertionError(f"{name} step {i}: launches {got}, "
                                 f"expected {VISION_WANT}")
        for k in total:
            total[k] += got[k]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name} losses {losses}: not finite")
    if ts.compiled_programs != 1:
        raise AssertionError(f"{name}: {ts.compiled_programs} programs")
    b = batch[0].shape[0]
    peak_flops = BF16_TC_FLOPS_PER_S if dtype == "bfloat16" else \
        F32_FLOPS_PER_S
    ms = wall / steps * 1e3
    res = {"engine_type": engine_type, "dtype": dtype, "batch": b,
           "ms_per_step": ms, "images_per_s": b * steps / wall,
           "mfu": flops / (ms / 1e3) / peak_flops,
           "mfu_peak_tflops": peak_flops / 1e12, "flops_per_step": flops,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "losses": losses, "steps": steps, "warmup": warmup}
    log(f"[{name}] losses {['%.4f' % v for v in losses]}")
    log(f"[{name}] {steps} timed steps: {ms:.2f} ms/step, "
        f"{res['images_per_s']:.1f} images/s, MFU {res['mfu']:.4f} of "
        f"{peak_flops / 1e12:.0f} TFLOP/s, peak memory "
        f"{res['peak_bytes'] / 2**30:.2f} GiB (reserved "
        f"{res['peak_reserved_bytes'] / 2**30:.2f}); launches per step "
        f"{ {k: v for k, v in VISION_WANT.items() if v} }")
    state = _state(ts, host=True)
    if engine_type == "graph":
        (prog, _, _), = ts._programs.values()
        check_replay_launches(prog, f"{name} step graph")
    del ts
    _release()
    return total, res, state


def _check_eval_reads_statistics(net, x, what):
    """An inference call (NDArrays outside ``record``) normalizes with the
    moving statistics: its output changes when they are set to their
    initial values, and it leaves them as they were."""
    import mxnet_tpu_torch as mx

    stats = {k: p.tensor() for k, p in net.collect_params().items()
             if p.is_state}
    held = {k: v.clone() for k, v in stats.items()}
    with torch.no_grad():
        out = net(mx.nd.array(x))._data.float()
        for k, v in stats.items():
            v.fill_(0.0 if k.endswith("running_mean") else 1.0)
        fresh = net(mx.nd.array(x))._data.float()
        for k, v in stats.items():
            v.copy_(held[k])
        again = net(mx.nd.array(x))._data.float()
    if torch.equal(out, fresh) or not torch.equal(out, again) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"{what}: the inference call does not read "
                             f"the moving statistics")
    if any(not torch.equal(v, held[k]) for k, v in stats.items()):
        raise AssertionError(f"{what}: an inference call moved the "
                             f"statistics")
    log(f"[{what}] an inference call of {tuple(x.shape)} reads the moving "
        f"statistics (max |out - out with initial statistics| "
        f"{(out - fresh).abs().max().item():.3e}) and leaves them")


def phase_resnet():
    """resnet50_v1 at full width through TrainStep, two turns: f32 at
    B=64 (the example's default) and ``net.cast("bfloat16")`` at B=128
    (tools/modelbench.py:60,70-76: bf16 weights trained through
    TrainStep's f32 masters, BatchNorm's parameters f32), each naive,
    graph, graph, naive from the same start. Each turn: losses, weights,
    moving statistics and momenta bit-identical across its four runs
    (``_turns``); every moving statistic moved; an inference call reads
    them; the xent kernels launched once each a step, confirmed on a
    profiled replay. Returns the launches of each turn's first graph run
    and the metrics."""
    launches, runs = {}, {}
    for dtype, batch in RESNET_TURNS:
        net, init, data, flops = _resnet_net(dtype, batch)
        names = [n for n, _ in sorted(net.named_parameters())]
        key = "resnet" if dtype == "float32" else "resnet_bf16"
        launches[key], runs[key] = _turns(
            f"resnet {dtype}", lambda mode: phase_resnet_run(
                net, init, data, flops, dtype, mode))
        moved = [n for n, p, w in zip(names, (p for _, p in sorted(
            net.named_parameters())), init) if "running" in n and
                 not torch.equal(p, w)]
        n_stats = sum("running" in n for n in names)
        if len(moved) != n_stats:
            raise AssertionError(f"resnet {dtype}: {len(moved)} of "
                                 f"{n_stats} moving statistics moved")
        log(f"[resnet {dtype}] all {n_stats} moving statistics moved "
            f"(f32: {all(p.dtype == torch.float32 for n, p in net.named_parameters() if 'running' in n)})")
        _check_eval_reads_statistics(net, data[0][:8], f"resnet {dtype}")
        del net, init, data
        _release()
    return launches, runs


def _lenet_data(n_batches=4):
    """Seeded (LENET_B, 1, 28, 28) batches of a learnable task: each image
    is its class's fixed pattern plus noise."""
    rs = np.random.RandomState(0)
    patterns = rs.rand(10, 1, 28, 28).astype(np.float32)
    out = []
    for _ in range(n_batches):
        y = rs.randint(0, 10, LENET_B).astype(np.int32)
        x = patterns[y] + 0.5 * rs.rand(LENET_B, 1, 28, 28).astype(
            np.float32)
        out.append((torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()))
    return out


def _lenet_net(mx, init=None):
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    mx.random.seed(0)
    net = get_model("lenet")
    net.initialize(mx.init.Xavier())
    net.hybridize()
    net(mx.nd.array(torch.zeros(1, 1, 28, 28).cuda()))
    if init is not None:
        _restore(net, init)
    return net


def phase_lenet():
    """LeNet (``model_zoo/vision/lenet.py``), hybridized, through
    ``autograd.record()`` + ``loss.backward()`` +
    ``gluon.Trainer(net.collect_params(), "adam")``.step on seeded (64, 1,
    28, 28) batches: (a) 3 steps bit-identical (losses, weights, Adam
    moments) to ``TrainStep(engine_type="naive")`` with the same loss and
    optimizer from the same weights (B=64: the Trainer's 1/B and the mean's
    differ by a power of two); (b) LENET_STEPS steps, each launching the
    Adam kernel once over the 10 tensors and the xent pair at (64, 10),
    the loss falling. Returns the launches of (b) and the metrics."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.optimizer import Adam

    data = _lenet_data()
    net0 = _lenet_net(mx)
    init = [p.detach().clone() for _, p in sorted(net0.named_parameters())]
    if len(init) != 10:
        raise AssertionError(f"lenet: {len(init)} parameters")
    tnet = _lenet_net(mx, init)
    ts = TrainStep(tnet, SoftmaxCrossEntropyLoss(),
                   Adam(learning_rate=LENET_LR), engine_type="naive")
    ts_losses = [float(ts(*data[i % len(data)])) for i in range(3)]
    inet = _lenet_net(mx, init)
    trainer = mx.gluon.Trainer(inet.collect_params(), "adam",
                               {"learning_rate": LENET_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nd = [(mx.nd.array(x), mx.nd.array(y)) for x, y in data]
    im_losses = [float(_gluon_step(mx, inet, trainer, loss_fn,
                                   *nd[i % len(nd)])) for i in range(3)]
    by_var = {id(p.tensor()): st for p, st in zip(trainer._params,
                                                trainer._states)}
    diff = [name for (name, a), (_, b) in zip(sorted(inet.named_parameters()),
                                              sorted(tnet.named_parameters()))
            if not torch.equal(a, b) or not all(
                torch.equal(u, v) for u, v in zip(by_var[id(a)],
                                                  ts.opt_state[name]))]
    log(f"[lenet f32] 3 steps at lr {LENET_LR}: losses record/backward/"
        f"Trainer.step {im_losses} / TrainStep naive {ts_losses}; weights "
        f"or Adam moments that differ: {diff or 'none'}")
    if im_losses != ts_losses or diff:
        raise AssertionError("lenet: the imperative steps are not "
                             "bit-identical to TrainStep naive")
    del tnet, ts, inet, trainer, by_var
    # (b) the timed loop
    net = _lenet_net(mx, init)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LENET_LR})
    want = LENET_WANT
    total = dict.fromkeys(want, 0)
    losses = []
    torch.cuda.synchronize()
    _reset_launch_counts()
    t = time.perf_counter()
    for i in range(LENET_STEPS):
        before = _launch_counts()
        losses.append(_gluon_step(mx, net, trainer, loss_fn,
                                  *nd[i % len(nd)]))
        got = {k: v - before[k] for k, v in _launch_counts().items()}
        if got != want:
            raise AssertionError(f"lenet step {i}: launches {got}, "
                                 f"expected {want}")
        for k in total:
            total[k] += got[k]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    losses = [float(v) for v in losses]
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not all(np.isfinite(losses)) or not last < 0.7 * first:
        raise AssertionError(f"lenet losses {losses}: not falling")
    res = {"ms_per_step": wall / LENET_STEPS * 1e3,
           "images_per_s": LENET_B * LENET_STEPS / wall, "losses": losses,
           "steps": LENET_STEPS, "parity_losses": im_losses}
    log(f"[lenet] {LENET_STEPS} steps (eager, including the first): "
        f"{res['ms_per_step']:.2f} ms/step, {res['images_per_s']:.0f} "
        f"images/s; losses {['%.4f' % v for v in losses]}; launches per "
        f"step { {k: v for k, v in want.items() if v} }")
    del net, trainer
    _release()
    return total, res


def phase_vision_timing():
    """The xent kernels at the vision paths' shapes, (64, 1000) f32 and
    (128, 1000) bf16 (ResNet-50's head) and (64, 10) f32 (LeNet's), and the
    Adam kernel over LeNet's 10 tensors, each beside its plain version and
    the library call (``_xent_rows``, ``_adam_row``); then BatchNorm at
    ResNet-50's largest shape, (B, 64, 112, 112) (the first convolution's
    output; stage 1's (B, 256, 56, 56) is as large), in training, forward
    and backward: the port's composition (``ops.nn.batch_norm``, its
    statistics as the JAX op computes them) beside ``F.batch_norm``
    (cuDNN), f32 at B=64 and bf16 at B=128, device time of a CUDA graph
    replay, and the bytes the two move at the least (x read twice, out
    written, then g and x read, dx written)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as tnn

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(23)
    rows = {}
    for name, (n, c, dtype) in (("resnet", (64, 1000, torch.float32)),
                                ("resnet_bf16", (128, 1000, torch.bfloat16)),
                                ("lenet", (64, 10, torch.float32))):
        fwd, bwd = _xent_rows(gen, n, c, dtype)
        rows[f"xent_fwd_{name}"], rows[f"xent_bwd_{name}"] = fwd, bwd
    rows["adam_lenet"] = _adam_row(_lenet_net(mx), gen)
    bn = {}
    for dtype, b in ((torch.float32, 64), (torch.bfloat16, 128)):
        shape = (b, 64, 112, 112)
        x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype).cuda()
        g = torch.randn(shape, generator=gen).to(dtype).cuda()
        xr = x.clone().requires_grad_()
        gr = (torch.rand(64, generator=gen) + 0.5).cuda().requires_grad_()
        br = (torch.randn(64, generator=gen) * 0.1).cuda().requires_grad_()
        zeros, ones = torch.zeros(64).cuda(), torch.ones(64).cuda()

        def composition():
            out, _, _ = tnn.batch_norm(xr, gr, br, zeros, ones,
                                       training=True)
            torch.autograd.grad(out, (xr, gr, br), g)

        def library():
            out = F.batch_norm(xr, None, None, gr, br, training=True)
            torch.autograd.grad(out, (xr, gr, br), g)

        size = x.element_size()
        nbytes = 6 * x.numel() * size
        row = {"shape": f"{shape} {str(dtype)[6:]}",
               "composition_ms": graph_time_ms(composition, calls=2,
                                               replays=3, repeats=3),
               "f_batch_norm_ms": graph_time_ms(library, calls=2, replays=3,
                                                repeats=3),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, _, _ = tnn.batch_norm(xr, gr, br, zeros, ones, training=True)
        row["composition_saved_bytes"] = torch.cuda.max_memory_allocated() \
            - base
        del out
        log(f"[time] BatchNorm fwd+bwd {row['shape']}: composition "
            f"{row['composition_ms']:.3f} ms, F.batch_norm "
            f"{row['f_batch_norm_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
            f"ms (bytes); the composition's forward holds "
            f"{row['composition_saved_bytes'] / 2**30:.2f} GiB")
        bn[str(dtype)[6:]] = row
        del x, xr, g
        _release()
    rows["batch_norm"] = bn
    return rows


# ---------------------------------------------------------------------------
# BERT pretraining (models/bert.py): bench.py's step, BERT-large at seq 128,
# batch 64, 20 masked positions (bench.py:470), through
# TrainStep(n_model_inputs=4, amp="bfloat16"): f32 masters, bf16 compute
BERT_LAYERS, BERT_UNITS, BERT_HIDDEN, BERT_VOCAB = 24, 1024, 4096, 30522
BERT_B, BERT_T, BERT_M = 64, 128, 20


def bert_flops(batch, seq, masked, num_layers, units, hidden, vocab):
    """bench.py's ``bert_flops`` (bench.py:342): training FLOPs of a step,
    3x the forward's matrix products (the encoder's and the MLM decoder's
    over the masked positions)."""
    per_token_layer = (4 * units * units * 2 + 2 * units * hidden * 2
                       + 2 * seq * units * 2)
    fwd = batch * seq * per_token_layer * num_layers
    head = batch * masked * units * vocab * 2
    return 3 * (fwd + head)


def bert_loss(out, labels, weights, nsp_labels):
    """bench.py's loss_fn: both heads cast to f32, then pretrain_loss."""
    from mxnet_tpu_torch.models.bert import pretrain_loss

    mlm, nsp = out
    return pretrain_loss(mlm.float(), nsp.float(), labels, weights,
                         nsp_labels)


def _bert_batch(batch, seq, masked, seed=0, ragged=False):
    """bench.py:306-331's batch from np.random.RandomState(seed): ids, zero
    token types, valid_length = seq, masked positions, labels, unit
    weights, NSP labels; the model's 4 int32 inputs then the 3 loss
    inputs, on the card. With ``ragged``, token types of both kinds and
    valid lengths from seq / 2 to seq (the first row full), drawn after
    the rest."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, BERT_VOCAB, (batch, seq))
    types = np.zeros((batch, seq))
    valid = np.full((batch,), seq)
    pos = rs.randint(0, seq, (batch, masked))
    labels = rs.randint(0, BERT_VOCAB, (batch, masked))
    weights = np.ones((batch, masked))
    nsp = rs.randint(0, 2, (batch,))
    if ragged:
        types = rs.randint(0, 2, (batch, seq))
        valid = rs.randint(seq // 2, seq + 1, (batch,))
        valid[0] = seq
    arrays = [a.astype(np.int32) for a in (ids, types, valid, pos, labels)]
    arrays += [weights.astype(np.float32), nsp.astype(np.int32)]
    return tuple(torch.from_numpy(a).cuda() for a in arrays)


def _bert_step(net, engine_type, lr=1e-4):
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.optimizer import Adam

    return TrainStep(net, bert_loss, Adam(learning_rate=lr), n_model_inputs=4,
                     amp="bfloat16", engine_type=engine_type)


def _bert_net(dropout=0.0):
    """``get_bert("bert_large", max_length=128)`` on the card (seed 0)."""
    from mxnet_tpu_torch.models import get_bert

    t0 = time.perf_counter()
    net = get_bert("bert_large", max_length=BERT_T, dropout=dropout,
                   device="cuda", seed=0)
    params = list(net.parameters())
    log(f"[bert_amp] bert_large max_length {BERT_T}, dropout {dropout}: "
        f"{len(params)} parameters, {sum(p.numel() for p in params)} "
        f"elements, built in {time.perf_counter() - t0:.1f}s")
    return net


BERT_WANT = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
             "adam": 1,
             # embed_ln, ln1 and ln2 of each of the 24 layers, mlm_ln
             "layernorm": 2 * BERT_LAYERS + 2,
             "layernorm_bwd": 2 * BERT_LAYERS + 2,
             "layernorm_bwd_merge": 2 * BERT_LAYERS + 2,
             "paged_attention": 0, "paged_attention_prefill": 0,
             "xent_fwd": 0, "xent_bwd": 0}


def phase_bert(net, init, engine_type, card, warmup=2, steps=10,
               name="bert_amp"):
    """bench.py's BERT step on ``net`` (from the weights ``init``, unless
    None): B=64, T=128, M=20, Adam(1e-4), amp="bfloat16"; each step 50
    LayerNorm forwards, backwards and merges (bf16), 1 Adam and no flash,
    paged or xent launch (``_timed_steps``). Adds the MFU by bench.py's
    ``bert_flops`` over the bf16 dense peak, beside the card."""
    if init is not None:
        _restore(net, init)
    ts = _bert_step(net, engine_type)
    total, res, state = _timed_steps(
        f"{name} {engine_type}", net, ts, _bert_batch(BERT_B, BERT_T, BERT_M),
        BERT_WANT, torch.bfloat16, warmup, steps, BERT_B, BERT_T)
    flops = bert_flops(BERT_B, BERT_T, BERT_M, BERT_LAYERS, BERT_UNITS,
                       BERT_HIDDEN, BERT_VOCAB)
    res.update(flops_per_step=flops,
               mfu=flops / (res["ms_per_step"] * 1e-3) / BF16_TC_FLOPS_PER_S,
               floor_ms=flops / BF16_TC_FLOPS_PER_S * 1e3, card=card)
    log(f"[{name} {engine_type}] {res['ms_per_step']:.2f} ms/step, "
        f"{res['samples_per_s']:.1f} samples/s, {res['tokens_per_s']:.0f} "
        f"tokens/s, peak {res['peak_bytes'] / 2**30:.2f} GiB allocated / "
        f"{res['peak_reserved_bytes'] / 2**30:.2f} reserved, MFU "
        f"{res['mfu']:.4f} ({flops:.4e} flops a step over 989 TFLOP/s: "
        f"floor {res['floor_ms']:.2f} ms) on {card}")
    return total, res, state


def phase_bert_turns(card):
    """``phase_bert`` under MODE_TURNS from one start at dropout 0
    (``_turns``). Returns the net, the launches of the first "graph" run
    and the runs' metrics."""
    net = _bert_net()
    init = [p.detach().clone() for _, p in sorted(net.named_parameters())]
    launches, runs = _turns("bert_amp", lambda mode: phase_bert(
        net, init, mode, card))
    del init
    _release()
    return net, launches, runs


def _replayed_losses(net, batch):
    """Four calls of a "graph" TrainStep at lr 0 on one batch (the eager
    warm-up, the capture and its replay, two more replays): the weights
    never move, so the last two losses differ only by dropout."""
    ts = _bert_step(net, "graph", lr=0.0)
    losses = [float(ts(*batch)) for _ in range(4)]
    (prog, _, _), = ts._programs.values()
    if prog.graph is None or prog.calls != 4:
        raise AssertionError(f"dropout check: the step was not replayed "
                             f"({prog.calls} calls)")
    del ts
    _release()
    return losses


def phase_bert_dropout(net, card):
    """Dropout inside a captured step: at lr 0 on one batch two
    consecutive replays give equal losses at dropout 0 (``net``, the timed
    runs' model) and different losses at bench.py's dropout 0.1 (a fresh
    model): each replay draws new masks. Then one timed "graph" run at
    dropout 0.1, as bench.py trains: finite losses and the launch counts of
    ``phase_bert``. Returns that run's metrics."""
    batch = _bert_batch(BERT_B, BERT_T, BERT_M)
    at0 = _replayed_losses(net, batch)
    if at0[2] != at0[3]:
        raise AssertionError(f"dropout 0: two replays at lr 0 gave losses "
                             f"{at0[2:]}")
    net = _bert_net(dropout=0.1)
    at1 = _replayed_losses(net, batch)
    if at1[2] == at1[3] or not all(np.isfinite(at1)):
        raise AssertionError(f"dropout 0.1: two replays at lr 0 gave losses "
                             f"{at1[2:]}: one frozen mask")
    log(f"[bert dropout] lr 0, one batch, calls warm-up, capture, replay, "
        f"replay: losses at dropout 0 {at0}, at dropout 0.1 {at1}: a fresh "
        f"mask at each replay")
    _, res, _ = phase_bert(net, None, "graph", card, name="bert_amp_dropout")
    del net
    _release()
    return {"losses_lr0_dropout0": at0, "losses_lr0_dropout0.1": at1,
            "run": res}


# ---------------------------------------------------------------------------
# The rest of the NN ops and the optimizers (ROADMAP queue 1, items 3 and 4):
# each new op on the card against the same op on CPU tensors, the chunked
# attention's VJP at T=8192, the fused xent op, the samplers' moments; the
# optimizers through TrainStep and the Gluon Trainer; BERT-large pretrained
# through LAMB by examples/torch_pretrain_bert.py's route.

# (rtol, atol) of a card result against the CPU's: f32 elementwise work, f32
# products and sums (cuBLAS and the CPU sum in other orders), CTC's log-space
# recursion over 400 frames, bf16
NN_TOL = {"f32": (1e-5, 1e-6), "f32_sum": (1e-4, 1e-4), "ctc": (1e-4, 1e-3),
          "bf16": (2e-2, 2e-2)}
# the chunked VJP in bf16 against the flash backward kernels: both round
# their gradients to bf16 and sum in other orders; a gradient may differ by
# this share of the largest |gradient| (the bf16 kernels' 3e-2 against the
# exact plain version)
CHUNKED_BF16_REL = 3e-2
# the samplers' moment checks: a sample moment may stand this many of its
# standard errors (sd / sqrt(draws)) from the distribution's
SAMPLER_SIGMAS = 6.0
SAMPLER_DRAWS = 1 << 20
# the knob-off flash backward's shape (B, H, T, D): a long context, where
# flash_bwd_plain's (B, H, T, T) f32 blocks take 4.3 GB each
CHUNKED_SHAPE = (1, 16, 8192, 64)


def _close(what, got, want, tol):
    """Max abs error of ``got`` against ``want``; raises beyond ``tol`` =
    (rtol, atol) per element."""
    rtol, atol = tol
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    err = (got - want).abs()
    bad = ~(err <= atol + rtol * want.abs())
    log(f"  {what}: max_abs_err={err.max().item() if err.numel() else 0:.3e}"
        f" (rtol {rtol}, atol {atol})")
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"tolerance")
    return err.max().item() if err.numel() else 0.0


def _card_and_cpu(what, fn, inputs, tol, grad=True, seed=0):
    """``fn`` on the card and on CPU copies of ``inputs`` (CPU tensors):
    its outputs, and with ``grad`` the gradients of its floating inputs
    under one seeded cotangent, held card against CPU at ``tol``. Returns
    the largest error."""
    results = {}
    for dev in ("cuda", "cpu"):
        # detached: a CPU input's ``.to("cpu")`` is the input itself, which
        # must not keep a requires_grad flag for the next case that reads it
        ts = [t.detach().to(dev).requires_grad_(grad and
                                                t.is_floating_point())
              for t in inputs]
        out = fn(*ts)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        grads = []
        if grad:
            gen = torch.Generator().manual_seed(seed)
            floats = [o for o in outs if o.is_floating_point()
                      and o.requires_grad]
            cots = [torch.randn(o.shape, generator=gen).to(dev, o.dtype)
                    for o in floats]
            leaves = [t for t in ts if t.requires_grad]
            grads = torch.autograd.grad(floats, leaves, cots,
                                        allow_unused=True)
        results[dev] = ([o.detach() for o in outs],
                        [g for g in grads if g is not None])
    err = 0.0
    for i, (a, b) in enumerate(zip(*(results[d][0] for d in ("cuda",
                                                               "cpu")))):
        err = max(err, _close(f"{what} out {i}", a, b, tol))
    for i, (a, b) in enumerate(zip(*(results[d][1] for d in ("cuda",
                                                               "cpu")))):
        err = max(err, _close(f"{what} grad {i}", a, b, tol))
    return err


def _ctc_case(t_len=400, b=32, c=29, max_label=100, seed=0):
    """(T, B, C) activations, 1-based labels of 1 to ``max_label`` classes
    (0-padded), data lengths from 250 to T: every alignment feasible."""
    rs = np.random.RandomState(seed)
    data = torch.from_numpy((2 * rs.randn(t_len, b, c)).astype(np.float32))
    lab_len = rs.randint(1, max_label + 1, (b,))
    lab_len[0] = max_label
    label = np.zeros((b, max_label), np.int32)
    for i, n in enumerate(lab_len):
        label[i, :n] = rs.randint(1, c, (n,))
    data_len = rs.randint(250, t_len + 1, (b,))
    data_len[0] = t_len
    return (data, torch.from_numpy(label),
            torch.from_numpy(data_len.astype(np.int32)),
            torch.from_numpy(lab_len.astype(np.int32)))


def _nn_ctc():
    """CTC at (T=400, B=32, C=29, L<=100), forward and backward, card
    against CPU, then timed beside ``F.ctc_loss`` (a yardstick: its values
    on these feasible alignments must agree; its CUDA backward is
    nondeterministic and it gives inf, not ~1e30, where no alignment
    exists, so the port never calls it)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import nn as tnn

    data, label, dl, ll = _ctc_case()

    def port(d, lab, dlen, llen):
        return tnn.ctc_loss(d, lab, dlen, llen, True, True, "first")

    err = _card_and_cpu("CTCLoss (400, 32, 29) L<=100", port,
                        [data, label, dl, ll], NN_TOL["ctc"])
    d = data.cuda().requires_grad_()
    lab, dlen, llen = label.cuda(), dl.cuda(), ll.cuda()
    ours = port(d, lab, dlen, llen)
    theirs = F.ctc_loss(torch.log_softmax(d.float(), -1), lab.long(),
                        dlen.long(), llen.long(), blank=0, reduction="none")
    yard = _close("CTCLoss against F.ctc_loss", ours, theirs, (1e-4, 1e-3))

    def fwd_bwd(fn):
        def run():
            d.grad = None
            fn().sum().backward()
        return run

    ms = cuda_time_ms(fwd_bwd(lambda: port(d, lab, dlen, llen)), warmup=1,
                      iters=3, repeats=3)
    fwd_ms = cuda_time_ms(lambda: port(d.detach(), lab, dlen, llen),
                          warmup=1, iters=3, repeats=3)
    lib_ms = cuda_time_ms(fwd_bwd(lambda: F.ctc_loss(
        torch.log_softmax(d, -1), lab.long(), dlen.long(), llen.long(),
        blank=0, reduction="none")), warmup=2, iters=10, repeats=3)
    log(f"[nn_ops] CTCLoss (400, 32, 29): forward + backward {ms:.2f} ms, "
        f"forward {fwd_ms:.2f} ms (eager, 400 frames a loop), F.ctc_loss "
        f"forward + backward {lib_ms:.3f} ms (yardstick)")
    return dict(max_abs_err=err, f_ctc_loss_max_abs_diff=yard,
                fwd_bwd_ms=ms, fwd_ms=fwd_ms, f_ctc_loss_fwd_bwd_ms=lib_ms)


def _nn_interleaved():
    """The interleaved self-attention ops at BERT-large width (qkv (128, 64,
    3072), 16 heads): scores, softmax, valatt, forward and backward, on the
    card against the port's ``multi_head_attention`` plain route on the
    same q, k, v (f32), and against the CPU (f32, then under
    ``amp.init("bfloat16")``); the cross-attention pair and
    ``_contrib_div_sqrt_dim`` against the CPU."""
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import attention as att

    t, b, h, ch = 128, 64, 16, 64
    gen = torch.Generator().manual_seed(31)
    qkv = torch.randn(t, b, h * 3 * ch, generator=gen)

    def cell(x):
        s = att.interleaved_matmul_selfatt_qk(x, heads=h)
        return att.interleaved_matmul_selfatt_valatt(
            x, torch.softmax(s.float(), -1).to(s.dtype), heads=h)

    def mha(x):
        q, k, v = x.reshape(t, b, h, 3, ch).permute(3, 1, 2, 0, 4)
        out = att.multi_head_attention(q, k, v, use_flash=False)
        return out.permute(2, 0, 1, 3).reshape(t, b, h * ch)

    res = {}
    x = qkv.cuda().requires_grad_()
    y = x.detach().clone().requires_grad_()
    cot = torch.randn(t, b, h * ch, generator=gen).cuda()
    got, want = cell(x), mha(y)
    gx, gy = torch.autograd.grad(got, x, cot)[0], \
        torch.autograd.grad(want, y, cot)[0]
    res["against_mha"] = max(
        _close("selfatt qk/valatt against multi_head_attention", got, want,
               NN_TOL["f32_sum"]),
        _close("selfatt qk/valatt grad against multi_head_attention", gx, gy,
               NN_TOL["f32_sum"]))
    res["f32"] = _card_and_cpu("selfatt qk/valatt (128, 64, 3072) f32", cell,
                               [qkv], NN_TOL["f32_sum"])
    amp.init("bfloat16")
    try:
        res["bf16_amp"] = _card_and_cpu(
            "selfatt_qk (128, 64, 3072) under amp bf16",
            lambda a: att.interleaved_matmul_selfatt_qk(a, heads=h), [qkv],
            NN_TOL["bf16"])
    finally:
        amp._reset()
    q = torch.randn(t, b, h * ch, generator=gen)
    kv = torch.randn(96, b, h * 2 * ch, generator=gen)
    res["encdec"] = _card_and_cpu(
        "encdec qk/valatt (128 | 96, 64, 16 heads)",
        lambda a, c: att.interleaved_matmul_encdec_valatt(
            c, torch.softmax(att.interleaved_matmul_encdec_qk(a, c, heads=h),
                             -1), heads=h), [q, kv], NN_TOL["f32_sum"])
    res["div_sqrt_dim"] = _card_and_cpu("div_sqrt_dim", att.div_sqrt_dim,
                                        [q], NN_TOL["f32"])
    return res


def _nn_elementwise():
    """The heads, norms and resizes of ops/nn.py at realistic shapes, card
    against CPU, values and gradients."""
    from mxnet_tpu_torch.ops import core
    from mxnet_tpu_torch.ops import nn as tnn

    gen = torch.Generator().manual_seed(32)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    fmap = rnd(32, 256, 28, 28)
    logits = rnd(4096, 1000, scale=3.0)
    labels = torch.randint(0, 1000, (4096,), generator=gen).float()
    labels[::7] = -1.0
    target = torch.rand(4096, 1000, generator=gen)
    img = rnd(16, 256, 64, 64)
    cases = [
        ("L2Normalization instance", lambda a: tnn.l2_normalization(a),
         [fmap], "f32_sum"),
        ("L2Normalization channel",
         lambda a: tnn.l2_normalization(a, mode="channel"), [fmap],
         "f32_sum"),
        ("L2Normalization spatial",
         lambda a: tnn.l2_normalization(a, mode="spatial"), [fmap],
         "f32_sum"),
        ("RMSNorm (8192, 1024) f32", tnn.rms_norm,
         [rnd(8192, 1024), rnd(1024)], "f32_sum"),
        ("RMSNorm (8192, 1024) bf16",
         lambda a, g: tnn.rms_norm(a.bfloat16(), g.bfloat16()),
         [rnd(8192, 1024), rnd(1024)], "bf16"),
        ("UpSampling x2", lambda a: tnn.upsampling(a, scale=2), [fmap],
         "f32"),
        ("BilinearResize2D up (64, 64) -> (128, 128)",
         lambda a: tnn.bilinear_resize(a, height=128, width=128), [img],
         "f32_sum"),
        ("BilinearResize2D down (64, 64) -> (32, 23)",
         lambda a: tnn.bilinear_resize(a, height=32, width=23), [img],
         "f32_sum"),
        ("SoftmaxOutput (4096, 1000) ignore, valid, smoothed",
         lambda a, l: tnn.softmax_output(a, l, use_ignore=True,
                                         normalization="valid",
                                         smooth_alpha=0.1),
         [logits, labels], "f32_sum"),
        ("LinearRegressionOutput", tnn.linear_regression_output,
         [logits, target], "f32"),
        ("LogisticRegressionOutput", tnn.logistic_regression_output,
         [logits, target], "f32"),
        ("MAERegressionOutput", tnn.mae_regression_output,
         [logits, target], "f32"),
        ("smooth_l1", lambda a: tnn.smooth_l1(a, 2.0), [logits], "f32"),
        ("softmax_cross_entropy",
         lambda a, l: tnn.softmax_cross_entropy(a, l.clamp(min=0)),
         [logits, labels], "f32_sum"),
        ("boolean_mask (4096, 1000)",
         lambda a, m: core.boolean_mask(a, m), [logits, (labels >= 0).float()],
         "f32"),
    ]
    return {what: _card_and_cpu(what, fn, inputs, NN_TOL[tol])
            for what, fn, inputs, tol in cases}


def _nn_embedding():
    """The lookup's gradient (ops/nn.py ``embedding``) where
    ``F.embedding``'s CUDA backward changed its sum from call to call: f32
    gradients on the ids of the example's first batch at B=64, T=128
    (examples/torch_pretrain_bert.py ``make_batch``), for the token types
    (2 rows: the one-hot product) and the words (30522 rows:
    ``F.embedding``'s own backward). The port's 20 calls must be equal bit
    for bit; ``F.embedding``'s 20 calls are reported (for the token types
    they differed inside the BERT step), both routes timed."""
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as tnn

    ex = _example("torch_pretrain_bert")
    words, types = (a._data for a in ex.make_batch(
        BERT_B, BERT_T, BERT_M, BERT_VOCAB, np.random.RandomState(0),
        mx.gpu())[:2])
    gen = torch.Generator().manual_seed(38)
    res = {}
    for name, rows, idx in (("token_types", 2, types),
                            ("words", BERT_VOCAB, words)):
        w = torch.zeros(rows, BERT_UNITS, device="cuda", requires_grad=True)
        g = torch.randn(BERT_B, BERT_T, BERT_UNITS, generator=gen).cuda()

        def port():
            return torch.autograd.grad(tnn.embedding(idx, w), w, g)[0]

        def native():
            return torch.autograd.grad(F.embedding(idx.long(), w), w, g)[0]

        runs = {fn.__name__: [fn() for _ in range(20)]
                for fn in (port, native)}
        same = {k: all(torch.equal(v[0], x) for x in v[1:])
                for k, v in runs.items()}
        if not same["port"]:
            raise AssertionError(f"embedding gradient ({name}): 20 calls "
                                 f"differ")
        res[name] = dict(
            route="one-hot" if rows <= tnn.ONE_HOT_ROWS else "F.embedding",
            us=graph_time_ms(port, calls=2, replays=5, repeats=3) * 1e3,
            native_us=graph_time_ms(native, calls=2, replays=5,
                                    repeats=3) * 1e3,
            native_20_calls_equal=same["native"])
        log(f"[nn_ops] embedding gradient, {name} ({rows} rows, the "
            f"example's ({BERT_B}, {BERT_T}) ids, f32): {res[name]}")
    return res


def _peak_above(fn):
    """(result, peak allocated bytes above what was allocated before)."""
    torch.cuda.synchronize()
    _release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _nn_chunked():
    """The knob-off flash backward at B=1, H=16, T=8192, d 64, bf16,
    causal: ``chunked_attention_vjp`` against the flash dK/dV and dQ kernels
    (CHUNKED_BF16_REL), its peak memory beside ``flash_bwd_plain``'s (or
    that one's out-of-memory error), and ``FlashAttention.backward`` with
    ``flash_pallas_bwd`` off launching no backward kernel."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(33)
    q, k, v, do = (torch.randn(CHUNKED_SHAPE, generator=gen).mul(0.5)
                   .to("cuda", torch.bfloat16) for _ in range(4))
    o, lse = fa._flash_fwd(q, k, v, True, return_lse=True)
    kern = fa._flash_bwd(q, k, v, o, lse, do, True)
    chunked, peak = _peak_above(lambda: fa.chunked_attention_vjp(q, k, v, do,
                                                                 True))
    errs = []
    for name, a, b in zip(("dq", "dk", "dv"), chunked, kern):
        rel = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        log(f"  chunked VJP {name} against the flash kernels: max abs err / "
            f"max |kernel| = {rel:.3e} (limit {CHUNKED_BF16_REL})")
        if not rel <= CHUNKED_BF16_REL:
            raise AssertionError(f"chunked VJP {name}: {rel:.3e} of the "
                                 f"kernels' largest gradient")
        errs.append(rel)
    try:
        _, plain_peak = _peak_above(lambda: fa.flash_bwd_plain(q, k, v, o,
                                                               lse, do, True))
        plain = f"{plain_peak / 2**30:.2f} GiB"
    except torch.cuda.OutOfMemoryError as e:
        plain_peak, plain = None, f"out of memory ({str(e)[:80]})"
    _release()
    ms = cuda_time_ms(lambda: fa.chunked_attention_vjp(q, k, v, do, True),
                      warmup=1, iters=3, repeats=3)
    kern_ms = cuda_time_ms(lambda: fa._flash_bwd(q, k, v, o, lse, do, True),
                           warmup=2, iters=5, repeats=3)
    # the route: FlashAttention's backward with the knob off
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    config.set("flash_pallas_bwd", False)
    try:
        before = _launch_counts()
        out = fa.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(out, leaves, do)
        got = {kk: vv - before[kk] for kk, vv in _launch_counts().items()}
    finally:
        config.set("flash_pallas_bwd", True)
    if got["flash_fwd"] != 1 or got["flash_bwd_dkv"] or got["flash_bwd_dq"]:
        raise AssertionError(f"knob-off flash backward launched {got}")
    if not all(torch.equal(a, b) for a, b in zip(grads, chunked)):
        raise AssertionError("knob-off FlashAttention.backward is not the "
                             "chunked VJP")
    log(f"[nn_ops] chunked VJP {CHUNKED_SHAPE} bf16 causal: {ms:.2f} ms, "
        f"peak {peak / 2**30:.3f} GiB above its inputs; flash_bwd_plain "
        f"peak {plain}; dK/dV + dQ kernels {kern_ms:.3f} ms; the knob-off "
        f"backward launched no backward kernel")
    return dict(rel_err=errs, ms=ms, peak_bytes=peak,
                plain_peak_bytes=plain_peak, plain_peak=plain,
                kernels_ms=kern_ms)


def _profiled_count(fn, kernel):
    """Launches of kernels named ``kernel`` in one call of ``fn`` under the
    profiler (a warm-up call the profiler discards first, as
    check_replay_launches does; the largest of REPLAY_ATTEMPTS traces, since
    a trace can lose a record but never adds one)."""
    from torch.profiler import ProfilerActivity, profile

    best = 0
    for _ in range(REPLAY_ATTEMPTS):
        torch.cuda.synchronize()
        once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=once) as prof:
            for _ in range(2):
                time.sleep(REPLAY_QUIET_S)
                fn()
                torch.cuda.synchronize()
                time.sleep(REPLAY_QUIET_S)
                prof.step()
        best = max(best, sum(e.count for e in prof.key_averages()
                             if e.device_type ==
                             torch.autograd.DeviceType.CUDA
                             and kernel in e.key))
        if best:
            break
    return best


def _nn_xent():
    """``nd.softmax_cross_entropy_fused`` on (4096, 50257) bf16 logits: one
    xent forward launch (its counter and the profiler), bit-equal to
    ``SoftmaxCrossEntropyLoss``; under ``autograd.record`` one forward and
    one backward launch. Returns the launches of the nd call (the nn_ops
    path's) and the checks."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    gen = torch.Generator().manual_seed(34)
    x = (torch.randn(4096, 50257, generator=gen) * 3).to("cuda",
                                                         torch.bfloat16)
    lbl = torch.randint(0, 50257, (4096,), generator=gen).cuda()
    px, pl = mx.nd.NDArray(x), mx.nd.NDArray(lbl)
    _reset_launch_counts()
    out = mx.nd.softmax_cross_entropy_fused(px, pl)
    launches = _launch_counts()
    want = dict.fromkeys(launches, 0)
    want["xent_fwd"] = 1
    if launches != want:
        raise AssertionError(f"nd.softmax_cross_entropy_fused launched "
                             f"{launches}")
    traced = _profiled_count(lambda: mx.nd.softmax_cross_entropy_fused(px,
                                                                       pl),
                             "xent_fwd_kernel")
    if traced != 1:
        raise AssertionError(f"the profiler saw {traced} xent_fwd_kernel "
                             f"launches in one nd call")
    ref = SoftmaxCrossEntropyLoss()(x, lbl)
    if not torch.equal(out._data, ref):
        raise AssertionError("nd.softmax_cross_entropy_fused differs from "
                             "SoftmaxCrossEntropyLoss")
    px.attach_grad()
    before = _launch_counts()
    with mx.autograd.record():
        loss = mx.nd.softmax_cross_entropy_fused(px, pl)
    loss.backward()
    rec = {k: v - before[k] for k, v in _launch_counts().items() if v -
           before[k]}
    if rec != {"xent_fwd": 1, "xent_bwd": 1}:
        raise AssertionError(f"recorded nd xent launched {rec}")
    log(f"[nn_ops] nd.softmax_cross_entropy_fused (4096, 50257) bf16: "
        f"launches {dict((k, v) for k, v in launches.items() if v)}, the "
        f"profiler saw {traced} xent_fwd_kernel; bit-equal to "
        f"SoftmaxCrossEntropyLoss; under record {rec}")
    return launches, dict(traced=traced, recorded=rec)


def _moments_ok(what, draws, dist):
    """The mean of the draws and of their squares within SAMPLER_SIGMAS
    standard errors of ``dist``'s (a scipy frozen distribution)."""
    x = draws.double()
    n = x.numel()
    m1, m2 = dist.mean(), dist.moment(2)
    sd1 = math.sqrt(dist.var() / n)
    sd2 = math.sqrt(max(dist.moment(4) - m2 * m2, 0.0) / n)
    got1, got2 = x.mean().item(), (x * x).mean().item()
    ok = abs(got1 - m1) <= SAMPLER_SIGMAS * sd1 and \
        abs(got2 - m2) <= SAMPLER_SIGMAS * sd2
    log(f"  {what}: mean {got1:.5f} (want {m1:.5f} +- "
        f"{SAMPLER_SIGMAS * sd1:.5f}), E[x^2] {got2:.5f} (want {m2:.5f} +- "
        f"{SAMPLER_SIGMAS * sd2:.5f})")
    if not ok:
        raise AssertionError(f"{what}: moments outside {SAMPLER_SIGMAS} "
                             f"standard errors")
    return dict(mean=got1, second=got2)


def _nn_samplers():
    """The samplers on the card (SAMPLER_DRAWS draws each): their first two
    moments against scipy's, a seed reproducing the draws, every draw on
    the card."""
    import mxnet_tpu_torch as mx
    from scipy import stats

    from mxnet_tpu_torch.ops import random_ops as ro

    n = SAMPLER_DRAWS
    gpu = mx.gpu()
    lam2 = torch.full((2,), 2.0, device="cuda")
    cases = [
        ("_random_uniform", lambda: ro.random_uniform(-1.0, 3.0, (n,),
                                                      ctx=gpu),
         stats.uniform(-1.0, 4.0)),
        ("_random_normal", lambda: ro.random_normal(1.0, 2.0, (n,),
                                                    ctx=gpu),
         stats.norm(1.0, 2.0)),
        ("_random_gamma", lambda: ro.random_gamma(2.5, 0.5, (n,), ctx=gpu),
         stats.gamma(2.5, scale=0.5)),
        ("_random_exponential", lambda: ro.random_exponential(
            2.0, (n,), ctx=gpu), stats.expon(scale=0.5)),
        ("_random_poisson", lambda: ro.random_poisson(3.0, (n,), ctx=gpu),
         stats.poisson(3.0)),
        ("_random_randint", lambda: ro.random_randint(2, 9, (n,), ctx=gpu),
         stats.randint(2, 9)),
        ("_random_negative_binomial", lambda: ro.random_negative_binomial(
            3, 0.4, (n,), ctx=gpu), stats.nbinom(3, 0.4)),
        ("_random_generalized_negative_binomial",
         lambda: ro.random_generalized_negative_binomial(2.0, 0.5, (n,),
                                                         ctx=gpu),
         stats.nbinom(2.0, 0.5)),
        ("_sample_gamma", lambda: ro.sample_gamma(lam2, lam2 * 0.25,
                                                  (n // 2,)),
         stats.gamma(2.0, scale=0.5)),
        ("_sample_poisson", lambda: ro.sample_poisson(lam2, (n // 2,)),
         stats.poisson(2.0)),
        ("_sample_normal", lambda: ro.sample_normal(lam2, lam2, (n // 2,)),
         stats.norm(2.0, 2.0)),
        ("_sample_multinomial", lambda: ro.sample_multinomial(
            torch.tensor([0.1, 0.2, 0.3, 0.4], device="cuda"), (n,)),
         stats.rv_discrete(values=([0, 1, 2, 3], [0.1, 0.2, 0.3, 0.4]))),
        ("temperature_sampling", lambda: ro.temperature_sampling(
            torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]], device="cuda"))
            .expand(n, 4)),
         stats.rv_discrete(values=([0, 1, 2, 3], [0.1, 0.2, 0.3, 0.4]))),
    ]
    res = {}
    for name, draw, dist in cases:
        mx.random.seed(40)
        a = draw()
        mx.random.seed(40)
        b = draw()
        if a.device.type != "cuda" or not torch.equal(a, b):
            raise AssertionError(f"{name}: not on the card, or a seed did "
                                 f"not reproduce its draws")
        res[name] = _moments_ok(f"{name} on the card", a, dist)
    x = torch.arange(4096, device="cuda")
    s = ro.shuffle(x)
    if not torch.equal(s.sort().values, x) or torch.equal(s, x):
        raise AssertionError("shuffle on the card is not a permutation")
    z = ro.sample_unique_zipfian(50000, (n,), ctx=gpu)
    if not (z.min() >= 0 and z.max() < 50000):
        raise AssertionError("_sample_unique_zipfian out of range")
    return res


def phase_nn_ops():
    """``[nn_ops]``: the ops of ROADMAP queue 1 item 3 on the card, each
    against the same op on CPU tensors (and the interleaved attention
    against ``multi_head_attention``, CTC beside ``F.ctc_loss``, the chunked
    VJP against the flash kernels), ``nd.softmax_cross_entropy_fused``'s one
    xent launch, the samplers. Returns the nd xent call's launches and the
    results."""
    t0 = time.perf_counter()
    res = {"interleaved": _nn_interleaved(), "ops": _nn_elementwise(),
           "ctc": _nn_ctc(), "chunked": _nn_chunked(),
           "embedding": _nn_embedding()}
    launches, res["xent"] = _nn_xent()
    res["samplers"] = _nn_samplers()
    _release()
    res["seconds"] = time.perf_counter() - t0
    log("[nn_ops] " + json.dumps(res, default=str))
    return launches, res


# the optimizers of the [optimizers] phase: (name, hyperparameters)
OPT_CASES = [("sgd", dict(learning_rate=0.01, momentum=0.9)),
             ("nag", dict(learning_rate=0.01, momentum=0.9)),
             ("adam", dict(learning_rate=1e-3)),
             ("adamw", dict(learning_rate=1e-3, wd=0.01)),
             ("adagrad", dict(learning_rate=1e-3)),
             ("rmsprop", dict(learning_rate=1e-4)),
             ("rmsprop", dict(learning_rate=1e-4, centered=True)),
             ("ftrl", dict(learning_rate=0.1)),
             ("signsgd", dict(learning_rate=1e-3)),
             ("lamb", dict(learning_rate=1e-3, wd=0.01))]
OPT_IN, OPT_HIDDEN, OPT_B = 1024, 4096, 256


def _opt_net(init, dtype=None):
    """The 2-layer net (Dense(4096, relu) over 1024 inputs, Dense(1024)) on
    the card with the weights ``init`` (bf16-exact), cast to ``dtype``."""
    import mxnet_tpu_torch as mx

    net = mx.gluon.nn.HybridSequential(prefix="optnet_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(OPT_HIDDEN, activation="relu",
                                  in_units=OPT_IN),
                mx.gluon.nn.Dense(OPT_IN, in_units=OPT_HIDDEN))
    net.initialize(ctx=mx.gpu())
    _restore(net, init)
    if dtype is not None:
        net.cast(dtype)
    return net


def _opt_loss(out, y):
    """The f32 mean squared error, on tensors (TrainStep) or NDArrays (the
    Gluon loop) alike."""
    if isinstance(out, torch.Tensor):
        return ((out.float() - y.float()) ** 2).mean()
    return ((out.astype("float32") - y.astype("float32")) ** 2).mean()


def _opt_data(n=4):
    gen = torch.Generator().manual_seed(35)
    return [tuple(torch.randn(OPT_B, OPT_IN, generator=gen).bfloat16()
                  .float().cuda() for _ in range(2)) for _ in range(n)]


def _opt_case(name, kw, init, data):
    """One optimizer: TrainStep graph against naive (3 steps), a window of
    2 against calls (4 steps), and the bf16 cast route (TrainStep, f32
    masters) against the Gluon Trainer with ``multi_precision``, each bit
    for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.optimizer import create

    def step(engine_type, dtype=None):
        net = _opt_net(init, dtype)
        return net, TrainStep(net, _opt_loss, create(name, **kw), amp=None,
                              engine_type=engine_type)

    runs = {}
    for mode in ("naive", "graph"):
        _, ts = step(mode)
        losses = [float(ts(*b)) for b in data[:3]]
        runs[mode] = (losses, _state(ts))
        del ts
    if runs["naive"][0] != runs["graph"][0] or \
            not _same_state(runs["naive"][1], runs["graph"][1]):
        raise AssertionError(f"{name} {kw}: graph != naive")
    _, calls = step("graph")
    seq = torch.stack([calls(*b) for b in data])
    _, win = step("graph")
    windowed = win.run(iter(data), steps=4, window=2)
    if not torch.equal(seq, windowed) or \
            not _same_state(_state(calls), _state(win)):
        raise AssertionError(f"{name} {kw}: run(window=2) != calls")
    del calls, win
    bf = [tuple(t.bfloat16() for t in b) for b in data[:3]]
    _, ts = step("graph", "bfloat16")
    ts_losses = [float(ts(*b)) for b in bf]
    masters = [ts._master[n] for n in sorted(ts._master)]
    weights = [p.detach() for _, p in ts._plist]
    net = _opt_net(init, "bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), name,
                               dict(kw, multi_precision=True))
    tr_losses = []
    for x, y in bf:
        with mx.autograd.record():
            loss = _opt_loss(net(mx.nd.NDArray(x)), mx.nd.NDArray(y))
        loss.backward()
        trainer.step(1)
        tr_losses.append(float(loss.asnumpy()))
    tr_masters = {p.name: st["master"]
                  for p, st in zip(trainer._params, trainer._states)}
    tr_weights = {p.name: p.data()._data
                  for p in net.collect_params().values()}
    names = sorted(tr_masters)
    if ts_losses != tr_losses or len(names) != len(masters) or not all(
            torch.equal(a, tr_masters[n]) for a, n in zip(masters, names)) \
            or not all(torch.equal(a, tr_weights[n])
                       for a, n in zip(weights, names)):
        raise AssertionError(f"{name} {kw}: the cast route's masters or "
                             f"weights differ from the multi_precision "
                             f"Trainer's")
    log(f"[optimizers] {name} {kw}: graph == naive, run(window=2) == calls, "
        f"cast route == multi_precision Trainer, bit for bit; losses "
        f"{[round(x, 5) for x in runs['graph'][0]]}")
    return runs["graph"][0]


def phase_optimizers():
    """``[optimizers]``: each of OPT_CASES on the 2-layer net (B=256) through
    ``_opt_case``."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(36)
    # by sorted parameter name: 0.bias, 0.weight, 1.bias, 1.weight
    init = [(torch.randn(p, generator=gen) * s).bfloat16().float().cuda()
            for p, s in (((OPT_HIDDEN,), 0.1), ((OPT_HIDDEN, OPT_IN), 0.03),
                         ((OPT_IN,), 0.1), ((OPT_IN, OPT_HIDDEN), 0.015))]
    data = _opt_data()
    res = {f"{name}{'_centered' if kw.get('centered') else ''}":
           _opt_case(name, kw, init, data) for name, kw in OPT_CASES}
    _release()
    log(f"[optimizers seconds] {time.perf_counter() - t0:.1f} s")
    return res


# examples/torch_pretrain_bert.py's route at bench.py's BERT shape: no Adam
# launch, bert_amp's LayerNorms (bf16 x and gamma: the cast net's)
PRETRAIN_WANT = dict(BERT_WANT, adam=0)


def _pretrain_net():
    """bert_large with the pretraining heads (max_length 128, dropout 0,
    seed 0) in f32: the example's ``train(net=)`` casts it."""
    from mxnet_tpu_torch.models import get_bert

    return get_bert("bert_large", max_length=BERT_T, dropout=0.0,
                    device="cuda", seed=0)


def _pretrain_args(ex, steps):
    """The example's flags at bert_large, B=64, T=128, M=20, ``steps``
    steps after the first (its defaults: LAMB 1e-4, bfloat16, the card)."""
    return ex.build_parser().parse_args(
        ["--model", "bert_large", "--batch-size", str(BERT_B),
         "--seq-length", str(BERT_T), "--num-masked", str(BERT_M),
         "--steps", str(steps)])


def _lamb_row(net, gen):
    """The LAMB update over ``net``'s tensors as the cast route runs it
    (f32 masters, bf16 gradients, the bf16 weights written), one CUDA graph
    of ``update_raw_multi``, beside the Adam kernel over the same tensors
    and dtypes. Bounds: the function's, each input read once and each
    output written once (w, bf16 g, m, v in; w, m, v and the bf16 copy out:
    28 bytes an element, as Adam's; ~22 and ~12 flops an element), and
    LAMB's two phases as the JAX ops write them (phase 1 reads w, g, m, v
    and writes m, v and the update; the norms read w and the update; phase
    2 reads w and the update and writes w and the copy: 48 bytes an
    element)."""
    from mxnet_tpu_torch.ops import optimizer as oo
    from mxnet_tpu_torch.optimizer import LAMB

    dev = torch.device("cuda")
    lows = [p.detach() for p in net.parameters()]
    ws = [p.float() for p in lows]
    gs = [(torch.randn(w.shape, generator=gen) * 1e-3).to(dev, torch.bfloat16)
          for w in ws]
    states = [(torch.zeros_like(w), torch.zeros_like(w)) for w in ws]
    n = sum(w.numel() for w in ws)
    lr = torch.full((len(ws),), 1e-4, device=dev)
    wd = torch.full((len(ws),), 0.01, device=dev)
    t = torch.ones((), dtype=torch.int32, device=dev)
    opt = LAMB(learning_rate=1e-4)
    lamb_ms = graph_time_ms(lambda: opt.update_raw_multi(
        ws, gs, states, lr, wd, t, out_lows=lows), calls=1, replays=3,
        repeats=3)
    adam_ms = graph_time_ms(lambda: oo.adam_update_fused(
        ws, gs, [s[0] for s in states], [s[1] for s in states], lr, wd,
        out_lows=lows), calls=2, replays=3, repeats=3)
    bound, by, _ = _bound_ms(40 * n, 22 * n)
    phases, _, _ = _bound_ms(48 * n, 22 * n)
    adam_bound, _, _ = _bound_ms(28 * n, 12 * n)
    row = dict(tensors=len(ws), elements=n, lamb_ms=lamb_ms,
               lamb_bound_ms=bound, bound_by=by,
               lamb_two_phase_bound_ms=phases, adam_ms=adam_ms,
               adam_bound_ms=adam_bound)
    log(f"[pretrain_bert] LAMB update over {len(ws)} tensors, {n} elements "
        f"(f32 masters, bf16 grads and weights): {lamb_ms:.3f} ms device, "
        f"bound {bound:.3f} ms ({by}; the two phases' {phases:.3f}); the "
        f"Adam kernel over the same {adam_ms:.3f} ms, bound "
        f"{adam_bound:.3f} ms")
    del ws, gs, states, lows
    return row


def phase_pretrain_bert(card):
    """``[pretrain_bert]``: examples/torch_pretrain_bert.py's route (bf16
    weights by ``amp.convert_model``, f32 masters, LAMB 1e-4,
    ``TrainStep(n_model_inputs=4)``) at bert_large, B=64, T=128, M=20:
    the example's ``train(net=, engine_type=)`` for 3 steps on its first 3
    batches, graph == naive bit for bit (losses, weights, masters, LAMB
    moments, step count); then the graph run's TrainStep for 2 warm-up and
    10 timed steps on the example's first batch (``_timed_steps``: 50
    LayerNorm forwards, backwards and
    merges a step on bf16 x and gamma, no Adam launch, a falling loss, one
    program, a profiled replay), ms/step, seq/s, MFU by ``bert_flops``,
    peak memory; the LAMB update's device time beside the Adam kernel's;
    then the example itself as a subprocess (``--model bert_base --steps
    5``). Returns the timed run's launches and the metrics."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp

    t0 = time.perf_counter()
    ex = _example("torch_pretrain_bert")
    try:
        runs = {}
        for mode in ("naive", "graph"):
            with _ln_dtypes() as ln_pairs:
                out = ex.train(_pretrain_args(ex, 2), net=_pretrain_net(),
                               engine_type=mode)
            runs[mode] = ([float(x) for x in out["losses"]],
                          _state(out["step"], host=True))
            if mode == "naive":
                del out
                amp._reset()
                _release()
        if runs["naive"][0] != runs["graph"][0] or \
                not _same_state(runs["naive"][1], runs["graph"][1]):
            raise AssertionError("pretrain_bert: graph != naive")
        log(f"[pretrain_bert] the example's train() at bert_large, 3 steps "
            f"graph == naive bit for bit (losses {runs['graph'][0]}, "
            f"weights, masters, LAMB moments)")
        del runs
        # the graph run's TrainStep (its graph captured in train(), with
        # the LayerNorm dtypes seen there), on the example's first batch
        net, ts = out["net"], out["step"]
        del out
        batch = ex.make_batch(BERT_B, BERT_T, BERT_M, BERT_VOCAB,
                              np.random.RandomState(0), mx.gpu())
        launches, res, state = _timed_steps(
            "pretrain_bert graph", net, ts, batch, PRETRAIN_WANT,
            torch.bfloat16, 2, 10, BERT_B, BERT_T, ln_pairs=ln_pairs)
        del ts, state
        flops = bert_flops(BERT_B, BERT_T, BERT_M, BERT_LAYERS, BERT_UNITS,
                           BERT_HIDDEN, BERT_VOCAB)
        res.update(seq_per_s=res["samples_per_s"], flops_per_step=flops,
                   mfu=flops / (res["ms_per_step"] * 1e-3)
                   / BF16_TC_FLOPS_PER_S, card=card)
        log(f"[pretrain_bert graph] {res['ms_per_step']:.2f} ms/step, "
            f"{res['seq_per_s']:.1f} seq/s, peak "
            f"{res['peak_bytes'] / 2**30:.2f} GiB allocated / "
            f"{res['peak_reserved_bytes'] / 2**30:.2f} reserved, MFU "
            f"{res['mfu']:.4f} on {card}")
        res["lamb"] = _lamb_row(net, torch.Generator().manual_seed(37))
        del net
        _release()
    finally:
        amp._reset()
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, str(root / "examples" / "torch_pretrain_bert.py"),
           "--model", "bert_base", "--steps", "5"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(root)))
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if proc.returncode != 0 or not line.startswith("bert_base: ") or \
            "seq/s, final loss" not in line:
        raise AssertionError(f"examples/torch_pretrain_bert.py exited "
                             f"{proc.returncode}: {line!r} "
                             f"{proc.stderr[-2000:]}")
    res["example_bert_base"] = line
    res["seconds"] = time.perf_counter() - t0
    log(f"[pretrain_bert] the example: {line}")
    log(f"[pretrain_bert seconds] {res['seconds']:.1f} s")
    return launches, res


# ---------------------------------------------------------------------------
# The WMT Transformer (models/transformer.py, BASELINE.md's config #4) on the
# example's synthetic reverse corpus (examples/torch_train_transformer_wmt.py:
# 4096 sentences of 4 to 28 tokens, buckets 8, 16, 24 and 32, B=64)
TF_B, TF_BUCKETS, TF_VOCAB, TF_SEED = 64, (8, 16, 24, 32), 36500, 0
TF_LAYERS = 6
TF_ADAM = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)
# InvSqrtWarmup over 16 steps to a peak of 0.1 * 512^-0.5 * 16^-0.5 =
# 1.1e-3 (the example's schedule; GluonNLP's 4000-step warm-up would not
# move the loss within a phase)
TF_WARMUP, TF_LR_SCALE = 16, 0.1
# a transformer_base / _big step: the decoder's causal self-attention on
# the flash kernels (6 layers), the masked encoder and cross-attention on
# the plain path, 30 LayerNorms (2 a encoder layer, 3 a decoder layer) each
# way, one Adam launch
TF_WANT = {"flash_fwd": TF_LAYERS, "flash_bwd_dkv": TF_LAYERS,
           "flash_bwd_dq": TF_LAYERS, "adam": 1, "layernorm": 5 * TF_LAYERS,
           "layernorm_bwd": 5 * TF_LAYERS,
           "layernorm_bwd_merge": 5 * TF_LAYERS, "paged_attention": 0,
           "paged_attention_prefill": 0, "xent_fwd": 0, "xent_bwd": 0}
# a cached decode step: the paged read of each decoder layer's
# self-attention over its dense cache, the decoder's 18 LayerNorms
TF_DECODE_WANT = dict(dict.fromkeys(TF_WANT, 0), paged_attention=TF_LAYERS,
                      layernorm=3 * TF_LAYERS)
TF_LOOP_EPOCHS, TF_LOOP_VOCAB = 2, 100


def _example(name, folder="examples"):
    """An example module of the port (``examples/<name>.py``)."""
    root = str(Path(__file__).resolve().parent / folder)
    if root not in sys.path:
        sys.path.insert(0, root)
    return __import__(name)


def _tool(name):
    """A script of ``tools/`` as a module."""
    return _example(name, folder="tools")


def _tf_batches(vocab=TF_VOCAB, seed=TF_SEED):
    """The example's corpus in its buckets at B=64, by bucket width: each
    batch (src_ids, tgt_in, src_valid, tgt_out) as int32 tensors on the
    card, and its count of target tokens (not padding)."""
    ex = _example("torch_train_transformer_wmt")
    src, tgt = ex.synthetic_corpus(4096, vocab, seed=seed)
    out = collections.defaultdict(list)
    for s_ids, t_in, t_out, valid in ex.bucket_batches(src, tgt, TF_BUCKETS,
                                                       TF_B, seed):
        out[s_ids.shape[1]].append(
            (tuple(torch.from_numpy(a).cuda()
                   for a in (s_ids, t_in, valid, t_out)),
             int((t_out != ex.PAD).sum())))
    return out


def tf_loss(out, labels):
    """The example's loss, the logits cast to f32 first (as bert_loss)."""
    from mxnet_tpu_torch.models.transformer import label_smoothing_loss

    return label_smoothing_loss(out.float(), labels, epsilon=0.1,
                                ignore_index=0)


def transformer_flops(b, ts, tt, num_layers, units, hidden, vocab):
    """Training FLOPs of a step at 2 a multiply-add, 3x the forward's
    matrix products: per layer the encoder's qkv and output projections and
    feed-forward on each source token with its scores and weighted sum
    (2 ts u), the decoder's self-attention the same on each target token,
    its cross-attention (query and output projections and 2 ts u a target
    token, key and value projections a source token) and feed-forward; the
    output projection on each target token."""
    u, h = units, hidden
    enc = ts * (4 * u * u + 2 * u * h + 2 * ts * u)
    dec = tt * (4 * u * u + 2 * u * h + 2 * tt * u) + \
        tt * (2 * u * u + 2 * ts * u) + ts * 2 * u * u
    fwd = 2 * b * (num_layers * (enc + dec) + tt * u * vocab)
    return 3 * fwd


def _tf_net(model, seed=TF_SEED, dropout=0.0, vocab=TF_VOCAB):
    from mxnet_tpu_torch.models import get_transformer

    t0 = time.perf_counter()
    net = get_transformer(model, dropout=dropout, device="cuda", seed=seed,
                          vocab_size=vocab)
    params = list(net.parameters())
    log(f"[{model}] dropout {dropout}, vocab {vocab}: {len(params)} "
        f"parameters, {sum(p.numel() for p in params)} elements, built in "
        f"{time.perf_counter() - t0:.1f}s")
    return net


def _tf_forward_run(net, batch, backward):
    """Logits and loss of ``net`` on ``batch`` (and with ``backward`` the
    gradients by name), with the launches of the call."""
    _reset_launch_counts()
    with torch.set_grad_enabled(backward):
        logits = net(*batch[:3])
        loss = tf_loss(logits, batch[3])
        grads = {}
        if backward:
            named = list(net.named_parameters())
            gs = torch.autograd.grad(loss, [p for _, p in named])
            grads = {n: g for (n, _), g in zip(named, gs)}
    torch.cuda.synchronize()
    return logits.detach(), loss.item(), grads, _launch_counts()


def phase_transformer_parity():
    """transformer_base at full width, f32, dropout 0, from one seeded
    ``.params`` file, on the first bucket-32 batch (ragged src_valid): the
    logits (LOGIT_TOL), the label-smoothed loss (TRAIN_LOSS_TOL) and the
    weights after one TrainStep Adam step (the sign-flip bound, at most 1%
    beyond 1e-2 * lr) with every kernel knob on against the plain versions.
    Then transformer_tiny (head dim 32: its causal self-attention takes the
    plain path by the dispatch rule, no flash launch) forward and backward
    on the card, logits and loss against the plain versions, and one
    amp="bfloat16" TrainStep step."""
    import tempfile

    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.optimizer import Adam

    (batch, _), = _tf_batches()[32][:1]
    valid = batch[2].tolist()
    valid = f"{min(valid)}..{max(valid)}"
    runs = []
    with tempfile.TemporaryDirectory() as d:
        fname = str(Path(d) / "transformer_base.params")
        _tf_net("transformer_base").save_parameters(fname)
        _release()
        for plain in (False, True):
            with plain_versions() if plain else contextlib.nullcontext():
                net = _tf_net("transformer_base", seed=TF_SEED + 1)
                net.load_parameters(fname)
                logits, loss, _, launches = _tf_forward_run(net, batch, False)
                ts = TrainStep(net, tf_loss, Adam(learning_rate=TRAIN_LR,
                                                  **TF_ADAM),
                               n_model_inputs=3, amp=None,
                               engine_type="naive")
                step_loss = float(ts(*batch))
                params = {n: p.detach().clone()
                          for n, p in net.named_parameters()}
            runs.append((logits, loss, step_loss, params, launches))
            del net, ts
            _release()
    (lk, sk, tk, pk, nk), (lp, sp, tp, pp, np_) = runs
    want_k = dict(dict.fromkeys(TF_WANT, 0), flash_fwd=TF_LAYERS,
                  layernorm=5 * TF_LAYERS)
    if nk != want_k or any(np_.values()):
        raise AssertionError(f"transformer parity: forward launches {nk} on "
                             f"the kernels (expected {want_k}), {np_} on the "
                             f"plain versions")
    logit_err = (lk - lp).abs().max().item()
    err = torch.cat([(pk[n] - pp[n]).abs().reshape(-1) for n in pk])
    worst, far = err.max().item(), (err > 1e-2 * TRAIN_LR).float().mean().item()
    res = {"max_abs_logit_err": logit_err, "loss_kernels": sk,
           "loss_plain": sp, "step_loss_kernels": tk, "step_loss_plain": tp,
           "max_weight_diff": worst, "weight_bound": 2.01 * TRAIN_LR,
           "share_beyond_1e-2_lr": far, "valid_length": valid}
    log(f"[transformer parity] transformer_base f32, B={TF_B} bucket 32, "
        f"src_valid {valid}: max |logit kernels - plain| {logit_err:.3e} "
        f"(limit {LOGIT_TOL[None]}); loss {sk} / {sp}; after one Adam step "
        f"(lr {TRAIN_LR}) max |weight diff| {worst:.3e} (bound "
        f"{2.01 * TRAIN_LR:.3e}), share beyond 1e-2*lr {far:.2e} (limit "
        f"1e-2); forward launches {nk}")
    rtol = TRAIN_LOSS_TOL[0]
    if not (torch.isfinite(lk).all() and logit_err <= LOGIT_TOL[None]
            and abs(sk - sp) <= rtol * abs(sp)
            and abs(tk - tp) <= rtol * abs(tp)
            and worst <= 2.01 * TRAIN_LR and far <= 1e-2):
        raise AssertionError(f"transformer parity: {res}")
    del runs, lk, lp, pk, pp, err
    _release()
    res["tiny"] = _transformer_tiny()
    return res


def _transformer_tiny():
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.optimizer import Adam

    vocab = 32000  # transformer_tiny's
    (batch, _), = _tf_batches(vocab)[32][:1]
    runs = []
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            net = _tf_net("transformer_tiny", vocab=vocab)
            runs.append(_tf_forward_run(net, batch, True))
    (lk, sk, gk, nk), (lp, sp, gp, _) = runs
    logit_err = (lk - lp).abs().max().item()
    grad_err = max(((gk[n] - gp[n]).norm() / gp[n].norm()).item()
                   for n in gk)
    want = dict(dict.fromkeys(TF_WANT, 0), layernorm=10, layernorm_bwd=10,
                layernorm_bwd_merge=10)
    log(f"[transformer_tiny] head dim 32 on the card, f32 forward and "
        f"backward: launches {nk} (no flash: the plain path by the "
        f"dispatch rule); max |logit kernels - plain| {logit_err:.3e}, loss "
        f"{sk} / {sp}, largest relative gradient difference {grad_err:.3e}")
    if nk != want or logit_err > LOGIT_TOL[None] or \
            abs(sk - sp) > TRAIN_LOSS_TOL[0] * abs(sp) or grad_err > 1e-4:
        raise AssertionError("transformer_tiny: the kernels' run differs "
                             "from the plain versions' or took flash")
    ts = TrainStep(net, tf_loss, Adam(learning_rate=1e-3, **TF_ADAM),
                   n_model_inputs=3, amp="bfloat16", engine_type="graph")
    amp_losses = [float(ts(*batch)) for _ in range(3)]
    if not all(np.isfinite(amp_losses)):
        raise AssertionError(f"transformer_tiny bf16 losses {amp_losses}")
    log(f"[transformer_tiny] 3 TrainStep(amp='bfloat16') graph steps: "
        f"losses {amp_losses}")
    del net, ts
    _release()
    return {"max_abs_logit_err": logit_err, "loss_kernels": sk,
            "loss_plain": sp, "grad_rel_err": grad_err, "launches": nk,
            "bf16_losses": amp_losses}


def _tf_step(net, engine_type):
    """The TrainStep of the ``transformer`` turns: amp="bfloat16", Adam
    (beta2 0.98, epsilon 1e-9) on the example's InvSqrtWarmup."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.optimizer import Adam

    ex = _example("torch_train_transformer_wmt")
    sched = ex.InvSqrtWarmup(net._units, TF_WARMUP, scale=TF_LR_SCALE)
    return TrainStep(net, tf_loss, Adam(learning_rate=sched(1),
                                        lr_scheduler=sched, **TF_ADAM),
                     n_model_inputs=3, amp="bfloat16",
                     engine_type=engine_type)


def _device_groups(fn, n, what, step_ms):
    """Device time of one of ``n`` calls of ``fn`` under the profiler, by
    the kernel groups of tools/torch_train_profile.py (``group_of``, the
    table the ResNet, BERT and GPT-2 breakdowns use) and by kernel (the 8
    largest), and the idle share against ``step_ms``, the untraced wall
    time of one call."""
    from torch.profiler import ProfilerActivity, profile

    group_of = _tool("torch_train_profile").group_of
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    groups, kernels = collections.Counter(), collections.Counter()
    ops = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0)))
        groups[group_of(evt.key)] += us / n / 1e3
        kernels[evt.key[:90]] += us / n / 1e3
        ops += evt.count
    device = sum(groups.values())
    res = {"device_ms": device, "step_ms": step_ms,
           "idle_share": 1 - device / step_ms if device else None,
           "device_ops": ops / n, "by_group_ms": dict(groups.most_common()),
           "top_kernels_ms": {k: round(v, 4)
                              for k, v in kernels.most_common(8)}}
    log(f"[{what}] {n} calls under the profiler: device "
        f"{device:.3f} ms of a {step_ms:.3f} ms call (idle share "
        f"{res['idle_share']}), {ops / n:.0f} device operations; by group "
        f"{ {g: round(v, 3) for g, v in groups.most_common()} }"
        if device else f"[{what}] the profiler recorded no device time: "
        f"not measured")
    return res


def phase_transformer(net, init, engine_type, card, batches, model,
                      steps=10, name="transformer", breakdown=False):
    """``model`` at full width through ``_tf_step`` from the weights
    ``init``: two batches of each bucket in turn (each bucket's step
    program made and, under "graph", captured), then ``steps`` timed steps
    of bucket-32 batches. Every step launches TF_WANT (LayerNorm on bf16 x
    and the bf16 copies of gamma and beta), four programs in all, every
    loss finite (the targets are uniform over 36,497 ids, so 18 steps do
    not move the loss off ln(vocab); phase_transformer_loop shows it
    fall over an epoch). Reports ms a bucket-32
    step, target tokens/s, MFU (transformer_flops over 989 TFLOP/s) and
    peak memory; after a "graph" run a profiled replay of each program
    (check_replay_launches) and, with ``breakdown``, the bucket-32 graph's
    device time by kernel group."""
    from mxnet_tpu_torch.models.transformer import transformer_configs

    cfg = transformer_configs[model]
    _restore(net, init)
    ts = _tf_step(net, engine_type)
    warm = [batches[b][i] for i in range(2) for b in TF_BUCKETS]
    pool = batches[32][2:]
    timed = [pool[i % len(pool)] for i in range(steps)]
    tokens = sum(n for _, n in timed)
    total = dict.fromkeys(TF_WANT, 0)
    losses = []
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    what = f"{name} {engine_type}"
    with _ln_dtypes() as ln_pairs:
        for i, (batch, _) in enumerate(warm + timed):
            if i == len(warm):
                torch.cuda.synchronize()
                t = time.perf_counter()
            before = _launch_counts()
            losses.append(ts(*batch))
            got = {k: v - before[k] for k, v in _launch_counts().items()}
            if got != TF_WANT:
                raise AssertionError(f"{what} step {i}: launches {got}, "
                                     f"expected {TF_WANT}")
            for k in total:
                total[k] += got[k]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    bf = torch.bfloat16
    if set(ln_pairs) != {("fwd", bf, bf), ("bwd", bf, bf)}:
        raise AssertionError(f"{what}: LayerNorm ran on (x, gamma) dtypes "
                             f"{dict(ln_pairs)}")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what} losses {losses}: not finite")
    if ts.compiled_programs != len(TF_BUCKETS):
        raise AssertionError(f"{what}: {ts.compiled_programs} programs, "
                             f"one a bucket expected")
    flops = transformer_flops(TF_B, 32, 32, cfg["num_layers"], cfg["units"],
                              cfg["hidden_size"], TF_VOCAB)
    ms = wall / steps * 1e3
    res = {"engine_type": engine_type, "model": model, "ms_per_step": ms,
           "target_tokens_per_s": tokens / wall,
           "flops_per_step": flops, "mfu": flops / (ms * 1e-3)
           / BF16_TC_FLOPS_PER_S, "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "programs": ts.compiled_programs, "losses": losses,
           "steps": steps, "warmup": len(warm), "card": card}
    log(f"[{what}] {model} B={TF_B} bucket 32, {steps} timed steps: "
        f"{ms:.2f} ms/step, {res['target_tokens_per_s']:.0f} target "
        f"tokens/s, MFU {res['mfu']:.4f} ({flops:.4e} flops a step over "
        f"989 TFLOP/s), peak {res['peak_bytes'] / 2**30:.2f} GiB allocated "
        f"/ {res['peak_reserved_bytes'] / 2**30:.2f} reserved, "
        f"{ts.compiled_programs} programs; losses "
        f"{['%.4f' % x for x in losses]} on {card}")
    state = _state(ts, host=True)
    if engine_type == "graph":
        for key, (prog, _, _) in ts._programs.items():
            width = key[1][0][0][1]
            check_replay_launches(prog, f"{what} bucket {width} step graph")
            if breakdown and width == 32:
                res["breakdown"] = _device_groups(
                    prog.graph.replay, 5, f"{what} bucket 32", ms)
    del ts
    _release()
    return total, res, state


def _masked_attention_ms(h, d=64, t=32):
    """Device ms of one layer's masked attention at a bucket-32 step's bf16
    shapes, forward and backward through ``multi_head_attention``: the
    encoder's self-attention on q, k and v from one (B, T, 3, H, D)
    projection and the decoder's cross-attention (queries from one
    projection, keys and values from another), each with the ragged
    (B, 1, 1, T) key-padding mask (CUDA graph replay)."""
    from mxnet_tpu_torch.ops.attention import multi_head_attention

    gen = torch.Generator().manual_seed(4)
    dev, bf = torch.device("cuda"), torch.bfloat16
    qkv = torch.randn(TF_B, t, 3, h, d, generator=gen).to(dev, bf) \
        .requires_grad_()
    kv = torch.randn(TF_B, t, 2, h, d, generator=gen).to(dev, bf) \
        .requires_grad_()
    valid = torch.randint(t // 2, t + 1, (TF_B,), generator=gen).to(dev)
    mask = torch.arange(t, device=dev).reshape(1, 1, 1, t) < \
        valid.reshape(-1, 1, 1, 1)
    cot = torch.randn(TF_B, h, t, d, generator=gen).to(dev, bf)

    def encoder():
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = multi_head_attention(q, k, v, mask=mask)
        torch.autograd.grad(out, qkv, cot)

    def cross():
        q = qkv[:, :, 0].transpose(1, 2)
        k, v = kv.permute(2, 0, 3, 1, 4)
        out = multi_head_attention(q, k, v, mask=mask)
        torch.autograd.grad(out, (qkv, kv), cot)

    return graph_time_ms(encoder, calls=2), graph_time_ms(cross, calls=2)


def phase_transformer_turns(card):
    """``phase_transformer`` at transformer_base under MODE_TURNS from one
    start (``_turns``): losses, weights, masters and Adam moments
    bit-identical across naive, graph, graph, naive; then the masked
    attention's device time (encoder and cross, 6 layers each) against
    the step; then transformer_big as a graph from the same batches.
    Returns the launches of base's first graph run and of big's, and the
    metrics."""
    batches = _tf_batches()
    counts = {b: len(v) for b, v in batches.items()}
    log(f"[transformer] batches of {TF_B} by bucket: {counts}")
    net = _tf_net("transformer_base")
    init = [p.detach().clone() for _, p in sorted(net.named_parameters())]
    first = {}

    def run(mode):
        out = phase_transformer(net, init, mode, card, batches,
                                "transformer_base",
                                breakdown=mode == "graph" and not first)
        if mode == "graph" and not first:
            first.update(out[1])
        return out

    launches, runs = _turns("transformer", run)
    del init, net
    _release()
    enc_ms, cross_ms = _masked_attention_ms(8)
    step_ms = first["ms_per_step"]
    masked = {"encoder_ms_per_layer": enc_ms, "cross_ms_per_layer": cross_ms,
              "per_step_ms": TF_LAYERS * (enc_ms + cross_ms),
              "step_ms": step_ms}
    masked["share_of_step"] = masked["per_step_ms"] / step_ms
    log(f"[transformer masked attention] bf16 B={TF_B} H=8 T=32 D=64 with "
        f"the ragged key-padding mask, forward + backward, device: encoder "
        f"{enc_ms * 1e3:.1f} us, cross {cross_ms * 1e3:.1f} us a layer; x6 "
        f"layers each {masked['per_step_ms']:.3f} ms = "
        f"{100 * masked['share_of_step']:.1f}% of a {step_ms:.2f} ms graph "
        f"step on {card}")
    big = _tf_net("transformer_big")
    init = [p.detach().clone() for _, p in sorted(big.named_parameters())]
    big_launches, big_res, state = phase_transformer(
        big, init, "graph", card, batches, "transformer_big",
        name="transformer_big", breakdown=True)
    del big, init, state, batches
    _release()
    return launches, runs, masked, big_launches, big_res


def phase_transformer_decode(card, steps=32, cache_len=64):
    """Greedy cached decode with transformer_base (f32, seed TF_SEED,
    dropout 0): encode a bucket-32 batch of 64 sources (ragged src_valid),
    then ``steps`` ``decode_step`` calls of one token each over
    ``init_decode_cache`` (dense (B, 8, 64, 64) buffers a layer, read by
    the paged kernel), each launching TF_DECODE_WANT. The per-step logits
    must agree with one teacher-forced forward on the decoded tokens
    within LOGIT_TOL (the flash kernels and the paged read sum in other
    orders). Reports ms a decode step and tokens/s (steps 1 on), and the
    device time of four more steps under the profiler by kernel group,
    with the idle share against the untraced step."""
    (batch, _), = _tf_batches()[32][:1]
    net = _tf_net("transformer_base")
    net.eval()
    src, valid = batch[0], batch[2]
    total = dict.fromkeys(TF_DECODE_WANT, 0)
    with torch.no_grad():
        mem, mask = net.encode(None, src, valid)
        cache = net.init_decode_cache(TF_B, cache_len)
        tok = torch.ones((TF_B, 1), dtype=torch.int32, device="cuda")
        toks, logits = [], []
        _reset_launch_counts()
        torch.cuda.synchronize()
        for t in range(steps):
            if t == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = _launch_counts()
            pos = torch.full((TF_B,), t, dtype=torch.int32, device="cuda")
            lg, cache = net.decode_step(tok, mem, mask, cache=cache,
                                        start_pos=pos)
            got = {k: v - before[k] for k, v in _launch_counts().items()}
            if got != TF_DECODE_WANT:
                raise AssertionError(f"transformer decode step {t}: "
                                     f"launches {got}, expected "
                                     f"{TF_DECODE_WANT}")
            for k in total:
                total[k] += got[k]
            tok = lg[:, -1].argmax(-1, keepdim=True).int()
            toks.append(tok)
            logits.append(lg[:, -1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tgt = torch.cat([torch.ones_like(toks[0])] + toks[:-1], dim=1)
        full = net(src, tgt, valid)
    logits = torch.stack(logits, dim=1)
    err = (logits - full).abs().max().item()
    ms = wall / (steps - 1) * 1e3
    res = {"ms_per_decode_step": ms,
           "tokens_per_s": TF_B * (steps - 1) / wall,
           "max_abs_logit_err": err, "steps": steps, "batch": TF_B,
           "cache_len": cache_len, "card": card}
    log(f"[transformer decode] transformer_base f32 greedy, B={TF_B}, "
        f"{steps} steps of one token over a {cache_len}-slot cache: "
        f"{ms:.3f} ms/step, {res['tokens_per_s']:.0f} tokens/s; max |decode "
        f"logits - teacher-forced forward| {err:.3e} (limit "
        f"{LOGIT_TOL[None]}); launches a step "
        f"{ {k: v for k, v in TF_DECODE_WANT.items() if v} } on {card}")
    if not torch.isfinite(logits).all() or err > LOGIT_TOL[None]:
        raise AssertionError(f"transformer decode: logits differ from the "
                             f"full forward by {err}")
    state = {"tok": tok, "cache": cache, "t": steps}

    def one_step():
        pos = torch.full((TF_B,), state["t"], dtype=torch.int32,
                         device="cuda")
        lg, state["cache"] = net.decode_step(state["tok"], mem, mask,
                                             cache=state["cache"],
                                             start_pos=pos)
        state["tok"] = lg[:, -1].argmax(-1, keepdim=True).int()
        state["t"] += 1

    with torch.no_grad():
        res["profile"] = _device_groups(one_step, 4, "transformer decode "
                                        "step", ms)
    del net, mem, cache, full, logits, state
    _release()
    return total, res


def phase_transformer_loop(card, profile_at=(40, 45)):
    """The example's own loop (examples/torch_train_transformer_wmt.py
    ``train``): transformer_base f32 at dropout 0.1 and its published
    width (36,500 ids, the example's ``build_net`` at ``--vocab-size
    36500``, passed as ``net=``), eager record / backward /
    Trainer("adam").step(1) over TF_LOOP_EPOCHS epochs of the corpus
    (about 62 steps each in the four buckets), at ``--vocab-size 100
    --warmup-steps 16 --lr-scale 0.1``, logging every 8 steps. Only the
    corpus is cut to 100 ids: drawn from all 36,500, each id occurs about
    twice an epoch and the loss stays near ln(vocab) for longer than a
    phase; over 100 the reverse task is learnable within it. Every step
    launches TF_WANT; the logged loss falls. Reports ms a step from step 8
    on (host clock, synced at both ends) and the host share over steps
    ``profile_at`` (1 - device time / wall time, the profiler on; and
    against the untraced steps' wall time)."""
    from torch.profiler import ProfilerActivity, profile

    ex = _example("torch_train_transformer_wmt")
    args = ex.build_parser().parse_args(
        ["--device", "gpu", "--epochs", str(TF_LOOP_EPOCHS), "--vocab-size",
         str(TF_LOOP_VOCAB), "--warmup-steps", str(TF_WARMUP), "--lr-scale",
         str(TF_LR_SCALE), "--log-interval", "8", "--seed", str(TF_SEED)])
    full = ex.build_parser().parse_args(
        ["--device", "gpu", "--vocab-size", str(TF_VOCAB), "--seed",
         str(TF_SEED)])
    net = ex.build_net(full, ex.mx.gpu())
    if net.out_proj.weight.shape[0] != TF_VOCAB:
        raise AssertionError(f"transformer loop: the net's output layer has "
                             f"{net.out_proj.weight.shape[0]} ids, not "
                             f"{TF_VOCAB}")
    marks, counts = {}, {}
    total = dict.fromkeys(TF_WANT, 0)
    prof = profile(activities=[ProfilerActivity.CUDA])
    _reset_launch_counts()

    def on_step(step, loss, tokens):
        now = _launch_counts()
        if counts:
            got = {k: v - counts[k] for k, v in now.items()}
            if got != TF_WANT:
                raise AssertionError(f"transformer loop step {step}: "
                                     f"launches {got}, expected "
                                     f"{TF_WANT}")
            for k in total:
                total[k] += got[k]
        counts.update(now)
        if step in (8,) + tuple(profile_at):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()
        if step == profile_at[0]:
            prof.__enter__()
        elif step == profile_at[1]:
            prof.__exit__(None, None, None)
        marks["last"] = (step, time.perf_counter())

    real_accuracy = ex.token_accuracy

    def accuracy(*a):
        # the epoch's evaluation forwards launch too: count from after them
        out = real_accuracy(*a)
        counts.update(_launch_counts())
        return out

    ex.token_accuracy = accuracy
    t0 = time.perf_counter()
    try:
        history = ex.train(args, net=net, on_step=on_step)
    finally:
        ex.token_accuracy = real_accuracy
    torch.cuda.synchronize()
    last_step, _ = marks["last"]
    wall = time.perf_counter() - t0
    device_ms = sum(
        float(getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)))
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    n_prof = profile_at[1] - profile_at[0]
    prof_wall = (marks[profile_at[1]] - marks[profile_at[0]]) * 1e3
    step_ms = (marks[profile_at[0]] - marks[8]) * 1e3 / (profile_at[0] - 8)
    res = {"steps": last_step, "losses_logged": history,
           "ms_per_step": step_ms,
           "profiled_ms_per_step": prof_wall / n_prof,
           "device_ms_per_step": device_ms / n_prof,
           "host_share": 1 - device_ms / prof_wall if device_ms else None,
           "host_share_untraced":
               1 - device_ms / n_prof / step_ms if device_ms else None,
           "vocab": net.src_embed.weight.shape[0],
           "corpus_vocab": TF_LOOP_VOCAB,
           "wall_s_with_eval": wall, "warmup_steps": TF_WARMUP,
           "lr_scale": TF_LR_SCALE, "card": card}
    log(f"[transformer loop] examples/torch_train_transformer_wmt.py train(), "
        f"transformer_base f32 dropout 0.1, vocab {res['vocab']}, "
        f"corpus of {TF_LOOP_VOCAB} ids, {last_step} steps "
        f"(--warmup-steps {TF_WARMUP} --lr-scale {TF_LR_SCALE}): "
        f"{res['ms_per_step']:.2f} ms/step (steps 8-{profile_at[0]}); steps "
        f"{profile_at[0]}-{profile_at[1]} under the profiler "
        f"{res['profiled_ms_per_step']:.2f} ms/step, device "
        f"{res['device_ms_per_step']:.2f}, host share {res['host_share']} "
        f"(against the untraced steps {res['host_share_untraced']}); "
        f"logged losses {['%.4f' % x for x in history]} on {card}")
    # each logged loss is one batch's, of one of four buckets: compare the
    # means of the first and the last quarter of them
    q = max(len(history) // 4, 1)
    res["first_quarter_mean"] = float(np.mean(history[:q]))
    res["last_quarter_mean"] = float(np.mean(history[-q:]))
    log(f"[transformer loop] mean logged loss, first quarter "
        f"{res['first_quarter_mean']:.4f}, last quarter "
        f"{res['last_quarter_mean']:.4f}")
    if len(history) < 8 or not all(np.isfinite(history)) or \
            not res["last_quarter_mean"] < res["first_quarter_mean"]:
        raise AssertionError(f"transformer loop: losses {history} do not "
                             f"fall")
    del net
    _release()
    return total, res


def phase_mnist(card, epochs=4):
    """examples/torch_train_mnist.py's route (``train``): the synthetic
    MNIST (8192 training images) -> DataLoader (B=128, shuffled) -> the
    zoo's LeNet -> Trainer("adam") -> metric.Accuracy, ``epochs`` epochs
    of 64 steps, each step launching the xent pair and one Adam. The
    training accuracy rises from the first epoch to the last. Reports ms a
    step and the share of the loop's host time spent waiting on the
    DataLoader."""
    tm = _example("torch_train_mnist")
    args = tm.build_parser().parse_args(["--device", "gpu", "--epochs",
                                         str(epochs)])
    counts = {}
    total = dict.fromkeys(LENET_WANT, 0)
    _reset_launch_counts()

    def on_step(step, loss):
        now = _launch_counts()
        got = {k: v - counts.get(k, 0) for k, v in now.items()}
        if got != LENET_WANT:
            raise AssertionError(f"mnist step {step}: launches {got}, "
                                 f"expected {LENET_WANT}")
        for k in total:
            total[k] += got[k]
        counts.update(now)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = tm.train(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = history[-1]["steps"]
    wait = sum(h["wait_s"] for h in history)
    busy = sum(h["step_s"] for h in history)
    res = {"steps": steps, "epochs": history,
           "ms_per_step": busy / steps * 1e3,
           "data_wait_share": wait / (wait + busy),
           "wall_s_with_eval": wall, "card": card}
    log(f"[mnist] examples/torch_train_mnist.py train(), {steps} steps of "
        f"B=128: {res['ms_per_step']:.2f} ms/step (host clock, eager), "
        f"data-wait share {res['data_wait_share']:.3f}; accuracy by epoch "
        f"{[round(h['train_acc'], 4) for h in history]} (validation "
        f"{[round(h['val_acc'], 4) for h in history]}) on {card}")
    if not history[-1]["train_acc"] > history[0]["train_acc"] or \
            not np.isfinite(history[-1]["loss"]):
        raise AssertionError(f"mnist: accuracy {history} does not rise")
    _release()
    return total, res


def phase_transformer_timing(card):
    """The kernels at the Transformer's shapes: flash forward, dK/dV and
    dQ at (64, 8, 32, 32, D 64) causal in bf16 (the ``transformer`` step)
    and f32 (the example's loop); LayerNorm forward and backward in bf16
    at (2048, 512) (transformer_base, B=64 x T=32 rows) and (2048, 1024)
    (transformer_big); Adam over transformer_base's 196 tensors; and the
    paged read of a decode step (64 rows, 8 heads, Ch 64, 32 live keys a
    row of a 64-slot dense cache, identity table)."""
    from mxnet_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(14)
    dev = torch.device("cuda")
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        fwd, dkv, dq = _flash_rows(gen, TF_B, 8, 32, 64, dtype)
        rows["flash_fwd_transformer" + sfx] = fwd
        rows["flash_bwd_dkv_transformer" + sfx] = dkv
        rows["flash_bwd_dq_transformer" + sfx] = dq
    for d in (512, 1024):
        fwd, bwd, _ = _ln_rows(gen, TF_B * 32, torch.bfloat16, d=d)
        rows[f"layernorm_transformer_{d}"] = fwd
        rows[f"layernorm_bwd_transformer_{d}"] = bwd
    net = _tf_net("transformer_base")
    rows["adam_transformer"] = _adam_row(net, gen)
    del net
    _release()
    b, h, tmax, ch, L = TF_B, 8, 64, 64, 32
    k_buf = torch.randn(b, h, tmax, ch, generator=gen).to(dev)
    v_buf = torch.randn(b, h, tmax, ch, generator=gen).to(dev)
    table = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    position = torch.full((b,), L - 1, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, 1, ch, generator=gen).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, vh = k_buf[:, :, :L], v_buf[:, :, :L]
    rows["paged_attention_transformer"] = _timed(
        lambda: pa.paged_attention_read(q, k_buf, v_buf, table, position),
        lambda: pa.paged_attention_read_plain(q, k_buf, v_buf, table,
                                              position),
        lambda: sdpa(q, kh, vh),
        nbytes=4 * (2 * b * h * L * ch + 2 * b * h * ch) + 4 * 2 * b,
        flops=4 * b * h * L * ch,
        shape=f"paged_attention Transformer decode B={b} H={h} Tq=1 Ch={ch} "
              f"L={L} of a {tmax}-slot dense cache f32",
        plain_graph=False, dtype="3xtf32")
    rows["paged_attention_transformer"]["library"] = "SDPA on the history"
    return rows


# Serving runs: one dispatch counter and one launch formula for every
# serving phase
SERVE_LAUNCHES = ("layernorm", "layernorm_bwd", "layernorm_bwd_merge",
                  "paged_attention", "paged_attention_prefill")
DISPATCHES = ("prefill", "decode_step", "plain_step", "spec_step")


def _serving_launches():
    return {k: v for k, v in _launch_counts().items() if k in SERVE_LAUNCHES}


def _count_dispatches(eng):
    """Count the engine's dispatches that returned (a call that an
    injected fault stopped launched nothing) by name, their time
    (``<name>_s``), the decode tokens they emitted, the rounds' drafted
    and accepted tokens and the peak of pages in use; ``_uncount`` takes
    the wrappers off. The one dispatch counter of every serving phase."""
    calls = collections.Counter()

    def wrap(name):
        fn = getattr(eng, name)

        def counted(*a, **kw):
            active = int((~eng.done).sum())
            t = time.perf_counter()
            out = fn(*a, **kw)
            calls[name + "_s"] += time.perf_counter() - t
            calls[name] += 1
            if name == "spec_step":
                calls["tokens"] += int(out[1].sum())
                calls["drafted"] += eng.last_round_drafted
                calls["accepted"] += eng.last_round_accepted
            elif name != "prefill":
                calls["tokens"] += active
            calls["peak_pages"] = max(calls["peak_pages"], eng.pages_in_use)
            return out

        setattr(eng, name, counted)

    for name in DISPATCHES:
        wrap(name)
    return calls


def _uncount(eng):
    for name in DISPATCHES:
        eng.__dict__.pop(name, None)


def _steps(calls):
    """Decode steps of every kind (plain steps and speculative rounds) in
    ``calls`` and their seconds."""
    return (sum(calls[k] for k in DISPATCHES[1:]),
            sum(calls[k + "_s"] for k in DISPATCHES[1:]))


def _want_launches(calls, draft_layers=0):
    """The serving kernels' launches for ``calls`` (``_count_dispatches``),
    the one launch formula of every serving phase: a plain step 24 decode
    reads and 49 LayerNorms; a speculative round k + 1 draft steps (the
    draft's layers in decode reads, 2 LayerNorms a layer and the final
    one) and one verify (24 prefill-kernel reads, 49 LayerNorms); a
    prefill (every one reads more than one query, the prefill kernel) the
    target's forward and, on a speculative engine, the draft's. No
    backward."""
    nd, k = draft_layers, SPEC_K
    plain = calls["decode_step"] + calls["plain_step"]
    rounds, pre = calls["spec_step"], calls["prefill"]
    draft_ln = 2 * nd + 1 if nd else 0
    return {"paged_attention": 24 * plain + (k + 1) * nd * rounds,
            "paged_attention_prefill": (24 + nd) * pre + 24 * rounds,
            "layernorm": 49 * plain + ((k + 1) * draft_ln + 49) * rounds
            + (49 + draft_ln) * pre,
            "layernorm_bwd": 0, "layernorm_bwd_merge": 0}


def _check_launches(name, launches, want):
    """The path's launches are exactly ``want``, and each serving kernel
    ran on it."""
    if launches != want or not all(launches[k] for k in (
            "paged_attention", "paged_attention_prefill", "layernorm")):
        raise AssertionError(f"{name}: launch counts {launches}, expected "
                             f"{want}")


def _serve_run(net, engine_type, requests, sampling=None, warm=True,
               check=None, warm_samples=1, batcher_kw=None, **engine_kw):
    """Serve ``requests`` ((prompt, max_new_tokens[, samples]) tuples)
    through a paged engine (batch 8, page size 16, EOS 50256, the keywords
    ``engine_kw`` beside) and the continuous batcher, after warm-up
    requests when ``warm`` (see below). Returns the engine, the requests
    (with the ``samples`` of each group after its leader), the decode steps' logits
    in order, the call counts (``_count_dispatches``: prefills, decode
    steps or speculative rounds, their time, tokens, drafted and accepted
    tokens, peak pages in use), the launches of the run, its wall time and
    peak memory,
    each request's top-2 logit margins (``margins``: per output token,
    the plain decode's (top1 - top2) / max |logit|, for the near-tie rule)
    and the program count seen after each call (which must stay at the
    buckets used + the step programs + the copy-on-write program once
    it ran), and the pages each prefill adopted from the prefix cache
    (``adopted``).
    ``check(engine, batcher)`` runs after each batcher step;
    ``warm_samples`` forks the warm-up request that many ways, so that its
    first decode step runs the copy-on-write program once;
    ``batcher_kw`` are the batcher's knobs."""
    from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine

    eng = GenerationEngine(net, batch_size=8, max_length=1024, paged=True,
                           page_size=16, eos_id=50256, device="cuda",
                           sampling=sampling, engine_type=engine_type,
                           **engine_kw)
    calls = _count_dispatches(eng)
    buckets, logits, decoded, cowed, adopted = set(), [], [], [], []
    slot_of, rows = {}, {}  # slot -> the prompt's id; id -> logits rows
    prefill, decode_step = eng.prefill, eng.decode_step
    spec_step, dispatch_cow = eng.spec_step, eng._dispatch_cow

    def check_programs(what):
        steps = (2 if eng.speculative else 1) if decoded else 0
        want = len(buckets) + steps + (1 if cowed else 0)
        if eng.compiled_programs != want or len(eng._programs) != want:
            raise AssertionError(
                f"serve {engine_type} after {what}: {eng.compiled_programs} "
                f"programs ({len(eng._programs)} graphs), expected the "
                f"{len(buckets)} buckets used + {steps} step programs"
                f" + {1 if cowed else 0} copy-on-write")

    def checked_prefill(prompt, slot):
        suffix = eng.suffix_for(prompt)
        adopted.append((len(prompt) - suffix) // eng.page_size)
        buckets.add(eng.bucket_for(suffix))
        out = prefill(prompt, slot)
        slot_of[slot] = id(prompt)
        rows[id(prompt)] = [eng._last_logits[None]]
        check_programs("a prefill")
        return out

    def checked_decode():
        active = ~eng.done
        out = decode_step()
        logits.append(out[2])
        for slot in np.flatnonzero(active):
            if slot_of.get(slot) is not None:
                rows[slot_of[slot]].append(out[2][slot][None])
        decoded.append(True)
        check_programs("a decode step")
        return out

    def checked_round():
        active = ~eng.done
        toks, counts, done = spec_step()
        if (counts[active] < 1).any():
            raise AssertionError(f"spec {engine_type}: an active row emitted "
                                 f"no token in a round: {counts}")
        decoded.append(True)
        check_programs("a speculative round")
        return toks, counts, done

    def counted_cow(copies):
        if copies:
            cowed.append(True)
        return dispatch_cow(copies)

    def fork(src, dst, **kw):
        slot_of[dst] = None  # a fork's rows are no request's plain logits
        return fork_slot(src, dst, **kw)

    fork_slot = eng.fork_slot
    eng.prefill, eng.decode_step = checked_prefill, checked_decode
    eng.spec_step, eng._dispatch_cow = checked_round, counted_cow
    eng.fork_slot = fork
    batcher = ContinuousBatcher(eng, device="cuda", **(batcher_kw or {}))
    if warm:
        # warm-up requests outside the measured run (cuBLAS handles, the
        # allocator; under "graph" the captures of the programs they run):
        # ``warm`` itself when it is a list, else one 40-token request of
        # 12 new tokens, which takes 3 decode steps or speculative rounds
        # at least, so that the step programs are captured. The prefix
        # cache is emptied after them.
        for p, n in (warm if isinstance(warm, list) else
                     [(np.random.RandomState(9).randint(0, 50257, 40), 12)]):
            batcher.submit(p, max_new_tokens=n, samples=warm_samples)
        batcher.run()
        if eng.prefix_cache is not None:
            eng._evict_prefix(eng.num_pages)
        calls.clear()
        adopted.clear()
        logits.clear()
    groups = [batcher.submit(p, max_new_tokens=n, samples=(m or [1])[0])
              for p, n, *m in requests]
    reqs = [r for g in groups for r in (g.samples or [g])]
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t = time.perf_counter()
    while batcher.step():
        if check is not None:
            check(eng, batcher)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _serving_launches()
    margins = {}
    for r in reqs:
        if id(r.prompt) in rows and not r.forked:
            lg = torch.cat(rows[id(r.prompt)])
            top2 = lg.topk(2, dim=-1).values
            margins[r.id] = ((top2[:, 0] - top2[:, 1])
                             / lg.abs().amax(dim=-1)).cpu().numpy()
    return dict(eng=eng, reqs=reqs, logits=logits, calls=calls,
                adopted=adopted, launches=launches, wall=wall, buckets=buckets,
                margins=margins, peak=torch.cuda.max_memory_allocated(),
                peak_reserved=torch.cuda.max_memory_reserved())


def _serve_requests(n=16, max_new=64, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 50257, int(m)), max_new)
            for m in rs.randint(32, 501, n)]


def phase_serve(net, engine_type):
    """16 requests (prompts of 32-500 tokens, 64 new tokens each) through
    the paged engine and the batcher, gpt2_345m f32 at full width, under
    ``engine_type``: every request finishes, every forward launches 24
    attention reads and 49 LayerNorms (and no backward), and the engine has one program for
    each prefill bucket used plus the decode step, flat through the run.
    Returns the run (``_serve_run``) and its metrics."""
    run = _serve_run(net, engine_type, _serve_requests())
    eng, reqs, calls, launches = (run["eng"], run["reqs"], run["calls"],
                                  run["launches"])
    reasons = [r.finish_reason for r in reqs]
    if any(r is None for r in reasons):
        raise AssertionError(f"unfinished requests: {reasons}")
    for r in reqs:
        if not 1 <= len(r.output) <= 64 or \
                not all(0 <= x < 50257 for x in r.output):
            raise AssertionError(f"request {r.id}: bad output {r.output[:8]}")
    steps, steps_s = _steps(calls)
    _check_launches(f"serve {engine_type}", launches, _want_launches(calls))
    ttft = sorted(r.ttft for r in reqs)
    used = {eng.bucket_for(len(r.prompt)) for r in reqs} | {eng.bucket_for(40)}
    if eng.compiled_programs != len(used) + 1:
        raise AssertionError(f"serve: {eng.compiled_programs} programs for "
                             f"{len(used)} buckets used + 1")
    res = {"engine_type": engine_type,
           "ttft_p50_ms": statistics.median(ttft) * 1e3,
           "decode_ms_per_step": steps_s / steps * 1e3,
           "decode_tokens_per_s": calls["tokens"] / steps_s,
           "wall_s": run["wall"], "prefills": calls["prefill"],
           "decode_steps": steps,
           "compiled_programs": eng.compiled_programs,
           "peak_bytes": run["peak"],
           "peak_reserved_bytes": run["peak_reserved"]}
    log(f"[serve {engine_type}] {len(reqs)} requests, prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, finish reasons "
        f"{ {x: reasons.count(x) for x in set(reasons)} }")
    log(f"[serve {engine_type}] wall {run['wall']:.2f}s, {calls['prefill']} "
        f"prefills, {steps} decode steps; TTFT p50 "
        f"{res['ttft_p50_ms']:.1f} ms (queue wait included), decode "
        f"{res['decode_tokens_per_s']:.1f} tokens/s "
        f"({res['decode_ms_per_step']:.2f} ms/step); peak memory "
        f"{run['peak'] / 2**30:.2f} GiB (reserved "
        f"{run['peak_reserved'] / 2**30:.2f}); {eng.compiled_programs} "
        f"programs = {len(used)} prefill buckets used + 1 decode, flat")
    log(f"[serve {engine_type}] launches in the run: {launches} (24 "
        f"attention reads, decode or prefill, and 49 LayerNorms per "
        f"forward)")
    if engine_type == "graph":  # replays more of each: after the run
        graphs = {key[0]: prog for key, prog in eng._programs.items()
                  if prog.graph is not None}
        # the prefill graphs share the last-token index, which the last
        # prefill set (it may lie past a smaller bucket): row 0 is in each
        eng._in_last.zero_()
        if ("decode", 8, "paged") not in graphs:
            raise AssertionError(f"serve: no decode graph in {list(graphs)}")
        for sig, prog in sorted(graphs.items(), key=str):
            check_replay_launches(prog, f"serve {sig} step graph")
    return run, res


def _same_serving(a, b):
    """Tokens of every request and the logits of every decode step equal."""
    return [r.output for r in a["reqs"]] == [r.output for r in b["reqs"]] \
        and len(a["logits"]) == len(b["logits"]) \
        and all(torch.equal(x, y) for x, y in zip(a["logits"], b["logits"]))


def phase_serve_turns(net):
    """``phase_serve`` under MODE_TURNS: greedy tokens and every decode
    step's logits bit-identical across the runs. Returns the launches of
    the first "graph" run (the main path), the runs' metrics and the
    reference for the speculative runs (``_reference``). No run keeps its
    engine past its end, so that each run's peak memory is its own."""
    runs, ref, launches = [], None, None
    for mode in MODE_TURNS:
        run, res = phase_serve(net, mode)
        del run["eng"]
        if ref is None:
            ref = run
        elif not _same_serving(run, ref):
            raise AssertionError(f"serve: the {mode} run's tokens or decode "
                                 f"logits differ from the first run's")
        if mode == "graph" and launches is None:
            launches = run["launches"]
        runs.append(res)
        del run
        _release()
    steps = len(ref["logits"])
    plain = _reference(ref)
    del ref
    log(f"[serve] {' '.join(MODE_TURNS)}: tokens and the logits of all "
        f"{steps} decode steps bit-identical across the runs; decode ms/step "
        f"{[round(r['decode_ms_per_step'], 2) for r in runs]}, TTFT p50 ms "
        f"{[round(r['ttft_p50_ms'], 1) for r in runs]}")
    return launches, runs, plain


def _reference(run):
    """A plain run's tokens and top-2 margins, request by request, for
    ``near_ties``."""
    return [(r.output, run["margins"].get(r.id)) for r in run["reqs"]]


def near_ties(what, reqs, ref):
    """Hold each request's tokens against the plain run's ``ref``
    (``_reference``, same order): where the two first differ, the plain
    run's two largest logits must lie within ``LOGIT_TOL[None]`` times
    that row's largest |logit| of each other (a near-tie that another
    kernel's rounding may flip); any other divergence fails. Returns the
    near-ties."""
    tol, ties = LOGIT_TOL[None], []
    for r, (want, margin) in zip(reqs, ref):
        got = r.output
        if got == want:
            continue
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        if margin is None or j >= len(margin) or margin[j] >= tol:
            raise AssertionError(
                f"{what}: request {r.id} leaves the plain run's tokens at "
                f"token {j} ({got[j:j + 4]} / {want[j:j + 4]}), where the "
                f"plain run's top-2 margin is "
                f"{None if margin is None or j >= len(margin) else margin[j]}"
                f" of its largest |logit| (a near-tie is < {tol})")
        ties.append((r.id, j, float(margin[j])))
    return ties


# ---------------------------------------------------------------------------
# Speculative decoding, the prefix cache and forks at full width: the
# gpt2_345m serve net as the target, gpt2_117m (seed 1) as the draft
SPEC_K = 4


def _graph_replays(eng, what):
    """After a "graph" run: one profiled replay of each captured graph
    that launches the port's kernels (``check_replay_launches``). The
    prefill graphs share the last-token index, which the last prefill set
    (it may lie past a smaller bucket): row 0 is in each."""
    eng._in_last.zero_()
    for key, prog in sorted(eng._programs.items(), key=str):
        if prog.graph is not None and prog.launches:
            check_replay_launches(prog, f"{what} {key[0]} step graph")


def _serve_metrics(name, run, draft_layers=0):
    """Every request finished with an output in range, the run's launches
    are ``_want_launches``' for its dispatches, and the run's metrics."""
    reqs, calls, launches = run["reqs"], run["calls"], run["launches"]
    reasons = [r.finish_reason for r in reqs]
    if any(r is None for r in reasons):
        raise AssertionError(f"{name}: unfinished requests: {reasons}")
    for r in reqs:
        if not 1 <= len(r.output) <= r.max_new_tokens or \
                not all(0 <= x < 50257 for x in r.output):
            raise AssertionError(f"{name}: request {r.id}: bad output "
                                 f"{r.output[:8]}")
    _check_launches(name, launches, _want_launches(calls, draft_layers))
    steps, steps_s = _steps(calls)
    ttft = sorted(r.ttft for r in reqs)
    res = {"ttft_p50_ms": statistics.median(ttft) * 1e3,
           "ms_per_step": steps_s / steps * 1e3,
           "tokens_per_s": calls["tokens"] / steps_s,
           "wall_s": run["wall"], "prefills": calls["prefill"],
           "steps": steps, "tokens": calls["tokens"],
           "peak_pages": calls["peak_pages"],
           "compiled_programs": run["eng"].compiled_programs,
           "peak_bytes": run["peak"], "launches": launches}
    if calls["drafted"]:
        res["accept_rate"] = calls["accepted"] / calls["drafted"]
    log(f"[{name}] {len(reqs)} requests, finish reasons "
        f"{ {x: reasons.count(x) for x in set(reasons)} }; wall "
        f"{run['wall']:.2f}s, {calls['prefill']} prefills, {steps} "
        f"steps of {res['ms_per_step']:.2f} ms, {res['tokens_per_s']:.1f} "
        f"tokens/s, TTFT p50 {res['ttft_p50_ms']:.1f} ms, peak "
        f"{calls['peak_pages']} pages in use, "
        f"{run['eng'].compiled_programs} programs"
        + (f", accept rate {res['accept_rate']:.4f} "
           f"({calls['accepted']}/{calls['drafted']})"
           if calls["drafted"] else ""))
    log(f"[{name}] launches in the run: {launches}")
    return res


def _spec_run(name, net, draft, mode, requests, sampling=None):
    """A speculative serve run (``_serve_run``, k = SPEC_K), its launches
    ``_want_launches``' for its rounds and prefills. The programs are the
    buckets used + draft + verify. The
    speculation governor's floor is 0, so that every step is a round
    whatever the accept rate (``phase_governed`` runs the governor)."""
    run = _serve_run(net, mode, requests, sampling=sampling, draft_net=draft,
                     speculate_k=SPEC_K, batcher_kw={"spec_floor": 0.0})
    res = _serve_metrics(name, run, draft._num_layers)
    eng = run["eng"]
    if eng.compiled_programs != len(run["buckets"]) + 2:
        raise AssertionError(f"{name}: {eng.compiled_programs} programs for "
                             f"{len(run['buckets'])} buckets used + 2")
    return run, res


def phase_spec(net, draft, plain):
    """Speculative serving of the serve phase's 16 requests at full width:
    gpt2_345m f32 verifying gpt2_117m's drafts, k = SPEC_K, greedy, naive
    then graph: the two runs' tokens bit-identical, and the plain serve
    run's tokens under the near-tie rule (``near_ties``: the verify reads
    through the tensor-core prefill kernel, plain decode through the
    decode kernel). Then the target as its own draft (every draft
    accepted), then top-k sampling with the gpt2_117m draft (every active
    row emits a token a round). Returns the launches of the graph run and
    the runs' metrics."""
    from mxnet_tpu_torch.inference import SamplingConfig

    reqs = _serve_requests()
    out, runs = {}, {}
    for mode in ("naive", "graph"):
        run, runs[mode] = _spec_run(f"spec {mode}", net, draft, mode, reqs)
        out[mode] = [r.output for r in run["reqs"]]
        if mode == "graph":
            ties = near_ties("spec", run["reqs"], plain)
            launches = run["launches"]
            _graph_replays(run["eng"], "spec")
        del run
        _release()
    if out["naive"] != out["graph"]:
        raise AssertionError("spec: graph and naive tokens differ")
    runs["graph"]["near_ties"] = ties
    log(f"[spec] naive and graph tokens bit-identical; against the plain "
        f"serve run {len(ties)} near-ties (request, token, margin) {ties}")
    run, runs["self"] = _spec_run("spec self-draft", net, net, "graph", reqs)
    if runs["self"]["accept_rate"] != 1.0:
        raise AssertionError(f"spec self-draft: accept rate "
                             f"{runs['self']['accept_rate']}, not 1.0")
    runs["self"]["near_ties"] = near_ties("spec self-draft", run["reqs"],
                                          plain)
    del run
    _release()
    topk = SamplingConfig(method="top_k", top_k=40, seed=7)
    run, runs["top_k"] = _spec_run("spec top-k", net, draft, "graph", reqs,
                                   sampling=topk)
    del run
    _release()
    return launches, runs


def _prefix_requests(n=16, seed=4):
    """A 384-token seeded shared prefix and ``n`` seeded suffixes of 8 to
    100 tokens, 32 new tokens each. The suffixes' lengths are seed 4's
    whatever ``seed``, so that other seeds use the same buckets."""
    rs = np.random.RandomState(seed)
    prefix = rs.randint(0, 50257, 384)
    return [(np.concatenate([prefix, rs.randint(0, 50257, int(m))]), 32)
            for m in np.random.RandomState(4).randint(8, 101, n)]


def phase_prefix(net):
    """The prefix requests (``_prefix_requests``) at full width through a
    cold engine and one with ``prefix_cache=True`` (graph), each after two
    warm-up passes of other tokens (its cache emptied after them): every
    request
    after the first adopts the prefix's 24 pages, a hit adds no program,
    the tokens are the cold run's under the near-tie rule, and the peak of
    pages in use is lower. Returns the hit run's launches and both runs'
    metrics."""
    reqs, res = _prefix_requests(), {}
    # two warm-up passes of other tokens at the same lengths capture every
    # bucket's prefill graph before the timed run, so that TTFT pays no
    # capture
    warm = _prefix_requests(seed=5) + _prefix_requests(seed=6)
    for name, kw in (("cold", {}), ("hit", {"prefix_cache": True})):
        run = _serve_run(net, "graph", reqs, warm=warm, **kw)
        res[name] = _serve_metrics(f"prefix {name}", run)
        res[name]["adopted_pages"] = run["adopted"]
        if name == "cold":
            cold = _reference(run)
        else:
            launches = run["launches"]
            res[name]["near_ties"] = near_ties("prefix", run["reqs"], cold)
            _graph_replays(run["eng"], "prefix")
        del run
        _release()
    want = [0] + [384 // 16] * (len(reqs) - 1)
    if res["hit"]["adopted_pages"] != want \
            or any(res["cold"]["adopted_pages"]):
        raise AssertionError(f"prefix: adopted pages "
                             f"{res['hit']['adopted_pages']}, expected {want}")
    if not res["hit"]["peak_pages"] < res["cold"]["peak_pages"]:
        raise AssertionError(f"prefix: peak pages in use "
                             f"{res['hit']['peak_pages']} with the cache, "
                             f"{res['cold']['peak_pages']} cold")
    log(f"[prefix] every request after the first adopted 24 pages; TTFT p50 "
        f"{res['hit']['ttft_p50_ms']:.1f} ms hit, "
        f"{res['cold']['ttft_p50_ms']:.1f} ms cold; peak pages "
        f"{res['hit']['peak_pages']} hit, {res['cold']['peak_pages']} cold; "
        f"{len(res['hit']['near_ties'])} near-ties against the cold run")
    return launches, res


def phase_fork(net):
    """``samples=4`` with top-k sampling on two seeded 200-token prompts, 64
    new tokens, at full width, naive then graph (the warm-up request is
    forked too, so that the run's copy-on-write call is the graph's
    capture): after the forks the prompts' 12 full pages have refcount 4,
    the copy-on-write program is one ``("cow", 8)`` program, the tokens of
    the two runs are bit-identical and every page is free after the run.
    Returns the graph run's launches and the runs' metrics."""
    from mxnet_tpu_torch.inference import SamplingConfig

    rs = np.random.RandomState(6)
    reqs = [(rs.randint(0, 50257, 200), 64, 4) for _ in range(2)]
    topk = SamplingConfig(method="top_k", top_k=40, seed=11)
    out, res = {}, {}
    for mode in ("naive", "graph"):
        shared = []

        def check(eng, batcher):
            if not shared:  # after the step that admitted the groups
                for r in batcher._slots:
                    if r is not None and r.samples is not None:
                        pages = eng._row_pages[r.slot][:200 // 16]
                        shared.append(sorted({int(eng._page_rc[p])
                                              for p in pages}))

        run = _serve_run(net, mode, reqs, sampling=topk, warm_samples=2,
                         check=check)
        eng = run["eng"]
        res[mode] = _serve_metrics(f"fork {mode}", run)
        cow = [p for (sig, _), p in eng._programs.items() if sig[0] == "cow"]
        forked = [r.forked for r in run["reqs"]]
        if shared != [[4], [4]] or forked != [False, True, True, True] * 2:
            raise AssertionError(f"fork {mode}: refcounts {shared} of the "
                                 f"prompts' full pages, forked {forked}")
        if [s for s in eng._signatures if s[0] == "cow"] != [("cow", 8)] \
                or len(cow) != 1 or cow[0].calls != 2 \
                or cow[0].capture and cow[0].graph is None:
            raise AssertionError(f"fork {mode}: copy-on-write programs "
                                 f"{eng._signatures}, calls "
                                 f"{[p.calls for p in cow]}")
        if eng.free_pages != eng.num_pages:
            raise AssertionError(f"fork {mode}: {eng.free_pages} pages free "
                                 f"of {eng.num_pages} after the run")
        out[mode] = [r.output for r in run["reqs"]]
        if mode == "graph":
            launches = run["launches"]
        del run, eng, cow
        _release()
    if out["naive"] != out["graph"]:
        raise AssertionError("fork: graph and naive tokens differ")
    log(f"[fork] 2 prompts x 4 samples: full pages at refcount 4 after the "
        f"forks, one ('cow', 8) program (captured on its second call), "
        f"every page free after the run, naive and graph tokens "
        f"bit-identical")
    return launches, res


# ---------------------------------------------------------------------------
# Serving resilience at full width: tools/torch_servedrill.py's drill
# scaled to the serve engine, the speculation governor, the dispatch
# watchdog and overload control, each with telemetry on and its events read
# back
STALL_S, STALL_WATCHDOG_S = 0.5, 0.25
OVERLOAD = dict(bursts=(0, 20, 40), deadline_s=1.5, max_queue=16,
                shed_page_floor=32)


def _load_drill():
    """``tools/torch_servedrill.py`` as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "torch_servedrill.py"
    spec = importlib.util.spec_from_file_location("torch_servedrill", path)
    mod = sys.modules["torch_servedrill"] = \
        importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve_engine(net, engine_type="graph", **kw):
    from mxnet_tpu_torch.inference import GenerationEngine

    return GenerationEngine(net, batch_size=8, max_length=1024, paged=True,
                            page_size=16, eos_id=50256, device="cuda",
                            engine_type=engine_type, **kw)


@contextlib.contextmanager
def _telemetry(run_id):
    """Telemetry on into a temporary directory, the registry emptied
    first; yields the directory (its events are read back inside)."""
    import tempfile

    from mxnet_tpu_torch import observability as obs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        obs.REGISTRY.reset()
        obs.enable(d, run_id=run_id)
        try:
            yield d
        finally:
            obs.disable()


def _by_label(name, label=None):
    """A counter's total, or its values by ``label``, in the port's
    registry."""
    from mxnet_tpu_torch import observability as obs

    c = obs.REGISTRY.get(name)
    if label is None:
        return c.total() if c is not None else 0.0
    return {} if c is None else {k[label]: c.value(**k)
                                 for k in c.labelsets()}


def _events(d, name):
    from mxnet_tpu_torch import observability as obs

    return [e for e in obs.read_events(d) if e["event"] == name]


def phase_drill(net, draft):
    """``tools/torch_servedrill.py``'s drill at full width
    (``serve_plan``: the serve engine with the gpt2_117m draft, k =
    SPEC_K, faults every 3 / 5 / 4 at gen.prefill / gen.decode /
    gen.verify, a 1 ms retry backoff, deadlines on a fake clock, a
    cancellation, max_queue 8 with policy "shed", a page floor of 400,
    the governor at window 8, the watchdog armed at 30 s), in graph and
    then naive mode: ``validate`` passes in both (every finish reason
    explicit, deadline in the queue and in a slot, a cancellation, sheds
    on queue_full and on page_floor, fallback and re-arm, a failed retry
    at each site, survivors bit-identical to an undisturbed plain run and
    interrupted rows prefixes of it, 512 free pages after the drain, no
    reservation, no stall), and the two runs are bit-identical in tokens,
    finish reasons and counters. Returns the graph run's launches (the
    drill's traffic, after its baseline) and the runs' metrics."""
    sd = _load_drill()
    runs, res = {}, {}
    for mode in ("graph", "naive"):
        counted = {}

        def hook(eng, mode=mode):
            if mode == "graph":
                _reset_launch_counts()
                counted["calls"] = _count_dispatches(eng)

        with _telemetry(f"drill-{mode}") as d:
            t = time.perf_counter()
            run = sd.run_drill(net, draft, sd.serve_plan(), device="cuda",
                               engine_type=mode, max_steps=400,
                               telemetry_dir=d, speculate_k=SPEC_K,
                               engine_hook=hook)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if mode == "graph":
            launches, calls = _serving_launches(), counted["calls"]
        problems = sd.validate(run)
        if problems:
            raise AssertionError(f"drill {mode}: {problems}")
        runs[mode] = run
        reasons = [r["reason"] for r in run["requests"].values()]
        res[mode] = {"wall_s": wall, "steps": run["steps"],
                     "requests": len(reasons),
                     "reasons": {x: reasons.count(x) for x in set(reasons)},
                     "counters": run["counters"],
                     "shed_causes": run["port"]["shed_causes"],
                     "compiled_programs": run["port"]["compiled_programs"]}
        log(f"[drill {mode}] " + json.dumps(res[mode]))
        del run
        _release()
    keys = ("steps", "baseline", "requests", "counters", "events", "drained")
    diff = [k for k in keys if runs["graph"][k] != runs["naive"][k]]
    if diff or runs["graph"]["port"]["shed_causes"] != \
            runs["naive"]["port"]["shed_causes"]:
        raise AssertionError(f"drill: graph and naive differ in {diff}")
    _check_launches("drill", launches, _want_launches(calls,
                                                      draft._num_layers))
    res["graph"].update(launches=launches, dispatches={
        k: calls[k] for k in DISPATCHES})
    log(f"[drill] graph and naive bit-identical (tokens, reasons, counters, "
        f"events); launches {launches} for {dict(calls)}")
    return launches, res


def _governed_run(net, draft, requests, what):
    """The requests through the batcher over a speculative serve engine
    with the governor at its defaults, telemetry on. A warm-up request
    first, through a batcher whose governor falls back on any round short
    of a full accept, so that the plain decode program is captured before
    the run whenever a round can fail."""
    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.inference import ContinuousBatcher

    eng = _serve_engine(net, draft_net=draft, speculate_k=SPEC_K)
    warm = ContinuousBatcher(eng, device="cuda", spec_window=1,
                             spec_floor=1.0, spec_cooldown=2)
    warm.submit(np.random.RandomState(9).randint(0, 50257, 40),
                max_new_tokens=12)
    warm.run()
    plain = [p for (sig, _), p in eng._programs.items()
             if sig == ("decode", 8, "paged")]
    warmed = len(plain) == 1 and (plain[0].graph is not None
                                  or not plain[0].capture)
    calls = _count_dispatches(eng)
    with _telemetry(what) as d:
        bat = ContinuousBatcher(eng, device="cuda")
        reqs = [bat.submit(p, max_new_tokens=n) for p, n in requests]
        torch.cuda.synchronize()
        _release()
        _reset_launch_counts()
        t = time.perf_counter()
        while bat.step():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = _serving_launches()
        events = [e["event"] for e in obs.read_events(d)
                  if e["event"] in ("gen_spec_fallback", "gen_spec_rearm")]
        counters = {k: _by_label(k) for k in ("gen_spec_fallbacks_total",
                                              "gen_spec_rearms_total")}
    _check_launches(what, launches, _want_launches(calls, draft._num_layers))
    steps = calls["spec_step"] + calls["plain_step"]
    step_s = calls["spec_step_s"] + calls["plain_step_s"]
    g = bat.governor
    if counters != {"gen_spec_fallbacks_total": g.fallbacks,
                    "gen_spec_rearms_total": g.rearms} or \
            events.count("gen_spec_fallback") != g.fallbacks or \
            events.count("gen_spec_rearm") != g.rearms:
        raise AssertionError(f"{what}: governor {g.fallbacks} fallbacks, "
                             f"{g.rearms} re-arms; counters {counters}, "
                             f"events {events}")
    sigs = {s[0] for s in eng._signatures}
    if eng.compiled_programs != len(eng._programs) or not \
            {"prefill", "draft", "verify"} <= sigs <= \
            {"prefill", "draft", "verify", "decode"}:
        raise AssertionError(f"{what}: programs {eng._signatures}, "
                             f"{len(eng._programs)} graphs")
    res = {"ms_per_step": step_s / steps * 1e3,
           "tokens_per_s": calls["tokens"] / step_s,
           "rounds": calls["spec_step"], "plain_steps": calls["plain_step"],
           "plain_share": calls["plain_step"] / steps,
           "ms_per_round": calls["spec_step_s"] / max(calls["spec_step"], 1)
           * 1e3,
           "ms_per_plain_step": calls["plain_step_s"]
           / max(calls["plain_step"], 1) * 1e3,
           "fallbacks": g.fallbacks, "rearms": g.rearms,
           "plain_program_warmed": warmed,
           "tokens": calls["tokens"], "prefills": calls["prefill"],
           "wall_s": wall, "peak_pages": calls["peak_pages"],
           "compiled_programs": eng.compiled_programs, "launches": launches}
    _uncount(eng)
    return eng, reqs, res


def phase_governed(net, draft, plain):
    """The ``spec`` phase's requests (serve's 16, 64 new tokens, greedy)
    through the batcher with the speculation governor at its defaults
    (window 8, floor 0.125, cooldown 16): with the random gpt2_117m draft
    (accept rate 0) at least one fallback and one re-arm, the plain
    program captured before the run; with the target as its own draft
    (accept rate 1.0) no fallback. Both runs' tokens are the plain serve
    run's (``near_ties``). Returns the random-draft run's launches and
    both runs' metrics."""
    res = {}
    for name, d in (("random", draft), ("self", net)):
        eng, reqs, res[name] = _governed_run(net, d, _serve_requests(),
                                             f"governed {name}")
        res[name]["near_ties"] = near_ties(f"governed {name}", reqs, plain)
        del eng, reqs
        _release()
        log(f"[governed {name}] " + json.dumps(res[name]))
    r, s = res["random"], res["self"]
    if r["fallbacks"] < 1 or r["rearms"] < 1 or not r["plain_program_warmed"]:
        raise AssertionError(f"governed random: {r['fallbacks']} fallbacks, "
                             f"{r['rearms']} re-arms, plain program warmed "
                             f"{r['plain_program_warmed']}")
    if s["fallbacks"] or s["plain_steps"]:
        raise AssertionError(f"governed self: {s['fallbacks']} fallbacks, "
                             f"{s['plain_steps']} plain steps")
    return r.pop("launches"), res


def phase_stall(net, plain):
    """The dispatch watchdog at ``STALL_WATCHDOG_S`` on the serve engine
    (graph): serve's first 8 requests, after a pass of the same prompts
    twice with the watchdog off (every bucket they use captured), with the
    third decode dispatch wrapped in a ``STALL_S`` host sleep (as the JAX
    test monkeypatches): exactly one ``gen_stuck_dispatch`` event, naming
    family "decode", that dispatch's step id and the 8 rows riding it,
    and every request's tokens the plain serve run's. Returns the engine
    (warm, for ``phase_overload``), the stalled pass's launches and its
    metrics."""
    from mxnet_tpu_torch.inference import ContinuousBatcher

    eng, eight = _serve_engine(net), _serve_requests()[:8]
    bat = ContinuousBatcher(eng, device="cuda")
    first = [bat.submit(p, max_new_tokens=n) for p, n in eight + eight]
    bat.run()
    calls = _count_dispatches(eng)
    counted, stall = eng.decode_step, {}

    def stalled():
        if calls["decode_step"] == 2 and not stall:
            stall["step_id"] = bat._step_id
            time.sleep(STALL_S)
        return counted()

    eng.decode_step = stalled
    with _telemetry("stall") as d:
        bat = ContinuousBatcher(eng, device="cuda",
                                watchdog_s=STALL_WATCHDOG_S)
        reqs = [bat.submit(p, max_new_tokens=n) for p, n in eight]
        _reset_launch_counts()
        t = time.perf_counter()
        bat.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = _serving_launches()
        ev = _events(d, "gen_stuck_dispatch")
    _uncount(eng)
    _check_launches("stall", launches, _want_launches(calls))
    got = [(e["family"], e["step_id"], len(e["victims"])) for e in ev]
    if got != [("decode", stall.get("step_id"), 8)] or \
            bat.watchdog.stalls != 1:
        raise AssertionError(f"stall: events {got}, expected one ('decode', "
                             f"{stall.get('step_id')}, 8); watchdog "
                             f"{bat.watchdog.stalls} stalls")
    outs = [r.output for r in first + reqs]
    if outs != [plain[i % 8][0] for i in range(24)]:
        raise AssertionError("stall: tokens differ from the plain serve run")
    res = {"event": ev[0], "watchdog_s": STALL_WATCHDOG_S, "sleep_s": STALL_S,
           "wall_s": wall, "decode_steps": calls["decode_step"]}
    log(f"[stall] one gen_stuck_dispatch: {json.dumps(ev[0])}; 8 requests' "
        f"tokens unchanged; launches {launches}")
    return eng, launches, res


def phase_overload(eng, plain):
    """Overload control on the real clock (the warm serve engine, graph):
    serve's 16 prompts submitted three times, in bursts of 16 at steps 0,
    20 and 40, each with ``deadline_s`` 1.5, into a batcher with
    max_queue 16, policy "shed" and a page floor of 32. Gates only on the
    invariants: an explicit finish reason for every request, a clean
    drain, every completed row the plain run's tokens for its prompt and
    every interrupted row a prefix of them. At this width the run takes
    under a second and holds about a third of the 512 pages, so neither
    the deadline nor the page floor fires and the sheds are all
    ``queue_full``; ``not_fired`` names the settings that did not bite.
    ``phase_drill`` alone holds deadline expiry (queue and slot) and
    page-floor shedding at full width, and gates on them. Returns the
    run's launches and metrics: the count of each finish reason, TTFT p50
    / p99 of the admitted requests (``ttft_seconds``' bucket edges, and
    exact), tokens a second and peak pages."""
    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.inference import FINISH_REASONS, ContinuousBatcher

    serve = _serve_requests()
    calls = _count_dispatches(eng)
    with _telemetry("overload"):
        bat = ContinuousBatcher(eng, device="cuda",
                                max_queue=OVERLOAD["max_queue"],
                                queue_policy="shed",
                                shed_page_floor=OVERLOAD["shed_page_floor"])
        reqs, step = [], 0
        _reset_launch_counts()
        t = time.perf_counter()
        while True:
            if step in OVERLOAD["bursts"]:
                reqs += [(j, bat.submit(p, max_new_tokens=n,
                                        deadline_s=OVERLOAD["deadline_s"]))
                         for j, (p, n) in enumerate(serve)]
            alive = bat.step()
            step += 1
            if not alive and step > max(OVERLOAD["bursts"]):
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = _serving_launches()
        h = obs.REGISTRY.get("ttft_seconds")
        hist = {"p50": h.percentile(0.5), "p99": h.percentile(0.99)}
        shed = _by_label("gen_shed_total", "cause")
        expired = _by_label("gen_deadline_expired_total", "where")
    _uncount(eng)
    _check_launches("overload", launches, _want_launches(calls))
    reasons = [r.finish_reason for _, r in reqs]
    if any(x not in FINISH_REASONS for x in reasons):
        raise AssertionError(f"overload: finish reasons {reasons}")
    drained = (bat.active, bat.pending, eng.free_pages, eng.reserved_pages)
    if drained != (0, 0, eng.num_pages, 0):
        raise AssertionError(f"overload: not drained clean (active, pending, "
                             f"free pages, reserved) = {drained}")
    for j, r in reqs:
        want = plain[j][0]
        if r.finish_reason in ("eos", "length") and r.output != want or \
                r.output != want[:len(r.output)]:
            raise AssertionError(f"overload: request {r.id} "
                                 f"({r.finish_reason}) is not the plain "
                                 f"run's tokens for prompt {j}")
    ttft = sorted(r.ttft for _, r in reqs if r.ttft is not None)
    res = {"reasons": {x: reasons.count(x) for x in FINISH_REASONS
                       if x in reasons},
           "shed_causes": shed, "deadlines": expired,
           "not_fired": [k for k, fired in (("deadline_s", expired),
                                            ("shed_page_floor",
                                             shed.get("page_floor")))
                         if not fired],
           "ttft_hist_p50_s": hist["p50"], "ttft_hist_p99_s": hist["p99"],
           "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None,
           "ttft_p99_s": ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))]
           if ttft else None,
           "admitted": len(ttft), "requests": len(reqs),
           "tokens_per_s": sum(len(r.output) for _, r in reqs) / wall,
           "peak_pages": calls["peak_pages"], "steps": step, "wall_s": wall,
           "ms_per_step": calls["decode_step_s"] / calls["decode_step"] * 1e3}
    log(f"[overload] " + json.dumps(res))
    return launches, res


def phase_graph_equals_naive(serve_net):
    """The step graphs against the eager steps, beyond the timed runs'
    greedy serving and full training: (1) seeded top-k serving at full
    width, tokens and every decode step's logits bit-identical; (2) 3
    TrainStep steps of a 2-layer gpt2_345m-width model in f32 and under
    amp="bfloat16" (the ``train`` and ``train_amp`` steps): losses, every
    parameter and every Adam moment bit-identical; (3) a host sync planted
    in a captured step raises, naming the step, and the card still
    works; (4) two engines' decode graphs replayed at the same time on two
    streams serve what each serves alone (``phase_two_streams``)."""
    from mxnet_tpu_torch import MXNetError, TrainStep
    from mxnet_tpu_torch.inference import SamplingConfig
    from mxnet_tpu_torch.models import get_gpt2, lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    topk = SamplingConfig(method="top_k", top_k=40, seed=7)
    reqs = _serve_requests(n=8, max_new=16, seed=3)
    runs = {m: _serve_run(serve_net, m, reqs, sampling=topk, warm=False)
            for m in ("naive", "graph")}
    if not _same_serving(runs["naive"], runs["graph"]):
        raise AssertionError("top-k serving: graph and naive differ")
    steps = len(runs["graph"]["logits"])
    del runs
    _release()
    log(f"[graph==naive] top-k (k 40, seed 7) serving, 8 requests: tokens "
        f"and the logits of all {steps} decode steps bit-identical")

    ids, labels = _train_batch(4, 1024)
    for amp in (None, "bfloat16"):
        out = {}
        for mode in ("naive", "graph"):
            net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2,
                           device="cuda", seed=1)
            ts = _train_step(net, amp, mode)
            losses = [ts(ids, labels) for _ in range(TRAIN_STEPS)]
            out[mode] = ([float(x) for x in losses], _state(ts),
                         ts.compiled_programs)
            del net, ts
            _release()
        (ln_, sn, _), (lg, sg, pg) = out["naive"], out["graph"]
        if ln_ != lg or not _same_state(sn, sg) or pg != 1:
            raise AssertionError(f"train {amp or 'f32'}: after "
                                 f"{TRAIN_STEPS} steps graph and naive "
                                 f"differ (losses {lg} / {ln_})")
        log(f"[graph==naive] train {amp or 'f32'}, 2 layers at gpt2_345m "
            f"width, {TRAIN_STEPS} steps: losses {lg}, {len(sg)} parameters "
            f"and Adam moments bit-identical")
        del out

    def syncing_loss(out, y):
        loss = lm_loss(out, y)
        _ = float(loss)  # a host sync: cannot be captured
        return loss

    net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=1, device="cuda",
                   seed=1)
    ts = TrainStep(net, syncing_loss, Adam(learning_rate=1e-4), amp=None,
                   engine_type="graph")
    ts(ids, labels)  # the eager warm-up syncs freely
    for attempt in (1, 2):  # the next call captures; it never runs eagerly
        try:
            ts(ids, labels)
        except MXNetError as e:
            msg = str(e)
            if "capture of step" not in msg or "train_step" not in msg:
                raise AssertionError(f"planted host sync: wrong error {msg}")
        else:
            raise AssertionError("planted host sync: the capture did not "
                                 "raise")
    del net, ts
    x = torch.ones(4, device="cuda")
    if float((x + 1).sum()) != 8.0:
        raise AssertionError("the card does not work after a failed capture")
    # a capture that failed must not leave the allocator believing that a
    # capture runs: it would then never again return the memory of a block
    # used on a second stream
    _release()
    before = torch.cuda.memory_reserved()
    t = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t.record_stream(torch.cuda.Stream())
    del t
    _release()
    if torch.cuda.memory_reserved() != before:
        raise AssertionError(f"after a failed capture a block used on two "
                             f"streams stays reserved: "
                             f"{torch.cuda.memory_reserved() - before} bytes")
    log(f"[graph==naive] a host sync planted in the captured step raises, "
        f"twice, with the signature, and leaves the allocator as it was: "
        f"{' '.join(msg.split())[:400]}")
    phase_two_streams(serve_net)


def phase_two_streams(serve_net, replays=16):
    """Two paged engines (gpt2_345m, batch 8: the decode read splits its
    keys and merges the splits through arrival counters) each prefill 8
    prompts and take two decode steps (the warm-up, then the capture).
    Each decode graph must own its counters. Then each graph is replayed
    once alone, and ``replays`` times more with the two graphs launched
    back to back on two streams, so that they run at the same time: every
    replay must give the logits of the replay alone, bit for bit (a replay
    rewrites the same cache entries from the same static inputs)."""
    from mxnet_tpu_torch.inference import GenerationEngine

    rs = np.random.RandomState(11)
    engs, graphs = [], []
    for _ in range(2):
        eng = GenerationEngine(serve_net, batch_size=8, max_length=1024,
                               paged=True, page_size=16, device="cuda",
                               engine_type="graph")
        for slot, n in enumerate(rs.randint(32, 300, 8)):
            eng.prefill(rs.randint(0, 50257, int(n)), slot)
        eng.decode_step()
        eng.decode_step()
        engs.append(eng)
        graphs.append(next(p for (sig, _), p in eng._programs.items()
                           if sig[0] == "decode"))
    log(f"[two streams] two engines, 8 prefills and 2 decode steps each: "
        f"decode graphs captured on streams {[g.stream for g in graphs]}")
    counters = [g._owned["arrivals"].data_ptr() for g in graphs]
    if any(g.graph is None for g in graphs) or counters[0] == counters[1]:
        raise AssertionError(f"two engines: decode graphs captured "
                             f"{[g.graph is not None for g in graphs]}, "
                             f"split-merge counters at {counters}")
    streams = [torch.cuda.Stream() for _ in graphs]
    alone = []
    for g, st in zip(graphs, streams):
        with torch.cuda.stream(st):
            g.graph.replay()
            alone.append(g.outputs[0].clone())
        st.synchronize()
    outs = [[], []]
    torch.cuda.synchronize()
    for _ in range(replays):
        for i, (g, st) in enumerate(zip(graphs, streams)):
            with torch.cuda.stream(st):
                g.graph.replay()
                outs[i].append(g.outputs[0].clone())
    torch.cuda.synchronize()
    for i in (0, 1):
        if not all(torch.equal(o, alone[i]) for o in outs[i]):
            raise AssertionError(f"two engines on two streams: engine {i}'s "
                                 f"decode logits differ from its replay "
                                 f"alone")
    del engs, graphs, alone, outs
    _release()
    log(f"[two streams] two engines' decode graphs, each with its own "
        f"split-merge counters, replayed {replays} times back to back on "
        f"two streams: every replay's logits bit-identical to each graph's "
        f"replay alone")


# the peak an operation count is held against (see HBM_BYTES_PER_S): by the
# inputs' type, and for f32 matrix products ("3xtf32") a third of the TF32
# rate
PEAKS = {torch.float32: ("f32 CUDA cores, 67 TFLOP/s", F32_FLOPS_PER_S),
         torch.bfloat16: ("bf16 tensor cores, 989 TFLOP/s",
                          BF16_TC_FLOPS_PER_S),
         "3xtf32": ("3xTF32 tensor cores, 494.7/3 TFLOP/s",
                    TF32_TC_FLOPS_PER_S / 3)}


def _bound_ms(nbytes, flops, dtype=torch.float32):
    """(least ms, "bytes" or "operations", the operations' peak): bytes over
    the HBM rate or flops over the peak for ``dtype`` (a key of PEAKS), the
    larger."""
    peak_name, peak = PEAKS[dtype]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations", peak_name


def _timed(kern, plain, library, nbytes, flops, shape, plain_graph=True,
           small=False, dtype=torch.float32):
    """One row of the kernel table. ``ms``, ``plain_ms`` and ``library_ms``
    are device times (CUDA graph replay), except the plain paged read, whose
    host syncs cannot be captured: its time is eager. The ``*_eager_ms``
    are the per-call times of eager calls, host included, as the serving
    loop pays them. ``library=None`` leaves the library time to the caller;
    ``small`` takes fewer calls, for work of milliseconds per call. The
    bound holds the flops against the peak for ``dtype`` (a key of
    PEAKS); for f32 matrix products ("3xtf32") the CUDA cores' bound is
    kept beside it as ``bound_cuda_cores_ms``."""
    bound_ms, bound_by, peak = _bound_ms(nbytes, flops, dtype)
    g = dict(calls=2, replays=3, repeats=3) if small else {}
    e = dict(warmup=2, iters=5, repeats=3) if small else {}
    r = dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by,
             bound_peak=peak,
             bound_cuda_cores_ms=_bound_ms(nbytes, flops)[0]
             if dtype == "3xtf32" else None,
             ms=graph_time_ms(kern, **g), eager_ms=cuda_time_ms(kern, **e),
             plain_eager_ms=cuda_time_ms(plain, **dict(e, iters=5)))
    if library is not None:
        r.update(library_ms=graph_time_ms(library, **g),
                 library_eager_ms=cuda_time_ms(library, **e))
    r["plain_ms"] = graph_time_ms(plain, **g) if plain_graph \
        else r["plain_eager_ms"]
    lib = (f"library {r['library_ms'] * 1e3:.2f} us (eager "
           f"{r['library_eager_ms'] * 1e3:.2f}), " if library is not None
           else "")
    log(f"[time] {shape}: kernel {r['ms'] * 1e3:.2f} us (eager "
        f"{r['eager_ms'] * 1e3:.2f}), plain {r['plain_ms'] * 1e3:.2f} us "
        f"(eager {r['plain_eager_ms'] * 1e3:.2f}), {lib}bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}; {peak})")
    return r


def phase_timing(eng):
    """Each kernel at the serving path's shapes beside its plain version
    and a library call; bound = max(bytes / HBM rate, flops / the peak for
    the work at the inputs' accuracy, PEAKS), each input read once and each
    output written once."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.ops.attention import alloc_paged_kv_cache

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}

    # decode attention: B=8 rows, each with L=512 live keys, ps=16; four
    # layers' pools in turn so the 34 MB of live K/V per layer is not
    # served from the 50 MB L2 on the next call
    b, h, ch, L = 8, 16, 64, 512
    pools = list(eng.pools[:4])
    for k, v in pools:
        k.normal_()
        v.normal_()
    table = eng.page_table.clone()
    table[:, :L // 16] = torch.arange(1, 1 + b * L // 16, dtype=torch.int32,
                                      device=dev).reshape(b, L // 16)
    position = torch.full((b,), L - 1, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, 1, ch, generator=gen).to(dev)
    it = iter(range(10 ** 9))
    # the library call runs on the pre-gathered history: the gather is
    # not timed
    hist = [(k[table[:, :L // 16].long()].transpose(1, 2).reshape(b, h, L, ch),
             v[table[:, :L // 16].long()].transpose(1, 2).reshape(b, h, L, ch))
            for k, v in pools]
    rows["paged_attention"] = _timed(
        lambda: pa.paged_attention_read(q, *pools[next(it) % 4], table,
                                        position),
        lambda: pa.paged_attention_read_plain(q, *pools[next(it) % 4], table,
                                              position),
        lambda: sdpa(q, *hist[next(it) % 4]),
        nbytes=4 * (2 * b * h * L * ch + 2 * b * h * ch) + 4 * b * (L // 16 + 1),
        flops=4 * b * h * L * ch,
        shape="paged_attention decode B=8 H=16 Tq=1 Ch=64 L=512 ps=16 f32",
        plain_graph=False, dtype="3xtf32")
    del hist

    # prefill attention at the largest bucket (one row, 512 new tokens)
    tq = 512
    kp, vp = pools[0]
    qp = torch.randn(1, h, tq, ch, generator=gen).to(dev)
    tp = table[:1].contiguous()
    p0 = torch.zeros(1, dtype=torch.int32, device=dev)
    kh = kp[tp[0, :tq // 16].long()].transpose(0, 1).reshape(1, h, tq, ch)
    vh = vp[tp[0, :tq // 16].long()].transpose(0, 1).reshape(1, h, tq, ch)
    rows["paged_attention_prefill"] = _timed(
        lambda: pa.paged_attention_read(qp, kp, vp, tp, p0),
        lambda: pa.paged_attention_read_plain(qp, kp, vp, tp, p0),
        lambda: sdpa(qp, kh, vh, is_causal=True),
        nbytes=4 * 4 * h * tq * ch + 4 * tq // 16,
        flops=4 * h * ch * tq * (tq + 1) // 2,
        shape="paged_attention prefill B=1 Tq=512 from position 0 f32",
        plain_graph=False, dtype="3xtf32")

    # the speculative path's reads at L=512 live keys a row: the verify
    # (k + 1 = 5 queries a row at positions L-5 .. L-1, the tensor-core
    # prefill kernel) and the gpt2_117m draft's decode (12 heads); the
    # library call runs on the pre-gathered history with the verify's
    # causal mask
    tq, hd = SPEC_K + 1, 12
    pos_v = torch.full((b,), L - tq, dtype=torch.int32, device=dev)
    qv = torch.randn(b, h, tq, ch, generator=gen).to(dev)
    hist = [(k[table[:, :L // 16].long()].transpose(1, 2).reshape(b, h, L, ch),
             v[table[:, :L // 16].long()].transpose(1, 2).reshape(b, h, L, ch))
            for k, v in pools]
    mask = torch.ones(tq, L, dtype=torch.bool, device=dev).tril(L - tq)
    rows["paged_attention_verify"] = _timed(
        lambda: pa.paged_attention_read(qv, *pools[next(it) % 4], table,
                                        pos_v),
        lambda: pa.paged_attention_read_plain(qv, *pools[next(it) % 4], table,
                                              pos_v),
        lambda: sdpa(qv, *hist[next(it) % 4], attn_mask=mask),
        nbytes=4 * (2 * b * h * L * ch + 2 * b * h * tq * ch)
        + 4 * b * (L // 16 + 1),
        flops=4 * b * h * tq * L * ch,
        shape=f"paged_attention verify B=8 H=16 Tq={tq} Ch=64 L=512 ps=16 "
              f"f32", plain_graph=False, dtype="3xtf32")
    del hist
    dpools = alloc_paged_kv_cache(eng.num_pages, hd, 16, ch, 4, device=dev)
    for k, v in dpools:
        k.normal_()
        v.normal_()
    qd = torch.randn(b, hd, 1, ch, generator=gen).to(dev)
    rows_d = table[:, :L // 16].long()
    hist = [(k[rows_d].transpose(1, 2).reshape(b, hd, L, ch),
             v[rows_d].transpose(1, 2).reshape(b, hd, L, ch))
            for k, v in dpools]
    rows["paged_attention_draft"] = _timed(
        lambda: pa.paged_attention_read(qd, *dpools[next(it) % 4], table,
                                        position),
        lambda: pa.paged_attention_read_plain(qd, *dpools[next(it) % 4],
                                              table, position),
        lambda: sdpa(qd, *hist[next(it) % 4]),
        nbytes=4 * (2 * b * hd * L * ch + 2 * b * hd * ch)
        + 4 * b * (L // 16 + 1),
        flops=4 * b * hd * L * ch,
        shape="paged_attention draft decode B=8 H=12 Tq=1 Ch=64 L=512 ps=16 "
              "f32", plain_graph=False, dtype="3xtf32")
    del hist, dpools

    rows.update(phase_layernorm_timing())
    return rows


def phase_layernorm_timing():
    """LayerNorm's forward at the decode shape (8 rows of 1024), the
    largest prefill bucket (512 rows) and the training shape (B=4 x T=1024
    rows: 49 launches a ``train`` or ``train_amp`` step) in f32, and at the
    training shape in bf16 (``train_amp``'s bf16 x, gamma and beta), each
    beside the launch floor: a kernel that does nothing on the grid and
    block of the route taken. The backward at the training shape in f32
    and bf16 (``_ln_rows``)."""
    gen = torch.Generator().manual_seed(2)
    rows, floor = {}, {}
    for n_rows, dtype in ((8, torch.float32), (512, torch.float32),
                          (4096, torch.float32), (4096, torch.bfloat16)):
        shape = f"({n_rows}, 1024) {str(dtype)[6:]}"
        fwd, bwd, floor[shape] = _ln_rows(gen, n_rows, dtype,
                                          backward=n_rows == 4096)
        sfx = "" if dtype == torch.float32 else "_bf16"
        if n_rows == 8:
            rows["layernorm"] = fwd
        elif n_rows == 4096:
            if sfx:
                rows["layernorm_bf16"] = fwd
            rows["layernorm_bwd" + sfx] = bwd
    log("[launch floor] " + json.dumps(floor))
    return rows


def _ln_rows(gen, n_rows, dtype, backward=True, d=1024):
    """The forward kernel's row at (n_rows, d) in ``dtype`` (x, gamma
    and beta), with the launch floor on its route's grid, and, with
    ``backward``, the backward's row, its library yardstick
    F.layer_norm's forward + backward minus its forward (device, CUDA
    graph replay; and eager). Bounds: each input read once, each output
    written once (forward: x, gamma, beta in, y out; backward: x, g, gamma
    in, dx, dgamma, dbeta out), ~8 flops an element forward and ~16
    backward at the f32 CUDA-core rate. Returns (forward row, backward row
    or None, floor entry)."""
    from mxnet_tpu_torch.ops import layernorm as ln

    F = torch.nn.functional
    dev = torch.device("cuda")
    x, g, bb, cot = _ln_case(gen, n_rows, d, 0, dtype, dtype, dev)
    size = x.element_size()
    shape = f"({n_rows}, {d}) {str(dtype)[6:]}"
    route = ln_route(x, g, bb)
    r = _timed(lambda: ln.layer_norm(x, g, bb),
               lambda: ln.layer_norm_plain(x, g, bb),
               lambda: F.layer_norm(x, (d,), g, bb, 1e-5),
               nbytes=size * (2 * x.numel() + 2 * d),
               flops=8 * x.numel(), shape=f"layernorm {shape} {route}")
    r["library"] = "F.layer_norm"
    floor = {"route": route, "layernorm_ms": r["ms"],
             "bound_ms": r["bound_ms"],
             "empty_ms": graph_time_ms(lambda: empty_launch(x, g, bb)),
             "empty_eager_ms": cuda_time_ms(lambda: empty_launch(x, g, bb))}
    log(f"[time] empty kernel on LayerNorm's {route} grid {shape}: "
        f"{floor['empty_ms'] * 1e3:.2f} us by graph replay "
        f"(eager {floor['empty_eager_ms'] * 1e3:.2f}); "
        f"LayerNorm {r['ms'] * 1e3:.2f} us, bound "
        f"{r['bound_ms'] * 1e3:.2f} us")
    if not backward:
        return r, None, floor
    xg, gg, bg = (t.clone().requires_grad_() for t in (x, g, bb))

    def lib_fwd_bwd():
        torch.autograd.grad(F.layer_norm(xg, (d,), gg, bg, 1e-5),
                            (xg, gg, bg), cot)

    def lib_fwd():
        F.layer_norm(xg, (d,), gg, bg, 1e-5)

    fb_ms, f_ms = graph_time_ms(lib_fwd_bwd), graph_time_ms(lib_fwd)
    lib_bwd = fb_ms - f_ms
    lib_bwd_eager = cuda_time_ms(lib_fwd_bwd) - cuda_time_ms(lib_fwd)
    log(f"[time] F.layer_norm backward at {shape}: "
        f"{lib_bwd * 1e3:.2f} us (fwd+bwd {fb_ms * 1e3:.2f} - fwd "
        f"{f_ms * 1e3:.2f}, device); eager {lib_bwd_eager * 1e3:.2f} us")
    bwd = _timed(lambda: ln._backward(x, g, cot, 1e-5),
                 lambda: ln.layer_norm_bwd(x, g, cot, 1e-5), None,
                 nbytes=size * 3 * x.numel() + 3 * d * size,
                 flops=16 * x.numel(), shape=f"layernorm_bwd {shape} {route}")
    bwd.update(library_ms=lib_bwd, library_eager_ms=lib_bwd_eager,
               library="F.layer_norm backward: fwd+bwd minus fwd")
    return r, bwd, floor


def _flash_bounds(b, h, t, d, itemsize):
    """(bytes, flops) of forward, dK/dV and dQ at (B, H, T, D), causal:
    each input read once and each output written once; 2*D flops per
    block-product entry over the T(T+1)/2 live (query, key) pairs, with 2
    products in the forward, 4 in dK/dV and 3 in dQ."""
    tile = b * h * t * d * itemsize
    rows = b * h * t * 4  # one f32 per query row: lse or di
    pairs = b * h * t * (t + 1) // 2
    return {"fwd": (4 * tile + rows, 2 * 2 * d * pairs),
            "dkv": (6 * tile + 2 * rows, 4 * 2 * d * pairs),
            "dq": (5 * tile + 2 * rows, 3 * 2 * d * pairs)}


def _flash_rows(gen, b, h, t, d, dtype):
    """The flash kernels' rows at (B, H, T, D), causal, in ``dtype``, each
    beside its plain version and SDPA (the backward's: SDPA forward +
    backward minus its forward). Returns (forward, dK/dV, dQ)."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dn = str(dtype)[6:]
    q, k, v = _flash_inputs(gen, b, h, t, t, d, dtype, dev)
    do = torch.randn(b, h, t, d, generator=gen).to(dev, dtype)
    out, lse = fa._flash_fwd(q, k, v, True, return_lse=True)
    di = fa._row_dot(do, out).contiguous()
    bounds = _flash_bounds(b, h, t, d, q.element_size())
    shape = f"B={b} H={h} T={t} D={d} causal {dn}"
    # f32 block products are bound at the 3xTF32 rate (PEAKS)
    peak = "3xtf32" if dtype == torch.float32 else dtype
    fwd = _timed(lambda: fa._flash_fwd(q, k, v, True, return_lse=True),
                 lambda: fa.flash_fwd_plain(q, k, v, True),
                 lambda: sdpa(q, k, v, is_causal=True),
                 *bounds["fwd"], shape=f"flash_fwd {shape}", dtype=peak)
    fwd["library"] = "SDPA is_causal forward"
    # the library yardstick of the backward: SDPA forward + backward minus
    # SDPA forward on inputs that require grad, on the device (CUDA graph
    # replay; eager, SDPA's host time per call, ~0.3 ms in bf16, would be
    # measured instead) and eager
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def lib_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True),
                            (qg, kg, vg), do)

    def lib_fwd():
        sdpa(qg, kg, vg, is_causal=True)

    fb_ms, f_ms = graph_time_ms(lib_fwd_bwd), graph_time_ms(lib_fwd)
    fb_eager = cuda_time_ms(lib_fwd_bwd, iters=10)
    lib_bwd = fb_ms - f_ms
    lib_bwd_eager = fb_eager - cuda_time_ms(lib_fwd, iters=10)
    log(f"[time] SDPA causal backward at {shape}: {lib_bwd * 1e3:.2f} us "
        f"(fwd+bwd {fb_ms * 1e3:.2f} - fwd {f_ms * 1e3:.2f}, device); "
        f"eager {lib_bwd_eager * 1e3:.2f} us")
    del qg, kg, vg
    bwd = {}
    for name, kern, plain in (
            ("dkv", fa._bwd_dkv, fa._flash_bwd_dkv_plain),
            ("dq", fa._bwd_dq, fa._flash_bwd_dq_plain)):
        bwd[name] = _timed(
            lambda: kern(q, k, v, do, lse, di, True),
            lambda: plain(q, k, v, do, lse, di, True),
            None, *bounds[name], shape=f"flash_bwd_{name} {shape}",
            dtype=peak)
        bwd[name].update(library_ms=lib_bwd,
                         library_eager_ms=lib_bwd_eager,
                         library="SDPA backward (dq, dk, dv together): "
                                 "fwd+bwd minus fwd")
    return fwd, bwd["dkv"], bwd["dq"]


def phase_train_timing(net):
    """The training kernels at the shapes gpt2_345m training gives them:
    flash (B=4, H=16, T=1024, D=64, causal) in f32 (the ``train`` path; also
    T=2048) and in bf16 (``train_amp``), and Adam over the model's 292
    parameters (``_adam_row``). Bounds as in phase_timing. Returns the rows
    by kernel name, the bf16 flash rows under ``<name>_bf16``."""
    gen = torch.Generator().manual_seed(6)
    rows = {}
    for t, dtype in ((1024, torch.float32), (2048, torch.float32),
                     (1024, torch.bfloat16)):
        fwd, dkv, dq = _flash_rows(gen, 4, 16, t, 64, dtype)
        if t == 1024:
            sfx = "" if dtype == torch.float32 else "_bf16"
            rows["flash_fwd" + sfx] = fwd
            rows["flash_bwd_dkv" + sfx] = dkv
            rows["flash_bwd_dq" + sfx] = dq

    rows["adam"] = _adam_row(net, gen)
    return rows


def _adam_row(net, gen, ws=None):
    """The Adam kernel over ``net``'s parameters (or over copies of the
    tensors ``ws``; f32 grads, lr 1e-4, wd 0), its plain version tensor by
    tensor and torch.optim.Adam(fused=True, capturable=True); first one
    update of the kernel against the plain version from the same state at
    ADAM_TOL["step"] (``max_abs_err`` of the row, at the path's shapes).
    Bound: 28 bytes an element (w, g, m, v read, w, m, v written), ~12
    flops an element."""
    from mxnet_tpu_torch.ops import optimizer as oo

    dev = torch.device("cuda")
    ws = [p.detach().clone() for p in
          (net.parameters() if ws is None else ws)]
    gs = [torch.randn(w.shape, generator=gen).to(dev) * 1e-3 for w in ws]
    ms = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    n = sum(w.numel() for w in ws)
    lr = torch.full((len(ws),), 1e-4, device=dev)
    wd = torch.zeros(len(ws), device=dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)

    def plain_adam(ws=ws, ms=ms, vs=vs):
        for i in range(len(ws)):
            oo.adam_update(ws[i], gs[i], ms[i], vs[i], lr[i], 0.9, 0.999,
                           1e-8, wd[i])

    shape = f"adam {len(ws)} tensors, {n} elements, f32 grads"
    ref = [[t.clone() for t in ts] for ts in (ws, ms, vs)]
    oo.adam_update_fused(ws, gs, ms, vs, lr, wd, **kw)
    plain_adam(*ref)
    torch.cuda.synchronize()
    err = 0.0
    for name, got, want in zip(("w", "m", "v"), (ws, ms, vs), ref):
        for i, (a, b) in enumerate(zip(got, want)):
            err = max(err, _adam_close(a, b, ADAM_TOL["step"],
                                       f"{shape}, {name} {i}"))
    log(f"[adam] {shape}: one update against the plain version, max abs err "
        f"{err:.3e} (rtol, atol {ADAM_TOL['step']})")
    del ref
    lib_params = [torch.nn.Parameter(w.clone()) for w in ws]
    for p, g in zip(lib_params, gs):
        p.grad = g
    # capturable: its step count stays on the card, so a CUDA graph can
    # replay the step (device time) as it does the kernel's
    lib_opt = torch.optim.Adam(lib_params, lr=1e-4, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=0.0, fused=True,
                               capturable=True)
    row = _timed(lambda: oo.adam_update_fused(ws, gs, ms, vs, lr, wd, **kw),
                 plain_adam, lib_opt.step, nbytes=28 * n, flops=12 * n,
                 shape=shape, small=True)
    row["library"] = (
        "torch.optim.Adam(fused=True, capturable=True).step(), wd 0 "
        "(epsilon added after the bias correction, not before as here)")
    row["max_abs_err_at_shape"] = err
    del lib_opt, lib_params, gs, ms, vs, ws
    return row


def _xent_rows(gen, n, c, dtype):
    """The xent kernels' rows at (``n``, ``c``) in ``dtype``, each beside
    its plain version and F.cross_entropy. Bound: the logits read once (and
    dx written once), and 16 bytes a row each way (labels and loss or
    cotangent, 4 bytes each; the row max and sum, 8); ~4 operations a
    logit each way."""
    from mxnet_tpu_torch.ops import softmax_xent as sx

    F = torch.nn.functional
    x, lbl, g = _xent_inputs(gen, n, c, dtype, torch.device("cuda"))
    _, stats = sx._xent_fwd(x, lbl)
    lbl64 = lbl.long()
    size = torch.finfo(dtype).bits // 8
    shape = f"({n}, {c}) {str(dtype)[6:]}"
    fwd = _timed(lambda: sx._xent_fwd(x, lbl),
                 lambda: sx.softmax_cross_entropy_plain(x, lbl),
                 lambda: F.cross_entropy(x, lbl64, reduction="none"),
                 nbytes=n * c * size + 16 * n, flops=4 * n * c,
                 shape=f"xent_fwd {shape}", dtype=dtype)
    fwd["library"] = "F.cross_entropy(reduction='none')"
    # the library yardstick of the backward: F.cross_entropy forward +
    # backward minus its forward on logits that require grad, on the
    # device (CUDA graph replay) and eager
    xg = x.clone().requires_grad_()

    def lib_fwd_bwd():
        torch.autograd.grad(F.cross_entropy(xg, lbl64, reduction="none"),
                            xg, g)

    def lib_fwd():
        F.cross_entropy(xg, lbl64, reduction="none")

    fb_ms, f_ms = (graph_time_ms(fn, calls=2, replays=3, repeats=3)
                   for fn in (lib_fwd_bwd, lib_fwd))
    lib_bwd = fb_ms - f_ms
    lib_bwd_eager = cuda_time_ms(lib_fwd_bwd, iters=10) - \
        cuda_time_ms(lib_fwd, iters=10)
    log(f"[time] F.cross_entropy backward at {shape}: "
        f"{lib_bwd * 1e3:.2f} us (fwd+bwd {fb_ms * 1e3:.2f} - fwd "
        f"{f_ms * 1e3:.2f}, device); eager {lib_bwd_eager * 1e3:.2f} us")
    bwd = _timed(lambda: sx._xent_bwd(x, lbl, stats, g),
                 lambda: sx.softmax_cross_entropy_bwd_plain(x, lbl, g),
                 None, nbytes=2 * n * c * size + 16 * n, flops=4 * n * c,
                 shape=f"xent_bwd {shape}", dtype=dtype)
    bwd.update(library_ms=lib_bwd, library_eager_ms=lib_bwd_eager,
               library="F.cross_entropy backward: fwd+bwd minus fwd")
    del x, xg, stats
    return fwd, bwd


def phase_xent_timing():
    """The xent kernels at the train_amp path's LM-head shape, (4096, 50257)
    in bf16 (the path's dtype; those are the table's rows) and in f32
    (``_xent_rows``)."""
    gen = torch.Generator().manual_seed(9)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        fwd, bwd = _xent_rows(gen, 4096, 50257, dtype)
        if dtype == torch.bfloat16:
            rows["xent_fwd"], rows["xent_bwd"] = fwd, bwd
    return rows


def phase_bert_timing(net):
    """The kernels at the shapes bert_amp gives them: LayerNorm forward and
    backward in bf16 at (8192, 1024) (embed_ln and the encoder's 48, B=64 x
    T=128 rows) and at (1280, 1024) (mlm_ln over the B x M=20 gathered
    rows), and Adam over BERT's 303 parameters (``_ln_rows``,
    ``_adam_row``)."""
    gen = torch.Generator().manual_seed(12)
    rows, floor = {}, {}
    for n_rows, name in ((BERT_B * BERT_T, "bert"), (BERT_B * BERT_M, "mlm")):
        fwd, bwd, floor[n_rows] = _ln_rows(gen, n_rows, torch.bfloat16)
        rows[f"layernorm_{name}"], rows[f"layernorm_bwd_{name}"] = fwd, bwd
    log("[launch floor] bert_amp " + json.dumps(floor))
    rows["adam_bert"] = _adam_row(net, gen)
    return rows


# ---------------------------------------------------------------------------
# The remaining tensor, linalg and control-flow ops and the recurrent nets
# (ROADMAP queue 1, items 5 and 6): each new op on the card against the same
# op on CPU tensors, and which of them a captured step can hold; the
# word-level LSTM language model (examples/torch_train_word_lm.py) at
# Zaremba et al.'s medium width (2 LSTM layers of 650, embedding 650 tied
# to the decoder, vocabulary 10,000, B=20, 35 steps), its Gluon loop and its
# TrainStep, beside cuDNN's LSTM.

# (rtol, atol) of a card result against the CPU's: transcendental
# activations (CUDA's and the CPU's erf, exp and log1p differ by a few ulps
# of inputs up to ~12: 4e-6), LAPACK against cuSOLVER (factorizations and
# solves of well-conditioned matrices, their gradients), an eigenvector
# (it moves by up to ~n · ulp · |A| / gap = 256 · 6e-8 · 10 / 0.035 ~ 4e-3
# between two correct solvers; 2.5e-4 measured on the card), eigenvalues
# and the reconstruction from them (cuSOLVER's batched eigh leaves residuals
# near 1e-4 · |A|: 9.8e-4 and 1.2e-3 at |A| = 10 measured), the sampling
# grid's gradient (64 channels' products summed and scaled by (W - 1) / 2 =
# 31.5: entries ~300, so 2e-3 is ~1e-5 of them), the recurrence over 35
# steps against cuDNN's (the weight gradients sum 700 rows in other orders;
# 5.3e-5 measured for the GRU's) and a quantized
# value (a product rounded half to even may land one step apart)
EXTRA_TOL = dict(NN_TOL, f32_fn=(1e-5, 4e-6), lapack=(1e-4, 1e-4),
                 eigvec=(1e-4, 1e-3), eig=(1e-4, 2e-3), rnn=(1e-4, 1e-4),
                 quantized=(0.0, 1.0), sampler=(1e-4, 2e-3))
WLM_VOCAB, WLM_WIDTH, WLM_LAYERS, WLM_B, WLM_T = 10000, 650, 2, 20, 35
WLM_LR, WLM_CLIP, WLM_DROPOUT = 1e-3, 0.25, 0.2
# each step of the word LM: the xent pair on the (700, 10000) logits and one
# multi-tensor Adam; no flash, LayerNorm or paged launch
WLM_WANT = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
            "adam": 1, "layernorm": 0, "layernorm_bwd": 0,
            "layernorm_bwd_merge": 0, "paged_attention": 0,
            "paged_attention_prefill": 0, "xent_fwd": 1, "xent_bwd": 1}


def _extra_cases(gen):
    """(what, fn, CPU inputs, tolerance key, differentiate) for every op of
    ops/extra.py and ops/linalg.py at a shape a model gives it."""
    from mxnet_tpu_torch import registry as reg

    def op(name, **kw):
        return lambda *a: reg.get(name).fn(*a, **kw)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    def uni(lo, hi, *shape):
        return torch.rand(*shape, generator=gen) * (hi - lo) + lo

    def spd(b, n):
        a = rnd(b, n, n)
        return a @ a.transpose(-1, -2) / n + torch.eye(n)

    acts = rnd(4096, 1024, scale=3.0)
    seq = rnd(WLM_T, WLM_B, WLM_WIDTH)
    lens = torch.randint(1, WLM_T + 1, (WLM_B,), generator=gen).float()
    img = rnd(32, 64, 64, 64)
    loc = torch.tensor([1.0, 0.1, 0.0, -0.1, 0.9, 0.05]) + uni(-.1, .1, 32, 6)
    conv = rnd(16, 64, 56, 56)
    idx = torch.randint(-1, 1001, (4096,), generator=gen)
    a = spd(64, 256)
    chol = torch.linalg.cholesky(a)
    small = spd(64, 16) * 0.9
    cases = [(n, op(n), [acts], "f32", True) for n in ("hard_sigmoid",
                                                         "relu6")]
    cases += [(n, op(n), [acts], "f32_fn", True) for n in (
        "softmin", "selu", "gelu", "softrelu", "log_sigmoid")]
    cases += [
        ("logsumexp", op("logsumexp", axis=-1), [acts], "f32_sum", True),
        ("SequenceLast", op("SequenceLast", use_sequence_length=True),
         [seq, lens], "f32", True),
        ("SequenceReverse", op("SequenceReverse", use_sequence_length=True),
         [seq, lens], "f32", True),
        ("GroupNorm (32, 256, 56, 56) G 32",
         op("GroupNorm", num_groups=32), [rnd(32, 256, 56, 56), rnd(32),
                                          rnd(32)], "f32_sum", True),
        ("GroupNorm (C,) gamma", op("GroupNorm", num_groups=32),
         [rnd(8, 256, 28, 28), rnd(256), rnd(256)], "f32_sum", True),
        ("LRN (32, 96, 55, 55)", op("LRN"), [rnd(32, 96, 55, 55)],
         "f32_sum", True),
        ("GridGenerator affine", op("GridGenerator",
                                    target_shape=(64, 64)), [loc],
         "f32_sum", True),
        ("GridGenerator warp", op("GridGenerator", transform_type="warp"),
         [rnd(32, 2, 64, 64)], "f32", True),
        ("BilinearSampler (32, 64, 64, 64)", op("BilinearSampler"),
         [img, uni(-1.1, 1.1, 32, 2, 64, 64)], "sampler", True),
        ("SpatialTransformer (32, 64, 64, 64)",
         op("SpatialTransformer", target_shape=(64, 64)), [img, loc],
         "sampler", True),
        ("batch_take", op("batch_take"), [rnd(4096, 1000),
                                          idx.clamp(0, 999)], "f32", False),
        ("khatri_rao", op("khatri_rao"), [rnd(64, 256), rnd(64, 256)],
         "f32_sum", True),
        ("unravel_index", op("unravel_index", shape=(64, 128, 128)),
         [torch.randint(0, 1 << 20, (1 << 20,), generator=gen)], "f32",
         False),
        ("ravel_multi_index", op("ravel_multi_index", shape=(64, 128, 128)),
         [torch.stack([torch.randint(0, s, (1 << 20,), generator=gen)
                       for s in (64, 128, 128)])], "f32", False),
        ("split_v2", op("split_v2", indices_or_sections=(100, 2000)),
         [acts], "f32", True),
        ("moments", op("moments", axes=(0, 2, 3)), [rnd(32, 256, 56, 56)],
         "f32_sum", True),
        # one image pair: the CPU side of four took 16 s of the phase
        ("Correlation FlowNetC (1, 256, 48, 64) d 20",
         op("Correlation", max_displacement=20, stride2=2, pad_size=20),
         [rnd(1, 256, 48, 64), rnd(1, 256, 48, 64)], "f32_sum", True),
        ("all_finite", op("all_finite"), [rnd(1 << 24)], "f32", False),
        ("multi_all_finite", op("multi_all_finite"),
         [rnd(1 << 22), rnd(1 << 22)], "f32", False),
        ("_sharding_constraint", op("_sharding_constraint"), [acts], "f32",
         True),
        ("add_n", op("add_n"), [acts, acts * 2, acts * 3, acts * 4],
         "f32", True),
        ("argmax_channel", op("argmax_channel"), [rnd(64, 1000, 7, 7)],
         "f32", False),
        ("shape_array", op("shape_array"), [acts], "f32", False),
        ("size_array", op("size_array"), [acts], "f32", False),
        ("im2col (16, 64, 56, 56) 3x3", op("im2col", kernel=(3, 3),
                                            pad=(1, 1)), [conv], "f32",
         True),
        ("col2im (16, 576, 3136) 3x3", op("col2im", output_size=(56, 56),
                                           kernel=(3, 3), pad=(1, 1)),
         [rnd(16, 576, 3136)], "f32_sum", True),
        ("quantize uint8", op("quantize"), [acts, torch.tensor(-8.0),
                                             torch.tensor(9.0)],
         "quantized", False),
        ("quantize_v2 int8", op("quantize_v2"), [acts], "quantized", False),
        ("dequantize", op("dequantize"),
         [torch.randint(0, 256, (4096, 1024), generator=gen).to(
             torch.uint8), torch.tensor(-8.0), torch.tensor(9.0)], "f32",
         False),
        ("bincount", op("bincount"), [torch.randint(
            0, 1000, (1 << 20,), generator=gen).int()], "f32", False),
        ("bincount weights", op("bincount"),
         [torch.randint(0, 1000, (1 << 20,), generator=gen).int(),
          uni(0, 1, 1 << 20)], "f32_sum", False),
        ("onehot_encode", op("onehot_encode"),
         [idx.float(), torch.zeros(4096, 1000)], "f32", False),
        ("choose_element_0index", op("choose_element_0index"),
         [rnd(4096, 1000), idx], "f32", True),
        ("fill_element_0index", op("fill_element_0index"),
         [rnd(4096, 1000), rnd(4096), idx], "f32", True),
        ("amp_cast bf16", op("amp_cast", dtype="bfloat16"), [acts], "f32",
         False),
        ("amp_multicast", op("amp_multicast"),
         [acts.bfloat16(), acts.half(), acts], "f32", False),
        ("linalg_gemm (64, 256, 256)", op("linalg_gemm", alpha=0.5,
                                          beta=2.0),
         [rnd(64, 256, 256), rnd(64, 256, 256), rnd(64, 256, 256)],
         "f32_sum", True),
        ("linalg_gemm2 (64, 256, 256)", op("linalg_gemm2", transpose_b=True),
         [rnd(64, 256, 256), rnd(64, 256, 256)], "f32_sum", True),
        ("linalg_potrf (64, 256, 256)", op("linalg_potrf"), [a], "lapack",
         True),
        ("linalg_potri", op("linalg_potri"), [chol], "lapack", True),
        ("linalg_trsm", op("linalg_trsm", alpha=2.0),
         [chol, rnd(64, 256, 256)], "lapack", True),
        ("linalg_trsm right transposed",
         op("linalg_trsm", rightside=True, transpose=True),
         [chol, rnd(64, 256, 256)], "lapack", True),
        ("linalg_trmm", op("linalg_trmm"), [chol, rnd(64, 256, 256)],
         "f32_sum", True),
        ("linalg_syrk", op("linalg_syrk"), [rnd(64, 256, 256)], "f32_sum",
         True),
        ("linalg_sumlogdiag", op("linalg_sumlogdiag"), [chol], "lapack",
         True),
        ("linalg_det (64, 16, 16)", op("linalg_det"), [small], "lapack",
         True),
        ("linalg_slogdet", op("linalg_slogdet"), [a], "lapack", True),
        ("linalg_inverse", op("linalg_inverse"), [a], "lapack", True),
        ("linalg_extractdiag", op("linalg_extractdiag", offset=1), [a],
         "f32", True),
        ("linalg_makediag", op("linalg_makediag", offset=-1),
         [rnd(64, 255)], "f32", True),
        ("linalg_extracttrian", op("linalg_extracttrian"), [a], "f32",
         True),
        ("linalg_maketrian", op("linalg_maketrian", offset=1, lower=False),
         [rnd(64, 255 * 256 // 2)], "f32", True),
    ]
    return cases


class _Owner:
    """A capture-stream owner for one capture check (``StepGraph``)."""


def _capture_status(what, fn, inputs):
    """"captured" when one forward of ``fn`` on card copies of ``inputs``
    can be captured as a CUDA graph (``StepGraph``) and its replay equals
    an eager call bit for bit, else "synced" (the capture raised: a host
    read)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_graph as cg

    dev = torch.device("cuda", torch.cuda.current_device())
    ins = [t.to(dev) for t in inputs]

    def step():
        out = fn(*ins)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    owner = _Owner()
    prog = cg.StepGraph(step, what, dev, stream=cg.capture_stream(owner, dev))
    with torch.no_grad():
        try:
            prog()
            got = prog()
        except mx.MXNetError:
            return "synced"
        want = step()
    for g, w in zip(got, want):
        if not torch.equal(g.nan_to_num(), w.nan_to_num()):
            raise AssertionError(f"{what}: the captured replay differs from "
                                 f"an eager call")
    return "captured"


def _extra_sign_cases(gen, failures):
    """gelqf and syevd at (64, 256, 256): the card's factors reconstruct
    the input and agree with the CPU's up to the sign of each row; potrf of
    a batch with one matrix that is not positive definite gives NaN in that
    matrix's lower triangle only. syevd's input has eigenvalues spaced
    0.035 apart (1 to 10 on a random basis): an eigenvector moves by about
    ulp · |A| / gap, and a random matrix's near-equal eigenvalues make its
    eigenvectors differ between two correct solvers."""
    from mxnet_tpu_torch import registry as reg

    a = torch.randn(64, 256, 256, generator=gen)
    basis = torch.linalg.qr(torch.randn(64, 256, 256, generator=gen))[0]
    s = (basis * torch.linspace(1.0, 10.0, 256)) @ basis.transpose(-1, -2)
    s = (s + s.transpose(-1, -2)) / 2
    errs = {}
    for name, inp in (("linalg_gelqf", a), ("linalg_syevd", s)):
        card = [t.cpu() for t in reg.get(name).fn(inp.cuda())]
        cpu = reg.get(name).fn(inp)
        rows = card[1] if name == "linalg_gelqf" else card[0]
        ref = cpu[1] if name == "linalg_gelqf" else cpu[0]
        sign = torch.sign((rows * ref).sum(-1, keepdim=True))
        errs[name + " rows"] = _close(
            f"{name} rows up to sign", rows * sign, ref,
            EXTRA_TOL["lapack" if name == "linalg_gelqf" else "eigvec"])
        if name == "linalg_gelqf":
            recon = card[0] @ card[1]
            other = _close("linalg_gelqf L up to sign",
                           card[0] * sign.transpose(-1, -2), cpu[0],
                           EXTRA_TOL["lapack"])
        else:
            recon = card[0].transpose(-1, -2) @ (card[1][..., None] *
                                                 card[0])
            other = _close("linalg_syevd eigenvalues", card[1], cpu[1],
                           EXTRA_TOL["eig"])
        errs[name] = max(other, _close(
            f"{name} reconstruction", recon, inp,
            EXTRA_TOL["lapack" if name == "linalg_gelqf" else "eig"]))
    bad = s.clone()
    bad[7] -= 3 * torch.eye(256)
    bad[7, 0, 1] = bad[7, 1, 0] = 5.0
    L = reg.get("linalg_potrf").fn(bad.cuda()).cpu()
    tri = torch.ones(256, 256, dtype=torch.bool).tril()
    if not (L[7][tri].isnan().all() and (L[7][~tri] == 0).all()
            and torch.isfinite(torch.cat([L[:7], L[8:]])).all()):
        failures.append("linalg_potrf: a matrix that is not positive "
                        "definite must give NaN in its lower triangle only")
    errs["linalg_potrf others"] = _close(
        "linalg_potrf, the positive-definite rest of the batch",
        torch.cat([L[:7], L[8:]]),
        torch.linalg.cholesky(torch.cat([bad[:7], bad[8:]])),
        EXTRA_TOL["lapack"])
    return errs


def phase_extra_ops():
    """``[extra_ops]``: every op of ops/extra.py and ops/linalg.py on the
    card against the same op on CPU tensors, values and (where it has one)
    the gradient under a seeded cotangent (``_card_and_cpu``), at the
    shapes models give them; gemm and gemm2 also under
    ``amp.init("bfloat16")`` (their LP16 rule); gelqf, syevd and a potrf
    batch holding a matrix that is not positive definite
    (``_extra_sign_cases``); then which ops a captured step can hold
    (``_capture_status``), the control-flow operators among them. Any
    mismatch fails the phase. Returns the launch counts of the phase (no
    kernel of the port: these ops are compositions) and the results."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(41)
    _reset_launch_counts()
    errs, capture, failures, took = {}, {}, [], {}
    for what, fn, inputs, tol, grad in _extra_cases(gen):
        t = time.perf_counter()
        try:  # every case runs; the phase fails after the last
            errs[what] = _card_and_cpu(what, fn, inputs, EXTRA_TOL[tol],
                                       grad=grad)
        except AssertionError as e:
            log(f"  FAILED {e}")
            failures.append(str(e))
        capture[what] = _capture_status(what, fn, inputs)
        took[what] = time.perf_counter() - t
    amp.init("bfloat16")
    try:
        for name in ("linalg_gemm2", "linalg_gemm"):
            n = 3 if name == "linalg_gemm" else 2
            ins = [torch.randn(64, 256, 256, generator=gen)
                   for _ in range(n)]
            errs[f"{name} amp bf16"] = _card_and_cpu(
                f"{name} under amp.init('bfloat16')",
                mx.registry.get(name).fn, ins, EXTRA_TOL["f32_sum"])
    finally:
        amp._reset()
    t = time.perf_counter()
    try:
        errs.update(_extra_sign_cases(gen, failures))
    except AssertionError as e:
        log(f"  FAILED {e}")
        failures.append(str(e))
    took["gelqf, syevd, potrf up to sign"] = time.perf_counter() - t
    if failures:
        raise AssertionError("extra_ops: " + "; ".join(failures))
    for name in ("linalg_gelqf", "linalg_syevd"):
        capture[name] = _capture_status(
            name, mx.registry.get(name).fn,
            [torch.eye(64).expand(8, 64, 64).contiguous()])
    nd = mx.nd
    x = torch.randn(WLM_T, WLM_B, WLM_WIDTH, generator=gen)
    flow = {
        "nd.contrib.foreach": lambda d: nd.contrib.foreach(
            lambda r, s: (r * s, r + s), nd.NDArray(d),
            nd.NDArray(d[0]))[0]._data,
        "nd.contrib.while_loop": lambda d: nd.contrib.while_loop(
            lambda v: v.sum() < 1e9, lambda v: (v, [v * 2]),
            [nd.NDArray(d[0])], max_iterations=4)[0]._data,
        "nd.contrib.cond": lambda d: nd.contrib.cond(
            nd.NDArray(d[0, 0, :1]), lambda: nd.NDArray(d) * 2,
            lambda: nd.NDArray(d) - 1)._data}
    for what, fn in flow.items():
        capture[what] = _capture_status(what, fn, [x])
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"extra_ops: kernels launched {launches}")
    # bincount raises inside a capture before it queues anything: the
    # capture ends, and StepGraph must leave the pool to the graph (a second
    # release aborted the process when the graph was freed)
    gc.collect()
    if capture["bincount"] != "synced":
        raise AssertionError("extra_ops: bincount was captured")
    # the captures that did not end (syevd's host read, ...) must leave
    # PyTorch's default generator out of capture mode: an eager draw
    torch.nn.functional.dropout(torch.ones(64, device="cuda"), 0.5)
    synced = sorted(k for k, v in capture.items() if v != "captured")
    res = {"max_abs_err": errs, "capture": capture, "synced": synced,
           "seconds": time.perf_counter() - t0, "seconds_by_case": took}
    slow = sorted(took.items(), key=lambda kv: -kv[1])[:5]
    log(f"[extra_ops] {len(errs)} checks card against CPU, largest error "
        f"{max(errs.values()):.3e}; ops a captured step cannot hold (a host "
        f"read): {synced}; in {res['seconds']:.1f} s (slowest "
        f"{', '.join(f'{k} {v:.1f}' for k, v in slow)})")
    log("[extra_ops] " + json.dumps(res))
    _release()
    return launches, res


def word_lm_flops(tokens, vocab, width, layers):
    """Training FLOPs of a word-LM step: per token forward, each LSTM layer
    2·4H·(in + H) (the input projection and the recurrent product; in = H
    here) and the decoder 2·H·V; the backward twice the forward (its
    products of the data and of the weights). The gate math and the lookup
    are left out."""
    fwd = layers * 2 * 4 * width * (2 * width) + 2 * width * vocab
    return 3 * fwd * tokens


def _wlm_args(ex, *extra):
    """The example's flags at Zaremba-medium width on the card."""
    return ex.build_parser().parse_args(
        ["--vocab", str(WLM_VOCAB), "--embed-size", str(WLM_WIDTH),
         "--hidden-size", str(WLM_WIDTH), "--batch-size", str(WLM_B),
         "--bptt", str(WLM_T), "--tied", *extra])


def _wlm_net(ex, dropout, seed=0):
    """The example's RNNModel at Zaremba-medium width on the card, its
    weights drawn from ``seed`` (Xavier, the example's init)."""
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)
    with mx.gpu():
        net = ex.RNNModel(WLM_VOCAB, WLM_WIDTH, WLM_WIDTH,
                          num_layers=WLM_LAYERS, dropout=dropout,
                          tie_weights=True)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu())
        net(mx.nd.array(np.zeros((WLM_T, WLM_B), np.int32), dtype="int32"))
    return net


def _wlm_batches(ex, n):
    """The first ``n`` (x, y) batches of the example's corpus at
    vocabulary 10,000, B=20, bptt 35, int32 on the card."""
    data = ex.batchify(ex.synthetic_corpus(vocab=WLM_VOCAB), WLM_B)
    out = []
    for i in range(0, n * WLM_T, WLM_T):
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(
            data[i + o:i + o + WLM_T])).cuda() for o in (0, 1)))
    return out


def _wlm_loss():
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    fn = SoftmaxCrossEntropyLoss()
    return lambda out, y: fn(out.reshape(-1, WLM_VOCAB), y.reshape(-1))


def _wlm_step(net, engine_type):
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.optimizer import Adam

    return TrainStep(net, _wlm_loss(), Adam(learning_rate=WLM_LR,
                                            clip_gradient=WLM_CLIP),
                     engine_type=engine_type)


def _wlm_turn(ex, dropout, engine_type, batches):
    """3 TrainStep steps from the seed-0 weights with PyTorch's generator
    seeded alike (the dropout masks' source under a call on tensors):
    losses and the state (weights, Adam moments, step count)."""
    net = _wlm_net(ex, dropout)
    ts = _wlm_step(net, engine_type)
    torch.manual_seed(7)
    losses = [float(ts(*b)) for b in batches]
    state = _state(ts, host=True)
    del ts, net
    _release()
    return losses, state


def _wlm_yardstick(net, gen):
    """The port's LSTM route (``ops.nn.rnn``, the net's flat weights) beside
    ``torch.nn.LSTM`` (cuDNN) with the same weights on one (35, 20, 650)
    input, forward and backward: outputs and gradients (input and every
    weight) at EXTRA_TOL["rnn"], and each one's device time (a CUDA graph
    of forward + backward) and eager time. Then the GRU: the port's fused
    GRU against ``torch.nn.GRU`` at a nonzero b_hn (MXNet's formula, which
    cuDNN's is)."""
    from mxnet_tpu_torch.ops import nn as tnn

    flat = net.rnn._reg_params["parameters"].data()._data.detach()
    res = {}
    for mode, cls in (("lstm", torch.nn.LSTM), ("gru", torch.nn.GRU)):
        ng = 4 if mode == "lstm" else 3
        if mode == "gru":
            size = tnn.rnn_param_size("gru", WLM_WIDTH, WLM_WIDTH, WLM_LAYERS)
            flat = (torch.rand(size, generator=gen) * 0.2 - 0.1).cuda()
        lib = cls(WLM_WIDTH, WLM_WIDTH, num_layers=WLM_LAYERS).cuda()
        g = ng * WLM_WIDTH
        ws, bs = tnn._rnn_unflatten(flat, ng, WLM_LAYERS, 1, WLM_WIDTH,
                                    WLM_WIDTH)
        with torch.no_grad():
            for layer in range(WLM_LAYERS):
                (wx, wh), (bx, bh) = ws[layer][0], bs[layer][0]
                getattr(lib, f"weight_ih_l{layer}").copy_(wx)
                getattr(lib, f"weight_hh_l{layer}").copy_(wh)
                getattr(lib, f"bias_ih_l{layer}").copy_(bx)
                getattr(lib, f"bias_hh_l{layer}").copy_(bh)
        x = torch.randn(WLM_T, WLM_B, WLM_WIDTH, generator=gen).cuda()
        cot = torch.randn(WLM_T, WLM_B, WLM_WIDTH, generator=gen).cuda()
        h0 = torch.zeros(WLM_LAYERS, WLM_B, WLM_WIDTH, device="cuda")
        xp = x.clone().requires_grad_()
        fp = flat.clone().requires_grad_()
        xl = x.clone().requires_grad_()

        def port():
            out = tnn.rnn(xp, fp, h0, h0 if mode == "lstm" else None,
                          state_size=WLM_WIDTH, num_layers=WLM_LAYERS,
                          mode=mode)[0]
            return out, torch.autograd.grad(out, (xp, fp), cot)

        def library():
            out = lib(xl)[0]
            return out, torch.autograd.grad(out, (xl,) + tuple(
                lib.parameters()), cot)

        po, (pdx, pdw) = port()
        lo, lg = library()
        lws, lbs = tnn._rnn_unflatten(pdw, ng, WLM_LAYERS, 1, WLM_WIDTH,
                                      WLM_WIDTH)
        mine = [pdx]
        for layer in range(WLM_LAYERS):
            (wx, wh), (bx, bh) = lws[layer][0], lbs[layer][0]
            mine += [wx, wh, bx, bh]
        err = _close(f"{mode} output, port against cuDNN", po, lo,
                     EXTRA_TOL["rnn"])
        for i, (a, b) in enumerate(zip(mine, lg)):
            err = max(err, _close(f"{mode} gradient {i}, port against cuDNN",
                                  a, b, EXTRA_TOL["rnn"]))
        row = {"max_abs_err": err}
        # the eager calls' graphs hold the leaves' gradient nodes, made on
        # this stream: a capture on another stream must not reuse them
        del po, pdx, pdw, lo, lg, lws, lbs, mine
        if mode == "lstm":
            row.update(
                port_ms=graph_time_ms(port, calls=1, replays=5, repeats=3),
                cudnn_ms=graph_time_ms(library, calls=1, replays=5,
                                       repeats=3),
                port_eager_ms=cuda_time_ms(port, warmup=2, iters=5,
                                           repeats=3),
                cudnn_eager_ms=cuda_time_ms(library, warmup=2, iters=5,
                                            repeats=3))
            row["port_over_cudnn"] = row["port_ms"] / row["cudnn_ms"]
            row["port_eager_over_cudnn_eager"] = \
                row["port_eager_ms"] / row["cudnn_eager_ms"]
            log(f"[word_lm yardstick] LSTM 2x650, T 35, B 20, forward + "
                f"backward: the port's route {row['port_ms']:.3f} ms device "
                f"(eager {row['port_eager_ms']:.3f}), cuDNN "
                f"{row['cudnn_ms']:.3f} ms (eager {row['cudnn_eager_ms']:.3f})"
                f": {row['port_over_cudnn']:.2f}x in a graph, "
                f"{row['port_eager_over_cudnn_eager']:.2f}x eager; max abs "
                f"err {err:.3e}")
        else:
            log(f"[word_lm yardstick] GRU 2x650 at nonzero b_hn, the port's "
                f"fused GRU against torch.nn.GRU: max abs err {err:.3e}")
        res[mode] = row
        del lib, xp, fp, xl
    return res


def phase_word_lm(card, loop_steps=30, profile_at=(20, 26)):
    """``[word_lm]``: examples/torch_train_word_lm.py's model at Zaremba
    et al.'s medium width on the synthetic corpus (vocabulary 10,000):

    (a) the example's Gluon loop (``train(args, net=, on_step=)`` with
        ``_wlm_net``'s seeded model, dropout 0.2, Adam 1e-3, clip 0.25)
        for ``loop_steps`` batches (30; cut from 50 for the script's
        time), each launching WLM_WANT; the loss falls (the
        mean of the last 10 below the first 10); ms a step over steps 10 to
        ``profile_at[0]`` (host clock, synced) and the host share over
        steps ``profile_at`` under the profiler;
    (b) TrainStep: 3 steps naive against graph, losses and state bit for
        bit, at the example's dropout 0.2; then 2 warm-up and 10 timed
        graph steps, WLM_WANT
        a step, ms a step, tokens/s, MFU (``word_lm_flops`` over the f32
        CUDA-core peak), peak memory, a profiled replay's launches and the
        device time by kernel group with the idle share;
    (c) the yardstick: cuDNN's LSTM and GRU beside the port's route
        (``_wlm_yardstick``);
    (d) the example itself as a subprocess at its defaults, one epoch.

    Returns the launches of (b)'s timed run, of (a), and the results."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    ex = _example("torch_train_word_lm")
    if int(ex.synthetic_corpus(vocab=WLM_VOCAB).max()) + 1 != WLM_VOCAB:
        raise AssertionError("word_lm: the corpus does not span the "
                             "vocabulary")
    res = {"card": card}
    # (a) the Gluon loop
    losses, marks, counts = [], {}, {}
    loop_total = dict.fromkeys(WLM_WANT, 0)
    prof = profile(activities=[ProfilerActivity.CUDA])
    _reset_launch_counts()

    def on_step(step, loss):
        now = _launch_counts()
        got = {k: v - counts.get(k, 0) for k, v in now.items()}
        if got != WLM_WANT:
            raise AssertionError(f"word_lm loop step {step}: launches {got}, "
                                 f"expected {WLM_WANT}")
        for k in loop_total:
            loop_total[k] += got[k]
        counts.update(now)
        losses.append(loss)
        if step in (10,) + tuple(profile_at):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()
        if step == profile_at[0]:
            prof.__enter__()
        elif step == profile_at[1]:
            prof.__exit__(None, None, None)
        return step == loop_steps

    epochs = ex.train(_wlm_args(ex, "--epochs", "1"),
                      net=_wlm_net(ex, WLM_DROPOUT), on_step=on_step)
    device_ms = sum(
        float(getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)))
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    n_prof = profile_at[1] - profile_at[0]
    prof_wall = (marks[profile_at[1]] - marks[profile_at[0]]) * 1e3
    step_ms = (marks[profile_at[0]] - marks[10]) * 1e3 / (profile_at[0] - 10)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    loop = {"steps": len(losses), "losses": losses, "epoch_mean": epochs,
            "ms_per_step": step_ms, "profiled_ms_per_step": prof_wall / n_prof,
            "device_ms_per_step": device_ms / n_prof,
            "host_share": 1 - device_ms / prof_wall if device_ms else None,
            "host_share_untraced":
                1 - device_ms / n_prof / step_ms if device_ms else None,
            "first10_mean": first, "last10_mean": last,
            "tokens_per_s": WLM_T * WLM_B / step_ms * 1e3}
    log(f"[word_lm loop] (cut to {loop_steps} steps for time) the example's "
        f"train(), Zaremba-medium, dropout "
        f"{WLM_DROPOUT}, "
        f"{len(losses)} steps: {step_ms:.2f} ms/step (steps 10-"
        f"{profile_at[0]}), {loop['tokens_per_s']:.0f} tokens/s; steps "
        f"{profile_at[0]}-{profile_at[1]} under the profiler "
        f"{loop['profiled_ms_per_step']:.2f} ms/step, device "
        f"{loop['device_ms_per_step']:.2f}, host share {loop['host_share']} "
        f"(against the untraced steps {loop['host_share_untraced']}); mean "
        f"loss first 10 {first:.4f}, last 10 {last:.4f} on {card}")
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"word_lm loop: losses {losses} do not fall")
    res["loop"] = loop
    _release()
    parts = {"loop": time.perf_counter() - t0}
    # (b) TrainStep, naive against graph
    batches = _wlm_batches(ex, 3)
    runs = {m: _wlm_turn(ex, WLM_DROPOUT, m, batches)
            for m in ("naive", "graph")}
    same = runs["naive"][0] == runs["graph"][0] and \
        _same_state(runs["naive"][1], runs["graph"][1])
    log(f"[word_lm] TrainStep 3 steps at dropout {WLM_DROPOUT}: graph "
        f"{'==' if same else '!='} naive bit for bit (losses naive "
        f"{runs['naive'][0]}, graph {runs['graph'][0]})")
    if not same:
        raise AssertionError(f"word_lm: graph != naive at dropout "
                             f"{WLM_DROPOUT}")
    res["parity"] = {"dropout": WLM_DROPOUT, "losses": runs["graph"][0]}
    parts["parity"] = time.perf_counter() - t0 - sum(parts.values())
    del runs
    net = _wlm_net(ex, WLM_DROPOUT)
    ts = _wlm_step(net, "graph")
    (x, y), = _wlm_batches(ex, 1)
    total = dict.fromkeys(WLM_WANT, 0)
    step_losses = []
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    for i in range(12):
        if i == 2:
            torch.cuda.synchronize()
            t = time.perf_counter()
        before = _launch_counts()
        step_losses.append(ts(x, y))
        got = {k: v - before[k] for k, v in _launch_counts().items()}
        if got != WLM_WANT:
            raise AssertionError(f"word_lm graph step {i}: launches {got}, "
                                 f"expected {WLM_WANT}")
        for k in total:
            total[k] += got[k]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    step_losses = [float(v) for v in step_losses]
    if not all(np.isfinite(step_losses)) or \
            not step_losses[-1] < step_losses[0] or ts.compiled_programs != 1:
        raise AssertionError(f"word_lm graph: losses {step_losses}, "
                             f"{ts.compiled_programs} programs")
    ms = wall / 10 * 1e3
    flops = word_lm_flops(WLM_T * WLM_B, WLM_VOCAB, WLM_WIDTH, WLM_LAYERS)
    (prog, _, _), = ts._programs.values()
    step = {"ms_per_step": ms, "tokens_per_s": WLM_T * WLM_B / ms * 1e3,
            "flops_per_step": flops,
            "mfu": flops / (ms * 1e-3) / F32_FLOPS_PER_S,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "losses": step_losses, "dropout": WLM_DROPOUT,
            "replay_launches": check_replay_launches(prog, "word_lm step "
                                                     "graph"),
            "breakdown": _device_groups(prog.graph.replay, 5,
                                        "word_lm graph step", ms)}
    log(f"[word_lm graph] Zaremba-medium, TrainStep Adam, dropout "
        f"{WLM_DROPOUT}, "
        f"10 timed steps: {ms:.2f} ms/step, {step['tokens_per_s']:.0f} "
        f"tokens/s, MFU {step['mfu']:.4f} ({flops:.4e} flops a step over "
        f"the f32 CUDA cores' 67 TFLOP/s), peak "
        f"{step['peak_bytes'] / 2**30:.2f} GiB allocated / "
        f"{step['peak_reserved_bytes'] / 2**30:.2f} reserved; losses "
        f"{['%.4f' % v for v in step_losses]} on {card}")
    res["graph"] = step
    parts["graph"] = time.perf_counter() - t0 - sum(parts.values())
    del ts
    _release()
    # (c) the yardstick, on the graph run's trained weights
    res["yardstick"] = _wlm_yardstick(net, torch.Generator().manual_seed(43))
    parts["yardstick"] = time.perf_counter() - t0 - sum(parts.values())
    res["timing_net"] = net
    # (d) the example at its defaults, one epoch
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, str(root / "examples" /
                                   "torch_train_word_lm.py"),
               "--epochs", "1", "--save", str(Path(d) / "word_lm.params")]
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=d, capture_output=True, text=True,
                              timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(root)))
        line = proc.stdout.strip().splitlines()[-1] \
            if proc.stdout.strip() else ""
        if proc.returncode != 0 or not line.startswith("epoch 0: loss ") or \
                not (Path(d) / "word_lm.params").exists():
            raise AssertionError(f"examples/torch_train_word_lm.py exited "
                                 f"{proc.returncode}: {line!r} "
                                 f"{proc.stderr[-2000:]}")
    res["example"] = {"line": line, "seconds": time.perf_counter() - t}
    parts["example"] = time.perf_counter() - t0 - sum(parts.values())
    log(f"[word_lm] the example at its defaults, one epoch: {line} "
        f"({res['example']['seconds']:.1f} s)")
    res["seconds"] = time.perf_counter() - t0
    res["seconds_by_part"] = parts
    log(f"[word_lm seconds] {res['seconds']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return total, loop_total, res


def phase_word_lm_timing(net):
    """The kernels at the word LM's shapes: the xent pair at (700, 10000)
    f32 (T·B rows over the vocabulary) and Adam over its 3 tensors (the
    tied table, the decoder bias, the flat LSTM parameter)."""
    gen = torch.Generator().manual_seed(44)
    fwd, bwd = _xent_rows(gen, WLM_T * WLM_B, WLM_VOCAB, torch.float32)
    return {"xent_fwd_word_lm": fwd, "xent_bwd_word_lm": bwd,
            "adam_word_lm": _adam_row(net, gen)}


# ---------------------------------------------------------------------------
# Detection (ops/contrib_vision.py, models/ssd.py, examples/torch_train_ssd.py)
# and the training utilities (callback.py, gluon/contrib/estimator.py,
# test_utils.py)
# ---------------------------------------------------------------------------
# card against CPU: the anchors, IoUs, NMS decisions, targets and pooled
# maxima are sums, products and quotients in one order on both (exact); the
# decode's exp and the targets' log may differ by an ulp (f32); a gradient
# summed over a broadcast axis (the anchors' over the batch) adds in another
# order (f32_sum); the sampled ops add corners and samples in another order,
# their gradients many contributions (atomics on the card; a deformable
# weight gradient sums 4,788 products of magnitude ~1 to a few hundred:
# sampled_sum's atol is 1e-5 of that scale)
DET_TOL = {"exact": (0.0, 0.0), "f32": (1e-5, 1e-6), "f32_sum": (1e-5, 1e-5),
           "sampled": (1e-4, 1e-4), "sampled_sum": (1e-4, 1e-3)}
SSD_SIZES = ((0.2, 0.27), (0.37, 0.44), (0.54, 0.62))
SSD_RATIOS = (1.0, 2.0, 0.5)
SSD_B, SSD_SIZE = 16, 32            # examples/train_ssd.py's defaults
# MXNet example/ssd/train.py's data shape and batch size, and its nms_topk
SSD300_B, SSD300_SIZE, SSD300_ANCHORS, SSD_NMS_TOPK = 32, 300, 117976, 400
SSD_LR = 5e-3
# an SSD step launches one multi-tensor Adam over its 24 tensors and no
# other kernel of the port (convolutions, pooling and the detection ops are
# cuDNN and plain compositions)
SSD_WANT = dict(VISION_WANT, adam=1, xent_fwd=0, xent_bwd=0)
# Mask R-CNN's box head (FPN level, 7x7, 1/16, 2 samples a bin) and
# Deformable R-FCN's res5 (3x3, pad 2, dilate 2, 4 deformable groups)
MASKRCNN_BOX_HEAD = dict(data=(2, 256, 50, 84), rois=512, pooled=(7, 7),
                         scale=1 / 16, sample_ratio=2)
DEFORM_RES5 = dict(data=(2, 512, 38, 63), filters=512, kernel=(3, 3),
                   pad=(2, 2), dilate=(2, 2), groups=4)


def _ssd_anchors(size):
    """The SSD's anchors at a ``size`` x ``size`` input: MultiBoxPrior on
    its three maps (size/2, /4, /8), concatenated (CPU)."""
    from mxnet_tpu_torch.ops import contrib_vision as cv

    out, hw = [], size
    for sizes in SSD_SIZES:
        hw //= 2
        out.append(cv.multibox_prior(torch.zeros(1, 1, hw, hw), sizes=sizes,
                                     ratios=SSD_RATIOS))
    return torch.cat(out, 1)


def _ssd_labels(batch, size, seed):
    """The example's synthetic labels (one box an image) and a padded row
    (class -1), CPU."""
    import mxnet_tpu_torch as mx

    ex = _example("torch_train_ssd")
    _, labels = ex.synthetic_batch(np.random.RandomState(seed), batch, size,
                                   ctx=mx.cpu())
    pad = torch.full((batch, 1, 5), -1.0)
    return torch.cat([labels._data, pad], 1)


def _rois(gen, n, batch, height, width):
    """``n`` rois [batch, x1, y1, x2, y2] in image pixels, inside the
    image, 16 to 400 px a side, the batch index -1 for every 64th."""
    b = torch.randint(0, batch, (n,), generator=gen).float()
    b[::64] = -1
    w = 16 + torch.rand(n, generator=gen) * 384
    h = 16 + torch.rand(n, generator=gen) * 384
    x1 = torch.rand(n, generator=gen) * (width - w).clamp_min(1)
    y1 = torch.rand(n, generator=gen) * (height - h).clamp_min(1)
    return torch.stack([b, x1, y1, x1 + w, y1 + h], 1)


def _detection_cases(gen):
    """(what, fn, CPU inputs, value tolerance key, gradient tolerance key or
    None) for every op of ops/contrib_vision.py at the SSD's shapes (32x32: 1,344 anchors, B=16;
    300x300: 117,976 anchors, B=32), Mask R-CNN's box head and Deformable
    R-FCN's res5."""
    from mxnet_tpu_torch.ops import contrib_vision as cv

    cases = []
    for size, batch, topk in ((SSD_SIZE, SSD_B, -1),
                              (SSD300_SIZE, SSD300_B, SSD_NMS_TOPK)):
        anchors = _ssd_anchors(size)
        a = anchors.shape[1]
        tag = f"{size}x{size} (B={batch}, {a} anchors)"
        hw = size // 2
        cases.append((f"MultiBoxPrior {hw}x{hw} map",
                      lambda x: cv.multibox_prior(x, sizes=SSD_SIZES[0],
                                                  ratios=SSD_RATIOS),
                      [torch.zeros(batch, 16, hw, hw)], "exact", None))
        labels = _ssd_labels(batch, size, seed=size)
        prob = torch.softmax(torch.randn(batch, 3, a, generator=gen), 1)
        loc = torch.randn(batch, a * 4, generator=gen) * 0.5
        cases.append((f"box_iou anchors x ground truths {tag}",
                      lambda x, g: cv.box_iou(x, g),
                      [anchors[0], labels[..., 1:]], "exact", "f32_sum"))
        rows = torch.cat([torch.randint(0, 2, (batch, a, 1),
                                        generator=gen).float(),
                          torch.rand(batch, a, 1, generator=gen),
                          anchors.expand(batch, a, 4)], -1)
        cases.append((f"box_nms topk {topk} {tag}",
                      lambda r, k=topk: cv.box_nms(r, topk=k, id_index=0),
                      [rows], "exact", "exact"))
        cases.append((f"MultiBoxDetection decode, nothing suppressed {tag}",
                      lambda p, lp, an, k=topk: cv.multibox_detection(
                          p, lp, an, nms_threshold=2.0, nms_topk=k),
                      [prob, loc, anchors], "f32", "f32_sum"))
        cases.append((f"MultiBoxDetection nms_topk {topk}, zero offsets "
                      f"{tag}",
                      lambda p, lp, an, k=topk: cv.multibox_detection(
                          p, lp, an, nms_topk=k),
                      [prob, torch.zeros_like(loc), anchors], "exact",
                      None))
        cases.append((f"MultiBoxTarget mining 3:1 {tag}",
                      lambda an, lab, p: cv.multibox_target(
                          an, lab, p, negative_mining_ratio=3.0),
                      [anchors, labels, prob], "f32", None))
        cases.append((f"getnnz of the background column {tag}",
                      lambda p: cv.getnnz(p[:, 0] > 0.5, axis=1),
                      [prob], "exact", None))
        cases.append((f"index_array {tag}", lambda p: cv.index_array(p),
                      [prob], "exact", None))
    box = MASKRCNN_BOX_HEAD
    n, c, h, w = box["data"]
    data = torch.randn(n, c, h, w, generator=gen)
    rois = _rois(gen, box["rois"], n, h / box["scale"], w / box["scale"])
    tag = f"Mask R-CNN box head {box['data']}, {box['rois']} rois, 7x7, 1/16"
    cases.append((f"ROIAlign {tag}, 2 samples",
                  lambda d, r: cv.roi_align(
                      d, r, pooled_size=box["pooled"],
                      spatial_scale=box["scale"],
                      sample_ratio=box["sample_ratio"]),
                  [data, rois], "sampled", "sampled"))
    cases.append((f"ROIPooling {tag}",
                  lambda d, r: cv.roi_pooling(d, r.detach(),
                                              pooled_size=box["pooled"],
                                              spatial_scale=box["scale"]),
                  [data, rois], "exact", "sampled"))
    dc = DEFORM_RES5
    n, c, h, w = dc["data"]
    kh, kw = dc["kernel"]
    # offsets of +-2 around 0.13: no sample on an integer
    offset = (torch.rand(n, 2 * dc["groups"] * kh * kw, h, w, generator=gen)
              - 0.5) * 4 + 0.13
    weight = torch.randn(dc["filters"], c, kh, kw, generator=gen) * 0.02
    bias = torch.randn(dc["filters"], generator=gen)
    cases.append((f"DeformableConvolution Deformable R-FCN res5 {dc['data']}"
                  f", {dc['filters']} filters, 3x3, pad 2, dilate 2, "
                  f"{dc['groups']} deformable groups",
                  lambda d, o, wt, b: cv.deformable_convolution(
                      d, o, wt, b, kernel=dc["kernel"], pad=dc["pad"],
                      dilate=dc["dilate"], num_filter=dc["filters"],
                      num_deformable_group=dc["groups"]),
                  [torch.randn(n, c, h, w, generator=gen), offset, weight,
                   bias], "sampled", "sampled_sum"))
    return cases


def _nbytes(ts):
    ts = ts if isinstance(ts, (tuple, list)) else [ts]
    return sum(t.numel() * t.element_size() for t in ts)


def phase_detection():
    """``[detection]``: every op of ops/contrib_vision.py on the card
    against the same op on CPU tensors, values and (where it has one) the
    gradients under a seeded cotangent, each at its DET_TOL
    (``_card_and_cpu``),
    at the 32x32 and 300x300 SSD's shapes, Mask R-CNN's box head and
    Deformable R-FCN's res5 (``_detection_cases``); then whether a captured
    step can hold each (``_capture_status``; MultiBoxTarget must), and each
    forward's device time (a CUDA graph replay where it is captured, else
    eager), its launches (one profiled call) and its byte bound (inputs
    read once, outputs written once). Returns the results."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(51)
    _reset_launch_counts()
    errs, capture, rows, failures = {}, {}, {}, []
    for what, fn, inputs, tol, grad_tol in _detection_cases(gen):
        t = time.perf_counter()
        try:  # every case runs; the phase fails after the last
            errs[what] = _card_and_cpu(what, fn, inputs, DET_TOL[tol],
                                       grad=False)
            if grad_tol is not None:
                errs[what] = max(errs[what], _card_and_cpu(
                    f"{what} (gradients)", fn, inputs, DET_TOL[grad_tol]))
        except AssertionError as e:
            log(f"  FAILED {e}")
            failures.append(str(e))
        capture[what] = _capture_status(what, fn, inputs)
        ins = [x.cuda() for x in inputs]
        with torch.no_grad():
            out = fn(*ins)
            call = (lambda: fn(*ins))
            timed = graph_time_ms(call, calls=1, replays=3, repeats=3) \
                if capture[what] == "captured" else \
                cuda_time_ms(call, warmup=1, iters=3, repeats=3)
            launches = _profiled_count(call, "")
        nbytes = _nbytes(ins) + _nbytes(out)
        rows[what] = {"ms": timed, "launches": launches, "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "capture": capture[what],
                      "seconds": time.perf_counter() - t}
        log(f"[detection] {what}: {timed:.3f} ms device"
            f"{'' if capture[what] == 'captured' else ' (eager)'}, "
            f"{launches} launches, byte bound "
            f"{rows[what]['bound_ms'] * 1e3:.2f} us; {capture[what]}")
        del ins, out
    if failures:
        raise AssertionError("detection: " + "; ".join(failures))
    target = [k for k in capture if k.startswith("MultiBoxTarget")]
    if any(capture[k] != "captured" for k in target):
        raise AssertionError("detection: MultiBoxTarget was not captured")
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"detection: kernels launched {launches}")
    synced = sorted(k for k, v in capture.items() if v != "captured")
    res = {"max_abs_err": errs, "ops": rows, "synced": synced,
           "seconds": time.perf_counter() - t0}
    log(f"[detection] {len(errs)} ops card against CPU, largest error "
        f"{max(errs.values()):.3e}; ops a captured step cannot hold: "
        f"{synced or 'none'}; in {res['seconds']:.1f} s")
    _release()
    return res


def _ssd_step_loss(out, labels):
    """The SSD loss of a TrainStep: the targets (MultiBoxTarget) from the
    step's own predictions, then ssd_loss, as the example's recorded step
    computes them."""
    from mxnet_tpu_torch.models.ssd import ssd_loss, ssd_train_targets

    anchors, cls_preds, box_preds = out
    loc_t, loc_m, cls_t = ssd_train_targets(anchors, labels, cls_preds)
    return ssd_loss(cls_preds, box_preds, cls_t, loc_t, loc_m)


def _ssd_net(size, seed=0):
    """The example's SSD (2 classes, default width) on the card, its
    weights drawn from ``seed`` as the example draws them, its shapes
    resolved by one call."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.ssd import get_ssd

    mx.random.seed(seed)
    net = get_ssd(num_classes=2)
    net.initialize(ctx=mx.gpu())
    net(mx.nd.array(torch.zeros(1, 3, size, size, device="cuda")))
    return net


def _ssd_step(net, engine_type, batch):
    """TrainStep with the example's Adam: the Gluon loop's
    ``trainer.step(B)`` divides the gradient by B, so does rescale_grad."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.optimizer import Adam

    return TrainStep(net, _ssd_step_loss,
                     Adam(learning_rate=SSD_LR, rescale_grad=1.0 / batch),
                     engine_type=engine_type)


def _ssd_batches(n, batch, size, seed=0):
    """``n`` of the example's synthetic batches on the card (tensors)."""
    import mxnet_tpu_torch as mx

    ex = _example("torch_train_ssd")
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x, y = ex.synthetic_batch(rs, batch, size, ctx=mx.gpu())
        out.append((x._data, y._data))
    return out


def phase_ssd(card):
    """``[ssd]``: the repo's SSD at its default width (filters 16/32/64, 3
    scales, 4 anchors a pixel), f32:

    (a) examples/torch_train_ssd.py's ``train()`` at its defaults (B=16,
        32x32, Adam 5e-3 through ``gluon.Trainer``, 200 steps, then
        ``detect`` and the IoU hits): one Adam launch a step and no other
        kernel of the port, the logged loss falling, ms a step;
    (b) SSD300's input and batch (300x300, B=32, 117,976 anchors) through
        ``TrainStep`` with MultiBoxTarget inside the step: 3 steps naive
        against graph, losses and state bit for bit; then 2 warm-up and 10
        timed graph steps (one program, SSD_WANT a step): ms a step,
        images/s, MFU (``_vision_flops`` over the f32 CUDA cores' 67
        TFLOP/s), peak memory, and a profiled replay's device time by
        kernel group and its largest kernels, with the idle share;
    (c) MultiBoxDetection(nms_topk=400) at 300x300 on the trained net's
        predictions (device time, launches), its greedy loop alone, the
        mining's stable sort at this shape, and the example net's
        ``detect`` at 32x32 (eager, as the example calls it).

    Returns the launches of (a) and of (b)'s timed run, the 300x300 net
    (for the Adam row) and the results."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import contrib_vision as cv

    t0 = time.perf_counter()
    ex = _example("torch_train_ssd")
    res = {"card": card}
    # (a) the example at its defaults
    args = ex.build_parser().parse_args([])
    _reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = ex.train(args)
    wall = time.perf_counter() - t
    example_launches = _launch_counts()
    want = {k: v * args.steps for k, v in SSD_WANT.items()}
    if example_launches != want:
        raise AssertionError(f"ssd example: launches {example_launches}, "
                             f"expected {want}")
    losses = [v for _, v in out["losses"]]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ssd example: logged losses {out['losses']} "
                             f"do not fall")
    res["example"] = {"steps": args.steps, "batch": args.batch_size,
                      "losses": out["losses"], "hits": out["hits"],
                      "seconds": wall,
                      "ms_per_step_with_eval": wall / args.steps * 1e3}
    log(f"[ssd example] examples/torch_train_ssd.py train() at its defaults "
        f"(B={args.batch_size}, {args.size}x{args.size}, {args.steps} steps, "
        f"Adam {args.lr}): {wall:.1f} s with the eval, logged losses "
        f"{['%.4f' % v for v in losses]}, detection hits {out['hits']}/"
        f"{args.batch_size}; launches {example_launches} on {card}")
    parts = {"example": time.perf_counter() - t0}
    # (b) 300x300, B=32: naive against graph
    batches = _ssd_batches(3, SSD300_B, SSD300_SIZE)
    net0 = _ssd_net(SSD300_SIZE)
    init = [p.detach().clone() for _, p in sorted(net0.named_parameters())]
    if len(init) != 24:
        raise AssertionError(f"ssd: {len(init)} parameter tensors")
    x0 = batches[0][0]
    with torch.no_grad():
        anchors = net0(x0[:1])[0]
    if anchors.shape[1] != SSD300_ANCHORS:
        raise AssertionError(f"ssd300: {anchors.shape[1]} anchors")
    macs, macs0 = _vision_flops(net0, x0)
    flops = 2 * (3 * macs - macs0) * SSD300_B
    del net0
    runs = {}
    for mode in ("naive", "graph"):
        net = _ssd_net(SSD300_SIZE)
        _restore(net, init)
        ts = _ssd_step(net, mode, SSD300_B)
        runs[mode] = ([float(ts(*b)) for b in batches], _state(ts, host=True),
                      ts.compiled_programs)
        del ts, net
        _release()
    same = runs["naive"][0] == runs["graph"][0] and \
        _same_state(runs["naive"][1], runs["graph"][1])
    log(f"[ssd300] TrainStep 3 steps, 300x300, B={SSD300_B}, "
        f"{SSD300_ANCHORS} anchors, MultiBoxTarget inside the step: graph "
        f"{'==' if same else '!='} naive bit for bit (losses naive "
        f"{runs['naive'][0]}, graph {runs['graph'][0]}; programs "
        f"{runs['graph'][2]})")
    if not same or runs["graph"][2] != 1:
        raise AssertionError("ssd300: graph != naive, or more than one "
                             "program")
    res["parity"] = {"losses": runs["graph"][0]}
    del runs
    parts["parity"] = time.perf_counter() - t0 - sum(parts.values())
    net = _ssd_net(SSD300_SIZE)
    _restore(net, init)
    ts = _ssd_step(net, "graph", SSD300_B)
    x, y = batches[0]
    total = dict.fromkeys(SSD_WANT, 0)
    step_losses = []
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    for i in range(12):
        if i == 2:
            torch.cuda.synchronize()
            t = time.perf_counter()
        before = _launch_counts()
        step_losses.append(ts(x, y))
        got = {k: v - before[k] for k, v in _launch_counts().items()}
        if got != SSD_WANT:
            raise AssertionError(f"ssd300 graph step {i}: launches {got}, "
                                 f"expected {SSD_WANT}")
        for k in total:
            total[k] += got[k]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    step_losses = [float(v) for v in step_losses]
    if not all(np.isfinite(step_losses)) or \
            not step_losses[-1] < step_losses[0] or ts.compiled_programs != 1:
        raise AssertionError(f"ssd300 graph: losses {step_losses}, "
                             f"{ts.compiled_programs} programs")
    ms = wall / 10 * 1e3
    (prog, _, _), = ts._programs.values()
    step = {"ms_per_step": ms, "images_per_s": SSD300_B / ms * 1e3,
            "flops_per_step": flops,
            "mfu": flops / (ms * 1e-3) / F32_FLOPS_PER_S,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "losses": step_losses,
            "replay_launches": check_replay_launches(prog, "ssd300 step "
                                                     "graph"),
            "breakdown": _device_groups(prog.graph.replay, 5,
                                        "ssd300 graph step", ms)}
    log(f"[ssd300 graph] 300x300, B={SSD300_B}, TrainStep Adam, 10 timed "
        f"steps: {ms:.2f} ms/step, {step['images_per_s']:.1f} images/s, MFU "
        f"{step['mfu']:.4f} ({flops:.4e} flops a step over the f32 CUDA "
        f"cores' 67 TFLOP/s), peak {step['peak_bytes'] / 2**30:.2f} GiB "
        f"allocated / {step['peak_reserved_bytes'] / 2**30:.2f} reserved; "
        f"losses {['%.4f' % v for v in step_losses]}; top kernels "
        f"{step['breakdown'].get('top_kernels_ms')} on {card}")
    res["ssd300"] = step
    del ts
    _release()
    parts["ssd300"] = time.perf_counter() - t0 - sum(parts.values())
    # (c) detection times
    with torch.no_grad():
        anchors, cls_preds, box_preds = net(x)
        prob = torch.softmax(cls_preds, -1).transpose(1, 2).contiguous()

        def det300():
            return cv.multibox_detection(prob, box_preds, anchors,
                                         nms_topk=SSD_NMS_TOPK)

        out300 = det300()
        det = {"ms_300": graph_time_ms(det300, calls=1, replays=3, repeats=3),
               "eager_ms_300": cuda_time_ms(det300, warmup=1, iters=3,
                                            repeats=3),
               "launches_300": _profiled_count(det300, ""),
               "kept_300": int((out300[..., 0] >= 0).sum())}
        # its greedy loop alone (400 rows, two launches each), and the
        # stable sort of MultiBoxTarget's mining at this shape
        sup = torch.rand(SSD300_B, SSD_NMS_TOPK, SSD_NMS_TOPK,
                         device="cuda") > 0.9
        keep = torch.ones(SSD300_B, SSD_NMS_TOPK, dtype=torch.bool,
                          device="cuda")
        det["nms_loop_ms_300"] = graph_time_ms(
            lambda: cv._greedy_keep(sup, keep), calls=1, replays=3,
            repeats=3)
        neg = torch.rand(SSD300_B, SSD300_ANCHORS, device="cuda")
        det["mining_sort_ms_300"] = graph_time_ms(
            lambda: torch.sort(neg, dim=1, stable=True), calls=1, replays=3,
            repeats=3)
    small = _ssd_net(SSD_SIZE)
    imgs = mx.nd.array(_ssd_batches(1, SSD_B, SSD_SIZE, seed=1)[0][0])

    def det32():
        return small.detect(imgs, threshold=0.3)

    det.update(ms_32=cuda_time_ms(det32, warmup=1, iters=3, repeats=3),
               launches_32=_profiled_count(det32, ""))
    log(f"[ssd detect] MultiBoxDetection(nms_topk={SSD_NMS_TOPK}) at "
        f"300x300, B={SSD300_B}: {det['ms_300']:.3f} ms device (eager "
        f"{det['eager_ms_300']:.3f}), {det['launches_300']} launches, "
        f"{det['kept_300']} rows kept (its greedy loop alone "
        f"{det['nms_loop_ms_300']:.3f} ms; the mining's stable sort of "
        f"({SSD300_B}, {SSD300_ANCHORS}) {det['mining_sort_ms_300']:.3f} "
        f"ms); detect at 32x32, B={SSD_B} (eager, "
        f"nms_topk -1): {det['ms_32']:.3f} ms, {det['launches_32']} launches")
    res["detect"] = det
    del small, prob, out300
    parts["detect"] = time.perf_counter() - t0 - sum(parts.values())
    res["seconds"] = time.perf_counter() - t0
    res["seconds_by_part"] = parts
    log(f"[ssd seconds] {res['seconds']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return example_launches, total, net, res


def phase_ssd_timing(net):
    """The Adam kernel over the SSD's 24 tensors (``_adam_row``)."""
    return {"adam_ssd": _adam_row(net, torch.Generator().manual_seed(52))}


class _LogLines(logging.Handler):
    """The messages of the log records emitted while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_estimator(card):
    """``[estimator]``: chip_smoke's LeNet (``_lenet_net``, seeded batches of
    ``_lenet_data``) on the card through the Gluon Estimator:

    (a) ``Estimator.fit`` for 2 epochs of 4 batches with every handler
        (Logging, Checkpoint with save_best, EarlyStopping, Metric,
        GradientUpdate, Validation every 2 batches, Stopping, Preemption),
        telemetry on: the parameters bit-identical to a hand-written
        ``record`` / ``backward`` / ``Trainer.step`` loop over the same
        batches, one Adam launch a step; LoggingHandler's lines carry the
        registry's loss and throughput;
    (b) a SIGTERM sent at batch 2 goes through PreemptionHandler (the
        step's parameters and trainer states saved, the fit stopped); a
        fresh net and trainer resumed from them take the next step with
        the loss of the uninterrupted loop's, bit for bit;
    (c) ``callback.Speedometer`` logs the registry's samples/s (its second
        line equals the registry's delta);
    (d) ``test_utils.check_consistency`` (CPU against the card) on a few
        ops.

    Returns the launches of (a) and the results."""
    import signal

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.gluon.contrib import estimator as est

    t0 = time.perf_counter()
    data = [(mx.nd.array(x), mx.nd.array(y)) for x, y in _lenet_data(6)]
    train, val = data[:4], data[4:]
    net0 = _lenet_net(mx)
    init = [p.detach().clone() for _, p in sorted(net0.named_parameters())]
    del net0
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def trainer(net):
        return mx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": LENET_LR})

    hnet = _lenet_net(mx, init)
    htr = trainer(hnet)
    hand = [float(_gluon_step(mx, hnet, htr, loss_fn, *b))
            for _ in range(2) for b in train]
    res = {"card": card}
    lines = _LogLines()
    logging.getLogger().addHandler(lines)
    logging.getLogger().setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory() as d:
            obs.enable(os.path.join(d, "telemetry"))
            try:
                enet = _lenet_net(mx, init)
                e = est.Estimator(enet, loss_fn, train_metrics="acc",
                                  trainer=trainer(enet))
                handlers = [est.LoggingHandler(log_interval=2),
                            est.CheckpointHandler(d, save_best=True),
                            est.EarlyStoppingHandler(monitor="accuracy",
                                                     patience=10),
                            est.ValidationHandler(val, batch_period=2),
                            est.StoppingHandler(max_epoch=2),
                            est.PreemptionHandler(d)]
                torch.cuda.synchronize()
                _reset_launch_counts()
                t = time.perf_counter()
                e.fit(train, epochs=3, event_handlers=handlers)
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t
                launches = _launch_counts()
                # (c) the Speedometer over 4 Trainer steps
                meter = mx.callback.Speedometer(LENET_B, frequent=2)
                snet = _lenet_net(mx, init)
                st = trainer(snet)
                param = SimpleNamespace(epoch=0, nbatch=0, eval_metric=None)
                meter(param)
                marks = []
                for i, b in enumerate(train, 1):
                    _gluon_step(mx, snet, st, loss_fn, *b)
                    param.nbatch = i
                    meter(param)
                    if i % 2 == 0:
                        marks.append((
                            obs.REGISTRY.get("train_samples_total").total(),
                            obs.REGISTRY.get("train_step_seconds")
                            .total_sum()))
            finally:
                obs.disable()
            files = sorted(os.listdir(d))
            diff = [k for (k, a), (_, b) in zip(
                sorted(enet.named_parameters()),
                sorted(hnet.named_parameters())) if not torch.equal(a, b)]
            want = {k: v * 8 for k, v in LENET_WANT.items()}
            batch_lines = [s for s in lines.lines if s.startswith("Batch[")]
            log(f"[estimator] Estimator.fit, LeNet B={LENET_B}, 2 epochs of "
                f"4 batches, every handler, telemetry on: {fit_s:.2f} s; "
                f"parameters that differ from the hand-written loop: "
                f"{diff or 'none'}; launches {launches}; files {files}; "
                f"last log line {batch_lines[-1] if batch_lines else None}")
            if diff or launches != want:
                raise AssertionError("estimator: fit differs from the "
                                     "hand-written loop, or launched other "
                                     "than one Adam and one xent pair a step")
            if not any("throughput=" in s and " loss=" in s
                       for s in batch_lines):
                raise AssertionError("estimator: LoggingHandler did not read "
                                     "the registry")
            if "model-best.params" not in files or \
                    "model-0001.params" not in files:
                raise AssertionError(f"estimator: checkpoints {files}")
            speeds = [float(s.split("Speed: ")[1].split(" ")[0])
                      for s in lines.lines if "Speed: " in s]
            (s0, t0_), (s1, t1_) = marks
            reg_speed = (s1 - s0) / (t1_ - t0_)
            log(f"[estimator] Speedometer lines {speeds} samples/s; the "
                f"registry's between them {reg_speed:.1f}")
            if len(speeds) != 2 or abs(speeds[1] / reg_speed - 1) > 1e-3:
                raise AssertionError("estimator: the Speedometer did not "
                                     "read the registry")
            res["fit"] = {"seconds": fit_s, "files": files,
                          "speedometer": speeds, "registry_speed": reg_speed}
            # (b) SIGTERM at batch 2, then a resume
            pnet = _lenet_net(mx, init)
            ptr = trainer(pnet)

            class Kill(est.BatchBegin):
                def batch_begin(self, estimator, batch=None, **kw):
                    if batch == 2:
                        os.kill(os.getpid(), signal.SIGTERM)

            pre = est.PreemptionHandler(d, model_prefix="pre")
            e = est.Estimator(pnet, loss_fn, trainer=ptr)
            e.fit(train, epochs=1, event_handlers=[Kill(), pre])
            if not pre.stop_training:
                raise AssertionError("estimator: SIGTERM did not stop fit")
            rnet = _lenet_net(mx, init)
            rnet.load_parameters(os.path.join(d, "pre-preempt.params"),
                                 ctx=mx.gpu())
            rtr = trainer(rnet)
            rtr.load_states(os.path.join(d, "pre-preempt.states"))
            resumed = float(_gluon_step(mx, rnet, rtr, loss_fn, *train[3]))
            log(f"[estimator] SIGTERM at batch 2: saved "
                f"{sorted(f for f in os.listdir(d) if f.startswith('pre'))},"
                f" fit stopped; the resumed step's loss {resumed} against "
                f"the uninterrupted loop's {hand[3]}")
            if resumed != hand[3]:
                raise AssertionError("estimator: the resumed step differs")
            res["preemption"] = {"resumed_loss": resumed, "want": hand[3]}
    finally:
        logging.getLogger().removeHandler(lines)
    # (d) check_consistency
    x = np.random.RandomState(5).randn(64, 128).astype(np.float32)
    checks = {"softmax": lambda v: mx.nd.softmax(v, axis=-1),
              "dot": lambda v: mx.nd.dot(v, v, transpose_b=True),
              "box_iou": lambda v: mx.nd.contrib.box_iou(v[:, :4].abs(),
                                                         v[:, 4:8].abs())}
    for name, fn in checks.items():
        mx.test_utils.check_consistency(fn, [x])
    res["check_consistency"] = sorted(checks)
    res["seconds"] = time.perf_counter() - t0
    log(f"[estimator] check_consistency CPU against the card: "
        f"{sorted(checks)}; phase {res['seconds']:.1f} s")
    _release()
    return launches, res


# ---------------------------------------------------------------------------
# the symbolic API: mx.sym, HybridBlock.export and
# SymbolBlock, mx.operator, Module / BucketingModule and mx.rnn
# ---------------------------------------------------------------------------
SYM_NAMES = ("src_ids", "tgt_ids", "src_valid")
# the imported transformer_base's forward launches what the Gluon net's
# does: the decoder's 6 causal self-attentions on the flash forward and 30
# LayerNorms (2 an encoder layer, 3 a decoder layer); a fine-tune step
# launches a TrainStep step's kernels (TF_WANT)
SYM_FWD_WANT = dict(dict.fromkeys(TF_WANT, 0), flash_fwd=TF_LAYERS,
                    layernorm=5 * TF_LAYERS)
SYM_STEPS, SYM_LR = 3, 1e-4
# the CPU tests' f32 limits (tests/test_torch_transformer.py): logits and
# losses rtol = atol = 1e-4; after three Adam steps no weight beyond the
# sign-flip bound 2.01 * lr * steps and 99.9% of them within 1e-2 * lr
SYM_TOL, SYM_FAR = 1e-4, 1e-3
RESNET_SYM_B = 32
# MXNet's example/rnn/bucketing/lstm_bucketing.py: 2 layers of
# LSTMCell(200), Embedding 200, batch 32, buckets 10..60, invalid label 0,
# Xavier(factor_type="in", magnitude=2.34); PTB's vocabulary size
LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS, LM_B = 10000, 200, 200, 2, 32
LM_BUCKETS = (10, 20, 30, 40, 50, 60)
LM_SENTENCES, LM_EPOCHS, LM_LR = 1152, 2, 1e-2
# a bucketing LM update: one multi-tensor Adam over its 11 tensors, no
# other kernel of the port (the LSTM cells are registry compositions)
LM_WANT = dict(dict.fromkeys(TF_WANT, 0), adam=1)


def _sync_ms(fn, n=5):
    """Mean host time of ``n`` calls of ``fn``, each ended by a sync (after
    one untimed call)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def _weights_close(what, got, want, lr, steps, far_limit):
    """Adam's sign-flip bound over parameters paired by name."""
    err = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    worst = err.max().item()
    far = (err > 1e-2 * lr).float().mean().item()
    bound = 2.01 * lr * steps
    log(f"[{what}] max |weight diff| {worst:.3e} (bound {bound:.3e}), share "
        f"beyond 1e-2*lr {far:.2e} (limit {far_limit})")
    if worst > bound or far > far_limit:
        raise AssertionError(f"{what}: weights differ beyond the Adam "
                             f"sign-flip bound, or too many beyond 1e-2*lr")
    return {"max_weight_diff": worst, "weight_bound": bound,
            "share_beyond_1e-2_lr": far}


def _sym_transformer(mx, d):
    """transformer_base (f32, dropout 0, seed TF_SEED) exported into ``d``
    and imported back on the card; the Gluon net, the SymbolBlock and the
    export's op counts."""
    net = _tf_net("transformer_base")
    t = time.perf_counter()
    sym_file, params = net.export(os.path.join(d, "transformer_base"),
                                  input_names=SYM_NAMES)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    sb = mx.gluon.SymbolBlock.imports(sym_file, list(SYM_NAMES), params)
    import_s = time.perf_counter() - t
    nodes = json.load(open(sym_file))["nodes"]
    ops = collections.Counter(n["op"] for n in nodes)
    args = mx.sym.load(sym_file).list_arguments()
    log(f"[symbol] transformer_base exported in {export_s:.2f} s: "
        f"{len(nodes)} nodes, {len(args)} arguments, "
        f"{os.path.getsize(sym_file)} bytes of symbol.json, "
        f"{os.path.getsize(params)} of params; LayerNorm "
        f"{ops['LayerNorm']}, multi_head_attention "
        f"{ops['multi_head_attention']}; imported in {import_s:.2f} s")
    if ops["LayerNorm"] != 5 * TF_LAYERS or \
            ops["multi_head_attention"] != 3 * TF_LAYERS:
        raise AssertionError(f"symbol: transformer_base export ops {ops}")
    return net, sb, {"nodes": len(nodes), "arguments": len(args),
                     "export_s": export_s, "import_s": import_s}


def _sym_forward(mx, block, batch):
    """One imperative forward of ``block`` on the NDArrays of ``batch``,
    with its launches."""
    torch.cuda.synchronize()
    _reset_launch_counts()
    out = block(*[mx.nd.array(a) for a in batch[:3]])
    torch.cuda.synchronize()
    return out, _launch_counts()


def _sym_finetune(mx, block, batches):
    """SYM_STEPS Gluon ``Trainer("adam")`` steps of ``block`` on the
    label-smoothed loss: the losses, the launches of each step and the
    parameters by name after."""
    from mxnet_tpu_torch.models.transformer import label_smoothing_loss

    tr = mx.gluon.Trainer(block.collect_params(), "adam",
                          {"learning_rate": SYM_LR})
    losses, launches = [], []
    for batch in batches:
        src, tgt, valid, labels = [mx.nd.array(a) for a in batch]
        torch.cuda.synchronize()
        _reset_launch_counts()
        with mx.autograd.record():
            loss = label_smoothing_loss(block(src, tgt, valid), labels,
                                        epsilon=0.1, ignore_index=0)
        loss.backward()
        tr.step(1)
        torch.cuda.synchronize()
        launches.append(_launch_counts())
        losses.append(float(loss.asnumpy()))
    return losses, launches, {p.name: p.tensor().detach().clone()
                              for p in block.collect_params().values()}


def phase_symbol(card):
    """``[symbol]``: the deploy path of the symbolic API on the card.

    (a) transformer_base (6 + 6 layers, 512 units, 8 heads, FFN 2048, f32,
        dropout 0) through ``net.export`` and ``SymbolBlock.imports`` on
        the card; the imported block's forward on the first bucket-32
        batch (B=64, ragged src_valid) against the Gluon net's at SYM_TOL,
        launching what the Gluon forward launches (SYM_FWD_WANT); ms a
        forward of each; then SYM_STEPS Gluon ``Trainer("adam")`` steps of
        each from the same weights: losses at SYM_TOL, every step
        launching TF_WANT (the flash backward pair, the LayerNorm
        backward, one Adam), the weights within the sign-flip bound;
    (b) resnet50_v1 (224x224, B=32) exported and imported: its forward
        against the Gluon net's at the CPU tests' 1e-3 / 1e-4;
    (c) the JAX test's CustomOp ``Sigmoid`` (nd ops only) as the step of a
        captured ``StepGraph``, replayed, against the CPU; its gradient
        through ``nd.Custom`` under ``record`` on the card against the
        CPU;
    (d) an ``Executor`` (FullyConnected, tanh, sum; ``grad_req`` write and
        add) bound on the card against one bound on the CPU.

    Returns the launches of the imported forward, those of its fine-tune
    (summed) and the results."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda_graph import StepGraph, capture_stream

    t0 = time.perf_counter()
    res = {"card": card}
    batches = _tf_batches()[32]
    first = batches[0][0]
    with tempfile.TemporaryDirectory() as d:
        net, sb, res["export"] = _sym_transformer(mx, d)
        g_out, g_launch = _sym_forward(mx, net, first)
        s_out, s_launch = _sym_forward(mx, sb, first)
        diff = (s_out._data - g_out._data).abs().max().item()
        scale = g_out._data.abs().max().item()
        log(f"[symbol] imported transformer_base forward B={TF_B}, T=32: "
            f"max |diff| {diff:.3e} against the Gluon net's (max |logit| "
            f"{scale:.3f}); launches {s_launch}, the Gluon forward's "
            f"{g_launch}")
        ok = torch.allclose(s_out._data, g_out._data, rtol=SYM_TOL,
                            atol=SYM_TOL)
        if not ok or s_launch != g_launch or s_launch != SYM_FWD_WANT:
            raise AssertionError("symbol: the imported transformer_base "
                                 "differs from the Gluon net, or launched "
                                 "other kernels")
        src = [mx.nd.array(a) for a in first[:3]]
        ms = {"gluon": _sync_ms(lambda: net(*src)),
              "symbolblock": _sync_ms(lambda: sb(*src))}
        log(f"[symbol] ms a forward (host clock, synced): SymbolBlock "
            f"{ms['symbolblock']:.3f}, Gluon net {ms['gluon']:.3f}")
        res["forward"] = {"max_abs_diff": diff, "max_abs_logit": scale,
                          "launches": s_launch, "ms": ms}
        steps = [b for b, _ in batches[1:1 + SYM_STEPS]]
        g_losses, g_steps, g_w = _sym_finetune(mx, net, steps)
        s_losses, s_steps, s_w = _sym_finetune(mx, sb, steps)
        log(f"[symbol] {SYM_STEPS} Trainer('adam') steps at lr {SYM_LR}: "
            f"losses {s_losses}, the Gluon net's {g_losses}; launches a "
            f"step {s_steps[0]}")
        for a, b in zip(s_losses, g_losses):
            if not abs(a - b) <= SYM_TOL + SYM_TOL * abs(b):
                raise AssertionError("symbol: fine-tune losses differ")
        if any(s != TF_WANT for s in s_steps + g_steps):
            raise AssertionError(f"symbol: fine-tune steps launched "
                                 f"{s_steps}, expected {TF_WANT}")
        if sorted(s_w) != sorted(g_w):
            raise AssertionError("symbol: parameter names differ")
        res["finetune"] = dict(_weights_close(
            "symbol", s_w, g_w, SYM_LR, SYM_STEPS, SYM_FAR),
            losses=s_losses, gluon_losses=g_losses)
        finetune = {k: sum(s[k] for s in s_steps) for k in TF_WANT}
        del net, sb, g_out, s_out, g_w, s_w
        _release()
        # (b) resnet50_v1 and back
        mx.random.seed(0)
        rnet = mx.gluon.model_zoo.vision.get_model("resnet50_v1",
                                                   classes=1000)
        rnet.initialize(mx.init.MSRAPrelu())
        x = mx.nd.array(np.random.RandomState(0).rand(
            RESNET_SYM_B, 3, 224, 224).astype(np.float32))
        want = rnet(x)
        t = time.perf_counter()
        rfile, rparams = rnet.export(os.path.join(d, "resnet50_v1"))
        rsb = mx.gluon.SymbolBlock.imports(rfile, ["data"], rparams)
        got = rsb(x)
        torch.cuda.synchronize()
        rdiff = (got._data - want._data).abs().max().item()
        nodes = len(json.load(open(rfile))["nodes"])
        log(f"[symbol] resnet50_v1 B={RESNET_SYM_B} export, import and "
            f"forward {time.perf_counter() - t:.2f} s ({nodes} nodes, "
            f"{len(rsb.collect_params())} parameters): max |diff| "
            f"{rdiff:.3e} against the Gluon forward")
        if not torch.allclose(got._data, want._data, rtol=1e-3, atol=1e-4):
            raise AssertionError("symbol: resnet50_v1 round trip differs")
        res["resnet50_v1"] = {"max_abs_diff": rdiff, "nodes": nodes}
        del rnet, rsb, x, want, got
        _release()

    # (c) CustomOp: JAX's test Sigmoid, nd ops only
    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1.0 / (1.0 + mx.nd.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @mx.operator.register("chip_smoke_sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    dev = torch.device("cuda")
    xs = torch.from_numpy(np.random.RandomState(1).uniform(
        -4, 4, (TF_B * 32, 512)).astype(np.float32))
    fn, _ = mx.operator.make_custom_fn("chip_smoke_sigmoid", {})
    x_dev = xs.to(dev)

    class Owner:  # the capture stream's owner (held by a weak reference)
        pass

    owner = Owner()
    graph = StepGraph(lambda: (fn(x_dev),), ("custom",), dev,
                      stream=capture_stream(owner, dev))
    for _ in range(3):  # warm-up, capture and replay, replay
        (out,) = graph()
    torch.cuda.synchronize()
    cerr = (out.cpu() - fn(xs)).abs().max().item()

    def custom_grad(ctx):
        a = mx.nd.array(xs.numpy(), ctx=ctx)
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(a, op_type="chip_smoke_sigmoid")
        y.backward()
        return a.grad.asnumpy()
    gerr = float(np.abs(custom_grad(mx.gpu()) - custom_grad(mx.cpu())).max())
    log(f"[symbol] CustomOp Sigmoid at ({TF_B * 32}, 512): captured "
        f"{graph.graph is not None}, replayed {graph.calls - 1} times, max "
        f"|diff| against the CPU {cerr:.3e}; gradient through nd.Custom "
        f"{gerr:.3e}")
    if graph.graph is None or cerr > 1e-6 or gerr > 1e-6:
        raise AssertionError("symbol: the CustomOp differs from the CPU or "
                             "was not captured")
    res["custom_op"] = {"captured": True, "max_abs_diff": cerr,
                        "grad_max_abs_diff": gerr}
    del graph, owner

    # (d) an Executor on the card against one on the CPU
    def executor(ctx, req):
        sym = mx.sym
        y = sym.sum(sym.tanh(sym.FullyConnected(
            sym.var("x"), num_hidden=256, name="fc")) ** 2)
        rs = np.random.RandomState(2)
        ex = y.simple_bind(ctx=ctx, grad_req=req, x=(64, 512))
        for k in ("x", "fc_weight", "fc_bias"):
            ex.arg_dict[k][:] = rs.normal(0, 0.1, ex.arg_dict[k].shape)
        outs = []
        for _ in range(2):
            outs.append(ex.forward(is_train=True)[0].asnumpy())
            ex.backward()
        return outs + [ex.grad_dict[k].asnumpy() for k in sorted(ex.grad_dict)]
    eerr = 0.0
    for req in ("write", "add"):
        for a, b in zip(executor(mx.gpu(), req), executor(mx.cpu(), req)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            eerr = max(eerr, float(np.abs(a - b).max()))
    log(f"[symbol] Executor forward/backward (grad_req write and add) on "
        f"the card against the CPU: max |diff| {eerr:.3e}")
    res["executor"] = {"max_abs_diff": eerr}
    res["seconds"] = time.perf_counter() - t0
    log(f"[symbol] phase {res['seconds']:.1f} s")
    _release()
    return s_launch, finetune, res


def _lm_elements():
    """The LM's parameter count: embedding, each LSTM layer's i2h and h2h
    weights and biases, the output layer (4,653,200 at the example's
    widths)."""
    lstm = sum(4 * LM_HIDDEN * (LM_EMBED if i == 0 else LM_HIDDEN) +
               4 * LM_HIDDEN * LM_HIDDEN + 8 * LM_HIDDEN
               for i in range(LM_LAYERS))
    return LM_VOCAB * LM_EMBED + lstm + LM_VOCAB * LM_HIDDEN + LM_VOCAB


def _lm_sentences(seed=0):
    """LM_SENTENCES synthetic sentences over LM_VOCAB ids (0 is padding),
    lengths spread over 2..60 so that every bucket gets batches; ids drawn
    by rank with probability 1/rank (Zipf's law, as words are), and half
    the time the successor that a fixed permutation gives the previous id
    (structure to learn)."""
    rs = np.random.RandomState(seed)
    nxt = rs.permutation(LM_VOCAB - 1) + 1
    p = 1.0 / np.arange(1, LM_VOCAB)
    lens = rs.randint(2, LM_BUCKETS[-1] + 1, LM_SENTENCES)
    draws = rs.choice(LM_VOCAB - 1, size=int(lens.sum()), p=p / p.sum()) + 1
    follow = rs.rand(int(lens.sum())) < 0.5
    out, k = [], 0
    for n in lens:
        s = [int(draws[k])]
        for j in range(1, n):
            s.append(int(nxt[s[-1] - 1]) if follow[k + j] else
                     int(draws[k + j]))
        out.append(s)
        k += n
    return out


def _lm_sym_gen(mx):
    """MXNet's lstm_bucketing.py symbol: Embedding, the unrolled stack of
    LSTMCells, FullyConnected over the vocabulary, SoftmaxOutput."""
    stack = mx.rnn.SequentialRNNCell()
    for i in range(LM_LAYERS):
        stack.add(mx.rnn.LSTMCell(num_hidden=LM_HIDDEN, prefix=f"lstm_l{i}_"))

    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=LM_VOCAB,
                                 output_dim=LM_EMBED, name="embed")
        outputs, _ = stack.unroll(seq_len, embed, merge_outputs=True)
        pred = mx.sym.reshape(outputs, shape=(-1, LM_HIDDEN))
        pred = mx.sym.FullyConnected(pred, num_hidden=LM_VOCAB, name="pred")
        label = mx.sym.reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


class _Recorded:
    """A data iterator that records each batch it gives (its bucket and
    its tokens that are not padding)."""

    def __init__(self, it):
        self.it, self.seen = it, []
        self.provide_data, self.provide_label = it.provide_data, \
            it.provide_label

    def reset(self):
        self.it.reset()

    def __iter__(self):
        for b in self.it:
            self.seen.append((b.bucket_key, int((b.label[0]._data != 0)
                                                .sum())))
            yield b


def phase_module(card):
    """``[module]``: the bucketing LSTM language model of MXNet's
    example/rnn/bucketing/lstm_bucketing.py at its widths (2 x
    LSTMCell(200), Embedding 200, vocabulary 10,000, B=32, buckets 10..60,
    invalid label 0, Xavier(in, 2.34)) trained through
    ``BucketingModule.fit`` with ``optimizer="adam"``, ``Perplexity(0)``
    and ``Speedometer`` on LM_SENTENCES synthetic sentences (``_lm_sentences``)
    for LM_EPOCHS epochs: the perplexity over the data before and after
    (it must fall), one Adam launch an update and nothing else of the
    port's kernels, per-bucket ms a batch and tokens/s (host clock, each
    batch synced); the
    device time, idle share, device operations and top kernels of one
    bucket-60 batch (forward, backward, update) under the profiler
    (``_device_groups``); then
    ``save_checkpoint(save_optimizer_states=True)`` and ``Module.load``:
    the parameters and a bucket-60 forward bit for bit. Returns the fit's
    launches and the results."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    res = {"card": card}
    mx.random.seed(0)
    it = mx.rnn.BucketSentenceIter(_lm_sentences(), batch_size=LM_B,
                                   buckets=list(LM_BUCKETS), invalid_label=0,
                                   shuffle_seed=0)
    counts = collections.Counter(b.bucket_key for b in it)
    it.reset()
    mod = mx.mod.BucketingModule(_lm_sym_gen(mx),
                                 default_bucket_key=LM_BUCKETS[-1],
                                 context=mx.gpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier(factor_type="in",
                                               magnitude=2.34))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": LM_LR})
    arg, _ = mod.get_params()
    n_el = sum(v.size for v in arg.values())
    log(f"[module] bucketing LM: {len(arg)} tensors, {n_el} elements; "
        f"batches a bucket {dict(sorted(counts.items()))}")
    if (len(arg), n_el) != (3 + 4 * LM_LAYERS, _lm_elements()):
        raise AssertionError(f"module: {len(arg)} tensors of {n_el}")
    before = mod.score(it, mx.metric.Perplexity(0))[0][1]
    rec = _Recorded(it)
    stamps = []

    def timer(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    lines = _LogLines()
    logging.getLogger().addHandler(lines)
    logging.getLogger().setLevel(logging.INFO)
    try:
        torch.cuda.synchronize()
        _reset_launch_counts()
        t = time.perf_counter()
        stamps.append(t)
        mod.fit(rec, eval_metric=mx.metric.Perplexity(0),
                batch_end_callback=[mx.callback.Speedometer(LM_B, 10),
                                    timer],
                optimizer="adam", num_epoch=LM_EPOCHS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = _launch_counts()
    finally:
        logging.getLogger().removeHandler(lines)
    updates = len(rec.seen)
    after = mod.score(it, mx.metric.Perplexity(0))[0][1]
    speed = [s for s in lines.lines if "Speed:" in s]
    want = {k: v * updates for k, v in LM_WANT.items()}
    log(f"[module] BucketingModule.fit, {LM_EPOCHS} epochs, {updates} "
        f"updates in {fit_s:.2f} s: perplexity {before:.2f} before, "
        f"{after:.2f} after; launches {launches}; Speedometer "
        f"{speed[0] if speed else None} ... {speed[-1] if speed else None}")
    if not after < before or launches != want or not speed:
        raise AssertionError("module: the perplexity did not fall, or the "
                             "updates launched other than one Adam each")
    # per-bucket ms a batch (every bucket was bound by the score before)
    by_bucket = collections.defaultdict(list)
    for (key, tokens), dt in zip(rec.seen, np.diff(stamps)):
        by_bucket[key].append((dt * 1e3, tokens))
    per_bucket = {k: {"ms_batch": statistics.median(d for d, _ in v),
                      "tokens_s": sum(n for _, n in v) /
                      (sum(d for d, _ in v) / 1e3), "batches": len(v)}
                  for k, v in sorted(by_bucket.items())}
    log("[module] per bucket (median ms a batch, tokens/s not counting "
        "padding): " + "; ".join(
            f"{k}: {v['ms_batch']:.1f} ms, {v['tokens_s']:.0f} tok/s"
            for k, v in per_bucket.items()))
    res.update(perplexity_before=before, perplexity_after=after,
               updates=updates, fit_s=fit_s, per_bucket=per_bucket,
               adam_launches_per_update=launches["adam"] / updates,
               speedometer=speed[-1])
    # one bucket-60 batch under the profiler
    it.reset()
    b60 = next(b for b in it if b.bucket_key == LM_BUCKETS[-1])

    def step():
        mod.forward_backward(b60)
        mod.update()
    res["profile_bucket_60"] = _device_groups(
        step, 1, "module bucket 60 (forward, backward, update)",
        _sync_ms(step, n=3))
    # the checkpoint and Module.load
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "lm")
        mod.save_checkpoint(prefix, LM_EPOCHS, save_optimizer_states=True)
        mod.forward(b60, is_train=False)
        want_out = mod.get_outputs()[0]._data.clone()
        mod2 = mx.mod.Module.load(prefix, LM_EPOCHS, data_names=("data",),
                                  label_names=("softmax_label",),
                                  context=mx.gpu())
        mod2.bind(data_shapes=b60.provide_data,
                  label_shapes=b60.provide_label, for_training=False)
        mod2.init_params_from_pending()
        mod2.forward(b60, is_train=False)
        got = mod2.get_outputs()[0]._data
        p1, p2 = mod.get_params()[0], mod2.get_params()[0]
        same = sorted(p1) == sorted(p2) and all(
            torch.equal(p1[k]._data, p2[k]._data) for k in p1)
        files = sorted(os.listdir(d))
    log(f"[module] save_checkpoint(save_optimizer_states=True) wrote "
        f"{files}; Module.load: parameters equal {same}, bucket-60 "
        f"outputs equal {torch.equal(got, want_out)}")
    if not same or not torch.equal(got, want_out):
        raise AssertionError("module: Module.load differs from the saved "
                             "module")
    res["checkpoint"] = {"files": files, "bit_identical": True}
    res["timing_params"] = [v._data for v in p1.values()]
    res["seconds"] = time.perf_counter() - t0
    log(f"[module] phase {res['seconds']:.1f} s")
    return launches, res


def phase_symbol_timing(lm_params):
    """The kernels at the symbolic paths' shapes: LayerNorm forward and
    backward in f32 at (2048, 512) (the imported transformer_base, B=64 x
    T=32 rows) and Adam over the bucketing LM's 11 tensors (4,653,200
    elements). The imported block's flash launches run at the f32 rows
    phase_transformer_timing measures (64, 8, 32, 32, D 64)."""
    gen = torch.Generator().manual_seed(20)
    fwd, bwd, _ = _ln_rows(gen, TF_B * 32, torch.float32, d=512)
    lm = SimpleNamespace(parameters=lambda: lm_params)
    return {"layernorm_symbol": fwd, "layernorm_bwd_symbol": bwd,
            "adam_bucketing_lm": _adam_row(lm, gen)}


# ---------------------------------------------------------------------------
# Row-sparse and CSR storage (ndarray/sparse.py): the lazy updates of
# Embedding(sparse_grad=True) through gluon.Trainer, the CSR product, the
# storage casts and sparse .params on the card; mx.np (numpy_api.py)
# ---------------------------------------------------------------------------
SPARSE_STEPS = 20
SPARSE_WD = 1e-5
# each step of the row-sparse word LM: the xent pair on the (700, 10000)
# logits and two Adam launches, the embedding's touched rows (the lazy
# block) and the other tensors
SPARSE_WANT = dict(WLM_WANT, adam=2)
# LM1B's vocabulary (Jozefowicz et al. 2016, "Exploring the limits of
# language modeling") at width 512: 1.63 GB of f32 table
LM1B_VOCAB, LM1B_WIDTH = 793471, 512
# Criteo's 13 + 26 fields, one nonzero each, hashed into 2^20 columns
CSR_ROWS, CSR_FIELDS, CSR_COLS, CSR_K = 8192, 39, 1 << 20, 16
CSR_TOL = (1e-5, 1e-5)  # (rtol, atol) against torch.matmul of a dense slice


def _sparse_lm(vocab=WLM_VOCAB, width=WLM_WIDTH, layers=WLM_LAYERS,
               sparse=True, seed=0):
    """The word LM untied, its embedding's gradient row-sparse:
    Embedding(vocab, width, sparse_grad=True) -> gluon.rnn.LSTM(width,
    layers) -> Dense(vocab), on the card, Xavier from ``seed``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    class SparseLM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(vocab, width,
                                                  sparse_grad=sparse)
                self.rnn = gluon.rnn.LSTM(width, num_layers=layers,
                                          layout="TNC")
                self.decoder = gluon.nn.Dense(vocab, flatten=False)

        def hybrid_forward(self, F, x):
            return self.decoder(self.rnn(self.encoder(x)))

    mx.random.seed(seed)
    with mx.gpu():
        net = SparseLM()
        net.initialize(mx.init.Xavier(), ctx=mx.gpu())
        net(mx.nd.array(np.zeros((WLM_T, WLM_B), np.int32), dtype="int32"))
    return net


def _sparse_trainer(net):
    import mxnet_tpu_torch as mx

    return mx.gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": WLM_LR, "wd": SPARSE_WD,
                             "clip_gradient": WLM_CLIP})


def _sparse_lm_backward(net, x, y):
    """The example's forward and backward of the per-token losses; returns
    their mean (on the card)."""
    import mxnet_tpu_torch as mx

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out.reshape(-1, out.shape[-1]), y.reshape(-1))
    loss.backward()
    return loss.mean()


def _sparse_lm_step(net, trainer, x, y):
    """The example's step: ``_sparse_lm_backward``, ``trainer.step(B)``."""
    loss = _sparse_lm_backward(net, x, y)
    trainer.step(x.shape[1])
    return loss


def _plain_update(trainer, batch):
    """What the next ``trainer.step(batch)`` must give, by the plain Adam
    (``ops/optimizer.adam_update``) on copies: a row-sparse parameter's
    recorded rows gathered, updated and scattered back, every other
    parameter updated whole. Read after the backward, before the step."""
    from mxnet_tpu_torch.ops import optimizer as oo

    opt = trainer._optimizer
    trainer._ensure_states()
    out = []
    for i, p in enumerate(trainer._params):
        w, g = p._var.detach().clone(), p._var.grad.detach().clone()
        m, v = (t.clone() for t in trainer._states[i])
        lr_t = opt._lr_t(opt._get_lr(i),
                         opt._index_update_count.get(i, 0) + 1)
        args = (lr_t, opt.beta1, opt.beta2, opt.epsilon, opt._get_wd(i),
                trainer._scale / batch, opt.clip_gradient)
        if p._sparse_rows is None:
            oo.adam_update(w, g, m, v, *args)
        else:
            rows = p._sparse_rows.long()
            blk = [t.index_select(0, rows) for t in (w, g, m, v)]
            oo.adam_update(*blk, *args)
            for full, part in zip((w, m, v), (blk[0], blk[2], blk[3])):
                full.index_copy_(0, rows, part)
        out.append((w, m, v))
    return out


def _trainer_state(trainer):
    return [(p._var.detach(), *trainer._states[i])
            for i, p in enumerate(trainer._params)]


def _sparse_capture_check(card):
    """A sparse-gradient net through ``TrainStep`` (one captured CUDA graph
    a step) against its dense twin: losses and weights bit for bit (the
    step updates densely, as the JAX TrainStep), no rows recorded."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import TrainStep

    ex = _example("torch_train_word_lm")
    batches = _wlm_batches(ex, 3)
    res = []
    for sparse in (True, False):
        net = _sparse_lm(vocab=WLM_VOCAB, width=64, layers=1, sparse=sparse,
                         seed=3)
        ts = TrainStep(net, _wlm_loss(), mx.optimizer.Adam(
            learning_rate=WLM_LR, wd=SPARSE_WD), engine_type="graph")
        losses = [float(ts(*b)) for b in batches]
        rows = net.encoder.collect_params()[
            net.encoder.prefix + "weight"]._sparse_rows
        res.append((losses, _state(ts, host=True), ts.compiled_programs,
                    rows))
        del ts, net
        _release()
    same = res[0][0] == res[1][0] and _same_state(res[0][1], res[1][1])
    log(f"[sparse] TrainStep graph, vocabulary {WLM_VOCAB} width 64: the "
        f"sparse_grad net {'==' if same else '!='} its dense twin bit for "
        f"bit over 3 captured steps (losses {res[0][0]}); rows recorded "
        f"{res[0][3]} on {card}")
    if not same or res[0][3] is not None or res[0][2] != 1:
        raise AssertionError(f"sparse TrainStep: {res[0][0]} vs "
                             f"{res[1][0]}, programs {res[0][2]}, rows "
                             f"{res[0][3]}")
    return {"losses": res[0][0], "equal_dense_twin": same}


def phase_sparse_lm(card):
    """``[sparse]`` (a): the word LM at Zaremba-medium width, untied, its
    embedding ``Embedding(10000, 650, sparse_grad=True)``, trained by
    ``gluon.Trainer("adam", wd=SPARSE_WD)`` on the example's Zipf corpus
    for SPARSE_STEPS steps: each step SPARSE_WANT (two Adam launches: the
    lazy block and the rest; the xent pair), the first 3 each held against
    the plain update from the same state (``_plain_update``) at
    ADAM_TOL["step"], the loss falling, every embedding row no batch
    touched bit-identical to its start; ms a step, tokens/s; then a
    profiled step's Adam launches, the device time by kernel group with
    the idle share; and the TrainStep capture check. Returns the run's
    launches, the results and the tensors for the timing rows."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    ex = _example("torch_train_word_lm")
    batches = [tuple(mx.nd.array(t) for t in b)
               for b in _wlm_batches(ex, SPARSE_STEPS + 6)]
    net = _sparse_lm()
    emb = net.encoder.collect_params()[net.encoder.prefix + "weight"]
    start = emb.tensor().detach().clone()
    touched = torch.unique(torch.cat([x._data.reshape(-1)
                                      for x, _ in batches[:SPARSE_STEPS]]))
    trainer = _sparse_trainer(net)
    losses, errs, block_rows = [], [], []
    total = dict.fromkeys(SPARSE_WANT, 0)
    torch.cuda.synchronize()
    _reset_launch_counts()
    for i, (x, y) in enumerate(batches[:SPARSE_STEPS]):
        if i == 5:
            torch.cuda.synchronize()
            t = time.perf_counter()
        before = _launch_counts()
        if i < 3:
            loss = _sparse_lm_backward(net, x, y)
            block_rows.append(int(emb._sparse_rows.numel()))
            want = _plain_update(trainer, WLM_B)
            trainer.step(WLM_B)
            err = 0.0
            for (w, m, v), got in zip(want, _trainer_state(trainer)):
                for name, a, b in zip(("w", "m", "v"), got, (w, m, v)):
                    err = max(err, _adam_close(a, b, ADAM_TOL["step"],
                                               f"sparse step {i} {name}"))
            errs.append(err)
        else:
            loss = _sparse_lm_step(net, trainer, x, y)
        losses.append(loss)
        got = {k: v - before[k] for k, v in _launch_counts().items()}
        if got != SPARSE_WANT:
            raise AssertionError(f"sparse step {i}: launches {got}, "
                                 f"expected {SPARSE_WANT}")
        for k in total:
            total[k] += got[k]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / (SPARSE_STEPS - 5) * 1e3
    losses = [float(v) for v in losses]
    now = emb.tensor().detach()
    keep = torch.ones(WLM_VOCAB, dtype=torch.bool, device=now.device)
    keep[touched.long()] = False
    untouched_same = bool(torch.equal(now[keep], start[keep]))
    moved = bool((now[~keep] != start[~keep]).any())
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"[sparse] word LM untied at Zaremba-medium, Embedding({WLM_VOCAB}, "
        f"{WLM_WIDTH}, sparse_grad=True), Trainer adam wd {SPARSE_WD}, "
        f"{SPARSE_STEPS} steps: launches {total}; first 3 steps against the "
        f"plain lazy update max abs err {errs} (lazy block rows "
        f"{block_rows}); {int(keep.sum())} untouched rows "
        f"{'bit-identical' if untouched_same else 'CHANGED'}; mean loss "
        f"first 5 {first:.4f}, last 5 {last:.4f}; {ms:.2f} ms/step (steps "
        f"5-{SPARSE_STEPS}), {WLM_T * WLM_B / ms * 1e3:.0f} tokens/s on "
        f"{card}")
    if not untouched_same or not moved:
        raise AssertionError("sparse: untouched rows changed, or touched "
                             "rows did not move")
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"sparse: losses {losses} do not fall")
    res = {"card": card, "steps": SPARSE_STEPS, "losses": losses,
           "first5_mean": first, "last5_mean": last, "ms_per_step": ms,
           "tokens_per_s": WLM_T * WLM_B / ms * 1e3,
           "plain_max_abs_err": errs, "lazy_block_rows": block_rows,
           "untouched_rows": int(keep.sum()), "untouched_bit_identical": True}
    # a profiled step: its Adam launches as the card sees them, then the
    # device time of a step by kernel group and the idle share
    it = iter(batches[SPARSE_STEPS:])

    def step():
        x, y = next(it)
        _sparse_lm_step(net, trainer, x, y)

    res["profiled_adam_launches"] = _profiled_count(step, "adam_kernel")
    if res["profiled_adam_launches"] != SPARSE_WANT["adam"]:
        raise AssertionError(f"sparse: a profiled step launched "
                             f"{res['profiled_adam_launches']} adam kernels")
    torch.cuda.synchronize()
    t = time.perf_counter()
    step()
    torch.cuda.synchronize()
    res["breakdown"] = _device_groups(step, 3, "sparse word LM step",
                                      (time.perf_counter() - t) * 1e3)
    # the timing rows' tensors: one batch's lazy block, the other tensors
    x, _ = batches[0]
    rows = torch.unique(x._data.reshape(-1)).long()
    block = emb.tensor().detach().index_select(0, rows)
    dense = [p.tensor().detach() for p in trainer._params if p is not emb]
    del trainer
    res["capture"] = _sparse_capture_check(card)
    res["seconds"] = time.perf_counter() - t0
    return total, res, (block, dense, net)


def _lm1b_ids(dev):
    """A (35, 20) batch of Zipf(1.3) ids over LM1B's vocabulary."""
    ids = np.random.RandomState(21).zipf(1.3, WLM_T * WLM_B) % LM1B_VOCAB
    return torch.from_numpy(ids.astype(np.int32).reshape(WLM_T, WLM_B)).to(
        dev)


def phase_sparse_lm1b(card):
    """``[sparse]`` (b): the lazy update at LM1B's vocabulary, 793,471 x
    512 f32 (1.63 GB; 6.5 GB with its gradient and moments), for one (35,
    20) batch of Zipf ids: the Trainer's lazy path (compact the dense
    gradient to the batch's rows, gather w, m and v, the Adam kernel on the
    block, scatter back) against the plain lazy update at ADAM_TOL["step"]
    and timed (eager: the block is new each call), beside the dense
    gradient the embedding's backward writes. Returns the launches of the
    timed lazy run, the results and the table for the dense row."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import registry
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    from mxnet_tpu_torch.ops import optimizer as oo

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    w = torch.randn(LM1B_VOCAB, LM1B_WIDTH, device=dev, generator=gen) * 0.05
    g = torch.randn(LM1B_VOCAB, LM1B_WIDTH, device=dev, generator=gen) * 1e-3
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    ids = _lm1b_ids(dev)
    rows32 = torch.unique(ids.reshape(-1))
    n_rows, n = int(rows32.numel()), int(rows32.numel()) * LM1B_WIDTH
    opt = mx.optimizer.Adam(learning_rate=1e-3, wd=SPARSE_WD)

    def lazy():
        rsp = RowSparseNDArray(g.index_select(0, rows32.long()), (rows32,),
                               g.shape)
        opt.update(0, w, rsp, (m, v))

    # one lazy update against the plain one from the same state
    want = [t.clone() for t in (w, m, v)]
    rows = rows32.long()
    blk = [t.index_select(0, rows) for t in (want[0], g, want[1], want[2])]
    oo.adam_update(*blk, opt._lr_t(1e-3, 1), opt.beta1, opt.beta2,
                   opt.epsilon, SPARSE_WD)
    for full, part in zip(want, (blk[0], blk[2], blk[3])):
        full.index_copy_(0, rows, part)
    lazy()
    torch.cuda.synchronize()
    err = max(_adam_close(a, b, ADAM_TOL["step"], f"lm1b lazy {name}")
              for name, a, b in zip("wmv", (w, m, v), want))
    keep = torch.ones(LM1B_VOCAB, dtype=torch.bool, device=dev)
    keep[rows] = False
    if not torch.equal(w[keep], want[0][keep]):
        raise AssertionError("lm1b lazy: untouched rows changed")
    del want, blk
    _release()
    _reset_launch_counts()
    lazy_ms = cuda_time_ms(lazy, warmup=2, iters=10, repeats=3)
    launches = _launch_counts()
    # the dense gradient a step of Embedding(sparse_grad=True) still
    # writes: the lookup's backward into a (793471, 512) f32 tensor
    table = torch.nn.Parameter(w.detach())
    embed = registry.get("Embedding").fn

    def dense_grad():
        out = embed(ids, table, input_dim=LM1B_VOCAB, output_dim=LM1B_WIDTH)
        torch.autograd.grad(out.sum(), table)

    grad_ms = cuda_time_ms(dense_grad, warmup=2, iters=5, repeats=3)
    grad_bound = (LM1B_VOCAB * LM1B_WIDTH * 4 + n * 4 * 2) / \
        HBM_BYTES_PER_S * 1e3
    res = {"card": card, "table": [LM1B_VOCAB, LM1B_WIDTH],
           "touched_rows": n_rows, "touched_elements": n,
           "lazy_ms": lazy_ms, "lazy_max_abs_err": err,
           "lazy_bound_ms": (28 + 56) * n / HBM_BYTES_PER_S * 1e3,
           "dense_grad_ms": grad_ms, "dense_grad_bound_ms": grad_bound}
    log(f"[sparse lm1b] table {LM1B_VOCAB} x {LM1B_WIDTH} f32, a (35, 20) "
        f"Zipf batch touches {n_rows} rows ({n} elements): the lazy update "
        f"(compact, gather, Adam kernel, scatter) {lazy_ms * 1e3:.2f} us "
        f"eager (bound {res['lazy_bound_ms'] * 1e3:.2f} us at 84 B an "
        f"element), max abs err {err:.3e} against the plain lazy update; "
        f"the embedding backward's dense gradient {grad_ms * 1e3:.2f} us "
        f"(bound {grad_bound * 1e3:.2f} us: the table written once) on "
        f"{card}")
    del table, g, m, v
    _release()
    return launches, res, (w, rows)


def _criteo_csr(dev, seed=23):
    """A CSR of CSR_ROWS Criteo-like samples: one nonzero in each of
    CSR_FIELDS fields, each field its own slice of CSR_COLS hashed
    columns (sorted, no duplicates), N(0, 1) values."""
    from mxnet_tpu_torch.ndarray.sparse import csr_matrix

    gen = torch.Generator(device=dev).manual_seed(seed)
    width = CSR_COLS // CSR_FIELDS
    base = torch.arange(CSR_FIELDS, device=dev) * width
    cols = base + torch.randint(0, width, (CSR_ROWS, CSR_FIELDS),
                                device=dev, generator=gen)
    data = torch.randn(CSR_ROWS * CSR_FIELDS, device=dev, generator=gen)
    indptr = torch.arange(CSR_ROWS + 1, device=dev) * CSR_FIELDS
    return csr_matrix((data, cols.reshape(-1), indptr),
                      shape=(CSR_ROWS, CSR_COLS))


def phase_sparse_csr(card):
    """``[sparse]`` (c): ``nd.dot(csr, dense)`` at 8192 Criteo-like rows
    over 2^20 columns, times a (2^20, 16) f32 matrix, and with
    ``transpose_a`` times an (8192, 16) one: each against ``torch.matmul``
    of a densified slice (the first 64 rows) at CSR_TOL, each run twice
    with equal bytes, timed (eager) beside ``torch.sparse.mm`` (cuSPARSE)
    on the same matrix."""
    import mxnet_tpu_torch as mx

    dev = torch.device("cuda")
    csr = _criteo_csr(dev)
    gen = torch.Generator(device=dev).manual_seed(24)
    rhs = mx.nd.array(torch.randn(CSR_COLS, CSR_K, device=dev,
                                  generator=gen))
    rhs_t = mx.nd.array(torch.randn(CSR_ROWS, CSR_K, device=dev,
                                    generator=gen))
    head = csr[0:64]
    dense_head = head.todense()._data
    lib = torch.sparse_csr_tensor(csr._aux[1].long(), csr._aux[0].long(),
                                  csr._data, (CSR_ROWS, CSR_COLS))
    res = {"card": card, "rows": CSR_ROWS, "cols": CSR_COLS,
           "nnz": int(csr._data.numel()), "k": CSR_K}
    nnz = CSR_ROWS * CSR_FIELDS
    for ta, r in ((False, rhs), (True, rhs_t)):
        key = "transpose_a" if ta else "plain"
        a = mx.nd.dot(csr, r, transpose_a=ta)._data
        b = mx.nd.dot(csr, r, transpose_a=ta)._data
        torch.cuda.synchronize()
        if a.device.type != "cuda" or not torch.equal(a, b):
            raise AssertionError(f"csr dot {key}: two runs differ")
        if ta:
            got = mx.nd.dot(head, mx.nd.array(r._data[:64]),
                            transpose_a=True)._data
            want = dense_head.t() @ r._data[:64]
        else:
            got, want = a[:64], dense_head @ r._data
        err = (got - want).abs()
        if (err > CSR_TOL[1] + CSR_TOL[0] * want.abs()).any():
            raise AssertionError(f"csr dot {key}: max abs err "
                                 f"{float(err.max())}")
        ms = cuda_time_ms(lambda: mx.nd.dot(csr, r, transpose_a=ta),
                          warmup=2, iters=5, repeats=3)
        lib_fn = (lambda: torch.sparse.mm(lib.t(), r._data)) if ta else \
            (lambda: torch.sparse.mm(lib, r._data))
        try:
            lib_ms = cuda_time_ms(lib_fn, warmup=2, iters=5, repeats=3)
        except RuntimeError as e:  # the yardstick only
            lib_ms = f"not measured: {str(e)[:120]}"
        # the products read once: values, columns, indptr, the rows of rhs
        # they touch, the output written once; 2 flops a nonzero a column
        nbytes = nnz * (4 + 4) + (CSR_ROWS + 1) * 4 + \
            nnz * CSR_K * 4 + (CSR_COLS if ta else CSR_ROWS) * CSR_K * 4
        bound_ms, bound_by, _ = _bound_ms(nbytes, 2 * nnz * CSR_K)
        res[key] = {"ms": ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": float(err.max()),
                    "equal_run_to_run": True}
        log(f"[sparse csr] dot(csr {CSR_ROWS}x{CSR_COLS}, {nnz} nonzeros, "
            f"transpose_a={ta}) x {tuple(r.shape)}: {ms * 1e3:.2f} us eager "
            f"(torch.sparse.mm {lib_ms if isinstance(lib_ms, str) else f'{lib_ms * 1e3:.2f} us'}), "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), max abs err "
            f"{float(err.max()):.3e} against torch.matmul of the dense "
            f"slice, two runs bit-identical on {card}")
    return res


def phase_sparse_storage(card, tmp):
    """``[sparse]`` (d): the storage ops on the card: cast_storage round
    trips (dense -> row_sparse -> dense, dense -> csr -> dense), retain,
    rsp + rsp against the dense sum, the lazy ``nd.adam_update`` op, and a
    ``.params`` file of both types saved and loaded back to the card; every
    result on the GPU and exact."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse as sp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    a = torch.randn(1000, 64, device=dev, generator=gen)
    a[torch.rand(1000, device=dev, generator=gen) < 0.7] = 0
    b = torch.randn(1000, 64, device=dev, generator=gen)
    b[torch.rand(1000, device=dev, generator=gen) < 0.7] = 0
    c = torch.randn(300, 500, device=dev, generator=gen)
    c[c.abs() < 1.5] = 0
    ra, rb = mx.nd.array(a).tostype("row_sparse"), \
        mx.nd.array(b).tostype("row_sparse")
    csr = mx.nd.array(c).tostype("csr")
    kept = sp.retain(ra, ra.indices._data[::2])
    total = ra + rb
    want_kept = torch.zeros_like(a)
    rows = ra._aux[0][::2].long()
    want_kept[rows] = a[rows]
    w, mean, var = (torch.randn(1000, 64, device=dev, generator=gen),
                    torch.zeros(1000, 64, device=dev),
                    torch.zeros(1000, 64, device=dev))
    nw, nm, _ = mx.nd.adam_update(mx.nd.array(w), ra, mx.nd.array(mean),
                                  mx.nd.array(var), lr=0.1, wd=0.01,
                                  lazy_update=True)
    fname = os.path.join(tmp, "sparse.params")
    mx.nd.save(fname, {"rsp": ra, "csr": csr})
    back = {k: v.as_in_context(mx.gpu()) for k, v in mx.nd.load(fname).items()}
    checks = {
        "rsp_roundtrip": torch.equal(ra.tostype("default")._data, a),
        "csr_roundtrip": torch.equal(csr.tostype("default")._data, c),
        "retain": torch.equal(kept.todense()._data, want_kept),
        "rsp_add": total.stype == "row_sparse" and
        torch.equal(total.todense()._data, a + b),
        "lazy_adam_untouched": torch.equal(
            nw._data[~(a != 0).any(1)], w[~(a != 0).any(1)]) and
        bool((nm._data[~(a != 0).any(1)] == 0).all()),
        "params_roundtrip": torch.equal(back["rsp"].todense()._data, a) and
        torch.equal(back["csr"].todense()._data, c)}
    on_card = all(t.is_cuda for x in (ra, csr, kept, total, back["rsp"],
                                      back["csr"])
                  for t in (x._data, *x._aux)) and nw._data.is_cuda
    log(f"[sparse storage] row_sparse {ra.indices.shape[0]} of 1000 rows, "
        f"csr {csr.data.shape[0]} nonzeros: {checks}; every result on the "
        f"card: {on_card} ({card})")
    if not all(checks.values()) or not on_card:
        raise AssertionError(f"sparse storage: {checks}, on card {on_card}")
    return dict(checks, on_card=on_card)


# the [np] names: (name, inputs, kwargs), each run on the card and on the
# CPU; from the list of numpy semantics PyTorch does not share
NP_CASES = [("var", ("x",), {"axis": 1}), ("std", ("x",), {}),
            ("median", ("x",), {"axis": 0}), ("meshgrid", ("v", "w"), {}),
            ("array_split", ("x", 3), {"axis": 1}),
            ("pad", ("x", ((1, 0), (2, 1))), {}), ("mod", ("x", "neg"), {}),
            ("cross", ("c", "d"), {}), ("digitize", ("x", "bins"), {}),
            ("histogram", ("x",), {"bins": 7}), ("cbrt", ("x",), {}),
            ("ptp", ("x",), {"axis": 1}),
            ("average", ("x",), {"axis": 1, "weights": "wts"}),
            ("interp", ("v", "xp", "fp"), {}), ("ediff1d", ("x",), {}),
            ("tril_indices", (5, -1), {}), ("empty_like", ("x",), {})]


def phase_np(card):
    """``[np]``: each NP_CASES name of ``mx.np`` on CUDA tensors against the
    same call on CPU tensors (floats at NN_TOL["f32"], the rest exact), its
    results on the card."""
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(26)
    host = {"x": rs.randn(64, 48).astype(np.float32),
            "neg": -rs.uniform(0.5, 2, (64, 48)).astype(np.float32),
            "v": np.sort(rs.randn(48)).astype(np.float32),
            "w": rs.randn(30).astype(np.float32),
            "c": rs.randn(64, 3).astype(np.float32),
            "d": rs.randn(64, 3).astype(np.float32),
            "bins": np.float32([-1, -0.2, 0, 0.5, 1.5]),
            "wts": rs.uniform(0, 1, 48).astype(np.float32),
            "xp": np.float32([-2, -1, 0, 1, 2]),
            "fp": np.float32([3, 1, 0, 1, 3])}
    rtol, atol = NN_TOL["f32"]
    out = {}
    for name, args, kw in NP_CASES:
        res = {}
        for ctx in (mx.gpu(), mx.cpu()):
            def arg(a):
                return mx.nd.array(host[a], ctx=ctx) \
                    if isinstance(a, str) and a in host else a
            with ctx:
                r = getattr(mx.np, name)(*[arg(a) for a in args],
                                         **{k: arg(v) for k, v in kw.items()})
            res[ctx.device_type] = list(r) if isinstance(r, tuple) else [r]
        for g, c in zip(res["gpu"], res["cpu"]):
            if not g._data.is_cuda:
                raise AssertionError(f"np.{name}: a result left the card")
            gt, ct = g._data.cpu(), c._data
            if gt.dtype != ct.dtype or gt.shape != ct.shape:
                raise AssertionError(f"np.{name}: {gt.dtype} {gt.shape} on "
                                     f"the card, {ct.dtype} {ct.shape} on "
                                     "the CPU")
            ok = torch.allclose(gt, ct, rtol=rtol, atol=atol) \
                if gt.is_floating_point() else torch.equal(gt, ct)
            if not ok:
                raise AssertionError(f"np.{name}: the card's result differs "
                                     "from the CPU's")
        out[name] = [tuple(g.shape) for g in res["gpu"]]
    log(f"[np] {len(NP_CASES)} mx.np names on the card equal to the CPU "
        f"(floats at {NN_TOL['f32']}), results on the card: {sorted(out)} "
        f"({card})")
    return out


def phase_sparse(card):
    """``[sparse]``: phase_sparse_lm (the main path, its launches counted
    from 0), phase_sparse_lm1b, phase_sparse_csr, phase_sparse_storage.
    Returns the launches of the word LM run and of the LM1B lazy run, the
    results, and the timing rows of the Adam kernel at the path's shapes:
    the lazy block, the untied LM's other tensors, the LM1B table."""
    t0 = time.perf_counter()
    launches, lm, (block, dense, net) = phase_sparse_lm(card)
    gen = torch.Generator().manual_seed(27)
    timing = {"adam_sparse_block": _adam_row(None, gen, ws=[block]),
              "adam_sparse_rest": _adam_row(None, gen, ws=dense)}
    del block, dense, net
    _release()
    lm1b_launches, lm1b, (table, rows) = phase_sparse_lm1b(card)
    timing["adam_lm1b_block"] = _adam_row(
        None, gen, ws=[table.index_select(0, rows)])
    timing["adam_lm1b"] = _adam_row(None, gen, ws=[table])
    del table
    _release()
    csr = phase_sparse_csr(card)
    with tempfile.TemporaryDirectory() as d:
        storage = phase_sparse_storage(card, d)
    res = {"word_lm": lm, "lm1b": lm1b, "csr": csr, "storage": storage,
           "seconds": time.perf_counter() - t0}
    log(f"[sparse seconds] {res['seconds']:.1f} s")
    return launches, lm1b_launches, res, timing


# -- INT8 on csrc/int8_gemm.cu, ONNX, and the DCGAN, generate_gpt2
# and ImageNet-ResNet example routes ---------------------------------------
INT8_TOPS = 1979e12  # dense int8 on the tensor cores (H100 SXM, 700 W)
PEAKS["int8"] = ("int8 tensor cores, 1,979 TOPS", INT8_TOPS)
INT8_NOTE = ("not a pallas_call site: the counterpart of XLA's int8 dot and "
             "conv (lax.dot_general / lax.conv_general_dilated with "
             "preferred_element_type=int32)")
INT8_B = 32
INT8_LAYERS = 54  # resnet50_v1: 53 Conv2D and the Dense
# (name, B, C, H, W, O, kernel, stride, pad, dilate, groups) of the kernel
# checks: resnet50_v1's at B=32 (the stem, res2's and res5's 1x1 and 3x3,
# a stride-2 downsample), a grouped 3x3 (ResNeXt's 32 groups at res3),
# LeNet's conv1 (K = 25), and windows too large for one block at 64
# channels: a 3x3 over rows 1024 wide (VGG16's conv1_2 at a 1024-pixel
# input; 32 channels a block), the same over rows 4096 wide (16 channels
# and half a row a block), a rate-24 dilated 3x3 on a 65x65 map
# (DeepLabv3's ASPP at output stride 8) and a 1x1 over rows 4096 wide
# (half a row a block)
INT8_CONV_CASES = [("stem", 32, 3, 224, 224, 64, 7, 2, 3, 1, 1),
                   ("res2 1x1", 32, 256, 56, 56, 64, 1, 1, 0, 1, 1),
                   ("res2 3x3", 32, 64, 56, 56, 64, 3, 1, 1, 1, 1),
                   ("res5 1x1", 32, 2048, 7, 7, 512, 1, 1, 0, 1, 1),
                   ("res5 3x3", 32, 512, 7, 7, 512, 3, 1, 1, 1, 1),
                   ("downsample s2", 32, 512, 28, 28, 1024, 1, 2, 0, 1, 1),
                   ("grouped 32", 32, 256, 28, 28, 256, 3, 1, 1, 1, 32),
                   ("lenet conv1", 64, 1, 28, 28, 6, 5, 1, 2, 1, 1),
                   ("wide 3x3", 1, 64, 8, 1024, 64, 3, 1, 1, 1, 1),
                   ("wider 3x3", 1, 64, 2, 4096, 64, 3, 1, 1, 1, 1),
                   ("dilated 24", 2, 64, 65, 65, 64, 3, 1, 24, 24, 1),
                   ("wide 1x1", 1, 64, 2, 4096, 64, 1, 1, 0, 1, 1)]
# (name, M, K, N) of the products checked alone: resnet50_v1's Dense (K
# split on the wgmma route) and LeNet's three (K = 400 on wgmma; 120 and 84:
# rows that are not 16-byte aligned, the mma.sync route's byte loads)
INT8_FC_CASES = [("dense 2048->1000", 32, 2048, 1000),
                 ("lenet dense 400->120", 64, 400, 120),
                 ("lenet dense 120->84", 64, 120, 84),
                 ("lenet dense 84->4", 64, 84, 4)]
# the timed shapes: res4's 3x3, res5's 3x3, the stem, res2's 3x3 and res3's
# 1x1 (the product on its wgmma route, the im2col from the f32 activation)
INT8_ROWS = {"": ("res4 3x3", 32, 256, 14, 14, 256, 3, 1, 1),
             "_res5": ("res5 3x3", 32, 512, 7, 7, 512, 3, 1, 1),
             "_stem": ("stem", 32, 3, 224, 224, 64, 7, 2, 3),
             "_res2": ("res2 3x3", 32, 64, 56, 56, 64, 3, 1, 1),
             "_res3": ("res3 1x1", 32, 512, 28, 28, 128, 1, 1, 0)}
# the mma.sync route's timed shape: LeNet's Dense 120 -> 84 at the
# quantize_model example's test batch of 32
INT8_MMA_ROW = ("lenet dense 120->84", 32, 120, 84)
# activation scales of the im2col checks: a power of two, so that x / s
# lands exactly on the ties (n + 0.5) the activations are built on, and
# one that is not
INT8_ACT_SCALES = (2.0 ** -6, 0.0123)
DCGAN_B, DCGAN_SAMPLES = 64, 4096
GEN_RUNS = (("default", []), ("paged", ["--paged"]),
            ("speculate", ["--paged", "--speculate", "4"]),
            ("share_prefix", ["--share-prefix"]), ("samples", ["--samples", "4"]))
IMAGENET_STEPS, REC_IMAGES, REC_STEPS = 12, 256, 4


def _int8_counts():
    from mxnet_tpu_torch.contrib import quantization as Q

    return dict(Q.launches)


def _int8_q(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _int8_act(gen, shape, scale, dtype):
    """f32 or bf16 activations on the quantisation's edges: a third
    integers n and a third n + 0.5 (|n| up to 160, so past the clamp at
    127) times ``scale``, a third arbitrary (normal, 60 ``scale`` wide)."""
    n = torch.randint(-160, 161, shape, generator=gen, device="cuda").float()
    pick = torch.randint(0, 3, shape, generator=gen, device="cuda")
    wild = torch.randn(shape, generator=gen, device="cuda") * 60
    x = torch.where(pick == 0, n, torch.where(pick == 1, n + 0.5, wild))
    return (x * scale).to(dtype)


def _int8_conv_check(gen, case):
    """A convolution's kernels on the card against their plain versions on
    the same CUDA tensors: the im2col on an int8 activation and on f32 and
    bf16 ones it quantises (each INT8_ACT_SCALES; the plain version
    quantises as ``_QuantizedLayer`` does, then unfolds), padded edges
    included; the product on each route (``gemm_plan``'s and mma.sync) in
    f32 and bf16 out and its int32 accumulator at unit scales; and the
    layer's whole fused path (``_conv`` from the f32 activation). Returns
    max |diff| by kernel and the plan of the product."""
    from mxnet_tpu_torch.contrib import quantization as Q

    name, b, c, h, w, o, k, s, p, d, g = case
    kk = c // g * k * k
    kp, geo = Q.k_padded(kk), ((k, k), (s, s), (p, p), (d, d), g)
    errs = {"int8_im2col": 0.0, "int8_gemm_wgmma": 0.0, "int8_gemm_mma": 0.0}
    col_errs = {}
    for dtype, scale in ([(torch.int8, None)]
                         + [(dt, sc) for dt in (torch.float32, torch.bfloat16)
                            for sc in INT8_ACT_SCALES]):
        if dtype == torch.int8:
            x = _int8_q(gen, b, c, h, w)
        else:
            x = _int8_act(gen, (b, c, h, w), scale, dtype)
            scale = torch.full((), scale, device="cuda")
        got = Q.int8_im2col(x, *geo, kp, scale)
        want = Q.int8_im2col_plain(x if scale is None
                                   else Q._quantize(x, scale), *geo, kp)
        e = (got.int() - want.int()).abs().max().item()
        col_errs[str(dtype).split(".")[-1] + (
            "" if scale is None else f"@{scale.item():g}")] = e
        errs["int8_im2col"] = max(errs["int8_im2col"], e)
    xq, wt = _int8_q(gen, b, c, h, w), _int8_q(gen, o, c // g, k, k)
    w2 = torch.zeros((o, kp), dtype=torch.int8, device="cuda")
    w2[:, :kk] = wt.reshape(o, kk)
    ws = torch.rand(o, device="cuda", generator=gen) * 1e-2
    bias = torch.randn(o, device="cuda", generator=gen)
    ds = torch.full((), 0.0123, device="cuda")
    cols = Q.int8_im2col_plain(xq, *geo, kp)
    oh, ow = Q._out_hw(h, w, (k, k), (s, s), (p, p), (d, d))
    pos = oh * ow
    plan = Q.gemm_plan(b * pos, o // g, kk, g, kp, kp, True,
                       Q._sm_count(xq.device))
    acc_p = Q.int8_gemm_plain(cols, w2, kk, 1.0, 1.0, None, "float32", g, pos)
    gemm_errs = {}
    for pl in (plan, ("mma", 0, 1)):
        key = "int8_gemm_" + pl[0]
        acc = Q._int8_gemm(cols, w2, kk, 1.0, 1.0, None, "float32", g, pos,
                           pl)
        e = [(acc - acc_p).abs().max().item()]
        for dtype in ("float32", "bfloat16"):
            got = Q._int8_gemm(cols, w2, kk, ds, ws, bias, dtype, g, pos,
                               pl)
            want = Q.int8_gemm_plain(cols, w2, kk, ds, ws, bias, dtype, g,
                                     pos)
            e.append((got.float() - want.float()).abs().max().item())
        gemm_errs[pl[0]] = e
        errs[key] = max(errs[key], *e)
    # the layer's path: the f32 activation through the fused im2col and the
    # plan's product, against quantise, unfold and the plain product
    xf = _int8_act(gen, (b, c, h, w), INT8_ACT_SCALES[1], torch.float32)
    got = Q._conv(xf, w2, kk, bias, (k, k), s, p, d, g, ds, ws, "float32",
                  quantize=True)
    want = Q.int8_gemm_plain(
        Q.int8_im2col_plain(Q._quantize(xf, ds), *geo, kp), w2, kk, ds, ws,
        bias, "float32", g, pos).reshape(got.shape)
    e_layer = (got - want).abs().max().item()
    errs[f"int8_gemm_{plan[0]}"] = max(errs[f"int8_gemm_{plan[0]}"], e_layer)
    errs["int8_im2col"] = max(errs["int8_im2col"], e_layer)
    torch.cuda.synchronize()
    log(f"[int8 kernels] {name}: K {kk} (rows of {kp}), plan {plan}; im2col "
        f"max|diff| {col_errs}; product (int32 accumulator, f32, bf16) "
        f"{gemm_errs}; the layer's fused path {e_layer} (largest |acc| "
        f"{acc_p.abs().max().item():.0f})")
    return errs, plan


def _int8_rows(gen):
    """Timing rows at INT8_ROWS: the product on its wgmma route over the
    path's padded patches and weight (f32 NCHW out) beside its plain version
    and ``torch._int_mm`` on the same zero-padded operands (the library
    yardstick, s32 out, no epilogue; the port never calls it), and the
    im2col from the f32 activation (quantising as it writes) beside its
    plain version (the quantisation passes and F.unfold; no library call
    takes int8); then the mma.sync route at INT8_MMA_ROW (``_int_mm`` does
    not take N = 84). Bounds: ops 2·M·N·K at 1,979 int8 TOPS, bytes the
    patches (M·K_pad), the weight and the f32 output (the product) or the
    f32 input and the patches (the im2col), at 3.35 TB/s."""
    from mxnet_tpu_torch.contrib import quantization as Q

    rows = {}
    for suffix, (name, b, c, h, w, o, k, s, p) in INT8_ROWS.items():
        x = torch.randn((b, c, h, w), device="cuda", generator=gen)
        ds = x.abs().amax() / 127.0 + 1e-12
        wt = _int8_q(gen, o, c, k, k)
        kk = wt[0].numel()
        kp, oh = Q.k_padded(kk), (h + 2 * p - k) // s + 1
        geo = ((k, k), (s, s), (p, p), (1, 1), 1)
        cols = Q.int8_im2col(x, *geo, kp, ds)
        w2 = torch.zeros((o, kp), dtype=torch.int8, device="cuda")
        w2[:, :kk] = wt.reshape(o, kk)
        ws = torch.rand(o, device="cuda", generator=gen) * 1e-2
        m = b * oh * oh
        plan = Q.gemm_plan(m, o, kk, 1, kp, kp, True, Q._sm_count(x.device))
        shape = (f"int8_gemm {name} M={m} K={kk} (rows of {kp}) N={o}, "
                 f"plan {plan}")
        key = "int8_gemm_wgmma" + suffix
        rows[key] = _timed(
            lambda: Q.int8_gemm(cols, w2, kk, ds, ws, None, "float32", 1,
                                oh * oh),
            lambda: Q.int8_gemm_plain(cols, w2, kk, ds, ws, None, "float32",
                                      1, oh * oh),
            lambda: torch._int_mm(cols[0], w2.t()),
            m * kp + o * kp + 4 * m * o, 2 * m * o * kk, shape, dtype="int8")
        rows[key].update(
            library="torch._int_mm on the zero-padded operands (s32 out)",
            note=INT8_NOTE, plan=list(plan))
        rows["int8_im2col" + suffix] = _timed(
            lambda: Q.int8_im2col(x, *geo, kp, ds),
            lambda: Q.int8_im2col_plain(Q._quantize(x, ds), *geo, kp), None,
            4 * x.numel() + m * kp, 0,
            f"int8_im2col {name} f32 ({b}, {c}, {h}, {w}) -> ({m}, {kp})",
            dtype="int8")
        rows["int8_im2col" + suffix].update(library_ms=None,
                                            library_eager_ms=None,
                                            note=INT8_NOTE)
    name, m, kk, n = INT8_MMA_ROW
    a, wt = _int8_q(gen, m, kk), _int8_q(gen, n, kk)
    ws = torch.rand(n, device="cuda", generator=gen) * 1e-2
    ds = torch.full((), 0.0123, device="cuda")
    plan = Q.gemm_plan(m, n, kk, 1, kk, kk, True, Q._sm_count(a.device))
    if plan[0] != "mma":
        raise AssertionError(f"[int8] {name} takes {plan}, not mma.sync")
    rows["int8_gemm_mma"] = _timed(
        lambda: Q.int8_gemm(a, wt, kk, ds, ws),
        lambda: Q.int8_gemm_plain(a, wt, kk, ds, ws), None,
        m * kk + n * kk + 4 * m * n, 2 * m * n * kk,
        f"int8_gemm {name} M={m} K={kk} N={n}, plan {plan}", dtype="int8")
    rows["int8_gemm_mma"].update(library_ms=None, library_eager_ms=None,
                                 note=INT8_NOTE, plan=list(plan))
    return rows


def _profiled_rows(fn):
    """The device rows' names, in start order, of one call of ``fn`` under
    the profiler (a warm-up call the profiler discards first)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CUDA], schedule=once) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(rows, key=lambda e: e.time_range.start)]


def _profiled_names(fn):
    """Device kernel launches by name in one call of ``fn`` under the
    profiler: the most of each name over REPLAY_ATTEMPTS traces of a call.
    A trace can lose a record, and not only at the window's start
    (``_trace_losses``; on the H100 one trace of an int8 resnet50_v1
    forward lost 7 of its 50 clamps), but never adds one."""
    best = collections.Counter()
    for _ in range(REPLAY_ATTEMPTS):
        best |= collections.Counter(_profiled_rows(fn))
    return best


#: traces of one int8 forward, for where a trace loses rows
TRACE_LOSS_TRIES = 4


def _trace_losses(fn, tries=TRACE_LOSS_TRIES):
    """Where traces of one call of ``fn`` lose device rows: against the
    longest of ``tries`` traces, each trace's count of rows lost, the
    position of its first row that differs, and the names lost. Reported,
    never a gate."""
    traces = [_profiled_rows(fn) for _ in range(tries)]
    ref = max(traces, key=len)
    out = []
    for got in traces:
        first = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                     len(got) if len(got) < len(ref) else None)
        lost = collections.Counter(ref) - collections.Counter(got)
        out.append({"lost": len(ref) - len(got), "first_differs_at": first,
                    "names": {k[:40]: v for k, v in lost.most_common(3)}})
    return {"rows": len(ref), "traces": out}


def _resnet50_f32(seed=0):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    mx.random.seed(seed)
    net = get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.MSRAPrelu())
    return net


def _top1_and_err(a, b):
    """Top-1 agreement of logits ``a`` with ``b`` and |a - b|'s norm over
    |b|'s (f32)."""
    a, b = a.float(), b.float()
    return ((a.argmax(1) == b.argmax(1)).float().mean().item(),
            ((a - b).norm() / b.norm()).item())


def phase_int8(card):
    """``[int8]``: the kernel checks (INT8_CONV_CASES: the im2col on int8,
    f32 and bf16 activations, the product on both routes in f32 and bf16
    out and its int32 accumulator; INT8_FC_CASES on both routes; max |diff|
    0 against the plain versions, a split-K plan among them), then
    resnet50_v1 at 224x224, B=32 (MSRAPrelu weights from seed 0): its f32
    and bf16 forwards, ``convert_to_int8`` with minmax calibration on 2
    batches (INT8_LAYERS layers), its int8 forward with its launches
    counted from 0 and on a profiled forward (one im2col a convolution, one
    product a layer, every product on wgmma; no round, clamp or division
    kernel but the Dense's quantisation), top-1 agreement and relative logit
    error against f32 and bf16; the entropy calibration once on a fresh
    net. Returns the launches, the results, the max |diff| of each kernel
    and the timing rows."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as Q

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(40)
    errs = {"int8_gemm_wgmma": 0.0, "int8_gemm_mma": 0.0, "int8_im2col": 0.0}
    plans = {}
    for case in INT8_CONV_CASES:
        e, plans[case[0]] = _int8_conv_check(gen, case)
        errs = {k: max(v, e[k]) for k, v in errs.items()}
    for name, m, kk, n in INT8_FC_CASES:
        a, wt = _int8_q(gen, m, kk), _int8_q(gen, n, kk)
        ws = torch.rand(n, device="cuda", generator=gen) * 1e-2
        bias = torch.randn(n, device="cuda", generator=gen)
        want = Q.int8_gemm_plain(a, wt, kk, 0.01, ws, bias)
        plans[name] = Q.gemm_plan(m, n, kk, 1, kk, kk, True,
                                  Q._sm_count(a.device))
        got = {}
        for pl in {plans[name], ("mma", 0, 1)}:
            out = Q._int8_gemm(a, wt, kk, 0.01, ws, bias, "float32", 1, 1,
                               pl)
            got[pl[0]] = (out - want).abs().max().item()
            errs["int8_gemm_" + pl[0]] = max(errs["int8_gemm_" + pl[0]],
                                             got[pl[0]])
        log(f"[int8 kernels] {name}: plan {plans[name]}, max|diff| {got}")
    if any(errs.values()):
        raise AssertionError(f"[int8] kernels differ from their plain "
                             f"versions: {errs}")
    split = [k for k, pl in plans.items() if pl[2] > 1]
    if not split or not any(pl[0] == "mma" for pl in plans.values()):
        raise AssertionError(f"[int8] the checks miss a split-K plan or the "
                             f"mma.sync route: {plans}")
    log(f"[int8 kernels] every route equals its plain version; K split at "
        f"{split}")

    rs = np.random.RandomState(0)
    xs = [torch.from_numpy(rs.rand(INT8_B, 3, 224, 224).astype(np.float32))
          .cuda() for _ in range(2)]
    x = mx.nd.array(xs[0])
    net = _resnet50_f32()
    with torch.no_grad():
        ref = net(x)._data.clone()
        f32_ms = cuda_time_ms(lambda: net(x), warmup=1, iters=3, repeats=3)
        with tempfile.TemporaryDirectory() as d:
            f = os.path.join(d, "r50.params")
            net.save_parameters(f)
            bnet = _resnet50_f32()
            bnet.load_parameters(f)
            bnet.cast("bfloat16")
            xb = mx.nd.array(xs[0].to(torch.bfloat16))
            ref_bf16 = bnet(xb)._data.float()
            bf16_ms = cuda_time_ms(lambda: bnet(xb), warmup=1, iters=3,
                                   repeats=3)
            del bnet
            enet = _resnet50_f32()
            enet.load_parameters(f)
        t = time.perf_counter()
        net, scales = Q.convert_to_int8(
            net, calib_data=[mx.nd.array(v) for v in xs])
        calib_s = time.perf_counter() - t
        if len(scales) != INT8_LAYERS:
            raise AssertionError(f"[int8] {len(scales)} layers quantized, "
                                 f"expected {INT8_LAYERS}")
        _reset_launch_counts()
        out = net(x)._data
        torch.cuda.synchronize()
        launches = _int8_counts()
        want = {"int8_gemm": INT8_LAYERS, "int8_gemm_wgmma": INT8_LAYERS,
                "int8_gemm_mma": 0, "int8_im2col": INT8_LAYERS - 1}
        if launches != want:
            raise AssertionError(f"[int8] a forward launched {launches}, "
                                 f"expected {want}")
        profiled = {k: _profiled_count(lambda: net(x), k + "_kernel")
                    for k in ("int8_gemm_wgmma", "int8_im2col")}
        # PyTorch's own round, clamp and division kernels (at::native; not
        # cuDNN's, whose names hold "div") in the int8 forward beside the
        # f32 one's (ReLU runs as a clamp in both): the difference is the
        # Dense's quantisation alone, one of each; the convolutions' runs
        # inside the im2col
        kinds = {}
        for what, fwd in (("int8", net), ("f32", enet)):
            names = _profiled_names(lambda: fwd(x))
            kinds[what] = {
                kind: sum(c for key, c in names.items()
                          if kind in key.lower()
                          and (kind == "int8_gemm_kernel"
                               or "at::native" in key))
                for kind in ("int8_gemm_kernel", "round", "clamp", "div")}
        profiled["int8_gemm_mma"] = kinds["int8"].pop("int8_gemm_kernel")
        kinds["f32"].pop("int8_gemm_kernel")
        if profiled != {k: want[k] for k in profiled}:
            raise AssertionError(f"[int8] a profiled forward ran {profiled}"
                                 f" kernels, expected {want}")
        extra = {k: v - kinds["f32"][k] for k, v in kinds["int8"].items()}
        if extra != {"round": 1, "clamp": 1, "div": 1}:
            raise AssertionError(f"[int8] quantisation kernels in a forward "
                                 f"beyond the f32 one's: {extra} ({kinds})")
        log(f"[int8] a profiled forward: {profiled}; round, clamp and "
            f"division kernels {kinds} (the Dense's quantisation: {extra})")
        log(f"[int8 trace losses] {TRACE_LOSS_TRIES} traces of one int8 "
            f"forward against the longest: "
            + json.dumps(_trace_losses(lambda: net(x))))
        if out.shape != (INT8_B, 1000) or not torch.isfinite(out).all():
            raise AssertionError("[int8] the int8 logits are not finite")
        int8_ms = cuda_time_ms(lambda: net(x), warmup=1, iters=3, repeats=3)
        groups = _device_groups(lambda: net(x), 3, "int8 forward", int8_ms)
        agree_f32, err_f32 = _top1_and_err(out, ref)
        agree_bf16, err_bf16 = _top1_and_err(out, ref_bf16)
        bf16_agree, bf16_err = _top1_and_err(ref_bf16, ref)
        t = time.perf_counter()
        enet, escales = Q.convert_to_int8(
            enet, calib_data=[mx.nd.array(v) for v in xs],
            calib_mode="entropy")
        entropy_s = time.perf_counter() - t
        eout = enet(x)._data
        e_agree, e_err = _top1_and_err(eout, ref)
        if len(escales) != INT8_LAYERS or not torch.isfinite(eout).all():
            raise AssertionError("[int8] the entropy-calibrated net failed")
    del net, enet
    _release()
    res = {"forward_ms": {"int8": int8_ms, "f32": f32_ms, "bf16": bf16_ms},
           "int8_vs_f32": {"top1_agreement": agree_f32,
                           "rel_logit_err": err_f32},
           "int8_vs_bf16": {"top1_agreement": agree_bf16,
                            "rel_logit_err": err_bf16},
           "bf16_vs_f32": {"top1_agreement": bf16_agree,
                           "rel_logit_err": bf16_err},
           "entropy_vs_f32": {"top1_agreement": e_agree,
                              "rel_logit_err": e_err},
           "layers": len(scales), "launches": launches,
           "profiled_launches": profiled, "quantisation_kernels": kinds,
           "calib_minmax_s": calib_s,
           "calib_entropy_s": entropy_s, "device": groups,
           "max_abs_err": errs}
    log(f"[int8] resnet50_v1 B={INT8_B} 224x224: {len(scales)} layers; "
        f"a forward int8 {int8_ms:.2f} ms, f32 {f32_ms:.2f}, bf16 "
        f"{bf16_ms:.2f}; int8 vs f32 top-1 {agree_f32:.4f}, rel logit err "
        f"{err_f32:.4g}; vs bf16 {agree_bf16:.4f} / {err_bf16:.4g}; bf16 vs "
        f"f32 {bf16_agree:.4f} / {bf16_err:.4g}; entropy calibration "
        f"{entropy_s:.1f} s, vs f32 {e_agree:.4f} / {e_err:.4g}; launches "
        f"{launches} ({card})")
    timing = _int8_rows(gen)
    res["seconds"] = time.perf_counter() - t0
    log(f"[int8 seconds] {res['seconds']:.1f} s")
    return launches, res, errs, timing


def phase_quantize_model(card):
    """``[quantize_model]``: examples/torch_quantize_model.py at its defaults
    (lenet, 4 classes, 2 epochs of f32 Adam, minmax calibration) on the
    card: f32 accuracy > 0.5 and int8 within 0.05 of it
    (tests/test_quantize_example.py's limits), its int8 launches counted
    from 0 (4 test batches x 5 layers, 2 convolutions of them; the Dense
    layers at K = 120 and 84 on the mma.sync route, the rest on wgmma)."""
    ex = _example("torch_quantize_model")
    _reset_launch_counts()
    t = time.perf_counter()
    fp32_acc, int8_acc = ex.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(_launch_counts(), **_int8_counts())
    if not (fp32_acc > 0.5 and int8_acc >= fp32_acc - 0.05):
        raise AssertionError(f"[quantize_model] accuracy f32 {fp32_acc}, "
                             f"int8 {int8_acc}")
    want = {"int8_gemm": 20, "int8_gemm_wgmma": 12, "int8_gemm_mma": 8,
            "int8_im2col": 8, "adam": 24, "xent_fwd": 24, "xent_bwd": 24}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"[quantize_model] launches {launches}, "
                             f"expected {want}")
    res = {"fp32_acc": fp32_acc, "int8_acc": int8_acc, "seconds": secs}
    log(f"[quantize_model] f32 {fp32_acc:.4f}, int8 {int8_acc:.4f} in "
        f"{secs:.1f} s; launches {launches} ({card})")
    return launches, res


def phase_onnx(card):
    """``[onnx]``: resnet50_v1 (MSRAPrelu, seed 0, BatchNorm statistics
    drawn) through ``HybridBlock.export`` -> ``export_model`` ->
    ``import_model`` -> ``SymbolBlock`` on the card at B=32, 224x224,
    against the Gluon forward within tests/test_onnx.py's resnet tolerance
    (rtol 1e-3, atol 1e-4)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.onnx import export_model, import_model

    net = _resnet50_f32(seed=1)
    rs = np.random.RandomState(41)
    x = mx.nd.array(rs.rand(INT8_B, 3, 224, 224).astype(np.float32))
    with torch.no_grad():
        net(x)  # the deferred shapes
    for name, p in net.collect_params().items():
        n = p.shape[0]
        if name.endswith(("running_var", "gamma")):
            p.set_data(rs.uniform(0.5, 1.5, n).astype(np.float32))
        elif name.endswith(("running_mean", "beta")):
            p.set_data(rs.randn(n).astype(np.float32) * 0.1)
    with torch.no_grad(), tempfile.TemporaryDirectory() as d:
        want = net(x)._data
        t = time.perf_counter()
        sym_file, param_file = net.export(os.path.join(d, "r50"))
        onnx_file = export_model(sym_file, param_file,
                                 input_shapes={"data": tuple(x.shape)},
                                 onnx_file=os.path.join(d, "r50.onnx"))
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        sym, arg_params, aux_params = import_model(onnx_file)
        inputs = [s for s in sym.list_arguments() if s not in arg_params]
        block = mx.gluon.SymbolBlock(sym, inputs,
                                     {**arg_params, **aux_params},
                                     ctx=mx.gpu())
        import_s = time.perf_counter() - t
        nbytes = os.path.getsize(onnx_file)
        got = block(x)._data
        torch.cuda.synchronize()
    if not got.is_cuda or got.shape != want.shape:
        raise AssertionError("[onnx] the imported block's output")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"[onnx] imported resnet50_v1 differs from the "
                             f"Gluon forward by {err}")
    del net, block
    _release()
    res = {"max_abs_diff": err, "export_s": export_s, "import_s": import_s,
           "onnx_bytes": nbytes}
    log(f"[onnx] resnet50_v1 B={INT8_B}: export {export_s:.2f} s "
        f"({nbytes} bytes), import {import_s:.2f} s, max|diff| {err:.3g} "
        f"against the Gluon forward ({card})")
    return res


def phase_dcgan(card):
    """``[dcgan]``: examples/torch_train_dcgan.py at the example's widths
    (ngf = ndf = 32, nz 64, 32x32) at B=64 over DCGAN_SAMPLES synthetic
    blobs, one epoch (64 D/G iterations): losses finite, G's loss moved,
    D's not collapsed (tests/test_dcgan.py's checks), two Adam launches an
    iteration (one a Trainer), ms an iteration (the first excluded), then
    8 more iterations on the same nets under the profiler for the idle
    share."""
    ex = _example("torch_train_dcgan")
    args = ex.build_parser().parse_args(
        ["--epochs", "1", "--batch-size", str(DCGAN_B), "--n-samples",
         str(DCGAN_SAMPLES)])
    stamps, per_iter = [], []

    def on_step(i):
        stamps.append(time.perf_counter())
        per_iter.append(_launch_counts()["adam"])

    _reset_launch_counts()
    d, g, gen, disc = ex.train(args, log=log, on_step=on_step)
    launches = _launch_counts()
    adam = np.diff([0] + per_iter)
    if not (np.isfinite(d).all() and np.isfinite(g).all()):
        raise AssertionError("[dcgan] losses are not finite")
    if abs(g[-1] - g[0]) <= 1e-3 or d[-1] <= 1e-4:
        raise AssertionError(f"[dcgan] G {g[0]} -> {g[-1]}, D {d[-1]}")
    if len(d) != DCGAN_SAMPLES // DCGAN_B or (adam != 2).any():
        raise AssertionError(f"[dcgan] {len(d)} iterations, Adam launches "
                             f"an iteration {sorted(set(adam))}")
    ms = (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3
    short = ex.build_parser().parse_args(
        ["--epochs", "1", "--batch-size", str(DCGAN_B), "--n-samples",
         str(8 * DCGAN_B)])

    def eight():
        ex.train(short, gen=gen, disc=disc, log=lambda *_: None)

    torch.cuda.synchronize()
    t = time.perf_counter()
    eight()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    groups = _device_groups(eight, 1, "dcgan 8 iterations", wall)
    del gen, disc
    _release()
    res = {"iterations": len(d), "ms_per_iteration": ms,
           "d_loss": [d[0], d[-1]], "g_loss": [g[0], g[-1]],
           "adam_per_iteration": 2, "device": groups}
    log(f"[dcgan] B={DCGAN_B}, {len(d)} iterations: {ms:.2f} ms an "
        f"iteration, D {d[0]:.4f} -> {d[-1]:.4f}, G {g[0]:.4f} -> "
        f"{g[-1]:.4f}, 2 Adam launches an iteration, idle share "
        f"{groups['idle_share']} ({card})")
    return launches, res


def phase_generate(card):
    """``[generate]``: examples/torch_generate_gpt2.py with gpt2_117m at the
    full 50,257 vocabulary, batch 8, in GEN_RUNS (default, ``--paged``,
    ``--paged --speculate 4``, ``--share-prefix``, ``--samples 4``), the
    telemetry reset before each: the greedy tokens of the paged and
    speculative runs equal the dense run's (tests/test_paged_inference.py's
    bit-identity), tokens/s (wall of ``main()``, the engine's first calls
    and captures included), pages, prefix hits, forks, accept rate."""
    from mxnet_tpu_torch.models import gpt2
    from mxnet_tpu_torch.observability import REGISTRY

    ex = _example("torch_generate_gpt2")
    net = gpt2.get_gpt2("gpt2_117m", dropout=0.0, vocab_size=50257,
                        max_length=256, device="cuda", seed=0)
    base = ["--model", "gpt2_117m", "--vocab", "50257", "--batch-size", "8"]
    _reset_launch_counts()
    runs = {}
    for name, flags in GEN_RUNS:
        REGISTRY.reset()
        t = time.perf_counter()
        r = ex.main(base + flags, net=net)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        toks = sum(len(q["tokens"]) for q in r["requests"])
        runs[name] = dict(r, seconds=wall, tokens_per_s=toks / wall)
    launches = _launch_counts()
    dense = [q["tokens"] for q in runs["default"]["requests"]]
    for name in ("paged", "speculate"):
        if [q["tokens"] for q in runs[name]["requests"]] != dense:
            raise AssertionError(f"[generate] {name}'s greedy tokens differ "
                                 "from the dense run's")
    if runs["speculate"]["accept_rate"] != 1.0:
        raise AssertionError("[generate] the self-draft's accept rate")
    if runs["samples"]["prefix"]["forks"] != 3 or \
            runs["share_prefix"]["prefix"]["hits"] < 1:
        raise AssertionError(f"[generate] forks / prefix hits: "
                             f"{runs['samples']['prefix']}, "
                             f"{runs['share_prefix']['prefix']}")
    del net
    _release()
    res = {k: {kk: v[kk] for kk in ("seconds", "tokens_per_s", "programs",
                                    "pages", "prefix", "accept_rate")
               if kk in v} for k, v in runs.items()}
    log(f"[generate] gpt2_117m B=8 vocab 50257: " + json.dumps(res)
        + f" ({card})")
    return launches, res


def _write_jpeg_pack(d, n, size, seed=42):
    """``n`` synthetic ``size`` x ``size`` RGB JPEGs (smooth gradients and
    noise) packed with the port's ``io.recordio`` writer into ``d``."""
    from mxnet_tpu_torch.io import recordio

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    path = os.path.join(d, "synthetic.rec")
    rec = recordio.IndexedRecordIO(os.path.join(d, "synthetic.idx"), path,
                                   "w")
    for i in range(n):
        a, b, c = rs.uniform(0, 255, 3)
        img = np.stack([a * xx, b * yy, c * (1 - xx)], -1)
        img = np.clip(img + rs.randn(size, size, 3) * 20, 0, 255)
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(rs.randint(0, 1000)), i, 0),
            img.astype(np.uint8), quality=90))
    rec.close()
    return path


def phase_imagenet(card):
    """``[imagenet]``: examples/torch_train_imagenet_resnet.py at
    ``--layers 50 --batch-size 64 --image-size 224 --steps 12`` on its
    synthetic batches (img/s over the 10 steps after the eager one and the
    capture, a finite loss, one xent pair a step), then ``--rec`` over REC_IMAGES synthetic
    256x256 JPEGs written here by the port's recordio writer, REC_STEPS
    steps (decode img/s)."""
    ex = _example("torch_train_imagenet_resnet")
    args = ex.build_parser().parse_args(
        ["--layers", "50", "--batch-size", "64", "--image-size", "224",
         "--steps", str(IMAGENET_STEPS)])
    _reset_launch_counts()
    syn = ex.train(args)
    launches = _launch_counts()
    if not np.isfinite(syn["losses"]).all():
        raise AssertionError(f"[imagenet] losses {syn['losses']}")
    if launches["xent_fwd"] != IMAGENET_STEPS or \
            launches["xent_bwd"] != IMAGENET_STEPS:
        raise AssertionError(f"[imagenet] launches {launches}")
    _release()
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        path = _write_jpeg_pack(d, REC_IMAGES, 256)
        write_s = time.perf_counter() - t
        rec_args = ex.build_parser().parse_args(
            ["--layers", "50", "--batch-size", "64", "--image-size", "224",
             "--steps", str(REC_STEPS), "--rec", path])
        rec = ex.train(rec_args)
    if not np.isfinite(rec["losses"]).all():
        raise AssertionError(f"[imagenet --rec] losses {rec['losses']}")
    _release()
    res = {"synthetic": syn, "rec": dict(rec, pack_write_s=write_s)}
    log(f"[imagenet] resnet50 B=64: {syn['img_per_s']:.1f} img/s, loss "
        f"{syn['loss']:.4f}; --rec over {REC_IMAGES} JPEGs: "
        f"{rec['img_per_s']:.1f} img/s, decode "
        f"{rec['decode_img_per_s']:.1f} img/s ({card})")
    return launches, res


# ---------------------------------------------------------------------------
# The serving fleet (serving/, tools/torch_servedrill.py --fleet), request
# tracing and measured profiling (observability/{tracing,profiling}.py,
# profiler.py)
FLEET_TICKS = 600
#: decode steps a tracer-cost turn times, and the turns (off/on in turns)
TRACE_COST_STEPS = 24
TRACE_COST_TURNS = (False, True, True, False, False, True)
#: the training capture's depth (train_amp runs 24 layers)
PROFILE_TRAIN_LAYERS = 8


def phase_fleet(net, card):
    """``tools/torch_servedrill.py --fleet`` at full width (``fleet_plan``:
    three gpt2_345m f32 replicas and a replacement from ``net``, each batch
    8, pages of 16, 512 pages, EOS 50256, the serve engine's buckets, warmed
    before the drill's clock starts; FleetRouter(affinity=True, seed=0), a
    keep-everything tracer; 12 requests, the kill at tick 3 and the wedge at
    tick 4, 8 more requests, the session's second turn and one hopeless
    deadline), in graph mode. ``validate_fleet`` must pass (no in-deadline
    drop, the wedged replica DEGRADED -> DRAINING -> DEAD with its work
    redistributed, the replacement, affinity, explicit finish reasons,
    survivors bit-identical to an undisturbed single engine, every
    terminal trace gap-free and reconciled), ``tools/torch_fleetreport.py``
    must show each replica's final state, and each replica that served
    must have launched the paged decode, paged prefill and LayerNorm
    kernels. Returns the phase's launches (baseline, warm-ups and drill)
    and its metrics."""
    sd = _load_drill()
    plan = sd.fleet_plan()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as d:
        _reset_launch_counts()
        t = time.perf_counter()
        run = sd.run_fleet_drill(
            net, plan, device="cuda", engine_type="graph",
            max_ticks=FLEET_TICKS, telemetry_dir=os.path.join(d, "run"),
            fleet_dir=os.path.join(d, "fleet"),
            launch_counts=_serving_launches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = _serving_launches()
        problems = sd.validate_fleet(run)
        if problems:
            raise AssertionError(f"fleet: {problems}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = _tool("torch_fleetreport").main([os.path.join(d, "fleet"),
                                                  "--json"])
        if rc:
            raise AssertionError(f"fleet: torch_fleetreport.py returned {rc}")
        states = {rid: r.get("state") for rid, r in
                  json.loads(out.getvalue())["router"]["replicas"].items()}
    want_states = {str(run["kill_rid"]): "dead", str(run["wedge_rid"]): "dead",
                   str(sd.REPLACEMENT_RID): "live"}
    for rid in range(3):
        want_states.setdefault(str(rid), "live")
    if states != want_states:
        raise AssertionError(f"fleet: the fleet report's states {states}, "
                             f"expected {want_states}")
    served = {rid: n for rid, n in run["port"]["launches"].items()
              if n.get("paged_attention_prefill")}
    for rid, n in run["port"]["launches"].items():
        admitted = any(rid in r["replicas"] for r in run["requests"].values())
        if admitted and not all(n.get(k) for k in (
                "paged_attention", "paged_attention_prefill", "layernorm")):
            raise AssertionError(f"fleet: replica {rid} served without "
                                 f"launching every serving kernel: {n}")
    reasons = [r["reason"] for r in run["requests"].values()]
    res = {"wall_s": wall, "ticks": run["ticks"],
           "requests": len(reasons),
           "reasons": {x: reasons.count(x) for x in set(reasons)},
           "kill": run["kill_rid"], "wedge": run["wedge_rid"],
           "transitions": {str(k): "->".join(t["to"] for t in v)
                           for k, v in run["transitions"].items()},
           "counters": run["counters"],
           "traces": {k: run["traces"][k] for k in ("checked", "hops",
                                                    "phase_err_max")},
           "report_states": states,
           "replica_launches": {str(k): v for k, v in
                                run["port"]["launches"].items()},
           "compiled_programs": {str(k): v for k, v in
                                 run["port"]["compiled_programs"].items()},
           "drill_s": run["wall_s"]}
    log("[fleet] " + json.dumps(res))
    log(f"[fleet] gpt2_345m f32, 3 replicas + replacement, batch 8 each, "
        f"graph: validate_fleet green in {wall:.1f}s ({run['ticks']} ticks); "
        f"launches in the phase {launches}; replicas that served: "
        f"{sorted(served)}")
    del run
    _release()
    res["trace_cost"] = phase_trace_cost(net, card)
    return launches, res


def phase_trace_cost(net, card):
    """The tracer's cost: ms a batcher step on one replica (gpt2_345m f32,
    batch 8, 8 rows decoding) with request tracing off and on (a
    keep-everything tracer, sample 1.0, its spans appended to a file), in
    turns, ``TRACE_COST_STEPS`` steps a turn after every row is
    admitted."""
    from mxnet_tpu_torch.inference import ContinuousBatcher
    from mxnet_tpu_torch.observability import tracing

    sd = _load_drill()
    eng = _serve_engine(net)
    sd.warm_engine(eng)
    rs = np.random.RandomState(5)
    turns = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        for i, on in enumerate(TRACE_COST_TURNS):
            bat = ContinuousBatcher(eng, device="cuda")
            if on:
                bat.tracer = tracing.Tracer(
                    os.path.join(d, f"spans-{i}.jsonl"), "h0",
                    sampler=tracing.TailSampler(sample=1.0, seed=0,
                                                slow_pct=100.0,
                                                margin_floor=0.0))
            reqs = [bat.submit(rs.randint(0, 50257, 32).tolist(),
                               max_new_tokens=TRACE_COST_STEPS + 8)
                    for _ in range(8)]
            bat.step()  # admits all 8 (prefills) and decodes once
            if bat.active != 8:
                raise AssertionError(f"trace cost: {bat.active} rows active")
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(TRACE_COST_STEPS):
                bat.step()
            ms = (time.perf_counter() - t) / TRACE_COST_STEPS * 1e3
            bat.run_until_idle()
            if any(r.finish_reason not in ("length", "eos") for r in reqs):
                raise AssertionError("trace cost: a request did not finish")
            if on:
                bat.tracer.close()
                spans = tracing.read_span_records(
                    os.path.join(d, f"spans-{i}.jsonl"))
                if sum(r.get("name") == "decode.round" for r in spans) < \
                        8 * TRACE_COST_STEPS:
                    raise AssertionError("trace cost: decode.round spans "
                                         "missing")
            turns.append({"trace": on, "ms_per_step": ms})
    off = [t["ms_per_step"] for t in turns if not t["trace"]]
    on_ = [t["ms_per_step"] for t in turns if t["trace"]]
    res = {"turns": turns, "off_ms": statistics.mean(off),
           "on_ms": statistics.mean(on_),
           "cost_ms": statistics.mean(on_) - statistics.mean(off)}
    log(f"[fleet trace cost] gpt2_345m f32 batch 8, 8 rows decoding, "
        f"{TRACE_COST_STEPS} steps a turn: off {[round(x, 3) for x in off]} "
        f"ms/step, on {[round(x, 3) for x in on_]} ms/step (sample 1.0); "
        f"cost {res['cost_ms']:.3f} ms a step on {card}")
    del eng
    _release()
    return res


def _decode_graph_ms(eng):
    """The serve engine's decode step: its captured graph's device time by
    CUDA events (``cuda_time_ms`` of one replay), the host's ms a
    ``decode_step`` call (tokens read back; the step as a caller waits for
    it), one live row, and the host's ms in one untraced
    ``cudaGraphLaunch`` of the step's graph."""
    eng.prefill([1, 2, 3, 4], slot=0)
    for _ in range(2):
        eng.decode_step()
    prog = next(p for k, p in eng._programs.items()
                if k[0] == ("decode", eng.batch_size, "paged"))
    if prog.graph is None:
        raise AssertionError("timing: the decode step has no graph")
    graph_ms = cuda_time_ms(prog.graph.replay, warmup=3, iters=20)
    launch_s = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prog.graph.replay()
        launch_s.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        eng.decode_step()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    eng.release_slot(0)
    return {"graph_ms": graph_ms, "host_ms": host_ms,
            "launch_ms": statistics.mean(launch_s) * 1e3}


def _kernel_names(report):
    return {r.name for r in report.op_rows}


def _has_kernel(names, kernel):
    return any(kernel in n for n in names)


def _host_rows_ms(timeline, name):
    """Durations (ms) of the host rows called ``name`` in a timeline."""
    return [e.dur_ns / 1e6 for p in timeline.planes if p.name == "/host:CPU"
            for ln in p.lines for e in ln.events if e.name == name]


def phase_profile_decode(eng, decode, card):
    """``GenerationEngine.profile(steps=8)`` on the serve engine: 8 step
    rows, the paged decode and LayerNorm kernels among the ops, and each
    step's busy time (``prof_step.busy``, the card busy on the step's
    rows) within 25% of the decode graph's own replay time (``decode``,
    timed by CUDA events beside the timing phase). The measured step (the
    device window by the step's kernel rows, idle gaps included) is held
    against the untraced decode step (the host's ms a ``decode_step`` call)
    and the verdict printed, not enforced: CUPTI holds a traced
    ``cudaGraphLaunch`` on the host while the card idles (both launches
    printed). Beside it: the capture's CUDA-event window of each traced
    call (``prof_step.events``), and a decode step's card time behind a
    queued gate that hides the host's enqueue, traced and untraced measured
    alike (whether the trace slows the card's own work). The capture is
    calibrated against the decode program's schedule ([calibrate]: each op
    class's predicted and measured seconds). Also reported: the host
    annotation against the untraced host step, and the capture's overhead.
    Then ``mx.profiler``: ``set_state('run')``, a few decode steps,
    ``set_state('stop')``, ``dump()`` writes a Chrome trace that names the
    port's kernels."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.observability import profiling

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as d:
        t = time.perf_counter()
        cap = eng.profile(steps=8, trace_dir=os.path.join(d, "decode"))
        call_s = time.perf_counter() - t
        rep = cap.report
        steps = rep.step_seconds()
        spans = rep.span_breakdown()
        names = _kernel_names(rep)
        step_ms = statistics.mean(steps) * 1e3 if steps else None
        busy_ms = spans.get("prof_step.busy", {}).get(
            "mean_seconds", 0.0) * 1e3
        launches = _host_rows_ms(cap.timeline, "cudaGraphLaunch")
        events_ms = spans.get(profiling.EVENTS_SPAN, {}).get(
            "mean_seconds", 0.0) * 1e3
        gated = {"untraced": statistics.mean(_gated_event_ms(eng, False)),
                 "traced": statistics.mean(_gated_event_ms(eng, True))}
        res = {"steps": len(steps), "step_ms": step_ms,
               "step_ms_min": min(steps) * 1e3 if steps else None,
               "step_ms_max": max(steps) * 1e3 if steps else None,
               "busy_ms": busy_ms,
               "host_annotation_ms": spans.get("prof_step.host", {}).get(
                   "mean_seconds", 0.0) * 1e3,
               "decode_graph_ms": decode["graph_ms"],
               "decode_host_ms": decode["host_ms"],
               "graph_launch_ms": {
                   "traced": statistics.mean(launches) if launches
                   else None, "untraced": decode["launch_ms"]},
               "busy_ratio": busy_ms / decode["graph_ms"],
               "window_ratio": step_ms / decode["host_ms"] if steps
               else None,
               "events_ms": events_ms,
               "events_ratio": events_ms / decode["host_ms"],
               "gated_event_ms": gated,
               "gated_event_ratio": gated["traced"] / gated["untraced"],
               "calibrate": _calibration_rows(cap),
               "traced_window_s": cap.seconds, "profile_call_s": call_s,
               "op_rows": len(rep.op_rows),
               "hot_us_per_step": [(h["name"][:60],
                                    round(h["self_ns"] / 8e3, 2))
                                   for h in rep.hot_ops(8)]}
        res["window_within_25pct"] = (res["window_ratio"] is not None and
                                      0.75 <= res["window_ratio"] <= 1.25)
        res["overhead_ms_per_step"] = (res["host_annotation_ms"]
                                       - decode["host_ms"])
        log("[profile decode] " + json.dumps(res))
        if len(steps) != 8:
            raise AssertionError(f"profile: {len(steps)} step rows, not 8")
        for k in ("paged_attention_kernel", "layernorm_fwd_warp_kernel"):
            if not _has_kernel(names, k):
                raise AssertionError(f"profile: no {k} among {sorted(names)}")
        if not 0.75 <= res["busy_ratio"] <= 1.25:
            raise AssertionError(
                f"profile: the card busy {busy_ms:.3f} ms a traced decode "
                f"step against the decode graph's {decode['graph_ms']:.3f} "
                f"ms")
        if not busy_ms <= step_ms:
            raise AssertionError(f"profile: busy {busy_ms:.3f} ms outside "
                                 f"its window {step_ms:.3f} ms")
        # mx.profiler around a few decode steps
        profiler.set_config(filename=os.path.join(d, "mx", "profile.json"))
        eng.prefill([1, 2, 3, 4], slot=0)
        profiler.set_state("run")
        for _ in range(4):
            eng.decode_step()
        profiler.set_state("stop")
        out = profiler.dump()
        eng.release_slot(0)
        tl = profiling.parse_trace(out)
        names = {e.name for p in tl.planes if p.is_device for ln in p.lines
                 for e in ln.events}
        for k in ("paged_attention_kernel", "layernorm_fwd_warp_kernel"):
            if not _has_kernel(names, k):
                raise AssertionError(f"mx.profiler: no {k} in the trace")
        table = profiler.dumps(reset=True)
        res["mx_profiler"] = {"device_rows": sum(
            len(ln.events) for p in tl.planes if p.is_device
            for ln in p.lines), "table_rows": len(table.splitlines()) - 3}
    gl = res["graph_launch_ms"]
    log("[calibrate] decode " + json.dumps(res["calibrate"]))
    log(f"[profile decode] gpt2_345m f32 serve engine: 8 step rows, device "
        f"window {step_ms:.3f} ms a step against the untraced decode step's "
        f"{decode['host_ms']:.3f} ms (x{res['window_ratio']:.3f}: "
        f"{'within' if res['window_within_25pct'] else 'OUTSIDE'} 25%); by "
        f"CUDA events around the traced call {events_ms:.3f} ms "
        f"(x{res['events_ratio']:.3f}); a traced cudaGraphLaunch holds the "
        f"host {gl['traced']:.3f} ms against {gl['untraced']:.3f} untraced; "
        f"behind a gate that hides the enqueue, {gated['traced']:.3f} ms "
        f"traced against {gated['untraced']:.3f} untraced "
        f"(x{res['gated_event_ratio']:.3f}); card busy {busy_ms:.3f} "
        f"ms of it (the decode graph {decode['graph_ms']:.3f} ms by CUDA "
        f"events); host {res['host_annotation_ms']:.3f} ms a traced step "
        f"against {decode['host_ms']:.3f} untraced; mx.profiler "
        f"{res['mx_profiler']}; {card}")
    return res


def phase_profile_train(card):
    """``TrainStep.profile(steps=2)`` on gpt2_345m at full width but
    ``PROFILE_TRAIN_LAYERS`` layers under ``amp="bfloat16"`` (B=4,
    T=1024, the train_amp step): 2 step rows, the flash forward, dK/dV and
    dQ, Adam and xent kernels among the ops, every traced step a replay.
    Then one periodic capture (``prof_every_n_steps``) and one trigger-file
    capture (``prof-request-h0.json`` in a fleet dir), whose snapshots
    land under ``prof/prof-*`` and ``telemetry-h0/prof-*``, the second
    swept by ``prof_keep_bytes``."""
    import glob

    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.observability import profiling
    from mxnet_tpu_torch.ops import cuda_graph as cg

    net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0,
                   num_layers=PROFILE_TRAIN_LAYERS)
    ts = _train_step(net, "bfloat16", "graph")
    batch = _train_batch(4, 1024)
    knobs = {k: config.get(k) for k in ("prof_every_n_steps", "fleet_dir",
                                        "profiler_dir", "prof_keep_bytes")}
    was_dir = obs._dir
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as d:
            n0 = cg.unreplayed_calls()
            t = time.perf_counter()
            cap = ts.profile(*batch, steps=2, trace_dir=os.path.join(d, "ts"))
            call_s = time.perf_counter() - t
            rep = cap.report
            names = _kernel_names(rep)
            spans = rep.span_breakdown()
            res = {"layers": PROFILE_TRAIN_LAYERS,
                   "steps": len(rep.step_rows()),
                   "step_ms": [s * 1e3 for s in rep.step_seconds()],
                   "busy_ms": spans.get("prof_step.busy", {}).get(
                       "mean_seconds", 0.0) * 1e3,
                   "graph_launch_ms": _host_rows_ms(cap.timeline,
                                                    "cudaGraphLaunch"),
                   "host_annotation_ms": spans.get("prof_step.host", {}).get(
                       "mean_seconds", 0.0) * 1e3,
                   "warmup_and_capture_calls": cg.unreplayed_calls() - n0,
                   "traced_window_s": cap.seconds, "profile_call_s": call_s,
                   "op_rows": len(rep.op_rows),
                   "hot": [(h["name"][:50], round(h["self_ns"] / 2e6, 3))
                           for h in rep.hot_ops(6)],
                   "calibrate": _calibration_rows(cap)}
            log("[profile train] " + json.dumps(res))
            log("[calibrate] train " + json.dumps(res["calibrate"]))
            if res["steps"] != 2:
                raise AssertionError(f"train profile: {res['steps']} step "
                                     f"rows")
            want = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                    "flash_bwd_dq_tc_kernel", "adam_kernel",
                    "xent_fwd_kernel", "xent_bwd_kernel")
            missing = [k for k in want if not _has_kernel(names, k)]
            if missing:
                raise AssertionError(f"train profile: no {missing}")
            # periodic: every 3rd step of a short loop
            obs._dir = None
            config.set("prof_every_n_steps", 3)
            config.set("profiler_dir", os.path.join(d, "local"))
            profiling._reset_controller()
            for _ in range(3):
                ts(*batch)
            torch.cuda.synchronize()
            periodic = glob.glob(os.path.join(d, "local", "prof", "prof-*",
                                              "profile.json"))
            if len(periodic) != 1:
                raise AssertionError(f"periodic capture: {periodic}")
            snap = json.load(open(periodic[0]))
            if snap["report"]["steps"] != 1 or not any(
                    dev.startswith("/device:GPU")
                    for dev in snap["report"]["devices"]):
                raise AssertionError(f"periodic capture: {snap['report']}")
            res["periodic"] = {"dir": os.path.basename(
                os.path.dirname(periodic[0])),
                "step_ms": snap["report"]["step_seconds"]["mean"] * 1e3}
            # triggered: a request file in the fleet dir, twice; the keep
            # cap of 1 byte sweeps the first capture when the second lands
            fdir = os.path.join(d, "fleet")
            os.makedirs(fdir)
            config.set("prof_every_n_steps", 0)
            config.set("fleet_dir", fdir)
            config.set("prof_keep_bytes", 1)
            profiling._reset_controller()
            seen = []
            for _ in range(2):
                with open(profiling.request_path(fdir, 0), "w") as f:
                    json.dump({"reason": "chip_smoke"}, f)
                profiling._ensure_controller()._next_probe = 0.0
                ts(*batch)
                torch.cuda.synchronize()
                seen.append(sorted(os.path.basename(p) for p in glob.glob(
                    os.path.join(fdir, "telemetry-h0", "prof-*"))))
            if len(seen[0]) != 1 or len(seen[1]) != 1 or seen[0] == seen[1]:
                raise AssertionError(f"triggered capture / sweep: {seen}")
            res["triggered"] = {"kept": seen[1], "swept": seen[0]}
    finally:
        for k, v in knobs.items():
            config.set(k, v)
        obs._dir = was_dir
        profiling._reset_controller()
    log("[profile train] " + json.dumps(res))
    log(f"[profile train] gpt2_345m bf16, {PROFILE_TRAIN_LAYERS} of 24 "
        f"layers, B=4 T=1024: 2 replayed steps traced (device windows "
        f"{[round(x, 2) for x in res['step_ms']]} ms, the card busy "
        f"{res['busy_ms']:.2f} ms a step), flash, Adam and xent kernels "
        f"named; periodic {res['periodic']['dir']}, triggered "
        f"{res['triggered']}; {card}")
    res["audit"] = phase_audit_train(ts, batch, card)
    del ts, net
    _release()
    return res


def _calibration_rows(cap):
    """[calibrate]'s rows of one capture: each op class's predicted
    (roofline) and measured seconds a step, their ratio and the ratio
    normalized by the median, the drifting classes, and the trace rows no
    class takes (``other``) by name."""
    cal = cap.calibration
    other = collections.Counter()
    for r in cap.report.op_rows:
        if r.op_class == "other":
            other[r.name[:70]] += r.dur_ns
    return {"rows": [[r.op_class, r.predicted_seconds, r.measured_seconds,
                      r.ratio, r.normalized, r.drift] for r in cal.rows],
            "other_rows_ns": other.most_common(4),
            "overall_ratio": cal.overall_ratio,
            "predicted_step_s": cal.predicted_step_seconds,
            "measured_step_s": cal.measured_step_seconds,
            "drifting": [[d["op_class"], d["normalized_ratio"], d["knob"]]
                         for d in cal.drifting]}


def _gated_event_ms(eng, traced, steps=4, cycles=50_000_000):
    """A decode step's card time with the host's enqueue hidden: a queued
    ``torch.cuda._sleep`` gate (``cycles``, 25–35 ms at the H100's clocks)
    holds the stream while the host enqueues the step, and CUDA events from
    the gate's end to the call's end time it. ``traced`` runs the steps
    under ``torch.profiler`` (CPU and CUDA activities), else untraced; the
    two sides are measured alike (ms a step)."""
    eng.prefill([1, 2, 3, 4], slot=0)
    for _ in range(2):
        eng.decode_step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = []
    with torch.profiler.profile(activities=acts) if traced \
            else contextlib.nullcontext():
        torch.cuda.synchronize()
        for _ in range(steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            e0.record()
            eng.decode_step()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1))
    eng.release_slot(0)
    return out


def _audit_figures(audit, seconds):
    """What [audit decode] / [audit train] print of one audit: the record
    (ops, kernels, products), the graph (nodes by type, edges), the three
    kernel columns (record, graph, launch counters over the capture), the
    carry and the memory estimate."""
    from mxnet_tpu_torch.observability import goodput

    def keyed(col):
        return {f"{k[0].rsplit('.', 1)[-1]}:{k[1]}": v
                for k, v in sorted(col.items(), key=str)}

    rec = audit.lowered
    out = {"audit_s": seconds, "record_ops": len(rec.ops),
           "products": rec.dot_dtypes(),
           "f64_ops": len(rec.ops_with_dtype("f64")),
           "flops": goodput.program_flops(rec).total,
           "carry_n": len(audit.carry_indices),
           "carry_in_place": audit.carry_donation(),
           "memory": audit.memory.summary()}
    out["memory"].pop("top_buffers", None)
    if audit.compiled is None:
        out["why_not_compiled"] = audit.why_not_compiled
        out["kernels"] = {"record": keyed(rec.kernel_counts())}
        return out
    g = audit.compiled
    out["nodes"] = len(g.ops)
    out["edges"] = len(g.edges)
    out["node_types"] = g.op_census()
    out["memcpy_nodes"] = sum(n for k, n in g.op_census().items()
                              if k.startswith("memcpy"))
    out["kernels"] = {k: keyed(v) for k, v in audit.census().items()}
    return out


def _check_audit(what, audit, figures, measured=None, unread=0):
    """The checks every audit phase makes: the graph census, the launch
    counters over its capture and the record agree on every port kernel;
    the carry is updated in place. Given what the card ``measured`` for one
    eager call (``measured_peak``: the call's own allocations at their
    peak, and what the allocator held), the memory estimate is held against
    the card in two parts: its pinned inputs equal what the real input
    tensors' storages hold, less the ``unread`` bytes of a storage the
    program reads only a view of, exactly; its temporaries are within
    ``VALIDATION_TOLERANCE`` of the call's own peak (the allocator's figure
    printed beside)."""
    from mxnet_tpu_torch.analysis import VALIDATION_TOLERANCE, \
        census_mismatches

    if audit.compiled is not None:
        bad = census_mismatches(audit)
        if bad:
            raise AssertionError(f"{what}: record, graph and launch "
                                 f"counters disagree: {bad}")
    if audit.carry_donation() != 1.0:
        raise AssertionError(f"{what}: carry in place "
                             f"{audit.carry_donation()}, missing inputs "
                             f"{audit.carry_missing()}")
    if measured is not None:
        mem = audit.memory
        transient, held = measured
        stored = audit.lowered.input_storage_bytes
        figures["input_storage_bytes"] = stored
        figures["measured_transient_bytes"] = transient
        figures["allocator_held_bytes"] = held
        figures["transient_estimate_over_measured"] = \
            mem.temp_peak_bytes / transient
        if mem.input_bytes + unread != stored:
            raise AssertionError(f"{what}: the estimate pins {mem.input_bytes}"
                                 f" B of inputs, their storages hold {stored} "
                                 f"B ({unread} B unread)")
        if abs(mem.temp_peak_bytes / transient - 1.0) > VALIDATION_TOLERANCE:
            raise AssertionError(f"{what}: the estimate's temporaries "
                                 f"{mem.temp_peak_bytes} B are outside "
                                 f"{VALIDATION_TOLERANCE} of the measured "
                                 f"transient {transient} B")


def phase_audit_decode(eng, card):
    """``GenerationEngine.audit()`` on the gpt2_345m f32 serve engine (B=8,
    full width, pages of 16) whose programs the earlier phases ran: the
    decode program, a prefill bucket's and the copy-on-write program
    (captured by a fork here). Each: the record's ops and kernels, the
    graph's nodes and edges, the three kernel columns equal, the carry in
    place; the decode graph holds no memcpy node; its ``kv_pages`` bytes
    are the pools' and the page table's; its estimate's inputs equal their
    storages' bytes and its temporaries hold the transient the card
    measured for one eager call within ``VALIDATION_TOLERANCE``; and
    audits between decode steps change no token."""
    from mxnet_tpu_torch.analysis import measured_peak
    from mxnet_tpu_torch.ops import cuda_graph as cg

    # the copy-on-write program's graph: three forks, each followed by a
    # step that writes into the shared page (one copy each: warm-up,
    # capture, replay)
    eng.prefill([5, 6, 7, 8, 9], slot=0)
    for dst in (1, 2, 3):
        eng.fork_slot(0, dst)
        eng.decode_step()
    for slot in range(4):
        eng.release_slot(slot)
    res = {}
    for name, kw in (("decode", {}), ("prefill_16", {"bucket": 16}),
                     ("cow", {"program": "cow"})):
        t = time.perf_counter()
        audit = eng.audit(**kw)
        secs = time.perf_counter() - t
        figures = _audit_figures(audit, secs)
        measured = None
        unread = 0
        if name == "decode":
            prog = eng._programs[(eng._decode_sig(), cg.capture_state())]
            with torch.inference_mode():
                measured = measured_peak(prog.fn)
            pools = sum(t.numel() * t.element_size()
                        for kv in eng.pools for t in kv)
            table = eng.page_table.numel() * eng.page_table.element_size()
            # the table is a view of a flat buffer one entry longer, whose
            # spare entry only the copy-on-write program writes
            unread = eng._table_flat.untyped_storage().nbytes() - table
            figures["kv_pages_bytes"] = audit.memory.by_category["kv_pages"]
            if figures["kv_pages_bytes"] != pools + table:
                raise AssertionError(
                    f"audit decode: kv_pages {figures['kv_pages_bytes']} B, "
                    f"the pools and table hold {pools + table} B")
            if audit.compiled is None or figures["memcpy_nodes"]:
                raise AssertionError(
                    f"audit decode: graph {figures.get('node_types')} "
                    f"({audit.why_not_compiled})")
        _check_audit(f"audit {name}", audit, figures, measured, unread)
        res[name] = figures
    # audits between decode steps change no token

    def tokens(audited):
        eng.prefill([11, 12, 13], slot=0)
        eng.prefill([21, 22, 23, 24, 25, 26], slot=1)
        out = []
        for _ in range(6):
            if audited:
                eng.audit()
                eng.audit(bucket=16)
            out.append(eng.decode_step()[0].tolist())
        eng.release_slot(0)
        eng.release_slot(1)
        return out

    plain = tokens(False)
    if tokens(True) != plain:
        raise AssertionError("audit decode: an audit changed the tokens")
    res["tokens_unchanged"] = True
    log("[audit decode] " + json.dumps(res, default=str))
    d = res["decode"]
    log(f"[audit decode] gpt2_345m f32 serve engine, B=8: the decode graph "
        f"{d['nodes']} nodes ({d['node_types']}), {d['edges']} edges, no "
        f"memcpy; record {d['record_ops']} ops, kernels "
        f"{d['kernels']['graph']} in the record, the graph and the "
        f"counters alike; carry {d['carry_n']} pools in place; inputs "
        f"{d['memory']['input_bytes']} B pinned, their storages "
        f"{d['input_storage_bytes']} B; temporaries "
        f"{d['memory']['temp_peak_bytes']} B against a measured transient "
        f"of {d['measured_transient_bytes']} B "
        f"(x{d['transient_estimate_over_measured']:.4f}; the allocator held "
        f"{d['allocator_held_bytes']} B); audit "
        f"{d['audit_s']:.3f} s; tokens unchanged; {card}")
    return res


def gpt2_train_flops(batch, seq, layers, units=1024, heads=16,
                     vocab=50257):
    """The hand count of one GPT-2 LM training step: 3 x (layers x the
    forward products of a layer + the tied head), each attention product
    over the full T x T."""
    ch = units // heads
    layer = (2 * batch * seq * units * 3 * units
             + 2 * (2 * batch * heads * seq * seq * ch)
             + 2 * batch * seq * units * units
             + 2 * (2 * batch * seq * units * 4 * units))
    return 3 * (layers * layer + 2 * batch * seq * units * vocab)


def phase_audit_train(ts, batch, card):
    """``TrainStep.audit`` on the ``train_amp`` step ``[profile train]``
    built (gpt2_345m width, bf16, B=4, T=1024, PROFILE_TRAIN_LAYERS deep):
    the audit checks of [audit decode] (the memory estimate against the
    inputs' storages and one eager step's measured transient), no f64 op,
    no parameter or moment changed by the audit, ``model_flops_per_step``
    equal to the hand count, and the ``train_mfu`` gauge set by two
    telemetry steps against ``peak_flops`` = 989e12 (the bf16 tensor
    cores)."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.analysis import measured_peak
    from mxnet_tpu_torch.ops import cuda_graph as cg

    carry = [t.detach().clone() for group in ts._carry() for t in group]
    t = time.perf_counter()
    audit = ts.audit(*batch)
    secs = time.perf_counter() - t
    after = [t.detach() for group in ts._carry() for t in group]
    if not all(torch.equal(a, b) for a, b in zip(carry, after)):
        raise AssertionError("audit train: the audit changed the carry")
    del carry, after
    figures = _audit_figures(audit, secs)
    if figures["f64_ops"]:
        raise AssertionError(f"audit train: {figures['f64_ops']} f64 ops")
    want = gpt2_train_flops(*batch[0].shape, PROFILE_TRAIN_LAYERS)
    flops = ts.model_flops_per_step(*batch)
    figures["model_flops_per_step"] = flops
    if flops != want:
        raise AssertionError(f"audit train: model_flops_per_step {flops} "
                             f"against the hand count {want}")
    shapes = tuple((tuple(b.shape), b.dtype) for b in batch)
    key = ("step", shapes, cg.capture_state(), False, ts._hyper_key())
    if audit.compiled is None:
        raise AssertionError(f"audit train: {audit.why_not_compiled}")
    _check_audit("audit train", audit, figures,
                 measured_peak(ts._programs[key][0].fn))
    was = config.get("peak_flops")
    config.set("peak_flops", 989e12)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mfu_") as d:
            obs.enable(d)
            try:
                for _ in range(3):  # warm-up, capture, a replay
                    ts(*batch)
                torch.cuda.synchronize()
                figures["train_mfu"] = obs.gauge("train_mfu").value()
                figures["train_model_flops_per_step"] = \
                    obs.gauge("train_model_flops_per_step").value()
                figures["train_mfu_bound"] = \
                    obs.gauge("train_mfu_bound").value()
            finally:
                obs.disable()
    finally:
        config.set("peak_flops", was)
    if not figures["train_mfu"] or \
            figures["train_model_flops_per_step"] != want:
        raise AssertionError(f"audit train: gauges {figures}")
    log("[audit train] " + json.dumps(figures, default=str))
    log(f"[audit train] gpt2_345m bf16 B=4 T=1024, {PROFILE_TRAIN_LAYERS} "
        f"layers: the step graph {figures['nodes']} nodes, "
        f"{figures['memcpy_nodes']} memcpy, {figures['edges']} edges; record "
        f"{figures['record_ops']} ops, products {figures['products']}, no "
        f"f64; kernels {figures['kernels']['graph']} in the record, the "
        f"graph and the counters alike; carry {figures['carry_n']} in place; "
        f"inputs {figures['memory']['input_bytes']} B pinned, their storages "
        f"{figures['input_storage_bytes']} B; temporaries "
        f"{figures['memory']['temp_peak_bytes']} B against a measured "
        f"transient of {figures['measured_transient_bytes']} B "
        f"(x{figures['transient_estimate_over_measured']:.4f}; the allocator "
        f"held {figures['allocator_held_bytes']} B); model FLOPs "
        f"a step "
        f"{flops:.6e} (the hand count), train_mfu {figures['train_mfu']:.4f}"
        f" against 989e12, bound {figures['train_mfu_bound']:.4f}; audit "
        f"{secs:.3f} s; {card}")
    return figures


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs one "
                 "NVIDIA H100")
    import mxnet_tpu_torch  # noqa: F401  (fails outside a checkout)

    # f32 references on the card are true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_build()
    errs = phase_kernels()
    phase_dense_equals_paged()
    phase_dense_equals_paged(amp="bfloat16")
    phase_dense_equals_paged(amp="float16")
    parity = phase_train_parity()
    from mxnet_tpu_torch.inference import GenerationEngine
    from mxnet_tpu_torch.models import get_gpt2

    t = time.perf_counter()
    serve_net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0)
    log(f"[serve] gpt2_345m f32 built in {time.perf_counter() - t:.1f}s; "
        f"batch 8, 512 pages of 16")
    phase_graph_equals_naive(serve_net)
    serve_launches, serve, plain = phase_serve_turns(serve_net)
    t = time.perf_counter()
    draft_net = get_gpt2("gpt2_117m", dropout=0.0, device="cuda", seed=1)
    log(f"[spec] gpt2_117m f32 draft built in {time.perf_counter() - t:.1f}s;"
        f" k {SPEC_K}")
    spec_launches, spec = phase_spec(serve_net, draft_net, plain)
    governed_launches, governed = phase_governed(serve_net, draft_net, plain)
    drill_launches, drill = phase_drill(serve_net, draft_net)
    eng, stall_launches, stall = phase_stall(serve_net, plain)
    overload_launches, overload = phase_overload(eng, plain)
    log("[serving resilience] " + json.dumps(
        {"governed": governed, "drill": drill, "stall": stall,
         "overload": overload}))
    del draft_net, plain, eng
    _release()
    prefix_launches, prefix = phase_prefix(serve_net)
    fork_launches, fork = phase_fork(serve_net)
    log("[serving features] " + json.dumps(
        {"spec": spec, "prefix": prefix, "fork": fork}))
    fleet_launches, fleet = phase_fleet(serve_net, card)
    # the serve engine's pools and table, for the kernels' timing
    eng = GenerationEngine(serve_net, batch_size=8, max_length=1024,
                           paged=True, page_size=16, device="cuda")
    timing = phase_timing(eng)
    profile_decode = phase_profile_decode(eng, _decode_graph_ms(eng), card)
    audit_decode = phase_audit_decode(eng, card)
    del eng, serve_net
    _release()
    amp_parity = phase_train_parity(amp="bfloat16")
    bert_parity = {amp or "f32": phase_train_parity(amp=amp, model="bert")
                   for amp in (None, "bfloat16")}
    net, train_launches, train = phase_train_turns()
    timing.update(phase_train_timing(net))
    log("[train] " + json.dumps(dict(runs=train, parity=parity)))
    del net
    _release()
    net, amp_launches, train_amp = phase_train_turns(amp="bfloat16")
    del net
    _release()
    log("[train_amp] " + json.dumps(dict(runs=train_amp, parity=amp_parity)))
    profile_train = phase_profile_train(card)
    log("[fleet and profile] " + json.dumps(
        {"fleet_s": fleet["wall_s"],
         "trace_cost_ms": fleet["trace_cost"]["cost_ms"],
         "decode_step_ms": profile_decode["step_ms"],
         "decode_window_ratio": profile_decode["window_ratio"],
         "audit_decode_s": audit_decode["decode"]["audit_s"],
         "audit_train_s": profile_train["audit"]["audit_s"],
         "decode_busy_ms": profile_decode["busy_ms"],
         "decode_capture_overhead_ms": profile_decode["overhead_ms_per_step"],
         "train_step_ms": profile_train["step_ms"]}))
    gluon_parity = phase_gluon_parity()
    gluon_launches, gluon = phase_gluon()
    log("[gluon] " + json.dumps(dict(run=gluon, parity=gluon_parity)))
    loop_launches, train_loop = phase_train_loop(card)
    t = time.perf_counter()
    conv_precision = phase_conv_precision()
    vision_launches, resnet = phase_resnet()
    log("[resnet] " + json.dumps(dict(runs=resnet,
                                      conv_precision=conv_precision)))
    lenet_launches, lenet = phase_lenet()
    log("[lenet] " + json.dumps(lenet))
    log(f"[vision seconds] {time.perf_counter() - t:.1f} s")
    net, bert_launches, bert_amp = phase_bert_turns(card)
    timing.update(phase_bert_timing(net))
    bert_dropout = phase_bert_dropout(net, card)
    del net
    _release()
    log("[bert_amp] " + json.dumps(dict(runs=bert_amp, parity=bert_parity,
                                        dropout=bert_dropout)))
    nn_launches, nn_ops = phase_nn_ops()
    optimizers = phase_optimizers()
    log("[optimizers] " + json.dumps(optimizers))
    pretrain_launches, pretrain = phase_pretrain_bert(card)
    log("[pretrain_bert] " + json.dumps(pretrain))
    t = time.perf_counter()
    tf_parity = phase_transformer_parity()
    tf_launches, tf_runs, tf_masked, big_launches, tf_big = \
        phase_transformer_turns(card)
    decode_launches, tf_decode = phase_transformer_decode(card)
    tf_loop_launches, tf_loop = phase_transformer_loop(card)
    log("[transformer] " + json.dumps(dict(
        runs=tf_runs, parity=tf_parity, masked_attention=tf_masked,
        big=tf_big, decode=tf_decode, loop=tf_loop)))
    mnist_launches, mnist = phase_mnist(card)
    log("[mnist] " + json.dumps(mnist))
    log(f"[transformer and mnist seconds] {time.perf_counter() - t:.1f} s")
    extra_launches, _ = phase_extra_ops()
    wlm_launches, wlm_loop_launches, word_lm = phase_word_lm(card)
    wlm_net = word_lm.pop("timing_net")
    log("[word_lm] " + json.dumps(word_lm, default=str))
    detection = phase_detection()
    log("[detection] " + json.dumps(detection))
    ssd_launches, ssd300_launches, ssd_net, ssd = phase_ssd(card)
    log("[ssd] " + json.dumps(ssd, default=str))
    est_launches, estimator = phase_estimator(card)
    log("[estimator] " + json.dumps(estimator))
    sym_launches, sym_ft_launches, symbol = phase_symbol(card)
    log("[symbol] " + json.dumps(symbol))
    lm_launches, module = phase_module(card)
    lm_params = module.pop("timing_params")
    log("[module] " + json.dumps(module))
    sparse_launches, lm1b_launches, sparse, sparse_timing = \
        phase_sparse(card)
    log("[sparse] " + json.dumps(sparse, default=str))
    log("[np] " + json.dumps(phase_np(card)))
    t = time.perf_counter()
    int8_launches, int8, int8_errs, int8_timing = phase_int8(card)
    log("[int8] " + json.dumps(int8, default=str))
    qm_launches, quantize_model = phase_quantize_model(card)
    log("[quantize_model] " + json.dumps(quantize_model))
    log("[onnx] " + json.dumps(phase_onnx(card)))
    dcgan_launches, dcgan = phase_dcgan(card)
    log("[dcgan] " + json.dumps(dcgan, default=str))
    gen_launches, generate = phase_generate(card)
    log("[generate] " + json.dumps(generate, default=str))
    imagenet_launches, imagenet = phase_imagenet(card)
    log("[imagenet] " + json.dumps(imagenet, default=str))
    log(f"[int8, quantize_model, onnx and example routes seconds] "
        f"{time.perf_counter() - t:.1f} s")
    log("[engine types] " + json.dumps(
        {"turns": MODE_TURNS, "serve": serve, "train": train,
         "train_amp": train_amp, "bert_amp": bert_amp,
         "resnet": resnet["resnet"], "resnet_bf16": resnet["resnet_bf16"],
         "transformer": tf_runs}))
    timing.update(phase_xent_timing())
    timing.update(phase_transformer_timing(card))
    timing.update(phase_vision_timing())
    timing.update(phase_word_lm_timing(wlm_net))
    timing.update(phase_ssd_timing(ssd_net))
    timing["adam_ssd300"] = timing["adam_ssd"]
    timing.update(phase_symbol_timing(lm_params))
    timing.update(sparse_timing)
    timing.update(int8_timing)
    errs.update(int8_errs)
    # the imported transformer_base runs the Transformer's f32 flash shapes
    # and its fine-tune updates transformer_base's tensors
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        timing[f"{k}_symbol"] = timing[f"{k}_transformer"]
    timing["adam_symbol"] = timing["adam_transformer"]
    del wlm_net, ssd_net, lm_params
    _release()
    log("[batch_norm] " + json.dumps(timing["batch_norm"]))
    # (source, replaced TPU kernel, the path whose run gives `launches`[,
    # its counter when the name without "_bf16" is not; the BERT rows'
    # max_abs_err is that of the check at their shape])
    meta = {
        "paged_attention": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                            "mxnet_tpu/ops/pallas_paged_attention.py:79",
                            "serve"),
        # the prefill read (the tensor-core kernel of the same file; its
        # launches: the serve run's prefill reads)
        "paged_attention_prefill": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                                    "mxnet_tpu/ops/pallas_paged_attention.py:79",
                                    "serve"),
        # the speculative path's reads: the verify through the prefill
        # kernel, the gpt2_117m draft's through the decode kernel (their
        # max_abs_err: the f32 checks at their shapes)
        "paged_attention_verify": (
            "mxnet_tpu_torch/csrc/paged_attention.cu",
            "mxnet_tpu/ops/pallas_paged_attention.py:79", "spec",
            "paged_attention_prefill", "paged_attention_verify"),
        "paged_attention_draft": (
            "mxnet_tpu_torch/csrc/paged_attention.cu",
            "mxnet_tpu/ops/pallas_paged_attention.py:79", "spec",
            "paged_attention", "paged_attention_draft"),
        "layernorm": ("mxnet_tpu_torch/csrc/layernorm.cu",
                      "mxnet_tpu/ops/pallas_layernorm.py:53", "serve"),
        # the same kernel on bf16 x, gamma and beta (train_amp), and the
        # backward kernels (row kernel and merge; their launches: the row
        # kernel's), the VJP of _ln_kernel's custom_vjp (_ln_bwd, plain jnp
        # on the TPU)
        "layernorm_bf16": ("mxnet_tpu_torch/csrc/layernorm.cu",
                           "mxnet_tpu/ops/pallas_layernorm.py:53",
                           "train_amp"),
        "layernorm_bwd": ("mxnet_tpu_torch/csrc/layernorm.cu",
                          "mxnet_tpu/ops/pallas_layernorm.py:97", "train"),
        "layernorm_bwd_bf16": ("mxnet_tpu_torch/csrc/layernorm.cu",
                               "mxnet_tpu/ops/pallas_layernorm.py:97",
                               "train_amp"),
        "flash_fwd": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                      "mxnet_tpu/ops/flash_attention.py:100", "train"),
        "flash_bwd_dkv": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                          "mxnet_tpu/ops/flash_attention.py:256", "train"),
        "flash_bwd_dq": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                         "mxnet_tpu/ops/flash_attention.py:285", "train"),
        # the same kernels' bf16 instantiations, on the train_amp path
        "flash_fwd_bf16": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                           "mxnet_tpu/ops/flash_attention.py:100", "train_amp"),
        "flash_bwd_dkv_bf16": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                               "mxnet_tpu/ops/flash_attention.py:256",
                               "train_amp"),
        "flash_bwd_dq_bf16": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                              "mxnet_tpu/ops/flash_attention.py:285",
                              "train_amp"),
        "adam": ("mxnet_tpu_torch/csrc/adam.cu",
                 "mxnet_tpu/ops/pallas_optimizer.py:63", "train"),
        "xent_fwd": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                     "mxnet_tpu/ops/pallas_softmax_xent.py:54", "train_amp"),
        "xent_bwd": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                     "mxnet_tpu/ops/pallas_softmax_xent.py:54", "train_amp"),
        # BERT's shapes on bert_amp (bf16): the encoder's (8192, 1024) rows
        # and mlm_ln's (1280, 1024); the launches count both shapes
        "layernorm_bert": ("mxnet_tpu_torch/csrc/layernorm.cu",
                           "mxnet_tpu/ops/pallas_layernorm.py:53", "bert_amp",
                           "layernorm", "layernorm_bf16_8192"),
        "layernorm_bwd_bert": ("mxnet_tpu_torch/csrc/layernorm.cu",
                               "mxnet_tpu/ops/pallas_layernorm.py:97",
                               "bert_amp", "layernorm_bwd",
                               "layernorm_bwd_bf16_8192"),
        "layernorm_mlm": ("mxnet_tpu_torch/csrc/layernorm.cu",
                          "mxnet_tpu/ops/pallas_layernorm.py:53", "bert_amp",
                          "layernorm", "layernorm_bf16_1280"),
        "layernorm_bwd_mlm": ("mxnet_tpu_torch/csrc/layernorm.cu",
                              "mxnet_tpu/ops/pallas_layernorm.py:97",
                              "bert_amp", "layernorm_bwd",
                              "layernorm_bwd_bf16_1280"),
        "adam_bert": ("mxnet_tpu_torch/csrc/adam.cu",
                      "mxnet_tpu/ops/pallas_optimizer.py:63", "bert_amp",
                      "adam", None),
        # the vision paths' shapes: ResNet-50's head (f32 B=64, bf16
        # B=128), LeNet's (64, 10) and its Adam over 10 tensors (their
        # max_abs_err: the checks at their shapes)
        "xent_fwd_resnet": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                            "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                            "resnet", "xent_fwd",
                            "xent_fwd float32 (64, 1000)"),
        "xent_bwd_resnet": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                            "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                            "resnet", "xent_bwd",
                            "xent_bwd float32 (64, 1000)"),
        "xent_fwd_resnet_bf16": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                                 "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                                 "resnet_bf16", "xent_fwd",
                                 "xent_fwd bfloat16 (128, 1000)"),
        "xent_bwd_resnet_bf16": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                                 "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                                 "resnet_bf16", "xent_bwd",
                                 "xent_bwd bfloat16 (128, 1000)"),
        "xent_fwd_lenet": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                           "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                           "lenet", "xent_fwd", "xent_fwd float32 (64, 10)"),
        "xent_bwd_lenet": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                           "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                           "lenet", "xent_bwd", "xent_bwd float32 (64, 10)"),
        "adam_lenet": ("mxnet_tpu_torch/csrc/adam.cu",
                       "mxnet_tpu/ops/pallas_optimizer.py:63", "lenet",
                       "adam", None),
        # the WMT Transformer's shapes: the decoder's causal self-attention
        # at bucket 32 (B=64, H=8, T=32, D=64) in bf16 on the transformer
        # step and in f32 on the example's loop; LayerNorm at
        # transformer_base's (2048, 512) and transformer_big's (2048, 1024)
        # rows; Adam over transformer_base's tensors; the decode step's
        # paged read (their max_abs_err: the checks at their shapes)
        "flash_fwd_transformer_bf16": (
            "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/ops/flash_attention.py:100", "transformer",
            "flash_fwd", "flash_fwd_bf16@64,8,32,32,1"),
        "flash_bwd_dkv_transformer_bf16": (
            "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/ops/flash_attention.py:256", "transformer",
            "flash_bwd_dkv", "flash_bwd_dkv_bf16@64,8,32,32,1"),
        "flash_bwd_dq_transformer_bf16": (
            "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/ops/flash_attention.py:285", "transformer",
            "flash_bwd_dq", "flash_bwd_dq_bf16@64,8,32,32,1"),
        "flash_fwd_transformer": (
            "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/ops/flash_attention.py:100", "transformer_loop",
            "flash_fwd", "flash_fwd@64,8,32,32,1"),
        "flash_bwd_dkv_transformer": (
            "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/ops/flash_attention.py:256", "transformer_loop",
            "flash_bwd_dkv", "flash_bwd_dkv@64,8,32,32,1"),
        "flash_bwd_dq_transformer": (
            "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/ops/flash_attention.py:285", "transformer_loop",
            "flash_bwd_dq", "flash_bwd_dq@64,8,32,32,1"),
        "layernorm_transformer_512": (
            "mxnet_tpu_torch/csrc/layernorm.cu",
            "mxnet_tpu/ops/pallas_layernorm.py:53", "transformer",
            "layernorm", "layernorm_bf16_2048x512"),
        "layernorm_bwd_transformer_512": (
            "mxnet_tpu_torch/csrc/layernorm.cu",
            "mxnet_tpu/ops/pallas_layernorm.py:97", "transformer",
            "layernorm_bwd", "layernorm_bwd_bf16_2048x512"),
        "layernorm_transformer_1024": (
            "mxnet_tpu_torch/csrc/layernorm.cu",
            "mxnet_tpu/ops/pallas_layernorm.py:53", "transformer_big",
            "layernorm", "layernorm_bf16_2048x1024"),
        "layernorm_bwd_transformer_1024": (
            "mxnet_tpu_torch/csrc/layernorm.cu",
            "mxnet_tpu/ops/pallas_layernorm.py:97", "transformer_big",
            "layernorm_bwd", "layernorm_bwd_bf16_2048x1024"),
        "adam_transformer": ("mxnet_tpu_torch/csrc/adam.cu",
                             "mxnet_tpu/ops/pallas_optimizer.py:63",
                             "transformer", "adam", None),
        "paged_attention_transformer": (
            "mxnet_tpu_torch/csrc/paged_attention.cu",
            "mxnet_tpu/ops/pallas_paged_attention.py:79",
            "transformer_decode", "paged_attention",
            "paged_attention_transformer"),
        # the word LM's shapes (Zaremba-medium): the xent pair on the
        # (700, 10000) f32 logits and Adam over its 3 tensors (their
        # max_abs_err: the checks at their shapes)
        "xent_fwd_word_lm": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                             "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                             "word_lm", "xent_fwd",
                             "xent_fwd float32 (700, 10000)"),
        "xent_bwd_word_lm": ("mxnet_tpu_torch/csrc/softmax_xent.cu",
                             "mxnet_tpu/ops/pallas_softmax_xent.py:54",
                             "word_lm", "xent_bwd",
                             "xent_bwd float32 (700, 10000)"),
        "adam_word_lm": ("mxnet_tpu_torch/csrc/adam.cu",
                         "mxnet_tpu/ops/pallas_optimizer.py:63", "word_lm",
                         "adam", None),
        # the SSD's 24 tensors (one timing row): the example's Gluon loop
        # (32x32, B=16, 200 steps) and SSD300's TrainStep (300x300, B=32,
        # 12 graph steps); the max_abs_err: the check at this shape
        "adam_ssd": ("mxnet_tpu_torch/csrc/adam.cu",
                     "mxnet_tpu/ops/pallas_optimizer.py:63", "ssd_example",
                     "adam", None),
        "adam_ssd300": ("mxnet_tpu_torch/csrc/adam.cu",
                        "mxnet_tpu/ops/pallas_optimizer.py:63", "ssd300",
                        "adam", None),
        # the symbolic paths: transformer_base imported from its
        # symbol.json (f32, B=64, bucket 32; its forward's LayerNorm and
        # flash forward, its Trainer("adam") fine-tune's backward kernels
        # and Adam over its tensors), and the bucketing LSTM LM's Adam over
        # its 11 tensors (their max_abs_err: the checks at their shapes)
        "layernorm_symbol": ("mxnet_tpu_torch/csrc/layernorm.cu",
                             "mxnet_tpu/ops/pallas_layernorm.py:53",
                             "symbol", "layernorm", "layernorm_2048x512"),
        "layernorm_bwd_symbol": ("mxnet_tpu_torch/csrc/layernorm.cu",
                                 "mxnet_tpu/ops/pallas_layernorm.py:97",
                                 "symbol_finetune", "layernorm_bwd",
                                 "layernorm_bwd_2048x512"),
        "flash_fwd_symbol": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                             "mxnet_tpu/ops/flash_attention.py:100",
                             "symbol", "flash_fwd", "flash_fwd@64,8,32,32,1"),
        "flash_bwd_dkv_symbol": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                                 "mxnet_tpu/ops/flash_attention.py:256",
                                 "symbol_finetune", "flash_bwd_dkv",
                                 "flash_bwd_dkv@64,8,32,32,1"),
        "flash_bwd_dq_symbol": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                                "mxnet_tpu/ops/flash_attention.py:285",
                                "symbol_finetune", "flash_bwd_dq",
                                "flash_bwd_dq@64,8,32,32,1"),
        "adam_symbol": ("mxnet_tpu_torch/csrc/adam.cu",
                        "mxnet_tpu/ops/pallas_optimizer.py:63",
                        "symbol_finetune", "adam", "adam_transformer"),
        "adam_bucketing_lm": ("mxnet_tpu_torch/csrc/adam.cu",
                              "mxnet_tpu/ops/pallas_optimizer.py:63",
                              "module", "adam", None),
        # the row-sparse paths: the untied word LM's lazy block (one batch's
        # embedding rows) and its other tensors, two launches a step; the
        # lazy block at LM1B's vocabulary, and the dense launch over that
        # whole table it is compared with (its launches: the LM1B lazy
        # run's); their max_abs_err: the checks at their shapes
        "adam_sparse_block": ("mxnet_tpu_torch/csrc/adam.cu",
                              "mxnet_tpu/ops/pallas_optimizer.py:63",
                              "sparse", "adam", None),
        "adam_sparse_rest": ("mxnet_tpu_torch/csrc/adam.cu",
                             "mxnet_tpu/ops/pallas_optimizer.py:63",
                             "sparse", "adam", None),
        "adam_lm1b_block": ("mxnet_tpu_torch/csrc/adam.cu",
                            "mxnet_tpu/ops/pallas_optimizer.py:63",
                            "sparse_lm1b", "adam", None),
        "adam_lm1b": ("mxnet_tpu_torch/csrc/adam.cu",
                      "mxnet_tpu/ops/pallas_optimizer.py:63",
                      "sparse_lm1b", "adam", None),
        # INT8 (no pallas_call site: XLA's int8 conv, lax.conv_general_
        # dilated with preferred_element_type=int32, and the activation's
        # quantisation before it): resnet50_v1's int8 forward at B=32, the
        # product on its wgmma route and the im2col from the f32 activation
        # at res4's 3x3, res5's 3x3, the stem, res2's 3x3 and res3's 1x1;
        # the product's mma.sync route at LeNet's Dense 120 -> 84 (its
        # launches: the quantize_model example's); their max_abs_err: the
        # largest of the checks at INT8_CONV_CASES and INT8_FC_CASES
        **{f"int8_gemm_wgmma{sfx}": (
            "mxnet_tpu_torch/csrc/int8_gemm.cu",
            "mxnet_tpu/contrib/quantization.py:135", "int8",
            "int8_gemm_wgmma", "int8_gemm_wgmma") for sfx in INT8_ROWS},
        "int8_gemm_mma": ("mxnet_tpu_torch/csrc/int8_gemm.cu",
                          "mxnet_tpu/contrib/quantization.py:135",
                          "quantize_model", "int8_gemm_mma", "int8_gemm_mma"),
        **{f"int8_im2col{sfx}": (
            "mxnet_tpu_torch/csrc/int8_gemm.cu",
            "mxnet_tpu/contrib/quantization.py:135", "int8", "int8_im2col",
            "int8_im2col") for sfx in INT8_ROWS},
    }
    errs["adam_bert"] = timing["adam_bert"]["max_abs_err_at_shape"]
    errs["adam_lenet"] = timing["adam_lenet"]["max_abs_err_at_shape"]
    errs["adam_transformer"] = \
        timing["adam_transformer"]["max_abs_err_at_shape"]
    errs["adam_word_lm"] = timing["adam_word_lm"]["max_abs_err_at_shape"]
    errs["adam_ssd"] = errs["adam_ssd300"] = \
        timing["adam_ssd"]["max_abs_err_at_shape"]
    errs["adam_bucketing_lm"] = \
        timing["adam_bucketing_lm"]["max_abs_err_at_shape"]
    for k in sparse_timing:
        errs[k] = timing[k]["max_abs_err_at_shape"]
    by_path = {"serve": serve_launches, "spec": spec_launches,
               "prefix": prefix_launches, "fork": fork_launches,
               "governed": governed_launches, "drill": drill_launches,
               "stall": stall_launches, "overload": overload_launches,
               "fleet": fleet_launches,
               "train": train_launches, "train_amp": amp_launches,
               "gluon": gluon_launches, "train_loop": loop_launches,
               "bert_amp": bert_launches,
               "resnet": vision_launches["resnet"],
               "resnet_bf16": vision_launches["resnet_bf16"],
               "lenet": lenet_launches, "transformer": tf_launches,
               "transformer_big": big_launches,
               "transformer_decode": decode_launches,
               "transformer_loop": tf_loop_launches, "mnist": mnist_launches,
               "nn_ops": nn_launches, "pretrain_bert": pretrain_launches,
               "extra_ops": extra_launches, "word_lm": wlm_launches,
               "word_lm_loop": wlm_loop_launches,
               "ssd_example": ssd_launches, "ssd300": ssd300_launches,
               "estimator": est_launches, "symbol": sym_launches,
               "symbol_finetune": sym_ft_launches, "module": lm_launches,
               "sparse": sparse_launches, "sparse_lm1b": lm1b_launches,
               "int8": int8_launches, "quantize_model": qm_launches,
               "dcgan": dcgan_launches, "generate": gen_launches,
               "imagenet": imagenet_launches}
    kernels = []
    for name, (src, rep, path, *extra) in meta.items():
        t = timing[name]
        # one counter for both dtypes
        counter, err_key = extra or (name.removesuffix("_bf16"), name)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": by_path[path][counter], "launches_path": path,
            "launches_by_path": {p: c.get(counter, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": errs[err_key or name],
            "max_abs_err_rounded": errs.get(name + "_rounded"),
            "max_abs_err_tight": errs.get(name + "_tight"),
            "max_abs_err_f64": errs.get(name + "_f64"),
            "plain_max_abs_err_f64": errs.get(name + "_plain_f64"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_peak": t["bound_peak"],
            "bound_cuda_cores_ms": t.get("bound_cuda_cores_ms"),
            "library_ms": t["library_ms"], "shape": t["shape"],
            "eager_ms": t["eager_ms"], "plain_eager_ms": t["plain_eager_ms"],
            "library_eager_ms": t["library_eager_ms"],
            "library": t.get("library"), "note": t.get("note")})
    log(f"[done] {time.perf_counter() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
