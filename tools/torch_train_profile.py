#!/usr/bin/env python3
"""Where the time of one PyTorch/CUDA training or decode step goes, on one
card.

    python3 tools/torch_train_profile.py [--layers 24] [--steps 3] [--amp bfloat16]
    python3 tools/torch_train_profile.py --decode [--steps 20]
    python3 tools/torch_train_profile.py --spec [--steps 20]
    python3 tools/torch_train_profile.py --model bert_large [--layers 24]
    python3 tools/torch_train_profile.py --model resnet50_v1 [--amp bfloat16]
    python3 tools/torch_train_profile.py --gluon [--layers 24]
    python3 tools/torch_train_profile.py ... --engine-type naive graph graph naive
    python3 tools/torch_train_profile.py --amp bfloat16 --window 8 [--accum 2]

Trains gpt2_345m (``mxnet_tpu_torch``, B=4, T=1024, seeded random weights
and batch, as ``chip_smoke.py``) for two warm-up steps: in f32 with
``lm_loss`` and Adam 1e-4 (the ``train`` phase), or with ``--amp bfloat16``
through ``TrainStep(net, SoftmaxCrossEntropyLoss(), Adam(lr_scheduler=...),
amp="bfloat16")`` on chip_smoke.py's warm-up schedule (the ``train_amp``
phase). With ``--model bert_large`` it trains chip_smoke.py's ``bert_amp``
step instead: ``get_bert("bert_large", max_length=128)``, bench.py's batch
(B=64, T=128, 20 masked positions), ``TrainStep(net, bert_loss, Adam(1e-4),
n_model_inputs=4, amp="bfloat16")``. With ``--model resnet50_v1`` it trains
chip_smoke.py's ``resnet`` step: resnet50_v1 (224x224, 1000 classes,
MSRAPrelu, seed 0), ``TrainStep(net, SoftmaxCrossEntropyLoss(),
SGD(learning_rate=0.1, momentum=0.9, wd=1e-4))`` on the example's synthetic
batch, in f32 at B=64, or with ``--amp bfloat16`` after
``net.cast("bfloat16")`` at B=128 (``--batch`` sets another); after the
step's profile it times the step's parts apart, each as one CUDA graph at
the step's shapes: every convolution's forward and gradients, every
BatchNorm composition's forward, backward and moving-statistic update,
the SGD update of all parameters, the loss forward and backward, and
reads the rest (ReLU, the residual adds, pooling, the dense layer, casts)
off the step's device time; then it times the convolutions and the step
graph again with cuDNN's deterministic algorithms off (``ops/nn.py``
``DETERMINISTIC``), the cost of the port's graph == naive rule. With ``--gluon`` it trains through
the imperative surface instead, chip_smoke.py's ``gluon`` step:
``net.cast("bfloat16")``, ``gluon.Trainer(..., "adam", {"learning_rate":
1e-4, "multi_precision": True})``, then ``autograd.record()``,
``loss.backward()`` and ``trainer.step(4)`` on the same batch, eager
(``--engine-type`` does not apply). With ``--model bert_large`` it then
also profiles one encoder
layer's masked attention (``multi_head_attention`` with the (B, 1, 1, T)
mask, forward and backward at bf16, one CUDA graph) and prints its device
time by group times the layer count, the share of the step's groups
(matmul, softmax, elementwise, copies) that the attention takes. With
``--decode`` it instead fills chip_smoke.py's serving engine
(gpt2_345m f32, batch 8, page size 16) with 8 prompts of 500 tokens and
takes decode steps (``GenerationEngine.decode_step``, B=8, 500-560 cached
keys a row); with ``--spec`` the same engine drafts with chip_smoke.py's
gpt2_117m (seed 1, k 4) and takes speculative rounds
(``GenerationEngine.spec_step``: a draft and a verify program). It then
times ``--steps`` steps untraced and ``--steps`` more traced by
``torch.profiler``, and prints the card's name and power limit,
the wall time per step of each, the device time per step summed over
kernels (one stream, so kernels do not overlap), the idle share (1 -
device time / wall time) against each wall time (the profiler adds host
time to every op) and the device time per kernel group and per kernel.
``--engine-type`` runs the steps as the port's captured step graphs
("graph", the default) or eagerly ("naive"); given several values, it
profiles each in turn in the same process, on the same net (a new engine
or TrainStep for each), so that the two can be compared on one card.

    python3 tools/torch_train_profile.py --memory [--amp bfloat16] ...

With ``--window K`` it profiles the training loop instead: the same
TrainStep driven by ``TrainStep.run`` over a ``DevicePrefetcher`` of the
fixed batch, one window program of K steps a call (``--accum A``: A
microbatches of B=4/A a step, the same tokens a step), and, first, the
one-step program of the same TrainStep settings beside it; every number
is per step (a window's over K).

With ``--memory`` it profiles nothing: after each of the first ``--steps``
calls it prints the bytes allocated and reserved, their peaks in that call,
and the reserved bytes by memory pool (the ordinary pool, or a graph's
private pool) and stream, from ``torch.cuda.memory_snapshot()``. Under
"graph" it records the allocator's history through the first two calls
(the warm-up and the capture) and prints what it did: new segments, the
frees whose memory came back late, and the blocks still allocated on a
side stream, with where they were allocated.
Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

GROUPS = (  # (group, substrings of the kernel name), first match wins
    # cuDNN's convolution kernels (forward, input and weight gradients) and
    # the layout transposes around them
    ("convolution", ("convolve", "conv2d", "Conv", "fprop", "dgrad", "wgrad",
                     "implicit_gemm", "winograd", "cudnn")),
    ("layout transpose", ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc",
                          "nhwc2nchw")),
    ("pooling", ("max_pool", "avg_pool", "MaxPool", "AvgPool")),
    ("flash forward", ("flash_fwd_",)),  # the f32 and the bf16 kernel
    ("paged attention", ("paged_attention_kernel", "paged_prefill_tc_kernel")),
    ("flash dK/dV", ("flash_bwd_dkv_",)),  # the f32 and the bf16 kernel
    ("flash dQ", ("flash_bwd_dq_",)),
    ("adam", ("adam_kernel",)),
    ("softmax xent forward", ("xent_fwd_kernel",)),
    ("softmax xent backward", ("xent_bwd_kernel",)),
    ("layernorm forward", ("layernorm_fwd_",)),  # warp and block routes
    # the backward kernels (row kernel, merge of the column sums); the
    # plain backward's chain falls in the groups below
    ("layernorm backward", ("layernorm_bwd_",)),
    ("matmul", ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "splitK",
                "nvjet")),
    ("softmax / log-softmax", ("softmax", "Softmax")),
    ("reduction", ("reduce", "Reduce")),
    ("copy / cast / fill", ("copy", "Copy", "fill", "Fill", "Memcpy",
                            "Memset")),
)


def group_of(kernel_name):
    """The group of GROUPS a device kernel's name falls in."""
    return next((g for g, keys in GROUPS
                 if any(k in kernel_name for k in keys)), "other elementwise")


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--amp", choices=("bfloat16",), default=None)
    ap.add_argument("--model", choices=("gpt2_345m", "bert_large",
                                        "resnet50_v1"),
                    default="gpt2_345m",
                    help="bert_large: chip_smoke.py's bert_amp step "
                         "(always amp bfloat16); resnet50_v1: its resnet "
                         "step (--amp bfloat16: the bf16-cast turn)")
    ap.add_argument("--batch", type=int, default=None,
                    help="resnet50_v1: images a step (default 64 in f32, "
                         "128 in bf16, chip_smoke.py's)")
    ap.add_argument("--decode", action="store_true",
                    help="profile serving decode steps instead of training")
    ap.add_argument("--spec", action="store_true",
                    help="profile speculative rounds (gpt2_117m draft)")
    ap.add_argument("--gluon", action="store_true",
                    help="profile the imperative Gluon step (bf16 weights, "
                         "multi_precision Adam)")
    ap.add_argument("--memory", action="store_true",
                    help="report memory per call instead of profiling")
    ap.add_argument("--window", type=int, default=None,
                    help="profile TrainStep.run windows of this many steps "
                         "(and the one-step program beside them)")
    ap.add_argument("--accum", type=int, default=1, choices=(1, 2, 4),
                    help="with --window: microbatches a step")
    ap.add_argument("--engine-type", nargs="+", default=["graph"],
                    choices=("naive", "graph"),
                    help="step graphs or eager steps; several: in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_profile: CUDA is not available")
    if args.model != "gpt2_345m" and (args.decode or args.spec):
        ap.error("--decode and --spec serve GPT-2 only")
    if args.model == "resnet50_v1" and args.memory:
        ap.error("--memory profiles GPT-2 and BERT only")
    if args.gluon and (args.decode or args.spec or args.amp or
                       args.model != "gpt2_345m" or
                       args.engine_type != ["graph"]):
        ap.error("--gluon trains GPT-2 eagerly in bf16: no other mode")
    if args.window and (args.decode or args.spec or args.gluon or
                        args.memory or args.model != "gpt2_345m"):
        ap.error("--window profiles GPT-2 TrainStep windows only")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from mxnet_tpu_torch.models import get_bert, get_gpt2

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    if args.model == "bert_large":
        net = get_bert("bert_large", max_length=128, dropout=0.0,
                       device="cuda", seed=0, num_layers=args.layers)
    elif args.model == "resnet50_v1":
        import chip_smoke as cs

        torch.backends.cudnn.allow_tf32 = False
        dtype = args.amp or "float32"
        batch = args.batch or dict(cs.RESNET_TURNS)[dtype]
        built = cs._resnet_net(dtype, batch)  # (net, init, batch, flops)
        for engine_type in args.engine_type:
            _profile(args, built, engine_type, card)
            torch.cuda.empty_cache()
        _resnet_parts(args, built, card)
        return
    else:
        net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0,
                       num_layers=args.layers)
    for engine_type in args.engine_type:
        if args.window:  # the one-step program first, then the window's
            _profile(args, net, engine_type, card)
            torch.cuda.empty_cache()
            _profile(args, net, engine_type, card, window=args.window)
        else:
            (_memory if args.memory else _profile)(args, net, engine_type,
                                                   card)
        torch.cuda.empty_cache()
    if args.model == "bert_large" and not args.memory:
        _attention_profile(args, card)


def _profile(args, net, engine_type, card, window=None):
    """``args.steps`` calls of the step (or, with ``window``, of a window
    program: ``window`` steps a call), untraced and then traced; reported
    per step."""
    if window:
        step, what = _window_step(args, net, engine_type, window)
    else:
        step, what = _step(args, net, engine_type)
    per = window or 1
    # under "graph" the first call warms up and the second captures
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    # the same steps untraced: the profiler adds host time to every op, so
    # the idle share is read against this wall time too
    t = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t) / (args.steps * per)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / (args.steps * per)
    _report(card, what, args.steps * per, prof, wall, plain_wall)


GIB = float(2 ** 30)


def _memory(args, net, engine_type, card):
    step, what = _step(args, net, engine_type)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(card)
    print(f"[memory] {what}: before the first call allocated "
          f"{torch.cuda.memory_allocated() / GIB:.4f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / GIB:.4f}")
    for i in range(args.steps):
        torch.cuda.reset_peak_memory_stats()
        history = engine_type == "graph" and i == 1
        if engine_type == "graph" and i == 0:  # through the capture
            torch.cuda.memory._record_memory_history(
                max_entries=1_000_000, context="alloc", stacks="python")
        step()
        torch.cuda.synchronize()
        if history:
            snap = torch.cuda.memory._snapshot()
            _live_side_blocks(snap)
            torch.cuda.memory._record_memory_history(enabled=None)
        print(f"[memory] call {i}: allocated "
              f"{torch.cuda.memory_allocated() / GIB:.4f} GiB (peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.4f}), reserved "
              f"{torch.cuda.memory_reserved() / GIB:.4f} (peak "
              f"{torch.cuda.max_memory_reserved() / GIB:.4f})")
        _pools()
        if history:
            _history(snap)


def _pools():
    """Reserved and allocated bytes by (memory pool, stream)."""
    pools = collections.defaultdict(lambda: [0, 0, 0])
    for seg in torch.cuda.memory_snapshot():
        key = (tuple(seg.get("segment_pool_id", (0, 0))), seg["stream"])
        pools[key][0] += seg["total_size"]
        pools[key][1] += seg["allocated_size"]
        pools[key][2] += 1
    for (pool, stream), (total, used, n) in sorted(pools.items()):
        kind = "ordinary" if pool == (0, 0) else f"graph {pool}"
        print(f"    pool {kind}, stream {stream:#x}: reserved "
              f"{total / GIB:.4f} GiB in {n} segments, allocated "
              f"{used / GIB:.4f}")


def _live_side_blocks(snap):
    """The blocks still allocated in the ordinary pool on a side stream,
    with where they were allocated."""
    for seg in snap["segments"]:
        if seg["stream"] == 0 or tuple(seg.get("segment_pool_id",
                                                 (0, 0))) != (0, 0):
            continue
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            where = " < ".join(f"{f['filename'].split('/')[-1]}:{f['line']} "
                               f"{f['name']}"
                               for f in (blk.get("frames") or [])[:5])
            print(f"      live {blk['size'] / 2**20:.2f} MiB in a "
                  f"{seg['total_size'] / 2**20:.1f} MiB segment, stream "
                  f"{seg['stream']:#x}: {where or '(no frames)'}")


def _history(snap):
    """What the allocator did since the history began (the warm-up and the
    capture): new and released segments
    by pool, and frees whose memory came back only later (a block used on
    a second stream: freed for reuse only once no capture runs)."""
    segs = collections.Counter()
    pending, late, frames = {}, [], {}
    for trace in snap["device_traces"]:
        for k, ev in enumerate(trace):
            act, addr = ev["action"], ev.get("addr")
            if act in ("segment_alloc", "segment_free", "segment_map",
                       "segment_unmap"):
                segs[act] += ev["size"]
            elif act == "alloc":
                frames[addr] = ev.get("frames") or []
            elif act == "free_requested":
                pending[addr] = (k, ev["size"], ev["stream"])
            elif act == "free_completed" and addr in pending:
                k0, size, stream = pending.pop(addr)
                if k > k0 + 1:
                    late.append((size, stream, frames.get(addr, [])))
    print(f"    history of the warm-up and the capture: "
          f"{ {a: round(b / GIB, 4) for a, b in segs.items()} } GiB; "
          f"{len(late)} frees completed late, "
          f"{sum(x[0] for x in late) / GIB:.4f} GiB; "
          f"{len(pending)} never completed, "
          f"{sum(x[1] for x in pending.values()) / GIB:.4f} GiB")
    for size, stream, fr in sorted(late, key=lambda x: -x[0])[:8]:
        where = " < ".join(f"{f['filename'].split('/')[-1]}:{f['line']} "
                           f"{f['name']}" for f in fr[:4])
        print(f"      {size / 2**20:.1f} MiB, stream {stream:#x}: {where}")


def _step(args, net, engine_type):
    """The step to run, as a closure, and its description."""
    rs = np.random.RandomState(0)
    if args.decode or args.spec:
        from mxnet_tpu_torch.inference import GenerationEngine
        from mxnet_tpu_torch.models import get_gpt2

        spec = dict(draft_net=get_gpt2("gpt2_117m", dropout=0.0,
                                       device="cuda", seed=1),
                    speculate_k=4) if args.spec else {}
        eng = GenerationEngine(net, batch_size=8, max_length=1024, paged=True,
                               page_size=16, eos_id=None, device="cuda",
                               engine_type=engine_type, **spec)
        for slot in range(8):
            eng.prefill(rs.randint(0, 50257, 500), slot)
        step = eng.spec_step if args.spec else eng.decode_step
        mode = "speculative rounds (gpt2_117m draft, k 4)" if args.spec \
            else "decode"
        what = (f"gpt2_345m layers={args.layers} f32 {mode} B=8, paged "
                f"(ps 16), 500 prompt tokens a row, engine_type "
                f"{engine_type}")
    elif args.gluon:
        import chip_smoke as cs
        import mxnet_tpu_torch as mx

        net.cast("bfloat16")
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-4,
                                    "multi_precision": True})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        ids, labels = cs._train_batch(4, 1024)
        x, y = mx.nd.array(ids), mx.nd.array(labels)
        step = lambda: cs._gluon_step(mx, net, trainer, loss_fn, x, y)  # noqa: E731
        what = (f"gpt2_345m layers={args.layers} B=4 T=1024 bfloat16 "
                f"weights, multi_precision Adam, record/backward/"
                f"Trainer.step (eager)")
    elif args.model == "resnet50_v1":
        import chip_smoke as cs

        net, init, batch, flops = net  # chip_smoke._resnet_net's
        cs._restore(net, init)
        ts = cs._resnet_step(net, engine_type)
        step = lambda: ts(*batch)  # noqa: E731
        what = (f"resnet50_v1 {args.amp or 'float32'} B={batch[0].shape[0]} "
                f"224x224, SGD, engine_type {engine_type} "
                f"({flops / 1e12:.4f} TFLOP a step)")
    elif args.model == "bert_large":
        import chip_smoke as cs

        ts = cs._bert_step(net, engine_type)
        batch = cs._bert_batch(cs.BERT_B, cs.BERT_T, cs.BERT_M)
        step = lambda: ts(*batch)  # noqa: E731
        what = (f"bert_large layers={args.layers} B={cs.BERT_B} "
                f"T={cs.BERT_T} M={cs.BERT_M} bfloat16 (bert_amp), "
                f"engine_type {engine_type}")
    else:
        step = _train_step(args, net, rs, engine_type)
        what = (f"gpt2_345m layers={args.layers} B=4 T=1024 "
                f"{args.amp or 'f32'}, engine_type {engine_type}")
    return step, what


def _attention_profile(args, card, b=64, h=16, t=128, d=64):
    """One encoder layer's masked attention at bert_amp's shapes (bf16 q,
    k, v from the (B, T, 3C) projection, the all-true (B, 1, 1, T) mask of
    valid_length = T), forward and backward, captured in one CUDA graph and
    replayed under the profiler: device ms by group, and times the layer
    count, the part of a bert_amp step it takes."""
    from mxnet_tpu_torch.ops.attention import multi_head_attention

    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, t, 3, h, d, generator=gen).to(
        "cuda", torch.bfloat16).requires_grad_()
    mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device="cuda")
    cot = torch.randn(b, h, t, d, generator=gen).to("cuda", torch.bfloat16)

    def fwd_bwd():
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = multi_head_attention(q, k, v, mask=mask)
        torch.autograd.grad(out, qkv, cot)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fwd_bwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fwd_bwd()
    graph.replay()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            graph.replay()
        torch.cuda.synchronize()
    _report(card, f"masked attention of one layer, B={b} H={h} T={t} D={d} "
            f"bf16, forward + backward (one CUDA graph); x{args.layers} "
            f"layers", args.steps, prof, None, None, scale=args.layers)


def _resnet_parts(args, built, card):
    """The parts of a resnet50_v1 step timed apart at its shapes, each one
    CUDA graph replayed between CUDA events (chip_smoke.graph_time_ms):
    every convolution's forward with its input and weight gradients (the
    first one's weight gradient only), every BatchNorm composition's
    forward and backward with the moving-statistic update, the SGD update
    of every parameter (TrainStep's own call of it), the loss's forward
    and backward; and the step's device time, graph replay, beside
    them."""
    import chip_smoke as cs
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv
    from mxnet_tpu_torch.ops import nn as tnn

    net, init, (x, y), _ = built
    cs._restore(net, init)
    seen = []

    def hook(mod, inp, out):
        seen.append((mod, inp[0].shape, inp[0].dtype))

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (_Conv, BatchNorm))]
    import mxnet_tpu_torch as mx

    with torch.no_grad():
        logits = net(mx.nd.array(x))._data
    for h in handles:
        h.remove()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    convs, bns = [], []
    for i, (mod, shape, dtype) in enumerate(seen):
        xin = rand(shape, dtype)
        if isinstance(mod, _Conv):
            w = mod._parameters["weight"].detach().clone().requires_grad_()
            kw = dict(stride=mod._strides, pad=mod._padding,
                      dilate=mod._dilation, num_group=mod._groups)
            leaves = (w,) if not convs else (xin.requires_grad_(), w)
            out_shape = tnn.convolution(xin.detach(), w.detach(), **kw).shape
            convs.append((xin, w, kw, leaves, rand(out_shape, dtype)))
        else:
            c = shape[1]
            gamma = torch.ones(c, device="cuda", requires_grad=True)
            beta = torch.zeros(c, device="cuda", requires_grad=True)
            stats = torch.zeros(c, device="cuda"), torch.ones(c,
                                                              device="cuda")
            bns.append((xin.requires_grad_(), gamma, beta, stats,
                        rand(shape, dtype)))

    def conv_part():
        for xin, w, kw, leaves, g in convs:
            torch.autograd.grad(tnn.convolution(xin, w, **kw), leaves, g)

    def bn_part():
        for xin, gamma, beta, (rm, rv), g in bns:
            out, mean, var = tnn.batch_norm(xin, gamma, beta, rm, rv,
                                            training=True)
            torch.autograd.grad(out, (xin, gamma, beta), g)
            with torch.no_grad():
                rm.copy_(0.9 * rm + (1 - 0.9) * mean)
                rv.copy_(0.9 * rv + (1 - 0.9) * var)

    ts = cs._resnet_step(net, "naive")
    train = ts._train
    weights = [ts._master.get(n, p.detach()) for _, n, p in train]
    lows = [p.detach() if n in ts._master else None for _, n, p in train]
    grads = [torch.randn_like(p) * 1e-3 for _, _, p in train]
    states = [ts.opt_state[n].clone() for _, n, _ in train]
    lr = torch.full((len(train),), 1e-6, device="cuda")
    wd = torch.full((len(train),), 1e-4, device="cuda")
    t2 = torch.ones((), dtype=torch.int32, device="cuda")

    def sgd_part():
        ts.optimizer.update_raw_multi(weights, grads, states, lr, wd, t2,
                                      out_lows=lows)

    head = logits.detach().clone().requires_grad_()
    loss_fn = SoftmaxCrossEntropyLoss()

    def loss_part():
        torch.autograd.grad(loss_fn(head, y).float().mean(), head)

    step_ts = cs._resnet_step(net, "graph")
    for _ in range(2):
        step_ts(x, y)
    (prog, _, _), = step_ts._programs.values()
    parts = {
        f"convolutions ({len(convs)}), forward + gradients":
            cs.graph_time_ms(conv_part, calls=1, replays=3, repeats=3),
        f"BatchNorm compositions ({len(bns)}), forward + backward + "
        f"statistics": cs.graph_time_ms(bn_part, calls=1, replays=3,
                                        repeats=3),
        f"SGD update ({len(train)} parameters)":
            cs.graph_time_ms(sgd_part, calls=1, replays=3, repeats=3),
        "SoftmaxCrossEntropyLoss forward + backward":
            cs.graph_time_ms(loss_part, calls=1, replays=3, repeats=3)}
    # a replay is one launch: timed by CUDA events around eager replays
    step_ms = cs.cuda_time_ms(prog.graph.replay, warmup=1, iters=3,
                              repeats=3)
    # what cuDNN's deterministic algorithms cost: the convolutions and the
    # step captured anew with them off, then the first step graph again
    tnn.DETERMINISTIC = False
    try:
        free_conv_ms = cs.graph_time_ms(conv_part, calls=1, replays=3,
                                        repeats=3)
        cs._restore(net, init)
        free_ts = cs._resnet_step(net, "graph")
        for _ in range(2):
            free_ts(x, y)
        (free_prog, _, _), = free_ts._programs.values()
        free_ms = cs.cuda_time_ms(free_prog.graph.replay, warmup=1, iters=3,
                                  repeats=3)
    finally:
        tnn.DETERMINISTIC = True
    again_ms = cs.cuda_time_ms(prog.graph.replay, warmup=1, iters=3,
                               repeats=3)
    cs._restore(net, init)
    print(card)
    print(f"resnet50_v1 {args.amp or 'float32'} B={x.shape[0]}: the step's "
          f"parts timed apart (device ms, CUDA graph replay)")
    for name, ms in parts.items():
        print(f"  {ms:9.3f}  {100 * ms / step_ms:5.1f}%  {name}")
    rest = step_ms - sum(parts.values())
    print(f"  {rest:9.3f}  {100 * rest / step_ms:5.1f}%  the rest (ReLU, "
          f"residual adds, pooling, the dense layer, casts), by difference")
    print(f"  {step_ms:9.3f}  100.0%  the step graph's replay")
    conv_ms = next(ms for name, ms in parts.items()
                   if name.startswith("convolutions"))
    print(f"cudnn.deterministic on / off / on (device ms, CUDA graph "
          f"replay): step {step_ms:.3f} / {free_ms:.3f} / {again_ms:.3f}, "
          f"convolutions {conv_ms:.3f} / {free_conv_ms:.3f}")


def _make_train_step(args, net, engine_type):
    """chip_smoke.py's ``train`` (f32) or ``train_amp`` TrainStep."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler
    from mxnet_tpu_torch.models import lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    if args.amp is None:
        return TrainStep(net, lm_loss, Adam(learning_rate=1e-4), amp=None,
                         engine_type=engine_type)
    # chip_smoke.py's amp_schedule()
    return TrainStep(net, SoftmaxCrossEntropyLoss(), Adam(
        learning_rate=1e-4, lr_scheduler=CosineScheduler(
            max_update=1000, base_lr=1e-4, warmup_steps=4,
            warmup_begin_lr=1e-5)),
        amp=args.amp, engine_type=engine_type)


def _window_step(args, net, engine_type, window):
    """One ``TrainStep.run`` window of ``window`` steps over a prefetcher
    of the fixed batch (``args.accum`` microbatches a step), as a
    closure."""
    import itertools

    from mxnet_tpu_torch.io.prefetch import DevicePrefetcher

    ts = _make_train_step(args, net, engine_type)
    micro = 4 // args.accum
    ids = np.random.RandomState(0).randint(0, 50257, (micro, 1024)).astype(
        np.int32)
    pf = DevicePrefetcher(itertools.repeat((ids, np.roll(ids, -1, 1))),
                          train_step=ts, window=window, accum=args.accum)
    what = (f"gpt2_345m layers={args.layers} {args.amp or 'f32'}, "
            f"TrainStep.run windows of {window} steps, accum {args.accum} "
            f"at B={micro} T=1024, engine_type {engine_type}; per step")
    return (lambda: ts.run(pf, steps=window)), what


def _train_step(args, net, rs, engine_type):
    """One TrainStep call on chip_smoke.py's fixed batch, as a closure."""
    ts = _make_train_step(args, net, engine_type)
    ids_np = rs.randint(0, 50257, (4, 1024))
    ids = torch.from_numpy(ids_np.astype(np.int32)).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, 1).astype(np.int32)).cuda()
    return lambda: ts(ids, labels)


def _report(card, what, steps, prof, wall, plain_wall, scale=1):
    """Device time by kernel group and by kernel, per step; ``wall`` None
    reports no idle share. ``scale`` multiplies every time (a per-layer
    profile read as the whole model's)."""
    kernels = collections.Counter()
    calls = collections.Counter()
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += scale * us / steps
            calls[evt.key] += scale * evt.count / steps
    busy = sum(kernels.values()) / 1e3
    print(card)
    print(f"{what}, {steps} traced steps under the profiler")
    if wall is None:
        print(f"device {busy:.3f} ms/step")
    else:
        print(f"wall {wall * 1e3:.2f} ms/step traced, {plain_wall * 1e3:.2f} "
              f"untraced; device {busy:.2f} ms/step; idle share "
              f"{1 - busy / (wall * 1e3):.3f} traced, "
              f"{1 - busy / (plain_wall * 1e3):.3f} untraced")
    if not kernels:
        print("the profiler recorded no device time: not measured")
        return
    groups = collections.Counter()
    for name, us in kernels.items():
        groups[group_of(name)] += us
    print("device ms per step by group:")
    for g, us in groups.most_common():
        print(f"  {us / 1e3:9.3f}  {100 * us / 1e3 / busy:5.1f}%  {g}")
    print("top kernels (device ms per step, launches per step):")
    for name, us in kernels.most_common(25):
        print(f"  {us / 1e3:9.3f}  {calls[name]:7.1f}  {name[:110]}")


if __name__ == "__main__":
    main()
