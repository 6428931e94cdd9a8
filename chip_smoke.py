#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure (so the script exits non-zero and never
prints its last line):

  1. build the CUDA kernels from ``mxnet_tpu_torch/csrc/`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes the serving and training paths give it (flash forward and
     lse, dK/dV, dQ, multi-tensor Adam, and LayerNorm's gradients through
     its autograd Function);
  3. check that dense-cache and paged-cache logits are bit-identical
     through a small GPT-2 (2 layers at gpt2_345m width), and that they
     agree with the same engine run on the kernels' plain versions;
  4. training parity: 3 TrainStep steps of a 2-layer GPT-2 at gpt2_345m
     width with every kernel knob on, then off (the plain versions), with
     the same seeded weights; per-step losses and final weights agree;
  5. serve 16 requests through the paged engine and the continuous
     batcher with gpt2_345m at full width (seeded random weights, f32),
     with both serving kernels' launch counts read around that run;
  6. train gpt2_345m at full width (B=4, T=1024, f32, Adam) through
     TrainStep: 2 warm-up and 10 timed steps, with the launch counts of
     every kernel read around each step;
  7. time each kernel, its plain version and a PyTorch library yardstick
     with CUDA events, on the device (CUDA graph replay) and per eager
     call, at the shapes the two paths give them;
  8. print the kernel table as one JSON line, then the result line.

It needs one CUDA card and imports nothing of JAX or ``mxnet_tpu``.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # CUDA cores; the kernels use no tensor cores
N_LAYERS = 24  # gpt2_345m

# Tolerances, |kernel - plain| <= atol + rtol * |plain|. f32: only the order
# of the f32 sums differs. bf16: the plain version rounds scores and
# weights to bf16 where the kernel keeps f32. LayerNorm's are those of
# tests/test_pallas_layernorm.py.
TOL = {
    ("paged_attention", torch.float32): 1e-5,
    ("paged_attention", torch.bfloat16): 2e-2,
    ("layernorm", torch.float32): 2e-5,
    ("layernorm", torch.bfloat16): 3e-2,
    # flash: tests/test_flash_attention.py's forward (2e-4 / 3e-2) and
    # backward (2e-3) tolerances. Kernel and plain version both keep f32
    # scores and sums and differ in sum order only; in bf16 both round the
    # same f32 result once, so they differ by at most a bf16 ulp or two.
    ("flash_fwd", torch.float32): 2e-4,
    ("flash_fwd", torch.bfloat16): 3e-2,
    ("flash_bwd", torch.float32): 2e-3,
    ("flash_bwd", torch.bfloat16): 3e-2,
    # LayerNorm gradients: the analytic backward under the kernel's forward
    # against autograd through the plain composition; f32 sums of up to 512
    # rows in another order (rtol 1e-4 as tests/test_pallas_layernorm.py)
    ("layernorm_grad", torch.float32): 1e-4,
    ("layernorm_grad", torch.bfloat16): 3e-2,
}
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
TRAIN_LOSS_RTOL = 1e-4
# Logits of the engine on the kernels against the same engine on their plain
# versions, f32, 2 layers: the f32 sums differ in order only (the
# tolerance of the port's CPU tests against the JAX package).
LOGIT_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


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


def check_close(name, dtype, got, want, what):
    tol = TOL[(name, dtype)]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {what}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    log(f"  {name} {what}: max_abs_err={err.max().item():.3e} "
        f"(atol=rtol={tol})")
    if bad.any():
        raise AssertionError(f"{name} {what}: {int(bad.sum())} elements "
                             f"outside tolerance {tol}")
    return err.max().item()


# ---------------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.ops import cuda_common

    t0 = time.perf_counter()
    libs = cuda_common.build()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s (sm_90a)")
    for name, path in libs.items():
        log_path = path.with_suffix(".log")
        for line in (log_path.read_text().splitlines()
                     if log_path.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def _paged_case(gen, b, h, tq, ch, ps, n_pages, pool_pages, dtype, trash_row,
                dev):
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
                             dtype=torch.int32).to(dev)
    q = randn(b, h, tq, ch).to(dtype)
    return q, k_pool, v_pool, table, position


def phase_kernels():
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    errs = {"paged_attention": 0.0, "layernorm": 0.0, "flash_fwd": 0.0,
            "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0, "adam": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for tq in (1, 128):
            for ps in (16, 6):
                n_pages = -(-1024 // ps)
                case = _paged_case(gen, 8, 16, tq, 64, ps, n_pages,
                                   8 * n_pages // 2, dtype, True, dev)
                got = pa.paged_attention_read(*case)
                want = pa.paged_attention_read_plain(*case)
                torch.cuda.synchronize()
                errs["paged_attention"] = max(errs["paged_attention"], check_close(
                    "paged_attention", dtype, got, want,
                    f"{str(dtype)[6:]} tq={tq} ps={ps} (row 0 all trash)"))
        for rows in (8, 512):
            x = torch.randn(rows, 1024, generator=gen).to(dev, dtype)
            g = (1 + 0.1 * torch.randn(1024, generator=gen)).to(dev, dtype)
            b = (0.1 * torch.randn(1024, generator=gen)).to(dev, dtype)
            got = ln.layer_norm(x, g, b)
            want = ln.layer_norm_plain(x, g, b)
            torch.cuda.synchronize()
            errs["layernorm"] = max(errs["layernorm"], check_close(
                "layernorm", dtype, got, want,
                f"{str(dtype)[6:]} ({rows}, 1024)"))
    phase_layernorm_grads(errs)
    phase_flash_kernels(errs)
    phase_adam_kernel(errs)
    return errs


def _flash_inputs(gen, b, h, tq, tk, d, dtype, dev, scale=1.0):
    def randn(*shape):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    return randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)


# (B, H, Tq, Tk, causal): the training shape both ways, cross lengths with
# rows that see no key (Tq > Tk), and a ragged length
FLASH_CASES = [(4, 16, 1024, 1024, True), (4, 16, 1024, 1024, False),
               (1, 16, 128, 384, True), (1, 16, 384, 128, True),
               (2, 8, 320, 320, True)]


def phase_flash_kernels(errs):
    """Flash forward + lse, dK/dV and dQ against their plain versions, f32
    and bf16, head dims 64 and 128."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for d in (64, 128):
            for b, h, tq, tk, causal in FLASH_CASES:
                what = f"{dn} d={d} B={b} H={h} Tq={tq} Tk={tk} causal={causal}"
                q, k, v = _flash_inputs(gen, b, h, tq, tk, d, dtype, dev)
                out, lse = fa._flash_fwd(q, k, v, causal, return_lse=True)
                ref, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
                torch.cuda.synchronize()
                e = check_close("flash_fwd", dtype, out, ref, f"out {what}")
                e = max(e, check_close("flash_fwd", dtype, lse, ref_lse,
                                       f"lse {what}"))
                errs["flash_fwd"] = max(errs["flash_fwd"], e)
                do = torch.randn(b, h, tq, d, generator=gen).to(dev, dtype)
                di = fa._row_dot(do, out).contiguous()
                dk, dv = fa._bwd_dkv(q, k, v, do, lse, di, causal)
                dq = fa._bwd_dq(q, k, v, do, lse, di, causal)
                rdk, rdv = fa._flash_bwd_dkv_plain(q, k, v, do, lse, di, causal)
                rdq = fa._flash_bwd_dq_plain(q, k, v, do, lse, di, causal)
                torch.cuda.synchronize()
                errs["flash_bwd_dkv"] = max(
                    errs["flash_bwd_dkv"],
                    check_close("flash_bwd", dtype, dk, rdk, f"dk {what}"),
                    check_close("flash_bwd", dtype, dv, rdv, f"dv {what}"))
                errs["flash_bwd_dq"] = max(
                    errs["flash_bwd_dq"],
                    check_close("flash_bwd", dtype, dq, rdq, f"dq {what}"))


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


def phase_layernorm_grads(errs):
    """LayerNorm gradients through the autograd Function (kernel forward,
    analytic backward) against autograd through the plain composition."""
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
         "flash_pallas_bwd", "fused_adam")


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


def phase_dense_equals_paged():
    """2 layers at gpt2_345m width: the dense and the paged engine give
    bit-identical logits, and both agree with the same paged engine run on
    the plain versions (the reference) within LOGIT_TOL."""
    from mxnet_tpu_torch.inference import GenerationEngine
    from mxnet_tpu_torch.models import get_gpt2

    net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2, max_length=256,
                   device="cuda", seed=1)
    kw = dict(batch_size=2, eos_id=None, device="cuda")
    dense = GenerationEngine(net, paged=False, **kw)
    paged = GenerationEngine(net, paged=True, page_size=16, **kw)
    plain = GenerationEngine(net, paged=True, page_size=16, **kw)
    worst = 0.0

    def against_plain(what, logits, ref):
        nonlocal worst
        err = (logits - ref).abs().max().item()
        worst = max(worst, err)
        if not torch.isfinite(logits).all() or err > LOGIT_TOL:
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
    log(f"[dense==paged] 2 prefills + 8 decode steps: logits bit-identical; "
        f"max |kernel - plain| logit {worst:.3e} (tolerance {LOGIT_TOL})")


def _train_batch(batch, seq, vocab=50257):
    """modelbench's batch: seeded random ids, labels the ids rolled by one."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (batch, seq))
    return (torch.from_numpy(ids.astype(np.int32)).cuda(),
            torch.from_numpy(np.roll(ids, -1, 1).astype(np.int32)).cuda())


def phase_train_parity():
    """3 TrainStep steps of a 2-layer GPT-2 at gpt2_345m width (B=4,
    T=1024), every kernel knob on and then off, from the same seeded
    weights: per-step losses and final weights agree (TRAIN_* above)."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.models import get_gpt2, lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    ids, labels = _train_batch(4, 1024)
    runs = []
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2,
                           device="cuda", seed=1)
            ts = TrainStep(net, lm_loss, Adam(learning_rate=TRAIN_LR))
            losses = [float(ts(ids, labels)) for _ in range(TRAIN_STEPS)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in net.named_parameters()}))
        del net, ts
    (lk, pk), (lp, pp) = runs
    for step, (a, b) in enumerate(zip(lk, lp)):
        if not (np.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)):
            raise AssertionError(f"training parity step {step}: loss {a} on "
                                 f"the kernels, {b} on the plain versions")
    err = torch.cat([(pk[n] - pp[n]).abs().reshape(-1) for n in pk])
    worst = err.max().item()
    far = (err > 1e-2 * TRAIN_LR).float().mean().item()
    bound = 2.01 * TRAIN_LR * TRAIN_STEPS
    log(f"[train parity] 2 layers at gpt2_345m width, B=4 T=1024, "
        f"{TRAIN_STEPS} steps: losses kernels {lk} / plain {lp}; max "
        f"|weight diff| {worst:.3e} (bound {bound:.3e}), share beyond "
        f"1e-2*lr {far:.2e} (limit 1e-2)")
    if worst > bound or far > 1e-2:
        raise AssertionError("training parity: final weights differ beyond "
                             "the Adam sign-flip bound")
    return {"losses_kernels": lk, "losses_plain": lp,
            "max_weight_diff": worst, "share_beyond_1e-2_lr": far}


def _launch_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import optimizer as oo
    from mxnet_tpu_torch.ops import paged_attention as pa

    return {"flash_fwd": fa.launches["fwd"], "flash_bwd_dkv": fa.launches["dkv"],
            "flash_bwd_dq": fa.launches["dq"], "adam": oo.launches,
            "layernorm": ln.launches, "paged_attention": pa.launches}


def _reset_launch_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import optimizer as oo
    from mxnet_tpu_torch.ops import paged_attention as pa

    for key in fa.launches:
        fa.launches[key] = 0
    ln.launches = oo.launches = pa.launches = 0


def phase_train(warmup=2, steps=10, batch=4, seq=1024):
    """gpt2_345m at full width through TrainStep, modelbench's setting:
    B=4, T=1024, f32, dropout 0, seed 0, Adam(1e-4), one fixed batch.
    Every step must launch each flash kernel once per layer, Adam once and
    LayerNorm 49 times; every loss is finite and the last is below the
    first. Returns the net (for timing Adam on its parameters), the
    per-kernel launches of the run and the step metrics."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.models import get_gpt2, lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    t0 = time.perf_counter()
    net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0)
    ts = TrainStep(net, lm_loss, Adam(learning_rate=1e-4))
    ids, labels = _train_batch(batch, seq)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"[train] gpt2_345m f32, {len(list(net.parameters()))} parameters, "
        f"{n_params} elements, built in {time.perf_counter() - t0:.1f}s")
    want = {"flash_fwd": N_LAYERS, "flash_bwd_dkv": N_LAYERS,
            "flash_bwd_dq": N_LAYERS, "adam": 1, "layernorm": 2 * N_LAYERS + 1,
            "paged_attention": 0}
    total = dict.fromkeys(want, 0)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t = time.perf_counter()
        before = _launch_counts()
        losses.append(ts(ids, labels))
        got = {k: v - before[k] for k, v in _launch_counts().items()}
        if got != want:
            raise AssertionError(f"train step {i}: launches {got}, expected "
                                 f"{want}")
        for k in total:
            total[k] += got[k]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite and falling")
    res = {"ms_per_step": wall / steps * 1e3,
           "tokens_per_s": batch * seq * steps / wall,
           "peak_bytes": peak, "losses": losses, "steps": steps,
           "warmup": warmup}
    log(f"[train] losses {['%.4f' % x for x in losses]}")
    log(f"[train] {steps} timed steps: {res['ms_per_step']:.1f} ms/step, "
        f"{res['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; launches per step {want}")
    del ts
    return net, total, res


def phase_serve():
    from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0)
    eng = GenerationEngine(net, batch_size=8, max_length=1024, paged=True,
                           page_size=16, eos_id=50256, device="cuda")
    log(f"[serve] gpt2_345m f32 built in {time.perf_counter() - t0:.1f}s; "
        f"{eng.num_pages} pages of 16, buckets {eng.prefill_buckets}")

    calls = {"prefill": 0, "decode": 0, "decode_s": 0.0, "tokens": 0}
    prefill, decode_step = eng.prefill, eng.decode_step

    def counted_prefill(prompt, slot):
        calls["prefill"] += 1
        return prefill(prompt, slot)

    def counted_decode():
        calls["decode"] += 1
        active = int((~eng.done).sum())
        t = time.perf_counter()
        out = decode_step()
        calls["decode_s"] += time.perf_counter() - t
        calls["tokens"] += active
        return out

    eng.prefill, eng.decode_step = counted_prefill, counted_decode
    batcher = ContinuousBatcher(eng, device="cuda")
    rs = np.random.RandomState(0)
    # warm-up request (cuBLAS handles, allocator) outside the measured run
    batcher.submit(rs.randint(0, 50257, 40), max_new_tokens=4)
    batcher.run()
    calls.update(prefill=0, decode=0, decode_s=0.0, tokens=0)

    reqs = [batcher.submit(rs.randint(0, 50257, int(n)), max_new_tokens=64)
            for n in rs.randint(32, 501, 16)]
    ln.launches = 0
    pa.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"layernorm": ln.launches, "paged_attention": pa.launches}

    reasons = [r.finish_reason for r in reqs]
    if any(r is None for r in reasons):
        raise AssertionError(f"unfinished requests: {reasons}")
    for r in reqs:
        if not 1 <= len(r.output) <= 64 or \
                not all(0 <= x < 50257 for x in r.output):
            raise AssertionError(f"request {r.id}: bad output {r.output[:8]}")
    forwards = calls["prefill"] + calls["decode"]
    want = {"paged_attention": 24 * forwards, "layernorm": 49 * forwards}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want} "
                             f"(24 attention + 49 LN per forward, "
                             f"{calls['prefill']} prefills + "
                             f"{calls['decode']} decode steps)")
    ttft = sorted(r.ttft for r in reqs)
    log(f"[serve] {len(reqs)} requests, prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, finish reasons "
        f"{ {x: reasons.count(x) for x in set(reasons)} }")
    log(f"[serve] wall {wall:.2f}s, {calls['prefill']} prefills, "
        f"{calls['decode']} decode steps; TTFT p50 "
        f"{statistics.median(ttft) * 1e3:.1f} ms (queue wait included), "
        f"decode {calls['tokens'] / calls['decode_s']:.1f} tokens/s "
        f"({calls['decode_s'] / calls['decode'] * 1e3:.2f} ms/step)")
    log(f"[serve] launches in the run: {launches} (24 and 49 per forward)")
    return eng, launches


def _bound_ms(nbytes, flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S \
        else "operations"


def _timed(kern, plain, library, nbytes, flops, shape, plain_graph=True,
           small=False):
    """One row of the kernel table. ``ms``, ``plain_ms`` and ``library_ms``
    are device times (CUDA graph replay), except the plain paged read, whose
    host syncs cannot be captured: its time is eager. The ``*_eager_ms``
    are the per-call times of eager calls, host included, as the serving
    loop pays them. ``library=None`` leaves the library time to the caller;
    ``small`` takes fewer calls, for work of milliseconds per call."""
    bound_ms, bound_by = _bound_ms(nbytes, flops)
    g = dict(calls=2, replays=3, repeats=3) if small else {}
    e = dict(warmup=2, iters=5, repeats=3) if small else {}
    r = dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by,
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
        f"{bound_ms * 1e3:.2f} us ({bound_by})")
    return r


def phase_timing(eng):
    """Each kernel at the serving path's shapes beside its plain version
    and a library call; bound = max(bytes / HBM rate, flops / f32 rate),
    each input read once and each output written once."""
    from mxnet_tpu_torch.ops import layernorm as ln
    from mxnet_tpu_torch.ops import paged_attention as pa

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
        plain_graph=False)
    del hist

    # prefill attention at the largest bucket (one row, 512 new tokens)
    tq = 512
    kp, vp = pools[0]
    qp = torch.randn(1, h, tq, ch, generator=gen).to(dev)
    tp = table[:1].contiguous()
    p0 = torch.zeros(1, dtype=torch.int32, device=dev)
    kh = kp[tp[0, :tq // 16].long()].transpose(0, 1).reshape(1, h, tq, ch)
    vh = vp[tp[0, :tq // 16].long()].transpose(0, 1).reshape(1, h, tq, ch)
    _timed(lambda: pa.paged_attention_read(qp, kp, vp, tp, p0),
           lambda: pa.paged_attention_read_plain(qp, kp, vp, tp, p0),
           lambda: sdpa(qp, kh, vh, is_causal=True),
           nbytes=4 * 4 * h * tq * ch + 4 * tq // 16,
           flops=4 * h * ch * tq * (tq + 1) // 2,
           shape="paged_attention prefill B=1 Tq=512 from position 0 f32",
           plain_graph=False)

    # LayerNorm at the decode shape (8 rows of 1024) and the largest
    # prefill bucket (512 rows)
    g = torch.ones(1024, device=dev)
    bb = torch.zeros(1024, device=dev)
    for n_rows in (8, 512):
        x = torch.randn(n_rows, 1024, generator=gen).to(dev)
        r = _timed(lambda: ln.layer_norm(x, g, bb),
                   lambda: ln.layer_norm_plain(x, g, bb),
                   lambda: torch.nn.functional.layer_norm(x, (1024,), g, bb,
                                                          1e-5),
                   nbytes=4 * (2 * x.numel() + 2 * 1024),
                   flops=8 * x.numel(),
                   shape=f"layernorm ({n_rows}, 1024) f32")
        if n_rows == 8:
            rows["layernorm"] = r
    return rows


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


def phase_train_timing(net):
    """The training kernels at the shapes gpt2_345m training gives them:
    flash (B=4, H=16, T=1024, D=64, causal, f32; also T=2048) and Adam over
    the model's 292 parameters. Bounds as in phase_timing."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import optimizer as oo

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for t in (1024, 2048):
        b, h, d = 4, 16, 64
        q, k, v = _flash_inputs(gen, b, h, t, t, d, torch.float32, dev)
        do = torch.randn(b, h, t, d, generator=gen).to(dev)
        out, lse = fa._flash_fwd(q, k, v, True, return_lse=True)
        di = fa._row_dot(do, out).contiguous()
        bounds = _flash_bounds(b, h, t, d, 4)
        shape = f"B={b} H={h} T={t} D={d} causal f32"
        fwd = _timed(lambda: fa._flash_fwd(q, k, v, True, return_lse=True),
                     lambda: fa.flash_fwd_plain(q, k, v, True),
                     lambda: sdpa(q, k, v, is_causal=True),
                     *bounds["fwd"], shape=f"flash_fwd {shape}")
        # the library yardstick of the backward: SDPA forward + backward
        # minus SDPA forward, eager, on inputs that require grad
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        fb_ms = cuda_time_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do), iters=10)
        f_ms = cuda_time_ms(lambda: sdpa(qg, kg, vg, is_causal=True), iters=10)
        lib_bwd = fb_ms - f_ms
        log(f"[time] SDPA causal backward at {shape}: {lib_bwd * 1e3:.2f} us "
            f"(fwd+bwd {fb_ms * 1e3:.2f} - fwd {f_ms * 1e3:.2f}, eager)")
        del qg, kg, vg
        bwd = {}
        for name, kern, plain in (
                ("dkv", fa._bwd_dkv, fa._flash_bwd_dkv_plain),
                ("dq", fa._bwd_dq, fa._flash_bwd_dq_plain)):
            bwd[name] = _timed(
                lambda: kern(q, k, v, do, lse, di, True),
                lambda: plain(q, k, v, do, lse, di, True),
                None, *bounds[name], shape=f"flash_bwd_{name} {shape}")
            bwd[name].update(library_ms=lib_bwd, library_eager_ms=lib_bwd,
                             library="SDPA backward (dq, dk, dv together): "
                                     "fwd+bwd minus fwd, eager")
        if t == 1024:
            fwd["library"] = "SDPA is_causal forward"
            rows["flash_fwd"] = fwd
            rows["flash_bwd_dkv"], rows["flash_bwd_dq"] = bwd["dkv"], bwd["dq"]
        del q, k, v, do, out, lse, di

    # Adam over gpt2_345m's parameters: f32 grads, lr 1e-4, wd 0
    ws = [p.detach() for p in net.parameters()]
    gs = [torch.randn(w.shape, generator=gen).to(dev) * 1e-3 for w in ws]
    ms = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    n = sum(w.numel() for w in ws)
    lr = torch.full((len(ws),), 1e-4, device=dev)
    wd = torch.zeros(len(ws), device=dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)

    def plain_adam():
        for i in range(len(ws)):
            oo.adam_update(ws[i], gs[i], ms[i], vs[i], lr[i], 0.9, 0.999,
                           1e-8, wd[i])

    lib_params = [torch.nn.Parameter(w.clone()) for w in ws]
    for p, g in zip(lib_params, gs):
        p.grad = g
    lib_opt = torch.optim.Adam(lib_params, lr=1e-4, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=0.0, fused=True)
    rows["adam"] = _timed(
        lambda: oo.adam_update_fused(ws, gs, ms, vs, lr, wd, **kw),
        plain_adam, None, nbytes=28 * n, flops=12 * n,
        shape=f"adam {len(ws)} tensors, {n} elements, f32 grads",
        small=True)
    rows["adam"].update(
        library_ms=cuda_time_ms(lib_opt.step, warmup=2, iters=5, repeats=3),
        library="torch.optim.Adam(fused=True).step(), eager, wd 0 (epsilon "
                "added after the bias correction, not before as here)")
    rows["adam"]["library_eager_ms"] = rows["adam"]["library_ms"]
    log(f"[time] adam library {rows['adam']['library_ms'] * 1e3:.2f} us")
    del lib_opt, lib_params, gs, ms, vs
    return rows


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
    parity = phase_train_parity()
    eng, serve_launches = phase_serve()
    timing = phase_timing(eng)
    del eng
    torch.cuda.empty_cache()
    net, train_launches, train = phase_train()
    timing.update(phase_train_timing(net))
    log("[train] " + json.dumps(dict(train, parity=parity)))
    # (source, replaced TPU kernel, the path whose run gives `launches`)
    meta = {
        "paged_attention": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                            "mxnet_tpu/ops/pallas_paged_attention.py:79",
                            "serve"),
        "layernorm": ("mxnet_tpu_torch/csrc/layernorm.cu",
                      "mxnet_tpu/ops/pallas_layernorm.py:53", "serve"),
        "flash_fwd": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                      "mxnet_tpu/ops/flash_attention.py:100", "train"),
        "flash_bwd_dkv": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                          "mxnet_tpu/ops/flash_attention.py:256", "train"),
        "flash_bwd_dq": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                         "mxnet_tpu/ops/flash_attention.py:285", "train"),
        "adam": ("mxnet_tpu_torch/csrc/adam.cu",
                 "mxnet_tpu/ops/pallas_optimizer.py:63", "train"),
    }
    by_path = {"serve": serve_launches, "train": train_launches}
    kernels = []
    for name, (src, rep, path) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": by_path[path][name], "launches_path": path,
            "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "eager_ms": t["eager_ms"], "plain_eager_ms": t["plain_eager_ms"],
            "library_eager_ms": t["library_eager_ms"],
            "library": t.get("library")})
    log(f"[done] {time.perf_counter() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
