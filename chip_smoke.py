#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure (so the script exits non-zero and never
prints its last line):

  1. build the CUDA kernels from ``mxnet_tpu_torch/csrc/`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes the serving path gives it;
  3. check that dense-cache and paged-cache logits are bit-identical
     through a small GPT-2 (2 layers at gpt2_345m width), and that they
     agree with the same engine run on the kernels' plain versions;
  4. serve 16 requests through the paged engine and the continuous
     batcher with gpt2_345m at full width (seeded random weights, f32),
     with both kernels' launch counts read around that run, then time each
     kernel, its plain version and a PyTorch library yardstick with CUDA
     events, on the device (CUDA graph replay) and per eager call;
  5. print the kernel table as one JSON line, then the result line.

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

# Tolerances, |kernel - plain| <= atol + rtol * |plain|. f32: only the order
# of the f32 sums differs. bf16: the plain version rounds scores and
# weights to bf16 where the kernel keeps f32. LayerNorm's are those of
# tests/test_pallas_layernorm.py.
TOL = {
    ("paged_attention", torch.float32): 1e-5,
    ("paged_attention", torch.bfloat16): 2e-2,
    ("layernorm", torch.float32): 2e-5,
    ("layernorm", torch.bfloat16): 3e-2,
}
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
    errs = {"paged_attention": 0.0, "layernorm": 0.0}
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
    return errs


@contextlib.contextmanager
def plain_versions():
    """Both knobs off: the engine runs the kernels' plain PyTorch versions."""
    from mxnet_tpu_torch import config

    config.set("paged_attention_kernel", False)
    config.set("fused_layernorm", False)
    try:
        yield
    finally:
        config.set("paged_attention_kernel", True)
        config.set("fused_layernorm", True)


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


def _timed(kern, plain, library, nbytes, flops, shape, plain_graph=True):
    """One row of the kernel table. ``ms``, ``plain_ms`` and ``library_ms``
    are device times (CUDA graph replay), except the plain paged read, whose
    host syncs cannot be captured: its time is eager. The ``*_eager_ms``
    are the per-call times of eager calls, host included, as the serving
    loop pays them."""
    bound_ms, bound_by = _bound_ms(nbytes, flops)
    r = dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by,
             ms=graph_time_ms(kern), eager_ms=cuda_time_ms(kern),
             plain_eager_ms=cuda_time_ms(plain, iters=5),
             library_ms=graph_time_ms(library),
             library_eager_ms=cuda_time_ms(library))
    r["plain_ms"] = graph_time_ms(plain) if plain_graph else r["plain_eager_ms"]
    log(f"[time] {shape}: kernel {r['ms'] * 1e3:.2f} us (eager "
        f"{r['eager_ms'] * 1e3:.2f}), plain {r['plain_ms'] * 1e3:.2f} us "
        f"(eager {r['plain_eager_ms'] * 1e3:.2f}), library "
        f"{r['library_ms'] * 1e3:.2f} us (eager "
        f"{r['library_eager_ms'] * 1e3:.2f}), bound {bound_ms * 1e3:.2f} us "
        f"({bound_by})")
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
    eng, launches = phase_serve()
    timing = phase_timing(eng)
    meta = {
        "paged_attention": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                            "mxnet_tpu/ops/pallas_paged_attention.py:79"),
        "layernorm": ("mxnet_tpu_torch/csrc/layernorm.cu",
                      "mxnet_tpu/ops/pallas_layernorm.py:53"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "eager_ms": t["eager_ms"], "plain_eager_ms": t["plain_eager_ms"],
            "library_eager_ms": t["library_eager_ms"]})
    log(f"[done] {time.perf_counter() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
