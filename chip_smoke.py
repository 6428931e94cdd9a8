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
     cores, frontiers on split boundaries, in five (q, pool) dtype pairs;
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
     on a warm-up schedule;
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
     same for the training graphs in 7);
  7. train gpt2_345m at full width (B=4, T=1024, f32, Adam) through
     TrainStep: 2 warm-up and 10 timed steps, with the launch counts of
     every kernel read around each step; then the same in bf16
     (``train_amp``): TrainStep(net, SoftmaxCrossEntropyLoss(),
     Adam(lr_scheduler=...), amp="bfloat16"); each naive, graph, graph,
     naive from the same weights, losses, weights and Adam moments
     bit-identical across the four;
  8. time each kernel, its plain version and a PyTorch library yardstick
     with CUDA events, on the device (CUDA graph replay) and per eager
     call, at the shapes the three paths give them, and the launch floor
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
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
    check_tensor_cores(libs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


# the kernels that must multiply on the tensor cores, by library: (name
# fragments of the kernel, TF32): the bf16 flash forward and backward, the
# f32 flash forward and backward in 3xTF32, and the paged prefill read in
# 3xTF32 (every instantiation), whose HMMA must have the TF32 m16n8k8 shape
# (.TF32, 1688)
TC_KERNELS = {
    "flash_attention": [((ns, f"{kern}ILi{d}"), ns == "tf32x3")
                        for ns in ("bf16tc", "tf32x3")
                        for kern in ("flash_fwd_tc_kernel",
                                     "flash_bwd_dkv_tc_kernel",
                                     "flash_bwd_dq_tc_kernel")
                        for d in (64, 128)],
    "paged_attention": [((f"paged_prefill_tc_kernelILi{ch}",), True)
                        for ch in (16, 32, 64, 128)],
}


def check_tensor_cores(libs):
    """Count the tensor-core instructions (HMMA, HGMMA) of each kernel of
    the libraries in TC_KERNELS in their SASS (``cuobjdump -sass``), and
    among them the TF32 ones, and fail unless every kernel that a
    TC_KERNELS entry names has some (TF32 ones where it says so): each
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
                counts[fn] = [0, 0]
            elif fn is not None and "HMMA" in line:  # HMMA and HGMMA
                counts[fn][0] += 1
                counts[fn][1] += ".TF32" in line or "1688" in line
        for fn, (n, n_tf32) in sorted(counts.items()):
            if n:
                log(f"  {name} SASS: {n} tensor-core instructions "
                    f"({n_tf32} TF32) in {fn[:80]}")
        for parts, tf32 in wants:
            fns = [fn for fn in counts if all(p in fn for p in parts)]
            bare = [fn for fn in fns if counts[fn][1 if tf32 else 0] == 0]
            if not fns or bare:
                raise AssertionError(
                    f"no {'TF32 ' if tf32 else ''}tensor-core instruction "
                    f"in {'::'.join(parts)} ({bare or 'no such kernel'})")


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
# frontiers cross key tiles
PAGED_CASES = [(8, 16, 1, None, "(row 0 all trash)"),
               (8, 16, 128, None, "(row 0 all trash)"),
               (8, 16, 1, [127, 128, 129, 255, 256, 300, 511, 1023],
                "(frontiers at split boundaries)"),
               (2, 4, 16, [120, 500], "(small prefill)"),
               (1, 16, 512, [0], "(serve prefill from position 0)"),
               (2, 4, 100, [37, 600], "(ragged prefill across tiles)")]


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
                errs[key] = max(errs.get(key, 0.0), check_close(
                    key, qdtype, got, want,
                    f"{dn} B={b} tq={tq} ps={ps} {what}",
                    failures=failures))


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
# rows that see no key (Tq > Tk), and a ragged length
FLASH_CASES = [(4, 16, 1024, 1024, True), (4, 16, 1024, 1024, False),
               (1, 16, 128, 384, True), (1, 16, 384, 128, True),
               (2, 8, 320, 320, True)]


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

    def held(key, *args, **kw):
        errs[key] = max(errs.get(key, 0.0),
                        check_close(*args, failures=failures, **kw))

    for dtype in dtypes:
        dn = str(dtype)[6:]
        sfx = "" if dtype == torch.float32 else "_bf16"
        for d in (64, 128):
            for b, h, tq, tk, causal in FLASH_CASES:
                what = f"{dn} d={d} B={b} H={h} Tq={tq} Tk={tk} causal={causal}"
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
# 4096, vocab 50257), one row, ragged small shapes, and a row wider than
# the TPU kernel's 65536 cap
XENT_CASES = [(4096, 50257), (1, 50257), (9, 50), (300, 128), (7, 70000)]


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
            (4096, 1024, 0, _WARP), (64, 1000, 0, _WARP),
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
    paths' shape in every dtype pair, the others in f32 and bf16. Each case
    must take its routes. The backward at (4096, 1024) f32 is also measured
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
            got = ln.layer_norm(x, g, b)
            want = ln.layer_norm_plain(x, g, b)
            grads = ln._backward(x, g, cot, 1e-5)
            wants = ln.layer_norm_bwd(x, g, cot, 1e-5)
            torch.cuda.synchronize()
            errs["layernorm" + sfx] = max(errs.get("layernorm" + sfx, 0.0),
                                          check_close("layernorm", xdt, got,
                                                      want,
                                                      f"{what} {route[0]}"))
            for a, r, name in zip(grads, wants, ("dx", "dgamma", "dbeta")):
                if a.dtype != r.dtype or a.shape != r.shape:
                    raise AssertionError(f"layernorm backward {what}: {name} "
                                         f"{a.dtype} {tuple(a.shape)}, plain "
                                         f"{r.dtype} {tuple(r.shape)}")
                errs["layernorm_bwd" + sfx] = max(
                    errs.get("layernorm_bwd" + sfx, 0.0),
                    check_close("layernorm_grad", a.dtype, a, r,
                                f"backward {name} {what} {route[1]}"))
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


def phase_train_parity(amp=None, seed=1, batch_seed=0, check=True):
    """3 TrainStep steps of a 2-layer GPT-2 at gpt2_345m width (B=4,
    T=1024), every kernel knob on and then off, from the same seeded
    weights: per-step losses and final weights agree. In f32 (``amp=None``)
    through ``lm_loss`` and Adam at TRAIN_LR (TRAIN_* above); under
    ``amp="bfloat16"`` through SoftmaxCrossEntropyLoss and Adam on the
    warm-up schedule, the masters staying f32 (AMP_* above). With
    ``check=False`` it only measures (tools/torch_amp_parity.py)."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import get_gpt2, lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    ids, labels = _train_batch(4, 1024, seed=batch_seed)
    runs = []
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            net = get_gpt2("gpt2_345m", dropout=0.0, num_layers=2,
                           device="cuda", seed=seed)
            if amp is None:
                opt, loss_fn = Adam(learning_rate=TRAIN_LR), lm_loss
            else:
                opt = Adam(learning_rate=AMP_LR, lr_scheduler=amp_schedule())
                loss_fn = SoftmaxCrossEntropyLoss()
            # the kernels through the step graphs (the default), the plain
            # versions eagerly: the reference
            ts = TrainStep(net, loss_fn, opt, amp=amp,
                           engine_type="naive" if plain else "graph")
            rates, losses = [], []
            for _ in range(TRAIN_STEPS):
                rates.append(opt.learning_rate)
                losses.append(float(ts(ids, labels)))
        params = {n: p.detach().clone() for n, p in net.named_parameters()}
        if any(p.dtype != torch.float32 for p in params.values()):
            raise AssertionError("training parity: the masters left f32")
        runs.append((losses, params))
        del net, ts
    (lk, pk), (lp, pp) = runs
    name = "train parity" if amp is None else f"train {amp} parity"
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
    log(f"[{name}] 2 layers at gpt2_345m width, B=4 T=1024, seeds "
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

    for counts in (fa.launches, sx.launches, pa.launches, ln.launches):
        for key in counts:
            counts[key] = 0
    oo.launches = 0


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


def check_replay_launches(prog, what):
    """Replay the captured step graph ``prog`` under the profiler and
    count the port's kernels the card ran in one replay, by name: they must equal the
    launches that the graph adds to the wrapper counts at every replay
    (recorded when it was captured). So the counts of a "graph" run are
    what the card launched, not only what the capture saw. Returns the
    counts."""
    from torch.profiler import ProfilerActivity, profile

    recorded = {name: 0 for name, _ in COUNTERS.values()}
    for (mod, key), n in prog.launches.items():
        recorded[COUNTERS[(mod.split(".")[-1], key)][0]] += n
    torch.cuda.synchronize()
    # a warm-up replay that the profiler discards (a trace's first kernels
    # can be lost while tracing starts), then the replay it counts
    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CUDA], schedule=once) as prof:
        for _ in range(2):
            prog.graph.replay()
            torch.cuda.synchronize()
            prof.step()
    seen = dict.fromkeys(recorded, 0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, kernels in COUNTERS.values():
            if any(k in evt.key for k in ((kernels,) if isinstance(
                    kernels, str) else kernels)):
                seen[name] += evt.count
    if seen != recorded or not any(seen.values()):
        raise AssertionError(f"{what}: one replay ran the kernels {seen}, "
                             f"the graph records {recorded} launches")
    log(f"[replay] {what}: one replay under the profiler ran "
        f"{ {k: v for k, v in seen.items() if v} }, as recorded at capture")
    return seen


# the engine types in the order the timed phases run them: naive, graph,
# graph, naive, so that drift over the call does not favour either
MODE_TURNS = ("naive", "graph", "graph", "naive")


def _release():
    """Free what dropped engines and TrainSteps held (the serving wrappers
    below make cycles) and hand the cached memory back."""
    gc.collect()
    torch.cuda.empty_cache()


def _state(net, ts, host=False):
    """Copies of every parameter and optimizer state tensor, in a fixed
    order (what bit-identity between engine types is checked on); in host
    memory with ``host``, for the full-width runs."""
    copy = (lambda t: t.detach().cpu()) if host else \
        (lambda t: t.detach().clone())
    out = [copy(p) for _, p in sorted(net.named_parameters())]
    for name in sorted(ts.opt_state):
        st = ts.opt_state[name]
        out.extend(copy(t) for t in
                   (st if isinstance(st, (tuple, list)) else (st,))
                   if t is not None)
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
    beta) and (bf16) each xent kernel once, under either engine type;
    every loss is finite and the last is below the first. Returns the
    per-kernel launches of the run, the step metrics and the final weights
    and Adam moments."""
    name = "train" if amp is None else "train_amp"
    with torch.no_grad():
        for (_, p), w in zip(sorted(net.named_parameters()), init):
            p.copy_(w)
    ts = _train_step(net, amp, engine_type)
    ids, labels = _train_batch(batch, seq)
    xent = 0 if amp is None else 1
    want = {"flash_fwd": N_LAYERS, "flash_bwd_dkv": N_LAYERS,
            "flash_bwd_dq": N_LAYERS, "adam": 1, "layernorm": 2 * N_LAYERS + 1,
            "layernorm_bwd": 2 * N_LAYERS + 1,
            "layernorm_bwd_merge": 2 * N_LAYERS + 1,
            "paged_attention": 0, "paged_attention_prefill": 0,
            "xent_fwd": xent, "xent_bwd": xent}
    total = dict.fromkeys(want, 0)
    losses = []
    torch.cuda.synchronize()
    _release()  # the peaks below start from what this run holds
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with _ln_dtypes() as ln_pairs:
        for i in range(warmup + steps):
            if i == warmup:
                torch.cuda.synchronize()
                t = time.perf_counter()
            before = _launch_counts()
            losses.append(ts(ids, labels))
            got = {k: v - before[k] for k, v in _launch_counts().items()}
            if got != want:
                raise AssertionError(f"{name} {engine_type} step {i}: "
                                     f"launches {got}, expected {want}")
            for k in total:
                total[k] += got[k]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dt = torch.float32 if amp is None else torch.bfloat16
    if set(ln_pairs) != {("fwd", dt, dt), ("bwd", dt, dt)}:
        raise AssertionError(f"{name} {engine_type}: LayerNorm ran on "
                             f"(x, gamma) dtypes {dict(ln_pairs)}")
    log(f"[{name} {engine_type}] LayerNorm wrapper calls by (direction, x, "
        f"gamma dtype): {dict(ln_pairs)}")
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} losses {losses}: not finite and falling")
    programs = ts.compiled_programs
    if programs != 1:
        raise AssertionError(f"{name} {engine_type}: {programs} programs")
    res = {"engine_type": engine_type, "ms_per_step": wall / steps * 1e3,
           "tokens_per_s": batch * seq * steps / wall,
           "peak_bytes": peak,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "losses": losses, "steps": steps, "warmup": warmup, "amp": amp}
    log(f"[{name} {engine_type}] losses {['%.4f' % x for x in losses]}")
    log(f"[{name} {engine_type}] {steps} timed steps: "
        f"{res['ms_per_step']:.2f} ms/step, {res['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {peak / 2**30:.2f} GiB (reserved "
        f"{res['peak_reserved_bytes'] / 2**30:.2f}); launches per step "
        f"{want}")
    state = _state(net, ts, host=True)
    if engine_type == "graph":  # replays more: after the state was read
        (prog, _, _), = ts._programs.values()
        check_replay_launches(prog, f"{name} step graph")
    del ts
    _release()
    return total, res, state


def phase_train_turns(amp=None):
    """``phase_train`` under MODE_TURNS from one start: every run's losses,
    final weights and Adam moments bit-identical to the first's. Returns
    the net, the launches of the first "graph" run and the runs'
    metrics."""
    name = "train" if amp is None else "train_amp"
    net, init = _train_net(amp)
    runs, ref, launches = [], None, None
    for mode in MODE_TURNS:
        total, res, state = phase_train(net, init, mode, amp=amp)
        if ref is None:
            ref = (res["losses"], state)
        elif res["losses"] != ref[0] or not _same_state(state, ref[1]):
            raise AssertionError(f"{name}: the {mode} run's losses, weights "
                                 f"or moments differ from the first run's")
        if mode == "graph" and launches is None:
            launches = total
        runs.append(res)
        del state
    del ref, init
    _release()
    log(f"[{name}] {' '.join(MODE_TURNS)}: losses, weights and Adam moments "
        f"bit-identical across the runs; ms/step "
        f"{[round(r['ms_per_step'], 2) for r in runs]}")
    return net, launches, runs


def _serve_run(net, engine_type, requests, sampling=None, warm=True):
    """Serve ``requests`` ((prompt, max_new_tokens) pairs) through a paged
    engine (batch 8, page size 16, EOS 50256) and the continuous batcher,
    after one warm-up request when ``warm``. Returns the engine, the
    requests, the decode steps' logits in order, the call counts, the
    launches of the run, its wall time and peak memory, and the program
    count seen after each call (which must stay at the buckets used + 1)."""
    from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine

    eng = GenerationEngine(net, batch_size=8, max_length=1024, paged=True,
                           page_size=16, eos_id=50256, device="cuda",
                           sampling=sampling, engine_type=engine_type)
    calls = {"prefill": 0, "decode": 0, "decode_s": 0.0, "tokens": 0}
    buckets, logits, decoded = set(), [], []
    prefill, decode_step = eng.prefill, eng.decode_step

    def check_programs(what):
        want = len(buckets) + (1 if decoded else 0)
        if eng.compiled_programs != want or len(eng._programs) != want:
            raise AssertionError(
                f"serve {engine_type} after {what}: {eng.compiled_programs} "
                f"programs ({len(eng._programs)} graphs), expected the "
                f"{len(buckets)} buckets used + 1")

    def counted_prefill(prompt, slot):
        calls["prefill"] += 1
        buckets.add(eng.bucket_for(len(prompt)))
        out = prefill(prompt, slot)
        check_programs("a prefill")
        return out

    def counted_decode():
        calls["decode"] += 1
        active = int((~eng.done).sum())
        t = time.perf_counter()
        out = decode_step()
        calls["decode_s"] += time.perf_counter() - t
        calls["tokens"] += active
        logits.append(out[2])
        decoded.append(True)
        check_programs("a decode step")
        return out

    eng.prefill, eng.decode_step = counted_prefill, counted_decode
    batcher = ContinuousBatcher(eng, device="cuda")
    if warm:
        # warm-up request (cuBLAS handles, allocator; under "graph" the
        # decode graph's capture) outside the measured run
        batcher.submit(np.random.RandomState(9).randint(0, 50257, 40),
                       max_new_tokens=4)
        batcher.run()
        calls.update(prefill=0, decode=0, decode_s=0.0, tokens=0)
        logits.clear()
    reqs = [batcher.submit(p, max_new_tokens=n) for p, n in requests]
    torch.cuda.synchronize()
    _release()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t = time.perf_counter()
    batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in _launch_counts().items()
                if k in ("layernorm", "layernorm_bwd", "layernorm_bwd_merge",
                         "paged_attention", "paged_attention_prefill")}
    return dict(eng=eng, reqs=reqs, logits=logits, calls=calls,
                launches=launches, wall=wall, buckets=buckets,
                peak=torch.cuda.max_memory_allocated(),
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
    forwards = calls["prefill"] + calls["decode"]
    # prompts of 32 tokens and more: every prefill reads more than one
    # query (the prefill kernel), every decode step one (the decode kernel)
    want = {"paged_attention": 24 * calls["decode"],
            "paged_attention_prefill": 24 * calls["prefill"],
            "layernorm": 49 * forwards, "layernorm_bwd": 0,
            "layernorm_bwd_merge": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want} "
                             f"(24 attention + 49 LN per forward, "
                             f"{calls['prefill']} prefills + "
                             f"{calls['decode']} decode steps)")
    ttft = sorted(r.ttft for r in reqs)
    used = {eng.bucket_for(len(r.prompt)) for r in reqs} | {eng.bucket_for(40)}
    if eng.compiled_programs != len(used) + 1:
        raise AssertionError(f"serve: {eng.compiled_programs} programs for "
                             f"{len(used)} buckets used + 1")
    res = {"engine_type": engine_type,
           "ttft_p50_ms": statistics.median(ttft) * 1e3,
           "decode_ms_per_step": calls["decode_s"] / calls["decode"] * 1e3,
           "decode_tokens_per_s": calls["tokens"] / calls["decode_s"],
           "wall_s": run["wall"], "prefills": calls["prefill"],
           "decode_steps": calls["decode"],
           "compiled_programs": eng.compiled_programs,
           "peak_bytes": run["peak"],
           "peak_reserved_bytes": run["peak_reserved"]}
    log(f"[serve {engine_type}] {len(reqs)} requests, prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, finish reasons "
        f"{ {x: reasons.count(x) for x in set(reasons)} }")
    log(f"[serve {engine_type}] wall {run['wall']:.2f}s, {calls['prefill']} "
        f"prefills, {calls['decode']} decode steps; TTFT p50 "
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
    the first "graph" run (the main path) and the runs' metrics. No run
    keeps its engine past its end, so that each run's peak memory is its
    own."""
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
    del ref
    log(f"[serve] {' '.join(MODE_TURNS)}: tokens and the logits of all "
        f"{steps} decode steps bit-identical across the runs; decode ms/step "
        f"{[round(r['decode_ms_per_step'], 2) for r in runs]}, TTFT p50 ms "
        f"{[round(r['ttft_p50_ms'], 1) for r in runs]}")
    return launches, runs


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
            out[mode] = ([float(x) for x in losses], _state(net, ts),
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

    rows.update(phase_layernorm_timing())
    return rows


def phase_layernorm_timing():
    """LayerNorm's forward at the decode shape (8 rows of 1024), the
    largest prefill bucket (512 rows) and the training shape (B=4 x T=1024
    rows: 49 launches a ``train`` or ``train_amp`` step) in f32, and at the
    training shape in bf16 (``train_amp``'s bf16 x, gamma and beta), each
    beside the launch floor: a kernel that does nothing on the grid and
    block of the route taken. The backward at the training shape in f32
    and bf16, its library yardstick F.layer_norm's forward + backward minus
    its forward (device, CUDA graph replay; and eager). Bounds: each input
    read once, each output written once (forward: x, gamma, beta in, y out;
    backward: x, g, gamma in, dx, dgamma, dbeta out), ~8 flops an element
    forward and ~16 backward at the f32 CUDA-core rate."""
    from mxnet_tpu_torch.ops import layernorm as ln

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    rows, floor = {}, {}
    for n_rows, dtype in ((8, torch.float32), (512, torch.float32),
                          (4096, torch.float32), (4096, torch.bfloat16)):
        x, g, bb, cot = _ln_case(gen, n_rows, 1024, 0, dtype, dtype, dev)
        size = x.element_size()
        shape = f"({n_rows}, 1024) {str(dtype)[6:]}"
        route = ln_route(x, g, bb)
        r = _timed(lambda: ln.layer_norm(x, g, bb),
                   lambda: ln.layer_norm_plain(x, g, bb),
                   lambda: F.layer_norm(x, (1024,), g, bb, 1e-5),
                   nbytes=size * (2 * x.numel() + 2 * 1024),
                   flops=8 * x.numel(), shape=f"layernorm {shape} {route}")
        r["library"] = "F.layer_norm"
        floor[shape] = {"route": route, "layernorm_ms": r["ms"],
                        "bound_ms": r["bound_ms"],
                        "empty_ms": graph_time_ms(
                            lambda: empty_launch(x, g, bb)),
                        "empty_eager_ms": cuda_time_ms(
                            lambda: empty_launch(x, g, bb))}
        log(f"[time] empty kernel on LayerNorm's {route} grid {shape}: "
            f"{floor[shape]['empty_ms'] * 1e3:.2f} us by graph replay "
            f"(eager {floor[shape]['empty_eager_ms'] * 1e3:.2f}); "
            f"LayerNorm {r['ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.2f} us")
        sfx = "" if dtype == torch.float32 else "_bf16"
        if n_rows == 8:
            rows["layernorm"] = r
        elif n_rows == 4096:
            if sfx:
                rows["layernorm_bf16"] = r
            xg, gg, bg = (t.clone().requires_grad_() for t in (x, g, bb))

            def lib_fwd_bwd():
                torch.autograd.grad(F.layer_norm(xg, (1024,), gg, bg, 1e-5),
                                    (xg, gg, bg), cot)

            def lib_fwd():
                F.layer_norm(xg, (1024,), gg, bg, 1e-5)

            fb_ms, f_ms = graph_time_ms(lib_fwd_bwd), graph_time_ms(lib_fwd)
            lib_bwd = fb_ms - f_ms
            lib_bwd_eager = cuda_time_ms(lib_fwd_bwd) - cuda_time_ms(lib_fwd)
            log(f"[time] F.layer_norm backward at {shape}: "
                f"{lib_bwd * 1e3:.2f} us (fwd+bwd {fb_ms * 1e3:.2f} - fwd "
                f"{f_ms * 1e3:.2f}, device); eager {lib_bwd_eager * 1e3:.2f} "
                f"us")
            bwd = _timed(lambda: ln._backward(x, g, cot, 1e-5),
                         lambda: ln.layer_norm_bwd(x, g, cot, 1e-5), None,
                         nbytes=size * 3 * x.numel() + 3 * 1024 * size,
                         flops=16 * x.numel(),
                         shape=f"layernorm_bwd {shape} {route}")
            bwd.update(library_ms=lib_bwd, library_eager_ms=lib_bwd_eager,
                       library="F.layer_norm backward: fwd+bwd minus fwd")
            rows["layernorm_bwd" + sfx] = bwd
            del xg, gg, bg
        del x, g, bb, cot
    log("[launch floor] " + json.dumps(floor))
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
    flash (B=4, H=16, T=1024, D=64, causal) in f32 (the ``train`` path; also
    T=2048) and in bf16 (``train_amp``), and Adam over the model's 292
    parameters. Bounds as in phase_timing. Returns the rows by kernel name,
    the bf16 flash rows under ``<name>_bf16``."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import optimizer as oo

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for t, dtype in ((1024, torch.float32), (2048, torch.float32),
                     (1024, torch.bfloat16)):
        b, h, d = 4, 16, 64
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
        # the library yardstick of the backward: SDPA forward + backward
        # minus SDPA forward on inputs that require grad, on the device (CUDA
        # graph replay; eager, SDPA's host time per call, ~0.3 ms in bf16,
        # would be measured instead) and eager
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
        if t == 1024:
            sfx = "" if dtype == torch.float32 else "_bf16"
            fwd["library"] = "SDPA is_causal forward"
            rows["flash_fwd" + sfx] = fwd
            rows["flash_bwd_dkv" + sfx] = bwd["dkv"]
            rows["flash_bwd_dq" + sfx] = bwd["dq"]
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
    # capturable: its step count stays on the card, so a CUDA graph can
    # replay the step (device time) as it does the kernel's
    lib_opt = torch.optim.Adam(lib_params, lr=1e-4, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=0.0, fused=True,
                               capturable=True)
    rows["adam"] = _timed(
        lambda: oo.adam_update_fused(ws, gs, ms, vs, lr, wd, **kw),
        plain_adam, lib_opt.step, nbytes=28 * n, flops=12 * n,
        shape=f"adam {len(ws)} tensors, {n} elements, f32 grads",
        small=True)
    rows["adam"]["library"] = (
        "torch.optim.Adam(fused=True, capturable=True).step(), wd 0 "
        "(epsilon added after the bias correction, not before as here)")
    del lib_opt, lib_params, gs, ms, vs
    return rows


def phase_xent_timing():
    """The xent kernels at the train_amp path's LM-head shape, (4096, 50257)
    in bf16 (the path's dtype; those are the table's rows) and in f32,
    beside their plain versions and F.cross_entropy. Bound as in
    phase_timing: the logits read once (and dx written once), and 16 bytes
    a row each way (labels and loss or cotangent, 4 bytes each; the row max
    and sum, 8); ~4 operations a logit each way."""
    from mxnet_tpu_torch.ops import softmax_xent as sx

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    rows = {}
    n, c = 4096, 50257
    for dtype in (torch.bfloat16, torch.float32):
        x, lbl, g = _xent_inputs(gen, n, c, dtype, dev)
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
        if dtype == torch.bfloat16:
            rows["xent_fwd"], rows["xent_bwd"] = fwd, bwd
        del x, xg, stats
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
    serve_launches, serve = phase_serve_turns(serve_net)
    # the serve engine's pools and table, for the kernels' timing
    eng = GenerationEngine(serve_net, batch_size=8, max_length=1024,
                           paged=True, page_size=16, device="cuda")
    timing = phase_timing(eng)
    del eng, serve_net
    _release()
    amp_parity = phase_train_parity(amp="bfloat16")
    net, train_launches, train = phase_train_turns()
    timing.update(phase_train_timing(net))
    log("[train] " + json.dumps(dict(runs=train, parity=parity)))
    del net
    _release()
    net, amp_launches, train_amp = phase_train_turns(amp="bfloat16")
    del net
    _release()
    log("[train_amp] " + json.dumps(dict(runs=train_amp, parity=amp_parity)))
    log("[engine types] " + json.dumps(
        {"turns": MODE_TURNS, "serve": serve, "train": train,
         "train_amp": train_amp}))
    timing.update(phase_xent_timing())
    # (source, replaced TPU kernel, the path whose run gives `launches`)
    meta = {
        "paged_attention": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                            "mxnet_tpu/ops/pallas_paged_attention.py:79",
                            "serve"),
        # the prefill read (the tensor-core kernel of the same file; its
        # launches: the serve run's prefill reads)
        "paged_attention_prefill": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                                    "mxnet_tpu/ops/pallas_paged_attention.py:79",
                                    "serve"),
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
    }
    by_path = {"serve": serve_launches, "train": train_launches,
               "train_amp": amp_launches}
    kernels = []
    for name, (src, rep, path) in meta.items():
        t = timing[name]
        # one counter for both dtypes
        counter = name.removesuffix("_bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": by_path[path][counter], "launches_path": path,
            "launches_by_path": {p: c.get(counter, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": errs[name],
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
            "library": t.get("library")})
    log(f"[done] {time.perf_counter() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
