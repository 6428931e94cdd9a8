"""Runtime knobs of the port: the subset of ``mxnet_tpu/config.py`` that
the serving, training, resilience and telemetry slices read, under the
same names, types, defaults and ``MXNET_TPU_*`` (or MXNet's ``MXNET_*``)
aliases.

Switching a knob off is an explicit choice of the plain PyTorch version of
that kernel (or, for ``engine_type``, of the eager step); it is never a
fallback taken on failure.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["get", "set", "resolve"]

# name -> (type, default, env aliases, doc)
_KNOBS: Dict[str, tuple] = {
    # On the TPU this knob defaults off because XLA fuses the plain
    # composition itself. Eager PyTorch fuses nothing: the plain version is
    # six launches with f32 intermediates in device memory, so the port
    # routes LayerNorm through its one-pass kernel by default.
    "fused_layernorm": (bool, True, ("MXNET_TPU_FUSED_LAYERNORM",),
                        "route LayerNorm through the CUDA kernel "
                        "(off = the plain PyTorch composition)"),
    "paged_attention_kernel": (bool, True, ("MXNET_TPU_PAGED_ATTENTION_KERNEL",),
                               "cached (dense and paged) attention reads "
                               "through the CUDA page-table kernel (off = "
                               "the plain PyTorch version)"),
    "flash_attention": (bool, True, ("MXNET_TPU_FLASH_ATTENTION",),
                        "unmasked full-sequence attention through the "
                        "flash kernels (off = the plain einsum path, "
                        "_reference_mha)"),
    "flash_pallas_bwd": (bool, True, ("MXNET_TPU_FLASH_PALLAS_BWD",),
                         "flash backward through the dK/dV and dQ CUDA "
                         "kernels (off = the plain PyTorch FlashAttention-2 "
                         "backward)"),
    # On the TPU this knob defaults off because XLA already fuses the plain
    # Adam chain into one pass. Eager PyTorch fuses nothing: the plain update
    # is about ten elementwise launches per parameter (292 parameters at
    # gpt2_345m), each a full pass over device memory, so the port routes
    # TrainStep's update through the one multi-tensor kernel by default.
    "fused_adam": (bool, True, ("MXNET_TPU_FUSED_ADAM",),
                   "Adam updates through the multi-tensor CUDA kernel, one "
                   "launch for all parameters (off = the plain per-tensor "
                   "PyTorch update)"),
    # On the TPU this knob defaults off because XLA fuses the log_softmax ->
    # pick composition and its gradient. Eager PyTorch materialises the
    # (N, C) f32 log-softmax and then its (N, C) gradient in several passes
    # (at an LM head, N·C = 4096 × 50257: 0.8 GB each), so the port routes
    # SoftmaxCrossEntropyLoss through the one-pass kernels by default.
    "fused_softmax_xent": (bool, True, ("MXNET_TPU_FUSED_SOFTMAX_XENT",),
                           "sparse-label SoftmaxCrossEntropyLoss through the "
                           "CUDA forward and backward kernels (off = the "
                           "log_softmax -> pick composition)"),
    # MXNet's engine switch. In the JAX package 'naive' turns jit off; here
    # the default runs each engine and TrainStep step as one captured CUDA
    # graph (the port's compiled step program) and 'naive' runs it eagerly,
    # kernel by kernel. Read when an engine or a TrainStep is built.
    "engine_type": (str, "graph", ("MXNET_ENGINE_TYPE",),
                    "'graph': one captured CUDA graph per step signature, "
                    "replayed from static buffers; 'naive': the eager step"),
    "storage_fallback_warn": (bool, True, ("MXNET_STORAGE_FALLBACK_WARN",),
                              "warn (once per op) when a sparse input is "
                              "densified at an op boundary that has no "
                              "sparse handler"),
    # -- fault injection and retries (resilience/faults.py, retry.py) -------
    "faults": (str, "", ("MXNET_TPU_FAULTS",),
               "fault-injection spec armed at first use, e.g. "
               "'gen.decode:every=5;gen.verify:on=2:times=2;seed=7' — "
               "deterministic failures at named sites for chaos testing"),
    "retry_max_attempts": (int, 3, ("MXNET_TPU_RETRY_MAX_ATTEMPTS",),
                           "attempts per retried site before RetryError"),
    "retry_base_delay": (float, 0.05, ("MXNET_TPU_RETRY_BASE_DELAY",),
                         "first backoff delay in seconds"),
    "retry_max_delay": (float, 2.0, ("MXNET_TPU_RETRY_MAX_DELAY",),
                        "backoff ceiling in seconds"),
    "retry_jitter": (float, 0.25, ("MXNET_TPU_RETRY_JITTER",),
                     "max fractional jitter added to each backoff delay"),
    "retry_timeout": (float, 0.0, ("MXNET_TPU_RETRY_TIMEOUT",),
                      "per-site wall-clock budget across all attempts of "
                      "one call, seconds (0 = unlimited)"),
    # -- checkpoints (checkpoint.py) -----------------------------------------
    "ckpt_keep_last": (int, 0, ("MXNET_TPU_CKPT_KEEP_LAST",),
                       "retention sweep after each save_train_state: keep "
                       "the newest N committed checkpoints (0 = keep all)"),
    "ckpt_sharded": (bool, False, ("MXNET_TPU_CKPT_SHARDED",),
                     "force the world-size-agnostic npz-shards checkpoint "
                     "format (not ported yet: True raises MXNetError)"),
    # -- serving resilience (inference/batcher.py, resilience/serving.py) ----
    "serve_default_deadline": (float, 0.0, ("MXNET_TPU_SERVE_DEADLINE",),
                               "default per-request deadline in seconds "
                               "applied at submit when the caller passes "
                               "none (0 = no deadline)"),
    "serve_max_queue": (int, 0, ("MXNET_TPU_SERVE_MAX_QUEUE",),
                        "bounded admission queue: submits past this depth "
                        "are shed per serve_queue_policy (0 = unbounded)"),
    "serve_queue_policy": (str, "reject", ("MXNET_TPU_SERVE_QUEUE_POLICY",),
                           "full-queue policy: 'reject' sheds the NEW "
                           "request; 'shed' evicts the oldest queued "
                           "request already past its deadline (falls back "
                           "to reject when none is)"),
    "serve_shed_page_floor": (int, 0, ("MXNET_TPU_SERVE_SHED_PAGE_FLOOR",),
                              "load-shed watermark: with a backlog queued, "
                              "shed new submits while free KV pages are "
                              "below this floor (0 = off)"),
    # the batcher's admission aging guard, as in the JAX package
    "serve_head_aging_steps": (int, 8, ("MXNET_TPU_SERVE_HEAD_AGING_STEPS",),
                               "admission aging guard: after this many "
                               "step-boundary deferrals of the queue head "
                               "on free pages, freed pages are reserved "
                               "for the head and bypass admission stops "
                               "(0 = off)"),
    "serve_spec_window": (int, 8, ("MXNET_TPU_SERVE_SPEC_WINDOW",),
                          "speculative accept-rate window (rounds) the "
                          "degradation governor decides on"),
    "serve_spec_floor": (float, 0.125, ("MXNET_TPU_SERVE_SPEC_FLOOR",),
                         "windowed accept rate below which speculation "
                         "falls back to plain paged decode (break-even "
                         "is ~1/speculate_k)"),
    "serve_spec_cooldown": (int, 16, ("MXNET_TPU_SERVE_SPEC_COOLDOWN",),
                            "plain decode steps before a fallen-back "
                            "engine re-arms speculation"),
    "serve_watchdog_s": (float, 0.0, ("MXNET_TPU_SERVE_WATCHDOG_S",),
                         "soft per-dispatch timeout for the serving loop: "
                         "a dispatch exceeding it emits gen_stuck_dispatch "
                         "(event + counter) instead of hanging silently "
                         "(0 = off)"),
    # -- telemetry (observability/) ------------------------------------------
    "telemetry": (bool, False, ("MXNET_TPU_TELEMETRY",),
                  "arm hot-path telemetry at first use: the engine's "
                  "histograms + the JSONL event log (off = one bool check "
                  "per instrumented call)"),
    "telemetry_dir": (str, "", ("MXNET_TPU_TELEMETRY_DIR",),
                      "run directory for events-h{host}.jsonl + metrics.json/"
                      ".prom exports (empty = a new directory of this "
                      "process's own under the temporary directory, which "
                      "honours TMPDIR)"),
    "telemetry_rotate_mb": (int, 64, ("MXNET_TPU_TELEMETRY_ROTATE_MB",),
                            "event-log rotation threshold per file (rotated "
                            "segments are gzip-compressed)"),
    "events_keep_bytes": (int, 0, ("MXNET_TPU_EVENTS_KEEP_BYTES",),
                          "cap on total bytes of retained rotated event-log "
                          "segments (.jsonl.N.gz); 0 = keep exactly one "
                          "rotated segment"),
}

#: the values a str knob may take; any other raises
_CHOICES: Dict[str, tuple] = {"engine_type": ("graph", "naive")}

_values: Dict[str, Any] = {}


def _parse(name, raw):
    typ = _KNOBS[name][0]
    if typ is bool:
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    value = typ(raw)
    if name in _CHOICES and value not in _CHOICES[name]:
        raise ValueError(f"knob {name!r} takes one of {_CHOICES[name]}, got "
                         f"{raw!r}")
    return value


def get(name: str):
    if name not in _KNOBS:
        raise KeyError(f"unknown knob {name!r}")
    if name in _values:
        return _values[name]
    _, default, envs, _ = _KNOBS[name]
    for env in envs:
        if env in os.environ:
            return _parse(name, os.environ[env])
    return default


def set(name: str, value) -> None:  # noqa: A001 - mirrors mxnet_tpu.config.set
    if name not in _KNOBS:
        raise KeyError(f"unknown knob {name!r}")
    _values[name] = _parse(name, value)


def resolve(name: str, value=None):
    """``value`` checked as the knob's own values are (a bad one raises
    ValueError), or the knob's value when ``value`` is None: for an entry
    point's argument that overrides a knob."""
    if name not in _KNOBS:
        raise KeyError(f"unknown knob {name!r}")
    return get(name) if value is None else _parse(name, value)
