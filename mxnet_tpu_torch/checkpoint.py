"""Checkpoint / resume of full training state: the flat ``npz`` format of
``mxnet_tpu/checkpoint.py``, file-compatible with it in both directions.

A training checkpoint is ``directory/ckpt-{step}`` holding

  - ``arrays.npz``: the leaves of ``{"params": params, "opt_state":
    opt_state}`` flattened as ``jax.tree_util`` flattens them (dict keys
    sorted, so ``opt_state`` first; tuples in order; ``None`` states
    dropped), under the keys ``"0".."n-1"``; a bfloat16 leaf as raw 2-byte
    ``|V2`` records, as ``np.savez`` writes an ml_dtypes array;
  - ``treedef.txt``: the tree's structure in ``str(PyTreeDef)`` form;
  - ``manifest.json``: per-array sha256, shape and dtype (``"bfloat16"``
    for those records) and the files' sha256 and sizes, written before the
    commit;
  - ``meta.json``: ``{"step", "world_size", ...extra}``, written last and
    fsynced;
  - ``masters.npz`` (port only, optional): the f32 masters of trainable
    low-precision parameters, keyed by the parameters' checkpoint names.
    The manifest lists it among its files (so both packages verify its
    sha256); the JAX package reads nothing else of it, and restoring such
    a checkpoint there casts the masters from the low-precision weights.

Crash safety as in the JAX package: everything lands in
``ckpt-{step}.tmp`` and one ``os.replace`` publishes it
(``resilience/integrity.py``); ``latest_checkpoint`` skips candidates that
fail validation; reads and writes are fault sites (``ckpt.save``,
``ckpt.load``) run under ``retry_call``; ``load_train_state`` verifies
every restored leaf against the manifest and raises
:class:`CheckpointCorruptError` on any mismatch. The ``ckpt_*`` telemetry
is recorded at every save and load.

Not ported: orbax, and the world-size-agnostic ``npz-shards`` format (the
``ckpt_sharded`` knob, or reading such a checkpoint, raises
``MXNetError``) — they come with the multi-device slice.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from . import config
from . import observability as _obs
from .base import MXNetError
from .resilience import faults, integrity, retry
from .resilience.integrity import CheckpointCorruptError  # noqa: F401

__all__ = ["save_train_state", "load_train_state", "load_masters",
           "latest_checkpoint", "validate_checkpoint", "checkpoint_layout",
           "tree_flatten", "tree_unflatten", "CheckpointCorruptError"]

MASTERS_NAME = "masters.npz"

logger = logging.getLogger("mxnet_tpu_torch.checkpoint")

_SHARDS_REFUSED = ("the npz-shards checkpoint format is not ported yet (it "
                   "comes with the multi-device slice)")


# -- the pytree of a training state -------------------------------------------
def tree_flatten(tree):
    """``(leaves, treedef_str)`` of nested dicts, tuples, lists and None
    over tensors or arrays, in ``jax.tree_util.tree_flatten``'s order and
    with its ``str(PyTreeDef)``."""
    leaves = []

    def rec(x):
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {rec(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, tuple):
            inner = [rec(v) for v in x]
            return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
                + ")"
        if isinstance(x, list):
            return "[" + ", ".join(rec(v) for v in x) + "]"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({rec(tree)})"


def tree_unflatten(like, leaves):
    """``leaves`` in the structure of ``like`` (the inverse of
    :func:`tree_flatten` over a tree of that structure)."""
    it = iter(leaves)

    def rec(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: rec(x[k]) for k in sorted(x)}
        if isinstance(x, (tuple, list)):
            return type(x)(rec(v) for v in x)
        return next(it)

    return rec(like)


# -- save ---------------------------------------------------------------------
def save_train_state(directory: str, step: int, params, opt_state,
                     extra: Optional[dict] = None,
                     keep_last: Optional[int] = None,
                     sharded: Optional[bool] = None,
                     layout: Optional[dict] = None,
                     masters: Optional[dict] = None) -> str:
    """Write checkpoint ``directory/ckpt-{step}``; returns the path.

    ``params`` and ``opt_state`` are dicts of tensors (or arrays); each
    leaf is copied to the host once. The write is crash-safe: all payload
    lands in ``ckpt-{step}.tmp`` and one ``os.replace`` publishes it.
    ``keep_last`` (default: the ``ckpt_keep_last`` knob; 0 = keep all)
    prunes older committed checkpoints after the commit. ``layout`` (a
    dict) is stored in the manifest's ``layout`` key. ``masters`` (a dict
    of f32 tensors, or None) goes into ``masters.npz``.
    """
    if sharded is None:
        sharded = config.get("ckpt_sharded")
    if sharded:
        raise MXNetError(f"save_train_state(sharded=True): {_SHARDS_REFUSED}")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt-{step}")
    tmp = path + ".tmp"
    flat, treedef = tree_flatten({"params": params, "opt_state": opt_state})
    dtypes = [integrity.dtype_name(a) for a in flat]
    host_flat = [integrity.host_array(a) for a in flat]
    files = ["arrays.npz", "treedef.txt"]
    host_masters = None
    if masters:
        host_masters = {k: integrity.host_array(v) for k, v in
                        sorted(masters.items())}
        files.append(MASTERS_NAME)

    def _write():
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{str(i): a for i, a in enumerate(host_flat)})
        with open(os.path.join(tmp, "treedef.txt"), "w") as f:
            f.write(treedef)
        if host_masters is not None:
            np.savez(os.path.join(tmp, MASTERS_NAME), **host_masters)
        # chaos site: a crash here leaves a torn .tmp (arrays written, no
        # manifest, no commit); latest_checkpoint never sees .tmp dirs
        faults.fire("ckpt.save")
        manifest = integrity.build_manifest(
            host_flat, "npz", tmp, files,
            specs=[None] * len(host_flat), dtypes=dtypes)
        if layout is not None:
            manifest["layout"] = layout
        integrity.write_manifest(tmp, manifest)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "world_size": 1, **(extra or {})}, f)
            f.flush()
            os.fsync(f.fileno())
        integrity.commit_dir(tmp, path)

    t0 = time.perf_counter()
    retry.retry_call(_write, site="ckpt.save")
    dt = time.perf_counter() - t0
    # checkpoint IO is rare: its telemetry is always recorded
    nbytes = _dir_bytes(path)
    _obs.histogram("ckpt_save_seconds", "checkpoint write+commit wall clock",
                   unit="s").observe(dt)
    _obs.counter("ckpt_saves_total").inc()
    _obs.counter("ckpt_bytes_total", unit="bytes").inc(nbytes, op="save")
    _obs.emit("checkpoint_save", path=path, ckpt_step=step,
              seconds=round(dt, 6), bytes=nbytes)
    # always sweep: keep=0 prunes nothing but still clears .tmp/.stale
    # debris abandoned by earlier crashed saves
    keep = keep_last if keep_last is not None \
        else config.get("ckpt_keep_last")
    integrity.sweep_retention(directory, keep)
    return path


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


# -- load ---------------------------------------------------------------------
def _as_tensor(data, dtype: Optional[str]):
    """A loaded npz array as a CPU tensor in its manifest ``dtype``. A
    bfloat16 leaf arrives as ``|V2`` records (``np.savez`` of an ml_dtypes
    array) or, where ml_dtypes is loaded, as bfloat16: its bytes are taken
    as they are (the JAX package's ``_undo_npz_void``)."""
    if dtype == "bfloat16" or str(data.dtype) == "bfloat16":
        if data.dtype.itemsize != 2:
            raise MXNetError(f"a bfloat16 leaf stored as {data.dtype}")
        raw = np.ascontiguousarray(data).view(np.int16)
        if not raw.flags.writeable:
            raw = raw.copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    if data.dtype.kind == "V":
        raise MXNetError(f"a leaf stored as raw {data.dtype} records of "
                         f"dtype {dtype!r}: the port reads bfloat16 only")
    data = np.ascontiguousarray(data)
    return torch.from_numpy(data if data.flags.writeable else data.copy())


def load_train_state(path: str, like=None):
    """Load a checkpoint: ``(params, opt_state, step)`` with CPU tensors in
    the structure of ``like`` = ``(params, opt_state)`` (a template of
    tensors or arrays; required). Restored leaves are verified against the
    manifest (per-array sha256); any mismatch raises
    :class:`CheckpointCorruptError`."""
    if like is None:
        raise MXNetError("load_train_state: an npz restore needs a template "
                         "(like=(params, opt_state))")
    template = {"params": like[0], "opt_state": like[1]}
    want, _ = tree_flatten(template)

    def _read():
        faults.fire("ckpt.load")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        try:
            mf = integrity.read_manifest(path)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                path, [f"unreadable manifest: {e}"]) from e
        if mf is not None and mf.get("format") == "npz-shards":
            raise MXNetError(f"{path}: {_SHARDS_REFUSED}")
        npz = os.path.join(path, "arrays.npz")
        if not os.path.exists(npz):
            raise MXNetError(f"{path}: no arrays.npz (an orbax checkpoint? "
                             f"the port reads the npz format only)")
        try:
            with np.load(npz) as data:
                raw = [data[str(i)] for i in range(len(data.files))]
        except (zipfile.BadZipFile, zlib.error, ValueError) as e:
            # a torn zip container is deterministic corruption, not a
            # transient read failure: surface it non-retryably
            raise CheckpointCorruptError(
                path, [f"unreadable arrays.npz: "
                       f"{type(e).__name__}: {e}"]) from e
        recorded = (mf or {}).get("arrays", {})
        flat = [_as_tensor(a, recorded.get(str(i), {}).get("dtype"))
                for i, a in enumerate(raw)]
        return flat, meta, mf

    t0 = time.perf_counter()
    flat, meta, manifest = retry.retry_call(_read, site="ckpt.load")
    verify_dt = 0.0
    if manifest is not None and manifest.get("arrays"):
        v0 = time.perf_counter()
        problems = integrity.verify_arrays(flat, manifest)
        verify_dt = time.perf_counter() - v0
        if problems:
            raise CheckpointCorruptError(path, problems)
    if len(flat) != len(want) or any(
            tuple(a.shape) != tuple(np.shape(w)) for a, w in zip(flat, want)):
        raise MXNetError(
            f"{path}: leaves {[tuple(a.shape) for a in flat][:4]}... "
            f"({len(flat)}) do not fit the template's "
            f"{[tuple(np.shape(w)) for w in want][:4]}... ({len(want)})")
    state = tree_unflatten(template, flat)
    dt = time.perf_counter() - t0
    _obs.histogram("ckpt_load_seconds", "checkpoint restore wall clock "
                   "(read + manifest verify)", unit="s").observe(dt)
    _obs.histogram("ckpt_verify_seconds", "manifest sha256 verification",
                   unit="s").observe(verify_dt)
    _obs.counter("ckpt_loads_total").inc()
    _obs.counter("ckpt_bytes_total", unit="bytes").inc(_dir_bytes(path),
                                                        op="load")
    _obs.emit("checkpoint_restore", path=path, ckpt_step=meta["step"],
              seconds=round(dt, 6), verify_seconds=round(verify_dt, 6))
    return state["params"], state["opt_state"], meta["step"]


def load_masters(path: str) -> Optional[dict]:
    """The f32 masters a port checkpoint holds (``masters.npz``), as CPU
    tensors by checkpoint name; None when it holds none (a JAX
    checkpoint, or a net without low-precision trainable parameters). The
    file is verified against the manifest's sha256 first."""
    mf = integrity.read_manifest(path)
    info = (mf or {}).get("files", {}).get(MASTERS_NAME)
    if info is None:
        return None
    problems = integrity.verify_files(path, {"files": {MASTERS_NAME: info}})
    if problems:
        raise CheckpointCorruptError(path, problems)
    with np.load(os.path.join(path, MASTERS_NAME)) as data:
        return {k: _as_tensor(data[k], None) for k in data.files}


def checkpoint_layout(path: str) -> Optional[dict]:
    """The layout record a checkpoint declared at save time, or None.
    Cheap: reads the manifest only."""
    try:
        mf = integrity.read_manifest(path)
    except (OSError, ValueError):
        return None
    return (mf or {}).get("layout")


def validate_checkpoint(path: str) -> bool:
    """Cheap is-this-checkpoint-usable check (no deserialization).

    A committed dir must have a parseable ``meta.json``; when a manifest is
    present, every listed payload file must exist with the recorded size
    and sha256. Manifest-less dirs with a valid ``meta.json`` are accepted
    as legacy checkpoints.
    """
    meta_p = os.path.join(path, "meta.json")
    try:
        with open(meta_p) as f:
            json.load(f)
        manifest = integrity.read_manifest(path)
    except (OSError, ValueError):
        return False  # unreadable/corrupt meta or manifest -> not a candidate
    if manifest is None:
        return True
    try:
        problems = integrity.verify_files(path, manifest)
    except OSError:
        return False
    if problems:
        logger.warning("checkpoint %s failed validation: %s",
                       path, "; ".join(problems))
        return False
    return True


def latest_checkpoint(directory: str, validate: bool = True) -> Optional[str]:
    """Newest *valid* ``ckpt-N`` under ``directory`` (None when none pass).
    Unverifiable candidates (``.tmp`` stages, dirs with no ``meta.json``,
    manifest mismatches) are skipped, falling back to the next-newest."""
    for _step, path in integrity.list_checkpoints(directory):
        if not validate or validate_checkpoint(path):
            return path
        logger.warning("skipping unverifiable checkpoint %s", path)
    return None
