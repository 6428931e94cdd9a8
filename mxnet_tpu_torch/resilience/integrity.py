"""Checkpoint integrity: manifests, validation, atomic commits, retention.

A copy of ``mxnet_tpu/resilience/integrity.py`` on numpy, ``hashlib`` and
torch. A checkpoint directory is only *real* once it has been atomically
renamed into place (``ckpt-{step}.tmp`` -> ``ckpt-{step}`` via
``os.replace``) and carries a ``manifest.json`` describing exactly what a
reader should find:

  {"format": "npz",
   "files":  {"arrays.npz": {"sha256": ..., "size": ...}, ...},
   "arrays": {"0": {"sha256": ..., "shape": [...], "dtype": "float32"}, ...}}

``files`` lets ``latest_checkpoint`` validate candidates *cheaply* (stat +
hash, no deserialization); ``arrays`` lets ``load_train_state`` verify each
restored array end to end (sha256 over its host bytes).

:func:`array_digest` hashes what the JAX package hashes: the C-order host
bytes of the array in its stored dtype. A torch tensor is hashed through
its host copy, a bfloat16 one through its raw 2-byte records (numpy has no
bfloat16; the JAX package's ml_dtypes array holds the same bytes), so
each package verifies the other's manifests.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
from typing import Dict, List, Optional

import numpy as np

__all__ = ["CheckpointCorruptError", "array_digest", "host_array",
           "dtype_name", "file_digest", "build_manifest", "write_manifest",
           "read_manifest", "verify_files", "verify_arrays", "commit_dir",
           "atomic_file_write", "list_checkpoints", "sweep_retention",
           "MANIFEST_NAME"]

logger = logging.getLogger("mxnet_tpu_torch.resilience.integrity")

MANIFEST_NAME = "manifest.json"
_CKPT_RE = re.compile(r"ckpt-(\d+)")


class CheckpointCorruptError(IOError):
    """A checkpoint failed manifest validation; carries the mismatches.

    ``retryable = False``: corruption is deterministic — re-reading the
    same bytes cannot heal it, so ``retry_call`` re-raises it unwrapped
    instead of burning the backoff budget and surfacing a ``RetryError``.
    """

    retryable = False

    def __init__(self, path: str, problems: List[str]):
        super().__init__(f"corrupt checkpoint {path}: " + "; ".join(problems))
        self.path = path
        self.problems = problems


def host_array(a) -> np.ndarray:
    """``a`` (a torch tensor, a numpy array or anything ``np.asarray``
    takes) as a C-order host numpy array of its bytes; a bfloat16 tensor
    becomes ``|V2`` records, as ``np.savez`` writes an ml_dtypes
    bfloat16 array."""
    try:
        import torch
    except ImportError:  # pragma: no cover - the port always has torch
        torch = None
    if torch is not None and torch.is_tensor(a):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.ascontiguousarray(np.asarray(a))


def dtype_name(a) -> str:
    """The dtype a manifest records for ``a``: numpy's name, and
    ``"bfloat16"`` for a bfloat16 tensor (the name ml_dtypes gives)."""
    try:
        import torch
    except ImportError:  # pragma: no cover
        torch = None
    if torch is not None and torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=a.dtype).numpy().dtype)
    return str(np.asarray(a).dtype)


def array_digest(a) -> str:
    """sha256 of the host-side bytes of an array (C-order, native layout)."""
    return hashlib.sha256(host_array(a).tobytes()).hexdigest()


def _host_digests(hosts) -> List[str]:
    """sha256 of each host array, on a few threads (``hashlib`` releases
    the GIL over large buffers): a checkpoint's arrays are hashed at every
    save and every verified load."""
    if len(hosts) < 2:
        return [hashlib.sha256(h.tobytes()).hexdigest() for h in hosts]
    from concurrent.futures import ThreadPoolExecutor

    def one(h):
        return hashlib.sha256(memoryview(np.ascontiguousarray(h)).cast(
            "B")).hexdigest()

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(one, hosts))


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def build_manifest(flat_arrays, fmt: str, dirpath: str,
                   files: Optional[List[str]] = None,
                   specs: Optional[List] = None,
                   dtypes: Optional[List[str]] = None) -> dict:
    """Manifest dict for the flat leaf list + the named payload files.
    ``specs`` (parallel to ``flat_arrays``) records each array's partition
    spec; on one device every spec is None. ``dtypes`` names the leaves'
    dtypes when ``flat_arrays`` are their :func:`host_array` forms (whose
    bfloat16 leaves read ``|V2``)."""
    manifest: dict = {"format": fmt, "files": {}, "arrays": {}}
    for name in files or ():
        p = os.path.join(dirpath, name)
        manifest["files"][name] = {"sha256": file_digest(p),
                                   "size": os.path.getsize(p)}
    hosts = [host_array(a) for a in flat_arrays]
    digests = _host_digests(hosts)
    for i, (a, host) in enumerate(zip(flat_arrays, hosts)):
        manifest["arrays"][str(i)] = {
            "sha256": digests[i],
            "shape": list(host.shape),
            "dtype": dtypes[i] if dtypes is not None else dtype_name(a),
            "spec": specs[i] if specs is not None else None,
        }
    return manifest


def write_manifest(dirpath: str, manifest: dict) -> None:
    with open(os.path.join(dirpath, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def read_manifest(dirpath: str) -> Optional[dict]:
    p = os.path.join(dirpath, MANIFEST_NAME)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def verify_files(dirpath: str, manifest: dict) -> List[str]:
    """Cheap validation pass: every manifest-listed file exists with the
    recorded size and sha256. Returns a list of problems (empty = clean)."""
    problems = []
    for name, info in manifest.get("files", {}).items():
        p = os.path.join(dirpath, name)
        if not os.path.exists(p):
            problems.append(f"missing file {name}")
            continue
        size = os.path.getsize(p)
        if size != info.get("size"):
            problems.append(f"size mismatch for {name}: "
                            f"{size} != {info.get('size')}")
            continue
        if file_digest(p) != info.get("sha256"):
            problems.append(f"sha256 mismatch for {name}")
    return problems


def verify_arrays(flat_arrays, manifest: dict) -> List[str]:
    """Deep validation: bit-level per-array digests of restored leaves."""
    recorded: Dict[str, dict] = manifest.get("arrays", {})
    problems = []
    if len(recorded) != len(flat_arrays):
        problems.append(f"array count mismatch: {len(flat_arrays)} restored "
                        f"!= {len(recorded)} in manifest")
        return problems
    digests = _host_digests([host_array(a) for a in flat_arrays])
    for i, digest in enumerate(digests):
        info = recorded.get(str(i))
        if info is None:
            problems.append(f"array {i} missing from manifest")
        elif digest != info["sha256"]:
            problems.append(f"array {i} sha256 mismatch")
    return problems


def commit_dir(tmp_path: str, final_path: str) -> None:
    """Atomically publish ``tmp_path`` as ``final_path``.

    ``os.replace`` of a directory is atomic on POSIX only when the target
    does not exist, so a previous ``final_path`` is moved aside to
    ``.stale`` and removed after the rename succeeds. A crash between the
    two renames leaves only the ``.stale`` copy — ``list_checkpoints``
    recovers it, so that window can delay but never lose the previous good
    checkpoint.
    """
    stale = None
    if os.path.exists(final_path):
        stale = final_path + ".stale"
        shutil.rmtree(stale, ignore_errors=True)
        os.replace(final_path, stale)
    os.replace(tmp_path, final_path)
    if stale is not None:
        shutil.rmtree(stale, ignore_errors=True)


def atomic_file_write(path: str, data: bytes) -> None:
    """Write a single file so readers see the old bytes or the new bytes,
    never a truncated middle state (tmp + fsync + ``os.replace``)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def list_checkpoints(directory: str) -> List[tuple]:
    """(step, path) pairs of *committed* ``ckpt-N`` dirs, newest first.
    ``.tmp`` leftovers from interrupted saves never match; an orphaned
    ``ckpt-N.stale`` (crash inside commit_dir's two-rename window) is
    recovered by renaming it back into place first."""
    if not os.path.isdir(directory):
        return []
    for name in os.listdir(directory):
        if name.endswith(".stale"):
            base = name[:-len(".stale")]
            if _CKPT_RE.fullmatch(base) and \
                    not os.path.exists(os.path.join(directory, base)):
                logger.warning("recovering orphaned checkpoint %s from %s",
                               base, name)
                os.replace(os.path.join(directory, name),
                           os.path.join(directory, base))
    out = []
    for name in os.listdir(directory):
        m = _CKPT_RE.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def sweep_retention(directory: str, keep_last: int) -> List[str]:
    """Keep the newest ``keep_last`` committed checkpoints (``keep_last < 1``
    = keep all) and remove interrupted-save ``.tmp``/``.stale`` debris
    regardless. Returns removed paths."""
    removed = []
    # list first: it recovers any orphaned .stale back to committed, so the
    # debris pass below only ever deletes true leftovers
    ckpts = list_checkpoints(directory)
    if keep_last >= 1:
        for _step, path in ckpts[keep_last:]:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.endswith((".tmp", ".stale")) and \
                    _CKPT_RE.fullmatch(name.rsplit(".", 1)[0]):
                p = os.path.join(directory, name)
                shutil.rmtree(p, ignore_errors=True)
                removed.append(p)
    if removed:
        logger.info("retention sweep removed %d entries under %s",
                    len(removed), directory)
    return removed
