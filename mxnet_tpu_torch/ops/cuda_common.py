"""Build, load and launch the port's hand-written CUDA kernels.

Counterpart of ``mxnet_tpu/ops/pallas_common.py``. Every ``csrc/*.cu``
source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library with a plain C interface, once per source content, into
``mxnet_tpu_torch/_build/``, and loaded with ``ctypes``. Nothing here runs
at import: the first kernel call builds what it needs, and
:func:`build` compiles every source at once, one ``nvcc`` per source, all
started together.

There is no fallback. A missing ``nvcc``, a failed build or a device other
than compute capability 9.0 raises :class:`MXNetError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from ..base import MXNetError

__all__ = ["SOURCES", "build", "load", "check_device", "check_launch",
           "stream_ptr", "dtype_code"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: kernel sources, one shared library each
SOURCES = ("layernorm", "paged_attention", "flash_attention", "adam",
           "softmax_xent", "int8_gemm")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# dtype codes shared with csrc/common.cuh
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise MXNetError(f"kernel dtype must be float32, bfloat16 or float16, "
                         f"got {dtype}")
    return _DTYPE_CODE[dtype]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (set CUDA_HOME); the port's kernels "
                         "are built from csrc/ at first use")
    return found


def _lib_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that have no library for
    their current content yet. One ``nvcc`` process per source, all started
    together. Returns name -> library path; ``<library>.log`` holds what
    ``ptxas -v`` said (registers, shared memory, spills)."""
    names = list(SOURCES if names is None else names)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _lib_path(n, nvcc) for n in names}
    procs = {}
    for n, path in out.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    errors = []
    for n, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
    if errors:
        raise MXNetError("\n".join(errors))
    return out


def check_device(t: torch.Tensor) -> None:
    """The kernels are compiled for sm_90a only: refuse anything else."""
    if t.device.type != "cuda":
        raise MXNetError(f"kernel input on {t.device}, expected a CUDA tensor")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise MXNetError(f"kernels are built for sm_90a; device "
                         f"{torch.cuda.get_device_name(t.device)} has "
                         f"capability {cap}")


_ARGTYPES = {
    # (x, gamma, beta, y), then rows, d, eps, x dtype, gamma dtype, warps
    # (0: the block route), stream
    "mx_layernorm": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_float, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p],
    # (x, gamma, g, dx, dgamma, dbeta, partial), then rows, d, eps, x dtype,
    # gamma dtype, warps (0: the block route), blocks, stream
    "mx_layernorm_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_float]
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    # (q, k_pool, v_pool, table, position, out, part | NULL,
    # arrivals | NULL), then B, H, Tq, Ch, ps, n_pages, n_pool, split_keys,
    # n_splits, q dtype, kv dtype, stream
    "mx_paged_attention": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                          + [ctypes.c_void_p],
    # (q, k, v, o, lse | NULL), then BH, Tq, Tk, D, causal, dtype, stream
    "mx_flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p],
    # (q, k, v, do, lse, di, dk, dv), then BH, Tq, Tk, D, causal, dtype, stream
    "mx_flash_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p],
    # (q, k, v, do, lse, di, dq), then BH, Tq, Tk, D, causal, dtype, stream
    "mx_flash_bwd_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p],
    # table, n_tensors, n_chunks, lr, wd, inv_scale | NULL, skip | NULL,
    # beta1, beta2, 1 - beta1, 1 - beta2, epsilon, rescale_grad,
    # clip_gradient, stream
    "mx_adam": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
               + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 7
               + [ctypes.c_void_p],
    # (x, label, loss, stats), then n, c, dtype, stream
    "mx_xent_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p],
    # (x, label, stats, g, dx), then n, c, dtype, stream
    "mx_xent_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p],
    # (x, out, scale | NULL), then the input dtype, B, C, H, W, G, KH, KW,
    # stride h w, pad h w, dilate h w, OH, OW, K_pad, stream
    "mx_int8_im2col": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17
                      + [ctypes.c_void_p],
    # (a, w, out, data_scale, ws, bias | NULL, partial | NULL,
    # counters | NULL), then M, N, K, lda, ldw, a_group, w_group, G, P, tile
    # width, splits, out dtype, stream
    "mx_int8_gemm_wgmma": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                          + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p],
    # (a, w, out, data_scale, ws, bias | NULL), then M, N, K, lda, ldw,
    # a_group, w_group, G, P, out dtype, stream
    "mx_int8_gemm": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p],
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _ARGTYPES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            lib.mx_error_string.argtypes = [ctypes.c_int]
            lib.mx_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if the C launcher reported a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        msg = lib.mx_error_string(rc).decode()
        raise MXNetError(f"{what}: CUDA launch failed ({rc}: {msg})")
