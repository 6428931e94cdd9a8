"""ctypes loader of the shared C++ data runtime (``native/``) for the
port's image data path.

Counterpart of the image half of ``mxnet_tpu/native.py``. The port builds
the two sources its data path calls, ``native/src/jpeg.cc`` (the baseline
JPEG decoder) and ``native/src/runtime.cc`` (the uint8 bilinear resize and
the threaded HWC uint8 to CHW float32 batch assembly), with ``g++`` and
``native/Makefile``'s flags into its own library under
``mxnet_tpu_torch/_build/``, once per source content, at first use. It
never writes into ``mxnet_tpu/_native/`` and loads nothing of the JAX
package. Both packages run the same C++ code, so their pixels are equal.

There is no fallback: a missing compiler or a failed build raises
:class:`MXNetError`, and nothing decodes with another library instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .base import MXNetError

__all__ = ["lib", "build", "jpeg_decode", "image_resize",
           "batch_to_chw_float"]

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: the sources of the data path (``native/Makefile`` builds them with the
#: runtime's other sources into ``libmxtpu.so``)
SOURCES = ("src/jpeg.cc", "src/runtime.cc")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise MXNetError(f"{cxx} not found: the image data path builds "
                         f"native/src/{{jpeg,runtime}}.cc at first use")
    return found


def _lib_path(cxx: str) -> Path:
    h = hashlib.sha256()
    headers = sorted((NATIVE / "src").glob("*.h")) + \
        sorted((NATIVE / "include").glob("*.h*"))
    for src in [NATIVE / s for s in SOURCES] + headers:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join((cxx,) + CXXFLAGS).encode())
    return BUILD_DIR / f"libmxtpu_data-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the data path's sources if their library is not built yet;
    return its path."""
    if not all((NATIVE / s).exists() for s in SOURCES):
        raise MXNetError(f"the native sources {SOURCES} are missing under "
                         f"{NATIVE}")
    cxx = _cxx()
    path = _lib_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), *(str(NATIVE / s)
                                              for s in SOURCES)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise MXNetError(f"building the native data runtime failed "
                         f"({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    with _lock:
        if _LIB is None:
            L = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            L.MXTPUImageResize.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, u8p, ctypes.c_int,
                                           ctypes.c_int]
            L.MXTPUBatchToCHWFloat.argtypes = [u8p] + [ctypes.c_int] * 4 + \
                [f32p, f32p, f32p, ctypes.c_int]
            L.MXTPUImdecode.restype = ctypes.c_int
            L.MXTPUImdecode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(u8p)]
            L.MXTPUImageFree.argtypes = [u8p]
            L.MXTPUJpegLastError.restype = ctypes.c_char_p
            _LIB = L
    return _LIB


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def jpeg_decode(buf: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> HWC RGB uint8. The C call releases the GIL
    for the whole decode, so decoding threads run in parallel."""
    L = lib()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    out = ctypes.POINTER(ctypes.c_uint8)()
    buf = bytes(buf)
    if L.MXTPUImdecode(buf, len(buf), ctypes.byref(h), ctypes.byref(w),
                       ctypes.byref(c), ctypes.byref(out)) != 0:
        raise MXNetError(f"JPEG decode failed: "
                         f"{L.MXTPUJpegLastError().decode()}")
    try:
        return np.ctypeslib.as_array(
            out, shape=(h.value, w.value, c.value)).copy()
    finally:
        L.MXTPUImageFree(out)


def image_resize(src, oh: int, ow: int) -> np.ndarray:
    """Bilinear HWC uint8 resize to (oh, ow) (``jax.image.resize``'s
    "linear" coordinates without antialiasing, cv2.INTER_LINEAR's)."""
    L = lib()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    h, w, c = src.shape
    dst = np.empty((int(oh), int(ow), c), np.uint8)
    L.MXTPUImageResize(_u8p(src), h, w, c, _u8p(dst), int(oh), int(ow))
    return dst


def batch_to_chw_float(batch_hwc_u8, mean=None, std=None,
                       nthreads: int = 4) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, C, H, W) float32 with per-channel
    ``(x - mean) / std`` (scalars broadcast), threaded in C++."""
    L = lib()
    src = np.ascontiguousarray(batch_hwc_u8, dtype=np.uint8)
    n, h, w, c = src.shape

    def chanvec(v, what):
        if v is None:
            return None
        arr = np.broadcast_to(np.asarray(v, np.float32), (c,)) \
            if np.ndim(v) == 0 else np.asarray(v, np.float32)
        if arr.shape != (c,):
            raise ValueError(f"{what} must be a scalar or length-{c} "
                             f"per-channel sequence, got shape {arr.shape}")
        return np.ascontiguousarray(arr)

    mean_v = chanvec(mean, "mean")
    std_v = chanvec(std, "std")
    std_inv = None if std_v is None else np.ascontiguousarray(1.0 / std_v)
    f32p = ctypes.POINTER(ctypes.c_float)
    dst = np.empty((n, c, h, w), np.float32)
    L.MXTPUBatchToCHWFloat(
        _u8p(src), n, h, w, c,
        None if mean_v is None else mean_v.ctypes.data_as(f32p),
        None if std_inv is None else std_inv.ctypes.data_as(f32p),
        dst.ctypes.data_as(f32p), int(nthreads))
    return dst
