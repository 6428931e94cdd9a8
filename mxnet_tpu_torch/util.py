"""Misc utilities (reference: ``python/mxnet/util.py``); counterpart of
``mxnet_tpu/util.py``."""
from __future__ import annotations

import os

__all__ = ["is_np_array", "use_np_shape", "makedirs"]


def is_np_array() -> bool:
    """numpy-semantics toggle; this build is always nd-semantics."""
    return False


def use_np_shape(fn):
    return fn


def makedirs(d):
    os.makedirs(d, exist_ok=True)
