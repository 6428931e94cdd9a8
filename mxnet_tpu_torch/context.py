"""Device context: ``mx.cpu()``, ``mx.gpu(i)`` and ``with ctx:`` scopes.

Counterpart of ``mxnet_tpu/context.py``. A :class:`Context` names a
``torch.device``; ``gpu(i)`` is CUDA device ``i``. The default context is
``gpu(0)``, the port's rule that entry points run on the card: allocating
on it without a card raises, and the CPU is taken only when the caller
names it (``mx.cpu()``, or a ``with mx.cpu():`` scope). The JAX package's
default is ``cpu(0)`` and its ``gpu()`` names the accelerator it has.
"""
from __future__ import annotations

import threading

import torch

from .base import resolve_device

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]

_DEVTYPE_COMPAT = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}


class Context:
    """A named device. ``device_typeid`` keeps MXNet's integer encoding."""

    _tls = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = "gpu" if device_type.type == "cuda" else \
                device_type.type
        device_type = str(device_type).lower()
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in _DEVTYPE_COMPAT:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device``; for ``gpu`` without a card this raises."""
        if self.device_type.startswith("cpu"):
            return torch.device("cpu")
        return resolve_device(f"cuda:{self.device_id}")

    @property
    def device_typeid(self) -> int:
        return _DEVTYPE_COMPAT[self.device_type]

    def __enter__(self):
        stack = getattr(Context._tls, "stack", None)
        if stack is None:
            stack = Context._tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._tls.stack.pop()

    def __eq__(self, other):
        return isinstance(other, Context) and \
            other.device_type == self.device_type and \
            other.device_id == self.device_id

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(0)``."""
    stack = getattr(Context._tls, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)


def as_device(ctx=None) -> torch.device:
    """``ctx`` (a Context, a torch.device, a device string or None for the
    current context) as a ``torch.device``, raising for a card that is not
    there."""
    if ctx is None:
        return current_context().torch_device
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise ValueError("the port places each parameter on one device; "
                             f"got {len(ctx)} contexts")
        ctx = ctx[0]
    if isinstance(ctx, Context):
        return ctx.torch_device
    return resolve_device(ctx)
