"""Imperative autograd: ``record()`` / ``backward()`` over ``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py``. The JAX package records a
replay tape and differentiates it with ``jax.vjp``; here an ``mx.nd`` op
(or the outermost call of a ``gluon.Block`` on NDArrays) runs with
PyTorch's grad mode on inside :func:`record` and off outside it, so only
recorded ops build a graph, and :func:`backward` is one
``torch.autograd.grad`` over every live attached leaf.

MXNet's gradient semantics are kept on top of PyTorch's accumulating
``.grad``:

- ``grad_req="write"`` overwrites a leaf's gradient at every backward,
  ``"add"`` accumulates into it until ``zero_grad``, and ``"null"`` (a
  ``requires_grad=False`` tensor) has none;
- a head without a head gradient takes ones, whatever its shape (a (B,)
  loss needs no ``.sum()``);
- a backward that reaches no attached leaf raises ``ValueError``, as it
  does when its head was computed outside :func:`record`;
- leaves the backward does not reach keep their gradient.

Dropout follows :func:`is_training` (the ``train_mode`` of ``record``)
under the imperative call; ``TrainStep`` and the generation engine keep
``torch.nn.Module.training`` (``gluon/nn/basic_layers.py``).
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad", "mark_variables", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()

# the attached leaves: id -> tensor, each carrying ``_mx_grad_req``
_LEAVES: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
    weakref.WeakValueDictionary()
_LEAVES_LOCK = threading.Lock()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


class _RecordScope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training

    def __enter__(self):
        self._saved = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._saved


def record(train_mode: bool = True):
    """``with autograd.record():`` records ops (and sets the train mode)."""
    return _RecordScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordScope(False, train_mode)


def train_mode():
    return _RecordScope(None, True)


def predict_mode():
    return _RecordScope(None, False)


def attach(tensor: torch.Tensor, grad_req: str = "write") -> None:
    """Make ``tensor`` (a leaf) an attached variable with ``grad_req``."""
    if grad_req not in ("write", "add", "null"):
        raise ValueError(f"grad_req must be 'write', 'add' or 'null', got "
                         f"{grad_req!r}")
    tensor._mx_grad_req = grad_req
    if grad_req == "null":
        if tensor.is_leaf:
            tensor.requires_grad_(False)
        return
    if tensor.is_floating_point():
        tensor.requires_grad_(True)
    with _LEAVES_LOCK:
        _LEAVES[id(tensor)] = tensor


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach ``variables`` with preallocated ``gradients``: a backward
    writes (or adds) into each gradient's storage."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        t = v._data
        attach(t, req)
        buf = g._data if hasattr(g, "_data") else g
        t._mx_grad_buf = buf
        t.grad = buf


def _attached():
    with _LEAVES_LOCK:
        return [t for t in _LEAVES.values()
                if t.requires_grad and getattr(t, "_mx_grad_req", "null")
                != "null"]


def _raw(x):
    return x._data if hasattr(x, "_data") else x


def _head_grads(heads, head_grads):
    if head_grads is None:
        return [torch.ones_like(h) for h in heads]
    return [torch.ones_like(h) if g is None else
            torch.as_tensor(_raw(g), dtype=h.dtype, device=h.device)
            for h, g in zip(heads, head_grads)]


def _store(leaf, g):
    """A new gradient ``g`` for ``leaf`` under its ``grad_req`` (made
    contiguous: autograd may return an expanded view)."""
    g = g.to(leaf.dtype).contiguous()
    buf = getattr(leaf, "_mx_grad_buf", None)
    if leaf._mx_grad_req == "add" and leaf.grad is not None:
        leaf.grad.add_(g)
    elif buf is not None:
        buf.copy_(g)
        leaf.grad = buf
    else:
        leaf.grad = g


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (NDArrays) with respect to every attached
    leaf they reach, stored per ``grad_req``."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    hs = [_raw(h) for h in heads]
    leaves = _attached()
    if not leaves or not any(h.requires_grad for h in hs):
        raise ValueError("backward: no arrays with attach_grad() are "
                         "reachable from the given heads")
    live = [(h, g) for h, g in zip(hs, _head_grads(hs, head_grads))
            if h.requires_grad]
    with torch.enable_grad():
        grads = torch.autograd.grad([h for h, _ in live],
                                    leaves, [g for _, g in live],
                                    retain_graph=retain_graph,
                                    allow_unused=True)
    if all(g is None for g in grads):
        raise ValueError("backward: no arrays with attach_grad() are "
                         "reachable from the given heads")
    with torch.no_grad():
        for leaf, g in zip(leaves, grads):
            if g is not None:
                _store(leaf, g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    NDArrays (nothing is stored). ``create_graph=True`` records the
    gradient computation, so a later ``grad``/``backward`` differentiates
    through it."""
    from .ndarray import NDArray

    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if not isinstance(variables, (list, tuple)):
        variables = [variables]
    hs = [_raw(h) for h in heads]
    vs = [_raw(v) for v in variables]
    with torch.enable_grad():
        gs = torch.autograd.grad(hs, vs, _head_grads(hs, head_grads),
                                 retain_graph=retain_graph,
                                 create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v) if g is None else g)
            for v, g in zip(vs, gs)]


class Function:
    """A user-defined differentiable function: ``forward`` on NDArrays
    defines the result, ``backward`` the gradients of the inputs. Runs as
    one ``torch.autograd.Function``; state stashed on ``self`` in
    ``forward`` is visible to ``backward``."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray

        fn_self = self

        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *raws):
                with torch.no_grad():
                    outs = fn_self.forward(*[NDArray(r) for r in raws])
                outs = outs if isinstance(outs, (list, tuple)) else (outs,)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *gs):
                with torch.no_grad():
                    in_grads = fn_self.backward(*[NDArray(g) for g in gs])
                in_grads = in_grads if isinstance(in_grads, (list, tuple)) \
                    else (in_grads,)
                return tuple(g._data for g in in_grads)

        raws = [x._data for x in inputs]
        with torch.set_grad_enabled(is_recording()):
            outs = _Fn.apply(*raws)
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)
