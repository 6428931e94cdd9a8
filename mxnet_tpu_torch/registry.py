"""Central operator registry.

Counterpart of ``mxnet_tpu/registry.py``: one table of named operators
from which ``mx.nd.*`` (and the ``F`` that ``HybridBlock.hybrid_forward``
receives) is generated. An op here is a function of ``torch.Tensor``s
(``fn(*tensors, **params)``); its gradient is PyTorch autograd's, and the
ops that have a hand-written kernel (``LayerNorm``, ``multi_head_attention``,
...) reach the same wrappers the models call. :func:`register_sparse`
attaches a handler for row-sparse or CSR inputs to an op name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

__all__ = ["OpDef", "register", "get", "list_ops", "alias",
           "register_sparse", "get_sparse"]


@dataclasses.dataclass(eq=False)
class OpDef:
    name: str
    fn: Callable  # (*tensors, **params) -> tensor | tuple(tensors)
    nout: int = 1
    aliases: Sequence[str] = ()
    doc: Optional[str] = None
    #: draws from the random generators (Dropout, the samplers)
    stochastic: bool = False

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


_REGISTRY: Dict[str, OpDef] = {}


def register(name, *, nout=1, aliases=(), stochastic=False):
    """Decorator: register a function of tensors as a named operator."""

    def deco(fn):
        op = OpDef(name=name, fn=fn, nout=nout, aliases=tuple(aliases),
                   doc=fn.__doc__, stochastic=stochastic)
        for n in (name, *aliases):
            if n in _REGISTRY:
                raise ValueError(f"operator {n!r} registered twice")
            _REGISTRY[n] = op
        return fn

    return deco


def alias(existing: str, *names: str) -> None:
    op = _REGISTRY[existing]
    for n in names:
        _REGISTRY[n] = op


# storage-type dispatch: an op may have a handler for sparse inputs
# (``ndarray/sparse.py``); ``nd.invoke`` consults it when an input is
# sparse and densifies the inputs when there is none or it returns
# NotImplemented for the storage types it was given
_SPARSE_FNS: Dict[str, Callable] = {}


def register_sparse(name: str):
    """Decorator: attach a sparse-storage handler to an op name. The
    handler takes the op's NDArray-level arguments and returns an NDArray
    (dense or sparse), or NotImplemented to have the inputs densified."""

    def deco(fn):
        _SPARSE_FNS[name] = fn
        return fn

    return deco


def get_sparse(name: str):
    return _SPARSE_FNS.get(name)


def get(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise AttributeError(f"operator {name!r} is not registered") from None


def list_ops():
    return sorted(set(_REGISTRY))
