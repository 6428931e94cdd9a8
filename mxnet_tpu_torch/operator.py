"""``mx.operator``: user-defined operators (CustomOp).

Counterpart of ``mxnet_tpu/operator.py`` (MXNet's ``python/mxnet/
operator.py``). A registered :class:`CustomOpProp` describes the op; its
:class:`CustomOp` computes ``forward`` and ``backward`` on NDArrays. Here
the op is one ``torch.autograd.Function`` (the JAX package's
``jax.custom_vjp``): its forward runs the user's ``forward``, and its
backward makes a fresh operator, runs its ``forward`` again and then the
user's ``backward``, so the autograd graph keeps only the inputs. An op
written in ``nd`` ops that reads nothing back to the host runs inside a
captured step (``StepGraph``) like any other.
"""
from __future__ import annotations

from typing import Dict, List, Type

import torch

from . import autograd as _ag
from .base import MXNetError, dtype_name, dtype_torch

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_class"]


class CustomOp:
    """Base class of user ops (``mx.operator.CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honoring the write/add/null request."""
        if req == "null":
            return
        raw = src._data if hasattr(src, "_data") else src
        if req == "add":
            dst._data = dst._data + raw
        else:  # write / inplace
            dst._data = raw


class CustomOpProp:
    """Shape/type inference and the operator factory (``CustomOpProp``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, shapes, dtypes) -> CustomOp:
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        return list(out_grad) + list(in_data) + list(out_data)


_CUSTOM_PROPS: Dict[str, Type[CustomOpProp]] = {}


def register(reg_name):
    """Decorator registering a CustomOpProp under ``op_type=reg_name``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError(f"{prop_cls} must subclass CustomOpProp")
        # registered when the user's module is imported, as in MXNet
        _CUSTOM_PROPS[reg_name] = prop_cls  # lint: disable=JH005 -- import-time registration
        return prop_cls

    return deco


def get_prop_class(op_type):
    try:
        return _CUSTOM_PROPS[op_type]
    except KeyError:
        raise MXNetError(
            f"custom op {op_type!r} is not registered; "
            f"known: {sorted(_CUSTOM_PROPS)}") from None


def make_custom_fn(op_type, kwargs):
    """``(fn, nout)`` for ``nd.Custom``/``sym.Custom``: ``fn`` takes and
    returns tensors (one, or a tuple of ``nout``) through a
    ``torch.autograd.Function`` whose forward and backward run the user's
    on NDArray views."""
    from .ndarray import NDArray

    prop = get_prop_class(op_type)(**{k: str(v) for k, v in kwargs.items()})
    n_in = len(prop.list_arguments())
    n_out = len(prop.list_outputs())

    def run_forward(raws, is_train):
        in_shapes = [list(r.shape) for r in raws]
        in_shapes, out_shapes, _aux_shapes = prop.infer_shape(in_shapes)
        in_types = [dtype_name(r.dtype) for r in raws]
        _, out_types, _ = prop.infer_type(in_types)
        op = prop.create_operator(None, in_shapes + out_shapes,
                                  in_types + out_types)
        in_data = [NDArray(r) for r in raws]
        out_data = [NDArray(torch.zeros(tuple(s), dtype=dtype_torch(t),
                                        device=raws[0].device))
                    for s, t in zip(out_shapes, out_types)]
        # the user's nd calls record nothing of their own
        with _ag.pause(train_mode=_ag.is_training()):
            op.forward(is_train, ["write"] * n_out, in_data, out_data, [])
        return op, in_data, out_data

    class _Custom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *raws):
            _, _, out_data = run_forward(raws, True)
            # only the inputs are kept: backward re-derives the outputs
            ctx.save_for_backward(*raws)
            outs = tuple(o._data for o in out_data)
            return outs if n_out > 1 else outs[0]

        @staticmethod
        def backward(ctx, *gs):
            raws = ctx.saved_tensors
            # a fresh operator re-derives the forward state for backward
            op, in_data, out_data = run_forward(raws, True)
            in_grad = [NDArray(torch.zeros_like(r)) for r in raws]
            with _ag.pause(train_mode=_ag.is_training()):
                op.backward(["write"] * n_in, [NDArray(g) for g in gs],
                            in_data, out_data, in_grad, [])
            return tuple(g._data for g in in_grad)

    def fn(*raws):
        return _Custom.apply(*raws)

    return fn, n_out
