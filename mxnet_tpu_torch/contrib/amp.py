"""Automatic mixed precision: the global ``init`` dtype and the policy of
``parallel.TrainStep(amp=...)``.

Counterpart of the policy half of ``mxnet_tpu/contrib/amp.py``:
:class:`Policy`, :func:`resolve_policy`, ``init``/``_reset``,
``amp_dtype``, ``compute_dtype`` and the op lists. Under a policy the
``TrainStep`` keeps the f32 master weights and runs the forward and
backward on low-precision copies of them; only float16 needs dynamic loss
scaling, since bfloat16 shares float32's exponent range. Under a global
``init`` dtype, :func:`matmul` (``ops.nn.fully_connected``, the tied LM
head of ``models.gpt2``) and ``multi_head_attention`` (full-sequence and
cached) compute their products in that dtype from f32 inputs. The host-side
``LossScaler``, ``init_trainer`` and ``scale_loss`` belong to the
imperative ``gluon.Trainer``, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

__all__ = ["init", "amp_dtype", "compute_dtype", "cast_inputs", "matmul",
           "Policy", "resolve_policy", "list_lp16_ops", "list_fp16_ops",
           "list_fp32_ops", "list_widest_type_cast_ops"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}

# process-global, as in the JAX package: TrainSteps built on other threads
# must see amp.init() too
_STATE = {"dtype": None}
_STATE_LOCK = threading.Lock()


def amp_dtype():
    """The dtype name given to :func:`init`, or None when AMP is off."""
    return _STATE["dtype"]


def compute_dtype():
    """The ``torch.dtype`` that matmul-class ops compute in, or None."""
    d = amp_dtype()
    return None if d is None else _DTYPES[d]


def cast_inputs(*tensors):
    """Cast f32 tensors to the active compute dtype (identity without AMP);
    other dtypes pass through."""
    cd = compute_dtype()
    if cd is None:
        return tensors
    return tuple(t.to(cd) if t is not None and t.dtype == torch.float32 else t
                 for t in tensors)


def matmul(a, b, data_decides=False):
    """``a @ b`` under AMP's matmul-class rule. With an active compute
    dtype the rule rounds both operands to it and multiplies them with an
    f32 sum and an f32 result, as a ``preferred_element_type=f32`` product
    (the products of the rounded values are exact in f32). It applies when
    both operands are f32, as the JAX ``dot`` (``ops/core.py``
    ``_amp_pair``), or, with ``data_decides``, when ``a`` is f32, as the
    JAX ``fully_connected``, which then rounds the weight whatever its
    dtype. Otherwise the operands are promoted to one dtype and multiplied
    as they are (``jnp.matmul``'s promotion), so ``TrainStep(amp=...)``'s
    low-precision copies pass through unchanged."""
    cd = compute_dtype()
    f32 = torch.float32
    if cd is not None and a.dtype == f32 and (data_decides or b.dtype == f32):
        return torch.matmul(a.to(cd).float(), b.to(cd).float())
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(ct), b.to(ct))


@dataclasses.dataclass(frozen=True)
class Policy:
    """The mixed-precision policy of ``TrainStep(amp=...)``: f32 master
    weights, forward and backward in ``compute_dtype``, and for float16 a
    dynamic loss scale (initial ``loss_scale``, multiplied or divided by
    ``scale_factor``, grown after ``scale_window`` good steps) kept on the
    card."""

    compute_dtype: str = "bfloat16"   # 'bfloat16' | 'float16'
    loss_scale: float = 2.0 ** 16     # initial dynamic scale (float16 only)
    scale_factor: float = 2.0
    scale_window: int = 2000

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"Policy compute_dtype must be 'bfloat16' or "
                             f"'float16', got {self.compute_dtype!r}")

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def dynamic_scaling(self) -> bool:
        """bf16 shares f32's exponent range: only float16 needs scaling."""
        return self.compute_dtype == "float16"


def resolve_policy(amp):
    """A ``TrainStep`` ``amp=`` argument as a Policy or None: ``"auto"``
    follows :func:`init` (None when AMP was never initialised),
    ``None``/``False`` disable, a dtype name or a Policy pass through."""
    if amp is None or amp is False:
        return None
    if isinstance(amp, Policy):
        return amp
    if amp == "auto":
        d = amp_dtype()
        return None if d is None else Policy(compute_dtype=d)
    if isinstance(amp, str):
        return Policy(compute_dtype=amp)
    raise TypeError(f"amp= must be 'auto', None, a dtype string, or a "
                    f"Policy, got {type(amp)}")


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP globally in ``target_dtype``. The op-list arguments are
    accepted for script compatibility, as in the JAX package."""
    if target_dtype not in _DTYPES:
        raise ValueError(f"amp.init target_dtype must be 'bfloat16' or "
                         f"'float16', got {target_dtype!r}")
    with _STATE_LOCK:
        _STATE["dtype"] = target_dtype


def _reset():
    """Disable AMP (test hook)."""
    with _STATE_LOCK:
        _STATE["dtype"] = None


# the op classes behind the policy (reference: amp/lists/symbol_fp16.py
# FP16_FUNCS / FP32_FUNCS / widest-type casts): matmul-class ops run in the
# low-precision dtype; reductions and normalizations accumulate in f32
_LP16_OPS = ["FullyConnected", "Convolution", "Deconvolution", "dot",
             "batch_dot", "linalg_gemm", "linalg_gemm2",
             "interleaved_matmul_selfatt_qk",
             "interleaved_matmul_selfatt_valatt", "multi_head_attention"]
_F32_OPS = ["softmax", "log_softmax", "SoftmaxOutput", "LayerNorm",
            "BatchNorm", "RMSNorm", "InstanceNorm", "L2Normalization",
            "norm", "sum", "mean", "exp", "log", "erf", "gammaln"]
_WIDEST_OPS = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
               "concat", "where"]


def list_lp16_ops(target_dtype="bfloat16"):
    """Ops computed in the low-precision dtype under AMP."""
    return list(_LP16_OPS)


list_fp16_ops = list_lp16_ops


def list_fp32_ops(target_dtype="bfloat16"):
    """Ops pinned to f32 compute or accumulation under AMP."""
    return list(_F32_OPS)


def list_widest_type_cast_ops(target_dtype="bfloat16"):
    """Ops that follow the widest input dtype."""
    return list(_WIDEST_OPS)
