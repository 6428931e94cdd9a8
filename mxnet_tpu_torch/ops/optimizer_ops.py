"""The optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py``: ``sgd_update`` ...
``rmspropalex_update``, ``ftml_update``, ``lamb_update_phase1``/``2``, the
``mp_*`` master-weight variants and the ``multi_*`` multi-tensor ones,
registered under the JAX names with the JAX parameters and ``nout``. The
math is the JAX ops', in f32, each result cast back to its input's dtype.

Two layers:

- The update functions without a registered name (:func:`rmsprop_update`,
  :func:`adagrad_update`, ... and, in ``ops/optimizer.py``,
  ``sgd_update``, ``sgd_mom_update``, ``nag_mom_update`` and
  ``adam_update``) work **in place** on f32 weights and states, as the
  optimizers (``optimizer.py``) drive them inside ``TrainStep``'s graphs.
  ``lr``, ``wd`` and ``t`` may be 0-d device tensors: nothing is read on
  the host.
- The registered ops are pure, as the JAX ops: each runs an in-place
  function on f32 copies and returns the new arrays (a tuple when the
  JAX op returns one). Through ``mx.nd`` they also take ``out=``: the new
  weights go into ``out`` (an NDArray, or a list for the ``multi_*``
  ops) and the new states into the state arguments they came from, in
  place, as MXNet's update ops write them (``write_back``).

``lazy_update=True`` with a row-sparse gradient reaches the sparse
handlers of ``sgd_update``, ``sgd_mom_update`` and ``adam_update``
through ``mx.nd``'s storage dispatch (``ndarray/sparse.py``): only the
gradient's rows are updated. With a dense gradient the op is the dense
one, as in JAX.
"""
from __future__ import annotations

import torch

from ..registry import register
from . import optimizer as _oo

__all__ = ["rmsprop_update", "rmspropalex_update", "ftml_update",
           "adagrad_update", "ftrl_update", "signsgd_update",
           "signum_update", "lamb_update_phase1", "lamb_update_phase2",
           "lamb_norms"]


def _pow(base, t):
    """``base ** t`` for a step count that may be a device tensor."""
    if torch.is_tensor(t):
        return torch.pow(base, t.float())
    return base ** t


# -- in-place updates (f32 weight and states) ---------------------------
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """``n = (1 - gamma1)·g^2 + gamma1·n; w -= lr·g / sqrt(n + epsilon)``,
    then ``w`` clipped to ``±clip_weights`` when that is positive."""
    g = _oo._apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n.copy_((1 - gamma1) * g.square() + gamma1 * n)
    w = weight - lr * g / torch.sqrt(n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    weight.copy_(w)
    return weight, n


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95, gamma2=0.9,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' centered RMSProp: ``n`` and ``g`` the running second and first
    moments, ``delta`` the momentum of the step."""
    gr = _oo._apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n.copy_((1.0 - gamma1) * gr * gr + gamma1 * n)
    g.copy_((1.0 - gamma1) * gr + gamma1 * g)
    delta.copy_(gamma2 * delta - lr * gr / torch.sqrt(n - g * g + epsilon))
    w = weight + delta
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    weight.copy_(w)
    return weight, n, g, delta


def ftml_update(weight, grad, d, v, z, lr, t=1, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """FTML (follow the moving leader), with the JAX op's order."""
    g = _oo._apply_wd(grad, weight, wd, rescale_grad, clip_grad)
    v.copy_(beta2 * v + (1 - beta2) * g.square())
    d_t = (1 - _pow(beta1, t)) / lr * \
        (torch.sqrt(v / (1 - _pow(beta2, t))) + epsilon)
    sigma = d_t - beta1 * d
    z.copy_(beta1 * z + (1 - beta1) * g - sigma * weight)
    d.copy_(d_t)
    weight.copy_(-z / d_t)
    return weight, d, v, z


def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``h += g^2; w -= lr·g / (sqrt(h) + epsilon)``."""
    g = _oo._apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    history.copy_(history + g.square())
    weight.copy_(weight - lr * g / (torch.sqrt(history) + epsilon))
    return weight, history


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal; weight decay enters the denominator, not the
    gradient."""
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    n_new = n + g.square()
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z.copy_(z + g - sigma * weight)
    n.copy_(n_new)
    weight.copy_(torch.where(
        z.abs() <= lamda1, torch.zeros_like(z),
        -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd)))
    return weight, z, n


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """``w -= lr·sign(g + wd·w)``."""
    g = _oo._apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    weight.copy_(weight - lr * torch.sign(g))
    return weight


def signum_update(weight, grad, mom, lr, momentum=0.9, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum: the sign of a momentum; ``wd_lh`` decays the weight
    directly."""
    g = _oo._apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - (1.0 - momentum) * g)
    weight.copy_((1.0 - lr * wd_lh) * weight + lr * torch.sign(mom))
    return weight, mom


def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's first phase: the moments in place, and the returned update
    ``m̂ / (sqrt(v̂) + epsilon) + wd·w`` (f32)."""
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * g.square())
    mh, vh = mean, var
    if bias_correction:
        mh = mean / (1 - _pow(beta1, t))
        vh = var / (1 - _pow(beta2, t))
    return mh / (torch.sqrt(vh) + epsilon) + wd * weight.float()


def lamb_update_phase2(weight, g_update, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB's second phase, in place: ``w -= lr·(r1 / r2)·update``, with a
    norm that is not positive taken as 1 and ``r1`` clipped to the bounds
    that are positive."""
    r1 = torch.where(r1 > 0, r1, torch.ones_like(r1))
    r2 = torch.where(r2 > 0, r2, torch.ones_like(r2))
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    weight.copy_(weight.float() - lr * (r1 / r2) * g_update)
    return weight


def lamb_norms(weight, update):
    """``(r1, r2)``: the f32 2-norms of the weight and of the update, 0-d
    tensors on their device."""
    return (torch.linalg.vector_norm(weight.float()),
            torch.linalg.vector_norm(update))


# -- the registered (pure) ops -------------------------------------------
def _f32(*ts):
    """f32 copies, for the in-place functions to overwrite."""
    return [t.detach().float().clone() for t in ts]


def _back(new, like):
    return tuple(x.to(t.dtype) for x, t in zip(new, like))


def _write_back_fn(per, targets):
    """``write_back(args, res, out)`` for an op whose inputs come in groups
    of ``per`` and whose outputs, per group, replace the inputs at
    ``targets`` (None: an output with no input, such as LAMB's update).
    The first output of each group goes to ``out``; the others into their
    inputs, in place."""
    n_out = len(targets)

    def write_back(args, res, out):
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        groups = len(res) // n_out
        if len(outs) != groups:
            raise ValueError(f"out= takes {groups} arrays, got {len(outs)}")
        with torch.no_grad():
            for j in range(groups):
                outs[j].copy_(res[j * n_out])
                for k, pos in enumerate(targets[1:], start=1):
                    if pos is not None:
                        args[j * per + pos].copy_(res[j * n_out + k])

    return write_back


def _register(name, per, targets, nout=1):
    def deco(fn):
        fn.write_back = _write_back_fn(per, targets)
        return register(name, nout=nout)(fn)

    return deco


@_register("sgd_update", 2, (0,))
def _sgd_update_op(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=False):
    w, = _f32(weight)
    _oo.sgd_update(w, grad, lr, wd, rescale_grad, clip_gradient)
    return w.to(weight.dtype)


@_register("sgd_mom_update", 3, (0, 2), nout=2)
def _sgd_mom_update_op(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=False):
    w, m = _f32(weight, mom)
    _oo.sgd_mom_update(w, grad, m, lr, momentum, wd, rescale_grad,
                       clip_gradient)
    return _back((w, m), (weight, mom))


@_register("nag_mom_update", 3, (0, 2), nout=2)
def _nag_mom_update_op(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    w, m = _f32(weight, mom)
    _oo.nag_mom_update(w, grad, m, lr, momentum, wd, rescale_grad,
                       clip_gradient)
    return _back((w, m), (weight, mom))


@_register("adam_update", 4, (0, 2, 3), nout=3)
def _adam_update_op(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                    epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    lazy_update=False):
    w, m, v = _f32(weight, mean, var)
    _oo.adam_update(w, grad, m, v, lr, beta1, beta2, epsilon, wd,
                    rescale_grad, clip_gradient)
    return _back((w, m, v), (weight, mean, var))


@_register("rmsprop_update", 3, (0, 2), nout=2)
def _rmsprop_update_op(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    w, nn_ = _f32(weight, n)
    rmsprop_update(w, grad, nn_, lr, gamma1, epsilon, wd, rescale_grad,
                   clip_gradient, clip_weights)
    return _back((w, nn_), (weight, n))


@_register("ftml_update", 5, (0, 2, 3, 4), nout=4)
def _ftml_update_op(weight, grad, d, v, z, lr, t=1, beta1=0.6, beta2=0.999,
                    epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    w, dd, vv, zz = _f32(weight, d, v, z)
    ftml_update(w, grad, dd, vv, zz, lr, t, beta1, beta2, epsilon, wd,
                rescale_grad, clip_grad)
    return _back((w, dd, vv, zz), (weight, d, v, z))


@_register("adagrad_update", 3, (0, 2), nout=2)
def _adagrad_update_op(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    w, h = _f32(weight, history)
    adagrad_update(w, grad, h, lr, epsilon, wd, rescale_grad, clip_gradient)
    return _back((w, h), (weight, history))


@_register("ftrl_update", 4, (0, 2, 3), nout=3)
def _ftrl_update_op(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    w, zz, nn_ = _f32(weight, z, n)
    ftrl_update(w, grad, zz, nn_, lr, lamda1, beta, wd, rescale_grad,
                clip_gradient)
    return _back((w, zz, nn_), (weight, z, n))


@_register("signsgd_update", 2, (0,))
def _signsgd_update_op(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    w, = _f32(weight)
    signsgd_update(w, grad, lr, wd, rescale_grad, clip_gradient)
    return w.to(weight.dtype)


@_register("lamb_update_phase1", 4, (None, 2, 3))
def _lamb_update_phase1_op(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                           epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                           rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(update, mean, var)`` (the update f32), as the JAX op."""
    m, v = _f32(mean, var)
    upd = lamb_update_phase1(weight, grad, m, v, beta1, beta2, epsilon, t,
                             bias_correction, wd, rescale_grad, clip_gradient)
    return (upd,) + _back((m, v), (mean, var))


@_register("lamb_update_phase2", 5, (0,))
def _lamb_update_phase2_op(weight, g_update, r1, r2, lr, lower_bound=-1.0,
                           upper_bound=-1.0):
    w, = _f32(weight)
    lamb_update_phase2(w, g_update, r1, r2, lr, lower_bound, upper_bound)
    return w.to(weight.dtype)


@_register("mp_sgd_update", 3, (0, 2), nout=2)
def _mp_sgd_update_op(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, lazy_update=False):
    """SGD on the f32 master; returns ``(weight, weight32)``."""
    w32 = _sgd_update_op(weight32, grad, lr, wd, rescale_grad, clip_gradient)
    return w32.to(weight.dtype), w32


@_register("mp_sgd_mom_update", 4, (0, 2, 3), nout=3)
def _mp_sgd_mom_update_op(weight, grad, mom, weight32, lr, momentum=0.0,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                          lazy_update=False):
    w32, m = _sgd_mom_update_op(weight32, grad, mom, lr, momentum, wd,
                                rescale_grad, clip_gradient)
    return w32.to(weight.dtype), m, w32


@_register("mp_nag_mom_update", 4, (0, 2, 3), nout=3)
def _mp_nag_mom_update_op(weight, grad, mom, weight32, lr, momentum=0.0,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    w32, m = _nag_mom_update_op(weight32, grad, mom, lr, momentum, wd,
                                rescale_grad, clip_gradient)
    return w32.to(weight.dtype), m, w32


@_register("signum_update", 3, (0, 2), nout=2)
def _signum_update_op(weight, grad, mom, lr, momentum=0.9, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    w, m = _f32(weight, mom)
    signum_update(w, grad, m, lr, momentum, wd, rescale_grad, clip_gradient,
                  wd_lh)
    return _back((w, m), (weight, mom))


@_register("rmspropalex_update", 5, (0, 2, 3, 4), nout=4)
def _rmspropalex_update_op(weight, grad, n, g, delta, lr, gamma1=0.95,
                           gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                           clip_gradient=-1.0, clip_weights=-1.0):
    w, nn_, gg, dd = _f32(weight, n, g, delta)
    rmspropalex_update(w, grad, nn_, gg, dd, lr, gamma1, gamma2, epsilon, wd,
                       rescale_grad, clip_gradient, clip_weights)
    return _back((w, nn_, gg, dd), (weight, n, g, delta))


def _per_weight(v, n):
    """A per-weight rate: one value per weight, or one for all."""
    try:
        return list(v)
    except TypeError:
        return [v] * n


def _groups(arrays, num_weights, per):
    n = num_weights if num_weights is not None else len(arrays) // per
    return n, [arrays[i * per:(i + 1) * per] for i in range(n)]


@_register("multi_sgd_update", 2, (0,))
def _multi_sgd_update_op(*arrays, lrs, wds, num_weights=None,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """N × (weight, grad) -> the N new weights (one array when N is 1)."""
    n, groups = _groups(arrays, num_weights, 2)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    out = tuple(_sgd_update_op(w, g, lrs[i], wds[i], rescale_grad,
                               clip_gradient)
                for i, (w, g) in enumerate(groups))
    return out if n != 1 else out[0]


@_register("multi_sgd_mom_update", 3, (0, 2))
def _multi_sgd_mom_update_op(*arrays, lrs, wds, num_weights=None,
                             momentum=0.0, rescale_grad=1.0,
                             clip_gradient=-1.0):
    """N × (weight, grad, mom) -> N × (weight, mom), flattened."""
    n, groups = _groups(arrays, num_weights, 3)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    outs = []
    for i, (w, g, m) in enumerate(groups):
        outs.extend(_sgd_mom_update_op(w, g, m, lrs[i], momentum, wds[i],
                                       rescale_grad, clip_gradient))
    return tuple(outs)


@_register("multi_mp_sgd_update", 3, (0, 2))
def _multi_mp_sgd_update_op(*arrays, lrs, wds, num_weights=None,
                            rescale_grad=1.0, clip_gradient=-1.0):
    """N × (weight, grad, weight32) -> N × (weight, weight32), flattened."""
    n, groups = _groups(arrays, num_weights, 3)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    outs = []
    for i, (w, g, w32) in enumerate(groups):
        outs.extend(_mp_sgd_update_op(w, g, w32, lrs[i], wds[i], rescale_grad,
                                      clip_gradient))
    return tuple(outs)


@_register("multi_mp_sgd_mom_update", 4, (0, 2, 3))
def _multi_mp_sgd_mom_update_op(*arrays, lrs, wds, num_weights=None,
                                momentum=0.0, rescale_grad=1.0,
                                clip_gradient=-1.0):
    """N × (weight, grad, mom, weight32) -> N × (weight, mom, weight32)."""
    n, groups = _groups(arrays, num_weights, 4)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    outs = []
    for i, (w, g, m, w32) in enumerate(groups):
        outs.extend(_mp_sgd_mom_update_op(w, g, m, w32, lrs[i], momentum,
                                          wds[i], rescale_grad, clip_gradient))
    return tuple(outs)
