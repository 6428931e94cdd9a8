"""Control-flow operators: ``foreach`` / ``while_loop`` / ``cond``
(``mx.nd.contrib.*``).

Counterpart of ``mxnet_tpu/control_flow.py``. The JAX package lowers each
construct to one structured XLA primitive (``lax.scan``, a bounded scan of
``lax.cond``, ``lax.cond``) so that a loop is one traced body; here the
body is Python, run eagerly on NDArrays, as MXNet's imperative path runs
it:

- :func:`foreach` calls the body once per row of axis 0. Under
  ``autograd.record`` each call is on the tape, so a weight the body
  closes over gets its gradient, as JAX's ``closure_convert`` gives it.
- :func:`while_loop` runs at most ``max_iterations`` steps, reading the
  predicate on the host before each, and stacks the step outputs with
  zero rows past the last step taken: the JAX op's result. It records no
  gradient (the reference's op is forward-only).
- :func:`cond` reads the predicate on the host and runs one branch, as
  the JAX package's eager path does.

A predicate read on the host is a sync: ``cond`` and ``while_loop``
cannot run inside a captured step (``StepGraph`` raises on the sync);
``foreach`` can, its length being the data's shape.
"""
from __future__ import annotations

from typing import Callable, List

import torch

__all__ = ["foreach", "while_loop", "cond"]


def _listify(x) -> List:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _pred(p) -> bool:
    from .ndarray import NDArray

    t = p._data if isinstance(p, NDArray) else torch.as_tensor(p)
    return bool(t.reshape(()).item())


def _stack(rows):
    from . import ndarray as nd

    return nd.stack(*rows, axis=0)


def foreach(body: Callable, data, init_states):
    """Run ``body(data_slice, states) -> (outputs, new_states)`` over axis 0
    of ``data`` (an NDArray or a list of them). Returns ``(outputs,
    final_states)``, each output stacked along a new axis 0; one output (or
    a one-element list) comes back as an NDArray, the states in the form
    ``init_states`` had."""
    data_l = _listify(data)
    states = _listify(init_states)
    data_seq = isinstance(data, (list, tuple))
    states_seq = isinstance(init_states, (list, tuple))
    rows = None
    for t in range(data_l[0].shape[0]):
        xs = [d[t] for d in data_l]
        out, new = body(xs if data_seq else xs[0],
                        states if states_seq else states[0])
        out = _listify(out)
        states = _listify(new)
        if rows is None:
            rows = [[] for _ in out]
        for acc, o in zip(rows, out):
            acc.append(o)
    outs = [_stack(r) for r in rows or []]
    outs = outs if len(outs) != 1 else outs[0]
    finals = states if states_seq else (states[0] if states else [])
    return outs, finals


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int):
    """``cond_fn(*loop_vars) -> scalar``; ``func(*loop_vars) ->
    (step_outputs, new_loop_vars)``. Runs while the predicate holds, at
    most ``max_iterations`` steps. Returns ``(outputs, final_loop_vars)``:
    each output stacked to ``max_iterations`` rows, zero past the last step
    taken (one output comes back as an NDArray), and the loop variables as
    a list. Forward only: nothing is recorded for autograd."""
    from . import autograd as _ag
    from . import ndarray as nd

    vars_l = _listify(loop_vars)
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations (static shapes)")
    rows = None
    with _ag.pause():
        for _ in range(int(max_iterations)):
            if not _pred(cond_fn(*vars_l)):
                break
            out, new = func(*vars_l)
            out = _listify(out)
            vars_l = _listify(new)
            if rows is None:
                rows = [[] for _ in out]
            for acc, o in zip(rows, out):
                acc.append(o)
        if rows is None:
            # no step ran: the outputs' shapes from one call, as the JAX
            # op's skipped branch probes them
            probe = _listify(func(*vars_l)[0])
            rows = [[] for _ in probe]
        else:
            probe = [r[0] for r in rows]
        outs = []
        for acc, p in zip(rows, probe):
            pad = [nd.zeros_like(p)] * (int(max_iterations) - len(acc))
            outs.append(_stack(acc + pad))
    outs = outs if len(outs) != 1 else outs[0]
    return outs, vars_l


def cond(pred, then_func: Callable, else_func: Callable):
    """Run ``then_func()`` when ``pred`` (read on the host) is nonzero, else
    ``else_func()``; one output comes back as an NDArray."""
    out = _listify((then_func if _pred(pred) else else_func)())
    return out if len(out) != 1 else out[0]
