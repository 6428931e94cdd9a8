"""Unfused RNN cells (reference: ``python/mxnet/gluon/rnn/rnn_cell.py``).

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: ``RNNCell``,
``LSTMCell`` and ``GRUCell`` (one step, i2h and h2h each a
``FullyConnected``; the GRU's ``n = tanh(x W_n + b_xn + r * (h W_hn +
b_hn))``, MXNet's formula, which the fused ``RNN`` op follows too),
``SequentialRNNCell``, the modifiers (``DropoutCell``, ``ResidualCell``,
``ZoneoutCell``) and ``BidirectionalCell``, which only unrolls. ``unroll``
with ``valid_length`` zeroes the outputs past each sequence's length
(``SequenceMask``) and returns the states at its last valid step. The
cells' dropout follows the rule of ``rnn_layer``: ``autograd`` in an
imperative call, the module's training mode on tensors.
"""
from __future__ import annotations

import torch

from ... import autograd as _ag
from ..block import HybridBlock, imperative
from .rnn_layer import _default_generator

__all__ = ["RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "ModifierCell", "DropoutCell", "ResidualCell", "ZoneoutCell",
           "BidirectionalCell"]


def _dropout_mode(block, x):
    """(training, generator) of a dropout inside ``block`` on ``x``."""
    if imperative():
        return _ag.is_training(), None
    return block.training, _default_generator(x.device)


def _batch_axis(layout):
    axis = layout.find("T")
    return axis, 1 - axis if axis == 0 else 0


class _BaseCell(HybridBlock):
    def __init__(self, hidden_size, input_size=0, ngates=1, prefix=None,
                 params=None, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._ng = ngates
        g = ngates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self._reg_params["i2h_weight"].shape = (
            self._ng * self._hidden_size, x.shape[-1])

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states (batch_size, H) on ``ctx`` (the current context when
        None): two for the LSTM cell, one otherwise."""
        from ... import ndarray as nd

        n = 2 if isinstance(self, LSTMCell) else 1
        return [nd.zeros((batch_size, self._hidden_size), ctx=ctx)
                for _ in range(n)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs`` along the
        layout's T axis. Returns (outputs, states): the outputs stacked
        along T unless ``merge_outputs`` is False (then a list). With
        ``valid_length`` (B,) the outputs past each sequence's length are 0
        and the states are those at its last valid step."""
        from ... import ndarray as nd

        axis, batch_axis = _batch_axis(layout)
        states = begin_state or self.begin_state(inputs.shape[batch_axis],
                                                 ctx=inputs.context)
        outputs = []
        trace = [] if valid_length is not None else None
        for t in range(length):
            x_t = nd.squeeze(nd.slice_axis(inputs, axis=axis, begin=t,
                                           end=t + 1), axis=axis)
            out, states = self(x_t, states)
            outputs.append(out)
            if trace is not None:
                trace.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*[st[i] for st in trace],
                                               axis=0),
                                      valid_length, use_sequence_length=True)
                      for i in range(len(states))]
        merged = nd.stack(*outputs, axis=axis)
        if valid_length is not None:
            merged = nd.SequenceMask(merged, valid_length,
                                     use_sequence_length=True, axis=axis)
        if merge_outputs or merge_outputs is None:
            return merged, states
        if valid_length is not None:
            outputs = [nd.squeeze(nd.slice_axis(merged, axis=axis, begin=t,
                                                end=t + 1), axis=axis)
                       for t in range(length)]
        return outputs, states


class RNNCell(_BaseCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, input_size, 1, **kwargs)
        self._activation = activation

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        h = states[0] if isinstance(states, (list, tuple)) else states
        out = F.Activation(
            F.FullyConnected(x, i2h_weight, i2h_bias,
                             num_hidden=self._hidden_size)
            + F.FullyConnected(h, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size),
            act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, input_size, 4, **kwargs)

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        h, c = states
        n = 4 * self._hidden_size
        gates = (F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=n)
                 + F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))
        i, f, g, o = F.split(gates, num_outputs=4, axis=-1)
        c_new = F.sigmoid(f) * c + F.sigmoid(i) * F.tanh(g)
        h_new = F.sigmoid(o) * F.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(_BaseCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, input_size, 3, **kwargs)

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        h = states[0] if isinstance(states, (list, tuple)) else states
        n = 3 * self._hidden_size
        xz = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=n)
        hz = F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n)
        xr, xu, xn = F.split(xz, num_outputs=3, axis=-1)
        hr, hu, hn = F.split(hz, num_outputs=3, axis=-1)
        r = F.sigmoid(xr + hr)
        u = F.sigmoid(xu + hu)
        n_t = F.tanh(xn + r * hn)
        h_new = (1 - u) * n_t + u * h
        return h_new, [h_new]


class SequentialRNNCell(_BaseCell):
    """Cells stacked: each step runs them in order, each with its own
    states."""

    def __init__(self, prefix=None, params=None):
        HybridBlock.__init__(self, prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def begin_state(self, batch_size=0, **kwargs):
        return [c.begin_state(batch_size, **kwargs)
                for c in self._children.values()]

    def hybrid_forward(self, F, x, states):
        next_states = []
        for cell, s in zip(self._children.values(), states):
            x, ns = cell(x, s)
            next_states.append(ns)
        return x, next_states


class ModifierCell(_BaseCell):
    """Wraps a base cell and takes its states (the base of the dropout,
    zoneout and residual cells)."""

    def __init__(self, base_cell):
        HybridBlock.__init__(self)
        self.base_cell = base_cell

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)

    def infer_shape(self, x, *args):
        if hasattr(self.base_cell, "infer_shape"):
            self.base_cell.infer_shape(x, *args)


class DropoutCell(ModifierCell):
    """Dropout on the wrapped cell's output at each step."""

    def __init__(self, base_cell, rate=0.5):
        super().__init__(base_cell)
        self._rate = float(rate)

    def hybrid_forward(self, F, x, states):
        out, ns = self.base_cell(x, states)
        if self._rate:
            training, key = _dropout_mode(self, out)
            out = F.Dropout(out, p=self._rate, training=training, key=key)
        return out, ns


class ResidualCell(ModifierCell):
    """The wrapped cell's output plus its input."""

    def hybrid_forward(self, F, x, states):
        out, ns = self.base_cell(x, states)
        return out + x, ns


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al. 2017): in training each output and state
    element keeps its previous value with probability ``zoneout_outputs``
    / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = float(zoneout_outputs)
        self._zs = float(zoneout_states)

    def hybrid_forward(self, F, x, states):
        out, ns = self.base_cell(x, states)
        prev = states if isinstance(states, (list, tuple)) else [states]
        training, key = _dropout_mode(self, out)

        def mix(new, old, rate):
            if not rate or not training:
                return new
            # a dropout of ones is the keep mask scaled by 1/(1-rate)
            mask = F.Dropout(torch.ones_like(new), p=rate, training=True,
                             key=key) * (1.0 - rate)
            return mask * new + (1 - mask) * old

        out = mix(out, prev[0], self._zo)
        return out, [mix(n, p, self._zs) for n, p in zip(ns, prev)]


class BidirectionalCell(_BaseCell):
    """Two cells over the sequence in opposite directions, their outputs
    concatenated; ``unroll`` only, as in the reference."""

    def __init__(self, l_cell, r_cell):
        HybridBlock.__init__(self)
        self.l_cell, self.r_cell = l_cell, r_cell

    def begin_state(self, batch_size=0, **kwargs):
        return [self.l_cell.begin_state(batch_size, **kwargs),
                self.r_cell.begin_state(batch_size, **kwargs)]

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(
            "BidirectionalCell supports unroll() only (reference behavior)")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd

        axis, batch_axis = _batch_axis(layout)
        bs = begin_state or self.begin_state(inputs.shape[batch_axis],
                                             ctx=inputs.context)

        def reverse(x):
            if valid_length is None:
                return nd.SequenceReverse(x, axis=axis)
            return nd.SequenceReverse(x, valid_length,
                                      use_sequence_length=True, axis=axis)

        l_out, l_states = self.l_cell.unroll(
            length, inputs, bs[0], layout, merge_outputs=True,
            valid_length=valid_length)
        r_out, r_states = self.r_cell.unroll(
            length, reverse(inputs), bs[1], layout, merge_outputs=True,
            valid_length=valid_length)
        out = nd.concat(l_out, reverse(r_out), dim=-1)
        return out, [l_states, r_states]
