"""``mx.rnn``: the legacy symbolic RNN cells and ``BucketSentenceIter``.

Counterpart of ``mxnet_tpu/rnn.py`` (MXNet's ``python/mxnet/rnn/``), the
API of the Module/BucketingModule language-model pipelines. Cells compose
Symbol graphs over the registry (FullyConnected and activations);
``unroll`` lays the time axis out explicitly, one cell graph a step, and
bucketing (one bound module a sequence length) gives the variable-length
story, as in MXNet. The unrolled graph runs eagerly, op by op.
"""
from __future__ import annotations

from typing import List, Optional

from . import symbol as sym
from .base import MXNetError

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell"]


class BaseRNNCell:
    def __init__(self, prefix=""):
        self._prefix = prefix
        self._own_params = {}

    def _get_param(self, name):
        if name not in self._own_params:
            self._own_params[name] = sym.var(self._prefix + name)
        return self._own_params[name]

    @property
    def state_info(self):
        raise NotImplementedError

    def __call__(self, inputs, states):
        raise NotImplementedError

    def _zero_state_like(self, template, num_hidden):
        """Symbolic zeros [B, num_hidden] derived from a data-dependent
        template (shape flows through infer-shape instead of a sym.zeros
        with an unknowable batch)."""
        probe = sym.slice_axis(template, axis=-1, begin=0, end=1)  # [B, 1]
        return sym.tile(probe * 0.0, reps=(1, num_hidden))

    def begin_state(self, template=None):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """inputs: one Symbol [N, T, C] ('NTC') or [T, N, C] ('TNC'), or a
        list of T Symbols [N, C]. Returns (outputs, states)."""
        if isinstance(inputs, (list, tuple)):
            steps = list(inputs)
        else:
            t_axis = layout.find("T")
            steps = [sym.squeeze(sym.slice_axis(inputs, axis=t_axis, begin=t, end=t + 1),
                                 axis=t_axis) for t in range(length)]
        states = begin_state if begin_state is not None else self.begin_state(steps[0])
        outputs = []
        for x in steps:
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs:
            t_axis = 0 if layout == "TNC" else 1
            outputs = sym.stack(*outputs, axis=t_axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_"):
        super().__init__(prefix)
        self._num_hidden = num_hidden
        self._activation = activation

    def begin_state(self, template=None):
        return [self._zero_state_like(template, self._num_hidden)]

    def __call__(self, inputs, states):
        H = self._num_hidden
        i2h = sym.FullyConnected(inputs, self._get_param("i2h_weight"),
                                 self._get_param("i2h_bias"), num_hidden=H)
        h2h = sym.FullyConnected(states[0], self._get_param("h2h_weight"),
                                 self._get_param("h2h_bias"), num_hidden=H)
        out = sym.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", forget_bias=1.0):
        super().__init__(prefix)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias

    def begin_state(self, template=None):
        z = self._zero_state_like(template, self._num_hidden)
        return [z, z]

    def __call__(self, inputs, states):
        H = self._num_hidden
        h, c = states
        gates = sym.FullyConnected(inputs, self._get_param("i2h_weight"),
                                   self._get_param("i2h_bias"), num_hidden=4 * H) \
            + sym.FullyConnected(h, self._get_param("h2h_weight"),
                                 self._get_param("h2h_bias"), num_hidden=4 * H)
        i = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=0, end=H))
        f = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=H, end=2 * H)
                        + self._forget_bias)
        g = sym.tanh(sym.slice_axis(gates, axis=-1, begin=2 * H, end=3 * H))
        o = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=3 * H, end=4 * H))
        c_new = f * c + i * g
        h_new = o * sym.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_"):
        super().__init__(prefix)
        self._num_hidden = num_hidden

    def begin_state(self, template=None):
        return [self._zero_state_like(template, self._num_hidden)]

    def __call__(self, inputs, states):
        H = self._num_hidden
        h = states[0]
        ig = sym.FullyConnected(inputs, self._get_param("i2h_weight"),
                                self._get_param("i2h_bias"), num_hidden=3 * H)
        hg = sym.FullyConnected(h, self._get_param("h2h_weight"),
                                self._get_param("h2h_bias"), num_hidden=3 * H)
        ri = sym.slice_axis(ig, axis=-1, begin=0, end=H)
        zi = sym.slice_axis(ig, axis=-1, begin=H, end=2 * H)
        ni = sym.slice_axis(ig, axis=-1, begin=2 * H, end=3 * H)
        rh = sym.slice_axis(hg, axis=-1, begin=0, end=H)
        zh = sym.slice_axis(hg, axis=-1, begin=H, end=2 * H)
        nh = sym.slice_axis(hg, axis=-1, begin=2 * H, end=3 * H)
        r = sym.sigmoid(ri + rh)
        z = sym.sigmoid(zi + zh)
        n = sym.tanh(ni + r * nh)
        out = (1 - z) * n + z * h
        return out, [out]


class SequentialRNNCell(BaseRNNCell):
    def __init__(self):
        super().__init__("")
        self._cells: List[BaseRNNCell] = []

    def add(self, cell):
        self._cells.append(cell)

    def begin_state(self, template=None):
        states = []
        for c in self._cells:
            states.append(c.begin_state(template))
        return states

    def __call__(self, inputs, states):
        next_states = []
        x = inputs
        for cell, s in zip(self._cells, states):
            x, ns = cell(x, s)
            next_states.append(ns)
        return x, next_states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell):
        super().__init__("bi_")
        self._l, self._r = l_cell, r_cell

    def begin_state(self, template=None):
        return self._l.begin_state(template) + self._r.begin_state(template)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        # begin_state is the concatenation [l_states..., r_states...]
        # (begin_state() layout); split by each sub-cell's state count
        l_begin = r_begin = None
        if begin_state is not None:
            if not isinstance(inputs, (list, tuple)):
                probe = sym.squeeze(sym.slice_axis(inputs, axis=layout.find("T"),
                                                   begin=0, end=1), axis=layout.find("T"))
            else:
                probe = inputs[0]
            n_l = len(self._l.begin_state(probe))
            l_begin, r_begin = begin_state[:n_l], begin_state[n_l:]
        l_out, l_states = self._l.unroll(length, inputs, begin_state=l_begin,
                                         layout=layout, merge_outputs=False)
        # reverse time for the right cell by unrolling the reversed step list
        if not isinstance(inputs, (list, tuple)):
            t_axis = layout.find("T")
            steps = [sym.squeeze(sym.slice_axis(inputs, axis=t_axis, begin=t, end=t + 1),
                                 axis=t_axis) for t in range(length)]
        else:
            steps = list(inputs)
        r_out, r_states = self._r.unroll(length, steps[::-1], begin_state=r_begin,
                                         merge_outputs=False)
        r_out = r_out[::-1]
        outs = [sym.concat(lo, ro, dim=-1) for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            outs = sym.stack(*outs, axis=layout.find("T"))
        return outs, l_states + r_states


class BucketSentenceIter:
    """Bucketing data iterator for variable-length sequences (MXNet's
    ``python/mxnet/rnn/io.py`` BucketSentenceIter, the companion of
    :class:`~mxnet_tpu_torch.module.BucketingModule`).

    ``sentences`` is a list of id-lists; each is placed in the smallest
    bucket that fits (longer ones are dropped, as MXNet does), padded
    with ``invalid_label``, and yielded as :class:`io.DataBatch` with
    ``bucket_key`` = the bucket length (BucketingModule binds one module a
    bucket), data and label on the current context.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", shuffle_seed=None):
        import numpy as _onp

        if layout not in ("NT", "TN"):
            raise ValueError(f"layout must be 'NT' or 'TN', got {layout!r}")
        self.layout = layout
        if buckets is None:
            lens = sorted({len(s) for s in sentences if len(s) > 0})
            buckets = lens[-8:] if len(lens) > 8 else lens
        if not buckets:
            raise ValueError("BucketSentenceIter: no buckets — pass buckets= "
                             "or provide at least one non-empty sentence")
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self._rs = _onp.random.RandomState(shuffle_seed)
        self._shuffle = shuffle_seed is not None

        self.data = [[] for _ in self.buckets]
        n_dropped = 0
        for s in sentences:
            if not len(s):
                continue
            for i, blen in enumerate(self.buckets):
                if len(s) <= blen:
                    row = _onp.full(blen, invalid_label, _onp.int64)
                    row[: len(s)] = s
                    self.data[i].append(row)
                    break
            else:
                n_dropped += 1
        if n_dropped:
            import logging

            logging.getLogger(__name__).warning(
                "BucketSentenceIter: dropped %d sentences longer than the "
                "largest bucket (%d)", n_dropped, self.buckets[-1])
        self.data = [_onp.asarray(rows) if rows
                     else _onp.empty((0, blen), _onp.int64)
                     for rows, blen in zip(self.data, self.buckets)]
        self.default_bucket_key = max(self.buckets)
        shape = ((batch_size, self.default_bucket_key) if layout == "NT"
                 else (self.default_bucket_key, batch_size))
        self.provide_data = [(data_name, shape)]
        self.provide_label = [(label_name, shape)]
        self.reset()

    def reset(self):
        self._plan = []
        for i, rows in enumerate(self.data):
            if self._shuffle:
                self._rs.shuffle(rows)
            for j in range(0, len(rows) - self.batch_size + 1,
                           self.batch_size):
                self._plan.append((i, j))
        if self._shuffle:
            self._rs.shuffle(self._plan)
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from .io.io import DataBatch
        from . import nd

        if self._cursor >= len(self._plan):
            raise StopIteration
        i, j = self._plan[self._cursor]
        self._cursor += 1
        blen = self.buckets[i]
        rows = self.data[i][j: j + self.batch_size]
        # label = next-token shift, invalid-padded (MXNet's behaviour)
        import numpy as _onp

        labels = _onp.full_like(rows, self.invalid_label)
        labels[:, :-1] = rows[:, 1:]
        if self.layout == "TN":
            rows, labels = rows.T, labels.T
            shape = (blen, self.batch_size)
        else:
            shape = (self.batch_size, blen)
        return DataBatch(
            data=[nd.array(rows.astype(self.dtype))],
            label=[nd.array(labels.astype(self.dtype))],
            bucket_key=blen,
            provide_data=[(self.data_name, shape)],
            provide_label=[(self.label_name, shape)])
