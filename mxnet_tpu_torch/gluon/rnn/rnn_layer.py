"""The fused RNN layers ``RNN``, ``LSTM`` and ``GRU`` (reference:
``python/mxnet/gluon/rnn/rnn_layer.py``).

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``: one flat parameter,
``rnn_param``, in cuDNN's layout (``ops.nn.rnn_param_size``), declared
under the attribute name ``parameters``, so a ``.params`` file of either
package loads into the other; its length is inferred at the first forward
when ``input_size`` is 0. The forward is the ``RNN`` op (``ops/nn.py``).
Dropout between layers is active under ``autograd.is_training()`` in an
imperative call, drawing from the port's generators, and in training mode
under a call on tensors (``TrainStep``), drawing from PyTorch's default
generator, which a captured CUDA graph replays, as the ``Dropout`` layer
does.
"""
from __future__ import annotations

import torch

from ... import autograd as _ag
from ...base import MXNetError
from ...ops.nn import rnn_param_size
from ..block import HybridBlock, imperative

__all__ = ["RNN", "LSTM", "GRU"]


def _default_generator(device):
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None else
            torch.cuda.current_device()]
    return torch.default_generator


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout}")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        with self.name_scope():
            # the flat cuDNN-layout parameter, under the JAX package's
            # attribute name (its structural name in a .params file)
            self.parameters = self.params.get(
                "rnn_param", shape=(self._param_size(input_size)
                                    if input_size else 0,),
                init=i2h_weight_initializer, allow_deferred_init=True)
        if input_size:
            self._alloc_params(None)

    def _param_size(self, input_size):
        return rnn_param_size(self._mode, input_size, self._hidden_size,
                              self._num_layers, self._dir == 2)

    def infer_shape(self, x, *args):
        self._input_size = x.shape[-1]
        self._reg_params["parameters"].shape = (
            self._param_size(x.shape[-1]),)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states (L·D, batch_size, H) on ``ctx`` (the current context
        when None): two for the LSTM, one otherwise."""
        from ... import ndarray as nd

        return [nd.zeros(info["shape"], ctx=ctx)
                for info in self.state_info(batch_size)]

    def hybrid_forward(self, F, x, *states, **params):
        parameters = params["parameters"]
        if self._layout == "NTC":
            x = x.swapaxes(0, 1)
        skip_states = not states
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=x.dtype,
                                  device=x.device)
                      for info in self.state_info(x.shape[1])]
        elif len(states) == 1 and isinstance(states[0], (list, tuple)):
            states = list(states[0])
        if imperative():
            training, key = _ag.is_training(), None
        else:
            training, key = self.training, _default_generator(x.device)
        out, h_n, c_n = F.RNN(x, parameters, states[0],
                              states[1] if len(states) > 1 else None,
                              state_size=self._hidden_size,
                              num_layers=self._num_layers, mode=self._mode,
                              bidirectional=self._dir == 2, p=self._dropout,
                              training=training, key=key)
        if self._layout == "NTC":
            out = out.swapaxes(0, 1)
        if skip_states:
            return out
        return out, ([h_n, c_n] if self._mode == "lstm" else [h_n])


class RNN(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers,
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("gru", hidden_size, num_layers, **kwargs)
