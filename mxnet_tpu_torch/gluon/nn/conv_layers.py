"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: the same classes,
arguments and parameter names. A convolution's ``in_channels=0`` is
inferred at the first forward (the weight is (channels, in_channels /
groups, *kernel), a transposed one's (in_channels, channels / groups,
*kernel)); a full shape is allocated at construction on ``device`` (the
current context by default). ``Conv3D`` is constructed as in the JAX
package, whose ``Convolution`` op takes 1-D and 2-D inputs only: its
forward raises there, and here.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
           "MaxPool1D", "MaxPool2D", "AvgPool1D", "AvgPool2D",
           "GlobalMaxPool2D", "GlobalAvgPool2D", "GlobalAvgPool1D"]


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, use_bias, in_channels, activation,
                 weight_initializer, bias_initializer, ndim,
                 op_name="Convolution", adj=None, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._kernel = _tuple(kernel_size, ndim)
        self._strides = _tuple(strides, ndim)
        self._padding = _tuple(padding, ndim)
        self._dilation = _tuple(dilation, ndim)
        self._groups = groups
        self._act = activation
        self._op_name = op_name
        self._adj = adj
        self._ndim = ndim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
        if in_channels:
            self._alloc_params(device)

    def _weight_shape(self, c_in):
        if self._op_name == "Deconvolution":
            return (c_in, self._channels // self._groups) + self._kernel
        return (self._channels,
                c_in // self._groups if c_in else 0) + self._kernel

    def infer_shape(self, x, *args):
        self._reg_params["weight"].shape = self._weight_shape(x.shape[1])
        if "bias" in self._reg_params:
            self._reg_params["bias"].shape = (self._channels,)

    def hybrid_forward(self, F, x, weight, bias=None):
        kw = dict(kernel=self._kernel, stride=self._strides,
                  pad=self._padding, num_filter=self._channels,
                  num_group=self._groups, no_bias=bias is None)
        if self._op_name == "Deconvolution":
            out = F.Deconvolution(x, weight, bias,
                                  adj=self._adj or (0,) * self._ndim, **kw)
        else:
            out = F.Convolution(x, weight, bias, dilate=self._dilation, **kw)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None, device=None):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 1,
                         prefix=prefix, params=params, device=device)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None, device=None):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 2,
                         prefix=prefix, params=params, device=device)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 3,
                         prefix=prefix, params=params, device=device)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, in_channels, activation,
                         weight_initializer, bias_initializer, 2,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 2), prefix=prefix,
                         params=params, device=device)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 count_include_pad=True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kw = dict(kernel=pool_size, stride=strides or pool_size,
                        pad=padding, global_pool=global_pool,
                        pool_type=pool_type,
                        count_include_pad=count_include_pad)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kw)


class _Pool1D(_Pool):
    """A 1-D pool: NCW as NC1W through the 2-D op."""

    def hybrid_forward(self, F, x):
        return F.squeeze(F.Pooling(F.expand_dims(x, axis=2), **self._kw),
                         axis=2)


class MaxPool1D(_Pool1D):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 **kw):
        super().__init__((1, pool_size), (1, strides or pool_size),
                         (0, padding), False, "max", **kw)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", **kw):
        super().__init__(pool_size, strides, padding, False, "max", **kw)


class AvgPool1D(_Pool1D):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 count_include_pad=True, **kw):
        super().__init__((1, pool_size), (1, strides or pool_size),
                         (0, padding), False, "avg", count_include_pad, **kw)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", count_include_pad=True, **kw):
        super().__init__(pool_size, strides, padding, False, "avg",
                         count_include_pad, **kw)


class GlobalMaxPool2D(_Pool):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), None, 0, True, "max", **kw)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), None, 0, True, "avg", **kw)


class GlobalAvgPool1D(_Pool1D):
    def __init__(self, layout="NCW", **kw):
        super().__init__((1, 1), None, 0, True, "avg", **kw)
