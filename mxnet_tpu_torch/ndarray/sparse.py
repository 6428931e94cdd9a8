"""``mx.nd.sparse``: row-sparse and CSR storage.

Counterpart of ``mxnet_tpu/ndarray/sparse.py``. A sparse array is an
:class:`~mxnet_tpu_torch.ndarray.NDArray` whose ``_data`` holds the
compacted values and whose ``_aux`` holds the index tensors (int32, as the
JAX package keeps them and as ``.params`` files store them) on the same
device; ``shape``, ``size`` and ``ndim`` describe the logical dense tensor.
Indices become int64 only where a torch index op takes them.

Sums are deterministic on the card: ``dot(csr, dense)`` reduces each
output row's products in one thread in index order
(``torch.segment_reduce`` over ``indptr``; with ``transpose_a`` the
nonzeros are first sorted by column, stably), and ``rsp + rsp`` adds each
operand's rows at distinct positions, so no float is summed by atomics in
an order that changes from run to run.

``cast_storage`` to a sparse type, ``retain`` and ``rsp + rsp`` read sizes
on the host (the number of nonzero rows or elements), as the JAX package's
do: they cannot run inside a captured CUDA graph.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, as_index_array, dtype_torch
from ..context import as_device
from ..registry import get as _get_op
from ..registry import register_sparse as _register_sparse
from . import NDArray, _from_host, _invoke_name, _raw

__all__ = [
    "BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
    "row_sparse_array", "csr_matrix", "cast_storage", "retain", "dot",
    "zeros", "array", "add", "subtract", "multiply",
]


def _index_tensor(values, what, device):
    """``values`` (an NDArray, tensor, numpy array or list) as an int32
    tensor on ``device``; int64 values are checked to fit."""
    values = _raw(values)
    if torch.is_tensor(values):
        t = as_index_array(values, what)
    else:
        t = torch.from_numpy(_np.ascontiguousarray(
            as_index_array(values, what)))
    return t.to(device=device, dtype=torch.int32)


def _values(data, ctx, dtype):
    """The value buffer: a tensor stays on its device (moved to ``ctx``
    if one is named), host data goes to ``ctx`` or the current context."""
    data = _raw(data)
    if not torch.is_tensor(data):
        data = _from_host(data, dtype, copy=True).to(as_device(ctx))
    elif ctx is not None:
        data = data.to(as_device(ctx))
    return data if dtype is None else data.to(dtype_torch(dtype))


class BaseSparseNDArray(NDArray):
    """The surface the two storage types share. ``_data`` is the value
    buffer (the dense view is never kept); ``_aux`` the index tensors."""

    __slots__ = ("_aux", "_shape")

    def __init__(self, data, aux, shape):
        NDArray.__init__(self, data)
        dev = self._data.device
        self._aux = tuple(_index_tensor(a, "sparse aux index", dev)
                          for a in aux)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(_np.prod(self._shape)) if self._shape else 1

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def data(self):
        return NDArray(self._data)

    def asnumpy(self):
        return NDArray(self._to_dense_raw()).asnumpy()

    def tostype(self, stype):
        return cast_storage(self, stype)

    def todense(self):
        return NDArray(self._to_dense_raw())

    def astype(self, dtype, copy=True):
        return type(self)(self._data.to(dtype_torch(dtype)), self._aux,
                          self._shape)

    def copy(self):
        return type(self)(self._data.detach().clone(),
                          tuple(a.clone() for a in self._aux), self._shape)

    def as_in_context(self, ctx):
        dev = as_device(ctx)
        if self._data.device == dev:
            return self
        return type(self)(self._data.to(dev),
                          tuple(a.to(dev) for a in self._aux), self._shape)

    as_in_ctx = as_in_context

    def __repr__(self):
        return (f"\n<{type(self).__name__} {'x'.join(map(str, self._shape))} "
                f"@{self.context}>")

    def __getitem__(self, key):
        if isinstance(self, CSRNDArray) and isinstance(key, slice):
            start, stop, step = key.indices(self._shape[0])
            if step != 1:
                raise MXNetError("CSRNDArray only supports step=1 row slices")
            indptr = self._aux[1]
            lo, hi = int(indptr[start]), int(indptr[stop])
            return CSRNDArray(self._data[lo:hi],
                              (self._aux[0][lo:hi],
                               indptr[start:stop + 1] - indptr[start]),
                              (stop - start, self._shape[1]))
        raise MXNetError(f"{type(self).__name__} does not support this "
                         "indexing")

    def __setitem__(self, key, value):
        raise MXNetError(f"{type(self).__name__} is immutable; use a dense "
                         "NDArray")


class RowSparseNDArray(BaseSparseNDArray):
    """A tensor of which only some slices along axis 0 are nonzero:
    ``data`` (nnz_rows, *shape[1:]) and ``indices``, the sorted row ids.
    The storage of an embedding's gradient."""

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        return NDArray(self._aux[0])

    def _to_dense_raw(self):
        dense = torch.zeros(self._shape, dtype=self._data.dtype,
                            device=self._data.device)
        if self._data.shape[0] == 0:
            return dense
        return dense.index_copy(0, self._aux[0].long(), self._data)

    def retain(self, indices):
        return retain(self, indices)


class CSRNDArray(BaseSparseNDArray):
    """A compressed-sparse-row matrix: ``data``, ``indices`` (the column
    ids) and ``indptr`` (each row's first position in both)."""

    @property
    def stype(self):
        return "csr"

    @property
    def indices(self):
        return NDArray(self._aux[0])

    @property
    def indptr(self):
        return NDArray(self._aux[1])

    def _to_dense_raw(self):
        rows, cols = self._shape
        dense = torch.zeros(rows * cols, dtype=self._data.dtype,
                            device=self._data.device)
        nnz = self._data.shape[0]
        if nnz == 0:
            return dense.reshape(rows, cols)
        flat = _row_ids(self._aux[1], nnz).long() * cols + \
            self._aux[0].long()
        return dense.index_copy(0, flat, self._data).reshape(rows, cols)


def _row_ids(indptr, nnz):
    """Each nonzero's row, from ``indptr`` (a search, no host read)."""
    pos = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr[1:].contiguous(), pos, right=True,
                              out_int32=True)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """``row_sparse_array((data, indices), shape=)``, or of a dense array.
    The rows come back sorted by index."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2 and \
            not _np.isscalar(arg1[0]):
        data = _values(arg1[0], ctx, dtype)
        indices = _index_tensor(arg1[1], "row_sparse indices", data.device)
        if shape is None:
            shape = (int(indices.max()) + 1 if indices.numel() else 0,) + \
                tuple(data.shape[1:])
        order = torch.argsort(indices, stable=True)
        return RowSparseNDArray(data[order], (indices[order],), shape)
    return cast_storage(_dense_nd(arg1, ctx, dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """``csr_matrix((data, indices, indptr), shape=)``, or of a dense
    matrix."""
    if isinstance(arg1, CSRNDArray):
        return arg1
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data = _values(arg1[0], ctx, dtype)
        indices = _index_tensor(arg1[1], "csr indices", data.device)
        indptr = _index_tensor(arg1[2], "csr indptr", data.device)
        if shape is None:
            raise MXNetError("csr_matrix from (data, indices, indptr) "
                             "requires shape")
        return CSRNDArray(data, (indices, indptr), shape)
    return cast_storage(_dense_nd(arg1, ctx, dtype), "csr")


def _dense_nd(arg, ctx, dtype):
    if isinstance(arg, NDArray):
        return arg if dtype is None else arg.astype(dtype)
    return NDArray(_values(arg, ctx, dtype))


def zeros(stype, shape, ctx=None, dtype="float32"):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dt, dev = dtype_torch(dtype), as_device(ctx)
    idx = torch.zeros((0,), dtype=torch.int32, device=dev)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,) + shape[1:], dtype=dt,
                                            device=dev), (idx,), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          (idx, torch.zeros((shape[0] + 1,),
                                            dtype=torch.int32, device=dev)),
                          shape)
    if stype == "default":
        from . import zeros as _dense_zeros

        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    raise MXNetError(f"unknown storage type {stype!r}")


def array(source_array, ctx=None, dtype=None):
    if isinstance(source_array, BaseSparseNDArray):
        out = source_array.astype(dtype) if dtype else source_array.copy()
        return out if ctx is None else out.as_in_context(ctx)
    raise MXNetError("mx.nd.sparse.array expects a sparse input; "
                     "use csr_matrix/row_sparse_array to construct")


# ---------------------------------------------------------------------------
# storage casts
# ---------------------------------------------------------------------------
def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` ("default", "row_sparse" or "csr"), on
    its device. To a sparse type this reads the nonzero count on the
    host."""
    if stype == arr.stype:
        return arr
    if stype == "default":
        return arr.todense()
    dense = (arr._to_dense_raw() if isinstance(arr, BaseSparseNDArray)
             else arr._data).detach()
    if stype == "row_sparse":
        if dense.dim() < 2:
            raise MXNetError("row_sparse requires ndim >= 2")
        nz = torch.nonzero(dense.reshape(dense.shape[0], -1).ne(0).any(1))
        nz = nz.reshape(-1)
        return RowSparseNDArray(dense.index_select(0, nz),
                                (nz.to(torch.int32),), dense.shape)
    if stype == "csr":
        if dense.dim() != 2:
            raise MXNetError("csr requires ndim == 2")
        rows, cols = torch.nonzero(dense, as_tuple=True)  # row-major
        bounds = torch.arange(dense.shape[0] + 1, device=dense.device)
        indptr = torch.searchsorted(rows, bounds, out_int32=True)
        return CSRNDArray(dense[rows, cols],
                          (cols.to(torch.int32), indptr), dense.shape)
    raise MXNetError(f"unknown storage type {stype!r}")


# ---------------------------------------------------------------------------
# sparse ops
# ---------------------------------------------------------------------------
def retain(rsp, indices):
    """``sparse_retain``: keep only the stored rows in ``indices``."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    stored = rsp._aux[0]
    want = _index_tensor(indices, "sparse_retain indices", stored.device)
    keep = torch.nonzero(torch.isin(stored, want)).reshape(-1)
    return RowSparseNDArray(rsp._data.index_select(0, keep),
                            (stored.index_select(0, keep),), rsp._shape)


def _segment_sum(values, offsets, n_out):
    """Row ``i`` of the result: the sum, in order, of ``values`` rows
    ``offsets[i]:offsets[i + 1]`` (one thread a row and column on the
    card: no atomics)."""
    if values.shape[0] == 0:
        return values.new_zeros((n_out,) + tuple(values.shape[1:]))
    return torch.segment_reduce(values, "sum", offsets=offsets.long(),
                                axis=0)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``dot`` with a sparse left operand. ``csr × dense`` sums the
    products by segment (see the module docstring); other storage
    combinations densify."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) and \
            not isinstance(rhs, BaseSparseNDArray):
        r = rhs._data.t() if transpose_b else rhs._data
        data, cols, indptr = lhs._data, lhs._aux[0], lhs._aux[1]
        nnz = data.shape[0]
        if not transpose_a:
            contrib = data[:, None] * r.index_select(0, cols.long())
            return NDArray(_segment_sum(contrib, indptr, lhs._shape[0]))
        order = torch.argsort(cols, stable=True)
        rows = _row_ids(indptr, nnz).index_select(0, order)
        sorted_cols = cols.index_select(0, order)
        contrib = data.index_select(0, order)[:, None] * \
            r.index_select(0, rows.long())
        bounds = torch.arange(lhs._shape[1] + 1, dtype=sorted_cols.dtype,
                              device=sorted_cols.device)
        offsets = torch.searchsorted(sorted_cols, bounds)
        return NDArray(_segment_sum(contrib, offsets, lhs._shape[1]))
    if isinstance(lhs, BaseSparseNDArray):
        lhs = lhs.todense()
    if isinstance(rhs, BaseSparseNDArray):
        rhs = rhs.todense()
    return _invoke_name("dot", (lhs, rhs), {"transpose_a": transpose_a,
                                            "transpose_b": transpose_b})


def _ewise(name, lhs, rhs):
    if name == "add" and isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        # rsp + rsp stays rsp over the union of the rows; each operand's
        # rows land at distinct positions, added in the JAX order
        li, ri = lhs._aux[0], rhs._aux[0]
        ids = torch.unique(torch.cat([li, ri]))
        dt = torch.promote_types(lhs._data.dtype, rhs._data.dtype)
        out = torch.zeros((ids.shape[0],) + lhs._shape[1:], dtype=dt,
                          device=ids.device)
        out.index_add_(0, torch.searchsorted(ids, li), lhs._data.to(dt))
        out.index_add_(0, torch.searchsorted(ids, ri), rhs._data.to(dt))
        return RowSparseNDArray(out, (ids,), lhs._shape)
    l = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    r = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return _invoke_name(name, (l, r), {})


def add(lhs, rhs):
    return _ewise("add", lhs, rhs)


def subtract(lhs, rhs):
    return _ewise("subtract", lhs, rhs)


def multiply(lhs, rhs):
    return _ewise("multiply", lhs, rhs)


# ---------------------------------------------------------------------------
# storage dispatch: the generic op names (nd.dot, +, nd.sgd_update with
# lazy_update=True) take these paths when an input is sparse
# ---------------------------------------------------------------------------
@_register_sparse("dot")
def _dot_storage(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) \
            and not isinstance(rhs, BaseSparseNDArray):
        return dot(lhs, rhs, transpose_a=transpose_a, transpose_b=transpose_b)
    return NotImplemented


@_register_sparse("add")
def _add_storage(lhs, rhs, **kw):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        return add(lhs, rhs)
    return NotImplemented


@_register_sparse("sparse_retain")
def _retain_storage(data, indices, **kw):
    if isinstance(data, RowSparseNDArray):
        return retain(data, indices)
    return NotImplemented


def _lazy_update_handler(op_name):
    """The update op on the rows of a row-sparse gradient only (MXNet's
    ``lazy_update``): gather those rows of the weight and of every state
    with the weight's rows, run the op on the block, scatter the results
    back into copies. Rows the gradient does not hold see no weight decay
    and no state decay."""

    def handler(weight, grad, *rest, **kw):
        if not isinstance(grad, RowSparseNDArray) or \
                isinstance(weight, BaseSparseNDArray) or \
                not kw.get("lazy_update", False):
            return NotImplemented
        kw = {k: _raw(v) for k, v in kw.items()}
        rows = grad._aux[0].long()
        w = _raw(weight)
        n = w.shape[0]
        raws = [_raw(a) for a in rest]
        row_state = [torch.is_tensor(a) and a.dim() >= 1 and a.shape[0] == n
                     for a in raws]
        gathered = [a.index_select(0, rows) if s else a
                    for a, s in zip(raws, row_state)]
        outs = _get_op(op_name).fn(w.index_select(0, rows), grad._data,
                                   *gathered, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        full = [w] + [a for a, s in zip(raws, row_state) if s]
        results = tuple(NDArray(f.index_copy(0, rows, o.to(f.dtype)))
                        for f, o in zip(full, outs))
        return results[0] if len(results) == 1 else results

    return handler


for _op in ("sgd_update", "sgd_mom_update", "adam_update"):
    _register_sparse(_op)(_lazy_update_handler(_op))
del _op
