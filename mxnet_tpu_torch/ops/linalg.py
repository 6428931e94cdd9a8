"""The linear-algebra operator family (reference: ``src/operator/tensor/
la_op.cc``), ``mx.nd.linalg_*`` and ``mx.nd.linalg.*``.

Counterpart of ``mxnet_tpu/ops/linalg.py``: every op works on the last two
axes, the leading ones being a batch, and gets its gradient from autograd.
``gemm``/``gemm2`` follow the AMP pair rule of the matmul class
(``ops/core.py`` ``_amp_pair``: under ``contrib.amp.init`` two f32
operands are rounded to the compute dtype and multiplied with f32 sums).

``potrf`` is ``cholesky_ex`` without its error check, its factor NaN in
the lower triangle where the matrix is not positive definite (what the
JAX op gives) and no value read on the host; ``inverse`` is ``inv_ex``
without its check. Which of them a captured step can hold is PyTorch's
choice of solver, measured on the H100 at (64, 256, 256) by
``chip_smoke.py`` ``[extra_ops]``: ``syevd`` (``eigh`` reads its
convergence flag on the host), ``inverse`` and ``slogdet`` (the batched
LU factorization at that size) sync and cannot be captured; ``potrf``,
``potri``, ``trsm``, ``gelqf``, ``det`` (at (64, 16, 16)) and the
products can. ``syevd``'s eigenvectors and ``gelqf``'s factors are unique
only up to the sign of each row (of ``U``; of ``Q`` and the matching
column of ``L``): two LAPACK builds may pick other signs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..registry import register
from .core import _amp_pair


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


def _amp_matmul(a, b):
    a, b = _amp_pair(a, b)
    return torch.matmul(a, b)


@register("linalg_gemm", aliases=("_linalg_gemm",))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    """``alpha * op(A) @ op(B) + beta * C``."""
    return alpha * _amp_matmul(_t(A, transpose_a), _t(B, transpose_b)) + \
        beta * C


@register("linalg_gemm2", aliases=("_linalg_gemm2",))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    """``alpha * op(A) @ op(B)``."""
    return alpha * _amp_matmul(_t(A, transpose_a), _t(B, transpose_b))


@register("linalg_potrf", aliases=("_linalg_potrf",))
def linalg_potrf(A):
    """The lower Cholesky factor L of a symmetric positive-definite A (its
    lower triangle read); a matrix that is not positive definite gives NaN
    in the lower triangle, with no host sync."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    bad = (info != 0)[..., None, None]
    lower = torch.ones(A.shape[-2:], dtype=torch.bool,
                       device=A.device).tril()
    return torch.where(bad & lower, float("nan"), L)


@register("linalg_potri", aliases=("_linalg_potri",))
def linalg_potri(A):
    """``inv(L @ L^T)`` from the Cholesky factor L (its lower triangle):
    ``inv(L)^T @ inv(L)``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    inv_l = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(inv_l.transpose(-1, -2), inv_l)


@register("linalg_trsm", aliases=("_linalg_trsm",))
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve ``op(A) X = alpha B`` (``X op(A) = alpha B`` when
    ``rightside``) for triangular A (the triangle ``lower`` names)."""
    a, upper = (A.transpose(-1, -2), lower) if transpose else (A, not lower)
    return torch.linalg.solve_triangular(a, alpha * B, upper=upper,
                                         left=not rightside)


@register("linalg_trmm", aliases=("_linalg_trmm",))
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(tri(A)) @ B`` (``alpha * B @ op(tri(A))`` when
    ``rightside``)."""
    tri = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    return alpha * (torch.matmul(B, tri) if rightside else
                    torch.matmul(tri, B))


@register("linalg_syrk", aliases=("_linalg_syrk",))
def linalg_syrk(A, transpose=False, alpha=1.0):
    """``alpha * A @ A^T`` (``alpha * A^T @ A`` when ``transpose``)."""
    return alpha * torch.matmul(_t(A, transpose), _t(A, not transpose))


@register("linalg_sumlogdiag", aliases=("_linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    """The sum of the log of the diagonal."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("linalg_gelqf", aliases=("_linalg_gelqf",), nout=2)
def linalg_gelqf(A):
    """LQ factorization ``A = L Q`` with orthonormal rows in Q, from the QR
    factorization of A^T: ``A^T = Q_r R`` gives ``L = R^T, Q = Q_r^T``."""
    q, r = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register("linalg_det", aliases=("_linalg_det",))
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", aliases=("_linalg_slogdet",), nout=2)
def linalg_slogdet(A):
    sign, logabsdet = torch.linalg.slogdet(A)
    return sign, logabsdet


@register("linalg_inverse", aliases=("_linalg_inverse",))
def linalg_inverse(A):
    """The inverse, with no host check of singularity."""
    return torch.linalg.inv_ex(A, check_errors=False)[0]


@register("linalg_extractdiag", aliases=("_linalg_extractdiag",))
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("linalg_makediag", aliases=("_linalg_makediag",))
def linalg_makediag(A, offset=0):
    """Square matrices of size ``n + |offset|`` with A on the ``offset``
    diagonal."""
    return torch.diag_embed(A, offset=int(offset), dim1=-2, dim2=-1)


def _trian_index(n, offset, lower, device):
    """(rows, cols) of the kept triangle band, row by row, made on
    ``device`` (no copy from host memory)."""
    fn = torch.tril_indices if lower else torch.triu_indices
    return fn(n, n, int(offset), device=device)


@register("linalg_extracttrian", aliases=("_linalg_extracttrian",))
def linalg_extracttrian(A, offset=0, lower=True):
    """The kept triangle band packed into a vector, walked row by row."""
    rows, cols = _trian_index(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


def _trian_count(n, k):
    """The entries ``tril(ones((n, n)), k)`` keeps: row i keeps
    ``clip(i + k + 1, 0, n)``."""
    i = np.arange(n)
    return int(np.clip(i + k + 1, 0, n).sum())


def _trian_size(m, offset, lower):
    """The n whose (offset, lower) triangle keeps m entries. ``triu(k)``
    keeps as many as ``tril(-k)``. With the band inside the matrix the
    count is quadratic in n: ``(n + k)(n + k + 1) / 2`` for k <= 0 and
    ``n(n + 1)/2 + k n - k(k + 1)/2`` for k > 0; a band past the corner
    keeps all n^2. Each closed form gives a candidate, held to the count."""
    k = int(offset) if lower else -int(offset)
    if k <= 0:
        guesses = [(math.isqrt(8 * m + 1) - 1) // 2 - k]
    else:
        b = k + 0.5
        guesses = [int(round(-b + math.sqrt(b * b + k * (k + 1) + 2 * m)))]
    guesses.append(math.isqrt(m))
    for g in sorted(guesses):
        for n in (g - 1, g, g + 1):
            if n >= 1 and _trian_count(n, k) == m:
                return n
    raise ValueError(f"linalg_maketrian: no n matches {m} entries")


@register("linalg_maketrian", aliases=("_linalg_maketrian",))
def linalg_maketrian(A, offset=0, lower=True):
    """The inverse of extracttrian: the packed vector scattered into an
    n x n triangular matrix, zero elsewhere."""
    n = _trian_size(A.shape[-1], offset, lower)
    rows, cols = _trian_index(n, offset, lower, A.device)
    flat = rows * n + cols
    out = torch.zeros(tuple(A.shape[:-1]) + (n * n,), dtype=A.dtype,
                      device=A.device)
    return out.index_copy(-1, flat, A).reshape(tuple(A.shape[:-1]) + (n, n))


@register("linalg_syevd", aliases=("_linalg_syevd",), nout=2)
def linalg_syevd(A):
    """``A = U^T diag(w) U`` with the eigenvectors in the rows of U and
    the eigenvalues ascending: returns (U, w). ``eigh`` reads its
    convergence flag on the host."""
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w
