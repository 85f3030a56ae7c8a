"""Linear algebra ops (counterpart: ``paddle_tpu/ops/linalg.py``):
``matmul`` (in ``math.py``, the models' op) and its aliases, norms, the
decompositions and solvers over ``torch.linalg``. LU pivots are 1-based,
as LAPACK and the reference give them."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..tensor import Tensor
from .common import binary_args, ensure_tensor, norm_axis, raw
from .dispatch import dispatch, nondiff
from .math import matmul


def bmm(x, y, name=None):
    return matmul(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def _dot_impl(x, y):
    return torch.sum(x * y, -1)


def dot(x, y, name=None):
    x, y = binary_args(x, y)
    return dispatch("dot", _dot_impl, x, y)


def _mv_impl(x, vec):
    return x @ vec


def mv(x, vec, name=None):
    return dispatch("mv", _mv_impl, *binary_args(x, vec))


def _einsum_impl(*operands, equation):
    return torch.einsum(equation, *operands)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = operands[0]
    return dispatch("einsum", _einsum_impl,
                    *[ensure_tensor(o) for o in operands], equation=equation)


def _norm_impl(x, p, axis, keepdim):
    dim = axis
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(torch.abs(x)),
                                    dim=dim or tuple(range(x.ndim)),
                                    keepdim=keepdim))
    if p == "nuc":
        return torch.linalg.matrix_norm(x, "nuc", dim=dim or (-2, -1),
                                        keepdim=keepdim)
    dim = dim or tuple(range(x.ndim))
    if p == np.inf:
        return torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == -np.inf:
        return torch.amin(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dim, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dim,
                               keepdim=keepdim), 1.0 / p)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    if p is None:
        p = "fro" if axis is None else 2
    ax = norm_axis(axis, raw(x).ndim)
    if ax is not None and len(ax) == 1 and p == "fro":
        p = 2
    return dispatch("norm", _norm_impl, x, p=p, axis=ax,
                    keepdim=bool(keepdim))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def dist(x, y, p=2, name=None):
    from .math import subtract
    return norm(subtract(x, y), p=p)


def _cholesky_impl(x, upper):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky(x, upper=False, name=None):
    return dispatch("cholesky", _cholesky_impl, ensure_tensor(x),
                    upper=bool(upper))


def _cholesky_solve_impl(x, y, upper):
    return torch.cholesky_solve(x, y, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    return dispatch("cholesky_solve", _cholesky_solve_impl,
                    *binary_args(x, y), upper=bool(upper))


def _qr_impl(x, mode):
    return tuple(torch.linalg.qr(x, mode=mode))


def qr(x, mode="reduced", name=None):
    out = dispatch("qr", _qr_impl, ensure_tensor(x), mode=mode)
    return out[1] if mode == "r" else out


def _svd_impl(x, full_matrices):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


def svd(x, full_matrices=False, name=None):
    return dispatch("svd", _svd_impl, ensure_tensor(x),
                    full_matrices=bool(full_matrices))


def _svdvals_impl(x):
    return torch.linalg.svdvals(x)


def svdvals(x, name=None):
    return dispatch("svdvals", _svdvals_impl, ensure_tensor(x))


def _inv_impl(x):
    return torch.linalg.inv(x)


def inv(x, name=None):
    return dispatch("inv", _inv_impl, ensure_tensor(x))


def _pinv_impl(x, rcond, hermitian):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return dispatch("pinv", _pinv_impl, ensure_tensor(x), rcond=float(rcond),
                    hermitian=bool(hermitian))


def _det_impl(x):
    return torch.linalg.det(x)


def det(x, name=None):
    return dispatch("det", _det_impl, ensure_tensor(x))


def _slogdet_impl(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def slogdet(x, name=None):
    return dispatch("slogdet", _slogdet_impl, ensure_tensor(x))


def _solve_impl(x, y):
    return torch.linalg.solve(x, y)


def solve(x, y, name=None):
    return dispatch("solve", _solve_impl, *binary_args(x, y))


def _triangular_solve_impl(x, y, upper, transpose, unitriangular):
    a = x
    if transpose:
        a = a.transpose(-1, -2)
        upper = not upper
    return torch.linalg.solve_triangular(a, y, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return dispatch("triangular_solve", _triangular_solve_impl,
                    *binary_args(x, y), upper=bool(upper),
                    transpose=bool(transpose),
                    unitriangular=bool(unitriangular))


def _lu_impl(x):
    lu, piv = torch.linalg.lu_factor(x)
    return lu, piv.to(torch.int32)   # torch's pivots are 1-based too


def lu(x, pivot=True, get_infos=False, name=None):
    x = ensure_tensor(x)
    lu_t, piv = dispatch("lu", _lu_impl, x)
    if get_infos:
        v = raw(x)
        info = Tensor._wrap(torch.zeros(v.shape[:-2], dtype=torch.int32,
                                        device=v.device))
        return lu_t, piv, info
    return lu_t, piv


def _matrix_power_impl(x, n):
    return torch.linalg.matrix_power(x, n)


def matrix_power(x, n, name=None):
    return dispatch("matrix_power", _matrix_power_impl, ensure_tensor(x),
                    n=int(n))


def _host_eig(x, values_only):
    v = raw(ensure_tensor(x)).detach()
    a = v.cpu().numpy()
    if values_only:
        w = np.linalg.eigvals(a)
        return Tensor._wrap(torch.from_numpy(w).to(v.device))
    w, vec = np.linalg.eig(a)
    return (Tensor._wrap(torch.from_numpy(w).to(v.device)),
            Tensor._wrap(torch.from_numpy(vec).to(v.device)))


def eig(x, name=None):
    """On the host through NumPy, as the reference runs it."""
    return _host_eig(x, False)


def eigvals(x, name=None):
    return _host_eig(x, True)


def _eigh_impl(x, UPLO):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


def eigh(x, UPLO="L", name=None):
    return dispatch("eigh", _eigh_impl, ensure_tensor(x), UPLO=UPLO)


def _eigvalsh_impl(x, UPLO):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return dispatch("eigvalsh", _eigvalsh_impl, ensure_tensor(x), UPLO=UPLO)


def _matrix_rank_impl(x, tol, hermitian):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian) \
        .to(torch.int64)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return nondiff("matrix_rank", _matrix_rank_impl, ensure_tensor(x),
                   tol=tol, hermitian=bool(hermitian))


def _lstsq_impl(x, y, rcond):
    # gelsd (SVD-based, the reference's algorithm) exists on the CPU
    driver = "gelsd" if x.device.type == "cpu" else None
    sol, res, rank, sv = torch.linalg.lstsq(x, y, rcond=rcond,
                                            driver=driver)
    return sol, res, rank.to(torch.int64), sv


def lstsq(x, y, rcond=None, driver=None, name=None):
    return dispatch("lstsq", _lstsq_impl, *binary_args(x, y), rcond=rcond)


def _cond_impl(x, p):
    return torch.linalg.cond(x, p=p)


def cond(x, p=None, name=None):
    return dispatch("cond", _cond_impl, ensure_tensor(x), p=p)


def _cov_impl(x, rowvar, ddof):
    return torch.cov(x if rowvar else x.T, correction=ddof)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return dispatch("cov", _cov_impl, ensure_tensor(x), rowvar=bool(rowvar),
                    ddof=1 if ddof else 0)


def _corrcoef_impl(v, rowvar):
    return torch.corrcoef(v if rowvar else v.T)


def corrcoef(x, rowvar=True, name=None):
    return dispatch("corrcoef", _corrcoef_impl, ensure_tensor(x),
                    rowvar=bool(rowvar))


def _cross_impl(x, y, axis):
    return torch.linalg.cross(x, y, dim=axis)


def cross(x, y, axis=9, name=None):
    x, y = binary_args(x, y)
    if axis == 9:
        axis = next((i for i, s in enumerate(raw(x).shape) if s == 3), 0)
    return dispatch("cross", _cross_impl, x, y, axis=int(axis))


def multi_dot(x, name=None):
    return functools.reduce(matmul, list(x))


def _matrix_exp_impl(x):
    return torch.linalg.matrix_exp(x)


def matrix_exp(x, name=None):
    return dispatch("matrix_exp", _matrix_exp_impl, ensure_tensor(x))


def _lu_unpack_impl(lu_data, lu_pivots, unpack_ludata, unpack_pivots):
    p, low, up = torch.lu_unpack(lu_data, lu_pivots.to(torch.int32),
                                 unpack_data=unpack_ludata,
                                 unpack_pivots=unpack_pivots)
    return (p if unpack_pivots else None,
            low if unpack_ludata else None,
            up if unpack_ludata else None)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) from ``lu``'s packed factors and 1-based pivots."""
    return dispatch("lu_unpack", _lu_unpack_impl, ensure_tensor(x),
                    ensure_tensor(y), unpack_ludata=bool(unpack_ludata),
                    unpack_pivots=bool(unpack_pivots))


def _householder_product_impl(x, tau):
    return torch.linalg.householder_product(x, tau)


def householder_product(x, tau, name=None):
    return dispatch("householder_product", _householder_product_impl,
                    *binary_args(x, tau))


def _ormqr_impl(x, tau, other, left, transpose):
    return torch.ormqr(x, tau, other, left=left, transpose=transpose)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    return dispatch("ormqr", _ormqr_impl, ensure_tensor(x),
                    ensure_tensor(tau), ensure_tensor(other), left=bool(left),
                    transpose=bool(transpose))


def _svd_lowrank(x, q, niter):
    from ..framework.random import generator
    a0 = raw(x)
    m, n = a0.shape[-2], a0.shape[-1]
    trans = m < n
    a = a0.transpose(-1, -2) if trans else a0
    at = a.transpose(-1, -2)
    omega = torch.empty(a.shape[:-2] + (a.shape[-1], q), dtype=a.dtype,
                        device=a.device)
    omega.normal_(generator=generator(a.device))
    qmat = torch.linalg.qr(a @ omega).Q
    for _ in range(niter):
        z = torch.linalg.qr(at @ qmat).Q
        qmat = torch.linalg.qr(a @ z).Q
    b = qmat.transpose(-1, -2) @ a
    u_b, s, vh = torch.linalg.svd(b, full_matrices=False)
    u, v = qmat @ u_b, vh.transpose(-1, -2)
    if trans:
        u, v = v, u
    return Tensor._wrap(u), Tensor._wrap(s), Tensor._wrap(v)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (Halko et al.): (U, S, V)."""
    x = ensure_tensor(x)
    if M is not None:
        x = Tensor._wrap(raw(x) - raw(ensure_tensor(M)))
    q = min(int(q), *raw(x).shape[-2:])
    return _svd_lowrank(x, q, int(niter))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Low-rank PCA through the randomized SVD of the (centered) data."""
    x = ensure_tensor(x)
    m, n = raw(x).shape[-2:]
    q = min(6, m, n) if q is None else q
    if center:
        x = Tensor._wrap(raw(x) - raw(x).mean(-2, keepdim=True))
    return _svd_lowrank(x, min(int(q), m, n), int(niter))
