"""Grid- and column-sharded GP computations over the mesh's mp dimension
(counterpart of ``mfgp_tpu/parallel/sharded.py``).

Every rank runs the same function; what the JAX package lays out with
``shard_map`` is here each rank's own slice:

* training data, the Cholesky factor and the weights are replicated (every
  rank computes them),
* the grid/test axis is sharded over mp: each rank computes its rows of
  ``K(X*, X)`` and its posterior slice with the single-device functions,
  and the slices are gathered, so the output is whole on every rank,
* scalar reductions (Frobenius norms, gradient sums) are ``psum`` over mp.

On the card the covariance blocks come from B1 (``ops/cuda_kernels``)
through the single-device functions' own dispatch (``ops/covariance``).
"""

from __future__ import annotations

import math

import torch

from mfgp_tpu_torch.models import gp as _gp
from mfgp_tpu_torch.models import mfgp as _mf
from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.parallel.mesh import (MP_AXIS, all_gather, axis_size,
                                          pad_to_multiple, psum, shard_rows)

_LOG2PI = math.log(2.0 * math.pi)
# elements of one row block of the gradient's N x Nc terms (256 MB in
# float32), as ops/cuda_kernels.grad_from_kinv blocks its N x N terms
_ROW_BLOCK_ELEMS = 1 << 26


def _pad_rows(a: torch.Tensor, m: int):
    """Pad axis 0 with zeros to a multiple of m. Returns (padded,
    original_len)."""
    n = a.shape[0]
    np_ = pad_to_multiple(n, m)
    if np_ == n:
        return a, n
    return torch.cat([a, a.new_zeros((np_ - n,) + a.shape[1:])]), n


def _rows_sharded(mesh, fn, *rows):
    """``fn`` on this rank's mp block of each of ``rows`` (padded to a
    multiple of the axis size), its outputs gathered whole and cut back to
    the original length."""
    n_mp = axis_size(mesh, MP_AXIS)
    padded = [_pad_rows(r, n_mp)[0] for r in rows]
    outs = fn(*(shard_rows(mesh, p) for p in padded))
    n = rows[0].shape[0]
    if isinstance(outs, torch.Tensor):
        return all_gather(mesh, outs)[:n]
    return tuple(all_gather(mesh, o)[:n] for o in outs)


def make_sharded_gp_predict(mesh, kernel: str = "rbf"):
    """Posterior mean/var over a grid, rows sharded over the mp axis.

    Returns ``f(params, state, grid) -> (mean, var)``, whole on every rank;
    the train-side state is replicated. The per-shard body is the
    single-device posterior (``models.gp.predict``)."""
    def f(params: _gp.GPParams, state: _gp.GPState, grid):
        return _rows_sharded(
            mesh, lambda g: _gp.predict(params, state, g, kernel=kernel),
            grid)

    return f


def make_sharded_mfgp_predict(mesh, kernel: str = "rbf"):
    """MFGP posterior over a fidelity-labelled grid, mp-sharded rows
    (``models.mfgp.predict`` per shard)."""
    def f(params: _mf.MFGPParams, state: _mf.MFGPState, grid, grid_fid):
        return _rows_sharded(
            mesh, lambda g, gf: _mf.predict(params, state, g, gf,
                                            kernel=kernel), grid, grid_fid)

    return f


def make_sharded_weighted_mse(mesh, normalize: bool = True):
    """Precision-weighted MSE with the identity solve sharded over columns.

    ``WMSE = e^T (Sigma^-1 / |Sigma^-1|_F) e / n`` (reference metric,
    reference/GPTrainers.py:127-137). The O(M^3) part, the solve of Sigma
    against the identity for the Frobenius normalisation, is split over
    identity columns on the mp axis: each rank solves its column block with
    the replicated Cholesky factor and its partial sum of squares is
    ``psum``'d."""
    n_mp = axis_size(mesh, MP_AXIS)

    def f(err: torch.Tensor, Sigma: torch.Tensor):
        n = err.shape[0]
        L = _la.chol(Sigma)
        quad = torch.dot(err, _la.chol_solve(L, err))
        if not normalize:
            return quad / n
        eye = torch.eye(n, pad_to_multiple(n, n_mp), dtype=Sigma.dtype,
                        device=Sigma.device)
        Sinv_cols = _la.chol_solve(L, shard_rows(mesh, eye.T).T)
        total_sq = psum(mesh, torch.sum(Sinv_cols * Sinv_cols))
        return quad / torch.sqrt(total_sq) / n

    return f


def _eye_cols(n: int, cols: torch.Tensor, like: torch.Tensor):
    """The identity's columns ``cols``, (n, len(cols)) in ``like``'s dtype
    and device."""
    eye = like.new_zeros((n, cols.shape[0]))
    eye[cols, torch.arange(cols.shape[0], device=cols.device)] = 1.0
    return eye


def _weigh_block_lower(W, cols, block):
    """Weight W's block-lower columns ``cols`` (whole panels of width
    ``block``) for a sum over the whole symmetric matrix, in place: each
    entry twice below its column's panel, once in it, and not above."""
    for q, p0 in enumerate(cols[::block].tolist()):
        c = slice(q * block, (q + 1) * block)
        W[:p0, c] = 0.0
        W[p0 + block:, c] *= 2.0


def _sharded_grad(mesh, Kinv_cols, alpha, X, fid, cols, params,
                  block_lower=None):
    """The AR1 NLML gradient (rbf, rhos held fixed) from this rank's
    columns ``cols`` of K^-1 (``Kinv_cols``, (N, Nc), overwritten with
    those of W = K^-1 - alpha alpha^T): each rank's partial sums
    ``[sum(W o T_m) (F), sum(W o T_m o S_d) (F x D), sum_{fid_i=f} W_ii
    (F)]`` over its columns, with T_m = var_m (w_m w_m^T) o k_m and S_d =
    (x_d 1^T - 1 x_d^T)^2, are ``psum``'d over mp into the whole matrix's,
    then g_logvar = sum(W o T)/2, g_logls = sum(W o T o S)/(2 l^2) and
    g_lognoise = noise sum W_ii / 2. On the card k_m(X, X[cols]) is B1 at
    F=1.

    S_d is summed from differences, as ``ops/cuda_kernels.grad_from_kinv``
    does: the JAX package takes the lengthscale term as ``sum x^2 s - sum
    x (A x)`` from row sums, which cancels in float32 for close points far
    from the origin (ROADMAP C5). The N x Nc terms are formed a block of
    rows at a time.

    With ``block_lower`` (a panel width) ``Kinv_cols`` holds K^-1's
    block-lower part only (``chol._kinv_block_lower_cols``), and W is
    weighted by ``_weigh_block_lower``: every T_m is symmetric, so the
    sums are the whole matrix's."""
    N, D = X.shape
    F = params.variances.shape[0]
    Nc = cols.shape[0]
    W = Kinv_cols.sub_(alpha[:, None] * alpha[cols][None, :])
    if block_lower:
        _weigh_block_lower(W, cols, block_lower)
    Xc = X[cols]
    wf = _k.ar1_fidelity_weights(params.rhos, F)
    w_full, w_cols = wf[:, fid], wf[:, fid[cols]]
    rows = max(1, _ROW_BLOCK_ELEMS // Nc)
    s = X.new_zeros(F)
    quad = X.new_zeros((F, D))
    for m in range(F):
        Km = _cov.sf_cross_cov(1.0, params.lengthscales[m], X, Xc, "rbf")
        for i0 in range(0, N, rows):
            i1 = min(N, i0 + rows)
            A = W[i0:i1] * Km[i0:i1] * (params.variances[m]
                                        * w_full[m, i0:i1, None]
                                        * w_cols[m, None, :])
            s[m] += torch.sum(A)
            for d in range(D):
                quad[m, d] += torch.sum(
                    A * (X[i0:i1, None, d] - Xc[None, :, d]) ** 2)
            del A
        del Km
    diag = W[cols, torch.arange(Nc, device=cols.device)]
    fc = fid[cols]
    noise = torch.stack([torch.sum(torch.where(fc == f, diag, 0.0))
                         for f in range(F)])
    sums = psum(mesh, torch.cat([s, quad.reshape(-1), noise]))
    s, quad, noise = sums[:F], sums[F:F + F * D].reshape(F, D), sums[-F:]
    return _mf.MFGPParams(0.5 * s, 0.5 * quad / params.lengthscales ** 2,
                          torch.zeros_like(params.rhos),
                          0.5 * params.noises * noise)


def make_sharded_nlml_value_and_grad(mesh, jitter: float = 0.0):
    """mp-distributed analytic MFGP NLML gradient (RBF, rhos fixed).

    The gradient's dominant cost and memory is the explicit ``K_n^-1``
    (models/mfgp.nlml_value_and_grad). Here each rank owns a column block
    of the inverse: it solves the replicated Cholesky factor against its
    identity columns and contributes its partial gradient sums, ``psum``'d
    over mp. Per-rank memory for the inverse drops from O(N^2) to
    O(N^2 / n_mp).

    Returns ``f(params, X, fid, y) -> (value, MFGPParams grad)`` with the
    single-device function's semantics; N must divide by the mp extent."""
    n_mp = axis_size(mesh, MP_AXIS)

    def f(params: _mf.MFGPParams, X, fid, y):
        N = X.shape[0]
        if N % n_mp:
            raise ValueError(
                f"N={N} must be divisible by the mp axis ({n_mp}); pad the "
                "training set (padding with decoupled pseudo-points changes "
                "the logdet, so it is not done implicitly)")
        Kn = _cov.mf_train_cov(params.variances, params.lengthscales,
                               params.rhos, params.noises, X, fid, jitter,
                               "rbf")
        L = _la.chol(Kn)
        del Kn
        alpha = _la.solve_posterior(L, y)
        logdet = _la.logdet_from_chol(L)
        val = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * N * _LOG2PI
        Nc = N // n_mp
        c0 = mesh.get_local_rank(MP_AXIS) * Nc
        cols = torch.arange(c0, c0 + Nc, device=X.device)
        Kinv_cols = _la.chol_solve_blocked(L, _eye_cols(N, cols, X))
        del L
        return val, _sharded_grad(mesh, Kinv_cols, alpha, X, fid, cols,
                                  params)

    return f


def make_sharded_ar1_cross_cov(mesh, kernel: str = "rbf"):
    """Cross-covariance ``K(grid, X)`` with grid rows mp-sharded, whole on
    every rank; each rank's block is one covariance over its grid rows
    against the replicated training set (B1 on the card)."""
    def f(grid, grid_fid, X, fid, params: _mf.MFGPParams):
        return _rows_sharded(
            mesh, lambda g, gf: _cov.mf_cross_cov(
                params.variances, params.lengthscales, params.rhos, g, gf,
                X, fid, kernel), grid, grid_fid)

    return f
