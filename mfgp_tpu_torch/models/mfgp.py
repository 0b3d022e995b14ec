"""Linear multi-fidelity GP (Kennedy-O'Hagan / AR1), functional core in
PyTorch (counterpart of ``mfgp_tpu/models/mfgp.py:48-495``).

Model: ``f_0 = g_0``, ``f_i = rho_i f_{i-1} + g_i`` with independent
``g_i ~ GP(0, k_i)``, so ``cov(f_i(x), f_j(x')) = sum_m W[m,i] W[m,j]
k_m(x, x')`` with ``W[m,f] = prod_{l=m+1..f} rho_l``.

Plain functions on tensors: the device and dtype come from the inputs.
On a CUDA float32 problem with an rbf or matern32 base the three
hand-written kernels carry the work (``ops/cuda_kernels``): every
covariance assembly (B1, including the K assembly of ``_nlml_vg_core``,
which the JAX package leaves to an XLA composition of the same
mathematics), the gradient's K^-1 contractions (B2) and the grid posterior
(B3). Elsewhere the plain compositions run. Cholesky, triangular solves and
products are torch.linalg / torch.matmul in IEEE fp32 or fp64.

Not here yet: the ``MFGP`` class, the fit loops and the autograd NLML.
``nlml`` is forward-only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import cuda_kernels as _ck
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la

_LOG2PI = math.log(2.0 * math.pi)


class MFGPParams(NamedTuple):
    log_variances: torch.Tensor  # (F,)
    log_lengthscales: torch.Tensor  # (F, D)
    rhos: torch.Tensor  # (F-1,), unconstrained (emukit's ``scale``)
    log_noises: torch.Tensor  # (F,)

    @property
    def variances(self):
        return torch.exp(self.log_variances)

    @property
    def lengthscales(self):
        return torch.exp(self.log_lengthscales)

    @property
    def noises(self):
        return torch.exp(self.log_noises)

    def to_vector(self) -> torch.Tensor:
        """GPy ``param_array`` layout: per fidelity [var, l_1..l_D], then
        the rhos, then the noises (17 entries at F=3, D=3)."""
        per_kern = torch.cat([torch.cat([v[None], l]) for v, l in
                              zip(self.variances, self.lengthscales)])
        return torch.cat([per_kern, self.rhos, self.noises])

    @staticmethod
    def from_vector(v: torch.Tensor, n_fidelities: int,
                    D: int) -> "MFGPParams":
        F = n_fidelities
        per = v[:F * (D + 1)].reshape(F, D + 1)
        rhos = v[F * (D + 1):F * (D + 1) + F - 1]
        noises = v[F * (D + 1) + F - 1:]
        return MFGPParams(torch.log(per[:, 0]), torch.log(per[:, 1:]),
                          rhos, torch.log(noises))


class MFGPState(NamedTuple):
    X: torch.Tensor  # (N, D)
    fid: torch.Tensor  # (N,) integer labels
    y: torch.Tensor  # (N,)
    L: torch.Tensor  # (N, N) lower Cholesky factor
    alpha: torch.Tensor


class MFGPStateInv(NamedTuple):
    """Conditioned state carrying the explicit inverse factor ``Linv =
    L^-1`` (computed for the gradient's K^-1 anyway), so the posterior's
    substitution becomes a triangular product."""

    X: torch.Tensor  # (N, D)
    fid: torch.Tensor  # (N,) integer labels
    y: torch.Tensor  # (N,)
    Linv: torch.Tensor | None  # (N, N) inverse lower Cholesky factor
    alpha: torch.Tensor


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_from_numpy(log_variances, log_lengthscales, rhos, log_noises,
                      device, dtype) -> MFGPParams:
    """The port's parameters from the JAX package's (``np.asarray`` of each
    ``mfgp_tpu`` ``MFGPParams`` field)."""
    return MFGPParams(*(_tensor(a, device, dtype) for a in
                        (log_variances, log_lengthscales, rhos, log_noises)))


def state_inv_from_numpy(X, fid, y, Linv, alpha, device,
                         dtype) -> MFGPStateInv:
    """The port's ``MFGPStateInv`` from the JAX package's (numpy arrays of
    its fields); fidelity labels become int64."""
    return MFGPStateInv(
        _tensor(X, device, dtype), _tensor(fid, device, torch.long),
        _tensor(y, device, dtype),
        None if Linv is None else _tensor(Linv, device, dtype),
        _tensor(alpha, device, dtype))


def nlml(params: MFGPParams, X, fid, y, kernel: str = "rbf",
         jitter: float = 0.0) -> torch.Tensor:
    """Exact NLML with per-fidelity noise (forward only)."""
    N = X.shape[0]
    Kn = _cov.mf_train_cov(params.variances, params.lengthscales,
                           params.rhos, params.noises, X, fid, jitter,
                           kernel)
    L = _la.chol(Kn)
    del Kn
    alpha = _la.solve_posterior(L, y)
    return (0.5 * torch.dot(y, alpha) + 0.5 * _la.logdet_from_chol(L)
            + 0.5 * N * _LOG2PI)


def _nlml_vg_core(params: MFGPParams, X, fid, y, kernel: str,
                  jitter: float, inv_mode: str | None = None):
    """NLML and its analytic gradient (rhos held fixed); returns
    ``(val, grad, alpha, Linv)``.

    ``inv_mode=None``: alpha by two triangular solves, K^-1 by two blocked
    triangular solves (Linv is None). ``inv_mode="highest"``: the explicit
    inverse factor Linv (triangular divide and conquer), alpha as two
    triangular products with it, and the gradient from Linv through the
    fused B2 kernel (CUDA float32) or the structure-aware syrk and the
    plain contractions. There is no reduced-precision mode: the port's
    products are IEEE fp32 or fp64.

    Each N x N buffer is freed once consumed (Kn after the factorization,
    L after alpha and K^-1 or Linv are formed, K^-1 after the
    contractions), and no base kernel stays alive for the gradient (the
    contractions rebuild each one): at N=20,000 every f32 N x N buffer is
    1.6 GB.
    """
    if kernel not in ("rbf", "matern32"):
        raise NotImplementedError(f"analytic gradient: {kernel}")
    if inv_mode not in (None, "highest"):
        raise ValueError(f"inv_mode must be None or 'highest', got "
                         f"{inv_mode!r}")
    N = X.shape[0]
    v, ls, rhos, nz = (params.variances, params.lengthscales, params.rhos,
                       params.noises)
    Kn = _cov.mf_train_cov(v, ls, rhos, nz, X, fid, jitter, kernel)
    L = _la.chol(Kn)
    del Kn
    logdet = _la.logdet_from_chol(L)
    if inv_mode is None:
        alpha = _la.solve_posterior(L, y)
        Kinv = _la.chol_solve_blocked(
            L, torch.eye(N, dtype=X.dtype, device=X.device))
        del L
        g = _ck.grad_from_kinv(Kinv, alpha, X, fid, v, ls, rhos, nz, kernel)
        del Kinv
        Linv = None
    else:
        Linv = _la.tri_inv_recursive(L)
        del L
        z = _la.tri_lower_matmul(Linv, y[:, None])
        alpha = _la.tri_lower_matmul_right(z.reshape(1, -1),
                                           Linv).reshape(-1)
        grad_fn = (_ck.syrk_grad_fused if _cov.use_cuda_kernels(X, kernel)
                   else _ck.syrk_grad_fused_plain)
        g = grad_fn(Linv, alpha, X, fid, v, ls, rhos, nz, kern=kernel)
    val = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * N * _LOG2PI
    g_logvar, g_logls, g_lognoise = g
    grad = MFGPParams(g_logvar, g_logls, torch.zeros_like(rhos), g_lognoise)
    return val, grad, alpha, Linv


def nlml_value_and_grad(params: MFGPParams, X, fid, y, kernel: str = "rbf",
                        jitter: float = 0.0):
    """NLML and its analytic trace-identity gradient (rhos held fixed,
    their gradient zero)."""
    val, grad, *_ = _nlml_vg_core(params, X, fid, y, kernel, jitter)
    return val, grad


def nlml_value_grad_state_inv(params: MFGPParams, X, fid, y,
                              kernel: str = "rbf", jitter: float = 0.0,
                              inv_mode: str | None = "highest"):
    """(value, grad, MFGPStateInv) from ONE factorization: the train step
    of the benchmark unit. The state carries Linv for ``predict_fused``."""
    val, grad, alpha, Linv = _nlml_vg_core(params, X, fid, y, kernel,
                                           jitter, inv_mode=inv_mode)
    return val, grad, MFGPStateInv(X, fid, y, Linv, alpha)


def condition(params: MFGPParams, X, fid, y, kernel: str = "rbf",
              jitter: float = 0.0) -> MFGPState:
    Kn = _cov.mf_train_cov(params.variances, params.lengthscales,
                           params.rhos, params.noises, X, fid, jitter,
                           kernel)
    L = _la.chol(Kn)
    del Kn
    return MFGPState(X, fid, y, L, _la.solve_posterior(L, y))


def _kss(params: MFGPParams, fid_s) -> torch.Tensor:
    """Prior variance of each test point at its fidelity."""
    W = _k.ar1_fidelity_weights(params.rhos, params.variances.shape[0])
    return torch.sum((W[:, fid_s] ** 2) * params.variances[:, None], dim=0)


def predict(params: MFGPParams, state: MFGPState, Xs, fid_s,
            kernel: str = "rbf", full_cov: bool = False,
            include_noise: bool = True):
    """Posterior at test points with fidelity labels ``fid_s``;
    ``include_noise`` adds the per-fidelity likelihood noise (emukit's
    wrapper ``predict``)."""
    Kxs = _cov.mf_cross_cov(params.variances, params.lengthscales,
                            params.rhos, Xs, fid_s, state.X, state.fid,
                            kernel)
    mean = _la.posterior_mean(Kxs, state.alpha)
    M = Xs.shape[0]
    noise = (_k.mf_noise_diag(fid_s, params.noises) if include_noise
             else Xs.new_zeros(M))
    if full_cov:
        Kss = _cov.mf_cross_cov(params.variances, params.lengthscales,
                                params.rhos, Xs, fid_s, Xs, fid_s, kernel)
        cov = _la.posterior_cov(Kss, Kxs, state.L)
        return mean, _la.diag_add(cov, noise.to(cov.dtype))
    var = _la.posterior_var(_kss(params, fid_s), Kxs, state.L) + noise
    return mean, var


def _blocked(one, Xs, fid_s, block_size: int):
    outs = [one(Xs[lo:lo + block_size], fid_s[lo:lo + block_size])
            for lo in range(0, Xs.shape[0], block_size)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def predict_blocked(params: MFGPParams, state: MFGPState, Xs, fid_s,
                    kernel: str = "rbf", include_noise: bool = True,
                    block_size: int = 1024):
    """Posterior mean/variance over grid-row blocks (peak memory
    block_size x N)."""
    def one(xb, fb):
        Kxs = _cov.mf_cross_cov(params.variances, params.lengthscales,
                                params.rhos, xb, fb, state.X, state.fid,
                                kernel)
        var = _la.posterior_var(_kss(params, fb), Kxs, state.L)
        if include_noise:
            var = var + _k.mf_noise_diag(fb, params.noises)
        return _la.posterior_mean(Kxs, state.alpha), var

    return _blocked(one, Xs, fid_s, block_size)


def predict_blocked_inv(params: MFGPParams, state: MFGPStateInv, Xs, fid_s,
                        kernel: str = "rbf", include_noise: bool = True,
                        block_size: int = 1024):
    """predict_blocked from an MFGPStateInv: the variance's substitution
    is the triangular product ``V = Linv Kxs^T`` per block."""
    def one(xb, fb):
        Kxs = _cov.mf_cross_cov(params.variances, params.lengthscales,
                                params.rhos, xb, fb, state.X, state.fid,
                                kernel)
        V = _la.tri_lower_matmul(state.Linv, Kxs.T)
        var = _kss(params, fb) - torch.sum(V * V, dim=0)
        if include_noise:
            var = var + _k.mf_noise_diag(fb, params.noises)
        return _la.posterior_mean(Kxs, state.alpha), var

    return _blocked(one, Xs, fid_s, block_size)


def predict_fused(params: MFGPParams, state: MFGPStateInv, Xs, fid_s,
                  kernel: str = "rbf", include_noise: bool = True):
    """Posterior mean/variance over the grid through the B3 kernel (CUDA
    float32; the plain composition elsewhere): same contract as
    predict_blocked_inv."""
    post = (_ck.posterior_fused if _cov.use_cuda_kernels(state.X, kernel)
            else _ck.posterior_fused_plain)
    mu, quad = post(state.Linv, state.alpha, state.X, state.fid, Xs, fid_s,
                    params.variances, params.lengthscales, params.rhos,
                    kern=kernel)
    var = _kss(params, fid_s) - quad
    if include_noise:
        var = var + _k.mf_noise_diag(fid_s, params.noises)
    return mu, var
