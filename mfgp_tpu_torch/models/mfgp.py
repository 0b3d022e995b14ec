"""Linear multi-fidelity GP (Kennedy-O'Hagan / AR1) in PyTorch (counterpart
of ``mfgp_tpu/models/mfgp.py``).

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

``nlml`` is differentiable by autograd in every parameter, rhos included;
on the card its Gram is ``ops.covariance._AR1TrainCov`` (B1 forward,
closed-form backward). The ``MFGP`` class fits with scipy's L-BFGS-B on
that autodiff NLML (``optimize``) or with the restart-batched L-BFGS on
the analytic gradient (``optimize_restarts``), as the JAX class does.

Data convention (the JAX package's): fidelity 0 is the lowest; inputs may
carry a trailing fidelity column (``split_augmented``), and the parameter
vector is GPy's 17-entry ``param_array`` at F=3, D=3.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import cuda_kernels as _ck
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.ops.optimize import (autograd_value_and_grad,
                                         batched_lbfgs, penalize_nonfinite,
                                         restart_inits, scipy_lbfgsb)

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

    @staticmethod
    def default(n_fidelities: int, D: int, dtype=torch.float64,
                device=None) -> "MFGPParams":
        """GPy/emukit defaults: variances, lengthscales, rhos and noises 1."""
        z = dict(dtype=dtype, device=device)
        return MFGPParams(torch.zeros(n_fidelities, **z),
                          torch.zeros((n_fidelities, D), **z),
                          torch.ones(n_fidelities - 1, **z),
                          torch.zeros(n_fidelities, **z))


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


def split_augmented(X_aug: torch.Tensor):
    """Split ``[X | fid]`` augmented inputs (emukit convention); X comes
    back contiguous, as the CUDA kernels take it."""
    return X_aug[:, :-1].contiguous(), X_aug[:, -1].long()


def augment(X: torch.Tensor, fid) -> torch.Tensor:
    f = torch.broadcast_to(torch.as_tensor(fid, dtype=X.dtype,
                                           device=X.device), (X.shape[0],))
    return torch.cat([X, f[:, None]], dim=1)


def stack_fidelity_lists(X_list: Sequence, y_list: Sequence | None = None):
    """emukit ``convert_xy_lists_to_arrays``: per-fidelity lists, lowest
    fidelity first, to dense ``(X, fid)`` or ``(X, fid, y)``. A fidelity
    may have no points."""
    X = torch.cat([torch.as_tensor(x) for x in X_list])
    fid = torch.cat([torch.full((len(x),), i, dtype=torch.long,
                                device=X.device)
                     for i, x in enumerate(X_list)])
    if y_list is None:
        return X, fid
    y = torch.cat([torch.as_tensor(yy, device=X.device).reshape(-1)
                   for yy in y_list])
    return X, fid, y


def _assemble_noisy_cov(params: MFGPParams, X, fid, jitter,
                        kernel: str) -> torch.Tensor:
    """Differentiable training covariance plus the noise (and jitter)
    diagonal. The JAX package rematerialises this under autodiff
    (``jax.checkpoint``); here nothing N x N is kept for the backward: on
    the card ``_AR1TrainCov`` saves only its O(N) inputs."""
    K = _cov.ar1_cov_diff(params.variances, params.lengthscales,
                          params.rhos, X, fid, kernel)
    return _la.diag_add(K, _k.mf_noise_diag(fid, params.noises) + jitter)


def nlml(params: MFGPParams, X, fid, y, kernel: str = "rbf",
         jitter: float = 0.0) -> torch.Tensor:
    """Exact NLML with per-fidelity noise, differentiable by autograd in
    every parameter. NaN where the Gram is not positive definite."""
    N = X.shape[0]
    L = _la.chol(_assemble_noisy_cov(params, X, fid, jitter, kernel))
    alpha = _la.solve_posterior(L, y)
    return (0.5 * torch.dot(y, alpha) + 0.5 * _la.logdet_from_chol(L)
            + 0.5 * N * _LOG2PI)


def _nlml_vg_core(params: MFGPParams, X, fid, y, kernel: str,
                  jitter, inv_mode: str | None = None, keep_L: bool = False):
    """NLML and its analytic gradient (rhos held fixed); returns
    ``(val, grad, L, alpha, Linv)``. ``jitter`` may be a per-point (N,)
    vector (the GP's extra noise).

    ``inv_mode=None``: alpha by two triangular solves, K^-1 by two blocked
    triangular solves; L is returned when ``keep_L`` (the conditioned
    state's factor), else freed before the contractions.
    ``inv_mode="highest"``: the explicit inverse factor Linv (triangular
    divide and conquer), alpha as two triangular products with it, and the
    gradient from Linv through the fused B2 kernel (CUDA float32) or the
    structure-aware syrk and the plain contractions; L is not returned.
    There is no reduced-precision mode: the port's products are IEEE fp32
    or fp64.

    Each N x N buffer is freed once consumed (Kn after the factorization,
    L after K^-1 or Linv is formed, K^-1 after the contractions), and no
    base kernel stays alive for the gradient (the contractions rebuild
    each one): at N=20,000 every f32 N x N buffer is 1.6 GB.
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
        if not keep_L:
            L = None
        g = _ck.grad_from_kinv(Kinv, alpha, X, fid, v, ls, rhos, nz, kernel)
        del Kinv
        Linv = None
    else:
        Linv = _la.tri_inv_recursive(L)
        L = None
        z = _la.tri_lower_matmul(Linv, y[:, None])
        alpha = _la.tri_lower_matmul_right(z.reshape(1, -1),
                                           Linv).reshape(-1)
        grad_fn = (_ck.syrk_grad_fused if _cov.use_cuda_kernels(X, kernel)
                   else _ck.syrk_grad_fused_plain)
        g = grad_fn(Linv, alpha, X, fid, v, ls, rhos, nz, kern=kernel)
    val = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * N * _LOG2PI
    g_logvar, g_logls, g_lognoise = g
    grad = MFGPParams(g_logvar, g_logls, torch.zeros_like(rhos), g_lognoise)
    return val, grad, L, alpha, Linv


def nlml_value_and_grad(params: MFGPParams, X, fid, y, kernel: str = "rbf",
                        jitter: float = 0.0):
    """NLML and its analytic trace-identity gradient (rhos held fixed,
    their gradient zero)."""
    val, grad, *_ = _nlml_vg_core(params, X, fid, y, kernel, jitter)
    return val, grad


def nlml_value_grad_state(params: MFGPParams, X, fid, y,
                          kernel: str = "rbf", jitter: float = 0.0):
    """(value, grad, MFGPState) sharing one factorization: a fit's last
    step needs both the gradient and the conditioned posterior state."""
    val, grad, L, alpha, _ = _nlml_vg_core(params, X, fid, y, kernel,
                                           jitter, keep_L=True)
    return val, grad, MFGPState(X, fid, y, L, alpha)


def nlml_value_grad_state_inv(params: MFGPParams, X, fid, y,
                              kernel: str = "rbf", jitter: float = 0.0,
                              inv_mode: str | None = "highest"):
    """(value, grad, MFGPStateInv) from ONE factorization: the train step
    of the benchmark unit. The state carries Linv for ``predict_fused``."""
    val, grad, _, alpha, Linv = _nlml_vg_core(params, X, fid, y, kernel,
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


def _blocked(one, block_size: int, *rows):
    """``one`` over blocks of ``block_size`` rows of each of ``rows``; the
    (mean, var) pairs concatenated."""
    outs = [one(*(r[lo:lo + block_size] for r in rows))
            for lo in range(0, rows[0].shape[0], block_size)]
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

    return _blocked(one, block_size, Xs, fid_s)


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

    return _blocked(one, block_size, Xs, fid_s)


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


def _mf_fit_restarts(inits, X, fid, y, fixed_rhos, lower, upper,
                     kernel: str, jitter: float, maxiter: int,
                     tol: float = 1e-6, ftol: float = 0.0):
    """Restart-batched projected L-BFGS for the AR1 MFGP on the analytic
    gradient, rhos fixed: ``inits`` is (R, 2F + F D), each row
    ``[log variances, log lengthscales, log noises]``. A non-finite NLML
    counts as 1e20 with a zero gradient, and non-finite gradient entries
    as zero. Returns ``(xs (R, n), fs (R,))``."""
    F = fixed_rhos.shape[0] + 1
    D = X.shape[1]

    def vg(vec):
        p = MFGPParams(vec[:F], vec[F:F + F * D].reshape(F, D), fixed_rhos,
                       vec[F + F * D:])
        v, g = nlml_value_and_grad(p, X, fid, y, kernel=kernel,
                                   jitter=jitter)
        return penalize_nonfinite(v, torch.cat([
            g.log_variances, g.log_lengthscales.reshape(-1), g.log_noises]))

    with torch.no_grad():
        xs, fs, _ = batched_lbfgs(None, inits, lower=lower, upper=upper,
                                  maxiter=maxiter, tol=tol, ftol=ftol,
                                  value_and_grad=vg)
    return xs, fs


def _as_data(X, fid, y):
    """(X, fid, y) as tensors on X's device: X at least 2-D, integer
    labels, y flat in X's dtype (an (N, 1) column is accepted)."""
    X = torch.atleast_2d(torch.as_tensor(X))
    fid = torch.as_tensor(fid, device=X.device).long().reshape(-1)
    y = torch.as_tensor(y, dtype=X.dtype, device=X.device).reshape(-1)
    return X, fid, y


@dataclass
class MFGP:
    """Stateful wrapper mirroring emukit's call sites (the JAX package's
    ``MFGP``). Tensors keep the device and dtype of ``X``.

    >>> m = MFGP.from_fidelity_lists([Xlo, Xmid, Xhi], [ylo, ymid, yhi])
    >>> m.optimize(fix_rhos=True)          # reference fixes scale to [1,1]
    >>> mu, var = m.predict(Xs)            # at the highest fidelity
    """

    X: torch.Tensor
    fid: torch.Tensor
    y: torch.Tensor
    n_fidelities: int = 3
    kernel: str = "rbf"
    params: MFGPParams | None = None
    jitter: float = 0.0

    def __post_init__(self):
        self.set_data(self.X, self.fid, self.y)
        if self.params is None:
            self.params = MFGPParams.default(self.n_fidelities,
                                             self.X.shape[1], self.X.dtype,
                                             self.X.device)

    @classmethod
    def from_fidelity_lists(cls, X_list, y_list, **kw):
        X, fid, y = stack_fidelity_lists(X_list, y_list)
        return cls(X, fid, y, n_fidelities=len(X_list), **kw)

    def set_data(self, X, fid, y):
        """Replace the data (emukit ``set_data``,
        reference/GPTrainers.py:66)."""
        self.X, self.fid, self.y = _as_data(X, fid, y)
        self._state = None

    @property
    def state(self) -> MFGPState:
        if self._state is None:
            self._state = condition(self.params, self.X, self.fid, self.y,
                                    kernel=self.kernel, jitter=self.jitter)
        return self._state

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return -float(nlml(self.params, self.X, self.fid, self.y,
                               kernel=self.kernel, jitter=self.jitter))

    def optimize(self, maxiter: int = 1000, fix_rhos: bool = True,
                 lengthscale_bounds=None) -> float:
        """scipy L-BFGS-B on the autodiff NLML from the current params.

        ``fix_rhos=True`` replicates ``kern.scale.fix([1,1])``
        (reference/GPTrainers.py:67); ``lengthscale_bounds`` replicates
        ``constrain_bounded(0.0001, 100)`` in log space
        (reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:652-657).
        """
        F, D = self.n_fidelities, self.X.shape[1]
        p = self.params
        x0 = torch.cat([p.log_variances, p.log_lengthscales.reshape(-1),
                        *([] if fix_rhos else [p.rhos]), p.log_noises])
        bounds = None
        if lengthscale_bounds is not None:
            lo, hi = (np.log(lengthscale_bounds[0]),
                      np.log(lengthscale_bounds[1]))
            bounds = ([(None, None)] * F + [(lo, hi)] * (F * D)
                      + ([] if fix_rhos else [(None, None)] * (F - 1))
                      + [(None, None)] * F)
        fixed_rhos = p.rhos

        def unpack(vec):
            rhos = fixed_rhos if fix_rhos else vec[F + F * D:2 * F + F * D - 1]
            return MFGPParams(vec[:F], vec[F:F + F * D].reshape(F, D), rhos,
                              vec[vec.shape[0] - F:])

        vg = autograd_value_and_grad(
            lambda vec: nlml(unpack(vec), self.X, self.fid, self.y,
                             kernel=self.kernel, jitter=self.jitter),
            self.X.dtype, self.X.device)
        xopt, fopt, _ = scipy_lbfgsb(vg, x0.detach().cpu().double().numpy(),
                                     bounds=bounds, maxiter=maxiter)
        self.params = unpack(torch.as_tensor(xopt, dtype=self.X.dtype,
                                              device=self.X.device))
        self._state = None
        return fopt

    def optimize_restarts(self, n_restarts: int = 8, maxiter: int = 200,
                          spread: float = 1.0, seed: int = 0,
                          fix_rhos: bool = True, lengthscale_bounds=None,
                          tol: float = 1e-6) -> float:
        """Restart-batched fit on the analytic gradient: ``n_restarts``
        projected L-BFGS lanes from the current params plus ``spread``
        times standard normal draws (row 0 is the current params; the draws
        come from a CPU ``torch.Generator`` seeded with ``seed``, so a seed
        repeats on every device); the best finite NLML wins. Rhos stay
        fixed (``kern.scale.fix``); ``lengthscale_bounds`` is a log-space
        box."""
        if not fix_rhos:
            raise NotImplementedError(
                "free rhos use optimize(); the reference always fixes them "
                "(kern.scale.fix, reference/GPTrainers.py:67)")
        F, D = self.n_fidelities, self.X.shape[1]
        z = dict(dtype=self.X.dtype, device=self.X.device)
        p = self.params
        x0 = torch.cat([p.log_variances, p.log_lengthscales.reshape(-1),
                        p.log_noises]).to(**z)
        n = x0.shape[0]
        lower = torch.full((n,), -torch.inf, **z)
        upper = torch.full((n,), torch.inf, **z)
        if lengthscale_bounds is not None:
            lower[F:F + F * D] = float(np.log(lengthscale_bounds[0]))
            upper[F:F + F * D] = float(np.log(lengthscale_bounds[1]))
        inits = restart_inits(x0, n_restarts, spread, seed)
        xs, fs = _mf_fit_restarts(inits, self.X, self.fid, self.y, p.rhos,
                                  lower, upper, self.kernel, self.jitter,
                                  maxiter, tol)
        best = torch.argmin(torch.where(torch.isfinite(fs), fs, torch.inf))
        xopt = xs[best]
        self.params = MFGPParams(xopt[:F], xopt[F:F + F * D].reshape(F, D),
                                 p.rhos, xopt[F + F * D:])
        self._state = None
        return float(fs[best])

    def extend_data(self, X_new, fid_new, y_new):
        """Online conditioning: append fidelity-labelled observations with
        a bordered Cholesky block, O(N^2 P), instead of the reference's
        ``set_data`` and refit per replan."""
        X_new, fid_new, y_new = _as_data(
            torch.as_tensor(X_new, dtype=self.X.dtype, device=self.X.device),
            fid_new, y_new)
        state = self.state
        p = self.params
        B = _cov.mf_cross_cov(p.variances, p.lengthscales, p.rhos, state.X,
                              state.fid, X_new, fid_new, self.kernel)
        C = _cov.mf_train_cov(p.variances, p.lengthscales, p.rhos, p.noises,
                              X_new, fid_new, self.jitter, self.kernel)
        L = _la.chol_append_block(state.L, B, C)
        X = torch.cat([state.X, X_new])
        fid = torch.cat([state.fid, fid_new])
        y = torch.cat([state.y, y_new])
        self.X, self.fid, self.y = X, fid, y
        self._state = MFGPState(X, fid, y, L, _la.solve_posterior(L, y))
        return self

    def predict(self, Xs, fid=None, full_cov: bool = False,
                include_noise: bool = True, block_size: int | None = None):
        """Posterior at fidelity ``fid`` (default: the highest). Takes plain
        (M, D) inputs, or emukit-style augmented (M, D+1) inputs with a
        trailing fidelity column when ``fid`` is None. Marginal variances
        over large grids (M N > 2^25) stream in row blocks."""
        Xs = torch.atleast_2d(torch.as_tensor(Xs, dtype=self.X.dtype,
                                              device=self.X.device))
        M = Xs.shape[0]
        if fid is None:
            if Xs.shape[1] == self.X.shape[1] + 1:
                Xs, fid_s = split_augmented(Xs)
            else:
                fid_s = torch.full((M,), self.n_fidelities - 1,
                                   dtype=torch.long, device=Xs.device)
        else:
            fid_s = torch.broadcast_to(
                torch.as_tensor(fid, device=Xs.device).long(), (M,))
        if not full_cov and (block_size is not None
                             or M * self.X.shape[0] > 1 << 25):
            return predict_blocked(self.params, self.state, Xs, fid_s,
                                   kernel=self.kernel,
                                   include_noise=include_noise,
                                   block_size=block_size or 1024)
        return predict(self.params, self.state, Xs, fid_s,
                       kernel=self.kernel, full_cov=full_cov,
                       include_noise=include_noise)

    def predict_covariance(self, Xs, fid=None):
        """emukit ``predict_covariance`` (reference/GPTrainers.py:120)."""
        return self.predict(Xs, fid=fid, full_cov=True)[1]

    @property
    def param_array(self) -> np.ndarray:
        return self.params.to_vector().detach().cpu().numpy()

    def set_param_array(self, v):
        self.params = MFGPParams.from_vector(
            torch.as_tensor(v, dtype=self.X.dtype, device=self.X.device),
            self.n_fidelities, self.X.shape[1])
        self._state = None
