"""Single-fidelity exact GP regression in PyTorch (counterpart of
``mfgp_tpu/models/gp.py``).

Capability parity with ``GPy.models.GPRegression`` as the reference uses it
(reference/GPTrainers.py:80-98): ARD rbf or matern32 kernel, ``optimize``,
``predict`` with optional ``full_cov``. The functional core is

    nlml(params, X, y)        exact NLML, differentiable by autograd
    condition(params, X, y)   -> GPState (Cholesky factor + alpha)
    predict(params, state, Xs) posterior mean / variance / covariance

and the stateful :class:`GP` wrapper stores tensors and params. The device
and dtype come from the inputs.

The GP is the F=1 case of the AR1 MFGP, and the port runs it through the
same code on the card: the training Gram and cross-covariances through B1
(``sf_train_cov``, ``sf_cross_cov``; the JAX package assembles the Gram of
its analytic gradient with an XLA composition of the same mathematics),
the autodiff NLML through ``sf_cov_diff`` (B1 forward, closed-form
backward), and the analytic gradient through ``mfgp._nlml_vg_core`` at
F=1, so every analytic gradient reaches B2 at F=1.

The parameter vector is GPy's ``param_array``: ``[variance,
lengthscale_1..D, noise]`` (reference/GPTrainers.py:85-88).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.models import mfgp as _mf
from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.ops.optimize import (autograd_value_and_grad,
                                         batched_lbfgs, penalize_nonfinite,
                                         restart_inits, scipy_lbfgsb)
from mfgp_tpu_torch.utils.device import CUDA, as_tensor_on, points_like

_LOG2PI = math.log(2.0 * math.pi)


class GPParams(NamedTuple):
    """Log-space hyperparameters (positive by construction)."""

    log_variance: torch.Tensor  # ()
    log_lengthscales: torch.Tensor  # (D,)
    log_noise: torch.Tensor  # ()

    @property
    def variance(self):
        return torch.exp(self.log_variance)

    @property
    def lengthscales(self):
        return torch.exp(self.log_lengthscales)

    @property
    def noise(self):
        return torch.exp(self.log_noise)

    def to_vector(self) -> torch.Tensor:
        """GPy ``param_array`` layout: [variance, lengthscales..., noise]."""
        return torch.cat([self.variance[None], self.lengthscales,
                          self.noise[None]])

    @staticmethod
    def from_vector(v: torch.Tensor, D: int) -> "GPParams":
        return GPParams(torch.log(v[0]), torch.log(v[1:1 + D]),
                        torch.log(v[1 + D]))

    @staticmethod
    def default(D: int, dtype=torch.float64, device=None) -> "GPParams":
        """GPy defaults: variance, lengthscales and noise 1. ``device=None``
        builds on the CPU; a caller passes its data's device."""
        z = dict(dtype=dtype, device=device)
        return GPParams(torch.zeros((), **z), torch.zeros(D, **z),
                        torch.zeros((), **z))


class GPState(NamedTuple):
    X: torch.Tensor  # (N, D)
    y: torch.Tensor  # (N,)
    L: torch.Tensor  # (N, N) lower Cholesky factor of K + noise (+ extra)
    alpha: torch.Tensor  # (N,)


class GPStateInv(NamedTuple):
    """Conditioned state carrying the inverse factor ``Linv = L^-1`` (see
    ``mfgp.MFGPStateInv``)."""

    X: torch.Tensor
    y: torch.Tensor
    Linv: torch.Tensor
    alpha: torch.Tensor


def gp_params_from_numpy(log_variance, log_lengthscales, log_noise, device,
                         dtype) -> GPParams:
    """The port's parameters from the JAX package's (``np.asarray`` of each
    ``mfgp_tpu`` ``GPParams`` field)."""
    return GPParams(*(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                      for a in (log_variance, log_lengthscales, log_noise)))


def _as_mf(params: GPParams) -> _mf.MFGPParams:
    """The same model as a one-fidelity AR1 MFGP."""
    lv = params.log_variance
    return _mf.MFGPParams(lv.reshape(1),
                          params.log_lengthscales.reshape(1, -1),
                          lv.new_zeros(0), params.log_noise.reshape(1))


def _assemble_noisy_cov(params: GPParams, X, extra_noise_diag, jitter,
                        kernel: str) -> torch.Tensor:
    """Differentiable K + (noise + extra_noise_diag + jitter) diagonal."""
    K = _cov.sf_cov_diff(params.variance, params.lengthscales, X, kernel)
    obs = params.noise + extra_noise_diag + jitter
    return _la.diag_add(K, torch.broadcast_to(obs, (X.shape[0],)))


def nlml(params: GPParams, X, y, extra_noise_diag=0.0, kernel: str = "rbf",
         jitter: float = 0.0) -> torch.Tensor:
    """Exact NLML ``0.5 y^T K_n^-1 y + 0.5 log|K_n| + 0.5 N log 2pi`` with
    ``K_n = K + (noise + extra_noise_diag) I``, differentiable by autograd;
    ``extra_noise_diag`` carries the NIGP's per-point input-noise term."""
    N = X.shape[0]
    L = _la.chol(_assemble_noisy_cov(params, X, extra_noise_diag, jitter,
                                     kernel))
    alpha = _la.solve_posterior(L, y)
    return (0.5 * torch.dot(y, alpha) + 0.5 * _la.logdet_from_chol(L)
            + 0.5 * N * _LOG2PI)


def _gp_vg_core(params: GPParams, X, y, extra_noise_diag=0.0,
                kernel: str = "rbf", jitter: float = 0.0):
    """NLML and its analytic gradient: ``mfgp._nlml_vg_core`` at F=1, the
    extra noise riding on the jitter diagonal. Returns ``(val, GPParams
    grad, alpha, Linv)``."""
    fid = torch.zeros(X.shape[0], dtype=torch.long, device=X.device)
    val, g, alpha, Linv = _mf._nlml_vg_core(
        _as_mf(params), X, fid, y, kernel, extra_noise_diag + jitter)
    grad = GPParams(g.log_variances[0], g.log_lengthscales[0],
                    g.log_noises[0])
    return val, grad, alpha, Linv


def nlml_value_and_grad(params: GPParams, X, y, extra_noise_diag=0.0,
                        kernel: str = "rbf", jitter: float = 0.0):
    """``mfgp.nlml_value_and_grad`` at F=1: Linv and B2."""
    val, grad, *_ = _gp_vg_core(params, X, y, extra_noise_diag, kernel,
                                jitter)
    return val, grad


def nlml_value_and_grad_lanes(params: GPParams, X, y, kernel: str = "rbf",
                              jitter: float = 0.0):
    """``nlml_value_and_grad`` of L lanes at once, each lane its own dataset
    (``params``' fields (L,), (L, D), (L,); X (L, N, D); y (L, N)):
    ``mfgp.nlml_value_and_grad_lanes`` at F=1."""
    L, N = X.shape[:2]
    lv = params.log_variance
    p = _mf.MFGPParams(lv[:, None], params.log_lengthscales[:, None, :],
                       lv.new_zeros((L, 0)), params.log_noise[:, None])
    fid = torch.zeros((L, N), dtype=torch.long, device=X.device)
    val, g = _mf.nlml_value_and_grad_lanes(p, X, fid, y, kernel, jitter)
    return val, GPParams(g.log_variances[:, 0], g.log_lengthscales[:, 0],
                         g.log_noises[:, 0])


def nlml_value_grad_state_inv(params: GPParams, X, y, extra_noise_diag=0.0,
                              kernel: str = "rbf", jitter: float = 0.0):
    """(value, grad, GPStateInv): the single-fidelity unit; on a CUDA
    float32 problem the gradient comes from B2 at F=1."""
    val, grad, alpha, Linv = _gp_vg_core(params, X, y, extra_noise_diag,
                                         kernel, jitter)
    return val, grad, GPStateInv(X, y, Linv, alpha)


def condition(params: GPParams, X, y, extra_noise_diag=0.0,
              kernel: str = "rbf", jitter: float = 0.0) -> GPState:
    Kn = _cov.sf_train_cov(params.variance, params.lengthscales,
                           params.noise + extra_noise_diag + jitter, X,
                           kernel)
    L = _la.chol(Kn)
    del Kn
    return GPState(X, y, L, _la.solve_posterior(L, y))


def predict(params: GPParams, state: GPState, Xs, kernel: str = "rbf",
            full_cov: bool = False, include_noise: bool = True):
    """Posterior mean and (co)variance; ``include_noise`` matches GPy
    ``predict``'s ``include_likelihood=True`` default."""
    Kxs = _cov.sf_cross_cov(params.variance, params.lengthscales, Xs,
                            state.X, kernel)
    mean = _la.posterior_mean(Kxs, state.alpha)
    noise = params.noise if include_noise else 0.0
    M = Xs.shape[0]
    if full_cov:
        Kss = _cov.sf_cross_cov(params.variance, params.lengthscales, Xs,
                                Xs, kernel)
        cov = _la.posterior_cov(Kss, Kxs, state.L)
        return mean, _la.diag_add(cov, torch.broadcast_to(
            torch.as_tensor(noise, dtype=cov.dtype, device=cov.device),
            (M,)))
    kss = torch.broadcast_to(params.variance, (M,))
    return mean, _la.posterior_var(kss, Kxs, state.L) + noise


def predict_blocked(params: GPParams, state: GPState, Xs,
                    kernel: str = "rbf", include_noise: bool = True,
                    block_size: int = 1024):
    """Posterior mean/variance over grid-row blocks (peak memory
    block_size x N)."""
    def one(xb):
        Kxs = _cov.sf_cross_cov(params.variance, params.lengthscales, xb,
                                state.X, kernel)
        kss = torch.broadcast_to(params.variance, (xb.shape[0],))
        var = _la.posterior_var(kss, Kxs, state.L)
        if include_noise:
            var = var + params.noise
        return _la.posterior_mean(Kxs, state.alpha), var

    return _mf._blocked(one, block_size, Xs)


def predict_blocked_inv(params: GPParams, state: GPStateInv, Xs,
                        kernel: str = "rbf", include_noise: bool = True,
                        block_size: int = 1024):
    """predict_blocked from a GPStateInv: the variance's substitution is
    the triangular product ``V = Linv Kxs^T`` per block."""
    def one(xb):
        Kxs = _cov.sf_cross_cov(params.variance, params.lengthscales, xb,
                                state.X, kernel)
        V = _la.tri_lower_matmul(state.Linv, Kxs.T)
        var = params.variance - torch.sum(V * V, dim=0)
        if include_noise:
            var = var + params.noise
        return _la.posterior_mean(Kxs, state.alpha), var

    return _mf._blocked(one, block_size, Xs)


def _fit_restarts(inits, X, y, kernel: str, jitter: float, maxiter: int,
                  tol: float = 1e-6, ftol: float = 0.0):
    """Restart-batched L-BFGS on the analytic gradient: ``inits`` is
    (R, D + 2), each row ``[log variance, log lengthscales, log noise]``.
    Non-finite NLMLs count as 1e20 with a zero gradient. Returns
    ``(xs, fs)``."""
    D = X.shape[1]

    def vg(vec):
        p = GPParams(vec[0], vec[1:1 + D], vec[1 + D])
        v, g = nlml_value_and_grad(p, X, y, kernel=kernel, jitter=jitter)
        return penalize_nonfinite(v, torch.cat([
            g.log_variance[None], g.log_lengthscales, g.log_noise[None]]))

    with torch.no_grad():
        xs, fs, _ = batched_lbfgs(None, inits, maxiter=maxiter, tol=tol,
                                  ftol=ftol, value_and_grad=vg)
    return xs, fs


@dataclass
class GP:
    """Stateful wrapper mirroring the GPy call sites (the JAX package's
    ``GP``). Tensors keep the device and dtype of ``X``. A tensor ``X``
    keeps its device; any other input goes to ``device``, the card unless
    the caller asks for the CPU (``device="cpu"``). After construction
    ``device`` is the data's.

    >>> gp = GP(X, y, kernel="rbf")
    >>> gp.optimize()
    >>> mu, var = gp.predict(Xs)
    """

    X: torch.Tensor
    y: torch.Tensor
    kernel: str = "rbf"
    params: GPParams | None = None
    jitter: float = 0.0
    device: torch.device | str = CUDA

    def __post_init__(self):
        self.set_XY(self.X, self.y)
        if self.params is None:
            self.params = GPParams.default(self.X.shape[1], self.X.dtype,
                                           self.X.device)

    def set_XY(self, X, y):
        """Replace the training set (reference ``gp.set_XY``,
        GPTrainers.py:83); inputs that are not tensors go to the model's
        device."""
        self.X = torch.atleast_2d(
            as_tensor_on(X, self.device)).contiguous()
        self.y = torch.as_tensor(y, dtype=self.X.dtype,
                                 device=self.X.device).reshape(-1)
        self.device = self.X.device
        self._state = None

    @property
    def state(self) -> GPState:
        if self._state is None:
            self._state = condition(self.params, self.X, self.y,
                                    kernel=self.kernel, jitter=self.jitter)
        return self._state

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return -float(nlml(self.params, self.X, self.y,
                               kernel=self.kernel, jitter=self.jitter))

    def _x0(self) -> torch.Tensor:
        p = self.params
        return torch.cat([p.log_variance.reshape(1), p.log_lengthscales,
                          p.log_noise.reshape(1)]).to(self.X.dtype)

    def _set_vector(self, x: torch.Tensor) -> None:
        D = self.X.shape[1]
        self.params = GPParams(x[0], x[1:1 + D], x[1 + D])
        self._state = None

    def optimize(self, maxiter: int = 1000, bounds=None) -> float:
        """One scipy L-BFGS-B run on the autodiff NLML from the current
        params (GPy ``optimize()``)."""
        D = self.X.shape[1]
        vg = autograd_value_and_grad(
            lambda v: nlml(GPParams(v[0], v[1:1 + D], v[1 + D]), self.X,
                           self.y, kernel=self.kernel, jitter=self.jitter),
            self.X.dtype, self.X.device)
        xopt, fopt, _ = scipy_lbfgsb(vg, self._x0().detach().cpu().double()
                                     .numpy(), bounds=bounds,
                                     maxiter=maxiter)
        self._set_vector(torch.as_tensor(xopt, dtype=self.X.dtype,
                                         device=self.X.device))
        return fopt

    def optimize_restarts(self, n_restarts: int = 8, maxiter: int = 200,
                          spread: float = 1.0, seed: int = 0,
                          tol: float = 1e-6) -> float:
        """Restart-batched fit (see ``MFGP.optimize_restarts``): row 0 is
        the current params, the others add ``spread`` times standard normal
        draws from a CPU generator seeded with ``seed``; the best finite
        NLML wins."""
        inits = restart_inits(self._x0(), n_restarts, spread, seed)
        xs, fs = _fit_restarts(inits, self.X, self.y, self.kernel,
                               self.jitter, maxiter, tol)
        best = torch.argmin(torch.where(torch.isfinite(fs), fs, torch.inf))
        self._set_vector(xs[best])
        return float(fs[best])

    def extend_data(self, X_new, y_new):
        """Online conditioning: append observations with a bordered
        Cholesky block, O(N^2 P), without refactorizing."""
        X_new = points_like(X_new, self.X)
        y_new = torch.as_tensor(y_new, dtype=self.X.dtype,
                                device=self.X.device).reshape(-1)
        state = self.state
        p = self.params
        B = _cov.sf_cross_cov(p.variance, p.lengthscales, state.X, X_new,
                              self.kernel)
        C = _cov.sf_train_cov(p.variance, p.lengthscales,
                              p.noise + self.jitter, X_new, self.kernel)
        L = _la.chol_append_block(state.L, B, C)
        X = torch.cat([state.X, X_new])
        y = torch.cat([state.y, y_new])
        self.X, self.y = X, y
        self._state = GPState(X, y, L, _la.solve_posterior(L, y))
        return self

    def predict(self, Xs, full_cov: bool = False, include_noise: bool = True,
                block_size: int | None = None):
        """Posterior at Xs; marginal variances over large grids
        (M N > 2^25) stream in row blocks."""
        Xs = points_like(Xs, self.X)
        if not full_cov and (block_size is not None
                             or Xs.shape[0] * self.X.shape[0] > 1 << 25):
            return predict_blocked(self.params, self.state, Xs,
                                   kernel=self.kernel,
                                   include_noise=include_noise,
                                   block_size=block_size or 1024)
        return predict(self.params, self.state, Xs, kernel=self.kernel,
                       full_cov=full_cov, include_noise=include_noise)

    @property
    def param_array(self) -> np.ndarray:
        """GPy-layout vector, as saved in ``*_sfGP.txt`` files."""
        return self.params.to_vector().detach().cpu().numpy()

    def set_param_array(self, v):
        self.params = GPParams.from_vector(
            torch.as_tensor(v, dtype=self.X.dtype, device=self.X.device),
            self.X.shape[1])
        self._state = None
