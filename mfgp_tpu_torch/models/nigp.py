"""NIGP: Gaussian process regression with input noise (McHutchon &
Rasmussen 2011) in PyTorch (counterpart of ``mfgp_tpu/models/nigp.py``).

Capability parity with the reference's from-scratch implementation
(reference/NIGP.py). Semantics preserved exactly:

* RBF-ARD kernel with amplitude ``sigma_f`` used directly as the GPy
  ``variance`` (reference/NIGP.py:18: the reference names it "signal std"
  but passes it as the variance; the value semantics are kept).
* Observation noise variance ``sigma_y^2 + v_i`` with the per-point
  input-noise inflation ``v_i = sum_d grad_i_d^2 * sigma_x_d^2``
  (reference/NIGP.py:144).
* Alternating fit: (A) analytic posterior-mean gradients at the training
  inputs with the *input-noise-free* covariance (``noise_diag=None`` at
  reference/NIGP.py:222), then (B) L-BFGS-B on the NLML with those gradients
  held fixed, log-space parameters bounded in [1e-6, 1e6], restarts jittered
  by 0.1*N(0,1) (reference/NIGP.py:215-240).

As in the JAX package, the posterior-mean gradients are two matrix
products, ``grads = (K (alpha o X) - X o (K alpha)) / l^2``; the NLML is
differentiated by autograd; and the native mode (``nlml_native``,
``fit_native``) differentiates through the gradients' own factorisation,
restart-batched. Every covariance goes through ``ops.covariance``: on a
CUDA float32 problem that is the B1 kernel, in the differentiable Gram
with its closed-form backward (``_AR1TrainCov`` at F=1). That Gram is used
three times per posterior-mean-gradient call (under the noise diagonal and
in both products); autograd sums the three cotangents and runs the
closed-form backward once on their (asymmetric) sum.

Hyperparameter vector for ``get_params`` matches the reference's saved
``*_nisfGP.txt`` layout: ``[sigma_x (D), sigma_f, sigma_y, lengthscales (D)]``
(reference/NIGP.py:188-189).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.ops import covariance as _cc
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.ops.optimize import (autograd_value_and_grad,
                                         batched_lbfgs, scipy_lbfgsb)
from mfgp_tpu_torch.utils.device import (CUDA, as_tensor_on, points_like,
                                         resolve)

_LOG2PI = math.log(2.0 * math.pi)


class NIGPParams(NamedTuple):
    """Log-space hyps: [log l (D), log sigma_f, log sigma_y, log sigma_x (D)].

    Identical vector layout to the reference's ``log_hyp``
    (reference/NIGP.py:127,212).
    """

    log_hyp: torch.Tensor  # (2D + 2,)

    @property
    def D(self):
        return (self.log_hyp.shape[0] - 2) // 2

    @property
    def lengthscales(self):
        return torch.exp(self.log_hyp[: self.D])

    @property
    def sigma_f(self):
        return torch.exp(self.log_hyp[self.D])

    @property
    def sigma_y(self):
        return torch.exp(self.log_hyp[self.D + 1])

    @property
    def sigma_x(self):
        return torch.exp(self.log_hyp[self.D + 2:])


def _like(a, X: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=X.dtype, device=X.device)


def posterior_mean_grads(X, y, lengthscales, sigma_f, sigma_y,
                         noise_diag=None):
    """Posterior mean and its input-gradients at the training points.

    Matches ``compute_post_mean_and_gradients`` (reference/NIGP.py:29-65)
    with the derivative sum contracted by matrix products:

        grads[i, d] = (1/l_d^2) * [ (K @ (alpha*X))[i,d] - X[i,d]*(K@alpha)[i] ]

    X (N, D), y (N,), or with one leading lane axis, each lane its own
    dataset (X (L, N, D), y (L, N), lengthscales (L, D), sigma_f and
    sigma_y (L,), noise_diag (L, N)); returns ``(Ka (..., N), grads
    (..., N, D))``.
    """
    lengthscales = _like(lengthscales, X)
    K = _cc.sf_cov_diff(sigma_f, lengthscales, X, "rbf")
    obs = (_like(sigma_y, X) ** 2)[..., None] + (
        noise_diag if noise_diag is not None else 0.0)
    Kn = _la.diag_add(K, torch.broadcast_to(obs, X.shape[:-1]))
    L = _la.chol(Kn)
    del Kn
    alpha = _la.solve_posterior(L, y)
    Ka = (K @ alpha[..., None])[..., 0]  # == posterior mean at train
    KaX = K @ (alpha[..., None] * X)
    grads = (KaX - X * Ka[..., None]) / (lengthscales[..., None, :] ** 2)
    return Ka, grads


def _unpack(log_hyp, D: int):
    return (torch.exp(log_hyp[..., :D]), torch.exp(log_hyp[..., D]),
            torch.exp(log_hyp[..., D + 1]), torch.exp(log_hyp[..., D + 2:]))


def _nlml_from_v(ls, sigma_f, sigma_y, v, X, y, jitter):
    N = X.shape[-2]
    K = _cc.sf_cov_diff(sigma_f, ls, X, "rbf")
    Kn = _la.diag_add(K, (sigma_y ** 2)[..., None] + v + jitter)
    del K
    L = _la.chol(Kn)
    del Kn
    alpha = _la.solve_posterior(L, y)
    return (0.5 * torch.sum(y * alpha, dim=-1)
            + 0.5 * _la.logdet_from_chol(L) + 0.5 * N * _LOG2PI)


def nlml(log_hyp, X, y, grad_fixed, extra_noise_diag=None,
         jitter: float = 1e-8):
    """NLML with fixed posterior-mean gradients (reference/NIGP.py:130-165).

    Per-point input-noise variance ``v = sum_d grad^2 sigma_x^2`` enters the
    observation-noise diagonal; the 1e-8 jitter matches the reference.
    Differentiable by autograd in ``log_hyp``.
    """
    ls, sigma_f, sigma_y, sigma_x = _unpack(log_hyp, X.shape[-1])
    v = torch.sum((grad_fixed ** 2) * (sigma_x[..., None, :] ** 2), dim=-1)
    if extra_noise_diag is not None:
        v = v + extra_noise_diag
    return _nlml_from_v(ls, sigma_f, sigma_y, v, X, y, jitter)


def nlml_native(log_hyp, X, y, jitter: float = 1e-8):
    """Fully-coupled NIGP NLML: the posterior-mean gradients are recomputed
    from the *current* hyperparameters inside the objective and
    differentiated through (SURVEY §7 step 2's "native mode").

    The reference freezes the gradients per outer iteration and alternates
    (reference/NIGP.py:215-240); under autodiff the exact joint objective
    removes the outer loop. One evaluation factorises twice, and its
    backward runs two Cholesky backwards.

    With one leading lane axis (log_hyp (L, 2D + 2), X (L, N, D), y (L, N)
    -> (L,)) each lane is its own dataset, its value depending on its own
    row only; on the card each of an evaluation's two Grams is one launch
    of B1's lane axis.
    """
    ls, sigma_f, sigma_y, sigma_x = _unpack(log_hyp, X.shape[-1])
    _, grads = posterior_mean_grads(X, y, ls, sigma_f, sigma_y)
    v = torch.sum((grads ** 2) * (sigma_x[..., None, :] ** 2), dim=-1)
    return _nlml_from_v(ls, sigma_f, sigma_y, v, X, y, jitter)


def _nigp_fit_restarts(inits, X, y, lower, upper, maxiter, ftol=0.0):
    """Restart-batched L-BFGS on the fully-coupled NLML; a non-finite NLML
    counts as 1e20. Returns ``(xs, fs)``."""
    def obj(lh):
        v = nlml_native(lh, X, y)
        return torch.where(torch.isfinite(v), v, 1e20)

    xs, fs, _ = batched_lbfgs(obj, inits, lower=lower, upper=upper,
                              maxiter=maxiter, ftol=ftol)
    return xs, fs


def median_pairwise_distance(X: torch.Tensor,
                             block_elems: int = 1 << 25) -> float:
    """Median of the positive pairwise Euclidean distances of the rows of
    ``X``, as ``np.median`` takes it (the mean of the two middle entries of
    an even count), 1.0 when there is none. Computed on X's device in
    float64 from coordinate differences, in row blocks of at most
    ``block_elems`` differences, over the pairs i < j (every distance
    stands twice in the full matrix, which leaves the median where it is).
    """
    X = X.detach().double()
    N, D = X.shape
    rows = max(1, block_elems // max(N * D, 1))
    cols = torch.arange(N, device=X.device)
    parts = []
    for lo in range(0, N, rows):
        xb = X[lo:lo + rows]
        d = torch.sqrt(torch.clamp_min(torch.sum(
            (xb[:, None, :] - X[None, :, :]) ** 2, dim=2), 0.0))
        keep = (cols[None, :] > cols[lo:lo + rows, None]) & (d > 0)
        parts.append(d[keep])
    pos = torch.sort(torch.cat(parts)).values
    m = pos.numel()
    if m == 0:
        return 1.0
    med = pos[m // 2] if m % 2 else 0.5 * (pos[m // 2 - 1] + pos[m // 2])
    return float(med)


def _init_log_hyp(X: torch.Tensor, y: torch.Tensor) -> np.ndarray:
    """The fits' starting point (reference/NIGP.py:200-205): median
    pairwise distance lengthscales, std(y) amplitude, a tenth of it as
    noise, 1 % of each coordinate's std as input noise."""
    D = X.shape[1]
    Xn = X.detach().cpu().numpy()
    med = median_pairwise_distance(X)
    std_y = np.std(y.detach().cpu().numpy())
    sigma_f = std_y if std_y > 0 else 1.0
    return np.concatenate([
        np.log(np.ones(D) * (med if med > 0 else 1.0)),
        [np.log(sigma_f), np.log(0.1 * sigma_f)],
        np.log(np.maximum(np.ones(D) * 0.01 * np.std(Xn, axis=0), 1e-8)),
    ])


@dataclass
class NIGP:
    """Input-noise GP with the reference's alternating fit schedule. A
    tensor ``X`` keeps its device; any other input goes to ``device``, the
    card unless the caller asks for the CPU (``device="cpu"``).

    >>> m = NIGP(n_restarts=2, iters=10)
    >>> m.fit(X, y)
    >>> mu, var = m.predict(Xs, Xs_input_noise=np.ones_like(Xs) * m.sigma_x_)
    """

    n_restarts: int = 3
    iters: int = 3
    verbose: bool = False
    seed: int = 0
    device: torch.device | str = CUDA

    lengthscales_: np.ndarray | None = field(default=None, repr=False)
    sigma_f_: float | None = field(default=None, repr=False)
    sigma_y_: float | None = field(default=None, repr=False)
    sigma_x_: np.ndarray | None = field(default=None, repr=False)
    X_train_: torch.Tensor | None = field(default=None, repr=False)
    y_train_: torch.Tensor | None = field(default=None, repr=False)
    noise_diag_train_: torch.Tensor | None = field(default=None, repr=False)

    def get_params(self) -> np.ndarray:
        """Saved-artifact layout: [sigma_x, sigma_f, sigma_y, lengthscales]
        (reference/NIGP.py:188-189)."""
        return np.hstack((self.sigma_x_, self.sigma_f_, self.sigma_y_,
                          self.lengthscales_))

    def _set_data(self, X, y):
        """Training tensors on X's device (``device`` when X is not a
        tensor); a floating X keeps its dtype, anything else is float64."""
        X = torch.atleast_2d(as_tensor_on(X, self.device)).contiguous()
        if not X.is_floating_point():
            X = X.double()
        y = torch.as_tensor(y, device=X.device).reshape(-1).to(X.dtype)
        self.X_train_, self.y_train_ = X, y
        self.device = X.device
        return X, y

    def _set_hyp(self, log_hyp: np.ndarray, grads: torch.Tensor):
        D = grads.shape[1]
        self.lengthscales_ = np.exp(log_hyp[:D])
        self.sigma_f_ = float(np.exp(log_hyp[D]))
        self.sigma_y_ = float(np.exp(log_hyp[D + 1]))
        self.sigma_x_ = np.exp(log_hyp[D + 2:])
        self.noise_diag_train_ = torch.sum(
            (grads ** 2) * (_like(self.sigma_x_, grads)[None, :] ** 2), dim=1)
        self._cond_cache = None
        self._cond_inv_cache = None

    def fit(self, X, y, maxiter_opt: int = 200):
        X, y = self._set_data(X, y)
        N, D = X.shape
        rng = np.random.default_rng(self.seed)
        log_hyp = _init_log_hyp(X, y)
        grad_fixed = torch.zeros((N, D), dtype=X.dtype, device=X.device)
        bounds = [(np.log(1e-6), np.log(1e6))] * (2 * D + 2)

        for it in range(self.iters):
            if self.verbose:
                print(f"NIGP iteration {it + 1}/{self.iters} ...")
            with torch.no_grad():
                ls = torch.exp(_like(log_hyp[:D], X))
                sf = torch.exp(_like(log_hyp[D], X))
                sy = torch.exp(_like(log_hyp[D + 1], X))
                _, grad_fixed = posterior_mean_grads(X, y, ls, sf, sy)

            # one value-and-gradient closure per outer iteration, shared
            # by its restarts (the gradients it holds change only here)
            vg = autograd_value_and_grad(
                lambda lh, gf=grad_fixed: nlml(lh, X, y, gf), X.dtype,
                X.device)
            best_x, best_val = None, np.inf
            for _ in range(self.n_restarts):
                init = log_hyp + 0.1 * rng.standard_normal(log_hyp.shape)
                xo, fo, _ = scipy_lbfgsb(vg, init, bounds=bounds,
                                         maxiter=maxiter_opt)
                if fo < best_val:
                    best_val, best_x = fo, xo
            log_hyp = best_x if best_x is not None else log_hyp
            if self.verbose:
                print(f"  optimized nlml: {best_val:.6g}")

        self._set_hyp(log_hyp, grad_fixed)
        return self

    def fit_native(self, X, y, n_restarts: int | None = None,
                   maxiter: int = 200, spread: float = 0.3):
        """Native-mode fit: restart-batched L-BFGS on the fully-coupled
        NLML (``nlml_native``), no alternating outer loop. Same init
        heuristics and [1e-6, 1e6] bounds as :meth:`fit`; restart 0 starts
        at the heuristic point, the others add ``spread`` times host
        ``np.random.default_rng(seed)`` normal draws."""
        X, y = self._set_data(X, y)
        N, D = X.shape
        rng = np.random.default_rng(self.seed)
        n_restarts = n_restarts or max(self.n_restarts, 1)

        log_hyp0 = _init_log_hyp(X, y)
        inits = (log_hyp0[None, :]
                 + spread * rng.standard_normal((n_restarts,
                                                 log_hyp0.shape[0])))
        inits[0] = log_hyp0
        z = dict(dtype=X.dtype, device=X.device)
        lower = torch.full((2 * D + 2,), float(np.log(1e-6)), **z)
        upper = torch.full((2 * D + 2,), float(np.log(1e6)), **z)

        xs, fs = _nigp_fit_restarts(torch.as_tensor(inits, **z), X, y,
                                    lower, upper, maxiter)
        best = int(torch.argmin(torch.where(torch.isfinite(fs), fs,
                                            torch.inf)))
        log_hyp = xs[best].detach().cpu().numpy()

        with torch.no_grad():
            _, grads = posterior_mean_grads(
                X, y, _like(np.exp(log_hyp[:D]), X),
                float(np.exp(log_hyp[D])), float(np.exp(log_hyp[D + 1])))
        self._set_hyp(log_hyp, grads)
        return self

    def _condition(self):
        """Cached conditioned state (L, alpha) of the fitted model.

        The reference re-factorizes the N x N train covariance on EVERY
        predict (reference/NIGP.py:285-289); repeated predicts with fixed
        hyperparameters share one factor, computed once per fit (its Gram
        through B1 on the card) and dropped whenever a fit updates the
        noise diagonal."""
        cache = getattr(self, "_cond_cache", None)
        if cache is not None:
            return cache
        X, y = self.X_train_, self.y_train_
        ls = _like(self.lengthscales_, X)
        obs = self.sigma_y_ ** 2 + (
            self.noise_diag_train_
            if self.noise_diag_train_ is not None else 0.0)
        noise = torch.broadcast_to(_like(obs, X), (X.shape[0],))
        with torch.no_grad():
            Kn = _cc.sf_train_cov(self.sigma_f_, ls, noise, X, "rbf")
            L = _la.chol(Kn)
            del Kn
            alpha = _la.solve_posterior(L, y)
        self._cond_cache = (L, alpha)
        return self._cond_cache

    def _condition_inv(self):
        """Explicit-inverse conditioned state (L^-1, alpha), cached: with
        L^-1 in hand every posterior-variance substitution is a triangular
        product, which repeated large-grid predicts amortise."""
        cache = getattr(self, "_cond_inv_cache", None)
        if cache is None:
            L, alpha = self._condition()
            cache = (_la.tri_inv_recursive(L), alpha)
            self._cond_inv_cache = cache
        return cache

    def predict_blocked(self, Xs, block_size: int = 1024,
                        include_noise: bool = False):
        """Blocked heteroscedastic posterior mean/marginal variance via the
        explicit-inverse state. Matches :meth:`predict`'s marginal-variance
        path (reference/NIGP.py:269-333 semantics: no output noise by
        default, 1e-12 floor) block by block over large grids.

        Delegates to :func:`models.gp.predict_blocked_inv`: the
        heteroscedastic training noise is already folded into the cached
        factor, so at predict time NIGP *is* a GP with variance sigma_f
        and output noise sigma_y^2. Its params are built on X's device."""
        from mfgp_tpu_torch.models.gp import (GPParams, GPStateInv,
                                              predict_blocked_inv)

        X = self.X_train_
        Xs = points_like(Xs, X)
        Linv, alpha = self._condition_inv()
        params = GPParams(torch.log(_like(self.sigma_f_, X)),
                          torch.log(_like(self.lengthscales_, X)),
                          torch.log(_like(self.sigma_y_ ** 2, X)))
        state = GPStateInv(X, self.y_train_, Linv, alpha)
        with torch.no_grad():
            mean, var = predict_blocked_inv(params, state, Xs, kernel="rbf",
                                            include_noise=include_noise,
                                            block_size=block_size)
        return (mean.cpu().numpy(),
                np.maximum(var.cpu().numpy(), 1e-12))

    @torch.no_grad()
    def predict(self, Xs, Xs_input_noise=None, return_var: bool = True,
                return_cov: bool = False, as_numpy: bool = True):
        """Heteroscedastic posterior (reference/NIGP.py:269-333).

        No output noise on the predictive covariance; optional test-point
        input-noise diagonal via analytic mean-gradients at Xs; 1e-12
        diagonal floor. ``as_numpy=False`` returns the tensors where they
        are (the study harness consumes the full covariance on the
        device)."""
        X = self.X_train_
        Xs = points_like(Xs, X)
        ls = _like(self.lengthscales_, X)
        L, alpha = self._condition()
        Kxs = _cc.sf_cross_cov(self.sigma_f_, ls, Xs, X, "rbf")
        mean = _la.posterior_mean(Kxs, alpha)
        if not (return_var or return_cov):
            return mean.cpu().numpy()

        if not return_cov and Xs_input_noise is None:
            # marginal variances without materialising the (M, M) cov
            kss = torch.broadcast_to(_like(self.sigma_f_, X),
                                     (Xs.shape[0],))
            var = torch.clamp_min(_la.posterior_var(kss, Kxs, L), 1e-12)
            return mean.cpu().numpy(), var.cpu().numpy()

        Kss = _cc.sf_cross_cov(self.sigma_f_, ls, Xs, Xs, "rbf")
        cov = _la.posterior_cov(Kss, Kxs, L)
        del Kss

        if Xs_input_noise is not None:
            # gradients of the posterior mean at the test points
            KaX = Kxs @ (alpha[:, None] * X)
            Ka = Kxs @ alpha
            grads_star = (KaX - Xs * Ka[:, None]) / (ls ** 2)
            Sx = _like(Xs_input_noise, X)
            if Sx.ndim == 1 and Sx.shape[0] == X.shape[1]:
                Sx = Sx[None, :]
            elif Sx.shape != grads_star.shape:
                raise ValueError(
                    "Xs_input_noise must have shape (D,) or (M, D)")
            v_star = torch.sum((grads_star ** 2) * (Sx ** 2), dim=1)
            cov.diagonal().add_(v_star)

        cov.diagonal().add_(1e-12)
        if return_cov:
            if not as_numpy:
                return mean, cov
            return mean.cpu().numpy(), cov.cpu().numpy()
        var = torch.clamp_min(torch.diagonal(cov), 1e-12)
        return mean.cpu().numpy(), var.cpu().numpy()


def nigp_from_numpy(hyp, X, y, noise_diag_train=None, device=CUDA,
                    dtype=torch.float64) -> NIGP:
    """A fitted :class:`NIGP` from numpy values: ``hyp`` is the log-space
    vector ``[log l (D), log sigma_f, log sigma_y, log sigma_x (D)]`` or
    the tuple ``(lengthscales, sigma_f, sigma_y, sigma_x)`` (the JAX
    package's fitted attributes); ``X``, ``y`` and ``noise_diag_train`` are
    its training arrays and per-point input-noise variances."""
    if isinstance(hyp, tuple):
        ls, sf, sy, sx = hyp
    else:
        hyp = np.asarray(hyp, np.float64)
        D = (hyp.shape[0] - 2) // 2
        ls, sf, sy, sx = (np.exp(hyp[:D]), np.exp(hyp[D]),
                          np.exp(hyp[D + 1]), np.exp(hyp[D + 2:]))
    m = NIGP(device=device)
    X, _ = m._set_data(torch.tensor(np.asarray(X), dtype=dtype,
                                    device=resolve(device)), y)
    m.lengthscales_ = np.asarray(ls, np.float64)
    m.sigma_f_, m.sigma_y_ = float(sf), float(sy)
    m.sigma_x_ = np.asarray(sx, np.float64)
    m.noise_diag_train_ = (None if noise_diag_train is None else
                           torch.tensor(np.asarray(noise_diag_train),
                                        dtype=dtype, device=X.device))
    return m
