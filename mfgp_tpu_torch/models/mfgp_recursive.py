"""Recursive multi-fidelity GP (Le Gratiet & Garnier formulation;
counterpart of ``mfgp_tpu/models/mfgp_recursive.py``).

An alternative to the joint AR1 model (``models/mfgp.py``, the reference's
emukit formulation): train one GP per fidelity level on the *residuals*
against the previous level's posterior mean,

    f_0 ~ GP(0, k_0)
    d_m = y_m - rho_m * mu_{m-1}(X_m),    delta_m ~ GP(0, k_m)
    mu_m(x)    = rho_m mu_{m-1}(x)    + mu_{delta_m}(x)
    sig2_m(x)  = rho_m^2 sig2_{m-1}(x) + sig2_{delta_m}(x)

For nested designs (X_m a subset of X_{m-1}) this reproduces the joint
AR1 posterior exactly (Le Gratiet 2013); for non-nested designs it is the
standard recursive approximation. Cost: O(sum_m N_m^3) independent
Cholesky factorizations instead of O((sum N_m)^3) on the joint covariance.

A host class over the port's ``GP``: the data and the level bookkeeping
are numpy, each level's GP lives on ``device`` (the card unless the caller
asks for the CPU), and posteriors come back as numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.utils.device import CUDA, resolve


@dataclass
class RecursiveMFGP:
    """Per-level residual GPs with scalar AR1 couplings.

    >>> m = RecursiveMFGP.from_fidelity_lists([Xlo, Xmid, Xhi],
    ...                                       [ylo, ymid, yhi])
    >>> m.optimize()
    >>> mu, var = m.predict(Xs)      # at the highest fidelity
    """

    X_list: List[np.ndarray]  # lowest -> highest fidelity
    y_list: List[np.ndarray]
    kernel: str = "rbf"
    jitter: float = 1e-6
    fix_rhos: bool = True  # the reference fixes the AR1 scales to 1
    rhos: np.ndarray | None = None  # (F-1,)
    residual_mode: str = "posterior_mean"  # or "observed"
    device: torch.device | str = CUDA
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = resolve(self.device)
        self.X_list = [np.atleast_2d(np.asarray(x, float))
                       for x in self.X_list]
        self.y_list = [np.asarray(y, float).reshape(-1)
                       for y in self.y_list]
        self.F = len(self.X_list)
        if self.rhos is None:
            self.rhos = np.ones(self.F - 1)
        self.levels: List[GP] = []
        self._build()

    @classmethod
    def from_fidelity_lists(cls, X_list, y_list, **kw):
        return cls(list(X_list), list(y_list), **kw)

    def _gp(self, X, d) -> GP:
        z = dict(dtype=self.dtype, device=self.device)
        return GP(torch.as_tensor(X, **z).contiguous(),
                  torch.as_tensor(d, **z),
                  kernel=self.kernel, jitter=self.jitter)

    # -- fitting ------------------------------------------------------------
    def _level_residuals(self, m: int) -> np.ndarray:
        """Targets for level m: y_m minus the coupled lower level.

        ``posterior_mean`` mode subtracts the recursive posterior mean of
        level m-1 (works for any design); ``observed`` mode subtracts the
        *observed* y_{m-1} at shared points (Le Gratiet's construction,
        exact joint-model equivalence for nested, noise-free designs),
        falling back to the posterior mean where a point has no lower-level
        observation. The matching of shared points is a host loop."""
        if m == 0:
            return self.y_list[0]
        mu_prev, _ = self._predict_level(m - 1, self.X_list[m])
        base = np.array(mu_prev)
        if self.residual_mode == "observed":
            Xlo = self.X_list[m - 1]
            ylo = self.y_list[m - 1]
            for i, x in enumerate(self.X_list[m]):
                hits = np.where((np.abs(Xlo - x) < 1e-12).all(axis=1))[0]
                if hits.size:
                    base[i] = ylo[hits[0]]
        return self.y_list[m] - self.rhos[m - 1] * base

    def _build(self):
        """(Re)build the per-level GPs at current hyps/rhos."""
        self.levels = []
        for m in range(self.F):
            if self.X_list[m].shape[0] == 0:
                self.levels.append(None)
                continue
            self.levels.append(self._gp(self.X_list[m],
                                        self._level_residuals(m)))

    def optimize(self, n_restarts: int = 4, maxiter: int = 200,
                 seed: int = 0):
        """Fit level by level (each level's residuals depend on the fitted
        level below). Per-level fits are restart-batched L-BFGS."""
        for m in range(self.F):
            if self.X_list[m].shape[0] == 0:
                continue
            gp = self._gp(self.X_list[m], self._level_residuals(m))
            if self.X_list[m].shape[0] >= 3:
                gp.optimize_restarts(n_restarts=n_restarts, maxiter=maxiter,
                                     seed=seed + m)
            self.levels[m] = gp
            if not self.fix_rhos and m + 1 < self.F and \
                    self.X_list[m + 1].shape[0] >= 2:
                # closed-form LS estimate of rho_{m+1}: regress y_{m+1}
                # on mu_m(X_{m+1})
                mu, _ = self._predict_level(m, self.X_list[m + 1])
                denom = float(mu @ mu)
                if denom > 0:
                    self.rhos[m] = float(mu @ self.y_list[m + 1]) / denom
        return self

    # -- prediction ---------------------------------------------------------
    def _predict_level(self, m: int, Xs):
        gp = self.levels[m]
        if gp is None:
            mu = np.zeros(np.atleast_2d(Xs).shape[0])
            var = np.zeros_like(mu)
        else:
            with torch.no_grad():
                mu_t, var_t = gp.predict(Xs, include_noise=False)
            mu = mu_t.double().cpu().numpy()
            var = var_t.double().cpu().numpy()
        if m == 0:
            return mu, var
        mu_lo, var_lo = self._predict_level(m - 1, Xs)
        r = self.rhos[m - 1]
        return r * mu_lo + mu, r * r * var_lo + var

    def predict(self, Xs, level: int | None = None,
                include_noise: bool = True):
        """Posterior at fidelity ``level`` (default: highest), as numpy
        arrays."""
        level = self.F - 1 if level is None else level
        mu, var = self._predict_level(level, Xs)
        if include_noise and self.levels[level] is not None:
            var = var + float(self.levels[level].params.noise)
        return mu, var

    # -- interop ------------------------------------------------------------
    @property
    def param_array(self) -> np.ndarray:
        """[per-level GPy vectors ..., rhos]: not the emukit 17-layout
        (different model family); kept stable for checkpointing."""
        parts = [lvl.param_array if lvl is not None else np.array([])
                 for lvl in self.levels]
        return np.concatenate(parts + [self.rhos])

    def set_param_array(self, v):
        """Set every level's hyperparameters and the rhos from a
        ``param_array`` (this package's or the JAX package's), then rebuild
        the levels' residual targets from the lowest level up."""
        v = np.asarray(v, np.float64)
        per = [0 if x.shape[0] == 0 else x.shape[1] + 2 for x in self.X_list]
        vecs = np.split(v[:sum(per)], np.cumsum(per)[:-1])
        self.rhos = v[sum(per):].copy()
        for m in range(self.F):
            if self.levels[m] is None:
                continue
            gp = self._gp(self.X_list[m], self._level_residuals(m))
            gp.set_param_array(vecs[m])
            self.levels[m] = gp
