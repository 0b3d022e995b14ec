"""Batched scoring of candidate paths (counterpart of
``mfgp_tpu/planning/scoring.py``).

SURVEY C13/C14: the planner's path-cost family. Each cost exposes

* ``__call__(points)`` — score one path (points = (T, 5) rows of
  x, y, depth, t, variance from ``primitives.path_to_traj_points``);
* ``batch(list_of_points)`` — score many candidate paths at once, each
  padded to a shared power-of-two length (``_pad_paths``) with a mask.

This is the planner's hot loop: the reference re-fits a GPy model per
trajectory point per candidate (reference/GraceRIGV3.py:443-503), while
here every candidate costs one posterior-covariance block + one Cholesky,
and a batch runs its candidates as lanes: every covariance block of the
batch is one launch of B1's lane axis (``ops.covariance.ar1_cov_lanes``,
the candidates' path points per lane, the training set and the grid
broadcast), every factorization and solve one batched call. The blocks
that do not depend on the candidate (the log-det costs' grid blocks) are
computed once per cost.

The model costs work on the model's device in its dtype; the two ergodic
costs take ``device`` (the card unless asked otherwise) and ``dtype``.
Scores come back as host numpy arrays (``batch``) or floats
(``__call__``), an empty path scoring ``-inf``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from mfgp_tpu_torch.metrics.ergodic import (kl_divergence,
                                            trajectory_distribution)
from mfgp_tpu_torch.metrics.fourier import (basis_norms, config_k,
                                            fourier_basis,
                                            fourier_coefficients,
                                            sobolev_weights)
from mfgp_tpu_torch.metrics.info_gain import (logdet,
                                              sequential_gain_cross,
                                              sequential_gain_from_cov)
from mfgp_tpu_torch.models import gp as gpm
from mfgp_tpu_torch.models import mfgp as mfm
from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.utils.device import CUDA, points_like, resolve


def fids_from_variance(var, fid_levels, n_fidelities: int):
    """Accrued localization variance -> conditioning fidelity label.

    Reference semantics (reference/GraceRIGV3.py:528-533): below the first
    threshold -> highest fidelity (F-1), each further threshold steps one
    level down, floor 0. Generalized to any F.
    """
    fl = np.asarray(fid_levels, float)
    if fl.shape[0] < n_fidelities - 1:
        raise ValueError(
            f"need {n_fidelities - 1} fidelity thresholds, got {fl.shape[0]}")
    lev = np.searchsorted(fl[: n_fidelities - 1], np.asarray(var),
                          side="right")
    return (n_fidelities - 1 - lev).astype(np.int32)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_paths(paths: Sequence[np.ndarray], width: int):
    """Pad (T_i, width) arrays to a common bucketed T; returns
    (B, T, width) float64 + (B, T) bool mask, host numpy. The final row is
    repeated into the padding (keeps interpolants finite); masks remove its
    weight."""
    T = _bucket(max(p.shape[0] for p in paths))
    B = len(paths)
    out = np.zeros((B, T, width))
    mask = np.zeros((B, T), bool)
    for i, p in enumerate(paths):
        t = p.shape[0]
        out[i, :t] = p[:, :width]
        out[i, t:] = p[-1, :width]
        mask[i, :t] = True
    return out, mask


def _padded_on(paths, width: int, like: torch.Tensor):
    """``_pad_paths`` as tensors in ``like``'s dtype and on its device:
    (points (B, T, width), mask (B, T)), plus the host points."""
    pts, mask = _pad_paths(paths, width)
    return (points_like(pts, like),
            torch.as_tensor(mask, device=like.device), pts)


def _labels_on(fids: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(fids, device=like.device).long().contiguous()


def _to_host(scores: torch.Tensor) -> np.ndarray:
    return scores.detach().cpu().numpy()


class _Hyp:
    """One model's AR1 hyperparameters, broadcast over the lanes of a B1
    lane-axis launch (a single-fidelity GP is the F=1 case)."""

    def __init__(self, variances, lengthscales, rhos, kernel: str):
        self.v, self.ls, self.rho, self.kernel = (variances, lengthscales,
                                                  rhos, kernel)

    def lanes(self, X1, f1, X2, f2, noise_diag=None) -> torch.Tensor:
        """(B, n, m) covariances of B lanes: X1 (B, n, D), f1 (B, n), X2
        (B, m, D), f2 (B, m), any of them a broadcast view; one launch of
        B1's lane axis on the card, its plain version elsewhere."""
        B = X1.shape[0]
        return _cov.ar1_cov_lanes(self.v.expand(B, -1),
                                  self.ls.expand(B, -1, -1),
                                  self.rho.expand(B, -1), X1, f1, X2, f2,
                                  self.kernel, noise_diag)

    def single(self, X1, f1, X2, f2) -> torch.Tensor:
        """One (n, m) covariance through the model's own dispatch."""
        return _cov.mf_cross_cov(self.v, self.ls, self.rho, X1, f1, X2, f2,
                                 self.kernel)


def _sf_hyp(model: gpm.GP) -> _Hyp:
    p = model.params
    v = p.variance.reshape(1)
    return _Hyp(v, p.lengthscales.reshape(1, -1), v.new_zeros(0),
                model.kernel)


def _mf_hyp(model: mfm.MFGP) -> _Hyp:
    p = model.params
    return _Hyp(p.variances, p.lengthscales, p.rhos, model.kernel)


def _broadcast(t: torch.Tensor, B: int) -> torch.Tensor:
    """A view of ``t`` repeated over B lanes (no copy)."""
    return t.expand((B,) + t.shape)


def _zero_labels(xyz: torch.Tensor) -> torch.Tensor:
    return torch.zeros(xyz.shape[:-1], dtype=torch.long, device=xyz.device)


def _masked_pairs(C, mask, fill):
    """C with every row and column of a masked point replaced by ``fill``
    times the identity."""
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
    mm = mask[..., :, None] & mask[..., None, :]
    return torch.where(mm, C, eye * fill)


# ---------------------------------------------------------------------------
# lane-batched scores (one candidate path per lane)
# ---------------------------------------------------------------------------
def _ergodic_lanes(t, xyz, mask, grid, sigma_diag, p_floored):
    """-KL(q || EID) of each lane's trajectory statistics q, q floored by
    its smallest positive entry (capped at 1e-15) where it has zeros."""
    q = trajectory_distribution(t, xyz, grid, sigma_diag, mask=mask)
    floor = torch.clamp_max(torch.amin(torch.where(q > 0, q, torch.inf),
                                       dim=-1, keepdim=True), 1e-15)
    q = torch.where(torch.any(q == 0, dim=-1, keepdim=True), q + floor, q)
    return -kl_divergence(q, p_floored)


def _fourier_lanes(xyz_unit, mask, k, hk, lamk, target_coef):
    """-sum_k lambda_k (c_k(path) - c_k(target))^2 per lane."""
    w = (mask.to(xyz_unit.dtype) if mask is not None
         else xyz_unit.new_ones(xyz_unit.shape[:-1]))
    F = fourier_basis(xyz_unit, k)  # (B, M, T)
    coef = (torch.sum(F * w[..., None, :], dim=-1)
            / torch.clamp_min(torch.sum(w, dim=-1), 1.0)[..., None] / hk)
    return -torch.sum(lamk * (coef - target_coef) ** 2, dim=-1)


def _sf_gain_lanes(xyz, mask, X, L, hyp: _Hyp, sig_n):
    """Sequential gain of each lane's path against the single-fidelity GP:
    Kxs (B, T, N) and Kss (B, T, T), two B1 launches."""
    B = xyz.shape[0]
    z = _zero_labels(xyz)
    Kxs = hyp.lanes(xyz, z, _broadcast(X, B),
                    _broadcast(_zero_labels(X), B))
    Kss = hyp.lanes(xyz, z, xyz, z)
    V = _la.tri_solve(L, Kxs.mT)
    Sigma = Kss - V.mT @ V
    return sequential_gain_from_cov(Sigma, sig_n, mask=mask)


def _mf_gain_lanes(xyz, fid_c, mask, X, fidX, L, hyp: _Hyp, noises):
    """Sequential gain of each lane's path against the AR1 model: each
    point conditions at its label ``fid_c`` and is predicted at fidelity 0.
    Kc_x, Kp_x (B, T, N), Kcc and Kpc (B, T, T): four B1 launches. Kcc gets
    the same tensors twice (B1's symmetric half grid); Kpc has the same
    points under other labels and takes the full grid."""
    B = xyz.shape[0]
    fid_p = _zero_labels(xyz)
    Xb, fXb = _broadcast(X, B), _broadcast(fidX, B)
    Kc_x = hyp.lanes(xyz, fid_c, Xb, fXb)
    Kp_x = hyp.lanes(xyz, fid_p, Xb, fXb)
    Kcc = hyp.lanes(xyz, fid_c, xyz, fid_c)
    Kpc = hyp.lanes(xyz, fid_p, xyz, fid_c)
    W = _k.ar1_fidelity_weights(hyp.rho, hyp.v.shape[0])
    kpp = torch.sum(W[:, 0] ** 2 * hyp.v)  # prior variance at fidelity 0

    Vc = _la.tri_solve(L, Kc_x.mT)
    Vp = _la.tri_solve(L, Kp_x.mT)
    Sig_cc = Kcc - Vc.mT @ Vc
    Sig_pc = Kpc - Vp.mT @ Vc
    sig_pp = kpp - torch.sum(Vp * Vp, dim=-2)
    C = _la.diag_add(Sig_cc, _k.mf_noise_diag(fid_c, noises))
    if mask is not None:
        C = _masked_pairs(C, mask, 1.0)
        Sig_pc = torch.where(mask[..., :, None] & mask[..., None, :],
                             Sig_pc, 0.0)
    return sequential_gain_cross(sig_pp, Sig_pc, C, noises[0], noises[0],
                                 mask=mask)


class _GridPrior:
    """The log-det costs' candidate-free blocks, computed once per cost:
    with Kg = K(grid, train) and V1 = L^-1 Kg^T, the prior grid posterior
    ``S = K(grid, grid) - V1^T V1 + noise I`` and its log-determinant.

    Conditioning on a path extends the training factor by one block,
    [[L, 0], [Lb^T, Lc]] with Lb = L^-1 K(train, path) and Lc =
    chol(C - Lb^T Lb); the grid's posterior is then S - V2^T V2 with V2 =
    Lc^-1 (K(path, grid) - Lb^T V1). The training block of that solve is V1
    for every lane, so no lane copies L or the extended factor."""

    def __init__(self, hyp: _Hyp, X, fidX, L, grid, fid_g, noise):
        self.X, self.fidX, self.L = X, fidX, L
        self.grid, self.fid_g, self.hyp = grid, fid_g, hyp
        Kg = hyp.single(grid, fid_g, X, fidX)
        Kss = hyp.single(grid, fid_g, grid, fid_g)
        self.V1 = _la.tri_solve(L, Kg.mT)  # (N, G)
        self.S = _la.diag_add(Kss - self.V1.mT @ self.V1,
                              torch.broadcast_to(noise, grid.shape[:1]))
        self.logdet_prior = logdet(self.S)

    def gain_lanes(self, xyz, fid_c, mask, C_noise, C_mask_fill):
        """0.5 (log|S| - log|S - V2^T V2|) per lane: B (B, N, T), C
        (B, T, T) with the per-lane noise diagonal ``C_noise`` (B, T), and
        K(grid, path) (B, G, T), three B1 launches."""
        B = xyz.shape[0]
        hyp = self.hyp
        Bk = hyp.lanes(_broadcast(self.X, B), _broadcast(self.fidX, B),
                       xyz, fid_c)
        C = hyp.lanes(xyz, fid_c, xyz, fid_c, noise_diag=C_noise)
        Kgp = hyp.lanes(_broadcast(self.grid, B), _broadcast(self.fid_g, B),
                        xyz, fid_c)
        if mask is not None:
            keep = mask[..., None, :]
            Bk = torch.where(keep, Bk, 0.0)
            C = _masked_pairs(C, mask, C_mask_fill)
            Kgp = torch.where(keep, Kgp, 0.0)
        Lb = _la.tri_solve(self.L, Bk)  # (B, N, T)
        Lc = _la.chol(C - Lb.mT @ Lb)
        V2 = _la.tri_solve(Lc, Kgp.mT - Lb.mT @ self.V1)  # (B, T, G)
        post = self.S - V2.mT @ V2
        return 0.5 * (self.logdet_prior - logdet(post))


# ---------------------------------------------------------------------------
# cost objects
# ---------------------------------------------------------------------------
@dataclass(eq=False)
class ErgodicCost:
    """Negative forward-KL between trajectory statistics and the EID
    (SURVEY C14, reference/GraceRIGV3.py:581-596): cost = -KL(q || EID).

    Zero-probability handling matches the reference: both q and the EID are
    floored by their smallest positive entry (capped at 1e-15) before the
    KL (reference/GraceRIGV3.py:588-592). The EID, the grid and the paths
    go to ``device`` in ``dtype``.
    """

    eid: np.ndarray  # (G,)
    grid: np.ndarray  # (G, d)
    sigma_diag: np.ndarray | None = None
    device: torch.device | str = CUDA
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        z = dict(dtype=self.dtype, device=resolve(self.device))
        self.grid = torch.as_tensor(self.grid, **z).contiguous()
        self.device = self.grid.device
        if self.sigma_diag is None:
            self.sigma_diag = 0.25 * torch.ones(self.grid.shape[1], **z)
        self.sigma_diag = torch.as_tensor(self.sigma_diag, **z)
        p = torch.as_tensor(self.eid, **z).reshape(-1)
        floor = torch.clamp_max(torch.amin(torch.where(p > 0, p, torch.inf)),
                                1e-15)
        self._p = torch.where(torch.any(p == 0), p + floor, p)

    def _lanes(self, pts, mask):
        return _ergodic_lanes(pts[..., 3], pts[..., :3], mask, self.grid,
                              self.sigma_diag, self._p)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(self._lanes(points_like(points[:, :4], self.grid)[None],
                                 None)[0])

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask, _ = _padded_on(paths, 4, self.grid)
        return _to_host(self._lanes(pts, mask))


@dataclass(eq=False)
class FourierErgodicCost:
    """Spectral (Sobolev-norm) ergodic cost over the cosine basis.

    The reference implements this metric standalone and never wires it into
    the planner (SURVEY C11, reference/PhysicalExperimentCode/
    ergodicMetric.py); here it is a first-class planner cost: score =
    -sum_k lambda_k (c_k(traj) - c_k(target))^2, with the target
    coefficients precomputed from the EID over the grid. Coordinates are
    normalized to the unit box (the cosine basis domain). Tensors live on
    ``device`` in ``dtype``.
    """

    eid: np.ndarray  # (G,) target distribution over grid
    grid: np.ndarray  # (G, d)
    bounds: np.ndarray  # (d, 2) workspace box for unit normalization
    n_coefs: int = 5  # coefficients per dimension
    device: torch.device | str = CUDA
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        z = dict(dtype=self.dtype, device=resolve(self.device))
        self.bounds = np.asarray(self.bounds, float)
        d = self.bounds.shape[0]
        lengths = self.bounds[:, 1] - self.bounds[:, 0]
        self._k = torch.as_tensor(config_k(*[(self.n_coefs, 1.0)] * d), **z)
        self._hk = basis_norms(self._k)
        self._lamk = sobolev_weights(self._k)
        grid = torch.as_tensor(self.grid, **z)
        gu = (grid[:, :d] - torch.as_tensor(self.bounds[:, 0], **z)) \
            / torch.as_tensor(lengths, **z)
        p = torch.as_tensor(self.eid, **z).reshape(-1)
        self._target = fourier_coefficients(gu, p * p.shape[0], self._k,
                                            self._hk)
        self._lo = torch.as_tensor(self.bounds[:, 0], **z)
        self._ilen = torch.as_tensor(1.0 / lengths, **z)
        self._d = d
        self.device = self._k.device

    def _unit(self, xyz):
        return (xyz[..., : self._d] - self._lo) * self._ilen

    def _lanes(self, pts, mask):
        return _fourier_lanes(self._unit(pts), mask, self._k, self._hk,
                              self._lamk, self._target)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(self._lanes(
            points_like(points[:, : self._d], self._k)[None], None)[0])

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask, _ = _padded_on(paths, self._d, self._k)
        return _to_host(self._lanes(pts, mask))


@dataclass(eq=False)
class SFInfoGainCost:
    """Sequential entropy gain against a single-fidelity GP
    (reference ``calcPathInfoSF2``, reference/GraceRIGV3.py:443-466),
    closed form, one Cholesky per candidate."""

    model: gpm.GP

    def __post_init__(self):
        m = self.model
        self._X, self._L = m.state.X, m.state.L
        self._hyp = _sf_hyp(m)
        self._noise = m.params.noise

    def _lanes(self, xyz, mask):
        return _sf_gain_lanes(xyz, mask, self._X, self._L, self._hyp,
                              self._noise)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(self._lanes(points_like(points[:, :3], self._X)[None],
                                 None)[0])

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask, _ = _padded_on(paths, 3, self._X)
        return _to_host(self._lanes(pts, mask))


@dataclass(eq=False)
class MFInfoGainCost:
    """Sequential gain against the multi-fidelity model
    (reference ``calculatePathInfoEmu``, reference/GraceRIGV3.py:525-562):
    each path point conditions at the fidelity implied by its accrued
    localization variance; prediction happens at fidelity 0 with the
    fidelity-0 likelihood noise as reference scale."""

    model: mfm.MFGP
    fid_levels: Sequence[float]  # ascending variance thresholds

    def __post_init__(self):
        m = self.model
        st = m.state
        self._X, self._fid, self._L = st.X, st.fid, st.L
        self._hyp = _mf_hyp(m)
        self._noises = m.params.noises
        self._F = int(m.params.variances.shape[0])

    def _fids_from_var(self, var):
        return fids_from_variance(var, self.fid_levels, self._F)

    def _lanes(self, xyz, fids, mask):
        return _mf_gain_lanes(xyz, _labels_on(fids, self._X), mask, self._X,
                              self._fid, self._L, self._hyp, self._noises)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(self._lanes(points_like(points[:, :3], self._X)[None],
                                 self._fids_from_var(points[None, :, 4]),
                                 None)[0])

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask, host = _padded_on(paths, 5, self._X)
        return _to_host(self._lanes(pts[..., :3].contiguous(),
                                    self._fids_from_var(host[..., 4]),
                                    mask))


@dataclass(eq=False)
class MFBatchLogDetCost:
    """Multi-fidelity batch mutual-information score over the eval grid
    (reference ``calculatePathInfoEmuBatch``, reference/
    PhysicalExperimentCode/GraceRIGV3.py:599-617). Path points condition at
    the fidelity implied by their accrued localization variance
    (labels l1*2+l2*1+l3*0, :602-606); the grid sits at the highest
    fidelity, and its prior log-det is cached per instance like the
    reference's per-plan ``logDetPrior``."""

    model: mfm.MFGP
    grid: np.ndarray
    fid_levels: Sequence[float]

    def __post_init__(self):
        m = self.model
        st = m.state
        self.grid = points_like(self.grid, st.X)
        self._F = int(m.params.variances.shape[0])
        fid_g = torch.full(self.grid.shape[:1], self._F - 1,
                           dtype=torch.long, device=st.X.device)
        self._noises = m.params.noises
        self._prior = _GridPrior(_mf_hyp(m), st.X, st.fid, st.L, self.grid,
                                 fid_g, self._noises[self._F - 1])
        self._logdet_prior = self._prior.logdet_prior

    def _fids_from_var(self, var):
        return fids_from_variance(var, self.fid_levels, self._F)

    def _lanes(self, xyz, fids, mask):
        fid_c = _labels_on(fids, xyz)
        return self._prior.gain_lanes(
            xyz, fid_c, mask, _k.mf_noise_diag(fid_c, self._noises), 1.0)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(self._lanes(points_like(points[:, :3], self.grid)[None],
                                 self._fids_from_var(points[None, :, 4]),
                                 None)[0])

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask, host = _padded_on(paths, 5, self.grid)
        return _to_host(self._lanes(pts[..., :3].contiguous(),
                                    self._fids_from_var(host[..., 4]),
                                    mask))


@dataclass(eq=False)
class BatchLogDetCost:
    """Batch mutual-information score over a fixed evaluation grid
    (reference ``calcPathInfoSFBatch``, reference/PhysicalExperimentCode/
    GraceRIGV3.py:571-598): 0.5 (log|Sigma_prior(grid)| -
    log|Sigma_post(grid | train + path)|); the prior log-determinant is
    cached per session like the reference's ``logDetPrior``. Conditioning
    on the path extends the training Cholesky by one block (O(N^2 P))
    instead of refitting.
    """

    model: gpm.GP
    grid: np.ndarray
    clamp_nonnegative: bool = True  # the reference's SF variant clamps >= 0

    def __post_init__(self):
        m = self.model
        st = m.state
        self.grid = points_like(self.grid, st.X)
        self._noise = m.params.noise
        self._prior = _GridPrior(_sf_hyp(m), st.X, _zero_labels(st.X), st.L,
                                 self.grid, _zero_labels(self.grid),
                                 self._noise)
        self._logdet_prior = self._prior.logdet_prior

    def _lanes(self, xyz, mask):
        z = _zero_labels(xyz)
        noise = torch.broadcast_to(self._noise, z.shape).contiguous()
        gain = self._prior.gain_lanes(xyz, z, mask, noise, self._noise)
        return torch.clamp_min(gain, 0.0) if self.clamp_nonnegative else gain

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(self._lanes(points_like(points[:, :3], self.grid)[None],
                                 None)[0])

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask, _ = _padded_on(paths, 3, self.grid)
        return _to_host(self._lanes(pts, mask))
