"""Ergodic coverage metric: trajectory time-averaged statistics + KL
(counterpart of ``mfgp_tpu/metrics/ergodic.py``).

SURVEY C10 (reference/ergodicKLDivergence.py). The reference loops over
grid cells, each a trapezoid rule over trajectory points
(reference/ergodicKLDivergence.py:53-61); here all G cells are one (G, T)
density and one product with the trapezoid weights. Every function takes
an optional leading lane axis (one candidate path per lane): the planner
scores a whole batch of candidates at once.

Masking: planner batches pad trajectories to a fixed T; pass ``mask`` to
exclude padding (padded steps get zero quadrature weight).

The functions take tensors: the first array argument keeps its device
and dtype (a numpy array becomes a CPU tensor), and the others follow it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def softmax(a):
    """Vector -> probability distribution over the last axis
    (reference/ergodicKLDivergence.py:6-9).

    Max-shifted for overflow safety (value-identical: softmax is shift
    invariant; the reference's raw ``exp`` overflows for large scores).
    """
    a = torch.as_tensor(a)
    e = torch.exp(a - torch.amax(a, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def config_grid(*specs):
    """Search-space grid (reference/ergodicKLDivergence.py:12-31).

    Each spec is (low, high, num). Returns (ss, grids..., lengths...) with
    ``ss`` the (prod(num), dim) stacked grid, matching the reference's
    meshgrid + ravel layout (numpy, like the JAX package's).
    """
    grids = np.meshgrid(*[np.linspace(s[0], s[1], s[2]) for s in specs])
    lengths = [s[1] - s[0] for s in specs]
    ss = np.array([g.ravel() for g in grids]).T
    return (ss, *grids, *lengths)


def _density_norm(sigma: torch.Tensor, d: int) -> torch.Tensor:
    return 1.0 / torch.sqrt((2 * math.pi) ** d * torch.prod(sigma, dim=-1))


def gaussian_sensor(x, s, sigma_diag):
    """Gaussian sensor footprint density N(s; x_t, diag(sigma)) per
    trajectory point (reference/ergodicKLDivergence.py:34-44).

    x: (..., T, d) trajectory; s: (d,) one domain point; sigma_diag: (d,)
    shared variances or (..., T, d) per-point variances. Returns (..., T).
    """
    x = torch.as_tensor(x)
    s, sigma = _like(s, x), _like(sigma_diag, x)
    quad = torch.sum((x - s) ** 2 / sigma, dim=-1)
    return _density_norm(sigma, x.shape[-1]) * torch.exp(-0.5 * quad)


def _trapezoid_weights(t, mask):
    """(weights (..., T), span (...)) of the trapezoid rule over ``t``; a
    masked step zeroes the weight of every interval that touches it."""
    dt = t[..., 1:] - t[..., :-1]
    if mask is None:
        seg_dt = dt
        span = t[..., -1] - t[..., 0]
    else:
        seg_dt = dt * (mask[..., 1:] & mask[..., :-1])
        span = torch.sum(seg_dt, dim=-1)
    w = torch.zeros_like(t)
    w[..., :-1] += 0.5 * seg_dt
    w[..., 1:] += 0.5 * seg_dt
    return w, span


def trajectory_distribution(t, x, grid, sigma_diag, mask=None,
                            parity_drop_last: bool = False):
    """Time-averaged trajectory statistics q over a discrete domain.

    q[g] = (1/T_total) * trapz_t N(s_g; x(t), diag(sigma)), the quantity the
    reference calls ``computeTrajectoryIntegrand``
    (reference/ergodicKLDivergence.py:46-61), for all G grid cells at once.

    t: (..., T) timestamps; x: (..., T, d); grid: (G, d); sigma_diag: (d,)
    or (..., T, d). mask: optional (..., T) boolean — False entries
    contribute zero quadrature weight (for padded planner batches).
    parity_drop_last: reproduce the reference's loop bound quirk that leaves
    the final grid cell at exactly 0 (its loop runs ``range(G-1)``).
    Returns (..., G).

    The (..., G, T) squared Mahalanobis distances accumulate one coordinate
    at a time from the differences (no (..., G, T, d) temporary; no
    ``|a|^2 + |b|^2 - 2ab`` expansion, which cancels).
    """
    x = torch.as_tensor(x)
    t = _like(t, x)
    grid = _like(grid, x)
    sigma = torch.broadcast_to(_like(sigma_diag, x), x.shape)
    d = x.shape[-1]
    quad = None
    for k in range(d):
        diff = x[..., None, :, k] - grid[:, k, None]
        term = diff * diff / sigma[..., None, :, k]
        quad = term if quad is None else quad + term
    dens = _density_norm(sigma, d)[..., None, :] * torch.exp(-0.5 * quad)
    del quad
    w, span = _trapezoid_weights(
        t, None if mask is None else torch.as_tensor(mask, device=x.device))
    q = (dens @ w[..., None])[..., 0] / span[..., None]
    if parity_drop_last:
        q[..., -1] = 0.0
    return q


def kl_divergence(p, q):
    """KL(p || q) over the last axis for discrete distributions,
    normalizing both inputs — the semantics of ``scipy.stats.entropy(p,
    q)`` the reference relies on (reference/ergodicKLDivergence.py:63-68).
    """
    p = torch.as_tensor(p)
    q = _like(q, p)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    return torch.sum(torch.where(p > 0, p * (torch.log(p) - torch.log(q)),
                                 0.0), dim=-1)


def combined_trajectory_distribution(dur1, dur2, q1, q2):
    """Duration-weighted merge of two trajectory distributions
    (reference/ergodicKLDivergence.py:70-71)."""
    tot = dur1 + dur2
    return dur1 / tot * q1 + dur2 / tot * q2
