"""Fourier/Sobolev ergodic metric, cosine basis (counterpart of
``mfgp_tpu/metrics/fourier.py``).

SURVEY C11 (reference/PhysicalExperimentCode/ergodicMetric.py): Fourier
coefficients of trajectory / target distributions on a rectangular domain,
Sobolev-weighted spectral distance, and incremental coefficient merging for
streaming trajectories. The basis is one (M, N) product of cosines instead
of the reference's per-coefficient loop
(reference/PhysicalExperimentCode/ergodicMetric.py:70-74); points may carry
a leading lane axis (one candidate path per lane).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def config_k(*specs):
    """Fourier index set. Each spec is (num_k, L) — number of coefficients
    and domain length per dimension
    (reference/PhysicalExperimentCode/ergodicMetric.py:24-38). Returns
    (prod(num_k), dim) scaled indices k_i/L_i (numpy)."""
    ks = np.meshgrid(*[np.arange(0, s[0]) / s[1] for s in specs])
    return np.array([k.ravel() for k in ks]).T


def basis_norms(k):
    """Normalization h_k = sqrt(prod (2k + sin 2k)/(4k)), with the k=0 limit
    1 (reference/PhysicalExperimentCode/ergodicMetric.py:40-47)."""
    k = torch.as_tensor(k)
    hk = torch.where(k == 0, 1.0, (2.0 * k + torch.sin(2.0 * k)) / (4.0 * k))
    return torch.sqrt(torch.prod(hk, dim=1))


def sobolev_weights(k):
    """lambda_k = (1 + |k|^2)^(-(d+1)/2)
    (reference/PhysicalExperimentCode/ergodicMetric.py:49-54)."""
    k = torch.as_tensor(k)
    d = k.shape[1]
    return (1.0 + torch.sum(k ** 2, dim=1)) ** (-(d + 1.0) / 2.0)


def fourier_basis(x, k):
    """Cosine basis F[m, n] = prod_d cos(pi * x[n,d] * k[m,d]).

    x: (..., N, d) points, k: (M, d) indices -> (..., M, N), the
    reference's ``fk`` layout (reference/PhysicalExperimentCode/
    ergodicMetric.py:65-74), one coordinate's cosines at a time.
    """
    x = torch.as_tensor(x)
    k = torch.as_tensor(k, dtype=x.dtype, device=x.device)
    out = None
    for j in range(x.shape[-1]):
        c = torch.cos(math.pi * x[..., None, :, j] * k[:, j, None])
        out = c if out is None else out * c
    return out


def fourier_coefficients(x, w, k, hk=None):
    """Coefficients c_k = mean_n(F[k, n] * w[n]) / h_k
    (reference/PhysicalExperimentCode/ergodicMetric.py:76-87).

    For a trajectory distribution pass w = ones (Dirac time statistics);
    for a target function over a grid pass the function values.
    """
    x = torch.as_tensor(x)
    k = torch.as_tensor(k, dtype=x.dtype, device=x.device)
    if hk is None:
        hk = basis_norms(k)
    w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    w = (w.reshape(x.shape[:-1]) if w.numel() == x.shape[:-1].numel()
         else w.reshape(-1))  # an (N, 1) column too
    return torch.mean(fourier_basis(x, k) * w[..., None, :], dim=-1) / hk


def merge_coefficients(coef1, coef2, dur1, dur2):
    """Duration-weighted streaming merge
    (reference/PhysicalExperimentCode/ergodicMetric.py:89-96)."""
    tot = dur1 + dur2
    return (dur1 * coef1 + dur2 * coef2) / tot


def sobolev_norm(coef1, coef2, k):
    """Sobolev-weighted spectral distance over the last axis
    (reference/PhysicalExperimentCode/ergodicMetric.py:98-104)."""
    coef1 = torch.as_tensor(coef1)
    lam = sobolev_weights(torch.as_tensor(k, dtype=coef1.dtype,
                                          device=coef1.device))
    return torch.sum(lam * (coef1 - torch.as_tensor(coef2)) ** 2, dim=-1)
