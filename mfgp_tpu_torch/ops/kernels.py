"""Covariance kernels in PyTorch (counterpart of ``mfgp_tpu/ops/kernels.py``).

Same formulation as the JAX package: the ARD squared distance is the matmul
expansion ``r2 = |x|^2 + |x'|^2 - 2 x.x'`` clamped at 0, so the O(N M D)
work is one (N, D) x (D, M) product and no (N, M, D) difference tensor is
built. Fidelity labels are dense per-point integer tensors, so the AR1
covariance is one masked dense sum over the F base kernels.

These compositions are also the plain versions that the hand-written CUDA
covariance kernel (``ops/cuda_kernels.ar1_cov_fused``) is tested against.
"""

from __future__ import annotations

import torch

_SQRT3 = 1.7320508075688772


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def sqdist(X1: torch.Tensor, X2: torch.Tensor,
           inv_lengthscales) -> torch.Tensor:
    """ARD squared distance ``r2[i,j] = sum_d (x1[i,d]-x2[j,d])^2 / l_d^2``.

    X1: (N, D), X2: (M, D), inv_lengthscales: (D,) == 1/l. Returns (N, M),
    clamped to >= 0 (the expansion can go slightly negative in floating
    point).
    """
    inv_l = _as(inv_lengthscales, X1)
    X1s = X1 * inv_l
    X2s = X2 * inv_l
    n1 = torch.sum(X1s * X1s, dim=-1)
    n2 = torch.sum(X2s * X2s, dim=-1)
    r2 = n1[:, None] + n2[None, :] - 2.0 * (X1s @ X2s.T)
    return torch.clamp_min(r2, 0.0)


def _ard(lengthscales, X1: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(_as(lengthscales, X1).reshape(-1),
                              (X1.shape[-1],))


def rbf(X1, X2, variance, lengthscales) -> torch.Tensor:
    """RBF ARD kernel, GPy convention: ``variance * exp(-r2 / 2)``."""
    r2 = sqdist(X1, X2, 1.0 / _ard(lengthscales, X1))
    return variance * torch.exp(-0.5 * r2)


def matern32(X1, X2, variance, lengthscales) -> torch.Tensor:
    """Matern-3/2 ARD kernel: ``variance (1 + sqrt3 r) exp(-sqrt3 r)``.

    The 1e-36 inside the square root keeps the derivative finite at r = 0
    (same guard as the JAX package).
    """
    r = torch.sqrt(sqdist(X1, X2, 1.0 / _ard(lengthscales, X1)) + 1e-36)
    return variance * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)


KERNELS = {"rbf": rbf, "matern32": matern32}


def ar1_fidelity_weights(rhos: torch.Tensor,
                         n_fidelities: int) -> torch.Tensor:
    """AR1 weights ``W[m, f] = prod_{l=m+1..f} rho_l`` (0 for f < m).

    Built row by row instead of as a cumulative-product ratio C[f]/C[m],
    which is 0/0 = NaN whenever a rho is exactly 0.
    """
    rows = []
    for m in range(n_fidelities):
        entries = []
        for f in range(n_fidelities):
            if f < m:
                entries.append(rhos.new_zeros(()))
            elif f == m:
                entries.append(rhos.new_ones(()))
            else:
                entries.append(entries[-1] * rhos[f - 1])
        rows.append(torch.stack(entries))
    return torch.stack(rows)


def ar1_cov(X1, fid1, X2, fid2, variances, lengthscales, rhos,
            kernel: str = "rbf") -> torch.Tensor:
    """Dense AR1 multi-fidelity covariance between labelled point sets.

    X1: (N, D), fid1: (N,) integer labels in [0, F); likewise X2/fid2.
    variances: (F,), lengthscales: (F, D), rhos: (F-1,). Returns
    ``sum_m (w_m[fid1] w_m[fid2]^T) o k_m(X1, X2)``.
    """
    F = variances.shape[0]
    kfn = KERNELS[kernel]
    W = ar1_fidelity_weights(rhos, F)
    out = None
    for m in range(F):
        Km = kfn(X1, X2, variances[m], lengthscales[m])
        term = (W[m][fid1][:, None] * W[m][fid2][None, :]) * Km
        out = term if out is None else out + term
    return out


def mf_noise_diag(fid: torch.Tensor,
                  noise_variances: torch.Tensor) -> torch.Tensor:
    """Per-point observation noise: one Gaussian noise per fidelity."""
    return noise_variances[fid]
