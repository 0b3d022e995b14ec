"""Covariance-assembly dispatch (counterpart of the forward half of
``mfgp_tpu/ops/covariance.py``).

Forward covariances (training Grams, prediction cross-covariances) go
through the hand-written CUDA kernel ``ops.cuda_kernels.ar1_cov_fused`` when
``use_cuda_kernels`` holds, and through the plain composition
(``ops.kernels``) otherwise: CPU tensors, float64, other base kernels. The
gate is decided from the tensor itself; there is no probe and no silent
fallback, so a CUDA float32 rbf/matern32 call launches the kernel or raises.
"""

from __future__ import annotations

import torch

from mfgp_tpu_torch.ops import cuda_kernels as _ck
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la


def use_cuda_kernels(x: torch.Tensor, kernel: str) -> bool:
    """True when the hand-written kernels apply: ``x`` on CUDA, float32,
    base rbf or matern32."""
    return (x.is_cuda and x.dtype == torch.float32
            and kernel in ("rbf", "matern32"))


def mf_train_cov(variances, lengthscales, rhos, noises, X, fid,
                 jitter: float, kernel: str) -> torch.Tensor:
    """AR1 training covariance + per-fidelity noise (+ jitter) diagonal."""
    noise = _k.mf_noise_diag(fid, noises) + jitter
    if use_cuda_kernels(X, kernel):
        return _ck.ar1_cov_fused(X, fid, X, fid, variances, lengthscales,
                                 rhos, noise_diag=noise, kern=kernel)
    K = _k.ar1_cov(X, fid, X, fid, variances, lengthscales, rhos, kernel)
    return _la.diag_add(K, noise)


def mf_cross_cov(variances, lengthscales, rhos, X1, fid1, X2, fid2,
                 kernel: str) -> torch.Tensor:
    """AR1 cross-covariance between labelled point sets."""
    if use_cuda_kernels(X1, kernel):
        return _ck.ar1_cov_fused(X1, fid1, X2, fid2, variances,
                                 lengthscales, rhos, kern=kernel)
    return _k.ar1_cov(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                      kernel)


def sf_train_cov(variance, lengthscales, noise_diag, X,
                 kernel: str) -> torch.Tensor:
    """Single-fidelity training covariance + noise diagonal."""
    noise = torch.broadcast_to(torch.as_tensor(noise_diag, dtype=X.dtype,
                                               device=X.device),
                               (X.shape[0],))
    if use_cuda_kernels(X, kernel):
        return _ck.rbf_cov_fused(X, X, variance, lengthscales,
                                 noise_diag=noise.contiguous(), kern=kernel)
    return _la.diag_add(_k.KERNELS[kernel](X, X, variance, lengthscales),
                        noise)


def sf_cross_cov(variance, lengthscales, X1, X2,
                 kernel: str) -> torch.Tensor:
    """Single-fidelity cross-covariance."""
    if use_cuda_kernels(X1, kernel):
        return _ck.rbf_cov_fused(X1, X2, variance, lengthscales, kern=kernel)
    return _k.KERNELS[kernel](X1, X2, variance, lengthscales)
