"""Covariance-assembly dispatch (counterpart of
``mfgp_tpu/ops/covariance.py``).

Covariances (training Grams, prediction cross-covariances) go through the
hand-written CUDA kernel ``ops.cuda_kernels.ar1_cov_fused`` when
``use_cuda_kernels`` holds, and through the plain composition
(``ops.kernels``) otherwise: CPU tensors, float64, other base kernels. The
gate is decided from the tensor itself; there is no probe and no silent
fallback, so a CUDA float32 rbf/matern32 call launches the kernel or raises.

The differentiable training Gram (``ar1_cov_diff``, ``sf_cov_diff``: the
autodiff NLML of both model families) runs on the card as ``_AR1TrainCov``,
an autograd Function whose forward is the kernel and whose backward is the
closed-form contraction of the cotangent with each fidelity's terms
(the JAX package's custom VJP). Elsewhere autograd differentiates the plain
composition, as JAX's autodiff does.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

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


# ---------------------------------------------------------------------------
# differentiable training Gram
# ---------------------------------------------------------------------------
def _dweights_drho(rhos, m: int, l: int, F: int) -> torch.Tensor:
    """(F,) row ``d W[m, :] / d rho_l``: ``prod_{k in (m, f], k != l+1}
    rho_k`` where ``m < l+1 <= f`` (rho_l couples fidelity l to l+1), else
    0. Product form, no division, so it stays finite at rho = 0."""
    row = []
    for f in range(F):
        p = rhos.new_zeros(())
        if m < l + 1 <= f:
            p = rhos.new_ones(())
            for k in range(m + 1, f + 1):
                if k != l + 1:
                    p = p * rhos[k - 1]
        row.append(p)
    return torch.stack(row)


def _ar1_cov_bwd(kern: str, variances, lengthscales, rhos, X, fid, Ct):
    """Cotangents of (variances, lengthscales, rhos) of the AR1 training Gram
    for a general (possibly asymmetric) cotangent ``Ct``
    (``mfgp_tpu/ops/covariance.py:159-230``). With T_m = v_m (w_m w_m^T) o
    K_m, A = Ct o T_m and [r | R] = A [1 | X], [c | C] = A^T [1 | X]:

      v_bar_m     = sum(A) / v_m
      l_bar_{m,d} = (x_d^2 . (r + c) - x_d . (R + C)_d) / l_{m,d}^3,
                    with A replaced for matern32 by Ct o v_m (w w^T) 3
                    e^{-sqrt3 r} (its dK/dl_d is not proportional to K)
      rho_bar_l   = sum_m g^T (B w_m) + g^T (B^T w_m),  B = Ct o v_m K_m,
                    g = d W[m, fid] / d rho_l

    Each fidelity's N x N terms are built, contracted and freed before the
    next (every float32 N x N buffer is 1.6 GB at N=20,000)."""
    F = variances.shape[0]
    N = X.shape[0]
    w = _k.ar1_fidelity_weights(rhos, F)[:, fid]
    inv_ls = 1.0 / lengthscales
    ones_x = torch.cat([X.new_ones((N, 1)), X], dim=1)
    v_bar, l_bar = [], []
    rho_bar = [rhos.new_zeros(()) for _ in range(F - 1)]
    for m in range(F):
        if kern == "rbf":
            B = _k.rbf(X, X, 1.0, lengthscales[m])
        else:
            # one distance pass serves the covariance and matern32's
            # lengthscale base; same formula and guard as kernels.matern32
            r = torch.sqrt(_k.sqdist(X, X, inv_ls[m]) + 1e-36)
            e3 = torch.exp(-_k._SQRT3 * r)
            B = (1.0 + _k._SQRT3 * r) * e3
            del r
        B = B.mul_(variances[m]).mul_(Ct)  # Ct o v_m K_m
        wprod = w[m][:, None] * w[m][None, :]
        A = B * wprod  # Ct o T_m
        rA, cA = A @ ones_x, A.T @ ones_x
        del A
        v_bar.append(torch.sum(rA[:, 0]) / variances[m])
        if kern == "rbf":
            rE, cE = rA, cA
        else:
            E = e3.mul_(variances[m] * 3.0).mul_(Ct).mul_(wprod)
            del e3
            rE, cE = E @ ones_x, E.T @ ones_x
            del E
        del wprod
        quad = (torch.sum(X ** 2 * (rE[:, :1] + cE[:, :1]), dim=0)
                - torch.sum(X * (rE[:, 1:] + cE[:, 1:]), dim=0))
        l_bar.append(quad * inv_ls[m] ** 3)  # v_m is inside A / E
        if F > 1:
            Bw, Btw = B @ w[m], B.T @ w[m]
            for l in range(F - 1):
                g = _dweights_drho(rhos, m, l, F)[fid]
                rho_bar[l] = rho_bar[l] + (g @ Bw + g @ Btw)
        del B
    return (torch.stack(v_bar), torch.stack(l_bar),
            torch.stack(rho_bar) if rho_bar else torch.zeros_like(rhos))


class _AR1TrainCov(torch.autograd.Function):
    """The AR1 training Gram ``K(X, X)`` as a function of (variances,
    lengthscales, rhos): forward through B1 (``ar1_cov_fused``, its plain
    version on a CPU tensor), backward in closed form (``_ar1_cov_bwd``).
    Only the O(N) inputs are saved, no N x N residual."""

    @staticmethod
    def forward(ctx, kern, variances, lengthscales, rhos, X, fid):
        ctx.kern = kern
        ctx.save_for_backward(variances, lengthscales, rhos, X, fid)
        return _ck.ar1_cov_fused(X, fid, X, fid, variances, lengthscales,
                                 rhos, kern=kern)

    @staticmethod
    @once_differentiable
    def backward(ctx, Ct):
        v_bar, l_bar, rho_bar = _ar1_cov_bwd(ctx.kern, *ctx.saved_tensors,
                                             Ct)
        return None, v_bar, l_bar, rho_bar, None, None


def ar1_cov_diff(variances, lengthscales, rhos, X, fid,
                 kernel: str) -> torch.Tensor:
    """Differentiable AR1 training covariance (without noise): the
    ``_AR1TrainCov`` Function on the card, autograd through the plain
    composition elsewhere."""
    if use_cuda_kernels(X, kernel):
        return _AR1TrainCov.apply(kernel, variances, lengthscales, rhos, X,
                                  fid)
    return _k.ar1_cov(X, fid, X, fid, variances, lengthscales, rhos, kernel)


def sf_cov_diff(variance, lengthscales, X, kernel: str) -> torch.Tensor:
    """Differentiable single-fidelity training covariance: the F=1 case of
    ``ar1_cov_diff`` (no rhos, every label 0)."""
    if use_cuda_kernels(X, kernel):
        v = torch.as_tensor(variance, dtype=X.dtype,
                            device=X.device).reshape(1)
        ls = torch.as_tensor(lengthscales, dtype=X.dtype,
                             device=X.device).reshape(1, -1)
        fid = torch.zeros(X.shape[0], dtype=torch.long, device=X.device)
        return _AR1TrainCov.apply(kernel, v, ls, X.new_zeros(0), X, fid)
    return _k.KERNELS[kernel](X, X, variance, lengthscales)
