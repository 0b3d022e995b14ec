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

``ar1_cov_lanes`` and ``sf_cov_diff`` take a leading lane axis on every
argument, each lane its own problem (the batched study's datasets x
restarts): on the card one launch of B1's lane axis serves all lanes, and
``_AR1TrainCov`` takes lanes too. Elsewhere they stack the lanes' plain
compositions.
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
def ar1_cov_lanes(variances, lengthscales, rhos, X1, fid1, X2, fid2,
                  kernel: str, noise_diag=None) -> torch.Tensor:
    """(L, N, M) AR1 covariances of L lanes (``cuda_kernels.
    ar1_cov_fused_lanes``'s arguments), plus ``noise_diag`` (L, N) on each
    Gram's diagonal when given: one lane-axis B1 launch on the card, the
    lanes' plain compositions elsewhere (CPU, float64)."""
    fused = (_ck.ar1_cov_fused_lanes if use_cuda_kernels(X1, kernel)
             else _ck.ar1_cov_fused_lanes_plain)
    return fused(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                 noise_diag, kernel)


def _dweights_drho(rhos, m: int, l: int, F: int) -> torch.Tensor:
    """(F,) row ``d W[m, :] / d rho_l``: ``prod_{k in (m, f], k != l+1}
    rho_k`` where ``m < l+1 <= f`` (rho_l couples fidelity l to l+1), else
    0. Product form, no division, so it stays finite at rho = 0. ``rhos``
    may carry leading lane axes: (..., F-1) -> (..., F)."""
    row = []
    for f in range(F):
        p = rhos.new_zeros(rhos.shape[:-1])
        if m < l + 1 <= f:
            p = rhos.new_ones(rhos.shape[:-1])
            for k in range(m + 1, f + 1):
                if k != l + 1:
                    p = p * rhos[..., k - 1]
        row.append(p)
    return torch.stack(row, dim=-1)


def _ar1_cov_bwd(kern: str, variances, lengthscales, rhos, X, fid, Ct):
    """Cotangents of (variances, lengthscales, rhos) of the AR1 training Gram
    for a general (possibly asymmetric) cotangent ``Ct``
    (``mfgp_tpu/ops/covariance.py:159-230``). With T_m = v_m (w_m w_m^T) o
    K_m, A = Ct o T_m and S_d = (x_d 1^T - 1 x_d^T)^2:

      v_bar_m     = sum(A) / v_m
      l_bar_{m,d} = sum(A o S_d) / l_{m,d}^3,
                    with A replaced for matern32 by Ct o v_m (w w^T) 3
                    e^{-sqrt3 r} (its dK/dl_d is not proportional to K)
      rho_bar_l   = sum_m g^T (B w_m) + g^T (B^T w_m),  B = Ct o v_m K_m,
                    g = d W[m, fid] / d rho_l

    The distances are summed from differences, as B1 takes them (no
    |x|^2 + |y|^2 - 2 x.y expansion, which cancels in float32 for close
    points far from the origin at small lengthscales). Each fidelity's
    N x N terms are built, contracted and freed before the next (every
    float32 N x N buffer is 1.6 GB at N=20,000). Every argument
    may carry one leading lane axis (variances (L, F), lengthscales
    (L, F, D), rhos (L, F-1), X (L, N, D), fid (L, N), Ct (L, N, N)); the
    contractions never mix lanes."""
    F = variances.shape[-1]
    N, D = X.shape[-2:]
    W = _k.ar1_fidelity_weights(rhos, F)
    w = torch.gather(W, -1, fid[..., None, :].expand(*W.shape[:-1], N))
    inv_ls = 1.0 / lengthscales
    v_bar, l_bar = [], []
    rho_bar = [rhos.new_zeros(rhos.shape[:-1]) for _ in range(F - 1)]

    def diff(d):  # x_id - x_jd, (..., N, N)
        return X[..., :, None, d] - X[..., None, :, d]

    for m in range(F):
        r2 = X.new_zeros(X.shape[:-1] + (N,))
        for d in range(D):
            r2.add_((diff(d) * inv_ls[..., m, d, None, None]) ** 2)
        if kern == "rbf":
            B = torch.exp(-0.5 * r2)
        else:
            # one distance pass serves the covariance and matern32's
            # lengthscale base; same formula and guard as kernels.matern32
            r = torch.sqrt(r2 + 1e-36)
            e3 = torch.exp(-_k._SQRT3 * r)
            B = (1.0 + _k._SQRT3 * r) * e3
            del r
        del r2
        vm = variances[..., m, None, None]
        B = B.mul_(vm).mul_(Ct)  # Ct o v_m K_m
        wm = w[..., m, :]
        wprod = wm[..., :, None] * wm[..., None, :]
        A = B * wprod  # Ct o T_m
        v_bar.append(torch.sum(A, dim=(-2, -1)) / variances[..., m])
        if kern == "rbf":
            E = A
        else:
            del A
            E = e3.mul_(vm * 3.0).mul_(Ct).mul_(wprod)
            del e3
        del wprod
        quad = torch.stack([torch.sum(E * diff(d) ** 2, dim=(-2, -1))
                            for d in range(D)], dim=-1)
        del E
        l_bar.append(quad * inv_ls[..., m, :] ** 3)  # v_m is inside A / E
        if F > 1:
            Bw = (B @ wm[..., :, None])[..., 0]
            Btw = (B.mT @ wm[..., :, None])[..., 0]
            for l in range(F - 1):
                g = torch.gather(_dweights_drho(rhos, m, l, F), -1, fid)
                rho_bar[l] = rho_bar[l] + (torch.sum(g * Bw, dim=-1)
                                           + torch.sum(g * Btw, dim=-1))
        del B
    return (torch.stack(v_bar, dim=-1), torch.stack(l_bar, dim=-2),
            torch.stack(rho_bar, dim=-1) if rho_bar
            else torch.zeros_like(rhos))


class _AR1TrainCov(torch.autograd.Function):
    """The AR1 training Gram ``K(X, X)`` as a function of (variances,
    lengthscales, rhos): forward through B1 (``ar1_cov_fused``, its plain
    version on a CPU tensor), backward in closed form (``_ar1_cov_bwd``).
    Only the O(N) inputs are saved, no N x N residual. With a leading lane
    axis on every input (X (L, N, D), ...) it is L Grams (L, N, N) from one
    launch of B1's lane axis (``ar1_cov_fused_lanes``), each lane's
    backward its own."""

    @staticmethod
    def forward(ctx, kern, variances, lengthscales, rhos, X, fid):
        ctx.kern = kern
        ctx.save_for_backward(variances, lengthscales, rhos, X, fid)
        fused = (_ck.ar1_cov_fused_lanes if X.dim() == 3
                 else _ck.ar1_cov_fused)
        return fused(X, fid, X, fid, variances, lengthscales, rhos,
                     kern=kern)

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
    composition elsewhere. With one leading lane axis on every argument
    (X (L, N, D), ...) it is L Grams (L, N, N), each lane its own."""
    if use_cuda_kernels(X, kernel):
        return _AR1TrainCov.apply(kernel, variances, lengthscales, rhos, X,
                                  fid)
    if X.dim() == 3:
        return torch.stack([ar1_cov_diff(variances[l], lengthscales[l],
                                         rhos[l], X[l], fid[l], kernel)
                            for l in range(X.shape[0])])
    return _k.ar1_cov(X, fid, X, fid, variances, lengthscales, rhos, kernel)


def sf_cov_diff(variance, lengthscales, X, kernel: str) -> torch.Tensor:
    """Differentiable single-fidelity training covariance: the F=1 case of
    ``ar1_cov_diff`` (no rhos, every label 0). With one leading lane axis
    (``variance`` (L,), ``lengthscales`` (L, D), X (L, N, D) -> (L, N, N))
    each lane is its own dataset: one launch of B1's lane axis on the card,
    the lanes' plain kernels elsewhere."""
    lead = X.shape[:-2]
    if use_cuda_kernels(X, kernel):
        v = torch.as_tensor(variance, dtype=X.dtype,
                            device=X.device).reshape(lead + (1,))
        ls = torch.as_tensor(lengthscales, dtype=X.dtype,
                             device=X.device).reshape(lead + (1, -1))
        fid = torch.zeros(X.shape[:-1], dtype=torch.long, device=X.device)
        return _AR1TrainCov.apply(kernel, v, ls, X.new_zeros(lead + (0,)),
                                  X, fid)
    if lead:
        return torch.stack([sf_cov_diff(variance[l], lengthscales[l], X[l],
                                        kernel) for l in range(X.shape[0])])
    return _k.KERNELS[kernel](X, X, variance, lengthscales)
