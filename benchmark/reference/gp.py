"""Plain reference of the 3-fidelity AR1 (Kennedy-O'Hagan) multi-fidelity
GP: covariance, NLML and its gradient, conditioning and the posterior.

Written from the model's equations, in plain PyTorch, and imports nothing
of the program:

    f_0 = g_0,  f_i = rho_i f_{i-1} + g_i,  g_m ~ GP(0, v_m k_m),
    cov(f_i(x), f_j(x')) = sum_m W[m,i] W[m,j] v_m k_m(x, x'),
    W[m, f] = prod_{l=m+1..f} rho_l (0 for f < m),
    rbf: k = exp(-r^2 / 2), matern32: k = (1 + sqrt3 r) exp(-sqrt3 r),
    r^2 = sum_d ((x_d - x'_d) / l_{m,d})^2, summed from differences;
    K = cov(X, X) + diag(noise[fid] + jitter);
    NLML = y^T K^-1 y / 2 + log|K| / 2 + N log(2 pi) / 2,
    d NLML / d theta = sum((K^-1 - a a^T) o dK/dtheta) / 2, a = K^-1 y,
    for theta = log v_m, log l_{m,d}, log noise_f (rhos held fixed).

Everything is computed in float64.

Large matrices are handled in blocks of rows, so that a reference at
N=20,000 fits beside nothing else on the card.
"""

from __future__ import annotations

import math

import torch

SQRT3 = math.sqrt(3.0)
LOG2PI = math.log(2.0 * math.pi)
F64 = torch.float64


def weights(rhos: torch.Tensor, F: int) -> torch.Tensor:
    W = torch.zeros((F, F), dtype=rhos.dtype, device=rhos.device)
    for m in range(F):
        W[m, m] = 1.0
        for f in range(m + 1, F):
            W[m, f] = W[m, f - 1] * rhos[f - 1]
    return W


def _base(kernel: str, r2: torch.Tensor) -> torch.Tensor:
    if kernel == "rbf":
        return torch.exp(-0.5 * r2)
    if kernel == "matern32":
        r = torch.sqrt(r2)
        return (1.0 + SQRT3 * r) * torch.exp(-SQRT3 * r)
    raise ValueError(kernel)


def _sqdist(X1, X2, ls):
    r2 = None
    for d in range(X1.shape[1]):
        t = ((X1[:, None, d] - X2[None, :, d]) / ls[d]) ** 2
        r2 = t if r2 is None else r2 + t
    return r2


def cov(X1, f1, X2, f2, th: dict, kernel: str) -> torch.Tensor:
    """AR1 covariance between labelled point sets, without noise."""
    F = th["variances"].shape[0]
    W = weights(th["rhos"], F)
    out = None
    for m in range(F):
        t = (W[m][f1][:, None] * W[m][f2][None, :] * th["variances"][m]
             * _base(kernel, _sqdist(X1, X2, th["lengthscales"][m])))
        out = t if out is None else out + t
    return out


def as_theta(th: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=F64, device=device)
            for k, v in th.items()}


def factor(X, fid, y, th: dict, kernel: str, jitter: float):
    """(L, alpha, logdet) of K = cov(X, X) + diag(noise[fid] + jitter)."""
    X, y = X.to(F64), y.to(F64)
    th = as_theta(th, X.device)
    K = cov(X, fid, X, fid, th, kernel)
    K.diagonal().add_(th["noises"][fid] + jitter)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return L, alpha, logdet


def nlml_grad(X, fid, y, th: dict, kernel: str = "rbf", jitter: float = 0.0,
              block: int = 2048, keep_L: bool = False) -> dict:
    """NLML, its gradient in (log variances, log lengthscales, log noises)
    and alpha = K^-1 y; with ``keep_L`` also the factor ``L``."""
    L, alpha, logdet = factor(X, fid, y, th, kernel, jitter)
    N = L.shape[0]
    value = (0.5 * torch.dot(y.to(F64), alpha) + 0.5 * logdet
             + 0.5 * N * LOG2PI)
    Ki = torch.cholesky_inverse(L)
    if not keep_L:
        L = None
    r = _contract(Ki, alpha, X.to(F64), fid, as_theta(th, X.device), kernel,
                  block)
    return dict(r, value=value, alpha=alpha, L=L)


def _contract(Ki, alpha, X, fid, t: dict, kernel: str, block: int) -> dict:
    """The trace identities' sums of W = K^-1 - alpha alpha^T against each
    derivative of K, a block of rows at a time, in the dtype of ``Ki``."""
    N = Ki.shape[0]
    F, D = t["lengthscales"].shape
    W = weights(t["rhos"], F)
    g_v = torch.zeros(F, dtype=Ki.dtype, device=X.device)
    g_l = torch.zeros((F, D), dtype=Ki.dtype, device=X.device)
    qdiag = torch.empty(N, dtype=Ki.dtype, device=X.device)
    for i0 in range(0, N, block):
        i1 = min(i0 + block, N)
        Q = Ki[i0:i1] - alpha[i0:i1, None] * alpha[None, :]
        qdiag[i0:i1] = torch.diagonal(Q, offset=i0)
        diffs = [X[i0:i1, None, d] - X[None, :, d] for d in range(D)]
        for m in range(F):
            ls = t["lengthscales"][m]
            sq = [(df / ls[d]) ** 2 for d, df in enumerate(diffs)]
            r2 = sum(sq)
            wq = (W[m][fid[i0:i1]][:, None] * W[m][fid][None, :]
                  * t["variances"][m]) * Q
            if kernel == "rbf":
                T = wq * torch.exp(-0.5 * r2)
                g_v[m] += torch.sum(T)
                for d in range(D):
                    g_l[m, d] += torch.sum(T * sq[d])
            else:
                r = torch.sqrt(r2)
                e3 = torch.exp(-SQRT3 * r)
                g_v[m] += torch.sum(wq * (1.0 + SQRT3 * r) * e3)
                E = 3.0 * wq * e3
                for d in range(D):
                    g_l[m, d] += torch.sum(E * sq[d])
    g_n = torch.zeros(F, dtype=Ki.dtype, device=X.device)
    g_n.index_add_(0, fid, qdiag * t["noises"][fid])
    return dict(g_logvar=0.5 * g_v, g_logls=0.5 * g_l, g_lognoise=0.5 * g_n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits (to the
    nearest, ties away from zero): the operand a TF32 tensor core reads.
    NaN and infinities stay as they are (the rounding's carry would wrap a
    NaN's bits to zero)."""
    i = x.contiguous().view(torch.int32)
    r = torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def chol_tf32(K: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Lower Cholesky factor of a float32 K by right-looking blocks: each
    diagonal block factored and each panel solved in float32, each
    trailing update a product of TF32 operands summed in float32, as a
    tensor-core factorization computes it. All NaN where a diagonal block
    is not positive definite."""
    A = K.clone()
    n = A.shape[0]
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        L11, info = torch.linalg.cholesky_ex(A[k0:k1, k0:k1])
        if int(info) != 0:
            return torch.full_like(A, float("nan"))
        A[k0:k1, k0:k1] = L11
        if k1 < n:
            L21 = torch.linalg.solve_triangular(
                L11, A[k1:, k0:k1].T, upper=False).T
            A[k1:, k0:k1] = L21
            R = tf32(L21)
            A[k1:, k1:] -= R @ R.T
    return torch.tril(A)


def nlml_grad_tf32(X, fid, y, th: dict, kernel: str = "rbf",
                   jitter: float = 0.0, block: int = 2048) -> dict:
    """``nlml_grad`` one precision below the configuration's float32 with
    TF32 off: float32 throughout, and every product's operands rounded to
    TF32 (the factorization's updates, K^-1 = Linv^T Linv, alpha = K^-1
    y); the triangular inverse and the sums stay float32. The control of
    the fit's evaluation, computed in the program's place."""
    F32 = torch.float32
    X, y = X.to(F32), y.to(F32)
    t = {k: torch.as_tensor(v, dtype=F32, device=X.device)
         for k, v in th.items()}
    K = cov(X, fid, X, fid, t, kernel)
    K.diagonal().add_(t["noises"][fid] + jitter)
    L = chol_tf32(K)
    del K
    N = L.shape[0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    Linv = torch.linalg.solve_triangular(
        L, torch.eye(N, dtype=F32, device=X.device), upper=False)
    del L
    R = tf32(Linv)
    del Linv
    Ki = R.T @ R
    del R
    alpha = (tf32(Ki) @ tf32(y)[:, None])[:, 0]
    value = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * N * LOG2PI
    r = _contract(Ki, alpha, X, fid, t, kernel, block)
    return dict(r, value=value, alpha=alpha)


def grad_vector(r: dict):
    """[g_logvar, g_logls (flat), g_lognoise] of ``nlml_grad``'s result,
    the program's parameter order."""
    return torch.cat([r["g_logvar"], r["g_logls"].reshape(-1),
                      r["g_lognoise"]])


def predict(L, alpha, X, fid, th: dict, kernel: str, Xs, fs,
            include_noise: bool = True, block: int = 1024):
    """Posterior mean and marginal variance at (Xs, fs) from a factor of
    ``factor``."""
    t = as_theta(th, X.device)
    F = t["variances"].shape[0]
    W = weights(t["rhos"], F)
    Xd, Xs = X.to(F64), Xs.to(F64)
    means, variances = [], []
    for i0 in range(0, Xs.shape[0], block):
        xb, fb = Xs[i0:i0 + block], fs[i0:i0 + block]
        Kxs = cov(xb, fb, Xd, fid, t, kernel)
        means.append(Kxs @ alpha)
        V = torch.linalg.solve_triangular(L, Kxs.T, upper=False)
        kss = torch.sum(W[:, fb] ** 2 * t["variances"][:, None], 0)
        var = kss - torch.sum(V * V, 0)
        if include_noise:
            var = var + t["noises"][fb]
        variances.append(var)
    return torch.cat(means), torch.cat(variances)


def rel_err(a, ref) -> float:
    """max |a - ref| / max |ref|, in float64."""
    a = torch.as_tensor(a).to(torch.float64).reshape(-1)
    ref = torch.as_tensor(ref).to(torch.float64).reshape(-1).to(a.device)
    return float(torch.max(torch.abs(a - ref)) / torch.max(torch.abs(ref)))
