"""Plain reference of the AR1 NLML and its gradient at an N whose float64 K
fills one card: the equations of ``reference/gp.py`` (its covariance and
its trace identities), computed in float64 with K held once.

    K = cov(X, X) + diag(noise[fid] + jitter), assembled a block of rows
        at a time into one N x N buffer;
    K = L L^T, factored in place by right-looking blocks (each diagonal
        block by ``torch.linalg.cholesky``, each panel by a triangular
        solve, each trailing update a block column of the lower triangle
        at a time), so that L overwrites K's lower triangle;
    NLML = y^T a / 2 + sum(log diag L) + N log(2 pi) / 2, a = K^-1 y by
        two blocked triangular solves;
    K^-1 a block of columns [j0, j1) at a time: L Z = E (E the identity's
        columns, zero above row j0, so the sweep starts there), then
        L^T X = Z for rows j0.. only (K^-1's lower part of the block
        column), and W = K^-1 - a a^T contracted with dK/dtheta over those
        rows: the diagonal block once, the rows below it twice (W and
        dK/dtheta are symmetric).

At N=80,000 the buffer is 51.2 GB, the rest a few GB. Imports nothing of
the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import gp

F64 = torch.float64


def assemble(X, fid, th: dict, kernel: str, jitter: float,
             rows: int = 2048) -> torch.Tensor:
    """K = cov(X, X) + diag(noise[fid] + jitter) in float64, one buffer."""
    n = X.shape[0]
    K = torch.empty((n, n), dtype=F64, device=X.device)
    for i0 in range(0, n, rows):
        i1 = min(i0 + rows, n)
        K[i0:i1] = gp.cov(X[i0:i1], fid[i0:i1], X, fid, th, kernel)
    K.diagonal().add_(th["noises"][fid] + jitter)
    return K


def chol_inplace(A: torch.Tensor, block: int) -> torch.Tensor:
    """Overwrite the lower triangle of the SPD ``A`` with its Cholesky
    factor L (the strict upper triangle of the diagonal blocks is zeroed,
    the rest of the upper triangle left as it was); returns ``A``."""
    n = A.shape[0]
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        L11 = torch.linalg.cholesky(A[k0:k1, k0:k1])
        A[k0:k1, k0:k1] = L11
        if k1 == n:
            break
        L21 = torch.linalg.solve_triangular(L11.T, A[k1:, k0:k1],
                                            upper=True, left=False)
        A[k1:, k0:k1] = L21
        for j0 in range(k1, n, block):
            j1 = min(j0 + block, n)
            A[j0:, j0:j1].addmm_(L21[j0 - k1:], L21[j0 - k1:j1 - k1].T,
                                 alpha=-1.0)
    return A


def solve_lower(L, B, r0: int, block: int) -> torch.Tensor:
    """``B`` (rows r0.. of a right-hand side zero above row r0, r0 a
    multiple of ``block``) overwritten with rows r0.. of L^-1 B."""
    n = L.shape[0]
    for k0 in range(r0, n, block):
        k1 = min(k0 + block, n)
        b = B[k0 - r0:k1 - r0]
        b.copy_(torch.linalg.solve_triangular(L[k0:k1, k0:k1], b,
                                              upper=False))
        if k1 < n:
            B[k1 - r0:].addmm_(L[k1:, k0:k1], b, alpha=-1.0)
    return B


def solve_upper(L, Z, r0: int, block: int) -> torch.Tensor:
    """``Z`` (rows r0.. of a right-hand side) overwritten with rows r0.. of
    the solution of L^T X = Z restricted to rows r0.. (rows below r0 do
    not enter those rows of X)."""
    n = L.shape[0]
    starts = list(range(r0, n, block))
    for k0 in reversed(starts):
        k1 = min(k0 + block, n)
        rhs = Z[k0 - r0:k1 - r0]
        if k1 < n:
            rhs = rhs - L[k1:, k0:k1].T @ Z[k1 - r0:]
        Z[k0 - r0:k1 - r0] = torch.linalg.solve_triangular(
            L[k0:k1, k0:k1].T, rhs, upper=True)
    return Z


def nlml_grad(X, fid, y, th: dict, kernel: str = "rbf", jitter: float = 0.0,
              block: int = 2048, rows: int = 16384) -> dict:
    """``reference/gp.nlml_grad``'s value, gradient (g_logvar, g_logls,
    g_lognoise) and alpha, with K held once (module docstring); ``rows``
    bounds the contraction's row chunks."""
    X, y = X.to(F64), y.to(F64)
    t = gp.as_theta(th, X.device)
    n = X.shape[0]
    L = chol_inplace(assemble(X, fid, t, kernel, jitter), block)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    alpha = solve_upper(L, solve_lower(L, y[:, None].clone(), 0, block), 0,
                        block)[:, 0]
    value = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * n * gp.LOG2PI
    F, D = t["lengthscales"].shape
    Wf = gp.weights(t["rhos"], F)
    g_v = torch.zeros(F, dtype=F64, device=X.device)
    g_l = torch.zeros((F, D), dtype=F64, device=X.device)
    qdiag = torch.empty(n, dtype=F64, device=X.device)
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        E = torch.zeros((n - j0, j1 - j0), dtype=F64, device=X.device)
        E.diagonal().fill_(1.0)
        Kinv = solve_upper(L, solve_lower(L, E, j0, block), j0, block)
        qdiag[j0:j1] = torch.diagonal(Kinv) - alpha[j0:j1] ** 2
        for i0 in range(j0, n, rows):
            i1 = min(i0 + rows, n)
            Q = (Kinv[i0 - j0:i1 - j0]
                 - alpha[i0:i1, None] * alpha[None, j0:j1])
            # the diagonal block once, the rows below it for both triangles
            Q[max(j1, i0) - i0:] *= 2.0
            diffs = [X[i0:i1, None, d] - X[None, j0:j1, d] for d in range(D)]
            for m in range(F):
                ls = t["lengthscales"][m]
                sq = [(df / ls[d]) ** 2 for d, df in enumerate(diffs)]
                r2 = sum(sq)
                wq = (Wf[m][fid[i0:i1]][:, None] * Wf[m][fid[j0:j1]][None, :]
                      * t["variances"][m]) * Q
                if kernel == "rbf":
                    T = wq * torch.exp(-0.5 * r2)
                    g_v[m] += torch.sum(T)
                    for d in range(D):
                        g_l[m, d] += torch.sum(T * sq[d])
                else:
                    r = torch.sqrt(r2)
                    e3 = torch.exp(-gp.SQRT3 * r)
                    g_v[m] += torch.sum(wq * (1.0 + gp.SQRT3 * r) * e3)
                    E3 = 3.0 * wq * e3
                    for d in range(D):
                        g_l[m, d] += torch.sum(E3 * sq[d])
        del Kinv, E
    g_n = torch.zeros(F, dtype=F64, device=X.device)
    g_n.index_add_(0, fid, qdiag * t["noises"][fid])
    return dict(value=value, alpha=alpha, g_logvar=0.5 * g_v,
                g_logls=0.5 * g_l, g_lognoise=0.5 * g_n)
