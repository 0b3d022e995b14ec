"""Dense linear algebra for GP posteriors (counterpart of
``mfgp_tpu/ops/linalg.py``, main-path subset).

Cholesky, triangular solves and plain matrix products go to
``torch.linalg`` / ``torch.matmul`` (cuSOLVER / cuBLAS on the card), as the
JAX package leaves them to XLA. What the port keeps is the structure: the
triangular inverse, the triangular products and the syrk skip the zero
half of their operands block by block, and the blocked solves bound the
temporaries of very wide right-hand sides. Block sizes are the JAX
package's, so both packages evaluate the same sums.
"""

from __future__ import annotations

import torch


def diag_add(K: torch.Tensor, d) -> torch.Tensor:
    """``K + diag(d)`` without a dense (N, N) diagonal temporary."""
    out = K.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(d)
    return out


def chol(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, failing as the JAX package's ``chol`` does:
    a matrix that is not positive definite gives NaN in the lower triangle
    and zeros above it, with no exception and no host sync. The fit loops
    rely on that NaN: it becomes their non-finite penalty or a rejected
    line-search trial. Differentiable (autograd covers ``cholesky_ex``)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.nan).tril()


def tri_solve(L: torch.Tensor, B: torch.Tensor,
              lower: bool = True) -> torch.Tensor:
    """Solve ``L X = B`` for triangular L (B may be a vector)."""
    vec = B.ndim == 1
    X = torch.linalg.solve_triangular(L, B[:, None] if vec else B,
                                      upper=not lower)
    return X[:, 0] if vec else X


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = B`` given the lower Cholesky factor L."""
    return tri_solve(L.T, tri_solve(L, B), lower=False)


def solve_posterior(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``alpha = (K + noise)^-1 y`` from the Cholesky factor."""
    return chol_solve(L, y)


def tri_solve_blocked(L: torch.Tensor, B: torch.Tensor,
                      block: int = 2048) -> torch.Tensor:
    """Lower-triangular solve ``L X = B`` by block forward substitution:
    ``X_i = L_ii^-1 (B_i - sum_{j<i} L_ij X_j)``, peak temporaries
    O(block * M) instead of one monolithic solve's."""
    n = L.shape[0]
    if n <= block:
        return tri_solve(L, B)
    vec = B.ndim == 1
    Bm = B[:, None] if vec else B
    xs = []
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        rhs = Bm[lo:hi]
        for j, xj in enumerate(xs):
            rhs = rhs - L[lo:hi, j * block:(j + 1) * block] @ xj
        xs.append(tri_solve(L[lo:hi, lo:hi], rhs))
    X = torch.cat(xs, dim=0)
    return X[:, 0] if vec else X


def chol_solve_blocked(L: torch.Tensor, B: torch.Tensor,
                       block: int = 2048) -> torch.Tensor:
    """``(L L^T)^-1 B`` with both triangular sweeps block-substituted; the
    upper sweep runs as a lower solve on the index-reversed system."""
    y = tri_solve_blocked(L, B, block)
    Lrev = torch.flip(L.T, dims=(0, 1))
    xrev = tri_solve_blocked(Lrev, torch.flip(y, dims=(0,)), block)
    return torch.flip(xrev, dims=(0,))


def tri_lower_matmul(L: torch.Tensor, B: torch.Tensor,
                     block: int = 2048) -> torch.Tensor:
    """``L @ B`` for lower-triangular L: row block i only multiplies the
    first (i+1) column blocks (half the dense FLOPs)."""
    n = L.shape[0]
    if n <= block:
        return L @ B
    return torch.cat([L[lo:lo + block, :lo + block] @ B[:lo + block]
                      for lo in range(0, n, block)], dim=0)


def tri_lower_matmul_right(B: torch.Tensor, L: torch.Tensor,
                           block: int = 2048) -> torch.Tensor:
    """``B @ L`` for lower-triangular L: output column block j only
    consumes B's columns >= j (half the dense FLOPs)."""
    n = L.shape[0]
    if n <= block:
        return B @ L
    return torch.cat([B[:, lo:] @ L[lo:, lo:lo + block]
                      for lo in range(0, n, block)], dim=1)


def tri_inv_recursive(L: torch.Tensor, base: int = 1024) -> torch.Tensor:
    """Lower-triangular inverse by divide and conquer,
    ``inv([[A, 0], [B, C]]) = [[Ai, 0], [-Ci B Ai, Ci]]``, with both
    per-level products taken as triangular strips (~N^3/6 multiplies).
    The result is row-major contiguous whatever L's strides (cuSOLVER's
    factors are column-major), as the CUDA kernels that read it need."""
    n = L.shape[0]
    if n <= base:
        return tri_solve(L, torch.eye(n, dtype=L.dtype,
                                      device=L.device)).contiguous()
    h = n // 2
    out = torch.zeros((n, n), dtype=L.dtype, device=L.device)
    Ai = tri_inv_recursive(L[:h, :h], base)
    out[:h, :h] = Ai
    Ci = tri_inv_recursive(L[h:, h:], base)
    out[h:, h:] = Ci
    BAi = tri_lower_matmul_right(L[h:, :h], Ai, block=base)
    del Ai
    out[h:, :h] = -tri_lower_matmul(Ci, BAi, block=base)
    return out


def syrk_tri_lower(A: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """``A^T A`` for lower-triangular A: output block (i, j), i >= j, sums
    only row blocks k >= i; the strict upper triangle is mirrored."""
    n = A.shape[0]
    if n <= block:
        return A.T @ A
    out = torch.empty_like(A)
    for ilo in range(0, n, block):
        ihi = min(n, ilo + block)
        for jlo in range(0, ilo + 1, block):
            jhi = min(n, jlo + block)
            b = A[ilo:, ilo:ihi].T @ A[ilo:, jlo:jhi]
            out[ilo:ihi, jlo:jhi] = b
            if ilo != jlo:
                out[jlo:jhi, ilo:ihi] = b.T
    return out


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """``log |K| = 2 sum log diag(L)``."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


def posterior_mean(Kxs: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``mu = K(X*, X) alpha``."""
    return Kxs @ alpha


_BLOCK_SOLVE_ELEMS = 1 << 26  # above this many RHS elements, solve blocked


def posterior_cov(Kss: torch.Tensor, Kxs: torch.Tensor,
                  L: torch.Tensor) -> torch.Tensor:
    """Full predictive covariance ``Kss - V^T V`` with ``V = L^-1 Kxs^T``."""
    B = Kxs.T
    if L.shape[0] * B.shape[1] > _BLOCK_SOLVE_ELEMS:
        V = tri_solve_blocked(L, B)
    else:
        V = tri_solve(L, B)
    return Kss - V.T @ V


def posterior_var(kss_diag: torch.Tensor, Kxs: torch.Tensor,
                  L: torch.Tensor) -> torch.Tensor:
    """Marginal predictive variances without the full covariance."""
    V = tri_solve(L, Kxs.T)
    return kss_diag - torch.sum(V * V, dim=0)


def chol_append_block(L: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor) -> torch.Tensor:
    """Extend a Cholesky factor by a block of rows: given ``L = chol(A)``
    (n x n) and the bordered matrix ``[[A, B], [B^T, C]]`` with B (n x p),
    C (p x p), the (n+p) x (n+p) lower factor in O(n^2 p + p^3)."""
    n, p = L.shape[0], C.shape[0]
    Lb = tri_solve(L, B)
    out = L.new_zeros((n + p, n + p))
    out[:n, :n] = L
    out[n:, :n] = Lb.T
    out[n:, n:] = chol(C - Lb.T @ Lb)
    return out
