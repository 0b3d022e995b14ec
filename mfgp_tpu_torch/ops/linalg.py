"""Dense linear algebra for GP posteriors (counterpart of
``mfgp_tpu/ops/linalg.py``, main-path subset).

Cholesky, triangular solves and plain matrix products go to
``torch.linalg`` / ``torch.matmul`` (cuSOLVER / cuBLAS on the card), as the
JAX package leaves them to XLA. What the port keeps is the structure: the
triangular inverse, the triangular products and the syrk skip the zero
half of their operands block by block, and the blocked solves bound the
temporaries of very wide right-hand sides. Block sizes are the JAX
package's, so both packages evaluate the same sums. On the card the
float32 triangular inverse runs its products on the port's 3xTF32
tensor-core engine instead (``tri_inv_recursive``).
"""

from __future__ import annotations

from collections import defaultdict

import torch

from mfgp_tpu_torch.utils import profiling


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
    """Solve ``L X = B`` for triangular L (B may be a vector). With one
    factor L (N, N) and lanes of right-hand sides B (..., N, K), the lanes'
    columns go side by side as one wide system, so L is never copied per
    lane."""
    if L.ndim == 2 and B.ndim > 2:
        lead, (N, K) = B.shape[:-2], B.shape[-2:]
        wide = torch.linalg.solve_triangular(
            L, B.movedim(-2, 0).reshape(N, -1), upper=not lower)
        return wide.reshape((N,) + lead + (K,)).movedim(0, -2)
    vec = B.ndim == 1
    X = torch.linalg.solve_triangular(L, B[:, None] if vec else B,
                                      upper=not lower)
    return X[:, 0] if vec else X


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = B`` given the lower Cholesky factor L."""
    return tri_solve(L.T, tri_solve(L, B), lower=False)


def solve_posterior(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``alpha = (K + noise)^-1 y`` from the Cholesky factor: L (..., N, N),
    y (..., N), leading axes being lanes, each its own system."""
    z = torch.linalg.solve_triangular(L, y[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]


def tri_inv_lanes(L: torch.Tensor) -> torch.Tensor:
    """Linv of each lane (..., N, N) from its lower Cholesky factor: one
    batched triangular solve on the identity (``tri_inv_recursive``'s base
    case). A NaN factor gives NaN."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


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
    per-level products skipping the zero half of their triangular operand
    (~N^3/6 multiplies) and triangular solves against the identity at
    ``n <= base``. The result is row-major contiguous whatever L's strides
    (cuSOLVER's factors are column-major), as the CUDA kernels that read it
    need.

    Where L is a float32 CUDA matrix that needs no gradient and ``n >
    base``, the products run on the 3xTF32 tensor-core engine
    (``_tri_inv_tc``, counted under ``linalg.tri_inv_tc``); everywhere else
    as float32 or float64 ``torch.matmul`` strips, the JAX package's order
    of evaluation. The recorder's span ``linalg.tri_inv`` covers the whole
    inverse (not its recursion)."""
    n = L.shape[0]
    with profiling.span("linalg.tri_inv", device=L.is_cuda):
        if (L.is_cuda and L.dtype == torch.float32 and not L.requires_grad
                and n > base):
            out = _tri_inv_tc(L, base)
            profiling.count("linalg.tri_inv_tc")
            return out
        return _tri_inv_strips(L, base)


def _tri_inv_strips(L: torch.Tensor, base: int) -> torch.Tensor:
    """``tri_inv_recursive`` with its products as ``torch.matmul``
    strips."""
    n = L.shape[0]
    if n <= base:
        return tri_solve(L, torch.eye(n, dtype=L.dtype,
                                      device=L.device)).contiguous()
    h = n // 2
    out = torch.zeros((n, n), dtype=L.dtype, device=L.device)
    Ai = _tri_inv_strips(L[:h, :h], base)
    out[:h, :h] = Ai
    Ci = _tri_inv_strips(L[h:, h:], base)
    out[h:, h:] = Ci
    BAi = tri_lower_matmul_right(L[h:, :h], Ai, block=base)
    del Ai
    out[h:, :h] = -tri_lower_matmul(Ci, BAi, block=base)
    return out


def _tri_inv_tc(L: torch.Tensor, base: int) -> torch.Tensor:
    """``tri_inv_recursive``'s recursion evaluated level by level from the
    bottom, into one row-major result: every base case of one size in one
    batched triangular solve, then per level and node size the two products
    of all its nodes in one launch each of the triangular tile product
    ``cuda_kernels.tri_gemm`` (``B Ai`` straight into the TF32 planes of its
    transpose, then ``-Ci (B Ai)`` into the nodes' strided blocks). On the
    CPU the products take ``tri_gemm``'s plain version."""
    from mfgp_tpu_torch.ops import cuda_kernels as _ck

    leaves, levels = defaultdict(list), []

    def walk(lo: int, n: int, depth: int) -> None:
        if n <= base:
            leaves[n].append(lo)
            return
        if len(levels) == depth:
            levels.append(defaultdict(list))
        levels[depth][n].append(lo)
        walk(lo, n // 2, depth + 1)
        walk(lo + n // 2, n - n // 2, depth + 1)

    N = L.shape[0]
    walk(0, N, 0)
    out = torch.empty((N, N), dtype=L.dtype, device=L.device)
    for n, los in leaves.items():
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        inv = tri_solve(torch.stack([L[lo:lo + n, lo:lo + n] for lo in los]),
                        eye.expand(len(los), n, n))
        for lo, x in zip(los, inv):
            out[lo:lo + n, lo:lo + n] = x
    for level in reversed(levels):
        for n, los in level.items():
            h = n // 2
            for lo in los:
                out[lo:lo + h, lo + h:lo + n].zero_()
            BAi_t = _ck.tri_gemm([L[lo + h:lo + n, lo:lo + h] for lo in los],
                                 [out[lo:lo + h, lo:lo + h].T for lo in los],
                                 "right")
            _ck.tri_gemm([out[lo + h:lo + n, lo + h:lo + n] for lo in los],
                         BAi_t, "left", alpha=-1.0,
                         out=[out[lo + h:lo + n, lo:lo + h] for lo in los])
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
    """Full predictive covariance ``Kss - V^T V`` with ``V = L^-1 Kxs^T``:
    Kss (..., M, M), Kxs (..., M, N), L (..., N, N), leading axes being
    lanes. A single system with a very wide right-hand side is solved
    blocked."""
    B = Kxs.mT
    if L.dim() == 2 and L.shape[0] * B.shape[1] > _BLOCK_SOLVE_ELEMS:
        V = tri_solve_blocked(L, B)
    else:
        V = torch.linalg.solve_triangular(L, B, upper=False)
    return Kss - V.mT @ V


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


def chol_rank1_update(L: torch.Tensor, x: torch.Tensor,
                      downdate: bool = False) -> torch.Tensor:
    """Rank-1 Cholesky update ``chol(L L^T +/- x x^T)`` by a hybrid
    Givens / hyperbolic-rotation sweep over the rows: O(n^2) work in n
    sequential steps (the JAX package scans them), no autograd."""
    n = L.shape[0]
    sign = -1.0 if downdate else 1.0
    L = L.detach().clone()
    x = x.detach().clone()
    for i in range(n):
        diag = L[i, i]
        xi = x[i]
        r = torch.sqrt(diag * diag + sign * xi * xi)
        c = r / diag
        s = xi / diag
        L[i:, i] = (L[i:, i] + sign * s * x[i:]) / c
        L[i, i] = r
        x[i + 1:] = c * x[i + 1:] - s * L[i + 1:, i]
    return L


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def weighted_mse(err: torch.Tensor, Sigma: torch.Tensor,
                 normalize: bool = True) -> torch.Tensor:
    """Precision-weighted MSE ``e^T (Sigma^-1 / |Sigma^-1|_F) e / n``
    (reference/GPTrainers.py:121-137): ``Sigma^-1 e`` is a Cholesky solve
    and ``|Sigma^-1|_F`` the Frobenius norm of ``A^T A`` with ``A = L^-1``.
    NaN where Sigma is not positive definite (``chol``'s NaN factor runs
    through), which the trainers' float64 repair relies on. err (..., n),
    Sigma (..., n, n) -> (...), leading axes being lanes; a single very
    large Sigma's inverse factor is solved blocked."""
    n = err.shape[-1]
    L = chol(Sigma)
    quad = torch.sum(err * solve_posterior(L, err), dim=-1)
    if normalize:
        eye = torch.eye(n, dtype=Sigma.dtype, device=Sigma.device)
        A = (tri_solve_blocked(L, eye)
             if L.dim() == 2 and n * n > _BLOCK_SOLVE_ELEMS
             else torch.linalg.solve_triangular(L, eye.expand_as(L),
                                                upper=False))
        quad = quad / torch.linalg.matrix_norm(A.mT @ A)
    return quad / n


def rmse(err: torch.Tensor) -> torch.Tensor:
    """Root mean squared error (reference/GPTrainers.py:141)."""
    return torch.sqrt(torch.mean(err ** 2))
