"""mp-distributed blocked Cholesky factorization (counterpart of
``mfgp_tpu/parallel/chol.py``).

Every O(N^2) object of the fully sharded training step lives in column
blocks over the mesh's mp ranks. Rank c owns a set of global columns; the
right-looking algorithm walks panels of width ``block``:

  1. the panel's owner factorizes its (b x b) diagonal block and solves
     the sub-diagonal rows (local work),
  2. the finished panel is broadcast from its owner (the JAX package sums
     zeros from every other rank into it: the same values),
  3. every rank applies the trailing update to its own columns with one
     product.

Per-rank memory is O(N^2 / n_mp); the panel broadcasts carry the lower
triangle once in all. Column layouts: ``"block"`` gives rank c the
contiguous columns [c*Nc, (c+1)*Nc); ``"cyclic"`` (block-cyclic) gives it
the panels p with p % n_mp == c, so every rank keeps trailing work until
the last n_mp panels (``panel_utilization`` measures the balance).

Per panel: ``ops.linalg.chol`` and ``torch.linalg.solve_triangular``; the
trailing update is a plain ``torch.matmul`` (the JAX package computes it
outside any Pallas kernel). On the card each rank assembles its
covariance columns with B1 (``ops/cuda_kernels``).

``block=None``, the default, takes the panel width from the shard
(``panel_width``): the largest divisor of n / n_mp that is at most 256, so
that an n such as 80,000 over 4 ranks (20,000 columns each, panels of 250)
runs without a width chosen by hand. The fully sharded NLML's stages are
the recorder's spans (``utils/profiling``): ``par.nlml`` around an
evaluation, ``par.gram``, ``par.chol``, ``par.trisolve`` and ``par.grad``
inside it, and ``par.comm`` (``parallel/mesh``) inside those; the counter
``par.sweep_macs`` adds up the multiply-adds its identity sweeps issue.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from mfgp_tpu_torch.models import mfgp as _mf
from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.parallel.mesh import (MP_AXIS, all_gather, axis_size,
                                          broadcast, psum)
from mfgp_tpu_torch.parallel.sharded import _eye_cols, _sharded_grad
from mfgp_tpu_torch.utils import profiling
from mfgp_tpu_torch.utils.device import CUDA, as_tensor_on

_LOG2PI = math.log(2.0 * math.pi)
# the default panel width: the widest divisor of the shard's column count
# up to PANEL_MAX; under PANEL_MIN the sweeps are launch-bound
PANEL_MAX, PANEL_MIN = 256, 32


def _owner_and_slot(k, nc, block, n_mp, layout):
    """(owner rank, local column offset) of the panel starting at global
    column k."""
    if layout == "block":
        return k // nc, k % nc
    p = k // block  # global panel index
    return p % n_mp, (p // n_mp) * block


def _local_to_global_cols(idx, nc, block, n_mp, layout) -> np.ndarray:
    """Global column indices of rank ``idx``'s nc local columns, in
    increasing order (either layout)."""
    j = np.arange(nc)
    if layout == "block":
        return idx * nc + j
    return ((j // block) * n_mp + idx) * block + (j % block)


def cyclic_permutation(n: int, n_mp: int, block: int) -> np.ndarray:
    """Global-column permutation gathering each rank's cyclic panels into a
    contiguous shard: perm[c*nc + j] = global column of rank c's local j."""
    cols = []
    npan = n // block
    for c in range(n_mp):
        for p in range(c, npan, n_mp):
            cols.extend(range(p * block, (p + 1) * block))
    return np.asarray(cols, np.int32)


def panel_utilization(n: int, n_mp: int, block: int, layout: str) -> float:
    """Mean trailing-update load balance over the panel sweep.

    For each panel step, each rank updates its local columns with global
    index past the panel; utilization = mean_k (mean_c active_c / max_c
    active_c) over steps with any trailing work. 1.0 = perfectly balanced.
    """
    nc = n // n_mp
    ratios = []
    for k in range(0, n, block):
        active = []
        for c in range(n_mp):
            if layout == "block":
                cols = np.arange(c * nc, (c + 1) * nc)
            else:
                j = np.arange(nc)
                cols = ((j // block) * n_mp + c) * block + (j % block)
            active.append(int(np.sum(cols >= k + block)))
        if max(active):
            ratios.append(np.mean(active) / max(active))
    return float(np.mean(ratios))


def _widest_panel(nc: int) -> int:
    return max(d for d in range(1, min(nc, PANEL_MAX) + 1) if nc % d == 0)


def panel_width(n: int, n_mp: int, block: int | None = None) -> int:
    """The panel width of an n-column factor split over n_mp ranks:
    ``block`` where given (it must divide n / n_mp), else the largest
    divisor of n / n_mp that is at most 256 (250 at n = 80,000, 20,000 or
    1,000 over 4 ranks). Raises where n_mp does not divide n, and, for the
    default, where that divisor is under 32, naming the nearest n that
    works."""
    if n % n_mp:
        raise ValueError(f"n={n} not divisible by mp={n_mp}")
    nc = n // n_mp
    if block is not None:
        if nc % block:
            raise ValueError(
                f"column block {nc} not divisible by panel {block}")
        return block
    width = _widest_panel(nc)
    if width < PANEL_MIN:
        near = next(m for d in itertools.count() for m in (n - d, n + d)
                    if m >= PANEL_MIN * n_mp and m % n_mp == 0
                    and _widest_panel(m // n_mp) >= PANEL_MIN)
        raise ValueError(
            f"n={n} over mp={n_mp}: the widest panel dividing the {nc}-column "
            f"block is {width}, under {PANEL_MIN}; the nearest n that works "
            f"is {near}")
    return width


def _check_layout(mesh, n, block, layout):
    """(n_mp, columns per rank, panel width) of an n-column layout."""
    if layout not in ("block", "cyclic"):
        raise ValueError(layout)
    n_mp = axis_size(mesh, MP_AXIS)
    block = panel_width(n, n_mp, block)
    return n_mp, n // n_mp, block


def _my_cols(mesh, n, block, layout) -> np.ndarray:
    n_mp = axis_size(mesh, MP_AXIS)
    return _local_to_global_cols(mesh.get_local_rank(MP_AXIS), n // n_mp,
                                 block, n_mp, layout)


def _chol_cols_body(mesh, A, n, block, layout="block"):
    """Right-looking Cholesky sweep of this rank's columns ``A`` (n, nc) of
    an SPD matrix, in place (see the module docstring); returns them as
    columns of L, the strict upper triangle zeroed. Panel k's rows below
    k are zero in L, so its broadcast carries rows k.. only."""
    n_mp = axis_size(mesh, MP_AXIS)
    nc = A.shape[1]
    idx = mesh.get_local_rank(MP_AXIS)
    my = _local_to_global_cols(idx, nc, block, n_mp, layout)
    my_t = torch.as_tensor(my, device=A.device)
    for k in range(0, n, block):
        owner, s = _owner_and_slot(k, nc, block, n_mp, layout)
        if idx == owner:
            Lkk = _la.chol(A[k:k + block, s:s + block])
            A[k:k + block, s:s + block] = Lkk
            A[k + block:, s:s + block] = torch.linalg.solve_triangular(
                Lkk, A[k + block:, s:s + block].T, upper=False).T
            panel = A[k:, s:s + block]
        else:
            panel = A.new_empty((n - k, block))
        panel = broadcast(mesh, panel, owner)
        j0 = int(np.searchsorted(my, k + block))
        if j0 < nc:
            pj = panel[my_t[j0:] - k]
            A[k + block:, j0:] -= panel[block:] @ pj.T
    return A.masked_fill_(torch.arange(n, device=A.device)[:, None]
                          < my_t[None, :], 0.0)


def _broadcast_panel(mesh, L_cols, k, n, block, layout="block"):
    """Rows k.. of L's column panel [k, k+block), from its owner rank."""
    n_mp = axis_size(mesh, MP_AXIS)
    nc = L_cols.shape[1]
    owner, s = _owner_and_slot(k, nc, block, n_mp, layout)
    panel = (L_cols[k:, s:s + block]
             if mesh.get_local_rank(MP_AXIS) == owner
             else L_cols.new_empty((n - k, block)))
    return broadcast(mesh, panel, owner)


def _tri_solve_lower_body(mesh, L_cols, B_cols, n, block, layout="block"):
    """Forward substitution ``L X = B`` with L column-sharded (block or
    block-cyclic layout) and the right-hand side column-sharded (each rank
    holds full rows of its own columns, whatever L's layout). Per row
    block: one panel broadcast from its owner, then each rank solves its
    own columns. X comes back column-sharded like B."""
    X = B_cols.clone()
    for k in range(0, n, block):
        panel = _broadcast_panel(mesh, L_cols, k, n, block, layout)
        X[k:k + block] = torch.linalg.solve_triangular(
            panel[:block], X[k:k + block], upper=False)
        X[k + block:] -= panel[block:] @ X[k:k + block]
    return X


def _tri_solve_upper_body(mesh, L_cols, Y_cols, n, block, layout="block"):
    """Backward substitution ``L^T X = Y`` with column-sharded operands;
    row block k needs ``sum_{j>k} L[j, k]^T X_j``, which lives in panel
    k."""
    X = Y_cols.clone()
    for k in range(n - block, -1, -block):
        panel = _broadcast_panel(mesh, L_cols, k, n, block, layout)
        rhs = X[k:k + block] - panel[block:].T @ X[k + block:]
        X[k:k + block] = torch.linalg.solve_triangular(
            panel[:block].T, rhs, upper=True)
    return X


def _kinv_block_lower_cols(mesh, L_cols, n, block, layout="block"):
    """This rank's identity columns of K^-1 = L^-T L^-1, block-lower only:
    the columns S of its block-cyclic panels (whatever L's layout, so that
    every rank carries about the same work), each exact in the rows of its
    own panel and below and zero above. Returns (S, a tensor on L's
    device, and the (n, len(S)) columns).

    Both sweeps touch only the live prefix of S, in place: at panel step k
    the columns below k + block. In the lower sweep (L X = I) the others
    are zero in rows up to k + block, so their update would subtract
    zeros; the upper sweep (L^T Z = X) stops each column at the top of its
    own panel, whose rows above keep the lower sweep's zeros. Every rank
    still takes part in every panel's broadcast. Each step's multiply-adds
    add to the recorder's counter ``par.sweep_macs``."""
    n_mp = axis_size(mesh, MP_AXIS)
    nc = L_cols.shape[1]
    S = _local_to_global_cols(mesh.get_local_rank(MP_AXIS), nc, block, n_mp,
                              "cyclic")
    S_t = torch.as_tensor(S, device=L_cols.device)
    X = _eye_cols(n, S_t, L_cols)
    for k in range(0, n, block):
        panel = _broadcast_panel(mesh, L_cols, k, n, block, layout)
        a = int(np.searchsorted(S, k + block))
        if a:
            X[k:k + block, :a] = torch.linalg.solve_triangular(
                panel[:block], X[k:k + block, :a], upper=False)
            X[k + block:, :a].addmm_(panel[block:], X[k:k + block, :a],
                                     alpha=-1)
            profiling.count("par.sweep_macs", (n - k - block) * block * a)
    for k in range(n - block, -1, -block):
        panel = _broadcast_panel(mesh, L_cols, k, n, block, layout)
        a = int(np.searchsorted(S, k + block))
        if a:
            rhs = X[k:k + block, :a].addmm_(panel[block:].T,
                                            X[k + block:, :a], alpha=-1)
            X[k:k + block, :a] = torch.linalg.solve_triangular(
                panel[:block].T, rhs, upper=True)
            profiling.count("par.sweep_macs", (n - k - block) * block * a)
    return S_t, X


def _block_lower_matvec(B, S, y, block):
    """This rank's share of K^-1 y from its block-lower columns ``B`` at the
    global columns ``S`` (``_kinv_block_lower_cols``): B y[S] for the
    entries in and below each column's panel, and, for their mirror images
    above the diagonal, B's entries below each column's panel transposed
    onto the rows S."""
    rows = S.view(-1, block)  # the rows of each local panel's diagonal block
    local = torch.arange(S.shape[0], device=B.device).view(-1, block)
    diag = B[rows[:, :, None], local[:, None, :]]
    v = B @ y[S]
    v[S] += B.T @ y - torch.einsum("qst,qs->qt", diag, y[rows]).reshape(-1)
    return v


def make_sharded_cholesky(mesh, n: int, block: int | None = None,
                          layout: str = "block"):
    """Build ``f(K) -> L`` for (n, n) SPD inputs, factorized in column
    blocks over mp; ``L`` comes back whole on every rank (each rank's
    columns gathered). ``n`` must divide by ``n_mp * block`` (``block``
    by default ``panel_width``'s).

    ``layout="cyclic"`` uses the block-cyclic column assignment (panel p ->
    rank p % n_mp); the caller-facing contract is the same."""
    n_mp, nc, block = _check_layout(mesh, n, block, layout)
    inv = np.argsort(cyclic_permutation(n, n_mp, block))

    def f(K: torch.Tensor) -> torch.Tensor:
        my = torch.as_tensor(_my_cols(mesh, n, block, layout),
                             device=K.device)
        L = all_gather(mesh, _chol_cols_body(mesh, K[:, my].contiguous(), n,
                                             block, layout), axis=1)
        return L if layout == "block" else L[:, torch.as_tensor(
            inv, device=K.device)]

    return f


def make_sharded_tri_solves(mesh, n: int, ncols: int,
                            block: int | None = None):
    """Build ``(lower_fn, upper_fn)``, ``f(L, B) -> X`` with ``L X = B``
    and ``L^T X = B``: L and the right-hand side are split in column blocks
    over mp; each sweep step is one (n - k, block) panel broadcast, a local
    block solve and a local elimination (``block`` by default
    ``panel_width``'s). ``ncols`` is the global number of right-hand-side
    columns (divisible by the mp extent). X comes back whole on every
    rank."""
    n_mp = axis_size(mesh, MP_AXIS)
    if block is None:
        block = panel_width(n, n_mp)
    elif n % n_mp or (n // n_mp) % block:
        raise ValueError(f"n={n} incompatible with mp={n_mp}, block={block}")
    if ncols % n_mp:
        raise ValueError(f"ncols={ncols} not divisible by mp={n_mp}")
    nc, rc = n // n_mp, ncols // n_mp

    def run(body):
        def f(L, B):
            i = mesh.get_local_rank(MP_AXIS)
            X = body(mesh, L[:, i * nc:(i + 1) * nc].contiguous(),
                     B[:, i * rc:(i + 1) * rc], n, block)
            return all_gather(mesh, X, axis=1)

        return f

    return run(_tri_solve_lower_body), run(_tri_solve_upper_body)


def make_fully_sharded_nlml_value_and_grad(mesh, n: int,
                                           block: int | None = None,
                                           jitter: float = 0.0,
                                           layout: str = "block"):
    """Memory-scaled MFGP NLML value and gradient (rbf, rhos fixed).

    Every O(N^2) object (the covariance columns, the Cholesky factor and
    the explicit inverse) lives in column blocks over mp; the only
    replicated tensors are the O(N) data and the O(1) parameters:

      1. each rank assembles ITS columns of K_n (B1 on the card, F
         fidelities in one launch) plus the noise on its diagonal entries,
      2. distributed Cholesky (``_chol_cols_body``),
      3. two distributed triangular sweeps give K_n^-1's block-lower part
         at this rank's block-cyclic identity columns, whatever the layout
         (``_kinv_block_lower_cols``); ``alpha`` is their psum'd product
         with y, each entry below the diagonal panels used twice
         (``_block_lower_matvec``), and ``logdet = psum(local
         log-diagonals)``,
      4. the trace-identity contractions over the block-lower part, each
         entry below the diagonal panels weighted twice, psum'd
         (``sharded._sharded_grad``).

    Per-rank memory: a few N^2/n_mp + O(N). ``layout="cyclic"`` gives each
    rank its block-cyclic columns, assembled directly (no permutation);
    value and gradient do not depend on the layout. ``block`` is by default
    ``panel_width``'s. Returns ``f(params, X, fid, y)``; each call is the
    recorder's span ``par.nlml`` (module docstring)."""
    n_mp, nc, block = _check_layout(mesh, n, block, layout)

    def f(params: _mf.MFGPParams, X, fid, y):
        dev = X.is_cuda
        with profiling.span("par.nlml", device=dev):
            cols = torch.as_tensor(_my_cols(mesh, n, block, layout),
                                   device=X.device)
            diag = (cols, torch.arange(nc, device=X.device))
            with profiling.span("par.gram", device=dev):
                Xc, fc = X[cols], fid[cols]
                K_cols = _cov.mf_cross_cov(
                    params.variances, params.lengthscales, params.rhos, X,
                    fid, Xc, fc, "rbf")
                K_cols[diag] += _k.mf_noise_diag(fc, params.noises) + jitter
            with profiling.span("par.chol", device=dev):
                L_cols = _chol_cols_body(mesh, K_cols, n, block, layout)
            with profiling.span("par.trisolve", device=dev):
                S, Kinv_cols = _kinv_block_lower_cols(mesh, L_cols, n,
                                                      block, layout)
            logdet = 2.0 * psum(mesh, torch.sum(torch.log(L_cols[diag])))
            del L_cols
            alpha = psum(mesh, _block_lower_matvec(Kinv_cols, S, y, block))
            val = (0.5 * torch.dot(y, alpha) + 0.5 * logdet
                   + 0.5 * n * _LOG2PI)
            with profiling.span("par.grad", device=dev):
                grad = _sharded_grad(mesh, Kinv_cols, alpha, X, fid, S,
                                     params, block_lower=block)
        return val, grad

    return f


def fit_memory_scaled(mesh, X, fid, y, *, steps: int = 100,
                      learning_rate: float = 0.05, block: int | None = None,
                      jitter: float = 1e-6, params0=None, device=CUDA):
    """Adam fit of one MFGP whose every gradient is fully sharded over mp
    (``make_fully_sharded_nlml_value_and_grad``, ``block`` by default
    ``panel_width``'s), in float32 as the JAX package's. For N beyond one
    device's memory: on a node of GPUs every rank calls ``init_ranks()``,
    ``make_mesh(mp=<ranks>)`` and then this. Returns (params,
    loss_history)."""
    from mfgp_tpu_torch.parallel.train import adam_init, adam_update

    X = as_tensor_on(X, device).to(torch.float32)
    fid = as_tensor_on(fid, X.device).long()
    y = as_tensor_on(y, X.device).to(torch.float32)
    N, D = X.shape
    F = int(fid.max()) + 1
    params = params0 or _mf.MFGPParams.default(F, D, torch.float32,
                                               device=X.device)
    vg = make_fully_sharded_nlml_value_and_grad(mesh, N, block=block,
                                                jitter=jitter)
    opt_state = adam_init(params)
    history = []
    for _ in range(steps):
        val, grad = vg(params, X, fid, y)
        grad = _mf.MFGPParams(*(torch.nan_to_num(g) for g in grad))
        params, opt_state = adam_update(grad, opt_state, params,
                                        learning_rate)
        history.append(float(val))
    return params, history
