"""The RIG planner as one device loop (counterpart of
``mfgp_tpu/planning/rig_device.py``).

The host planner (``planning/rig.py``) keeps the graph bookkeeping in
Python and batches only the scoring onto the device. Here the whole
planning loop (sampling, expansion-ring nearest, steering, node merging,
candidate-edge synthesis (``primitives_device``), feasibility filtering,
the path-set dynamic program, scoring and best-path tracking) runs over
padded device buffers, with no host synchronisation inside the loop, and
the host reads the result once per plan.

Every tensor of the loop state carries a leading lane axis L: a solo plan
is L = 1, and ``plan_ensemble`` / ``plan_batch`` are L = K lanes of the
same code (what ``jax.vmap`` makes of the JAX package's loop). Lanes never
mix. The per-iteration offsets into the edge store and the path arena are
device tensors, so one iteration can be captured as a CUDA graph and
replayed ``max_iter`` times (``graph=True``); the eager loop issues the
same kernels.

Score-everything semantics (all cost modes), as in the JAX package:

* ``ergodic``: each edge's unnormalized time-integral of the
  Gaussian-sensor density over the grid is computed once; a path's
  statistics are the running sum. Flooring/normalization match
  metrics.ergodic exactly.
* ``fourier``: each edge's unnormalized cosine-coefficient sums are
  additive the same way; the score is the negative Sobolev distance to the
  EID's coefficients.
* ``sf_gain`` / ``mf_gain``: each beam slot carries ``chol(C_path |
  train)``; extending a path by one S-point edge borders that factor by S
  rows (one triangular solve + an S x S Cholesky), and the path's gain
  grows by exactly the new points' sequential terms.
* ``sf_logdet`` / ``mf_logdet``: each beam slot also carries the grid's
  latent posterior covariance given train + path; conditioning on an
  edge's S points is a rank-S downdate through the same bordered pipeline.

Every covariance block of the gain and log-det costs goes through the
``ops/covariance`` dispatch: on the card in float32 one launch of B1's
lane axis per block and extension phase (the edges, the beam's paths, or
every (path, edge) pair as lanes), the grid blocks through B1's
single-lane wrapper; elsewhere their plain compositions.

Capacity-bounded analogues of the host's unbounded structures: a beam of
``max_paths`` paths per node in an append-only arena, ``near_neighbors``
near-phase extensions per iteration.

What differs from the JAX package: the random numbers. They are drawn
before the loop into one draws tensor per plan (``DeviceRIG.draws``, from
a ``torch.Generator`` seeded per plan); ``plan(draws=...)`` takes a
caller's draws instead, which is how the tests give the port the JAX
package's own ``jax.random`` draws and hold its plans to JAX's. Not
ported: ``MFGP_TPU_PLAN_GATHER`` and ``plan(gather=)`` (the TPU's choice
between two index lowerings; the port has one, gathers and scatters with
an index tensor and a validity mask).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mfgp_tpu_torch.metrics.ergodic import gaussian_sensor
from mfgp_tpu_torch.metrics.fourier import (basis_norms, config_k,
                                            fourier_basis, sobolev_weights)
from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.planning.primitives import AgentConfig
from mfgp_tpu_torch.planning.primitives_device import (
    evaluate_trajectory_device, generate_trajectory_device)
from mfgp_tpu_torch.utils import profiling
from mfgp_tpu_torch.utils.device import CUDA, resolve

SENTINEL = -10000.0
NEG = -1e30
PIN = 1e20  # beam-rank pin for the root trivial path

GAIN_COSTS = ("sf_gain", "mf_gain")  # additive sequential-entropy carries
LOGDET_COSTS = ("sf_logdet", "mf_logdet")  # carried grid-posterior cov
STAT_COSTS = ("ergodic", "fourier")  # additive-statistics modes


def _top(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, the lower index first
    among equal values (``jax.lax.top_k``'s order)."""
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]


def _lex_top(tier: torch.Tensor, key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the top-k entries of each row by (tier, key) descending,
    lexicographically exact, the lower index first among ties."""
    order = torch.sort(key, dim=-1, descending=True, stable=True)[1]
    t = torch.gather(tier, -1, order)
    return torch.gather(order, -1, torch.sort(t, dim=-1, descending=True,
                                              stable=True)[1])[..., :k]


def _interp(x, xp, fps):
    """``jnp.interp`` row by row for each of ``fps``: x (B, S), xp (B, n)
    non-decreasing, each fp (B, n). JAX's formula, also for repeated
    abscissae (the padding rows): the right neighbour by
    ``searchsorted(side='right')``, and an interval no longer than
    ``spacing(eps)`` takes its left value."""
    n = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(),
                           right=True).clamp(1, n - 1)
    xl, xr = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    dx = xr - xl
    dx0 = torch.abs(dx) <= float(np.spacing(torch.finfo(xp.dtype).eps))
    w = (x - xl) / torch.where(dx0, 1.0, dx)
    lo, hi = x < xp[..., :1], x > xp[..., -1:]
    out = []
    for fp in fps:
        fl, fr = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
        f = torch.where(dx0, fl, fl + w * (fr - fl))
        f = torch.where(lo, fp[..., :1], f)
        out.append(torch.where(hi, fp[..., -1:], f))
    return out


def _bcast(t: torch.Tensor, dims: int) -> torch.Tensor:
    return t.reshape(t.shape + (1,) * dims)


@dataclass
class DevicePlanResult:
    info: float
    budget: float
    time: float
    points: np.ndarray  # (P, 4) x, y, z, t waypoints of the best path
    n_nodes: int
    node_states: np.ndarray  # (n_nodes, 2)
    # best-path edge chain: (padded prims (L, 4), src_xy, dst_xy) per edge,
    # enough to rebuild the runtime flight plan (hw.runtime.flight_plan)
    edges: list = None
    # kept for the JAX package's interface: over-cap extensions are
    # infeasible, so a score is never computed on a truncated point set
    truncated: bool = False
    # feasible candidate edges admitted to the graph (counted in the loop)
    n_feasible_edges: int = 0
    # chronological admitted-extension trace, (K, 6): iteration, x_src,
    # y_src, x_dst, y_dst, edge_id
    trace: np.ndarray = None
    # the best path's arena chain, root first (arena indices)
    chain: list = None


class DeviceRIG:
    """The RIG planner as one device loop. See the module docstring.

    >>> planner = DeviceRIG(cfg, delta=2.0, B=20.0, WS=ws, R=3.0, Rd=2.0,
    ...                     eid=eid, grid=grid, max_iter=40)
    >>> result = planner.plan(np.array([1.0, 1.0]), seed=0)

    ``device`` is the card unless the caller asks for the CPU; ``dtype``
    defaults to float32 on the card and float64 on the CPU. ``graph``
    (card only) runs iteration 0 eagerly, captures one iteration as a CUDA
    graph and replays it for the rest.
    """

    MAX_GRAPHS = 4  # captured iterations kept, one per shape

    def __init__(self, cfg: AgentConfig, *, delta: float, B: float, WS,
                 R: float, Rd: float = 0.0, same_node_distance: float = 0.0,
                 budget_cutoff: float = 0.9, max_iter: int = 40,
                 eid=None, grid=None, sigma_diag=None,
                 max_nodes: int = 64, max_paths: int = 8,
                 samples_per_edge: int = 24, near_neighbors: int = 1,
                 cost: str = "ergodic", max_path_points: int = 192,
                 kernel: str = "rbf", dtype: torch.dtype | None = None,
                 fourier_bounds=None, n_coefs: int = 5, device=CUDA,
                 graph: bool = True):
        self.cfg = cfg
        self.delta = float(delta)
        self.B = float(B)
        self.WS = np.asarray(WS, float).reshape(2, 2)
        self.R = float(R)
        self.Rd = float(Rd)
        self.snd = float(same_node_distance)
        self.budget_cutoff = float(budget_cutoff)
        self.max_iter = int(max_iter)
        self.max_nodes = int(max_nodes)
        self.max_paths = int(max_paths)
        self.S = int(samples_per_edge)
        self.K = int(near_neighbors)  # near-phase extensions per iteration
        if cost not in STAT_COSTS + GAIN_COSTS + LOGDET_COSTS:
            raise ValueError(cost)
        if kernel not in _k.KERNELS:
            raise ValueError(kernel)
        self.kernel = kernel
        self.cost = cost
        self.P = int(max_path_points)  # per-path point capacity (gain mode)
        if self.P < self.S:
            raise ValueError("max_path_points must be >= samples_per_edge")
        self.device = resolve(device)
        # the covariance tiles' precision (B1 on the card in float32); the
        # model costs' posterior algebra (the carried factors and grid
        # covariances, the log-determinants) runs in float64 whatever it
        # is: in float32 its cancellations lose the score (mf_logdet at
        # N=705 on the CPU: no finite score, the factors fail)
        self.cov_dtype = dtype or (torch.float32 if self.device.type == "cuda"
                                   else torch.float64)
        self.dtype = (self.cov_dtype if cost in STAT_COSTS
                      else torch.float64)
        self.graph = bool(graph) and self.device.type == "cuda"
        f = dict(dtype=self.dtype, device=self.device)
        if grid is None:
            if cost in STAT_COSTS + LOGDET_COSTS:
                raise ValueError(f"{cost} scoring needs a grid"
                                 + (" (+ eid)" if cost in STAT_COSTS
                                    else ""))
            grid = np.zeros((1, 3))
        grid = np.asarray(grid, float)
        self.grid = torch.as_tensor(grid, **f).contiguous()
        if sigma_diag is None:
            sigma_diag = 0.25 * np.ones(grid.shape[1])
        self.sigma_diag = torch.as_tensor(np.asarray(sigma_diag, float), **f)
        self._eid = (None if eid is None else torch.as_tensor(
            np.asarray(eid, float).reshape(-1), **f))
        if cost == "fourier":
            # cosine-basis tables (host FourierErgodicCost semantics); the
            # target coefficients come from each plan's EID
            if fourier_bounds is None:
                fourier_bounds = np.concatenate(
                    [self.WS, [[0.0, float(cfg.max_depth)]]], axis=0)
            fb = np.asarray(fourier_bounds, float).reshape(-1, 2)
            d = fb.shape[0]
            self._f_lo = torch.as_tensor(fb[:, 0], **f)
            self._f_ilen = torch.as_tensor(1.0 / (fb[:, 1] - fb[:, 0]), **f)
            k = config_k(*[(int(n_coefs), 1.0)] * d)
            self._f_k = torch.as_tensor(k, **f)
            self._f_hk = basis_norms(self._f_k)
            self._f_lam = sobolev_weights(self._f_k)
            gu = (self.grid[:, :d] - self._f_lo) * self._f_ilen
            self._f_grid_basis = fourier_basis(gu, self._f_k)  # (M, G)
        S = self.S
        self._lo = torch.as_tensor(self.WS[:, 0], **f)
        self._hi = torch.as_tensor(self.WS[:, 1], **f)
        # jnp.linspace(0, t, S): t * (i / (S - 1)), the last sample t itself
        self._lin = (torch.arange(S - 1, dtype=self.dtype)
                     / float(S - 1)).to(self.device)
        self._strict_upper_S = torch.triu(torch.ones(
            (S, S), dtype=torch.bool, device=self.device), diagonal=1)
        self.stats: dict = {}  # the last plan's iterations, replays, B1
        # captured iterations by shapes (lane counts, grid, state), oldest
        # first: a plan_batch service's padded widths 1, 2, 4 and 8 each
        # keep theirs instead of recapturing whenever the width changes
        self._graphs: dict = {}

    # -- draws ---------------------------------------------------------------
    @property
    def draw_width(self) -> int:
        """Numbers one iteration reads: the sample's two uniforms, then per
        phase (1 + near_neighbors) the edges' leg choices (E x num_legs),
        their (E x num_legs x 3) uniforms and their E surfacing uniforms."""
        E, nl = self.cfg.traj_count, self.cfg.num_legs
        return 2 + (1 + self.K) * (4 * E * nl + E)

    def draws(self, generator: torch.Generator, lanes: int = 1):
        """(lanes, max_iter, draw_width) draws of one plan from
        ``generator`` (a CPU generator), in the planner's dtype on its
        device: uniforms, and leg choices by inverse CDF of
        ``cfg.leg_probs``."""
        E, nl = self.cfg.traj_count, self.cfg.num_legs
        u = torch.rand((lanes, self.max_iter, self.draw_width),
                       generator=generator, dtype=torch.float64)
        cdf = torch.cumsum(torch.as_tensor(list(self.cfg.leg_probs),
                                           dtype=torch.float64), 0)
        n_ch = E * nl
        for p in range(1 + self.K):
            o = 2 + p * (4 * n_ch + E)
            ch = u[..., o:o + n_ch]
            u[..., o:o + n_ch] = torch.sum(
                ch[..., None] >= cdf[:-1] / cdf[-1], dim=-1).double()
        return u.to(device=self.device, dtype=self.dtype)

    def _phase_draws(self, rec, phase: int):
        """(choices (L, E, nl) long, u (L, E, nl, 3), u_surf (L, E)) of one
        extension phase from an iteration's draws (L, draw_width)."""
        E, nl = self.cfg.traj_count, self.cfg.num_legs
        L, n_ch = rec.shape[0], E * nl
        o = 2 + phase * (4 * n_ch + E)
        choices = rec[:, o:o + n_ch].long().reshape(L, E, nl)
        u = rec[:, o + n_ch:o + 4 * n_ch].reshape(L, E, nl, 3)
        return choices, u, rec[:, o + 4 * n_ch:o + 4 * n_ch + E]

    # -- per-edge geometry + additive statistics -----------------------------
    def _edge_stats(self, prims, src_xy, dst_xy):
        """(feasible, budget, time, q (B, G|M), pts (B, S, 4), var (B, S))
        of edges (B, MAX_LEGS, 4) from src_xy to dst_xy (B, 2)."""
        cfg = self.cfg
        t_e, _, tuw, wpts, budget = evaluate_trajectory_device(prims, cfg)
        # bearing from src to dst (host edge_points_to_traj_points)
        dxy = dst_xy - src_xy
        b = torch.atan2(dxy[:, 1], dxy[:, 0])[:, None]
        ts = torch.cat([t_e[:, None] * self._lin, t_e[:, None]], dim=1)
        d, z, var_s = _interp(ts, wpts[..., 2],
                              (wpts[..., 0], wpts[..., 1], wpts[..., 3]))
        xyz = torch.stack([src_xy[:, :1] + d * torch.cos(b),
                           src_xy[:, 1:] + d * torch.sin(b), z], dim=-1)
        if self.cost == "ergodic":
            # unnormalized time-integral of the sensor density per cell
            dens = gaussian_sensor(xyz[:, None], self.grid[:, None, :],
                                   self.sigma_diag)  # (B, G, S)
            dt = ts[:, 1:] - ts[:, :-1]
            w = torch.zeros_like(ts)
            w[:, :-1] += 0.5 * dt
            w[:, 1:] += 0.5 * dt
            q = (dens @ w[..., None])[..., 0]
        elif self.cost == "fourier":
            # unnormalized cosine-coefficient sums over the edge samples
            # (additive across edges; host coef = sum / count / hk)
            xu = (xyz - self._f_lo) * self._f_ilen
            q = torch.sum(fourier_basis(xu, self._f_k), dim=-1)  # (B, M)
        else:  # gain mode scores from the points themselves
            q = xyz.new_zeros(xyz.shape[0], 1)
        feasible = tuw <= cfg.underwater_time_limit
        pts = torch.cat([xyz, ts[..., None]], dim=-1)
        return feasible, budget, t_e, q, pts, var_s

    def _score(self, q, T, r):
        """Host _ergodic_one semantics on additive stats (floor + KL), rows
        q (..., G) and T (...); ``r`` is the pre-floored, normalized EID."""
        qn = q / torch.clamp_min(T, 1e-30)[..., None]
        pos = torch.where(qn > 0, qn, torch.inf)
        floor = torch.clamp_max(torch.min(pos, dim=-1, keepdim=True)[0],
                                1e-15)
        qn = torch.where(torch.any(qn == 0, dim=-1, keepdim=True),
                         qn + floor, qn)
        p = qn / torch.sum(qn, dim=-1, keepdim=True)
        return -torch.sum(torch.where(p > 0, p * (torch.log(p)
                                                  - torch.log(r)), 0.0),
                          dim=-1)

    def _score_fourier(self, fc_sum, count, target):
        """Host _fourier_erg_one on additive stats: coef = sum/count/hk,
        score = -sum_k lambda_k (coef - target)^2."""
        coef = fc_sum / torch.clamp_min(count, 1.0)[..., None] / self._f_hk
        return -torch.sum(self._f_lam * (coef - target) ** 2, dim=-1)

    # -- one plan's constants ------------------------------------------------
    def _context(self, B, eid, gp) -> dict:
        """The tensors every iteration of one plan reads and none writes.

        ``eid`` (G,) and the ``gp`` tuple are shared by all lanes, or carry
        a leading lane axis (eid (L, G), X_pad (L, N, D), ...): each lane
        then plans on its own EID and model (the members of a mission
        ensemble). Per-lane model tensors keep that axis in the context
        (``ctx["per_lane"]``); shared ones have none."""
        dt = self.dtype
        ctx = {"B": B, "L": B.shape[0]}
        if eid.dim() == 2:  # one EID per lane
            if self.cost == "ergodic":
                pos = torch.where(eid > 0, eid, torch.inf)
                floor = torch.clamp_max(torch.amin(pos, -1, keepdim=True),
                                        1e-15)
                p_eid = torch.where(torch.any(eid == 0, -1, keepdim=True),
                                    eid + floor, eid)
                ctx["p_eid"] = (p_eid / torch.sum(p_eid, -1, keepdim=True)
                                )[:, None]
            elif self.cost == "fourier":
                ctx["f_target"] = ((eid @ self._f_grid_basis.T)
                                   / self._f_hk)[:, None]
        elif self.cost == "ergodic":
            pos = torch.where(eid > 0, eid, torch.inf)
            floor = torch.clamp_max(torch.min(pos), 1e-15)
            p_eid = torch.where(torch.any(eid == 0), eid + floor, eid)
            ctx["p_eid"] = p_eid / torch.sum(p_eid)
        elif self.cost == "fourier":
            ctx["f_target"] = (self._f_grid_basis @ eid) / self._f_hk
        if self.cost in STAT_COSTS:
            return ctx
        if gp[0].dim() == 3:
            return self._context_lanes(ctx, gp)
        ctx["per_lane"] = False
        mf = self.cost in ("mf_gain", "mf_logdet")
        if mf:
            (X_pad, fid_pad, L_pad, variances, lengthscales, rhos, noises,
             fl) = gp
            F = variances.shape[0]
            ctx.update(fid_pad=fid_pad, variances=variances,
                       lengthscales=lengthscales, rhos=rhos, noises=noises,
                       fl=fl, F=F, Wf=_k.ar1_fidelity_weights(rhos, F))
        else:
            X_pad, L_pad, variance, lengthscales, noise = gp
            ctx.update(fid_pad=torch.zeros(X_pad.shape[0], dtype=torch.long,
                                           device=X_pad.device),
                       variances=variance.reshape(1),
                       lengthscales=lengthscales.reshape(1, -1),
                       rhos=variance.new_zeros(0), noise=noise, F=1)
        N = X_pad.shape[0]
        cd = self.cov_dtype
        ctx.update(X_pad=X_pad, Kinv=_la.chol_solve(
            L_pad, torch.eye(N, dtype=dt, device=L_pad.device)),
            # B1's inputs in the tiles' precision, cast once per plan
            X_pad_c=X_pad.to(cd), grid_c=self.grid.to(cd),
            hyp_c=tuple(ctx[k].to(cd) for k in ("variances", "lengthscales",
                                                "rhos")))
        if self.cost in LOGDET_COSTS:
            # batch-mutual-information mode (host BatchLogDetCost /
            # MFBatchLogDetCost): each beam slot carries the grid's latent
            # posterior covariance given train + path
            G = self.grid.shape[0]
            fid_g = torch.full((G,), ctx["F"] - 1, dtype=torch.long,
                               device=self.device)
            g_noise = noises[ctx["F"] - 1] if mf else noise
            Kxg = self._cov1(ctx, X_pad, ctx["fid_pad"], self.grid, fid_g)
            Kgg = self._cov1(ctx, self.grid, fid_g, self.grid, fid_g)
            Ag = ctx["Kinv"] @ Kxg  # (N, G)
            Sig0 = Kgg - Kxg.T @ Ag  # latent grid posterior | train
            eyeG = torch.eye(G, dtype=dt, device=self.device)
            ctx.update(fid_g=fid_g, g_noise=g_noise, Kxg=Kxg, Ag=Ag,
                       Sig0=Sig0, eyeG=eyeG, ld_prior=_la.logdet_from_chol(
                           _la.chol(Sig0 + g_noise * eyeG)))
        return ctx

    def _context_lanes(self, ctx, gp) -> dict:
        """``_context``'s model tensors for a ``gp`` with a lane axis: each
        lane's built as a solo plan builds it, stacked."""
        L = ctx["L"]
        mf = self.cost in ("mf_gain", "mf_logdet")
        if mf:
            (X_pad, fid_pad, L_pad, variances, lengthscales, rhos, noises,
             fl) = gp
            F = variances.shape[-1]
            ctx.update(fid_pad=fid_pad, variances=variances,
                       lengthscales=lengthscales, rhos=rhos, noises=noises,
                       fl=fl, F=F, Wf=torch.stack([
                           _k.ar1_fidelity_weights(rhos[l], F)
                           for l in range(L)]))
        else:
            X_pad, L_pad, variance, lengthscales, noise = gp
            ctx.update(fid_pad=torch.zeros(X_pad.shape[:2], dtype=torch.long,
                                           device=X_pad.device),
                       variances=variance.reshape(L, 1),
                       lengthscales=lengthscales.reshape(L, 1, -1),
                       rhos=variance.new_zeros(L, 0), noise=noise, F=1)
        solo = [self._context(ctx["B"][l:l + 1], torch.ones(1),
                              tuple(t[l] for t in gp)) for l in range(L)]
        ctx["per_lane"] = True
        cd = self.cov_dtype
        ctx.update(X_pad=X_pad, Kinv=torch.stack([c["Kinv"] for c in solo]),
                   X_pad_c=X_pad.to(cd),
                   grid_c=self.grid.to(cd),
                   hyp_c=tuple(ctx[k].to(cd) for k in ("variances",
                                                        "lengthscales",
                                                        "rhos")))
        if self.cost in LOGDET_COSTS:
            ctx.update({k: (solo[0][k] if k in ("fid_g", "eyeG")
                            else torch.stack([c[k] for c in solo]))
                        for k in ("fid_g", "g_noise", "Kxg", "Ag", "Sig0",
                                  "eyeG", "ld_prior")})
        return ctx

    @staticmethod
    def _rep(ctx, t, k: int):
        """A per-plan model tensor for n = L * k lanes, lane-major: shared
        (no lane axis), broadcast; per lane (L, ...), each repeated k
        times."""
        if ctx["per_lane"]:
            return t.repeat_interleave(k, 0)
        return t.expand((ctx["L"] * k,) + t.shape)

    @staticmethod
    def _lane(ctx, t, dims: int):
        """A per-plan scalar against (L, ...) tensors of ``dims`` more
        axes: shared as it is, per lane (L,) shaped (L, 1, ..., 1)."""
        return t.reshape((-1,) + (1,) * dims) if ctx["per_lane"] else t

    @staticmethod
    def _left(A, X, k: int):
        """``A @ X`` for the n = L * k lanes of X (n, a, b): A (c, a) shared
        by all, or (L, c, a), one per lane (one product per lane, its k
        right-hand sides side by side)."""
        if A.dim() == 2:
            return A @ X
        L = A.shape[0]
        n, a, b = X.shape
        Xr = X.reshape(L, k, a, b).permute(0, 2, 1, 3).reshape(L, a, k * b)
        return (A @ Xr).reshape(L, A.shape[1], k, b).permute(
            0, 2, 1, 3).reshape(n, A.shape[1], b)

    @staticmethod
    def _right(X, A):
        """``X @ A`` for X (L, ..., a): A (a, c) shared, or (L, a, c)."""
        if A.dim() == 2:
            return X @ A
        L = A.shape[0]
        return (X.reshape(L, -1, X.shape[-1]) @ A).reshape(
            X.shape[:-1] + (A.shape[-1],))

    def _cov1(self, ctx, X1, f1, X2, f2):
        """One covariance (the grid blocks) through the model's dispatch,
        in the tiles' precision."""
        cd = self.cov_dtype
        return _cov.mf_cross_cov(*ctx["hyp_c"], X1.to(cd), f1, X2.to(cd), f2,
                                 self.kernel).to(self.dtype)

    def _cov(self, ctx, X1, f1, X2, f2, noise_diag=None):
        """Covariances of n lanes: X1 (n, a, D), f1 (n, a), X2 (n, b, D),
        f2 (n, b), any a broadcast view (of a tensor in the tiles'
        precision, which keeps it a view): one launch of B1's lane axis on
        the card in float32, the lanes' plain compositions elsewhere."""
        n, cd = X1.shape[0], self.cov_dtype
        v, ls, rho = (self._rep(ctx, t, n // ctx["L"]) for t in ctx["hyp_c"])
        return _cov.ar1_cov_lanes(
            v, ls, rho, X1.to(cd), f1, X2.to(cd), f2, self.kernel,
            None if noise_diag is None else noise_diag.to(cd)).to(self.dtype)

    def _flabels(self, ctx, var):
        """Accrued variance -> conditioning fidelity (traced
        fids_from_variance, reference/GraceRIGV3.py:528-533)."""
        fl = ctx["fl"]
        if ctx["per_lane"]:
            fl = fl.reshape((fl.shape[0],) + (1,) * (var.dim() - 1) + (-1,))
        lev = torch.sum(var[..., None] >= fl, dim=-1)
        return ctx["F"] - 1 - lev

    # -- the loop state ------------------------------------------------------
    def _init_state(self, x0, ctx) -> dict:
        L = x0.shape[0]
        cfg = self.cfg
        f = dict(dtype=self.dtype, device=self.device)
        i = dict(dtype=torch.long, device=self.device)
        MAXN, MAXP, E, S, P = (self.max_nodes, self.max_paths,
                               cfg.traj_count, self.S, self.P)
        PH = 1 + self.K
        ARENA = 1 + PH * self.max_iter * MAXP  # slot 0 = root trivial path
        MAXE = PH * self.max_iter * E
        st = dict(
            nodes=torch.zeros((L, MAXN, 2), **f),
            n_nodes=torch.ones(L, **i),
            n_feas=torch.zeros(L, **i),
            # per-node beam: arena indices, -1 = empty
            node_paths=torch.full((L, MAXN, MAXP), -1, **i),
            a_budget=torch.zeros((L, ARENA), **f),
            a_time=torch.zeros((L, ARENA), **f),
            a_score=torch.full((L, ARENA), SENTINEL, **f),
            a_prev=torch.full((L, ARENA), -1, **i),
            a_edge=torch.full((L, ARENA), -1, **i),
            a_node=torch.zeros((L, ARENA), **i),
            edge_pts=torch.zeros((L, MAXE, S, 4), **f),
            edge_prims=torch.full((L, MAXE, 2 * cfg.num_legs + 1, 4), -1.0,
                                  **f),
            edge_src=torch.zeros((L, MAXE), **i),
            edge_dst=torch.zeros((L, MAXE), **i),
            best_score=torch.full((L,), NEG, **f),
            best_budget=torch.full((L,), torch.inf, **f),
            best_arena=torch.full((L,), -1, **i),
        )
        st["nodes"][:, 0] = x0
        st["node_paths"][:, 0, 0] = 0
        # the root's trivial path is never evicted from node 0's beam
        # (every path starts by extending it): its beam-ranking score is
        # above any real one (never read as a best-path candidate)
        st["a_score"][:, 0] = PIN
        if self.cost == "ergodic":
            st["a_q"] = torch.zeros((L, ARENA, self.grid.shape[0]), **f)
        elif self.cost == "fourier":
            st["a_q"] = torch.zeros((L, ARENA, self._f_k.shape[0]), **f)
            st["a_cnt"] = torch.zeros((L, ARENA), **f)
        else:
            # gain-mode carries, per (node, beam slot): path points (xyz +
            # accrued var), count, accumulated gain, and the bordered
            # factor chol(C_path | train)
            st.update(
                c_pts=torch.zeros((L, MAXN, MAXP, P, 4), **f),
                c_np=torch.zeros((L, MAXN, MAXP), **i),
                c_gain=torch.zeros((L, MAXN, MAXP), **f),
                c_L=torch.eye(P, **f).expand(L, MAXN, MAXP, P, P).clone())
            if self.cost in LOGDET_COSTS:
                G = ctx["Sig0"].shape[-1]
                sig0 = (ctx["Sig0"][:, None, None] if ctx["per_lane"]
                        else ctx["Sig0"])
                st["c_sig"] = sig0.expand(L, MAXN, MAXP, G, G).clone()
        return st

    # -- index lowering: gathers and scatters with a validity mask -----------
    @staticmethod
    def _take(arr, idx):
        """``arr[l, idx[l, k]]`` (L, K, ...): an index outside [0, A) (-1 =
        empty) gives zeros, JAX's ``take(mode="fill")``."""
        valid = (idx >= 0) & (idx < arr.shape[1])
        lanes = torch.arange(arr.shape[0], device=arr.device)
        out = arr[lanes.view((-1,) + (1,) * (idx.dim() - 1)),
                  torch.where(valid, idx, 0)]
        return torch.where(_bcast(valid, arr.dim() - 2), out,
                           False if arr.dtype == torch.bool else 0)

    @staticmethod
    def _at(arr, idx):
        """``arr[l, idx[l]]`` (L, ...) for an index that is always valid."""
        return arr[torch.arange(arr.shape[0], device=arr.device), idx]

    @staticmethod
    def _put(arr, idx, value, active):
        """In place ``arr[l, idx[l]] = value[l]`` where ``active[l]``."""
        lanes = torch.arange(arr.shape[0], device=arr.device)
        arr[lanes, idx] = torch.where(_bcast(active, value.dim() - 1), value,
                                      arr[lanes, idx])

    # -- one extension phase -------------------------------------------------
    def extend(self, st, ctx, src_idx, dst_xy, draws, phase: int, it):
        """Synthesize E candidate edges src->dst per lane and run the DP
        update, in place on the state ``st``. ``it`` is the iteration (a
        0-d device tensor), ``draws`` the iteration's (L, draw_width)."""
        cfg = self.cfg
        L = dst_xy.shape[0]
        MAXN, MAXP, E, S, P = (self.max_nodes, self.max_paths,
                               cfg.traj_count, self.S, self.P)
        PH = 1 + self.K
        dev = self.device
        gain_mode = self.cost not in STAT_COSTS
        ld_mode = self.cost in LOGDET_COSTS
        mf = self.cost in ("mf_gain", "mf_logdet")
        B = ctx["B"]
        nodes, n_nodes = st["nodes"], st["n_nodes"]
        src_xy = self._at(nodes, src_idx)

        # merge into an existing node, else allocate a new slot
        ar_n = torch.arange(MAXN, device=dev)
        d_all = torch.sqrt(torch.sum((nodes - dst_xy[:, None]) ** 2, -1))
        d_all = torch.where(ar_n < n_nodes[:, None], d_all, torch.inf)
        j_min = torch.argmin(d_all, dim=1)
        merge = torch.min(d_all, dim=1)[0] < self.snd
        have_room = n_nodes < MAXN
        dst_idx = torch.where(merge, j_min, torch.where(have_room, n_nodes,
                                                        j_min))
        dst_xy = torch.where(merge[:, None], self._at(nodes, dst_idx),
                             dst_xy)
        in_ws = torch.all((dst_xy >= self._lo) & (dst_xy <= self._hi), -1)
        active = in_ws & (merge | have_room) & (dst_idx != src_idx)

        # candidate edges: batched synthesis + stats over (lane, edge)
        distance = torch.sqrt(torch.sum((dst_xy - src_xy) ** 2, -1))
        choices, u, u_surf = self._phase_draws(draws, phase)
        e_prims = generate_trajectory_device(
            choices.reshape(L * E, -1), distance.repeat_interleave(E), cfg,
            u.reshape(L * E, cfg.num_legs, 3), u_surf.reshape(L * E))
        (feas, e_budget, e_time, e_q, e_pts, e_var) = (
            t.reshape((L, E) + t.shape[1:]) for t in self._edge_stats(
                e_prims, src_xy.repeat_interleave(E, 0),
                dst_xy.repeat_interleave(E, 0)))
        e_prims = e_prims.reshape((L, E) + e_prims.shape[1:])
        feas = feas & active[:, None]
        ebase = (PH * it + phase) * E
        eidx = ebase + torch.arange(E, device=dev)
        st["n_feas"] += torch.sum(feas, dim=1)
        st["edge_pts"].index_copy_(1, eidx, e_pts)
        st["edge_prims"].index_copy_(1, eidx, e_prims)
        st["edge_src"].index_copy_(1, eidx, src_idx[:, None].expand(L, E))
        st["edge_dst"].index_copy_(1, eidx, dst_idx[:, None].expand(L, E))

        # DP: extend every source path slot by every feasible edge
        src_slots = self._at(st["node_paths"], src_idx)  # (L, MAXP)
        src_valid = src_slots >= 0
        sb = self._take(st["a_budget"], src_slots)
        stt = self._take(st["a_time"], src_slots)
        xb = (sb[:, :, None] + e_budget[:, None, :]).reshape(L, MAXP * E)
        xt = (stt[:, :, None] + e_time[:, None, :]).reshape(L, MAXP * E)
        ok = ((src_valid[:, :, None] & feas[:, None, :]).reshape(L, -1)
              & (xb < B[:, None]))
        abase = 1 + (PH * it + phase) * MAXP
        aidx = abase + torch.arange(MAXP, device=dev)

        if not gain_mode:
            scored = ok & (xb > self.budget_cutoff * B[:, None])
            # scores are cheap (additive stats): score ALL extensions, beam
            # by score. Infeasible entries can carry NaNs from masked-out
            # synthesis branches: they rank below every real key.
            sq = self._take(st["a_q"], src_slots)  # (L, MAXP, nst)
            xq = (sq[:, :, None, :] + e_q[:, None, :, :]).reshape(
                L, MAXP * E, -1)
            if self.cost == "fourier":
                scnt = self._take(st["a_cnt"], src_slots)
                xcnt = (scnt[:, :, None] + torch.full(
                    (1, 1, E), float(S), dtype=self.dtype,
                    device=dev)).reshape(L, -1)
                scores = self._score_fourier(xq, xcnt, ctx["f_target"])
            else:
                scores = self._score(xq, xt, ctx["p_eid"])
            scores = torch.where(scored, scores, torch.where(
                ok, torch.full_like(scores, SENTINEL), NEG))
            # scored: by score (lower budget tie-break). Unscored: HIGHER
            # budget first (closest to the budget_cutoff scoring band)
            key_rank = torch.where(
                scored, scores - 1e-6 * xb,
                torch.where(ok, SENTINEL + 1e-6 * xb, NEG))
            top = _top(key_rank, MAXP)
            sel_ok = torch.gather(ok, 1, top)
            top_scored = torch.gather(scored, 1, top)
            top_scores = torch.gather(scores, 1, top)
            blk_real = torch.where(top_scored & sel_ok, top_scores, NEG)
            a_score_blk = torch.where(sel_ok, top_scores, NEG)
            st["a_q"].index_copy_(1, aidx, self._take(xq, top))
            if self.cost == "fourier":
                st["a_cnt"].index_copy_(1, aidx, torch.gather(xcnt, 1, top))
        else:
            # gain mode, score-everything: per-path bordered-Cholesky
            # carries make the sequential gain additive per edge, so EVERY
            # eligible extension is scored exactly. Extensions that would
            # exceed the P-point carry capacity are infeasible.
            ppts = self._at(st["c_pts"], src_idx)  # (L, MAXP, P, 4)
            pnp = self._at(st["c_np"], src_idx)  # (L, MAXP)
            pgain = self._at(st["c_gain"], src_idx)
            Lp = self._at(st["c_L"], src_idx)  # (L, MAXP, P, P)
            ok = ok & (pnp + S <= P).repeat_interleave(E, 1)
            scored = ok & (xb > self.budget_cutoff * B[:, None])
            e_xyz = e_pts[..., :3].contiguous()  # (L, E, S, 3)
            zS = torch.zeros((L, E, S), dtype=torch.long, device=dev)
            if mf:
                e_fid = self._flabels(ctx, e_var)  # (L, E, S)
                p_fid = self._flabels(ctx, ppts[..., 3])  # (L, MAXP, P)
            else:
                e_fid = zS
                p_fid = torch.zeros((L, MAXP, P), dtype=torch.long,
                                    device=dev)
            Kinv = ctx["Kinv"]
            X_pad, fid_pad = ctx["X_pad"], ctx["fid_pad"]
            N = X_pad.shape[-2]

            # per-edge posterior projections against the train set, the
            # (lane, edge) pairs as B1's lanes
            LE = L * E
            exyz = e_xyz.reshape(LE, S, 3)
            efid = e_fid.reshape(LE, S)
            Xl = self._rep(ctx, ctx["X_pad_c"], E)
            fl_ = self._rep(ctx, fid_pad, E)
            if mf:
                noise_c = torch.gather(self._rep(ctx, ctx["noises"], E), 1,
                                       efid)
            else:
                noise_c = self._lane(ctx, ctx["noise"], 1)
                noise_c = (self._rep(ctx, noise_c, E) if ctx["per_lane"]
                           else noise_c).expand(LE, S).contiguous()
            Kx_c = self._cov(ctx, Xl, fl_, exyz, efid)  # (LE, N, S)
            A_c = self._left(Kinv, Kx_c, E)
            D_cc = (self._cov(ctx, exyz, efid, exyz, efid, noise_c)
                    - Kx_c.mT @ A_c)
            if ld_mode:
                G = self.grid.shape[0]
                # latent grid<->edge posterior cross-cov | train
                Cgs = (self._cov(ctx, ctx["grid_c"].expand(LE, -1, -1),
                                 ctx["fid_g"].expand(LE, -1), exyz, efid)
                       - self._left(ctx["Ag"].mT, Kx_c, E))  # (LE, G, S)
                eKx_p, eSig_cp = Kx_c, Cgs
            elif mf:
                f0 = zS.reshape(LE, S)
                Kx_p = self._cov(ctx, Xl, fl_, exyz, f0)
                A_p = self._left(Kinv, Kx_p, E)
                eSig_cp = self._cov(ctx, exyz, efid, exyz, f0) - Kx_c.mT @ A_p
                kpp = torch.sum(ctx["Wf"][..., 0] ** 2 * ctx["variances"],
                                dim=-1)
                if ctx["per_lane"]:
                    kpp = kpp.repeat_interleave(E)[:, None]
                esig_pp = kpp - torch.sum(Kx_p * A_p, dim=1)  # (LE, S)
                eKx_p = Kx_p
            else:
                eKx_p, eSig_cp = Kx_c, D_cc
            eKx_c = Kx_c.reshape(L, E, N, S)
            eD_cc = D_cc.reshape(L, E, S, S)

            # per-path prefix projection (rows beyond n masked), the
            # (lane, path) pairs as B1's lanes
            LM = L * MAXP
            m = (torch.arange(P, device=dev) < pnp[..., None])  # (L,MAXP,P)
            pxyz = ppts[..., :3].reshape(LM, P, 3)
            pf = p_fid.reshape(LM, P)
            Kpx = self._cov(ctx, pxyz, pf,
                            self._rep(ctx, ctx["X_pad_c"], MAXP),
                            self._rep(ctx, fid_pad, MAXP)).reshape(
                                L, MAXP, P, N)
            Kpx = torch.where(m[..., None], Kpx, 0.0)
            Rp = self._right(Kpx, Kinv)  # (L, MAXP, P, N)
            if ld_mode:
                # whitened prefix<->grid posterior cross-cov | train
                Kpg = self._cov(ctx, pxyz, pf,
                                ctx["grid_c"].expand(LM, -1, -1),
                                ctx["fid_g"].expand(LM, -1)).reshape(
                                    L, MAXP, P, G)
                Kpg = torch.where(m[..., None], Kpg, 0.0)
                Vg = torch.linalg.solve_triangular(
                    Lp, Kpg - self._right(Rp, ctx["Kxg"]),
                    upper=False)  # (L,MAXP,P,G)
                csig_src = self._at(st["c_sig"], src_idx)  # (L,MAXP,G,G)

            # every (path, edge) pair: exact score of extending path ip by
            # edge ie + the bordered factor pieces for the carry
            LME = L * MAXP * E

            def pair_lanes(t):  # (L, MAXP, a, ...) -> (LME, a, ...)
                return t[:, :, None].expand(
                    (L, MAXP, E) + t.shape[2:]).reshape(
                        (LME,) + t.shape[2:])

            def edge_lanes(t):  # (L, E, a, ...) -> (LME, a, ...)
                return t[:, None].expand((L, MAXP, E) + t.shape[2:]).reshape(
                    (LME,) + t.shape[2:])

            def by_pair(t):  # (L, MAXP, a, E, b) -> (L, MAXP, E, a, b)
                return t.permute(0, 1, 3, 2, 4)

            def rhs_all_edges(t):  # (L, E, a, b) -> (L, 1, a, E * b)
                return t.permute(0, 2, 1, 3).reshape(
                    L, 1, t.shape[2], E * t.shape[3])

            pm = pair_lanes(m.reshape(L, MAXP, P))[..., None]
            exyz_p = edge_lanes(e_xyz.to(self.cov_dtype))
            pxyz_p = pair_lanes(ppts[..., :3].to(self.cov_dtype))
            efid_p = edge_lanes(e_fid)
            Kpn_cc = self._cov(ctx, pxyz_p, pair_lanes(p_fid), exyz_p,
                               efid_p)
            Kpn_cc = torch.where(pm, Kpn_cc, 0.0).reshape(L, MAXP, E, P, S)
            # latent posterior cross-cov prefix<->new given train
            Sig_cc = Kpn_cc - by_pair((Rp @ rhs_all_edges(eKx_c)).reshape(
                L, MAXP, P, E, S))
            U = by_pair(torch.linalg.solve_triangular(
                Lp, by_pair(Sig_cc).reshape(L, MAXP, P, E * S),
                upper=False).reshape(L, MAXP, P, E, S))  # (L,MAXP,E,P,S)
            Schur = eD_cc[:, None] - U.mT @ U
            Ls = _la.chol(Schur)  # (L, MAXP, E, S, S)
            if ld_mode:
                # rank-S grid-cov downdate; score = batch mutual
                # information over the grid (host _logdet_gain_one /
                # _mf_logdet_gain_one semantics)
                VgU = by_pair((Vg.mT @ U.permute(0, 1, 3, 2, 4).reshape(
                    L, MAXP, P, E * S)).reshape(L, MAXP, G, E, S))
                Cgs_p = eSig_cp.reshape(L, 1, E, G, S) - VgU
                W = torch.linalg.solve_triangular(Ls, Cgs_p.mT,
                                                  upper=False)  # (.., S, G)
                Sig_new = csig_src[:, :, None] - W.mT @ W
                inc = 0.5 * (self._lane(ctx, ctx["ld_prior"], 2)
                             - _la.logdet_from_chol(_la.chol(
                                 Sig_new + self._lane(ctx, ctx["g_noise"], 4)
                                 * ctx["eyeG"])))
                if not mf:  # the reference's SF variant clamps
                    inc = torch.clamp_min(inc, 0.0)
                gains = inc.reshape(L, -1)  # direct scores, not increments
            else:
                if not mf:
                    noise = self._lane(ctx, ctx["noise"], 3)
                    v = torch.diagonal(Ls, dim1=-2, dim2=-1) ** 2
                    terms = torch.log(1.0 + v / noise)
                    # first-point self-conditioning quirk at path start
                    # (reference/GraceRIGV3.py:454-456)
                    noise = self._lane(ctx, ctx["noise"], 2)
                    a = eD_cc[..., 0, 0][:, None] - noise  # (L, 1, E)
                    t0 = torch.log(1.0 + (a - a * a / (a + noise) + noise)
                                   / noise)
                    terms[..., 0] = torch.where((pnp == 0)[..., None], t0,
                                                terms[..., 0])
                    inc = torch.sum(terms, dim=-1)
                else:
                    noise0 = self._lane(ctx, ctx["noises"][..., 0], 3)
                    f0p = torch.zeros((LME, S), dtype=torch.long, device=dev)
                    Kpn_cp = self._cov(ctx, pxyz_p, pair_lanes(p_fid),
                                       exyz_p, f0p)
                    Kpn_cp = torch.where(pm, Kpn_cp, 0.0).reshape(
                        L, MAXP, E, P, S)
                    Sig_cp_pfx = Kpn_cp - by_pair(
                        (Rp @ rhs_all_edges(eKx_p.reshape(L, E, N, S)))
                        .reshape(L, MAXP, P, E, S))
                    B_top = by_pair(torch.linalg.solve_triangular(
                        Lp, by_pair(Sig_cp_pfx).reshape(L, MAXP, P, E * S),
                        upper=False).reshape(L, MAXP, P, E, S))
                    Mx = eSig_cp.reshape(L, 1, E, S, S) - U.mT @ B_top
                    B_bot = torch.linalg.solve_triangular(Ls, Mx,
                                                          upper=False)
                    w = (torch.sum(B_top ** 2, dim=-2)
                         + torch.sum(torch.where(self._strict_upper_S,
                                                 B_bot ** 2, 0.0), dim=-2))
                    v = esig_pp.reshape(L, 1, E, S) - w + noise0
                    inc = torch.sum(torch.log(1.0 + v / noise0), dim=-1)
                gains = (pgain[:, :, None] + inc).reshape(L, -1)
            finite = torch.isfinite(gains)
            gains = torch.where(finite, gains, NEG)
            ok = ok & finite
            scored = scored & finite
            # beam selection: scored extensions outrank unscored; within a
            # tier, by accumulated gain (cheaper ties first)
            tier = torch.where(ok, scored.long(), -1)
            top = _lex_top(tier, gains - 1e-6 * xb, MAXP)
            sel_ok = torch.gather(ok, 1, top)
            top_scored = torch.gather(scored, 1, top)
            top_scores = torch.gather(gains, 1, top)
            blk_real = torch.where(top_scored & sel_ok, top_scores, NEG)
            a_score_blk = torch.where(
                sel_ok, torch.where(top_scored, top_scores, SENTINEL), NEG)

            # build the selected extensions' carries
            ip_s, ie_s = top // E, top % E
            n_s = torch.gather(pnp, 1, ip_s)
            exyzv = torch.cat([self._take(e_xyz, ie_s),
                               self._take(e_var, ie_s)[..., None]], dim=-1)
            # rows n0 .. n0 + S - 1 take the edge's rows (the start clamped
            # as jax.lax.dynamic_update_slice clamps it)
            n0 = torch.clamp_max(n_s, P - S)[..., None]  # (L, MAXP, 1)
            rP = torch.arange(P, device=dev)
            inblk = (rP >= n0) & (rP < n0 + S)  # (L, MAXP, P)
            rel = torch.clamp(rP - n0, 0, S - 1)
            new_pts = torch.where(
                inblk[..., None],
                torch.gather(exyzv, 2, rel[..., None].expand(L, MAXP, P, 4)),
                self._take(ppts, ip_s))
            Lsel = self._take(Ls.reshape(L, MAXP * E, S, S), top)
            Usel = self._take(U.reshape(L, MAXP * E, P, S), top)
            # border: rows n0.. of the factor become [U^T | Ls | 0]
            rowblk = torch.where(
                inblk[:, :, None, :],
                torch.gather(Lsel, 3, rel[:, :, None, :].expand(
                    L, MAXP, S, P)),
                Usel.mT)  # (L, MAXP, S, P)
            new_L = torch.where(
                inblk[..., None],
                torch.gather(rowblk, 2, rel[..., None].expand(
                    L, MAXP, P, P)),
                self._take(Lp, ip_s))
            eyeP = torch.eye(P, dtype=self.dtype, device=dev)
            sel4 = sel_ok[..., None, None]
            new_L = torch.where(sel4, new_L, eyeP)
            new_pts = torch.where(sel4, new_pts, 0.0)
            new_np = torch.where(sel_ok, n_s + S, 0)
            new_gain = torch.where(sel_ok, top_scores, 0.0)
            if ld_mode:
                W_s = self._take(W.reshape(L, MAXP * E, S, G), top)
                new_sig = self._take(csig_src, ip_s) - W_s.mT @ W_s
                sig0 = (ctx["Sig0"][:, None] if ctx["per_lane"]
                        else ctx["Sig0"])
                new_sig = torch.where(sel4, new_sig, sig0)

        prev = torch.gather(src_slots, 1, top // E)
        edge_ids = ebase + top % E
        blk_budget = torch.gather(xb, 1, top)
        st["a_budget"].index_copy_(1, aidx, blk_budget)
        st["a_time"].index_copy_(1, aidx, torch.gather(xt, 1, top))
        st["a_score"].index_copy_(1, aidx, a_score_blk)
        st["a_prev"].index_copy_(1, aidx, torch.where(sel_ok, prev, -1))
        st["a_edge"].index_copy_(1, aidx, torch.where(sel_ok, edge_ids, -1))
        st["a_node"].index_copy_(1, aidx, torch.where(sel_ok,
                                                      dst_idx[:, None], 0))

        # merge the new block into dst's beam
        new_idx = torch.where(sel_ok, aidx, -1)
        cand = torch.cat([self._at(st["node_paths"], dst_idx), new_idx], 1)
        # _take zeroes invalid (-1) rows; a real arena score can be 0, so
        # invalid entries are forced to NEG
        sc_c = torch.where(cand >= 0, self._take(st["a_score"], cand), NEG)
        bu_c = self._take(st["a_budget"], cand)
        if gain_mode:
            # rank by accumulated gain (scored entries above unscored,
            # cheaper ties first); the root pin dominates everything
            cand_gain = torch.cat([self._at(st["c_gain"], dst_idx),
                                   new_gain], 1)
            ctier = torch.where(
                cand >= 0,
                torch.where(sc_c >= PIN * 0.5, 2,
                            torch.where(sc_c != SENTINEL, 1, 0)), -1)
            keep = _lex_top(ctier, cand_gain - 1e-6 * bu_c, MAXP)
            beam = torch.where(torch.gather(ctier, 1, keep) >= 0,
                               torch.gather(cand, 1, keep), -1)
        else:
            # scored paths by score (cheaper ties first), sentinel
            # (unscored) paths by HIGHER budget
            ck = torch.where(cand >= 0,
                             torch.where(sc_c == SENTINEL,
                                         SENTINEL + 1e-6 * bu_c,
                                         sc_c - 1e-6 * bu_c), NEG)
            keep = _top(ck, MAXP)
            beam = torch.where(torch.gather(ck, 1, keep) > NEG,
                               torch.gather(cand, 1, keep), -1)
        admitted = torch.any(beam >= 0, dim=1) & active
        self._put(st["node_paths"], dst_idx, beam, active)
        self._put(st["nodes"], dst_idx, dst_xy, active)
        st["n_nodes"].copy_(torch.where(admitted & ~merge & have_room,
                                        n_nodes + 1, n_nodes))
        if gain_mode:
            # gather the surviving entries' carries into dst's slots
            bvalid = (beam >= 0)[..., None, None]

            def keep_rows(carry, new):
                both = torch.cat([self._at(carry, dst_idx), new], 1)
                return self._take(both, keep)

            cL = torch.where(bvalid, keep_rows(st["c_L"], new_L), eyeP)
            cP = torch.where(bvalid, keep_rows(st["c_pts"], new_pts), 0.0)
            cN = torch.where(beam >= 0, keep_rows(st["c_np"], new_np), 0)
            cG = torch.where(beam >= 0, keep_rows(st["c_gain"], new_gain),
                             0.0)
            if ld_mode:
                cS = torch.where(bvalid, keep_rows(st["c_sig"], new_sig),
                                 sig0)
                self._put(st["c_sig"], dst_idx, cS, active)
            self._put(st["c_L"], dst_idx, cL, active)
            self._put(st["c_pts"], dst_idx, cP, active)
            self._put(st["c_np"], dst_idx, cN, active)
            self._put(st["c_gain"], dst_idx, cG, active)

        # global best (scored extensions only; lower budget tie-break). The
        # best SCORED extension always ranks inside the arena block, so its
        # arena index is abase + its position within the block. The key is
        # masked: budgets of infeasible rows can be NaN.
        blk_key = torch.where(blk_real > NEG, blk_real - 1e-9 * blk_budget,
                              NEG)
        pos = torch.argmax(blk_key, dim=1, keepdim=True)
        cand_s = torch.gather(blk_real, 1, pos)[:, 0]
        cand_b = torch.gather(blk_budget, 1, pos)[:, 0]
        best_s, best_b = st["best_score"], st["best_budget"]
        better = ((cand_s > best_s)
                  | ((cand_s == best_s) & (cand_b < best_b))) & (cand_s > NEG)
        st["best_arena"].copy_(torch.where(better, abase + pos[:, 0],
                                           st["best_arena"]))
        best_b.copy_(torch.where(better, cand_b, best_b))
        best_s.copy_(torch.where(better, cand_s, best_s))

    def body(self, st, ctx, draws, it):
        """One planning iteration, in place on ``st``; advances ``it``."""
        L = draws.shape[0]
        MAXN = self.max_nodes
        dev = self.device
        rec = draws.index_select(1, it.reshape(1))[:, 0]  # (L, draw_width)
        xsamp = self._lo + (self._hi - self._lo) * rec[:, :2]
        nodes, n_nodes = st["nodes"], st["n_nodes"]
        d = torch.sqrt(torch.sum((nodes - xsamp[:, None]) ** 2, -1))
        ar_n = torch.arange(MAXN, device=dev)
        valid = ar_n < n_nodes[:, None]
        ring = torch.where(valid, (self.Rd - d) ** 2, torch.inf)
        i_near = torch.argmin(ring, dim=1)
        # steer
        near = self._at(nodes, i_near)
        v = xsamp - near
        dist = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
        step = torch.clamp_max(dist, self.delta)
        xfeas = near + torch.where(dist > 0, step / dist, 0.0) * v
        # near-set BEFORE the phase-0 extend: the host extends PRE-existing
        # nodes within R (reference/GraceRIGV3.py:1284-1337)
        d2 = torch.sqrt(torch.sum((nodes - xfeas[:, None]) ** 2, -1))
        d2 = torch.where(valid & (ar_n != i_near[:, None]), d2, torch.inf)
        self.extend(st, ctx, i_near, xfeas, rec, 0, it)
        # near phases: the K closest pre-existing OTHER nodes within R each
        # steer toward xfeas
        near_js = torch.sort(d2, dim=1, stable=True)[1][:, :self.K]
        for k in range(self.K):
            j = near_js[:, k]
            has_near = self._at(d2, j) <= self.R
            nj = self._at(st["nodes"], j)
            v2 = xfeas - nj
            dist2 = torch.sqrt(torch.sum(v2 * v2, -1, keepdim=True))
            step2 = torch.clamp_max(dist2, self.delta)
            x2 = nj + torch.where(dist2 > 0, step2 / dist2, 0.0) * v2
            # out of the workspace: inactive
            x2 = torch.where(has_near[:, None], x2, self._lo - 1.0)
            self.extend(st, ctx, j, x2, rec, 1 + k, it)
        it.add_(1)

    # -- the loop ------------------------------------------------------------
    def _run(self, x0, B, eid, gp, draws) -> dict:
        """The whole loop over L lanes: x0 (L, 2), B (L,), draws (L,
        max_iter, draw_width). Returns the final state.

        With ``graph``, the first call of a shape runs iteration 0 eagerly
        and captures one iteration; a later call whose plan constants,
        state and draws have the same shapes (a mission's replans) copies
        its values into the captured buffers and replays every iteration,
        so it captures nothing. Its state is then those buffers, which the
        next call of those shapes overwrites. The last ``MAX_GRAPHS``
        shapes keep their captures."""
        from mfgp_tpu_torch.ops import cuda_kernels as _ck

        with torch.no_grad():
            ctx = self._context(B, eid, gp)
            st = self._init_state(x0, ctx)
            it = torch.zeros((), dtype=torch.long, device=self.device)
            n0 = _ck.LAUNCHES["ar1_cov_fused"]
            key = _shapes((ctx, st, draws))
            g = self._graphs.get(key)
            if self.graph and g is not None:
                _copy_into(g["args"], (ctx, st, draws))
                g["it"].zero_()
                for _ in range(self.max_iter):
                    g["graph"].replay()
                self.stats = dict(eager_iterations=0, replays=self.max_iter,
                                  b1_captured=g["b1"], capture_s=0.0,
                                  b1_launches=g["b1"] * self.max_iter)
                return g["args"][1]
            if not self.graph or self.max_iter < 2:
                for _ in range(self.max_iter):
                    self.body(st, ctx, draws, it)
                self.stats = dict(eager_iterations=self.max_iter, replays=0,
                                  b1_launches=_ck.LAUNCHES["ar1_cov_fused"]
                                  - n0, b1_captured=0)
                return st
            # the captured graph reads buffers of its own: the constants'
            # tensors may be the caller's
            ctx, draws = _clone_tree((ctx, draws))
            # iteration 0 eagerly on a side stream (it also warms up the
            # libraries' handles), then one iteration captured and replayed
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.body(st, ctx, draws, it)
            torch.cuda.current_stream(self.device).wait_stream(side)
            n1 = _ck.LAUNCHES["ar1_cov_fused"]
            t_cap = time.perf_counter()
            g = torch.cuda.CUDAGraph()
            profiling.count("graph.captures")
            with torch.cuda.graph(g):
                self.body(st, ctx, draws, it)
            capture_s = time.perf_counter() - t_cap
            captured = _ck.LAUNCHES["ar1_cov_fused"] - n1
            for _ in range(self.max_iter - 1):
                g.replay()
            self.stats = dict(eager_iterations=1, replays=self.max_iter - 1,
                              b1_captured=captured, capture_s=capture_s,
                              b1_launches=(n1 - n0) + captured
                              * (self.max_iter - 1))
            # its memory pool outlives the replays
            if len(self._graphs) >= self.MAX_GRAPHS:
                del self._graphs[next(iter(self._graphs))]
            self._graphs[key] = dict(graph=g, args=(ctx, st, draws), it=it,
                                     b1=captured)
            return st

    def _args(self, x0s, Bs, eid, gp):
        f = dict(dtype=self.dtype, device=self.device)
        eid_t = (self._eid if eid is None
                 else torch.as_tensor(eid, **f).reshape(-1))
        if eid_t is None:
            if self.cost in STAT_COSTS:
                raise ValueError(f"{self.cost} scoring needs an eid "
                                 "(constructor or plan argument)")
            eid_t = torch.ones(1, **f)  # unused in gain mode
        if gp is None and self.cost in GAIN_COSTS + LOGDET_COSTS:
            raise ValueError(
                "gain/logdet scoring needs the conditioned GP state: pass "
                "gp=prepare_sf_gain_state(...)/prepare_mf_gain_state(...)")
        if gp is not None:
            gp = tuple(t.to(**f).contiguous() if t.dtype.is_floating_point
                       else t.long() for t in
                       (torch.as_tensor(a, device=self.device) for a in gp))
        x0 = torch.as_tensor(np.asarray(x0s, float).reshape(-1, 2), **f)
        B = torch.as_tensor(np.broadcast_to(np.asarray(
            self.B if Bs is None else Bs, float).reshape(-1),
            (x0.shape[0],)).copy(), **f)
        return x0, B, eid_t, gp

    def _lane_draws(self, draws, seed, lanes):
        if draws is None:
            return self.draws(torch.Generator().manual_seed(int(seed)),
                              lanes)
        draws = torch.as_tensor(np.asarray(draws) if not isinstance(
            draws, torch.Tensor) else draws)
        if draws.shape != (lanes, self.max_iter, self.draw_width):
            raise ValueError(f"draws {tuple(draws.shape)}, need "
                             f"({lanes}, {self.max_iter}, {self.draw_width})")
        return draws.to(device=self.device, dtype=self.dtype)

    def plan(self, x0, seed: int = 0, B=None, eid=None, gp=None,
             draws=None) -> DevicePlanResult:
        """Run the device loop for one start, extract the best path on the
        host. ``B`` (budget), ``eid`` (ergodic target) and ``gp`` (the
        conditioned GP for gain scoring, prepare_sf_gain_state) override
        the constructor's. The draws come from a generator seeded with
        ``seed`` unless ``draws`` (1, max_iter, draw_width) are given."""
        x0t, Bt, eidt, gpt = self._args(x0, B, eid, gp)
        st = self._run(x0t, Bt, eidt, gpt, self._lane_draws(draws, seed, 1))
        return self._extract(self._to_host(st), 0)

    def plan_ensemble(self, x0, seed: int = 0, n_plans: int = 8, B=None,
                      eid=None, gp=None, draws=None,
                      mesh=None) -> DevicePlanResult:
        """``n_plans`` independent planner instances as lanes of one loop;
        the best-scoring plan wins (ties break toward lower budget).

        ``mesh`` (a ``parallel.make_mesh`` mesh; every rank calls this with
        the same arguments) partitions the lanes over its dp ranks: each
        rank builds all lanes' draws as the one-device ensemble does and
        runs its own block of them, so lane i is lane i of the one-device
        ensemble; the lanes' results are gathered to every rank, which
        picks the same winner. No other collective."""
        if mesh is None:
            lanes = slice(0, n_plans)
        else:
            from mfgp_tpu_torch.parallel.mesh import DP_AXIS, axis_size

            dp = axis_size(mesh, DP_AXIS)
            if n_plans % dp:
                raise ValueError(f"n_plans={n_plans} must be a multiple of "
                                 f"the mesh dp extent {dp} (the lanes "
                                 "shard over dp)")
            b = n_plans // dp
            i = mesh.get_local_rank(DP_AXIS)
            lanes = slice(i * b, (i + 1) * b)
        draws = self._lane_draws(draws, seed, n_plans)
        x0r = np.repeat(np.asarray(x0, float).reshape(1, 2), n_plans, 0)
        x0t, Bt, eidt, gpt = self._args(x0r[lanes], B, eid, gp)
        st = self._to_host(self._run(x0t, Bt, eidt, gpt, draws[lanes]))
        if mesh is not None:
            from mfgp_tpu_torch.parallel.mesh import gather_lanes

            st = gather_lanes(mesh, st)
        i = int(np.lexsort((st["best_budget"], -st["best_score"]))[0])
        return self._extract(st, i)

    def plan_batch(self, x0s, seeds=None, Bs=None, eid=None, gp=None,
                   draws=None) -> list[DevicePlanResult]:
        """K INDEPENDENT (start, seed, budget) planner lanes in one loop,
        the fleet-serving form of :meth:`plan_ensemble`: concurrent replan
        requests against the same model (shared ``eid``/``gp``). Lane k
        draws from a generator seeded with ``seeds[k]`` unless ``draws``
        (K, max_iter, draw_width) are given. The lanes are padded to the
        next power of two by repeating lane 0 (as the JAX package pads
        them), so a service of varying fleet sizes captures few widths."""
        x0s = np.atleast_2d(np.asarray(x0s, float))
        K = x0s.shape[0]
        if draws is None:
            if seeds is None or len(seeds) != K:
                raise ValueError("seeds must align with x0s")
            draws = torch.cat([self.draws(torch.Generator().manual_seed(
                int(s)), 1) for s in seeds])
        draws = self._lane_draws(draws, 0, K)
        Bs = np.broadcast_to(np.asarray(self.B if Bs is None else Bs,
                                        float).reshape(-1), (K,))
        idx = np.zeros(1 << (K - 1).bit_length(), np.int64)
        idx[:K] = np.arange(K)
        x0t, Bt, eidt, gpt = self._args(x0s[idx], Bs[idx], eid, gp)
        st = self._to_host(self._run(x0t, Bt, eidt, gpt,
                                     draws[torch.as_tensor(idx)]))
        return [self._extract(st, i) for i in range(K)]

    _HOST_KEYS = ("best_arena", "best_score", "best_budget", "n_nodes",
                  "n_feas", "nodes", "a_prev", "a_edge", "a_budget",
                  "a_time", "a_score", "a_node", "edge_pts", "edge_prims",
                  "edge_src", "edge_dst", "node_paths")

    def _to_host(self, st) -> dict:
        """The state's result arrays on the host: one copy of all lanes
        (carries are working state and stay on the device)."""
        flat = [st[k].reshape(st[k].shape[0], -1).double()
                for k in self._HOST_KEYS]
        sizes = [t.shape[1] for t in flat]
        host = torch.cat(flat, dim=1).cpu().numpy()
        out, o = {}, 0
        for k, n in zip(self._HOST_KEYS, sizes):
            a = host[:, o:o + n].reshape(st[k].shape)
            out[k] = (a.astype(np.int64) if not st[k].dtype.is_floating_point
                      else a.astype(np.float64))
            o += n
        return out

    def _extract(self, st, lane: int) -> DevicePlanResult:
        s = {k: v[lane] for k, v in st.items()}
        best = int(s["best_arena"])
        n_nodes = int(s["n_nodes"])
        n_feas = int(s["n_feas"])
        all_nodes = s["nodes"]
        nodes = all_nodes[:n_nodes]
        a_prev, a_edge = s["a_prev"], s["a_edge"]
        edge_pts, edge_prims = s["edge_pts"], s["edge_prims"]
        edge_src, edge_dst = s["edge_src"], s["edge_dst"]
        # admitted-extension chronology from the arena: entries with a
        # real backing edge, in arena (= insertion) order; the arena block
        # index encodes the planning iteration
        kept = np.nonzero(a_edge >= 0)[0]
        eids = a_edge[kept]
        its = (kept - 1) // ((1 + self.K) * self.max_paths)
        trace = np.column_stack([
            its.astype(float),
            all_nodes[edge_src[eids]], all_nodes[edge_dst[eids]],
            eids.astype(float)]) if kept.size else np.zeros((0, 6))
        if best < 0:
            return DevicePlanResult(-np.inf, 0.0, 0.0, np.zeros((0, 4)),
                                    n_nodes, nodes, [],
                                    n_feasible_edges=n_feas, trace=trace,
                                    chain=[])
        chain, arena = [], []
        i = best
        while i > 0:
            arena.append(i)
            chain.append(int(a_edge[i]))
            i = int(a_prev[i])
        chain.reverse()
        arena.reverse()
        rows, edges, t_off = [], [], 0.0
        for e in chain:
            pts = edge_pts[e].copy()
            pts[:, 3] += t_off
            t_off = pts[-1, 3]
            rows.append(pts)
            edges.append((edge_prims[e], all_nodes[edge_src[e]],
                          all_nodes[edge_dst[e]]))
        points = np.concatenate(rows, axis=0) if rows else np.zeros((0, 4))
        return DevicePlanResult(
            float(s["best_score"]), float(s["a_budget"][best]),
            float(s["a_time"][best]), points, n_nodes, nodes, edges,
            truncated=False, n_feasible_edges=n_feas, trace=trace,
            chain=[0] + arena)


def _leaves(tree):
    """The tensors of nested dicts / tuples / lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _shapes(tree) -> tuple:
    """What a captured iteration depends on besides tensor values: every
    leaf's shape and dtype, and the other values of the dicts."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _shapes(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(v) for v in tree)
    return tree


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def _copy_into(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _pad_state(X, L, n_max: int):
    n, D = X.shape
    if n > n_max:
        raise ValueError(f"train size {n} exceeds n_max={n_max}")
    X_pad = X.new_full((n_max, D), 1e6)
    X_pad[:n] = X
    L_pad = torch.eye(n_max, dtype=L.dtype, device=L.device)
    L_pad[:n, :n] = L
    return X_pad, L_pad


def prepare_sf_gain_state(model, n_max: int, dtype=None):
    """Pad a conditioned single-fidelity GP to a STATIC train size for the
    device planner's gain scoring.

    Dummy rows sit at a far sentinel coordinate (kernel values underflow
    to 0, so cross-covariances to them vanish) and the factor is extended
    block-diagonally with the identity: the padded posterior equals the
    real one exactly. Returns (X_pad, L_pad, variance, lengthscales,
    noise), on the model's device, for ``DeviceRIG.plan(gp=...)``.
    """
    st = model.state
    dtype = dtype or st.X.dtype
    X_pad, L_pad = _pad_state(st.X.to(dtype), st.L.detach().to(dtype),
                              n_max)
    p = model.params
    return (X_pad, L_pad) + tuple(t.detach().to(dtype) for t in (
        p.variance, p.lengthscales, p.noise))


def prepare_mf_gain_state(model, fid_levels, n_max: int, dtype=None):
    """MF counterpart of prepare_sf_gain_state: pad the conditioned AR1
    multi-fidelity GP to a static train size. Returns (X_pad, fid_pad,
    L_pad, variances, lengthscales, rhos, noises, fid_levels) for
    ``DeviceRIG(cost="mf_gain").plan(gp=...)``."""
    st = model.state
    dtype = dtype or st.X.dtype
    X_pad, L_pad = _pad_state(st.X.to(dtype), st.L.detach().to(dtype),
                              n_max)
    fid_pad = torch.zeros(n_max, dtype=torch.long, device=st.X.device)
    fid_pad[:st.X.shape[0]] = st.fid.long()
    p = model.params
    F = int(p.variances.shape[0])
    fl = np.asarray(fid_levels, float)
    if fl.shape[0] < F - 1:  # host fids_from_variance raises too
        raise ValueError(
            f"need {F - 1} fidelity thresholds, got {fl.shape[0]}")
    return ((X_pad, fid_pad, L_pad) + tuple(t.detach().to(dtype) for t in (
        p.variances, p.lengthscales, p.rhos, p.noises))
            + (torch.as_tensor(fl[:F - 1], dtype=dtype, device=st.X.device),))


class DeviceRIGAdapter:
    """The host RIGPlanner's sim-facing surface (``plan(x0)`` /
    ``best_path_points`` / ``graph_summary`` / ``flight_plan``) over a
    DeviceRIG, so ``sim.ExplorationSim(planner_backend="device")`` swaps
    the whole planning loop onto the device. One instance serves every
    replan: budget tranche, EID and seed are per-plan arguments.
    ``plan_draws(seed, lanes)``, when given, supplies each plan's draws
    (lanes, max_iter, draw_width) instead of the planner's generator."""

    def __init__(self, seed: int = 0, n_plans: int = 1, plan_draws=None,
                 mesh=None, **kw):
        self._planner = DeviceRIG(**kw)
        self._seed = seed
        self._n_plans = int(n_plans)
        self._plan_draws = plan_draws
        self._mesh = mesh
        self._res: Optional[DevicePlanResult] = None

    def plan(self, x0, seed: int | None = None, B=None, eid=None,
             gp=None):
        seed = self._seed if seed is None else seed
        draws = (None if self._plan_draws is None
                 else self._plan_draws(seed, self._n_plans))
        x0r = np.asarray(x0, float).reshape(-1)
        if self._n_plans > 1:
            self._res = self._planner.plan_ensemble(
                x0r, seed, n_plans=self._n_plans, B=B, eid=eid, gp=gp,
                draws=draws, mesh=self._mesh)
        else:
            self._res = self._planner.plan(x0r, seed, B=B, eid=eid, gp=gp,
                                           draws=draws)
        r = self._res

        class _Best:
            info = r.info
            budget = r.budget
            segments = r.points if r.points.shape[0] else None

        return _Best()

    def plan_batch(self, x0s, seeds, Bs, eid=None,
                   gp=None) -> list[DevicePlanResult]:
        """Independent per-request plans as lanes of one loop (see
        DeviceRIG.plan_batch). Stateless: does NOT update the
        ``best_path_points``/``graph_summary`` cache."""
        if self._n_plans > 1:
            raise ValueError("plan_batch is for single-plan services; "
                             "n_plans>1 ensembles already batch")
        return self._planner.plan_batch(x0s, list(seeds), Bs, eid=eid,
                                        gp=gp)

    def best_path_points(self, dense: bool = True):
        if self._res is None or self._res.points.shape[0] == 0:
            return None
        return self._res.points  # (P, 4) x, y, z, t: the sim's schema

    def flight_plan(self):
        """(waypoints, legs) of the best plan for the robot runtime, the
        device-planner counterpart of hw.runtime.flight_plan: per-edge
        primitives are rolled out on the host and rotated by the edge
        bearing (reference pathPoints/edgeChain, reference/...MFEGP.py:
        449-461)."""
        from mfgp_tpu_torch.hw.runtime import chain_to_flight_plan
        from mfgp_tpu_torch.planning.primitives_device import padded_to_prims

        if self._res is None or not self._res.edges:
            return None, None
        triples = [(padded_to_prims(p), src, dst)
                   for p, src, dst in self._res.edges]
        return chain_to_flight_plan(triples, self._planner.cfg)

    def graph_summary(self):
        return {"nodes": self._res.n_nodes if self._res else 0,
                # feasible candidate edges admitted to the graph, counted
                # in the loop (NOT launch capacity)
                "edges": (self._res.n_feasible_edges if self._res else 0),
                "best_info": self._res.info if self._res else -np.inf,
                "best_budget": self._res.budget if self._res else 0.0}
