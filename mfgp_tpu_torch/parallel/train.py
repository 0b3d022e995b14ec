"""Multi-device training step: dp-sharded restarts and the mp-sharded grid
posterior (counterpart of ``mfgp_tpu/parallel/train.py``).

The "replan" unit of work of the reference's exploration loop (retrain the
GP, evaluate the posterior grid, reference/PhysicalExperimentCode/
GraceExplorationExperiments_MFEGP.py:358-483) over the (dp, mp) mesh:

* R hyperparameter restarts are lanes of the autodiff NLML (B1's lane axis
  on the card, ``ops.covariance.ar1_cov_diff``), sharded over dp: each dp
  rank advances its R/dp lanes with Adam and no collective,
* the best restart is a global argmin over dp: the losses are gathered and
  the winner's parameters broadcast from the rank that holds it; it is
  then conditioned and predicted on the mp-sharded grid rows.

The JAX package's optax Adam is written out here with optax's defaults
(``b1=0.9``, ``b2=0.999``, ``eps=1e-8``, ``eps_root=0``). The same
functions run on one device with a (1, 1) mesh.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.models import mfgp as _mf
from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.parallel.mesh import (DP_AXIS, MP_AXIS, all_gather,
                                          axis_size, broadcast,
                                          pad_to_multiple, shard_rows)
from mfgp_tpu_torch.parallel.sharded import _rows_sharded
from mfgp_tpu_torch.utils.device import CUDA, as_tensor_on

_LOG2PI = math.log(2.0 * math.pi)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the moments, each an
    ``MFGPParams`` shaped like the parameters."""

    count: int
    mu: _mf.MFGPParams
    nu: _mf.MFGPParams


class TrainState(NamedTuple):
    params: _mf.MFGPParams  # this rank's restarts on a leading axis (R/dp)
    opt_state: AdamState
    step: int


def adam_init(params: _mf.MFGPParams) -> AdamState:
    zeros = _mf.MFGPParams(*(torch.zeros_like(p) for p in params))
    return AdamState(0, zeros, _mf.MFGPParams(*(torch.zeros_like(p)
                                                for p in params)))


def adam_update(grads: _mf.MFGPParams, state: AdamState,
                params: _mf.MFGPParams, learning_rate: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of optax's ``adam(learning_rate)`` then ``apply_updates``:
    returns (params, state)."""
    count = state.count + 1
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * g ** 2 + b2 * v for g, v in zip(grads, state.nu)]
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = [p + -learning_rate * ((m / c1) / (torch.sqrt(v / c2) + eps))
           for p, m, v in zip(params, mu, nu)]
    return (_mf.MFGPParams(*new),
            AdamState(count, _mf.MFGPParams(*mu), _mf.MFGPParams(*nu)))


def init_restarts(generator: torch.Generator, n_restarts: int,
                  n_fidelities: int, D: int, dtype=torch.float32,
                  spread: float = 1.0, device=CUDA) -> _mf.MFGPParams:
    """Random log-space perturbations around the GPy-default init, drawn
    from ``generator`` (a CPU ``torch.Generator``; jax.random's stream
    cannot be reproduced) in the order log-variances, log-lengthscales,
    log-noises; the rhos stay at their default."""
    base = _mf.MFGPParams.default(n_fidelities, D, dtype)

    def jig(x):
        return x[None] + spread * torch.randn((n_restarts,) + x.shape,
                                              generator=generator,
                                              dtype=dtype)

    lv, ll, ln = (jig(base.log_variances), jig(base.log_lengthscales),
                  jig(base.log_noises))
    rhos = base.rhos.expand((n_restarts,) + base.rhos.shape).clone()
    return _mf.MFGPParams(*(t.to(device) for t in (lv, ll, rhos, ln)))


def train_state_from_numpy(params, mu, nu, count, step, mesh=None,
                           device=CUDA, dtype=torch.float64) -> TrainState:
    """The port's ``TrainState`` from the JAX package's: ``params``, ``mu``
    and ``nu`` the numpy leaves (log_variances, log_lengthscales, rhos,
    log_noises) of its ``TrainState.params`` and of optax's
    ``ScaleByAdamState`` (``opt_state[0]``), each with the restarts on the
    leading axis; ``count`` and ``step`` its scalars. With ``mesh`` the
    state is this rank's dp block of the restarts."""
    def block(leaves):
        p = _mf.params_from_numpy(*leaves, device, dtype)
        if mesh is None:
            return p
        return _mf.MFGPParams(*(shard_rows(mesh, t, DP_AXIS) for t in p))

    return TrainState(block(params), AdamState(int(count), block(mu),
                                               block(nu)), int(step))


def _nlml_lanes(params: _mf.MFGPParams, X, fid, y, kernel: str,
                jitter: float) -> torch.Tensor:
    """``models.mfgp.nlml`` of each lane of ``params`` (leading axis R) on
    the same data: the Grams by one launch of B1's lane axis on the card
    (``ops.covariance.ar1_cov_diff``), differentiable by autograd."""
    R = params.log_variances.shape[0]
    N = X.shape[0]
    Xl, fl, yl = X.expand(R, *X.shape), fid.expand(R, N), y.expand(R, N)
    K = _cov.ar1_cov_diff(params.variances, params.lengthscales,
                          params.rhos, Xl, fl, kernel)
    L = _la.chol(_la.diag_add(K, torch.gather(params.noises, -1, fl)
                              + jitter))
    alpha = _la.solve_posterior(L, yl)
    return (0.5 * torch.sum(yl * alpha, dim=-1)
            + 0.5 * _la.logdet_from_chol(L) + 0.5 * N * _LOG2PI)


class TrainStepFns(NamedTuple):
    """The sharded training-step bundle (see make_mfgp_train_step)."""

    init_fn: object
    step_fn: object  # full step: update + best-restart grid posterior
    loss_step_fn: object  # update only: (state, X, fid, y) -> state, losses
    prepare_grid: object


def make_mfgp_train_step(mesh, kernel: str = "rbf",
                         learning_rate: float = 0.05, jitter: float = 1e-6,
                         fix_rhos: bool = True) -> TrainStepFns:
    """Build the dp-sharded restart-batched MFGP fit functions.

    ``init_fn(generator, n_restarts, n_fidelities, D, dtype, device)``
    draws all restarts (``init_restarts``) and keeps this rank's dp block.
    ``loss_step_fn(state, X, fid, y) -> (state, losses)`` advances this
    rank's restarts one Adam step on the exact NLML (``losses`` are theirs,
    before the step). ``step_fn(state, X, fid, y, grid, grid_fid) ->
    (state, losses (R,), mu, var)`` does the same, gathers every rank's
    losses and returns the posterior of the best restart (its updated
    parameters) on the grid prepared by ``prepare_grid``, whole on every
    rank."""
    n_dp = axis_size(mesh, DP_AXIS)
    n_mp = axis_size(mesh, MP_AXIS)

    def init_fn(generator, n_restarts, n_fidelities, D, dtype=torch.float32,
                device=CUDA):
        if n_restarts % n_dp:
            raise ValueError(
                f"n_restarts={n_restarts} must be divisible by dp={n_dp}")
        params = init_restarts(generator, n_restarts, n_fidelities, D, dtype,
                               device=device)
        params = _mf.MFGPParams(*(shard_rows(mesh, p, DP_AXIS)
                                  for p in params))
        return TrainState(params, adam_init(params), 0)

    def _update(state: TrainState, X, fid, y):
        leaves = [p.detach().requires_grad_(True) for p in state.params]
        losses = _nlml_lanes(_mf.MFGPParams(*leaves), X, fid, y, kernel,
                             jitter)
        grads = torch.autograd.grad(losses.sum(), leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if fix_rhos:
            grads[2] = torch.zeros_like(grads[2])
        grads = _mf.MFGPParams(*(torch.nan_to_num(g) for g in grads))
        params, opt_state = adam_update(grads, state.opt_state,
                                        state.params, learning_rate)
        return TrainState(params, opt_state, state.step + 1), losses.detach()

    def step_fn(state: TrainState, X, fid, y, grid, grid_fid):
        state, losses = _update(state, X, fid, y)
        losses = all_gather(mesh, losses, DP_AXIS)
        best = best_restart(mesh, state, losses)
        gstate = _mf.condition(best, X, fid, y, kernel=kernel, jitter=jitter)
        mu, var = _rows_sharded(
            mesh, lambda g, gf: _mf.predict(best, gstate, g, gf,
                                            kernel=kernel), grid, grid_fid)
        return state, losses, mu, var

    def prepare_grid(grid, grid_fid=None, dtype=torch.float32,
                     n_fidelities: int = 3, device=CUDA):
        """Grid rows padded to a multiple of the mp extent, on the device,
        with (padded, fidelity labels, M). ``grid_fid=None`` is the HIGHEST
        fidelity (the reference predicts by appending fidelity 2,
        reference/GPTrainers.py:119)."""
        grid = np.asarray(grid)
        M = grid.shape[0]
        Mp = pad_to_multiple(M, n_mp)
        g = np.zeros((Mp, grid.shape[1]), dtype=grid.dtype)
        g[:M] = grid
        gf = np.full((Mp,), n_fidelities - 1, np.int64)
        if grid_fid is not None:
            gf[:M] = np.asarray(grid_fid)
        return (as_tensor_on(g, device).to(dtype), as_tensor_on(gf, device),
                M)

    return TrainStepFns(init_fn, step_fn, _update, prepare_grid)


def best_restart(mesh, state: TrainState, losses) -> _mf.MFGPParams:
    """The parameters of the restart with the least finite loss among
    ``losses`` (all R, in dp order), on every rank: broadcast over dp from
    the rank that holds that restart."""
    r = state.params.log_variances.shape[0]
    safe = torch.where(torch.isfinite(losses), losses, torch.inf)
    best = int(torch.argmin(safe))
    owner = best // r
    flat = torch.cat([p[best % r].reshape(-1) for p in state.params])
    if mesh.get_local_rank(DP_AXIS) != owner:
        flat = torch.empty_like(flat)
    flat = broadcast(mesh, flat, owner, DP_AXIS)
    out, o = [], 0
    for p in state.params:
        n = p[0].numel()
        out.append(flat[o:o + n].reshape(p.shape[1:]))
        o += n
    return _mf.MFGPParams(*out)


def fit_sharded(mesh, X, fid, y, grid, grid_fid=None, *,
                n_restarts: int | None = None, steps: int = 200,
                kernel: str = "rbf", learning_rate: float = 0.05,
                jitter: float = 1e-6, seed: int = 0, dtype=torch.float32,
                device=CUDA):
    """Restart-batched Adam fit and the final grid posterior. The restarts
    are drawn from a ``torch.Generator`` seeded with ``seed``. Returns
    (best_params, losses of the last step (R,), mu, var), whole on every
    rank."""
    n_dp = axis_size(mesh, DP_AXIS)
    if n_restarts is None:
        n_restarts = pad_to_multiple(max(8, n_dp), n_dp)
    fns = make_mfgp_train_step(mesh, kernel=kernel,
                               learning_rate=learning_rate, jitter=jitter)
    X = as_tensor_on(X, device).to(dtype)
    fid = as_tensor_on(fid, X.device).long()
    y = as_tensor_on(y, X.device).to(dtype)
    n_fidelities = int(fid.max()) + 1 if fid.numel() else 1
    gpad, gfpad, M = fns.prepare_grid(grid, grid_fid, dtype, n_fidelities,
                                      X.device)
    state = fns.init_fn(torch.Generator().manual_seed(int(seed)),
                        n_restarts, n_fidelities, X.shape[1], dtype,
                        X.device)
    # update-only steps, then one step with the best restart's posterior
    for _ in range(max(steps - 1, 0)):
        state, _ = fns.loss_step_fn(state, X, fid, y)
    state, losses, mu, var = fns.step_fn(state, X, fid, y, gpad, gfpad)
    return best_restart(mesh, state, losses), losses, mu[:M], var[:M]
