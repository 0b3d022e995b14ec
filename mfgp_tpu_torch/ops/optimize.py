"""Hyperparameter optimizers (counterpart of ``mfgp_tpu/ops/optimize.py``).

* :func:`scipy_lbfgsb`: scipy's L-BFGS-B on the host, one evaluation of a
  torch value-and-gradient closure per step (bounds supported). Used for
  single-model fits.
* :func:`batched_lbfgs`: projected L-BFGS with box bounds over an explicit
  restart axis. The JAX package runs its single-lane loop under
  ``jax.vmap``; a vmapped ``while_loop`` keeps iterating every lane and
  throws away the evaluations of the lanes that are done. Here the state
  carries the restart axis itself, with per-lane iteration counts,
  convergence flags and line-search masks, and the objective is evaluated
  only on the lanes still active: one lane at a time (one NLML at
  N=20,000 holds several N x N buffers; R of them at once would not fit),
  or, given a lane-batched evaluator, every active lane in one call (the
  batched study's datasets x restarts at N ~ 700). Lane by lane the
  iterates are those of the vmapped loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def scipy_lbfgsb(value_and_grad: Callable, x0, bounds=None,
                 maxiter: int = 1000):
    """Minimise with scipy L-BFGS-B; ``value_and_grad`` maps a float64
    numpy vector to ``(float, numpy gradient)``.

    Returns (x_opt, f_opt, n_evals). A non-finite value becomes a 1e20
    penalty with a zero gradient, and non-finite gradient entries are
    clamped, as in the JAX package (the reference's ``safe_obj``,
    reference/NIGP.py:119-123).
    """
    from scipy.optimize import minimize

    n_evals = 0

    def f_np(x):
        nonlocal n_evals
        n_evals += 1
        v, g = value_and_grad(x)
        v = float(v)
        g = np.asarray(g, dtype=np.float64)
        if not np.isfinite(v):
            return 1e20, np.zeros_like(g)
        return v, np.nan_to_num(g, nan=0.0, posinf=1e10, neginf=-1e10)

    res = minimize(f_np, np.asarray(x0, np.float64), jac=True,
                   method="L-BFGS-B", bounds=bounds,
                   options={"maxiter": maxiter})
    return res.x, float(res.fun), n_evals


def _autograd_lane(fun: Callable) -> Callable:
    """``(value, gradient)`` of a torch scalar function of one parameter
    vector, by autograd."""
    def vg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = fun(x)
            g, = torch.autograd.grad(v, x)
        return v.detach(), g
    return vg


def autograd_value_and_grad(fun: Callable, dtype, device) -> Callable:
    """A :func:`scipy_lbfgsb` closure from a torch scalar function of one
    parameter vector, differentiated by autograd in ``dtype`` on
    ``device``."""
    vg = _autograd_lane(fun)

    def vg_np(x):
        v, g = vg(torch.tensor(x, dtype=dtype, device=device))
        return float(v), g.cpu().double().numpy()
    return vg_np


def restart_inits(x0: torch.Tensor, n_restarts: int, spread: float,
                  seed: int) -> torch.Tensor:
    """(n_restarts, n) starting points: row 0 is ``x0``, the others add
    ``spread`` times standard normal draws from a CPU ``torch.Generator``
    seeded with ``seed``, so a seed repeats on every device."""
    gen = torch.Generator().manual_seed(seed)
    draws = torch.randn((n_restarts, x0.shape[0]), generator=gen,
                        dtype=torch.float64)
    inits = x0[None, :] + spread * draws.to(x0)
    inits[0] = x0
    return inits


def penalize_nonfinite(v: torch.Tensor, g: torch.Tensor):
    """A non-finite value becomes 1e20 with a zero gradient, and non-finite
    gradient entries become zero (the restart fits' guard, so a wild trial
    is rejected by the line search instead of poisoning the lane). ``v``
    may be a vector of lanes and ``g`` their (lanes, n) gradients: each
    lane is penalised alone."""
    bad = ~torch.isfinite(v)
    bad_g = bad.reshape(bad.shape + (1,) * (g.dim() - bad.dim()))
    return (torch.where(bad, 1e20, v),
            torch.where(bad_g | ~torch.isfinite(g), 0.0, g))


class LBFGSState(NamedTuple):
    """Per-lane state: R lanes, n parameters, history depth m."""

    x: torch.Tensor  # (R, n)
    f: torch.Tensor  # (R,)
    g: torch.Tensor  # (R, n)
    s_hist: torch.Tensor  # (R, m, n) ring buffers
    y_hist: torch.Tensor  # (R, m, n)
    rho: torch.Tensor  # (R, m)
    k: torch.Tensor  # (R,) iteration counts
    converged: torch.Tensor  # (R,) bool


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _two_loop(g, s_hist, y_hist, rho, k, m: int):
    """The L-BFGS two-loop recursion over each lane's ring buffer: ``g``
    (r, n), histories (r, m, n), ``rho`` (r, m), ``k`` (r,)."""
    lanes = torch.arange(g.shape[0], device=g.device)
    used = torch.clamp(k, max=m)
    q = g
    alphas = torch.zeros_like(rho)
    for i in range(m):
        idx = (k - 1 - i) % m
        valid = i < used
        a = torch.where(valid, rho[lanes, idx] * _dot(s_hist[lanes, idx], q),
                        0.0)
        q = q - a[:, None] * y_hist[lanes, idx] * valid[:, None]
        alphas[lanes, idx] = a
    # initial Hessian scaling gamma = s.y / y.y from the most recent pair
    last = (k - 1) % m
    sy = _dot(s_hist[lanes, last], y_hist[lanes, last])
    yy = _dot(y_hist[lanes, last], y_hist[lanes, last])
    gamma = torch.where(k > 0, sy / torch.clamp(yy, min=1e-30), 1.0)
    r = gamma[:, None] * q
    for i in range(m):
        idx = (k - used + i) % m
        valid = i < used
        b = rho[lanes, idx] * _dot(y_hist[lanes, idx], r)
        r = r + ((alphas[lanes, idx] - b)[:, None] * s_hist[lanes, idx]
                 * valid[:, None])
    return r


def _per_lane(vg: Callable) -> Callable:
    """A one-lane ``vg(x) -> (value, (n,) gradient)`` as a lane evaluator
    that calls it on each lane in turn."""
    def evaluate(lanes, xs):
        fs, gs = zip(*(vg(x) for x in xs))
        return torch.stack(fs), torch.stack(gs)
    return evaluate


def batched_lbfgs(
    fun: Callable | None,
    x0: torch.Tensor,
    lower: torch.Tensor | None = None,
    upper: torch.Tensor | None = None,
    maxiter: int = 200,
    m: int = 10,
    tol: float = 1e-6,
    max_ls: int = 20,
    value_and_grad: Callable | None = None,
    ftol: float = 0.0,
    value_and_grad_lanes: Callable | None = None,
):
    """Projected L-BFGS with a backtracking Armijo line search, over R
    restart lanes at once.

    ``x0`` is (R, n). ``fun`` maps one lane's (n,) vector to a scalar and
    is differentiated by autograd, unless ``value_and_grad`` (one lane's
    ``(value, (n,) gradient)``, e.g. the analytic NLML gradient) is given,
    or ``value_and_grad_lanes``: ``(lane_idx (r,), xs (r, n)) -> (f (r,),
    g (r, n))`` for the lanes ``lane_idx`` at once, called once per round
    on every lane that round evaluates (each lane may then be its own
    problem: ``lane_idx`` says which). Bounds (n,) are enforced by
    projecting each trial point. Returns ``(x (R, n), f (R,), k (R,))``,
    ``k`` each lane's iteration count. Choosing the active lanes costs one
    host sync per round, not one per lane.

    A lane stops when its largest gradient entry is below ``tol``, when its
    line search fails (it then keeps its point), at ``maxiter``, or, with
    ``ftol > 0``, when an accepted step decreases f by no more than
    ``ftol * max(1, |f|)`` (scipy's ``factr``-style stagnation stop, which
    ends straggling lanes).
    """
    R, n = x0.shape
    lower = (torch.full((n,), -torch.inf, dtype=x0.dtype, device=x0.device)
             if lower is None else lower)
    upper = (torch.full((n,), torch.inf, dtype=x0.dtype, device=x0.device)
             if upper is None else upper)
    evaluate = value_and_grad_lanes or _per_lane(
        value_and_grad or _autograd_lane(fun))

    def clip(x):
        return torch.minimum(torch.maximum(x, lower), upper)

    x = clip(x0)
    f, g = evaluate(torch.arange(R, device=x0.device), x)
    st = LBFGSState(
        x=x, f=f, g=g,
        s_hist=x0.new_zeros((R, m, n)), y_hist=x0.new_zeros((R, m, n)),
        rho=x0.new_zeros((R, m)),
        k=torch.zeros(R, dtype=torch.long, device=x0.device),
        converged=torch.zeros(R, dtype=torch.bool, device=x0.device))

    while True:
        act = ((st.k < maxiter) & ~st.converged).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        x, f, g, k = st.x[act], st.f[act], st.g[act], st.k[act]
        d = -_two_loop(g, st.s_hist[act], st.y_hist[act], st.rho[act], k, m)
        # ensure descent; fall back to steepest descent
        d = torch.where((_dot(d, g) < 0)[:, None], d, -g)

        # backtracking line search; a lane leaves it at its first accepted
        # trial, and all lanes still searching are at the same trial number
        t = torch.where(
            k == 0,
            torch.clamp(1.0 / torch.clamp(torch.linalg.vector_norm(g, dim=1),
                                          min=1e-12), max=1.0),
            1.0)
        xn = clip(x + t[:, None] * d)
        fn, gn = evaluate(act, xn)
        ok = (fn <= f + 1e-4 * _dot(g, xn - x)) & torch.isfinite(fn)
        for _ in range(1, max_ls):
            search = (~ok).nonzero().squeeze(1)
            if search.numel() == 0:
                break
            t[search] = t[search] * 0.5
            xt = clip(x[search] + t[search, None] * d[search])
            ft, gt = evaluate(act[search], xt)
            xn[search], fn[search], gn[search] = xt, ft, gt
            ok[search] = ((ft <= f[search] + 1e-4 * _dot(g[search],
                                                         xt - x[search]))
                          & torch.isfinite(ft))
        # a lane whose line search failed keeps its point and stops
        fail = ~ok
        xn = torch.where(fail[:, None], x, xn)
        fn = torch.where(fail, f, fn)
        gn = torch.where(fail[:, None], g, gn)

        s, yv = xn - x, gn - g
        sy = _dot(s, yv)
        idx = k % m
        good = sy > 1e-10
        s_hist, y_hist, rho = st.s_hist, st.y_hist, st.rho
        s_hist[act, idx] = torch.where(good[:, None], s, s_hist[act, idx])
        y_hist[act, idx] = torch.where(good[:, None], yv, y_hist[act, idx])
        rho[act, idx] = torch.where(good, 1.0 / torch.clamp(sy, min=1e-30),
                                    rho[act, idx])
        converged = (torch.amax(torch.abs(gn), dim=1) < tol) | fail
        if ftol > 0.0:
            converged = converged | ((f - fn) <= ftol * torch.clamp(
                torch.abs(f), min=1.0))
        st.x[act], st.f[act], st.g[act] = xn, fn, gn
        st.k[act] = k + 1
        st.converged[act] = converged
    return st.x, st.f, st.k
