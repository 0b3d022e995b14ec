"""Plain reference of a mission's model-side answers, from the mission
configuration and the rows the mission harvested. Imports nothing of the
program; the AR1 algebra is ``reference/gp.py``'s, in float64.

What it recomputes:

* the sim field (a weighted sum of radial sources,
  ``f(x) = sum_i L exp(-(s |(x - p_i) o w|)^2)``, sources at fractions of
  the workspace), at the harvested true positions and on the test grid;
* the EID each replan planned on: the posterior on the EID grid given the
  start's dummy observation and every row harvested before that replan,
  ``softmax(alpha mu + (1 - alpha) sqrt|var|)`` (uniform where a variance
  is negative);
* the ergodic cost of the path each replan chose, from its flown points
  and the reference's EID: the trapezoid time-integral over the path of a
  Gaussian sensor density N(grid; x(t), sensor_var I) on the EID grid,
  over the path's duration, against the EID, both floored at their least
  positive entry (at most 1e-15) where they hold a zero and normalized;
  the score is -KL(path || EID);
* the final posterior on the test grid given every row, and its RMSE
  against the field;
* the rows themselves, against what the configuration states: each
  measurement against the field at its true position and the stated
  measurement noise, and each estimated position against its true one
  and the variance bound of its fidelity bin (the filter's stated noise).

The rows (estimated position, measurement, fidelity bin) are the
program's: the reference follows the mission from them, replan by replan,
once the last two checks have held them to the truth.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gp as ref


def field(cfg: dict, x) -> np.ndarray:
    f = cfg["field"]
    ws, depth = np.asarray(cfg["workspace"]["WS"], float), \
        cfg["workspace"]["max_depth"]
    scale = np.array([ws[0, 1], ws[1, 1], depth])
    p = np.asarray(f["sources_frac"], float) * scale
    x = np.atleast_2d(np.asarray(x, float))
    d = f["s"] * np.linalg.norm((x[:, None, :] - p[None]) * np.asarray(
        f["w"], float), axis=2)
    return np.sum(f["L"] * np.exp(-d ** 2), axis=1)


def _grid(cfg: dict, order: str) -> np.ndarray:
    ws = cfg["workspace"]["WS"]
    nums = cfg["eid"]["grid"]
    specs = [(ws[0][0], ws[0][1], nums[0]), (ws[1][0], ws[1][1], nums[1]),
             (0.0, cfg["workspace"]["max_depth"], nums[2])]
    g = np.meshgrid(*[np.linspace(a, b, n) for a, b, n in specs])
    return np.array([x.ravel(order) for x in g]).T


def eid_grid(cfg: dict) -> np.ndarray:
    """The EID grid (meshgrid over x, y, depth; C ravel)."""
    return _grid(cfg, "C")


def test_grid(cfg: dict) -> np.ndarray:
    """The RMSE's test points (the same meshgrid, Fortran ravel)."""
    return _grid(cfg, "F")


def fid_levels(cfg: dict) -> np.ndarray:
    """The fidelity bins' bounds on the filter's mean x-y position
    variance: ``(min workspace span * frac) ** 2``; bin b < F holds the
    rows under bound b - 1."""
    ws = np.asarray(cfg["workspace"]["WS"], float)
    span = float(np.min(ws[:, 1] - ws[:, 0]))
    return (span * np.asarray(cfg["fid_levels_frac"], float)) ** 2


def start_xy(cfg: dict) -> np.ndarray:
    ws = np.asarray(cfg["workspace"]["WS"], float)
    return ws[:, 0] + cfg["start_frac"] * (ws[:, 1] - ws[:, 0])


def _posterior(cfg, X, y, fid, P, device):
    """Posterior mean and variance (with the top fidelity's noise) at P."""
    th = cfg["theta0"]
    F = len(th["variances"])
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt,
                                                    device=device)
    Xt, ft, yt = t(X), t(fid, torch.long), t(y)
    L, alpha, _ = ref.factor(Xt, ft, yt, th, cfg["kernel"], cfg["jitter"])
    Pt = t(P)
    fs = torch.full((Pt.shape[0],), F - 1, dtype=torch.long, device=device)
    mu, var = ref.predict(L, alpha, Xt, ft, th, cfg["kernel"], Pt, fs)
    return mu.cpu().numpy(), var.cpu().numpy()


def eid(cfg: dict, mu, var) -> np.ndarray:
    if np.any(var < 0):
        return np.full_like(mu, 1.0 / mu.shape[0])
    a = cfg["eid"]["alpha"]
    z = a * mu + (1.0 - a) * np.sqrt(np.abs(var))
    e = np.exp(z - z.max())
    return e / e.sum()


def _floored(q: np.ndarray) -> np.ndarray:
    if np.any(q == 0):
        q = q + min(q[q > 0].min(), 1e-15)
    return q / q.sum()


def path_score(cfg: dict, pts: np.ndarray, e: np.ndarray) -> float:
    """-KL(path statistics || EID) of a path's (x, y, z, t) rows."""
    G = eid_grid(cfg)
    var = cfg["ergodic"]["sensor_var"]
    t = pts[:, 3]
    w = np.zeros_like(t)
    w[:-1] += 0.5 * np.diff(t)
    w[1:] += 0.5 * np.diff(t)
    quad = np.sum((G[:, None, :] - pts[None, :, :3]) ** 2, axis=2) / var
    dens = np.exp(-0.5 * quad) / np.sqrt((2 * np.pi * var) ** 3)
    p = _floored(dens @ w / (t[-1] - t[0]))
    r = _floored(e)
    return -float(np.sum(np.where(p > 0, p * (np.log(p) - np.log(r)), 0.0)))


def check(cfg: dict, out: dict, device) -> dict:
    """The numbers of one mission (``out``: its host arrays ``rows``
    (t, true position, estimated position, measurement, fidelity bin),
    ``flown`` and ``flown_mask`` (each replan's path points), ``info`` (the
    planner's score of each replan's path, NaN where it did not fly),
    ``eids``, ``test_mu``, ``test_var``, ``rmse``,
    ``budget_used``, ``theta``):

    * ``eid_rel``: max over replans of max |eid - eid_ref| / max eid_ref;
    * ``score_rel``: max over the replans that flew of |score - score_ref|
      / |score_ref|, the planner's score of its chosen path against the
      reference's ergodic cost of the same path;
    * ``mean_rel``, ``var_rel``: the final test posterior, max |x - x_ref|
      / max |x_ref|;
    * ``rmse_rel``: |rmse - rmse_ref| / rmse_ref;
    * ``meas_z``: the largest measurement deviation from the field at the
      true position, in units of the stated noise (a measurement clamped
      at 0 counts the field value);
    * ``pos_z``: the largest x-y error of an estimated position against
      its true one, sqrt(|e_xy|^2 / (2 bound)), in units of the variance
      bound of its fidelity bin, over the rows of the bins that have one
      (the top bin's variance is unbounded);
    * ``budget_over``: budget used beyond the stated budget;
    * ``theta_moved``: the largest change of the frozen log
      hyperparameters.
    """
    rows = out["rows"]
    sigma = cfg["workspace"]["meas_noise"]
    f_pos = field(cfg, rows[:, 1:4])
    meas = rows[:, 7]
    z = np.where(meas > 0, np.abs(meas - f_pos), np.maximum(f_pos, 0.0))
    F = len(cfg["theta0"]["variances"])
    b = rows[:, 8].astype(int)
    held = b < F
    e2 = np.sum((rows[held, 4:6] - rows[held, 1:3]) ** 2, axis=1)
    bound = fid_levels(cfg)[b[held] - 1]
    pos_z = float(np.sqrt(np.max(e2 / (2.0 * bound)))) if e2.size else 0.0
    x0 = np.concatenate([start_xy(cfg), [0.0]])
    X = np.vstack([x0[None], rows[:, 4:7]])
    y = np.concatenate([[0.0], meas])
    fid = np.concatenate([[F - 1], F - rows[:, 8].astype(int)])
    per = out["flown_mask"][:, 1:].sum(1)
    G = eid_grid(cfg)
    eid_rel = score_rel = 0.0
    seen = 1
    for r in range(per.shape[0]):
        mu, var = _posterior(cfg, X[:seen], y[:seen], fid[:seen], G, device)
        e_ref = eid(cfg, mu, var)
        # np.maximum, not max: a NaN reading stays NaN and fails
        eid_rel = float(np.maximum(
            eid_rel, np.max(np.abs(out["eids"][r] - e_ref)) / np.max(e_ref)))
        if np.isfinite(out["info"][r]):
            ref_s = path_score(cfg, out["flown"][r][out["flown_mask"][r]],
                               e_ref)
            score_rel = float(np.maximum(
                score_rel, abs(out["info"][r] - ref_s) / abs(ref_s)))
        seen += int(per[r])
    T = test_grid(cfg)
    mu, var = _posterior(cfg, X, y, fid, T, device)
    rmse_ref = float(np.sqrt(np.mean((mu - field(cfg, T)) ** 2)))
    theta0 = np.concatenate([np.log(np.asarray(cfg["theta0"][k], float))
                             .reshape(-1) for k in
                             ("variances", "lengthscales", "noises")])
    return dict(
        eid_rel=eid_rel, score_rel=score_rel,
        mean_rel=float(np.max(np.abs(out["test_mu"] - mu))
                       / np.max(np.abs(mu))),
        var_rel=float(np.max(np.abs(out["test_var"] - var))
                      / np.max(np.abs(var))),
        rmse_rel=abs(out["rmse"] - rmse_ref) / rmse_ref,
        meas_z=float(np.max(z / sigma)) if z.size else 0.0,
        pos_z=pos_z,
        budget_over=float(np.maximum(0.0, out["budget_used"] - cfg["B"])),
        theta_moved=float(np.max(np.abs(out["theta"] - theta0))))
