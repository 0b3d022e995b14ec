"""The studies: the end-to-end sweep (§3.5) and the training-set-size
study (C22); counterpart of ``mfgp_tpu/data/study.py``.

The reference's simulation study is four scripts run by hand over a
ground-truth trajectory CSV. ``run_study`` runs it end to end:

  for each (trajectory seed x velocity-noise level):
      1. a scripted reference curve -> ground-truth trajectory
      2. pipeline: KF estimates -> field measurements -> fidelity binning
      3. trainers: fit {MFGP, SFGP, SFGP-TP, NIGP}, RMSE/WMSE
      4. aggregate -> results.csv + summary

reproducing the reference's 10 x 3 x 3 study design
(reference/resultParser.py:44-55) at any scale. With
``fit_mode="device-batched"`` step 3 runs once for the whole matrix, every
dataset a lane of one batch per model family (``data.study_batched``).
Trajectories from a closed-loop exploration run wait for their module.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from mfgp_tpu_torch.data.aggregate import collect_results, summary
from mfgp_tpu_torch.data.io import Table
from mfgp_tpu_torch.data.pipeline import (generate_estimates_batch,
                                          run_pipeline)
from mfgp_tpu_torch.data.study_batched import process_datasets_batched
from mfgp_tpu_torch.data.trainers import (F64_KEY, _check_fit_mode,
                                          process_dataset)
from mfgp_tpu_torch.fields.wrbf import (WRBFField, default_sim_field,
                                        random_field)
from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.utils.configs import SimConfig
from mfgp_tpu_torch.utils.device import CUDA


# -- training-set-size study (SURVEY C22, reference/HowManyPoints.py:62-109)

def grid_samples(WS, max_depth, nums=(8, 16, 8)) -> np.ndarray:
    """The reference's 8x16x8 grid-sampled candidate training set."""
    axes = [np.linspace(WS[0][0], WS[0][1], nums[0]),
            np.linspace(WS[1][0], WS[1][1], nums[1]),
            np.linspace(0.0, max_depth, nums[2])]
    g = np.meshgrid(*axes)
    return np.array([a.ravel() for a in g]).T


def training_size_study(sizes: Sequence[int], cfg: SimConfig | None = None,
                        field: WRBFField | None = None, noise: float = 0.125,
                        seed: int = 0, optimize: bool = True,
                        restarts: int = 4, device=CUDA):
    """RMSE on the sim test grid vs number of training points.

    Returns a list of dicts {n, rmse, nlml}. Training points are drawn
    without replacement from the dense candidate grid (matching the
    reference's random grid subset), targets from the WRBF field + noise.
    """
    cfg = cfg or SimConfig()
    field = field or default_sim_field(cfg.WS, cfg.max_depth, device=device)
    rng = np.random.default_rng(seed)
    cand = grid_samples(cfg.WS, cfg.max_depth)
    y_cand = field.numpy(cand)
    y_cand = y_cand + noise * rng.standard_normal(y_cand.shape[0])
    tp = cfg.test_points()
    f_true = field.numpy(tp)

    out = []
    for n in sizes:
        idx = rng.choice(cand.shape[0], size=min(n, cand.shape[0]),
                         replace=False)
        gp = GP(cand[idx], y_cand[idx], jitter=1e-6, device=device)
        if optimize:
            gp.optimize_restarts(n_restarts=restarts, maxiter=150,
                                 seed=seed)
        mu, _ = gp.predict(tp)
        rmse = float(np.sqrt(np.mean((mu.cpu().numpy() - f_true) ** 2)))
        out.append({"n": int(len(idx)), "rmse": rmse,
                    "nlml": -gp.log_likelihood()})
    return out


# -- end-to-end sweep ----------------------------------------------------------


def scripted_trajectory(seed: int, cfg: SimConfig, duration: float = 1200.0,
                        dt: float = 0.1) -> Table:
    """A smooth seeded survey trajectory over the workspace (stand-in for a
    full closed-loop flight when speed matters)."""
    rng = np.random.default_rng(seed)
    t = np.arange(0.0, duration, dt)
    xs, ys = cfg.WS[0][1], cfg.WS[1][1]
    f1, f2, f3 = rng.uniform(1 / 600, 1 / 200, 3)
    ph = rng.uniform(0, 2 * np.pi, 3)
    x = xs * (0.5 + 0.4 * np.sin(2 * np.pi * f1 * t + ph[0]))
    y = ys * (0.5 + 0.4 * np.sin(2 * np.pi * f2 * t + ph[1]))
    z = np.clip(cfg.max_depth * (0.55 + 0.5 * np.sin(
        2 * np.pi * f3 * t + ph[2])) - 0.1 * cfg.max_depth, 0.0, None)
    return Table(["t", "x", "y", "z"], np.column_stack([t, x, y, z]))


def closed_loop_trajectory(seed: int, cfg: SimConfig, budget: float = 30.0,
                           plan_iters: int = 10, device=CUDA,
                           kf_noise=None) -> Table:
    """Ground-truth trajectory from an actual closed-loop exploration run
    (the missing generator of the reference's mfgpSimSimp.csv): the SFEGP
    variant on ``device`` (its model in float32 on the card, float64 on the
    CPU); ``kf_noise`` goes to ``ExplorationSim`` (the filter's draws)."""
    from mfgp_tpu_torch.sim import ExplorationSim
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    exp = ExperimentConfig(sim=cfg, multi_fidelity=False, ergodic=True,
                           B=budget, BD=3)
    sim = ExplorationSim(exp, seed=seed, plan_iters=plan_iters,
                         device=device, kf_noise=kf_noise)
    res = sim.run()
    est = res.estimates
    if est.shape[0] < 10:
        return scripted_trajectory(seed, cfg)
    return Table(["t", "x", "y", "z"], est[:, :4])


def run_study(out_dir: str, traj_seeds=(0, 1), vmn_levels=(0.0, 0.2),
              field_seeds=(0,), cfg: SimConfig | None = None,
              closed_loop: bool = False, optimize: bool = True,
              duration: float = 1200.0, fit_mode: str = "scipy",
              dtype=None, device=CUDA, filter_noises=None,
              timings: dict | None = None, fit_chunk: int = 8,
              eval_chunk: int = 8, ftol: float = 1e-6):
    """The full sweep. Returns the aggregate summary dict; writes the
    reference's artifact tree under ``out_dir``.

    ``fit_mode="device-batched"``: the whole matrix is staged first
    (pipeline per run), then every dataset is fitted and evaluated in one
    ``process_datasets_batched`` call, as lanes of one batch per model
    family, ``fit_chunk`` / ``eval_chunk`` datasets per call; ``ftol`` is
    its restart lanes' stagnation stop (0.0 restores the per-dataset fits'
    pure max|g| < tol criterion). ``closed_loop``: each trajectory is a
    closed-loop exploration run's (``closed_loop_trajectory`` on
    ``device``) instead of a scripted one.
    ``filter_noises`` maps ``(field seed, vmn)`` to the per-trajectory
    standard normal draws of the filter's measurement noise
    (``generate_estimates_batch``'s ``noises``) in place of the seeded
    generator's. ``timings``, when given, collects the seconds of each
    stage (filter, pipeline, trainers, aggregate), under
    ``"wmse_f64_count"`` the number of WMSE metrics redone in float64, and
    with ``device-batched`` under ``"batched"`` the sweeps' per-family
    statistics (``process_datasets_batched``'s ``stats``). The summary
    gains nothing beyond the JAX package's.
    """
    import time

    _check_fit_mode(fit_mode, batched=True)
    batched = fit_mode == "device-batched"
    staged: list[tuple[str, str]] = []
    base_cfg = cfg or SimConfig()
    os.makedirs(out_dir, exist_ok=True)
    res_dir = os.path.join(out_dir, "GPResults")
    os.makedirs(res_dir, exist_ok=True)
    timings = timings if timings is not None else {}
    for k in ("filter_s", "pipeline_s", "trainers_s", "aggregate_s",
              F64_KEY):
        timings.setdefault(k, 0)
    clock = time.perf_counter

    for fseed in field_seeds:
        frng = np.random.default_rng(1000 + fseed)
        field = random_field(frng, base_cfg.WS, base_cfg.max_depth,
                             device=device)
        traj_cfg = SimConfig(seed=fseed, vmn=0.0)
        trajs = [(closed_loop_trajectory(tseed, traj_cfg, device=device)
                  if closed_loop
                  else scripted_trajectory(tseed, traj_cfg,
                                           duration=duration))
                 for tseed in traj_seeds]
        for vmn in vmn_levels:
            run_cfg = SimConfig(seed=fseed, vmn=vmn)
            # stage 1 for the whole trajectory sweep in one batched loop
            t0 = clock()
            ests = generate_estimates_batch(
                trajs, run_cfg, seeds=[fseed] * len(trajs),
                noises=(filter_noises or {}).get((fseed, vmn)),
                device=device)
            timings["filter_s"] += clock() - t0
            for tseed, traj, est in zip(traj_seeds, trajs, ests):
                name = f"T{tseed}_{vmn:g}"
                t0 = clock()
                run_pipeline(traj, run_cfg, out_dir=out_dir, traj_name=name,
                             field=field, est=est,
                             field_rng=np.random.default_rng(
                                 7 * tseed + fseed))
                timings["pipeline_s"] += clock() - t0
                ds_name = (f"GPData_{run_cfg.meas_rate:g}_fieldMeas_"
                           f"{fseed}_{name}.csv")
                gpdata_path = os.path.join(out_dir, "GPDataSets", ds_name)
                settings_path = os.path.join(out_dir, "FieldData",
                                             f"FieldSettings{fseed}.txt")
                if batched:
                    staged.append((gpdata_path, settings_path))
                    continue
                t0 = clock()
                _, metrics = process_dataset(
                    gpdata_path, settings_path,
                    out_dir=res_dir, cfg=run_cfg, optimize=optimize,
                    fit_mode=fit_mode,
                    dtype=dtype if dtype is not None else np.float64,
                    device=device)
                timings["trainers_s"] += clock() - t0
                timings[F64_KEY] += metrics[F64_KEY]

    if batched:
        # the evaluation's settings (test grid, t_cut, WMSE normalisation)
        # are the same in every (seed, vmn) config of the matrix
        t0 = clock()
        res = process_datasets_batched(
            [p for p, _ in staged], [s for _, s in staged], out_dir=res_dir,
            cfg=base_cfg,
            dtype=dtype if dtype is not None else np.float32,
            verbose=True, fit_chunk=fit_chunk, eval_chunk=eval_chunk,
            ftol=ftol, device=device,
            stats=timings.setdefault("batched", {}))
        timings["trainers_s"] += clock() - t0
        timings[F64_KEY] += sum(m[F64_KEY] for m in res.values())

    t0 = clock()
    rows = collect_results(os.path.join(res_dir, "MSE_*.txt"),
                           os.path.join(res_dir, "results.csv"))
    rep = summary(rows)
    timings["aggregate_s"] += clock() - t0
    return rep
