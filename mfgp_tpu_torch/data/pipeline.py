"""Offline data pipeline: trajectory -> KF estimates -> field measurements
-> fidelity-binned GP datasets (SURVEY C16-C18; counterpart of
``mfgp_tpu/data/pipeline.py``).

The reference runs three scripts with per-row Python loops
(reference/trajectoryEstimateGenerator.py, measFieldData.py, prepGPData.py);
here:

* estimates: the batched Kalman filter
  (``estimation.kalman.filter_trajectory``), one loop for a whole sweep of
  trajectories, on the card unless the caller asks for the CPU
* measurements: one batched WRBF field evaluation + host noise
* binning: vectorized downsample + fidelity thresholding on the host

Stages read/write the reference's CSV schemas (``data.io``), so the port's
artifacts, the JAX package's and the reference's are interchangeable at
every pipeline boundary.
"""

from __future__ import annotations

import os

import numpy as np

from mfgp_tpu_torch.data.io import (EST_HEADER, FIELD_HEADER, GPDATA_HEADER,
                                    Table)
from mfgp_tpu_torch.estimation.kalman import KFModel, filter_trajectory
from mfgp_tpu_torch.fields.wrbf import (WRBFField, random_field,
                                        write_field_settings)
from mfgp_tpu_torch.utils.configs import SimConfig
from mfgp_tpu_torch.utils.device import CUDA


def _cut(traj: Table, t_cut: float):
    """(t, pos) up to the cutoff. The reference breaks before writing a row
    with t > t_cut (reference/trajectoryEstimateGenerator.py:54-55): every
    output row satisfies t <= t_cut, so exactly that many rows are kept (+1
    for the filter's finite-difference lookahead)."""
    t = traj.col("t")
    pos = traj.cols("x", "y", "z")
    n_keep = int(np.searchsorted(t, t_cut, side="right"))
    return t[: n_keep + 1], pos[: n_keep + 1]


def _est_table(out, i=None, n=None) -> Table:
    """The filter's columns (of trajectory ``i`` cut to ``n`` rows when
    batched) as an estimates Table on the host."""
    def col(k):
        v = out[k] if i is None else out[k][i][:n]
        return v.detach().cpu().numpy()

    return Table(EST_HEADER.split(","), np.column_stack(
        [col(k) for k in ("t", "pos", "xh", "sig", "err")]))


def generate_estimates(traj: Table, cfg: SimConfig, seed: int | None = None,
                       t_cut: float = 3600.0, noise=None,
                       device=CUDA) -> Table:
    """KF-estimate a ground-truth trajectory (stage 1, C16).

    traj columns must include t,x,y,z. Returns the reference's
    ``T<seed>_<vmn>.csv`` schema. ``noise``: standard normal draws (T-1, 6)
    for the simulated measurements instead of the seeded generator's
    (``filter_trajectory``)."""
    seed = cfg.seed if seed is None else seed
    t, pos = _cut(traj, t_cut)
    out = filter_trajectory(cfg.kf_model(device=device), t, pos, seed=seed,
                            noise=noise)
    return _est_table(out)


def generate_estimates_batch(trajs, cfg: SimConfig, seeds=None,
                             t_cut: float = 3600.0, noises=None,
                             device=CUDA):
    """Batched stage 1: one filter loop for a whole sweep.

    The reference runs its 10-trajectory x 3-noise study one file at a time
    (reference/trajectoryEstimateGenerator.py); here every trajectory's KF
    shares the loop's steps on a leading batch axis. Variable lengths are
    padded to the longest (positions repeat the last row with a constant
    dt tail) and outputs are truncated per trajectory.

    trajs: list of Tables with t/x/y/z columns. Each trajectory draws its
    measurement noise from its own seed (``seeds``, default ``cfg.seed +
    i``), as :func:`generate_estimates` does, or takes ``noises[i]`` (T_i-1,
    6). Returns a list of estimate Tables matching
    :func:`generate_estimates` row for row."""
    import torch

    seeds = seeds if seeds is not None else [cfg.seed + i
                                             for i in range(len(trajs))]
    model = cfg.kf_model(device=device)

    cuts = [_cut(traj, t_cut) for traj in trajs]
    lengths = [t.shape[0] for t, _ in cuts]
    T = max(lengths)
    tpad = np.zeros((len(trajs), T))
    ppad = np.zeros((len(trajs), T, 3))
    draws = torch.zeros((len(trajs), T - 1, 6), dtype=torch.float64)
    for i, (t, pos) in enumerate(cuts):
        n = t.shape[0]
        tpad[i, :n] = t
        ppad[i, :n] = pos
        if n < T:  # constant-dt tail keeps the filter's divisions finite
            dt = t[-1] - t[-2] if n >= 2 else 1.0
            tpad[i, n:] = t[-1] + dt * np.arange(1, T - n + 1)
            ppad[i, n:] = pos[-1]
        if noises is not None:
            draws[i, :n - 1] = torch.as_tensor(np.asarray(noises[i]),
                                               dtype=torch.float64)
        else:
            gen = torch.Generator().manual_seed(int(seeds[i]))
            draws[i, :n - 1] = torch.randn((n - 1, 6), generator=gen,
                                           dtype=torch.float64)

    out = filter_trajectory(model, tpad, ppad, noise=draws)
    return [_est_table(out, i, n - 1) for i, n in enumerate(lengths)]


def generate_field_measurements(est: Table, field: WRBFField,
                                cfg: SimConfig, rng: np.random.Generator
                                ) -> Table:
    """Sample the field along the (true) trajectory + noise (stage 2, C17).

    One batched field evaluation; the clamp-at-zero matches
    ``max(0, f + eps)`` (reference/measFieldData.py:70)."""
    pos = est.cols("x", "y", "z")
    vals = field.numpy(pos)
    noisy = np.maximum(0.0, vals + cfg.meas_noise * rng.standard_normal(
        vals.shape[0]))
    cols = np.column_stack([est.col("t"), pos, noisy])
    return Table(FIELD_HEADER.split(","), cols)


def bin_fidelity(est: Table, meas: Table, cfg: SimConfig) -> Table:
    """Downsample to ``meas_rate`` and label fidelity by localization
    covariance (stage 3, C18; reference/prepGPData.py:50-69).

    Reference semantics preserved exactly: the sample clock compares row
    j-1's time against the last *accepted* sample (a sequential dependency,
    computed with a tiny host loop over the boolean decision only), the
    covariance is read from row j while positions come from row j-1, and
    ``covComp = 0.5 (sigx + sigy)``."""
    t = est.col("t")
    lev1, lev2, _ = cfg.fidlevels
    period = 1.0 / cfg.meas_rate

    # sequential accept clock (reference/prepGPData.py:56-59)
    accept = np.zeros(t.shape[0], bool)
    last = t[0]
    for j in range(1, t.shape[0]):
        if t[j - 1] - last > period:
            last = t[j - 1]
            accept[j] = True
    idx = np.nonzero(accept)[0]

    cov_comp = 0.5 * (est.col("sigx")[idx] + est.col("sigy")[idx])
    fid = np.where(cov_comp < lev1, 1, np.where(cov_comp < lev2, 2, 3))
    jm1 = idx - 1
    cols = np.column_stack([
        t[jm1], est.cols("x", "y", "z")[jm1], est.cols("xh", "yh", "zh")[jm1],
        meas.col("fieldVal")[jm1], fid.astype(float),
    ])
    return Table(GPDATA_HEADER.split(","), cols)


def write_run_settings(path: str, cfg: SimConfig, origin: str = ""):
    """``T<seed>_<vmn>Settings.txt`` provenance artifact: ground-truth
    origin, seed, measurement-noise vector, and the KF matrices, the
    reference's per-run settings dump
    (reference/trajectoryEstimateGenerator.py:16-43). Host values only."""
    model = cfg.kf_model(device="cpu")
    A = KFModel.A(cfg.dt, device="cpu").numpy()
    with open(path, "w") as f:
        f.write(f"Groundtruth Origin: {origin}\n")
        f.write(f"Random Seed: {cfg.seed}\n")
        f.write("Meas Noise:\n "
                + str(np.asarray(cfg.kf_meas_noise).reshape(-1, 1)) + "\n")
        f.write(f"KF A({cfg.dt}) Matrix:\n {A}\n")
        f.write("KF B Matrix:\n 0\n")
        f.write(f"KF Pinit Matrix:\n {model.P0.numpy()}\n")
        f.write(f"KF Q Matrix:\n {model.Q.numpy()}\n")
        f.write(f"KF R Matrix:\n {model.R.numpy()}\n")


def run_pipeline(traj: Table, cfg: SimConfig, out_dir: str | None = None,
                 traj_name: str | None = None, field: WRBFField | None = None,
                 field_rng: np.random.Generator | None = None,
                 est: Table | None = None, device=CUDA):
    """Full stage 1-3 sweep for one ground-truth trajectory.

    Returns (estimates, measurements, gp_data, field). When ``out_dir`` is
    given, writes the reference's directory layout:
    ``T<seed>_<vmn>.csv``, ``FieldData/fieldMeas_<seed>_<name>.csv``,
    ``FieldData/FieldSettings<seed>.txt``,
    ``GPDataSets/GPData_<rate>_fieldMeas_<seed>_<name>.csv``.

    ``est`` short-circuits stage 1 with precomputed estimates (the study
    sweep filters all of its trajectories in one batched loop,
    generate_estimates_batch). ``device`` is where stage 1 and a field
    drawn here live."""
    name = traj_name or f"T{cfg.seed}_{cfg.vmn:g}"
    if est is None:
        est = generate_estimates(traj, cfg, device=device)
    if field is None:
        rng = field_rng or np.random.default_rng(cfg.seed)
        xmax = max(10.0, est.col("x").max())
        ymax = max(20.0, est.col("y").max())
        zmax = max(10.0, est.col("z").max())
        field = random_field(rng, [[0, xmax], [0, ymax]], zmax,
                             device=device)
    rng_meas = field_rng or np.random.default_rng(cfg.seed + 1)
    meas = generate_field_measurements(est, field, cfg, rng_meas)
    gp_data = bin_fidelity(est, meas, cfg)

    if out_dir is not None:
        os.makedirs(os.path.join(out_dir, "FieldData"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "GPDataSets"), exist_ok=True)
        write_run_settings(os.path.join(out_dir, name + "Settings.txt"),
                           cfg, origin=getattr(traj, "origin", "<in-memory>"))
        est.save(os.path.join(out_dir, name + ".csv"))
        meas.save(os.path.join(
            out_dir, "FieldData", f"fieldMeas_{cfg.seed}_{name}.csv"))
        write_field_settings(
            os.path.join(out_dir, "FieldData", f"FieldSettings{cfg.seed}.txt"),
            field, meas_noise=cfg.meas_noise)
        gp_data.save(os.path.join(
            out_dir, "GPDataSets",
            f"GPData_{cfg.meas_rate:g}_fieldMeas_{cfg.seed}_{name}.csv"))
    return est, meas, gp_data, field
