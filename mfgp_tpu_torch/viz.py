"""Replay and plotting tools (SURVEY C27; counterpart of
``mfgp_tpu/viz.py``).

The reference resurrects models purely from saved hyperparameter CSVs plus
data pointers and re-predicts grids for figures
(reference/MFplottingData.py:17,58-60; reference/SFplottingData.py:32-33),
bar-plots aggregated errors (reference/plottingAverageErrors.py), and ships
a tkinter CSV plotter (reference/dataPlotter.py; GUI deliberately not
ported, SURVEY §7; its capability survives as :func:`plot_csv`).

All figure functions render headless (Agg) and write PNGs; matplotlib is
imported on a figure function's first call, never with the module. They
take the port's objects: the host ``RIGPlanner``, a ``DevicePlanResult``,
the dict that ``run_campaign`` returns.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from mfgp_tpu_torch.data.io import load_gp_dataset, load_hyp_vector
from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.models.mfgp import MFGP
from mfgp_tpu_torch.models.nigp import NIGP
from mfgp_tpu_torch.utils.device import CUDA


# ---------------------------------------------------------------------------
# Model replay from artifacts
# ---------------------------------------------------------------------------
def replay_models(gpdata_path: str, hyp_dir: str, kernel: str = "rbf",
                  jitter: float = 1e-6, device=CUDA):
    """Rebuild the four trained models of one run from its artifacts (no
    optimization, exactly the reference's plot-script pattern) on
    ``device``, the card unless the caller asks for the CPU.

    Looks for ``<base>_emuGP.txt / _sfGP.txt / _sfGPTP.txt / _nisfGP.txt``
    next to the dataset (the GPTrainers artifact family). Missing files
    yield no entry."""
    ds = load_gp_dataset(gpdata_path)
    base = os.path.basename(gpdata_path).replace(".csv", "_")

    def hyp(name):
        p = os.path.join(hyp_dir, base + name + ".txt")
        return load_hyp_vector(p) if os.path.exists(p) else None

    out = {}
    v = hyp("emuGP")
    if v is not None:
        Xs, ys = ds.fidelity_lists(use_estimates=True)
        m = MFGP.from_fidelity_lists(Xs, ys, kernel=kernel, jitter=jitter,
                                     device=device)
        m.set_param_array(v)
        out["mf"] = m
    v = hyp("sfGP")
    if v is not None:
        m = GP(ds.X_est, ds.y, kernel=kernel, jitter=jitter, device=device)
        m.set_param_array(v)
        out["sf"] = m
    v = hyp("sfGPTP")
    if v is not None:
        m = GP(ds.X_true, ds.y, kernel=kernel, jitter=jitter, device=device)
        m.set_param_array(v)
        out["sfTP"] = m
    v = hyp("nisfGP")
    if v is not None:
        D = ds.X_est.shape[1]
        m = NIGP(device=device)
        m.sigma_x_ = v[:D]
        m.sigma_f_ = float(v[D])
        m.sigma_y_ = float(v[D + 1])
        m.lengthscales_ = v[D + 2:]
        m._set_data(ds.X_est, ds.y)
        m.noise_diag_train_ = None
        out["nisf"] = m
    return ds, out


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a).reshape(-1)


def replay_grid(gpdata_path: str, hyp_dir: str, test_points: np.ndarray,
                kernel: str = "rbf", device=CUDA):
    """Re-predict the evaluation grid from saved artifacts -> dict of
    (mean, var) numpy arrays per available model."""
    _, models = replay_models(gpdata_path, hyp_dir, kernel=kernel,
                              device=device)
    grids = {}
    for key, m in models.items():
        mu, var = m.predict(np.asarray(test_points))
        grids[key] = (_host(mu), _host(var))
    return grids


# ---------------------------------------------------------------------------
# Figures
# ---------------------------------------------------------------------------
def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_field_slices(grid: np.ndarray, values: np.ndarray, out_png: str,
                      n_slices: int = 4, title: str = ""):
    """Depth-slice heatmaps of a scalar field over the 3D grid (the
    reference's per-plan EID/posterior figures)."""
    plt = _plt()
    zs = np.unique(grid[:, 2])
    pick = zs[np.linspace(0, len(zs) - 1, min(n_slices, len(zs))).astype(int)]
    fig, axes = plt.subplots(1, len(pick), figsize=(4 * len(pick), 3.6),
                             squeeze=False)
    for ax, z in zip(axes[0], pick):
        m = np.isclose(grid[:, 2], z)
        sc = ax.tricontourf(grid[m, 0], grid[m, 1], values[m], levels=20)
        ax.set_title(f"{title} z={z:.2f}")
        fig.colorbar(sc, ax=ax)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def plot_gpres(gpres_csv: str, out_png: str):
    """Posterior-vs-truth scatter from a GPRes artifact (ours or the
    reference's; header x,y,z,trueField,sfMean,sfVar,mfMean,mfVar)."""
    plt = _plt()
    d = np.loadtxt(gpres_csv, delimiter=",", skiprows=1)
    f_true, sf, mf = d[:, 3], d[:, 4], d[:, 6]
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    for ax, (name, mu) in zip(axes, [("SFGP", sf), ("MFGP", mf)]):
        ax.scatter(f_true, mu, s=4, alpha=0.4)
        lo, hi = f_true.min(), f_true.max()
        ax.plot([lo, hi], [lo, hi], "k--", lw=1)
        rmse = np.sqrt(np.mean((mu - f_true) ** 2))
        ax.set_title(f"{name}  RMSE={rmse:.3f}")
        ax.set_xlabel("true field")
        ax.set_ylabel("posterior mean")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def plot_average_errors(rows: Sequence[dict], out_png: str,
                        metrics: Optional[Sequence[str]] = None,
                        by: str = "velVariance"):
    """Grouped bar chart of mean metrics sliced by a run parameter
    (reference/plottingAverageErrors.py)."""
    from mfgp_tpu_torch.data.aggregate import METRICS, mean_metrics

    plt = _plt()
    metrics = list(metrics or METRICS[:4])
    groups = sorted({r.get(by) for r in rows} - {None})
    width = 0.8 / max(len(groups), 1)
    fig, ax = plt.subplots(figsize=(1.8 * len(metrics) + 2, 4))
    xs = np.arange(len(metrics))
    for gi, g in enumerate(groups):
        rep = mean_metrics(rows, {by: g})
        ax.bar(xs + gi * width, [rep[m] for m in metrics], width,
               label=f"{by}={g}")
    ax.set_xticks(xs + 0.4 - width / 2)
    ax.set_xticklabels(metrics, rotation=20)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def plot_planner_graph(planner, out_png: str, show_best: bool = True):
    """Planner graph figure: nodes, edges, and the best path — the headless
    equivalent of the reference's ``RIG.draw_graph`` / 2D projection
    (reference/GraceRIGV3.py:908-1063)."""
    plt = _plt()
    wx = planner.WS[0][1] - planner.WS[0][0]
    wy = planner.WS[1][1] - planner.WS[1][0]
    fig, ax = plt.subplots(figsize=(6, 6 * wy / max(wx, 1e-9)))
    for (i, j) in planner.E:
        if i in planner.V and j in planner.V:
            a, b = planner.V[i].state, planner.V[j].state
            ax.plot([a[0, 0], b[0, 0]], [a[1, 0], b[1, 0]],
                    color="0.8", lw=0.8, zorder=1)
    xs = [n.state[0, 0] for n in planner.V.values()]
    ys = [n.state[1, 0] for n in planner.V.values()]
    ax.scatter(xs, ys, s=14, color="C0", zorder=2)
    root = planner.V.get(planner.root_idx)
    if root is not None:
        ax.scatter([root.state[0, 0]], [root.state[1, 0]], s=60,
                   marker="*", color="C3", zorder=3, label="start")
    if show_best and planner.best_path.segments:
        pts = planner.best_path_points(dense=True)
        if pts is not None and pts.shape[0]:
            ax.plot(pts[:, 0], pts[:, 1], color="C1", lw=2, zorder=4,
                    label=f"best (info {planner.best_path.info:.3g})")
    ax.set_xlim(planner.WS[0])
    ax.set_ylim(planner.WS[1])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def plot_device_plan(result, WS, out_png: str):
    """2D figure for a DevicePlanResult (planning.rig_device): explored
    node set + the best path, the device-planner counterpart of
    plot_planner_graph (plot_path_3d takes result.points directly)."""
    plt = _plt()
    WS = np.asarray(WS, float)
    wx, wy = WS[0][1] - WS[0][0], WS[1][1] - WS[1][0]
    fig, ax = plt.subplots(figsize=(6, 6 * wy / max(wx, 1e-9)))
    ns = np.asarray(result.node_states)
    if ns.shape[0]:
        ax.scatter(ns[:, 0], ns[:, 1], s=14, color="C0", zorder=2)
        ax.scatter([ns[0, 0]], [ns[0, 1]], s=60, marker="*", color="C3",
                   zorder=3, label="start")
    p = np.asarray(result.points)
    if p.shape[0]:
        ax.plot(p[:, 0], p[:, 1], color="C1", lw=2, zorder=4,
                label=f"best (info {result.info:.3g})")
    ax.set_xlim(WS[0])
    ax.set_ylim(WS[1])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def plot_plan_animation(source, WS, out_dir: str, n_frames: int = 8,
                        show_best: bool = True) -> list:
    """PNG frame sequence of planner-graph growth, the headless
    counterpart of the reference's live planning animation
    (reference/GraceRIGV3.py:1213-1216, draw methods :908-1063).

    ``source``: a host ``RIGPlanner`` (frames are prefixes of its
    insertion-ordered edge list) or a ``DevicePlanResult`` (frames replay
    its ``trace`` chronology by planning iteration). Writes
    ``frame_000.png``... under ``out_dir`` and returns the paths.
    """
    plt = _plt()
    WS = np.asarray(WS, float).reshape(2, 2)
    os.makedirs(out_dir, exist_ok=True)

    if hasattr(source, "trace"):  # DevicePlanResult
        tr = np.asarray(source.trace if source.trace is not None
                        else np.zeros((0, 6)))
        # cut points: equal slices of the admitted-extension chronology
        cuts = np.linspace(0, tr.shape[0], max(n_frames, 2)).astype(int)
        segments = [tr[:c, 1:5] for c in cuts[1:]]
        nodes = np.asarray(source.node_states)
        best = (np.asarray(source.points)
                if show_best and source.points.shape[0] else None)
        info = source.info
    else:  # host RIGPlanner
        edges = [(np.asarray(source.V[i].state[:2, 0]),
                  np.asarray(source.V[j].state[:2, 0]))
                 for (i, j) in source.E
                 if i in source.V and j in source.V]
        seg_arr = (np.asarray([[a[0], a[1], b[0], b[1]]
                               for a, b in edges])
                   if edges else np.zeros((0, 4)))
        cuts = np.linspace(0, seg_arr.shape[0],
                           max(n_frames, 2)).astype(int)
        segments = [seg_arr[:c] for c in cuts[1:]]
        nodes = np.asarray([[n.state[0, 0], n.state[1, 0]]
                            for n in source.V.values()])
        best = None
        if show_best and source.best_path.segments:
            pts = source.best_path_points(dense=True)
            if pts is not None and pts.shape[0]:
                best = np.asarray(pts)
        info = source.best_path.info if source.best_path.segments else None

    wx, wy = WS[0, 1] - WS[0, 0], WS[1, 1] - WS[1, 0]
    paths = []
    for f, seg in enumerate(segments):
        fig, ax = plt.subplots(figsize=(6, 6 * wy / max(wx, 1e-9)))
        for row in seg:
            ax.plot([row[0], row[2]], [row[1], row[3]], color="0.8",
                    lw=0.8, zorder=1)
        ends = (np.unique(np.concatenate([seg[:, :2], seg[:, 2:4]]),
                          axis=0) if seg.shape[0] else nodes[:1])
        ax.scatter(ends[:, 0], ends[:, 1], s=14, color="C0", zorder=2)
        if nodes.shape[0]:
            ax.scatter([nodes[0, 0]], [nodes[0, 1]], s=60, marker="*",
                       color="C3", zorder=3, label="start")
        if f == len(segments) - 1 and best is not None:
            ax.plot(best[:, 0], best[:, 1], color="C1", lw=2, zorder=4,
                    label=f"best (info {info:.3g})")
        ax.set_xlim(WS[0])
        ax.set_ylim(WS[1])
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_title(f"frame {f + 1}/{len(segments)}: "
                     f"{seg.shape[0]} extensions")
        ax.legend(loc="best")
        fig.tight_layout()
        p = os.path.join(out_dir, f"frame_{f:03d}.png")
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_path_3d(path_points: np.ndarray, out_png: str, max_depth=None):
    """3D trajectory figure (depth axis inverted, diving down) — the
    reference's ``draw_3D_path`` (reference/GraceRIGV3.py:988-1063)."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(projection="3d")
    p = np.asarray(path_points)
    ax.plot(p[:, 0], p[:, 1], p[:, 2], color="C0")
    ax.scatter(p[0, 0], p[0, 1], p[0, 2], color="C3", marker="*", s=60)
    ax.invert_zaxis()
    if max_depth is not None:
        ax.set_zlim(max_depth, 0)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("depth")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def plot_csv(csv_path: str, out_png: str, x: str | int = 0,
             y: Sequence[str | int] = (1,), kind: str = "line",
             skiprows: int = 1):
    """Generic CSV column plotter — the capability of the reference's
    tkinter ``dataPlotter`` as a headless function/CLI."""
    plt = _plt()
    with open(csv_path) as f:
        header = f.readline().strip().lstrip("#").split(",")
    header = [h.strip() for h in header]

    def col(c):
        idx = header.index(c) if isinstance(c, str) else int(c)
        # per-column load so non-numeric columns elsewhere in the file
        # (e.g. results.csv's filename column) don't break parsing
        v = np.loadtxt(csv_path, delimiter=",", skiprows=skiprows,
                       usecols=[idx], ndmin=1)
        return v, (header[idx] if idx < len(header) else str(idx))

    xv, xname = col(x)
    fig, ax = plt.subplots(figsize=(7, 4))
    for c in y:
        yv, yname = col(c)
        if kind == "scatter":
            ax.scatter(xv, yv, s=4, label=yname)
        else:
            ax.plot(xv, yv, label=yname)
    ax.set_xlabel(xname)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def plot_campaign(campaign: dict, out_png: str):
    """Per-variant RMSE distributions of a mission campaign
    (sim.mission_device.run_campaign output) — the device-mission
    counterpart of plot_average_errors over the reference's
    results.csv aggregation (reference/averageErrors.py:56-85)."""
    plt = _plt()
    variants = list(campaign)
    fig, ax = plt.subplots(figsize=(1.6 * max(len(variants), 2) + 2, 4))
    data = [np.asarray(campaign[v]["rmse"], float) for v in variants]
    ax.boxplot(data, tick_labels=variants, showmeans=True)
    for i, d in enumerate(data):
        ax.plot(np.full(d.shape, i + 1) + 0.08, d, ".", color="C0",
                alpha=0.6)
    ax.set_ylabel("final-model RMSE on the sim grid")
    ax.set_title(f"mission campaign: {sum(len(d) for d in data)} runs")
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
