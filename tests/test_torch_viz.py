"""Parity of the port's replay tools (``mfgp_tpu_torch.viz``) with
``mfgp_tpu.viz`` on the CPU, and every figure function of the port.

``replay_grid`` rebuilds the four model families from a GP dataset and its
hyperparameter files and predicts a grid: both packages read the same
files and agree to 1e-10 (float64). Each ``plot_*`` takes the port's
objects (the host ``RIGPlanner``, a ``DevicePlanResult``, the dict of
``run_campaign``) and writes a non-empty PNG; ``cli plot`` and ``campaign
--plot`` run.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mfgp_tpu import viz as jviz
from mfgp_tpu_torch import cli, viz
from mfgp_tpu_torch.data.io import GPDATA_HEADER, Table, save_hyp_vector
from mfgp_tpu_torch.utils.configs import SimConfig

CPU = "cpu"
BASE = "GPData_0.2_fieldMeas_0_T0_0"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread per test worker (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A 40-row GPData CSV in the simulator's box and the four families'
    hyperparameter files (the trainers' artifact names)."""
    d = tmp_path_factory.mktemp("replay")
    g = np.random.default_rng(0)
    n = 40
    X = g.uniform(0, 1, (n, 3)) * [10, 20, 10]
    rows = np.column_stack([np.arange(n, dtype=float), X,
                            X + 0.05 * g.standard_normal((n, 3)),
                            np.sin(X[:, 0]) + 0.1 * X[:, 1],
                            g.integers(1, 4, n).astype(float)])
    path = d / f"{BASE}.csv"
    Table(GPDATA_HEADER.split(","), rows).save(str(path))
    hyps = {"emuGP": np.r_[1.2, 2.0, 3.0, 2.5, 0.8, 2.5, 3.5, 2.0, 0.5,
                           3.0, 4.0, 2.2, 1.0, 1.0, 0.03, 0.02, 0.01],
            "sfGP": np.r_[1.2, 2.0, 3.0, 2.5, 0.05],
            "sfGPTP": np.r_[1.1, 2.2, 3.1, 2.4, 0.04],
            "nisfGP": np.r_[0.1, 0.2, 0.1, 1.1, 0.2, 2.0, 3.0, 2.5]}
    for name, v in hyps.items():
        save_hyp_vector(str(d / f"{BASE}_{name}.txt"), v,
                        row=name == "emuGP")
    return str(path), str(d)


def test_replay_grid_matches_jax(artifacts):
    path, hyp_dir = artifacts
    tp = SimConfig().test_points()[::40]
    got = viz.replay_grid(path, hyp_dir, tp, device=CPU)
    ref = jviz.replay_grid(path, hyp_dir, tp)
    assert set(got) == set(ref) == {"mf", "sf", "sfTP", "nisf"}
    for key in ref:
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10,
                                       atol=1e-10)


def test_replay_models_skip_missing_files(artifacts, tmp_path):
    path, hyp_dir = artifacts
    os.symlink(os.path.join(hyp_dir, f"{BASE}_sfGP.txt"),
               tmp_path / f"{BASE}_sfGP.txt")
    ds, models = viz.replay_models(path, str(tmp_path), device=CPU)
    assert set(models) == {"sf"} and ds.n == 40
    assert models["sf"].X.device.type == "cpu"


def png(p) -> bool:
    with open(p, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n" and os.path.getsize(p) > 1000


def test_field_gpres_csv_and_error_figures(tmp_path):
    grid = SimConfig().test_points()
    g = np.random.default_rng(1)
    assert png(viz.plot_field_slices(grid, g.random(grid.shape[0]),
                                     str(tmp_path / "slices.png")))
    res = tmp_path / "GPRes.csv"
    np.savetxt(res, np.column_stack([grid[:50], g.random((50, 5))]),
               delimiter=",", header="x,y,z,trueField,sfMean,sfVar,mfMean,"
               "mfVar", comments="")
    assert png(viz.plot_gpres(str(res), str(tmp_path / "gpres.png")))
    rows = [{"RMSE mf": 1.0 + v, "RMSE sf": 2.0, "RMSE nisf": 1.5,
             "RMSE sfTP": 1.8, "velVariance": v}
            for v in (0.0, 0.1, 0.2) for _ in range(3)]
    assert png(viz.plot_average_errors(rows, str(tmp_path / "avg.png")))
    csv = tmp_path / "r.csv"
    csv.write_text("filename,RMSE sf,T\nMSE_a.txt,1.5,0\nMSE_b.txt,2.5,1\n")
    assert png(viz.plot_csv(str(csv), str(tmp_path / "csv.png"), x="T",
                            y=["RMSE sf"], kind="scatter"))
    camp = {v: {"rmse": list(g.uniform(1, 2, 3))}
            for v in ("MFEGP", "MFGP", "SFEGP", "SFGP")}
    assert png(viz.plot_campaign(camp, str(tmp_path / "camp.png")))


def test_planner_figures_host_and_device(tmp_path):
    """The host RIGPlanner's graph, its 3-D path and animation, and a
    DevicePlanResult's plan and animation."""
    from mfgp_tpu_torch.planning.primitives import AgentConfig
    from mfgp_tpu_torch.planning.rig import RIGPlanner
    from mfgp_tpu_torch.planning.rig_device import DeviceRIG

    ws = np.array([[0, 10], [0, 20]])
    p = RIGPlanner(cfg=AgentConfig.sim_defaults(), delta=10, B=150, WS=ws,
                   R=1.25, Rd=5, same_node_distance=1, max_iter=25, seed=3,
                   env=lambda pts: np.ones(len(pts)))
    p.plan(np.array([[0.5], [0.5]]))
    assert png(viz.plot_planner_graph(p, str(tmp_path / "graph.png")))
    pts = p.best_path_points(dense=True)
    assert png(viz.plot_path_3d(pts, str(tmp_path / "p3d.png"),
                                max_depth=10))
    frames = viz.plot_plan_animation(p, ws, str(tmp_path / "anim"),
                                     n_frames=3)
    assert len(frames) == 2 and all(map(png, frames))

    sim = SimConfig()
    grid = SimConfig().test_points()[::20]
    rig = DeviceRIG(sim.agent(), delta=sim.step_size, B=15.0, WS=sim.WS,
                    R=sim.near_rad, Rd=sim.Rd, max_iter=8, grid=grid,
                    eid=np.full(grid.shape[0], 1.0 / grid.shape[0]),
                    device=CPU)
    res = rig.plan(np.array([3.0, 5.0]), seed=0)
    assert res.points.shape[0] > 0
    assert png(viz.plot_device_plan(res, sim.WS, str(tmp_path / "dev.png")))
    frames = viz.plot_plan_animation(res, sim.WS, str(tmp_path / "danim"),
                                     n_frames=3)
    assert len(frames) == 2 and all(map(png, frames))


def run_cli(argv) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_plot_and_campaign_plot(tmp_path, artifacts):
    path, _ = artifacts
    out = run_cli(["plot", path, "--out", str(tmp_path / "p.png"), "--x",
                   "t", "--y", "fieldVal", "4"])
    assert png(out["figure"])
    out = run_cli(["--cpu", "campaign", "--variants", "SFGP", "--seeds", "2",
                   "--budget", "8", "--bd", "1", "--plan-iters", "4",
                   "--e-max", "4", "--plot", str(tmp_path / "c.png")])
    assert png(out["plot"]) and out["runs"] == 2
