"""The port's mission paths beside the kinematic one: dynamic flight
(against ``mfgp_tpu.sim.mission_device`` under its draws, with and without
``glide_stride``), the ``mission`` / ``campaign`` commands, and the device
planner's per-lane model context that a mission ensemble plans on.

The closed loop amplifies rounding: JAX's and torch's transcendental
functions differ in the last bit, and in the runtime's loop that
difference doubles every ~1.5 s of flight (measured on a 147 s flight in
the default 10 m deep workspace: sample rows apart by 1e-14 at 10 s,
2e-11 at 28 s, 1e-7 at 43 s, 3e-2 at 68 s). So the dynamic missions fly
in a 1 m deep workspace on a budget (16, seed 5) whose one flight lasts
39 s, and every row of it, the tracking RMSE and the integrated energy
are held to 1e-8 (measured: 3e-13 and 2e-14).
"""

import json

import numpy as np
import pytest
import torch

from mfgp_tpu_torch import cli
from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.models.mfgp import MFGP
from mfgp_tpu_torch.planning.rig_device import (DeviceRIG,
                                                prepare_mf_gain_state,
                                                prepare_sf_gain_state)
from mfgp_tpu_torch.utils.configs import SimConfig
from test_torch_mission import both, exp_kw, rel

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's tensors here are small: one intra-op thread, so that the
    test workers sharing the machine's cores do not oversubscribe them
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dynamic(stride: int):
    return both(exp_kw(multi_fidelity=True, ergodic=True, B=16.0, BD=1), 5,
                sim=dict(max_depth=1.0), flight="dynamic", t_cap=400,
                glide_stride=stride)


@pytest.fixture(scope="module")
def dyn():
    return dynamic(1)


@pytest.fixture(scope="module")
def dyn_stride():
    return dynamic(2)


def assert_dynamic_close(got, ref):
    assert got.n_replans == ref.n_replans == 1
    for a, b in zip(got.replans, ref.replans):
        assert (a["nodes"], a["edges"]) == (b["nodes"], b["edges"])
        for k in ("info", "budget", "t_flown", "tracking_rmse",
                  "flown_budget"):
            assert a[k] == pytest.approx(b[k], rel=1e-8), k
        assert a["tracking_rmse"] > 0.01 and a["flown_budget"] > 0.01
    np.testing.assert_array_equal(got.flown_mask, ref.flown_mask)
    assert rel(got.flown, ref.flown) <= 1e-8
    assert rel(got.eids, ref.eids) <= 1e-8
    assert not got.meas_overflow and not ref.meas_overflow
    g, r = got.gp_data.data, ref.gp_data.data
    assert g.shape == r.shape and g.shape[0] >= 4
    assert rel(g, r) <= 1e-8
    # fidelity labels from the live position-KF covariance
    assert set(g[:, 8].astype(int)) <= {1, 2, 3}
    # estimated positions differ from the truth: real localization error
    assert np.abs(g[:, 4:7] - g[:, 1:4]).max() > 1e-4


def test_dynamic_mission_matches_jax(dyn):
    _, jr, tm, tr = dyn
    assert_dynamic_close(tr, jr)
    assert tm.rt.last_fly["windows"] <= tm.t_cap


def test_dynamic_glide_stride_matches_jax(dyn_stride):
    _, jr, tm, tr = dyn_stride
    assert_dynamic_close(tr, jr)
    s = tm.rt.last_fly
    assert s["coarse"] > 0 and s["windows"] == s["coarse"] + s["fine"] \
        + s["mixed"]


def test_dynamic_arena_equals_model_from_scratch(dyn):
    """The arena after a dynamic flight (rows on estimated positions)
    equals the port's MFGP conditioned from scratch on them."""
    _, _, tm, tr = dyn
    X, fid, y = tm.harvested(tr)
    X0 = np.array([[tm._x0[0], tm._x0[1], 0.0]])
    mf = MFGP.from_fidelity_lists(
        [X[fid == 0], X[fid == 1], np.concatenate([X0, X[fid == 2]])],
        [y[fid == 0], y[fid == 1], np.concatenate([[0.0], y[fid == 2]])],
        device="cpu", kernel="rbf", jitter=1e-6)
    mf.params = tm.host_params(tr.theta)
    mf._state = None
    mu, var = mf.predict(tm.cfg.test_points())
    np.testing.assert_allclose(mu.numpy().reshape(-1), tr.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(var.numpy().reshape(-1), tr.test_var,
                               rtol=1e-7, atol=1e-8)


# -- the command line ---------------------------------------------------------
# the JSON fields of the JAX package's commands (mfgp_tpu/cli.py:264-285,
# :302-313)
MISSION_KEYS = {"variant", "replans", "n_data", "budget_used", "rmse",
                "replans2", "rmse2", "launch_seconds_cold",
                "launch_seconds_warm"}
TINY = ["--budget", "20", "--bd", "2", "--plan-iters", "12", "--e-max", "6"]


def run_cli(capsys, argv):
    cli.main(["--cpu"] + argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_mission(capsys, tmp_path):
    out = run_cli(capsys, ["mission"] + TINY + [
        "--ensemble", "2", "--out", str(tmp_path / "m")])
    assert MISSION_KEYS | {"ensemble_seconds", "ensemble_rmse",
                           "ensemble_replans", "artifacts"} == set(out)
    assert out["variant"] == "MFEGP" and out["replans"] >= 1
    assert np.isfinite(out["rmse"]) and len(out["ensemble_rmse"]) == 2
    # member 0 is the cold run's seed
    assert out["ensemble_rmse"][0] == pytest.approx(out["rmse"], abs=1e-4)
    assert (tmp_path / "m" / "replans.csv").exists()
    out = run_cli(capsys, ["mission", "--variant", "SFGP", "--update-hyps",
                           "--fit-restarts", "2"] + TINY[:2] + ["--bd", "1"]
                  + TINY[4:])
    assert set(out) == MISSION_KEYS


def test_cli_campaign(capsys):
    out = run_cli(capsys, ["campaign", "--variants", "SFEGP,MFGP",
                           "--seeds", "2"] + TINY)
    assert set(out) == {"campaign_seconds", "runs", "SFEGP", "MFGP"}
    assert out["runs"] == 4
    for v in ("SFEGP", "MFGP"):
        assert set(out[v]) == {"rmse_mean", "rmse", "replans",
                               "budget_used", "seconds"}
        assert len(out[v]["rmse"]) == 2


@pytest.mark.parametrize("argv", [
    ["mission", "--submit", "http://127.0.0.1:1"],
    ["mission-server"],
    ["campaign", "--plot", "c.png"]])
def test_cli_unported_raise_naming_a7(argv, tmp_path, monkeypatch, capsys):
    """The three commands that raised naming ROADMAP A7 until serving was
    ported now run: ``mission --submit`` posts its mission (nothing listens
    on port 1: a connection error, not a NotImplementedError),
    ``mission-server`` serves missions (``serve.serve_missions``, which
    blocks, is recorded instead), ``campaign --plot`` draws its figure."""
    import urllib.error

    from mfgp_tpu_torch import serve

    if argv[0] == "mission":
        with pytest.raises(urllib.error.URLError):
            cli.main(["--cpu"] + argv)
    elif argv[0] == "mission-server":
        calls = []
        monkeypatch.setattr(serve, "serve_missions",
                            lambda **kw: calls.append(kw))
        cli.main(["--cpu"] + argv + ["--port", "0"])
        assert calls == [{"host": "127.0.0.1", "port": 0,
                          "device": torch.device("cpu")}]
    else:
        png = str(tmp_path / argv[-1])
        out = run_cli(capsys, ["campaign", "--variants", "SFGP", "--seeds",
                               "1", "--plot", png] + TINY)
        assert out["plot"] == png and out["runs"] == 1
        with open(png, "rb") as f:
            assert f.read(4) == b"\x89PNG"


# -- the planner's per-lane model context --------------------------------------
def _sf(seed):
    r = np.random.default_rng(seed)
    X = r.uniform(0, 10, (12, 3))
    return GP(X, np.sin(X[:, 0]), kernel="rbf", jitter=1e-6, device="cpu")


def _mf(seed):
    r = np.random.default_rng(seed)
    Xs = [r.uniform(0, 10, (n, 3)) for n in (4, 5, 6)]
    return MFGP.from_fidelity_lists(Xs, [np.sin(X[:, 0]) for X in Xs],
                                    device="cpu", kernel="rbf", jitter=1e-6)


@pytest.mark.parametrize("cost", ["sf_gain", "mf_logdet", "ergodic"])
def test_per_lane_context_equals_solo_plans(cost):
    """A 2-lane loop whose lanes plan on two different EIDs and arenas
    (each its own X_pad, L_pad and hyperparameters) equals the two solo
    plans."""
    cfg = SimConfig()
    ag = cfg.agent()
    from mfgp_tpu_torch.metrics.eid import eid_grid

    grid = eid_grid([list(b) for b in cfg.WS], cfg.max_depth,
                    nums=(10, 6, 5) if cost.endswith("logdet")
                    else (10, 20, 10))
    pl = DeviceRIG(ag, delta=cfg.step_size, B=15.0,
                   WS=np.asarray(cfg.WS, float), R=cfg.near_rad, Rd=cfg.Rd,
                   same_node_distance=cfg.same_node_distance, max_iter=12,
                   grid=grid, cost=cost, device="cpu", max_nodes=16,
                   samples_per_edge=6, max_path_points=48)
    if cost == "ergodic":
        gps = [None, None]
    elif cost.startswith("sf"):
        gps = [prepare_sf_gain_state(_sf(s), 32) for s in (1, 2)]
    else:
        gps = [prepare_mf_gain_state(_mf(s), ag.fid_levels, 32)
               for s in (1, 2)]
    rng = np.random.default_rng(0)
    eids = [torch.softmax(torch.as_tensor(rng.normal(size=grid.shape[0])),
                          0) for _ in range(2)]
    draws = pl.draws(torch.Generator().manual_seed(7), 2)
    x0 = torch.tensor([[1.0, 1.0], [1.5, 1.2]], dtype=torch.float64)
    B = torch.tensor([15.0, 14.0], dtype=torch.float64)
    gp2 = None if gps[0] is None else tuple(
        torch.stack(ts) for ts in zip(*gps))
    st2 = pl._run(x0, B, torch.stack(eids), gp2, draws)
    for l in range(2):
        st1 = pl._run(x0[l:l + 1], B[l:l + 1], eids[l], gps[l],
                      draws[l:l + 1])
        assert float(st1["best_score"][0]) > -1e29  # a path was found
        for k in ("best_arena", "n_nodes", "n_feas", "a_prev", "a_edge"):
            assert torch.equal(st2[k][l], st1[k][0]), k
        for k in ("best_score", "a_budget", "a_score", "edge_pts"):
            torch.testing.assert_close(st2[k][l], st1[k][0], rtol=1e-12,
                                       atol=1e-12)
