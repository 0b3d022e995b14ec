"""The port's closed-loop simulator off its kinematic main path, against
``mfgp_tpu`` on the CPU in float64: the frozen-hyperparameter run's online
extension, checkpoints and resume, the manual variant, one dynamic flight,
``cli explore`` and the study's closed-loop trajectory. The configurations
are the JAX package's own tests' (tests/test_sim_cli.py,
tests/test_runtime.py:171-191); where a run reads the Kalman filter's
draws, the port is given the JAX package's (``kf_noise``).
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu import cli as jcli
from mfgp_tpu.data import study as jstudy
from mfgp_tpu.models.gp import GP as JGP
from mfgp_tpu.sim import ExplorationSim as JSim
from mfgp_tpu.utils import checkpoint as jckpt
from mfgp_tpu.utils.configs import ExperimentConfig as JExp
from mfgp_tpu.utils.configs import SimConfig as JSimConfig
from mfgp_tpu_torch import cli as tcli
from mfgp_tpu_torch.data import study as tstudy
from mfgp_tpu_torch.models.gp import GP as TGP
from mfgp_tpu_torch.models.mfgp import MFGP as TMFGP
from mfgp_tpu_torch.sim import ExplorationSim as TSim
from mfgp_tpu_torch.utils import checkpoint as tckpt
from mfgp_tpu_torch.utils.configs import ExperimentConfig as TExp
from mfgp_tpu_torch.utils.configs import SimConfig as TSimConfig

CPU = "cpu"


def jax_kf_noise(seed: int, manual: bool = False):
    """The JAX sim's filter draws (mfgp_tpu/sim/explore.py:334,427-428):
    replan ``k`` draws with the second half of the (k+1)-th ``split`` of
    ``jax.random.key(seed)``; the manual run with the key itself (:564)."""
    def draws(plan_num, n):
        key = jax.random.key(seed)
        if not manual:
            for _ in range(plan_num + 1):
                key, sub = jax.random.split(key)
            key = sub
        return np.array(jax.random.normal(key, (n, 6), jnp.float64))
    return draws


def assert_runs_close(got, ref, tol=1e-6):
    assert got.gp_data.data.shape == ref.gp_data.data.shape
    np.testing.assert_allclose(got.gp_data.data, ref.gp_data.data, rtol=tol,
                               atol=tol)
    assert len(got.replans) == len(ref.replans)
    for a, b in zip(got.replans, ref.replans):
        assert (a.plan_num, a.nodes, a.edges, a.fit_mode) == \
            (b.plan_num, b.nodes, b.edges, b.fit_mode)
        np.testing.assert_allclose(a.path_points, b.path_points, rtol=tol,
                                   atol=tol)
        assert a.best_info == pytest.approx(b.best_info, rel=tol, abs=tol)
    assert got.budget_used == pytest.approx(ref.budget_used, rel=tol,
                                            abs=tol)


# ---------------------------------------------------------------------------
# frozen hyperparameters: the online extension
# ---------------------------------------------------------------------------
FROZEN = (dict(multi_fidelity=True, ergodic=False, B=20, BD=2,
               update_hyps=False), 1, 8)  # tests/test_sim_cli.py:116-149


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    kw, seed, iters = FROZEN
    out = tmp_path_factory.mktemp("frozen")
    ref = JSim(JExp(**kw), seed=seed, plan_iters=iters).run()
    sim = TSim(TExp(**kw), seed=seed, plan_iters=iters, device=CPU,
               kf_noise=jax_kf_noise(seed), out_dir=str(out))
    return sim, sim.run(), ref, out


def test_frozen_run_matches_jax(frozen):
    _, got, ref, _ = frozen
    assert_runs_close(got, ref)
    assert [r.fit_mode for r in got.replans] == ["refit", "extend"]
    assert got.rmse == pytest.approx(ref.rmse, rel=1e-6, abs=1e-6)


def test_frozen_extension_equals_recondition(frozen):
    """The online-extended posterior equals a from-scratch recondition of
    the same data at the same hyperparameters within 1e-6, and the replan
    statistics land in ``replans.csv``."""
    sim, got, _, out = frozen
    rows = got.gp_data.data
    fresh = sim._make_model(rows[:, 4:7], rows[:, 8].astype(int), rows[:, 7])
    fresh.set_param_array(got.model.param_array)
    tp = sim.cfg.test_points()[::17]
    mu_o, var_o = got.model.predict(tp)
    mu_f, var_f = fresh.predict(tp)
    np.testing.assert_allclose(mu_o.numpy(), mu_f.numpy(), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(var_o.numpy(), var_f.numpy(), rtol=1e-6,
                               atol=1e-8)
    txt = (out / "replans.csv").read_text().splitlines()
    assert txt[0].startswith("planNum,") and "fitMode" in txt[0]
    assert len(txt) == 1 + len(got.replans)
    assert txt[2].split(",")[7] == "extend"
    for n in range(len(got.replans)):
        eid = np.loadtxt(out / f"EID{n}.csv", delimiter=",")
        assert eid.shape[1] == 4
        np.testing.assert_allclose(eid[:, 3].sum(), 1.0, rtol=1e-6)
        assert (out / f"plannedTraj{n}.csv").exists()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 5, (12, 3))
    gp = TGP(X, np.cos(X[:, 1]), jitter=1e-8, device=CPU)
    mf = TMFGP(X, rng.integers(0, 3, 12), np.sin(X[:, 0]), jitter=1e-8,
               device=CPU)
    gen = torch.Generator().manual_seed(4)
    torch.randn(7, generator=gen)
    for model in (gp, mf):
        ck = tckpt.ExplorationCheckpoint(
            plan_num=3, t_now=12.5, planned_budget=7.25, x0=np.ones((2, 1)),
            model=tckpt.capture_model(model),
            data_rows=rng.normal(size=(5, 9)),
            rng_state=rng.bit_generator.state,
            kf_generator_state=gen.get_state().numpy(),
            graph_nodes={"0": [0.0, 1.0]}, graph_edges={"0": [0, 1]})
        p = str(tmp_path / f"ck_{type(model).__name__}")
        tckpt.save_checkpoint(p, ck)
        back = tckpt.load_checkpoint(p)
        assert back.plan_num == 3 and back.t_now == 12.5
        np.testing.assert_array_equal(back.data_rows, ck.data_rows)
        np.testing.assert_array_equal(back.model.X, ck.model.X)
        assert back.model.kind == ck.model.kind
        assert back.graph_nodes == ck.graph_nodes
        assert back.rng_state == ck.rng_state
        np.testing.assert_array_equal(back.kf_generator_state,
                                      ck.kf_generator_state)
        m = back.model.restore(jitter=1e-8, device=CPU)
        np.testing.assert_allclose(m.predict(X[:3])[0].numpy(),
                                   model.predict(X[:3])[0].numpy(),
                                   rtol=1e-9)
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.save_checkpoint(str(tmp_path / "o"), ck, backend="orbax")
    os.makedirs(tmp_path / "only.orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_checkpoint(str(tmp_path / "only"))


def test_jax_written_checkpoint_loads(tmp_path):
    """A checkpoint the JAX package's npz backend wrote loads: its model
    (restored as a port model, the same posterior), rows, budget and NumPy
    RNG state. Resuming from it raises: it holds a jax.random key, no
    torch generator state."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 10, (15, 3))
    gp = JGP(X, np.sin(X[:, 0]), jitter=1e-6)
    gp.set_param_array(np.array([1.3, 2.0, 3.0, 2.5, 0.01]))
    ck = jckpt.ExplorationCheckpoint(
        plan_num=2, t_now=40.0, planned_budget=9.5, x0=np.full((2, 1), 3.0),
        model=jckpt.capture_model(gp), data_rows=rng.normal(size=(15, 9)),
        rng_state=rng.bit_generator.state,
        jax_key_data=np.asarray(jax.random.key_data(jax.random.key(4))))
    p = str(tmp_path / "jax_ck")
    jckpt.save_checkpoint(p, ck)
    back = tckpt.load_checkpoint(p)
    assert (back.plan_num, back.t_now, back.planned_budget) == (2, 40.0, 9.5)
    assert back.kf_generator_state is None
    assert back.rng_state == ck.rng_state
    np.testing.assert_array_equal(back.data_rows, ck.data_rows)
    m = back.model.restore(device=CPU)
    np.testing.assert_allclose(m.predict(X[:4])[0].numpy(),
                               np.asarray(gp.predict(X[:4])[0]), rtol=1e-9)
    sim = TSim(TExp(multi_fidelity=False, ergodic=False, B=10, BD=1),
               device=CPU)
    with pytest.raises(ValueError, match="no torch generator state"):
        sim.run(resume_from=p)


def test_resume_equals_uninterrupted(tmp_path):
    """MFGP at the frozen run's setting, refitting, on the port's own
    seeded filter draws: stopped after replan 1 with a checkpoint and
    resumed in a new sim, it gives the uninterrupted run's replans, rows
    and budget."""
    kw, seed, iters = dict(FROZEN[0], update_hyps=True), 1, 8
    full = TSim(TExp(**kw), seed=seed, plan_iters=iters, device=CPU).run()
    p = str(tmp_path / "ck")
    first = TSim(TExp(**kw), seed=seed, plan_iters=iters, device=CPU).run(
        max_replans=1, checkpoint_path=p)
    assert len(first.replans) == 1 and os.path.exists(p + ".npz")
    rest = TSim(TExp(**kw), seed=seed, plan_iters=iters, device=CPU).run(
        resume_from=p)
    assert len(full.replans) == 2 and len(rest.replans) == 1
    a, b = rest.replans[0], full.replans[1]
    assert (a.plan_num, a.nodes, a.edges) == (b.plan_num, b.nodes, b.edges)
    np.testing.assert_allclose(a.path_points, b.path_points, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(rest.gp_data.data, full.gp_data.data,
                               rtol=1e-6, atol=1e-6)
    assert rest.budget_used == pytest.approx(full.budget_used, abs=1e-6)
    assert rest.rmse == pytest.approx(full.rmse, rel=1e-6)


# ---------------------------------------------------------------------------
# manual variant, dynamic flight
# ---------------------------------------------------------------------------
def test_run_manual_matches_jax(tmp_path):
    """The CLI's demo chain flown by ``run_manual`` (SFGP): rows, budget
    and RMSE as JAX's; the end-of-run model checkpoint restores."""
    wp = np.array([[1, 1, 0], [8, 4, 3], [3, 15, 5], [8, 18, 0]], float)
    exp = dict(multi_fidelity=False, ergodic=False)
    ref = JSim(JExp(**exp), seed=0).run_manual(wp)
    got = TSim(TExp(**exp), seed=0, device=CPU, out_dir=str(tmp_path),
               kf_noise=jax_kf_noise(0, manual=True)).run_manual(wp)
    assert len(got.replans) == 0 and got.gp_data.data.shape[0] > 50
    np.testing.assert_allclose(got.gp_data.data, ref.gp_data.data, rtol=1e-8,
                               atol=1e-8)
    assert got.budget_used == pytest.approx(ref.budget_used, rel=1e-12)
    assert got.rmse == pytest.approx(ref.rmse, rel=1e-6, abs=1e-6)
    ck = tckpt.load_checkpoint(str(tmp_path / "manual_model"))
    m = ck.model.restore(device=CPU)
    np.testing.assert_allclose(m.predict(wp)[0].numpy(),
                               got.model.predict(wp)[0].numpy(), rtol=1e-9)


def test_dynamic_flight_matches_jax(tmp_path):
    """The MFEGP run of tests/test_runtime.py:171-191 flying through the
    runtime, one replan: the flight reads no filter draws, so the whole
    run is held within 1e-6, its tracking error and flown budget too, and
    the runtime's artifacts are written."""
    exp = dict(multi_fidelity=True, ergodic=True, B=20.0, BD=2)
    ref = JSim(JExp(**exp), seed=0, plan_iters=8, flight="dynamic").run(
        max_replans=1)
    got = TSim(TExp(**exp), seed=0, plan_iters=8, flight="dynamic",
               device=CPU, out_dir=str(tmp_path)).run(max_replans=1)
    assert_runs_close(got, ref)
    np.testing.assert_allclose(got.estimates, ref.estimates, rtol=1e-6,
                               atol=1e-6)
    a, b = got.replans[0], ref.replans[0]
    assert a.tracking_rmse > 0.01 and a.flown_budget > 0
    assert a.tracking_rmse == pytest.approx(b.tracking_rmse, rel=1e-6)
    assert a.flown_budget == pytest.approx(b.flown_budget, rel=1e-6)
    assert got.rmse == pytest.approx(ref.rmse, rel=1e-6, abs=1e-6)
    for name in ("plannedTraj0", "estimates0", "control0", "trajInfo0",
                 "measurements0"):
        assert (tmp_path / f"{name}.csv").exists()


# ---------------------------------------------------------------------------
# the command line, the study's closed-loop trajectory
# ---------------------------------------------------------------------------
def run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_explore_dynamic_matches_jax(tmp_path, monkeypatch):
    """``explore --flight dynamic`` reads no filter draws: the port's JSON
    (``--cpu``) equals JAX's at 1e-6, key for key."""
    monkeypatch.setenv("MFGP_TPU_COMPILE_CACHE", "0")
    argv = ["explore", "--variant", "SFEGP", "--budget", "10", "--bd", "1",
            "--plan-iters", "6", "--seed", "2", "--flight", "dynamic"]
    ref = run_cli(jcli.main, argv + ["--out", str(tmp_path / "j")])
    got = run_cli(tcli.main, ["--cpu"] + argv + ["--out", str(tmp_path / "t")])
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], str):
            assert got[k] == ref[k]
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)


def test_cli_explore_kinematic_and_device_planner(tmp_path, monkeypatch):
    """``explore`` on the kinematic path (tests/test_sim_cli.py:70-77's
    SFGP run): the CLI cannot take the JAX draws, so the JSON is held
    structurally (its keys, variant, replans, rows and budget are JAX's;
    the RMSE depends on the draws). ``--planner device`` with and without
    ``--plan-ensemble 2`` runs on the CPU with ``--cpu`` (its own draws:
    the same keys, the budget within the run's); ``--plan-ensemble 2``
    alone raises as JAX's does; without ``--cpu`` the command needs the
    card."""
    monkeypatch.setenv("MFGP_TPU_COMPILE_CACHE", "0")
    argv = ["explore", "--variant", "SFGP", "--budget", "8", "--bd", "1",
            "--plan-iters", "5"]
    ref = run_cli(jcli.main, argv)
    got = run_cli(tcli.main, ["--cpu"] + argv)
    assert sorted(got) == sorted(ref)
    assert (got["variant"], got["replans"], got["n_data"]) == \
        (ref["variant"], ref["replans"], ref["n_data"])
    assert got["budget_used"] == pytest.approx(ref["budget_used"], abs=1e-6)
    assert got["budget_used"] <= 8.0 and np.isfinite(got["rmse"])
    for extra in (["--planner", "device"],
                  ["--planner", "device", "--plan-ensemble", "2"]):
        dev = run_cli(tcli.main, ["--cpu"] + argv + ["--plan-iters", "6"]
                      + extra)
        assert sorted(dev) == sorted(ref) and dev["variant"] == "SFGP"
        assert dev["replans"] == 1 and dev["n_data"] > 0
        assert 0.0 < dev["budget_used"] <= 8.0
    with pytest.raises(ValueError, match="device planner"):
        tcli.main(["--cpu"] + argv + ["--plan-ensemble", "2"])
    if not torch.cuda.is_available():  # the card unless --cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)


def test_closed_loop_trajectory_matches_jax():
    """The study's closed-loop ground truth (an SFEGP run, B=30, BD=3):
    the same trajectory as JAX's with JAX's filter draws."""
    ref = jstudy.closed_loop_trajectory(0, JSimConfig(seed=0, vmn=0.0))
    got = tstudy.closed_loop_trajectory(0, TSimConfig(seed=0, vmn=0.0),
                                        device=CPU, kf_noise=jax_kf_noise(0))
    assert got.headers == ref.headers == ["t", "x", "y", "z"]
    assert got.data.shape == ref.data.shape and got.data.shape[0] >= 10
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-8, atol=1e-8)
