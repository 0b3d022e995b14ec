"""Parity of the port's whole-mission program (``mfgp_tpu_torch.sim.
mission_device``) with ``mfgp_tpu.sim.mission_device`` on the CPU, in
float64, at the JAX package's test sizes (``SMALL``,
tests/test_mission_device.py:20).

The JAX mission's key splits do not depend on its state, so
``jax_mission_draws`` rebuilds every number a JAX mission reads from
``jax.random.key(seed)`` alone: per replan ``key, kp, kkf, km, kf =
split(key, 5)`` (mfgp_tpu/sim/mission_device.py:595), the planner's draws
from kp (``jax_plan_draws``), the filter's or the runtime's noise from
kkf, the measurement noise from km and the restart perturbations from kf.
The port takes them through its ``replan_draws`` hook.

Each JAX mission is compiled once per module (three here, two in
``test_torch_mission_paths.py``); the port's ensembles, stepped runs and
campaign are held against the port's own solo runs.

The refit test runs at seed 1. At seed 0 the MF refit lands in a flat
valley of the masked NLML (the noise going to 0, a fidelity without data):
the objective and its gradient agree with JAX's to 7e-13, but over 81
L-BFGS iterations the two optimizers reach different points of the valley
(NLML within 5e-8, theta apart by up to 4.1), so theta cannot be held
there; at seed 1 it agrees to 1e-10.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.sim.mission_device import DeviceMission as JM
from mfgp_tpu.utils.configs import ExperimentConfig as JE
from mfgp_tpu.utils.configs import SimConfig as JS
from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.models.mfgp import MFGP
from mfgp_tpu_torch.sim.mission_device import DeviceMission as TM
from mfgp_tpu_torch.sim.mission_device import run_campaign
from mfgp_tpu_torch.utils.configs import ExperimentConfig as TE
from mfgp_tpu_torch.utils.configs import SimConfig as TS
from test_torch_parallel import MESH_DP2
from test_torch_primitives_device import jax_plan_draws

SMALL = dict(plan_iters=6, e_max=6, max_nodes=16, samples_per_edge=6)
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's tensors here are small: one intra-op thread, so that the
    test workers sharing the machine's cores do not oversubscribe them
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mission_draws(bd: int, max_iter: int, near_neighbors: int, agent,
                      R: int, fit_restarts: int = 1, n_theta: int = 0,
                      t_cap: int = 0, stride: int = 1, s_meas: int = 0):
    """A ``replan_draws(seed, r)`` hook returning what the JAX mission of
    ``key(seed)`` reads at replan r, in the port's layout. ``t_cap`` > 0:
    a dynamic flight (the runtime's tick rows, the s_meas measurement
    draws)."""
    cache = {}

    def draws(seed, r):
        if seed not in cache:
            key, out = jax.random.key(seed), []
            for _ in range(bd):
                key, kp, kkf, km, kf = jax.random.split(key, 5)
                d = dict(plan=jax_plan_draws(kp, max_iter, near_neighbors,
                                             agent))
                if t_cap:
                    n = -(-t_cap // stride) * stride
                    d["flight"] = np.asarray(jax.vmap(
                        lambda i, k=kkf: jax.random.normal(
                            jax.random.fold_in(k, i), (13,), jnp.float64))(
                                jnp.arange(n)))
                    d["meas"] = np.asarray(jax.random.normal(
                        km, (s_meas,), jnp.float64))
                else:
                    d["flight"] = np.asarray(jax.random.normal(
                        kkf, (R - 1, 6), jnp.float64))
                    d["meas"] = np.asarray(jax.random.normal(
                        km, (R - 1,), jnp.float64))
                if fit_restarts > 1:
                    d["restart"] = np.asarray(jax.random.normal(
                        kf, (fit_restarts, n_theta), jnp.float64))
                out.append(d)
            cache[seed] = out
        return cache[seed][r]

    return draws


def port_mission(exp_kw: dict, seed: int, bd: int | None = None,
                 sim: dict | None = None, **kw):
    """A port mission on the CPU fed the JAX mission's draws (``sim``:
    SimConfig fields other than the defaults)."""
    m = TM(TE(sim=TS(**(sim or {})), **exp_kw), seed=seed, device="cpu",
           **SMALL, **kw)
    m.replan_draws = jax_mission_draws(
        bd or m.exp.BD, m.planner.max_iter, m.planner.K, m.agent_cfg, m.R,
        m.fit_restarts, m._theta0.shape[0],
        m.t_cap if m.flight == "dynamic" else 0,
        m.rt.glide_stride if m.rt is not None else 1, m.s_meas)
    return m


def exp_kw(**kw):
    base = dict(B=20.0, BD=2, update_hyps=False)
    base.update(kw)
    return base


def rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.size \
        else 0.0


def assert_results_close(got, ref, tol=TOL, theta_tol=TOL):
    """Every array of two mission results (JAX's or the port's)."""
    assert got.n_replans == ref.n_replans
    assert rel(got.gp_data.data, ref.gp_data.data) <= tol
    assert len(got.replans) == len(ref.replans)
    for a, b in zip(got.replans, ref.replans):
        assert (a["plan_num"], a["nodes"], a["edges"]) == \
            (b["plan_num"], b["nodes"], b["edges"])
        for k in ("info", "budget", "t_flown"):
            assert a[k] == pytest.approx(b[k], rel=tol, abs=tol), k
    np.testing.assert_array_equal(got.flown_mask, ref.flown_mask)
    assert rel(got.flown, ref.flown) <= tol
    assert rel(got.eids, ref.eids) <= tol
    assert rel(got.thetas, ref.thetas) <= theta_tol
    assert rel(got.theta, ref.theta) <= theta_tol
    for k in ("test_mu", "test_var"):
        assert rel(getattr(got, k), getattr(ref, k)) <= theta_tol, k
    assert got.rmse == pytest.approx(ref.rmse, rel=theta_tol)
    assert got.budget_used == pytest.approx(ref.budget_used, rel=tol,
                                            abs=tol)
    assert got.chain_overflow == ref.chain_overflow


def both(exp: dict, seed: int, max_replans=None, sim=None, **kw):
    jm = JM(JE(sim=JS(**(sim or {})), **exp), seed=seed, dtype=jnp.float64,
            **SMALL, **kw)
    jr = jm.run(max_replans=max_replans)
    tm = port_mission(exp, seed, bd=max_replans, sim=sim, **kw)
    return jm, jr, tm, tm.run(max_replans=max_replans)


@pytest.fixture(scope="module")
def sf_frozen():
    # SF ergodic, frozen hyperparameters (tests/test_mission_device.py:75)
    return both(exp_kw(multi_fidelity=False, ergodic=True, B=30.0), 0)


@pytest.fixture(scope="module")
def mf_refit():
    return both(exp_kw(multi_fidelity=True, ergodic=False,
                       update_hyps=True), 1, fit_restarts=2)


@pytest.fixture(scope="module")
def budget_end():
    # one tranche of 8: the second and third replans are masked no-ops
    return both(exp_kw(B=8.0, BD=1), 1, max_replans=3)


def test_sf_frozen_matches_jax(sf_frozen):
    _, jr, _, tr = sf_frozen
    assert jr.n_replans == 2
    assert_results_close(tr, jr)


def test_mf_refit_matches_jax(mf_refit):
    """In-graph refits with 2 restarts: theta per replan within 1e-6."""
    jm, jr, tm, tr = mf_refit
    assert jr.n_replans == 2
    assert not np.allclose(jr.theta, np.asarray(jm._theta0))
    assert_results_close(tr, jr, theta_tol=1e-6)
    assert [f["replan"] for f in tm.refits] == [0, 1]
    for f in tm.refits:  # the warm start is a restart: never worse
        assert f["lanes"] == 2
        assert np.all(np.asarray(f["f"]) <= np.asarray(f["f_start"]))


def test_budget_termination_matches_jax(budget_end):
    """A one-tranche budget stops after the first replan; the masked
    replans still write their EID and theta rows, equal to JAX's."""
    _, jr, tm, tr = budget_end
    assert tr.n_replans == jr.n_replans == 1
    assert tr.budget_used <= 8.0 + 1e-9
    assert tr.eids.shape[0] == 3 and np.all(tr.eids.sum(1) > 0.99)
    assert_results_close(tr, jr)


def test_arena_equals_models_conditioned_from_scratch(sf_frozen, mf_refit):
    """The padded arena with its masked bordered extensions (and, after
    refits, its refactorization) equals the port's GP / MFGP conditioned
    from scratch on the harvested rows and the dummy start row, at the
    mission's final hyperparameters (tests/test_mission_device.py:50-93)."""
    _, _, tm, tr = sf_frozen
    X, _, y = tm.harvested(tr)
    X0 = np.array([[tm._x0[0], tm._x0[1], 0.0]])
    gp = GP(np.concatenate([X0, X]), np.concatenate([[0.0], y]),
            kernel="rbf", jitter=1e-6, params=tm.host_params(tr.theta),
            device="cpu")
    tp = tm.cfg.test_points()
    mu, var = gp.predict(tp)
    np.testing.assert_allclose(mu.numpy().reshape(-1), tr.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(var.numpy().reshape(-1), tr.test_var,
                               rtol=1e-7, atol=1e-8)

    _, _, tm, tr = mf_refit
    X, fid, y = tm.harvested(tr)
    Xs = [X[fid == 0], X[fid == 1], np.concatenate([X0, X[fid == 2]])]
    ys = [y[fid == 0], y[fid == 1], np.concatenate([[0.0], y[fid == 2]])]
    mf = MFGP.from_fidelity_lists(Xs, ys, device="cpu", kernel="rbf",
                                  jitter=1e-6)
    mf.params = tm.host_params(tr.theta)
    mf._state = None
    mu, var = mf.predict(tp)
    np.testing.assert_allclose(mu.numpy().reshape(-1), tr.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(var.numpy().reshape(-1), tr.test_var,
                               rtol=1e-7, atol=1e-8)


def _same(a, b):
    for k in ("flown", "flown_mask", "thetas", "eids", "test_mu",
              "test_var", "theta"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    np.testing.assert_array_equal(a.gp_data.data, b.gp_data.data)
    assert a.replans == b.replans and a.rmse == b.rmse


def test_stepped_equals_one():
    """Spans of replans over the carried state (with and without a
    ceiling sizing them) give the one-pass run bit for bit."""
    kw = exp_kw(multi_fidelity=False, ergodic=True, B=30.0)
    one = port_mission(kw, 0)
    r1 = one.run(mode="one")
    assert one.last_run_launches == 1 and r1.n_replans == 2
    st = port_mission(kw, 0)
    _same(st.run(mode="stepped"), r1)
    assert st.last_run_launches == 3  # a span per replan + the finish
    capped = port_mission(kw, 0, launch_ceiling_s=1e-9)
    with pytest.warns(RuntimeWarning, match="ceiling"):
        _same(capped.run(mode="auto"), r1)
    with pytest.raises(ValueError, match="mode"):
        one.run(mode="two")


def test_ensemble_members_equal_solo_runs():
    """run_ensemble(3, seed_chunk=2): a chunk of 2 lanes and a tail chunk
    padded to 2; member i equals the solo mission of seed i."""
    kw = exp_kw(multi_fidelity=True, ergodic=True, B=20.0)
    ens = port_mission(kw, 0).run_ensemble(3, seed_chunk=2)
    assert len(ens) == 3 and sum(e.n_replans for e in ens) >= 3
    for i, e in enumerate(ens):
        solo = port_mission(kw, i).run()
        assert e.n_replans == solo.n_replans
        assert e.replans == pytest.approx(solo.replans)
        np.testing.assert_array_equal(e.flown_mask, solo.flown_mask)
        for k in ("flown", "eids", "test_mu", "test_var"):
            np.testing.assert_allclose(getattr(e, k), getattr(solo, k),
                                       rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(e.gp_data.data, solo.gp_data.data,
                                   rtol=1e-10, atol=1e-12)
        assert e.rmse == pytest.approx(solo.rmse, rel=1e-10)
    with pytest.raises(ValueError, match="multiple of the mesh dp"):
        port_mission(kw, 0).run_ensemble(3, mesh=MESH_DP2)


def test_campaign_equals_solo_missions():
    """Two variants x two seeds: each member equals its variant's solo
    mission of that seed."""
    ref = port_mission(exp_kw(multi_fidelity=False, ergodic=True), 0)
    hook = ref.replan_draws
    camp = run_campaign(variants=("SFEGP", "SFGP"), n_seeds=2, seed=0,
                        exp_kw=dict(B=20.0, BD=2, update_hyps=False),
                        device="cpu", replan_draws=hook, **SMALL)
    assert set(camp) == {"SFEGP", "SFGP"}
    for v, ergodic in (("SFEGP", True), ("SFGP", False)):
        c = camp[v]
        assert len(c["rmse"]) == 2 and c["seconds"] > 0
        for s in range(2):
            solo = port_mission(exp_kw(multi_fidelity=False,
                                       ergodic=ergodic), s).run()
            assert c["replans"][s] == solo.n_replans
            assert c["rmse"][s] == pytest.approx(solo.rmse, rel=1e-10)
            assert c["budget_used"][s] == pytest.approx(solo.budget_used,
                                                        rel=1e-10)
            np.testing.assert_allclose(c["results"][s].gp_data.data,
                                       solo.gp_data.data, rtol=1e-10,
                                       atol=1e-12)
    with pytest.raises(ValueError, match="variant"):
        run_campaign(variants=("XFGP",), device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh dp"):
        run_campaign(variants=("SFGP",), n_seeds=3, mesh=MESH_DP2,
                     device="cpu")


def test_save_artifacts_match_jax(sf_frozen, tmp_path):
    """The same five file kinds as the JAX package's, numbers within
    1e-8."""
    jm, jr, tm, tr = sf_frozen
    a, b = tmp_path / "jax", tmp_path / "port"
    jm.save_artifacts(jr, str(a))
    tm.save_artifacts(tr, str(b))
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert {"GPData.csv", "hyps.csv", "replans.csv", "plannedTraj0.csv",
            "EID0.csv"} <= set(names)
    for n in names:
        skip = 1 if n in ("GPData.csv", "replans.csv") else 0
        if skip:  # the same header
            assert open(a / n).readline() == open(b / n).readline(), n
        if n == "replans.csv":
            ra = np.genfromtxt(a / n, delimiter=",", skip_header=1,
                               dtype=None, encoding=None)
            rb = np.genfromtxt(b / n, delimiter=",", skip_header=1,
                               dtype=None, encoding=None)
            for x, y in zip(np.atleast_1d(ra), np.atleast_1d(rb)):
                for u, w in zip(x, y):
                    if isinstance(u, str):
                        assert u == w
                    else:
                        assert np.nan_to_num(u) == pytest.approx(
                            np.nan_to_num(w), rel=TOL, abs=TOL)
            continue
        xa = np.loadtxt(a / n, delimiter=",", skiprows=skip, ndmin=2)
        xb = np.loadtxt(b / n, delimiter=",", skiprows=skip, ndmin=2)
        assert rel(xb, xa) <= TOL, n


def test_constructor_errors_match_jax():
    with pytest.raises(ValueError, match="fit_restarts"):
        TM(TE(update_hyps=False), fit_restarts=2, device="cpu")
    with pytest.raises(ValueError, match="glide_stride"):
        TM(TE(), glide_stride=2, device="cpu")
    with pytest.raises(ValueError):
        TM(TE(), flight="hover", device="cpu")
    with pytest.raises(ValueError, match="n_max"):
        TM(TE(B=20.0, BD=2), n_max=8, device="cpu", **SMALL)
