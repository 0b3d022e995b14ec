"""Parity of the port's device planner (``mfgp_tpu_torch.planning.
rig_device``) with ``mfgp_tpu.planning.rig_device`` on the CPU, in
float64, with the JAX package's own draws injected (``jax_lane_draws``:
every number a JAX plan reads, rebuilt from its key).

Held for each plan: ``n_nodes``, the nodes, the best path's arena chain,
its points, score and budget (1e-10 relative), the admitted-extension
trace, and the whole arena (indices equal; budgets, times and scores on
its valid rows to 1e-10) and every node's beam. The costs' planners are
module-scoped (a JAX planner compiles in ~7 s here) at small sizes:
max_iter 4, 16 nodes, beams of 4, 8 samples per edge, 32 path points, a
60-point grid. ``test_torch_rig_device_paths.py`` holds the multi-fidelity
and log-det costs and the gain costs' closed loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.metrics.eid import eid_grid
from mfgp_tpu.models.gp import GP as JGP
from mfgp_tpu.models.mfgp import MFGP as JMFGP
from mfgp_tpu.planning import rig_device as jrd
from mfgp_tpu.planning.primitives import AgentConfig as JCfg
from mfgp_tpu_torch.models.gp import GP as TGP
from mfgp_tpu_torch.models.mfgp import MFGP as TMFGP
from mfgp_tpu_torch.planning import rig_device as trd
from mfgp_tpu_torch.planning.primitives import AgentConfig as TCfg
from test_torch_parallel import MESH_DP2
from test_torch_primitives_device import jax_lane_draws

REL = 1e-10
X0 = np.array([1.0, 1.0])
WS = np.array([[0.0, 10.0], [0.0, 20.0]])
GRID = np.asarray(eid_grid([[0, 10], [0, 20]], 5.0, nums=(6, 5, 2)))
EID = np.random.default_rng(0).random(GRID.shape[0])
EID /= EID.sum()
KW = dict(delta=2.0, B=8.0, WS=WS, R=3.0, Rd=2.0, same_node_distance=0.5,
          budget_cutoff=0.5, max_iter=4, max_nodes=16, max_paths=4,
          samples_per_edge=8, max_path_points=32)
ARENA_KEYS = ("a_prev", "a_edge", "a_node")
_CACHE: dict = {}


def agents(mf: bool):
    jc, tc = JCfg.sim_defaults(), TCfg.sim_defaults()
    if mf:  # accrue localization variance so the fidelity labels vary
        jc.variance_rate = tc.variance_rate = 0.01
    return jc, tc


def gain_states(cost: str):
    """Both packages' padded GP states of one model (20 points, n_max
    32), float64, for the gain and log-det costs; (None, None) else."""
    if cost in ("ergodic", "fourier"):
        return None, None
    rng = np.random.default_rng(1)
    X = rng.uniform([0, 0, 0], [10, 20, 5], (20, 3))
    y = np.sin(X[:, 0]) + np.cos(X[:, 1] / 3)
    if cost.startswith("mf"):
        fid = rng.integers(0, 3, 20)
        fl = TCfg.sim_defaults().fid_levels
        return (jrd.prepare_mf_gain_state(JMFGP(X, fid, y, jitter=1e-8), fl,
                                          32, dtype=jnp.float64),
                trd.prepare_mf_gain_state(
                    TMFGP(X, fid, y, jitter=1e-8, device="cpu"), fl, 32))
    return (jrd.prepare_sf_gain_state(JGP(X, y, jitter=1e-8), 32,
                                      dtype=jnp.float64),
            trd.prepare_sf_gain_state(TGP(X, y, jitter=1e-8, device="cpu"),
                                      32))


def planners(cost: str):
    """(JAX planner, port planner, JAX gp state, port gp state, agent),
    once per module."""
    if cost not in _CACHE:
        kw = dict(KW, cost=cost)
        if cost in ("ergodic", "fourier"):
            kw.update(grid=GRID, eid=EID)
        elif cost.endswith("logdet"):
            kw.update(grid=GRID)
        jc, tc = agents(cost.startswith("mf"))
        gj, gt = gain_states(cost)
        _CACHE[cost] = (jrd.DeviceRIG(jc, dtype=jnp.float64, **kw),
                        trd.DeviceRIG(tc, device="cpu", **kw), gj, gt, tc)
    return _CACHE[cost]


def jax_state(jp, key, B, gp) -> dict:
    """The final loop state of JAX's ``plan`` (its jitted loop, the same
    trace ``plan`` runs), as numpy."""
    x0, Bj, eid, gpj = jp._args(X0, B, None, gp)
    st = dict(jp._plan_jit(x0, key, Bj, eid, gpj))
    st.pop("key")
    return {k: np.asarray(v) for k, v in st.items()}


def port_plan(tp, draws, B, gp):
    """The port's ``plan`` (its loop, then the extraction) with the final
    loop state kept: (result, state as numpy)."""
    st = tp._to_host(tp._run(*tp._args(X0, B, None, gp),
                             tp._lane_draws(draws, 0, 1)))
    return tp._extract(st, 0), {k: v[0] for k, v in st.items()}


def jax_chain(st) -> list:
    chain, i = [], int(st["best_arena"])
    while i > 0:
        chain.append(i)
        i = int(st["a_prev"][i])
    return [0] + chain[::-1] if chain else []


def assert_result(got, ref, chain=None):
    assert got.n_nodes == ref.n_nodes
    np.testing.assert_allclose(got.node_states, ref.node_states, rtol=REL,
                               atol=1e-12)
    assert got.info == pytest.approx(ref.info, rel=REL, abs=1e-12)
    assert got.budget == pytest.approx(ref.budget, rel=REL, abs=1e-12)
    assert got.time == pytest.approx(ref.time, rel=REL, abs=1e-12)
    assert got.n_feasible_edges == ref.n_feasible_edges
    assert got.points.shape == ref.points.shape
    np.testing.assert_allclose(got.points, ref.points, rtol=REL, atol=1e-10)
    np.testing.assert_allclose(got.trace, ref.trace, rtol=REL, atol=1e-10)
    assert len(got.edges) == len(ref.edges)
    if chain is not None:
        assert got.chain == chain


def assert_arena(got, ref):
    for k in ARENA_KEYS + ("node_paths", "edge_src", "edge_dst"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    valid = ref["a_edge"] >= 0
    for k in ("a_budget", "a_time", "a_score"):
        np.testing.assert_allclose(got[k][valid], ref[k][valid], rtol=REL,
                                   atol=1e-10, err_msg=k)
    for k in ("n_nodes", "n_feas", "best_arena"):
        assert int(got[k]) == int(ref[k]), k


def check_cost(cost: str, seed: int):
    """One plan per package with the same key; returns the port's plan."""
    jp, tp, gj, gt, tc = planners(cost)
    key = jax.random.key(seed)
    ref = jp.plan(X0, key, gp=gj)
    got, gst = port_plan(tp, jax_lane_draws(key, 1, KW["max_iter"], 1, tc),
                         None, gt)
    rst = jax_state(jp, key, None, gj)
    assert_result(got, ref, chain=jax_chain(rst))
    assert_arena(gst, rst)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cost", ["ergodic", "fourier", "sf_gain"])
def test_plan_matches_jax(cost, seed):
    got = check_cost(cost, seed)
    assert np.isfinite(got.info) and got.points.shape[0] > 0


def test_scores_match_host_costs():
    """The additive ergodic and Fourier scores and the sequential gain of
    the best path, re-scored by the host costs in float64 on its points
    (``tests/test_rig_device.py:51-66``'s check)."""
    from mfgp_tpu_torch.planning.scoring import (ErgodicCost,
                                                 FourierErgodicCost,
                                                 SFInfoGainCost)
    from mfgp_tpu_torch.models.gp import GP

    cpu = dict(device="cpu", dtype=torch.float64)
    got = check_cost("ergodic", 0)
    host = ErgodicCost(eid=EID, grid=GRID, **cpu)(got.points)
    assert got.info == pytest.approx(host, rel=5e-3, abs=5e-3)
    got = check_cost("fourier", 0)
    bounds = np.array([[0.0, 10.0], [0.0, 20.0], [0.0, 10.0]])
    host = FourierErgodicCost(eid=EID, grid=GRID, bounds=bounds,
                              **cpu)(got.points)
    assert got.info == pytest.approx(host, rel=1e-6, abs=1e-12)
    got = check_cost("sf_gain", 1)
    rng = np.random.default_rng(1)
    X = rng.uniform([0, 0, 0], [10, 20, 5], (20, 3))
    model = GP(X, np.sin(X[:, 0]) + np.cos(X[:, 1] / 3), jitter=1e-8,
               device="cpu")
    pts = np.column_stack([got.points[:, :3], np.zeros(len(got.points))])
    assert got.info == pytest.approx(SFInfoGainCost(model=model)(pts),
                                     rel=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_plan_ensemble_matches_jax(seed):
    """``plan_ensemble(n_plans=3)``: the lanes take JAX's split keys'
    draws; the winning plan is JAX's, and each lane is the solo plan of
    its draws."""
    jp, tp, _, _, tc = planners("ergodic")
    key = jax.random.key(seed)
    ref = jp.plan_ensemble(X0, key, n_plans=3, B=12.0)
    draws = jax_lane_draws(key, 3, KW["max_iter"], 1, tc)
    got = tp.plan_ensemble(X0, n_plans=3, B=12.0, draws=draws)
    assert_result(got, ref)
    solos = [tp.plan(X0, B=12.0, draws=draws[i:i + 1]) for i in range(3)]
    best = max(solos, key=lambda r: (r.info, -r.budget))
    assert (best.info, best.budget) == (got.info, got.budget)
    with pytest.raises(ValueError, match="multiple of the mesh dp"):
        tp.plan_ensemble(X0, n_plans=3, mesh=MESH_DP2)


def test_plan_batch_matches_jax():
    """``plan_batch`` of 3 lanes (start, key, budget each): every lane is
    JAX's lane, and the port's own solo plan of the same draws."""
    jp, tp, _, _, tc = planners("ergodic")
    starts = np.array([[1.0, 1.0], [5.0, 10.0], [8.0, 18.0]])
    Bs = np.array([8.0, 6.0, 10.0])
    keys = jax.vmap(jax.random.key)(jnp.arange(3, dtype=jnp.uint32))
    ref = jp.plan_batch(starts, keys, Bs)
    draws = np.concatenate([jax_lane_draws(jax.random.key(i), 1,
                                           KW["max_iter"], 1, tc)
                            for i in range(3)])
    got = tp.plan_batch(starts, Bs=Bs, draws=draws)
    assert len(got) == len(ref) == 3
    for i in range(3):
        assert_result(got[i], ref[i])
        solo = tp.plan(starts[i], B=Bs[i], draws=draws[i:i + 1])
        assert (solo.info, solo.n_nodes) == (got[i].info, got[i].n_nodes)
        np.testing.assert_array_equal(solo.points, got[i].points)
    with pytest.raises(ValueError, match="align"):
        tp.plan_batch(starts, seeds=[0, 1])


def test_zero_budget_finds_nothing():
    """B = 1e-6: no extension fits, both packages return no path."""
    jp, tp, gj, gt, tc = planners("sf_gain")
    key = jax.random.key(0)
    ref = jp.plan(X0, key, B=1e-6, gp=gj)
    got = tp.plan(X0, B=1e-6, gp=gt,
                  draws=jax_lane_draws(key, 1, KW["max_iter"], 1, tc))
    assert got.points.shape == ref.points.shape == (0, 4)
    assert got.info == ref.info == -np.inf
    assert got.edges == [] and got.chain == []
    assert got.n_nodes == ref.n_nodes


def test_padded_gain_state_is_exact():
    """prepare_sf_gain_state: the padded posterior equals the unpadded one
    (dummy rows at the far sentinel contribute nothing), and the padded
    arrays are JAX's (``tests/test_rig_device.py:243``'s check)."""
    from mfgp_tpu_torch.metrics.info_gain import sequential_gain_from_cov
    from mfgp_tpu_torch.ops import kernels as tk
    from mfgp_tpu_torch.ops import linalg as tla

    rng = np.random.default_rng(2)
    X = rng.uniform(0, 10, (30, 3))
    y = np.sin(X[:, 0])
    m = TGP(X, y, jitter=1e-8, device="cpu")
    X_pad, L_pad, var, ls, noise = trd.prepare_sf_gain_state(m, 50)
    ref = jrd.prepare_sf_gain_state(JGP(X, y, jitter=1e-8), 50,
                                    dtype=jnp.float64)
    for a, b in zip((X_pad, L_pad, var, ls, noise), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    pts = torch.as_tensor(rng.uniform(0, 10, (12, 3)))
    k = tk.KERNELS["rbf"]
    Sig_pad = tla.posterior_cov(k(pts, pts, var, ls), k(pts, X_pad, var, ls),
                                L_pad)
    Sig = tla.posterior_cov(k(pts, pts, var, ls),
                            k(pts, m.state.X, var, ls), m.state.L)
    np.testing.assert_allclose(Sig_pad.numpy(), Sig.numpy(), rtol=1e-9,
                               atol=1e-12)
    assert float(sequential_gain_from_cov(Sig_pad, noise)) == pytest.approx(
        float(sequential_gain_from_cov(Sig, noise)), rel=1e-10)
    with pytest.raises(ValueError, match="exceeds"):
        trd.prepare_sf_gain_state(m, 20)


def test_own_draws_are_seeded_and_valid():
    """Without injected draws a plan draws from a generator seeded with
    ``seed``: the same seed gives the same plan, another seed another, and
    the draws' leg choices follow ``leg_probs`` (the simulator's agent
    never spirals)."""
    _, tp, _, _, tc = planners("ergodic")
    a, b = tp.plan(X0, seed=5, B=12.0), tp.plan(X0, seed=5, B=12.0)
    assert (a.info, a.n_nodes) == (b.info, b.n_nodes)
    np.testing.assert_array_equal(a.points, b.points)
    c = tp.plan(X0, seed=6, B=12.0)
    assert not np.array_equal(a.trace, c.trace)
    d = tp.draws(torch.Generator().manual_seed(0), lanes=2)
    assert d.shape == (2, KW["max_iter"], tp.draw_width)
    E, nl = tc.traj_count, tc.num_legs
    for phase in range(2):
        ch, u, us = tp._phase_draws(d[:, 0], phase)
        assert ch.shape == (2, E, nl) and set(ch.unique().tolist()) <= {
            1, 2, 3}
        assert u.shape == (2, E, nl, 3) and us.shape == (2, E)
        assert ((u >= 0) & (u < 1)).all()
    with pytest.raises(ValueError, match="draws"):
        tp.plan(X0, draws=d)  # two lanes for a solo plan


def test_adapter_surface():
    """DeviceRIGAdapter: the sim-facing surface over the last plan
    (points, graph summary with the loop's own feasible-edge count, and a
    runtime flight plan rebuilt from the extracted primitive chain)."""
    _, tp, _, _, tc = planners("ergodic")
    ad = trd.DeviceRIGAdapter(seed=0, cfg=tc, device="cpu", grid=GRID,
                              eid=EID, cost="ergodic", **KW)
    assert ad.best_path_points() is None and ad.flight_plan() == (None, None)
    best = ad.plan(X0, seed=1, B=12.0)
    ref = tp.plan(X0, seed=1, B=12.0)
    assert best.info == ref.info and best.budget == ref.budget
    np.testing.assert_array_equal(ad.best_path_points(), ref.points)
    g = ad.graph_summary()
    assert g["nodes"] == ref.n_nodes and g["best_info"] == ref.info
    capacity = 2 * KW["max_iter"] * tc.traj_count
    assert 0 < g["edges"] == ref.n_feasible_edges < capacity
    way, legs = ad.flight_plan()
    assert way.shape[1] == 4 and len(legs) >= len(ref.edges)
    np.testing.assert_allclose(way[0, :2], X0)
    np.testing.assert_allclose(way[-1, 3], ref.time, rtol=1e-9)
    lanes = ad.plan_batch(np.stack([X0, X0]), [1, 2], [12.0, 12.0])
    assert lanes[0].info == ref.info


def test_closed_loop_ergodic_matches_jax(monkeypatch):
    """``ExplorationSim(planner_backend="device")``, SFEGP, kinematic
    flight, 2 replans, with JAX's filter and planner draws injected: JAX's
    rows to 1e-8 and scores to 1e-6 (test_torch_explore.py's bars).
    JAX's simulator builds its device planner in float32; here it is
    given float64 (its ``dtype`` argument), the port's precision on the
    CPU."""
    from test_torch_rig_device_paths import run_both

    got, ref, sim = run_both(
        monkeypatch, dict(multi_fidelity=False, ergodic=True, B=16, BD=2),
        seed=0, iters=6)
    assert sim._device_planner._planner.cost == "ergodic"
    assert all(r.best_info <= 0 for r in got.replans)  # -KL
