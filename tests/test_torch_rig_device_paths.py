"""Parity of the port's device planner with ``mfgp_tpu.planning.
rig_device`` on the CPU in float64, continued (see
``test_torch_rig_device.py`` for the setting and what is held): the
multi-fidelity sequential gain and the two batch log-det costs, each best
path re-scored by the host cost, and the gain costs' closed loop.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.planning import rig_device as jrd
from mfgp_tpu.sim import ExplorationSim as JSim
from mfgp_tpu.utils.configs import ExperimentConfig as JExp
from mfgp_tpu_torch.planning import primitives as tprim
from mfgp_tpu_torch.planning import primitives_device as tpd
from mfgp_tpu_torch.sim import ExplorationSim as TSim
from mfgp_tpu_torch.utils.configs import ExperimentConfig as TExp
from test_torch_explore import jax_kf_noise
from test_torch_primitives_device import jax_lane_draws
from test_torch_rig_device import GRID, check_cost, planners


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cost", ["mf_gain", "sf_logdet", "mf_logdet"])
def test_plan_matches_jax(cost, seed):
    got = check_cost(cost, seed)
    assert np.isfinite(got.info) and got.points.shape[0] > 0


def scored_points(res, cfg, S: int) -> np.ndarray:
    """(x, y, z, t, accrued variance) of a plan's edge samples, rebuilt on
    the host from its primitive chain (``tests/test_rig_device.py``'s
    reconstruction for the multi-fidelity costs)."""
    rows = []
    for padded, src, dst in res.edges:
        t, _, _, wpts, _ = tprim.evaluate_trajectory(
            tpd.padded_to_prims(padded), cfg)
        br = math.atan2(dst[1] - src[1], dst[0] - src[0])
        ts = np.linspace(0.0, t, S)
        dd, zz, vv = (np.interp(ts, wpts[:, 2], wpts[:, i])
                      for i in (0, 1, 3))
        rows.append(np.column_stack([src[0] + dd * np.cos(br),
                                     src[1] + dd * np.sin(br), zz, ts, vv]))
    return np.concatenate(rows, axis=0)


def test_scores_match_host_costs():
    """Each best path re-scored in float64 by the host cost on its points
    and accrued-variance fidelity labels (``tests/test_rig_device.py``'s
    checks of mf_gain, sf_logdet and mf_logdet)."""
    from mfgp_tpu_torch.models.gp import GP
    from mfgp_tpu_torch.models.mfgp import MFGP
    from mfgp_tpu_torch.planning.scoring import (BatchLogDetCost,
                                                 MFBatchLogDetCost,
                                                 MFInfoGainCost)

    rng = np.random.default_rng(1)
    X = rng.uniform([0, 0, 0], [10, 20, 5], (20, 3))
    y = np.sin(X[:, 0]) + np.cos(X[:, 1] / 3)
    fid = rng.integers(0, 3, 20)
    mf = MFGP(X, fid, y, jitter=1e-8, device="cpu")
    sf = GP(X, y, jitter=1e-8, device="cpu")
    for cost, host in (
            ("mf_gain", lambda fl: MFInfoGainCost(model=mf, fid_levels=fl)),
            ("sf_logdet", lambda fl: BatchLogDetCost(model=sf, grid=GRID)),
            ("mf_logdet", lambda fl: MFBatchLogDetCost(
                model=mf, grid=GRID, fid_levels=fl))):
        got = check_cost(cost, 0)
        _, tp, _, _, cfg = planners(cost)
        pts = scored_points(got, cfg, tp.S)
        assert pts.shape[0] == got.points.shape[0]
        np.testing.assert_allclose(pts[:, :3], got.points[:, :3],
                                   rtol=1e-9, atol=1e-9)
        assert got.info == pytest.approx(host(cfg.fid_levels)(pts),
                                         rel=1e-6, abs=1e-9), cost


def run_both(monkeypatch, kw: dict, seed: int, iters: int):
    """Both simulators with the device planner on one configuration: the
    port's with JAX's filter draws (``kf_noise``) and planner draws
    (``plan_draws``) injected, JAX's with its device planner and gain
    states in float64 (JAX's simulator builds them in float32: its
    ``dtype`` defaults). Asserts JAX's rows (1e-8), replans and scores
    (1e-6); returns (port result, JAX result, port sim)."""
    class F64RIG(jrd.DeviceRIG):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "dtype": jnp.float64})

    monkeypatch.setattr(jrd, "DeviceRIG", F64RIG)
    for name in ("prepare_sf_gain_state", "prepare_mf_gain_state"):
        monkeypatch.setattr(jrd, name, functools.partial(
            getattr(jrd, name), dtype=jnp.float64))
    ref = JSim(JExp(**kw), seed=seed, plan_iters=iters,
               planner_backend="device").run()
    agent = TExp(**kw).sim.agent()
    sim = TSim(TExp(**kw), seed=seed, plan_iters=iters, device="cpu",
               planner_backend="device", kf_noise=jax_kf_noise(seed),
               plan_draws=lambda s, lanes: jax_lane_draws(
                   jax.random.key(s), lanes, iters, 1, agent))
    got = sim.run()
    assert len(got.replans) == len(ref.replans) == 2
    np.testing.assert_allclose(got.gp_data.data, ref.gp_data.data,
                               rtol=1e-8, atol=1e-8)
    for a, b in zip(got.replans, ref.replans):
        assert (a.plan_num, a.nodes, a.edges, a.fit_mode) == \
            (b.plan_num, b.nodes, b.edges, b.fit_mode)
        assert a.best_info == pytest.approx(b.best_info, rel=1e-6, abs=1e-6)
        np.testing.assert_allclose(a.path_points, b.path_points, rtol=1e-8,
                                   atol=1e-8)
    assert got.budget_used == pytest.approx(ref.budget_used, rel=1e-6)
    assert got.rmse == pytest.approx(ref.rmse, rel=1e-6)
    return got, ref, sim


def test_closed_loop_gain_matches_jax(monkeypatch):
    """SFGP (the sequential gain) on the device planner: 2 replans as
    JAX's, with its draws injected; the gains are positive."""
    got, _, sim = run_both(
        monkeypatch, dict(multi_fidelity=False, ergodic=False, B=16, BD=2),
        seed=0, iters=6)
    assert sim._device_planner._planner.cost == "sf_gain"
    assert sim._gain_nmax == 512
    assert all(r.best_info > 0 for r in got.replans)
    assert got.model.X.dtype == torch.float64
