"""Parity of the port's robot runtime (``mfgp_tpu_torch.hw.runtime``) with
``mfgp_tpu`` on the CPU, in float64.

``RobotRuntime.fly`` of the same short plans from the same seed and plant:
every ``FlightLog`` array within 1e-8 of the JAX package's (the loop is the
same NumPy code; the body-velocity observer is the port's torch function
where the JAX package jits its own). The flight-plan builders on a seeded
``RIGPlanner`` and the derived tail weight are equal, and ``FlightLog.save``
writes the same bytes.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mfgp_tpu.hw import plant as jplant
from mfgp_tpu.hw import runtime as jrt
from mfgp_tpu.planning import primitives as jpr
from mfgp_tpu.planning import rig as jrig
from mfgp_tpu.planning import scoring as jsc
from mfgp_tpu_torch.hw import plant as tplant
from mfgp_tpu_torch.hw import runtime as trt
from mfgp_tpu_torch.planning import primitives as tpr
from mfgp_tpu_torch.planning import rig as trig
from mfgp_tpu_torch.planning import scoring as tsc

TOL = 1e-8
LOG_ARRAYS = ("estimates", "control", "traj_info", "measurements", "samples",
              "truth")


def plan(pr, seed, choices, dist):
    """The JAX runtime tests' plan builder (tests/test_runtime.py:_plan)."""
    cfg = pr.AgentConfig.sim_defaults()
    rng = np.random.default_rng(seed)
    _, prims = pr.generate_trajectory(rng, list(choices), dist, cfg)
    _, _, _, wpnts, _ = pr.evaluate_trajectory(prims, cfg)
    d = wpnts[:, 0]
    way = np.column_stack([d, np.zeros_like(d), wpnts[:, 1], wpnts[:, 2]])
    return way, list(prims), cfg


def legs_of(pr, names):
    return [getattr(pr.Leg, n) for n in names]


def fly_both(seed, names, dist, flights=1, **rt_kw):
    logs = {}
    for lib, pr, rt_mod, pl_mod, kw in (
            ("jax", jpr, jrt, jplant, {}),
            ("torch", tpr, trt, tplant, {"device": "cpu"})):
        way, legs, cfg = plan(pr, seed, legs_of(pr, names), dist)
        field = lambda x, y, z: 5.0 * math.exp(-0.05 * ((x - 3) ** 2 + y * y
                                                        + z * z))
        plant = pl_mod.GliderPlant(pl_mod.PlantParams.from_agent(cfg))
        rt = rt_mod.RobotRuntime(cfg, rt_mod.RuntimeConfig(**rt_kw),
                                 plant=plant, seed=seed, field_fn=field,
                                 max_depth=cfg.max_depth, **kw)
        logs[lib] = [rt.fly(way + np.array([3.0 * k, 0, 0, 0]), legs)
                     for k in range(flights)]
        logs[lib + "_rt"] = rt
    return logs


def assert_logs_close(a, b):
    for name in LOG_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL, err_msg=name)
    for name in ("budget_used", "plan_budget", "tracking_rmse"):
        assert getattr(a, name) == pytest.approx(getattr(b, name), rel=TOL,
                                                 abs=TOL), name


@pytest.mark.parametrize("seed,names,dist", [
    (0, ("GLIDE", "SWIM", "FLATDIVE"), 3.0),
    (1, ("SPIRAL", "GLIDE"), 4.0),
    (3, ("SWIM",), 3.0),
])
def test_fly_matches_jax(seed, names, dist):
    """One flight per leg mix (every control law), a few hundred ticks."""
    logs = fly_both(seed, names, dist, dt=0.1)
    a, b = logs["torch"][0], logs["jax"][0]
    assert 100 <= a.estimates.shape[0] <= 2000
    assert a.samples.shape[0] > 0
    assert_logs_close(a, b)
    np.testing.assert_allclose(logs["torch_rt"].xhat, logs["jax_rt"].xhat,
                               rtol=TOL, atol=TOL)


def test_fly_state_carries_across_plans():
    """Two plans in a row on one runtime (KFs, observer and budget carry
    over), the tail weight given explicitly and the observer's divergence
    reset exercised by a tight ``vb_cap``."""
    logs = fly_both(2, ("GLIDE", "FLATDIVE"), 3.0, flights=2, dt=0.1,
                    udot_weights=(1.0, 1.0, 2.0, 1.0), vb_cap=0.05)
    for a, b in zip(logs["torch"], logs["jax"]):
        assert_logs_close(a, b)
    assert logs["torch"][1].budget_used > logs["torch"][0].budget_used


def test_control_laws_and_tail_weight():
    gains = np.asarray((100.0, 3000.0, 20.0, 3.0))
    e = np.array([[0.5], [0.1], [0.0], [-0.2]])
    for depth in (1.0, 9.99, 10.2):
        for s in (1, -1):
            assert trt.pump_spd_control2(depth, s * e, gains, 5e5, 10.0) == \
                jrt.pump_spd_control2(depth, s * e, gains, 5e5, 10.0)
    for args in ((0.0, 0.3, 0.0), (0.3, 0.0, 0.2), (-0.1, 0.4, -3.0)):
        assert trt.mass_spd_control(*args, (5.0, 0.5)) == \
            jrt.mass_spd_control(*args, (5.0, 0.5))
    assert trt.yaw_correction(3.0, -3.0) == jrt.yaw_correction(3.0, -3.0)
    way = np.array([[0, 0, 0, 0], [1, 2, 1, 5], [3, 2, 0, 9.0]])
    for t in (0.0, 2.5, 7.0, 20.0):
        assert np.array_equal(trt.traj_point(t, way), jrt.traj_point(t, way))
    ta, ja = tpr.AgentConfig.sim_defaults(), jpr.AgentConfig.sim_defaults()
    for dt, k in ((0.1, 5.0), (0.05, 3.0)):
        for wave in ("square", "sin"):
            assert trt.derived_tail_weight(ta, dt, k, wave) == \
                jrt.derived_tail_weight(ja, dt, k, wave)


def seeded_planners():
    """The same RIG replan in both packages: the ergodic cost on a fixed
    EID, the simulator's settings at a short tranche."""
    from mfgp_tpu_torch.metrics.eid import eid_grid

    grid = eid_grid([[0.0, 10.0], [0.0, 20.0]], 10.0, nums=(6, 8, 4))
    eid = np.random.default_rng(5).random(grid.shape[0])
    eid /= eid.sum()
    out = {}
    for lib, rig, sc, pr, kw in (
            ("jax", jrig, jsc, jpr, {}),
            ("torch", trig, tsc, tpr, {"device": "cpu",
                                       "dtype": torch.float64})):
        cfg = dataclasses.replace(pr.AgentConfig.sim_defaults(),
                                  fid_levels=(0.25, 2.25, 6.25),
                                  max_depth=10.0)
        p = rig.RIGPlanner(cfg=cfg, delta=10.0, B=15.0,
                           WS=np.array([[0.0, 10.0], [0.0, 20.0]]), R=1.25,
                           Rd=5.0, same_node_distance=1.0, budget_cutoff=0.9,
                           max_iter=12, seed=4,
                           cost=sc.ErgodicCost(eid=eid, grid=grid, **kw),
                           env=lambda pts: np.zeros(len(pts)))
        p.plan(np.array([[0.5], [1.0]]))
        out[lib] = p
    return out


def test_flight_plan_on_a_seeded_planner():
    """``flight_plan`` (and ``chain_to_flight_plan`` under it) of the best
    path of the same seeded replan: the same waypoints and legs."""
    ps = seeded_planners()
    assert ps["torch"].best_path.segments is not None
    way_t, legs_t = trt.flight_plan(ps["torch"])
    way_j, legs_j = jrt.flight_plan(ps["jax"])
    np.testing.assert_allclose(way_t, way_j, rtol=1e-12, atol=1e-12)
    assert [tuple(map(float, leg)) for leg in legs_t] == \
        [tuple(map(float, leg)) for leg in legs_j]
    triples = [(ps["torch"].E[(s.sn, s.en)][s.edge_idx].prims,
                [0.0, 0.0], [1.0, 1.0])
               for s in ps["torch"].best_path.segments]
    a = trt.chain_to_flight_plan(triples, ps["torch"].cfg)
    b = jrt.chain_to_flight_plan(triples, ps["jax"].cfg)
    assert np.array_equal(a[0], b[0])
    assert trt.chain_to_flight_plan([], ps["torch"].cfg) == (None, None)


def test_flight_log_save_bytes(tmp_path):
    """``FlightLog.save`` of the same arrays: the same four files, byte for
    byte, under the same names and headers."""
    rng = np.random.default_rng(9)
    arrays = dict(estimates=rng.normal(size=(7, 21)),
                  control=rng.normal(size=(7, 10)),
                  traj_info=rng.normal(size=(7, 9)),
                  measurements=rng.normal(size=(7, 12)),
                  samples=rng.normal(size=(2, 9)),
                  truth=rng.normal(size=(7, 7)))
    scalars = dict(budget_used=1.5, plan_budget=0.5, tracking_rmse=0.25)
    trt.FlightLog(**arrays, **scalars).save(str(tmp_path / "t"), "3")
    jrt.FlightLog(**arrays, **scalars).save(str(tmp_path / "j"), "3")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == ["control3.csv", "estimates3.csv", "measurements3.csv",
                     "trajInfo3.csv"]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


def test_observer_step_device_rule():
    """The runtime's observer runs on the card unless asked: without CUDA
    the default raises, and a CUDA graph on the CPU is refused."""
    from mfgp_tpu_torch.estimation.observers import GliderParams

    with pytest.raises(ValueError, match="CUDA graph"):
        trt.ObserverStep(GliderParams(), "cpu", graph=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.RobotRuntime(tpr.AgentConfig.sim_defaults())
