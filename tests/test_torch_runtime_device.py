"""Parity of the port's device runtime (``mfgp_tpu_torch.hw.runtime_device``)
with ``mfgp_tpu.hw.runtime_device`` on the CPU, in float64.

The port reads its tick noise from a tensor; the JAX package draws
``normal(fold_in(key, i), (13,))`` at tick i (a coarse window reads its
first tick's row), so ``jax_tick_noise`` rebuilds those rows from the key
and the port flies on them.

The closed loop amplifies rounding: JAX's and torch's ``atan2``/``tan``/
``exp`` differ in the last bit of some results, and the difference doubles
every ~1.5 s of flight (measured on an 80 s plan: 1e-17 at tick 0, 1e-14
at tick 100, 4e-11 at tick 300, 2e-7 at tick 600). The plans held to
1e-8 relative therefore fly under ~30 s (at most ~300 ticks).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.hw.runtime import RuntimeConfig as JRC
from mfgp_tpu.hw.runtime_device import DeviceRuntime as JDR
from mfgp_tpu.planning.primitives import AgentConfig as JA
from mfgp_tpu.planning.primitives import Leg as JLeg
from mfgp_tpu.planning.primitives import evaluate_trajectory as j_eval
from mfgp_tpu.planning.primitives import generate_trajectory as j_gen
from mfgp_tpu_torch.hw.plant import GliderPlant, PlantParams
from mfgp_tpu_torch.hw.runtime import RobotRuntime
from mfgp_tpu_torch.hw.runtime import RuntimeConfig as TRC
from mfgp_tpu_torch.hw.runtime_device import DevicePlan
from mfgp_tpu_torch.hw.runtime_device import DeviceRuntime as TDR
from mfgp_tpu_torch.planning.primitives import AgentConfig as TA

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


def jax_tick_noise(seed: int, n: int) -> np.ndarray:
    """(n, 13): the draws a JAX flight with ``key(seed)`` reads at ticks
    0..n-1 (mfgp_tpu/hw/runtime_device.py:242-243)."""
    key = jax.random.key(seed)
    return np.asarray(jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(key, i), (13,), jnp.float64))(jnp.arange(n)))


def plan(seed, choices, dist):
    """(waypoints, legs) of a synthesized edge (tests/test_runtime_device.py
    ``_plan``)."""
    cfg = JA.sim_defaults()
    _, prims = j_gen(np.random.default_rng(seed), list(choices), dist, cfg)
    _, _, _, w, _ = j_eval(prims, cfg)
    d = w[:, 0]
    return np.column_stack([d, np.zeros_like(d), w[:, 1], w[:, 2]]), \
        list(prims)


def zero_noise(rc, dt=0.1):
    return rc(dt=dt, fix_noise=0.0, fix_vel_noise=0.0, depth_noise=0.0,
              euler_noise=0.0, gyro_noise=0.0)


def rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.size \
        else 0.0


def assert_logs_close(got, ref, tol=TOL):
    for k in ("truth", "estimates", "samples"):
        assert rel(got[k], ref[k]) <= tol, k
    for k in ("tracking_rmse", "budget_used", "plan_budget"):
        assert got[k] == pytest.approx(ref[k], rel=tol, abs=tol), k
    for k, v in ref["carry"].items():
        assert rel(got["carry"][k][0].numpy(), np.asarray(v)) <= tol, k


# short plans (<= ~30 s) that fly all four primitives: flat dive, glide,
# swim (20 s) and spiral, swim, flat dive (27 s)
PLANS = [(3, (JLeg.FLATDIVE, JLeg.GLIDE, JLeg.SWIM), 1.5),
         (3, (JLeg.SPIRAL, JLeg.SWIM), 2.0)]


@pytest.mark.parametrize("seed,choices,dist", PLANS)
def test_fly_log_matches_jax_under_its_noise(seed, choices, dist):
    """Every log row, the carry and tracking_rmse within 1e-8 of the JAX
    runtime's, with its tick noise injected."""
    way, legs = plan(seed, choices, dist)
    t_cap = int(math.ceil(way[-1, 3] / 0.1)) + 1
    assert t_cap <= 320
    ref = JDR(JA.sim_defaults(), JRC(dt=0.1)).fly_log(way, legs, seed=7)
    got = TDR(TA.sim_defaults(), TRC(dt=0.1), device="cpu").fly_log(
        way, legs, noise=jax_tick_noise(7, t_cap))
    assert got["truth"].shape[0] == t_cap
    assert_logs_close(got, ref)


JAX_STRIDE4 = JDR(JA.sim_defaults(), JRC(dt=0.1), glide_stride=4)


@pytest.mark.parametrize("lanes", [1, 2])
def test_glide_stride_matches_jax(lanes):
    """glide_stride=4 (coarse GLIDE windows, fine elsewhere) against the
    JAX runtime's glide_stride=4: one lane, and two lanes of different
    plans, whose schedules disagree in some windows (those run both sides
    and select per lane)."""
    rt = TDR(TA.sim_defaults(), TRC(dt=0.1), device="cpu", glide_stride=4)
    plans = [plan(0, (JLeg.GLIDE, JLeg.SWIM), 2.0),
             plan(4, (JLeg.GLIDE, JLeg.SWIM), 1.5)]
    # one capacity for both cases: one compile of the JAX runtime
    t_cap = max(int(math.ceil(w[-1, 3] / 0.1)) + 1 for w, _ in plans)
    plans = plans[:lanes]
    n = -(-t_cap // 4) * 4
    packed = [rt.pack_plan(*p) for p in plans]
    lane_plan = DevicePlan(*[torch.cat([getattr(p, k) for p in packed])
                             for k in DevicePlan._fields])
    carry = {k: torch.cat([rt.init_carry(w[0, 0], w[0, 1])[k]
                           for w, _ in plans]) for k in rt.init_carry()}
    noise = np.stack([jax_tick_noise(5 + l, n) for l in range(lanes)])
    got, logs = rt.fly(lane_plan, carry, noise, t_cap)
    st = rt.last_fly
    assert st["coarse"] > 0
    assert (st["fine"] if lanes == 1 else st["mixed"]) > 0
    for l, (way, legs) in enumerate(plans):
        ref = JAX_STRIDE4.fly_log(way, legs, seed=5 + l, t_cap=t_cap)
        alive = logs["alive"][l].numpy()
        t = logs["t"][l].numpy()[alive]
        truth = logs["truth"][l].numpy()[alive]
        assert rel(np.column_stack([t, truth]), ref["truth"][:, :4]) <= TOL
        assert rel(got["budget"][l].numpy(), ref["budget_used"]) <= TOL
        for k, v in ref["carry"].items():
            assert rel(got[k][l].numpy(), np.asarray(v)) <= TOL, k


@pytest.mark.parametrize("seed,choices,dist", [
    (0, (JLeg.GLIDE, JLeg.SWIM, JLeg.FLATDIVE), 2.0),
    (12, (JLeg.FLATDIVE, JLeg.GLIDE, JLeg.SWIM), 1.5)])
def test_zero_noise_matches_host_runtime(seed, choices, dist):
    """With every noise scale at zero the device loop integrates the same
    trajectory as the port's host ``RobotRuntime.fly`` (the JAX package's
    own contract, tests/test_runtime_device.py:46)."""
    way, legs = plan(seed, choices, dist)
    cfg = TA.sim_defaults()
    host = RobotRuntime(cfg, zero_noise(TRC), seed=1, device="cpu",
                        plant=GliderPlant(PlantParams.from_agent(cfg)))
    hlog = host.fly(way, legs)
    dlog = TDR(cfg, zero_noise(TRC), device="cpu").fly_log(way, legs)
    assert dlog["truth"].shape[0] == hlog.truth.shape[0]
    np.testing.assert_allclose(dlog["truth"][:, 0], hlog.truth[:, 0],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(dlog["truth"][:, 1:4], hlog.truth[:, 1:4],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dlog["estimates"][:, 1:7],
                               hlog.estimates[:, 5:11], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dlog["tracking_rmse"], hlog.tracking_rmse,
                               rtol=1e-6)
    np.testing.assert_allclose(dlog["budget_used"], hlog.budget_used,
                               rtol=1e-6)
    assert dlog["samples"].shape[0] == hlog.samples.shape[0]
    np.testing.assert_allclose(dlog["samples"][:, :7], hlog.samples[:, :7],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dlog["samples"][:, 8], hlog.samples[:, 8])


@pytest.mark.parametrize("stride", [1, 4])
def test_lanes_equal_solo_flights(stride):
    """L plans flown as lanes of one loop equal L solo flights bit for
    bit: every live log row and the carry."""
    cfg = TA.sim_defaults()
    rt = TDR(cfg, TRC(dt=0.1), device="cpu", glide_stride=stride)
    plans = [plan(s, (JLeg.GLIDE, JLeg.SWIM), 1.0 + 0.5 * s)
             for s in range(3)]
    t_cap = 240
    noise = torch.randn((3, t_cap, 13),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.float64)
    packed = [rt.pack_plan(*p) for p in plans]
    lanes = DevicePlan(*[torch.cat([getattr(p, k) for p in packed])
                         for k in DevicePlan._fields])
    carries = [rt.init_carry(p[0][0, 0], p[0][0, 1]) for p in plans]
    c3, l3 = rt.fly(lanes, {k: torch.cat([c[k] for c in carries])
                            for k in carries[0]}, noise, t_cap)
    for i in range(3):
        c1, l1 = rt.fly(packed[i], carries[i], noise[i:i + 1], t_cap)
        live = l1["alive"][0]
        assert torch.equal(live, l3["alive"][i])
        for k in l1:
            assert torch.equal(l3[k][i][live], l1[k][0][live]), k
        for k in c1:
            assert torch.equal(c3[k][i], c1[k][0]), k


def test_carry_persists_across_plans():
    way, legs = plan(3, (JLeg.SWIM,), 1.0)
    rt = TDR(TA.sim_defaults(), TRC(dt=0.1), device="cpu")
    log1 = rt.fly_log(way, legs, seed=1)
    log2 = rt.fly_log(way + np.array([1.0, 0, 0, 0.0]), legs,
                      carry=log1["carry"], seed=2)
    assert log2["budget_used"] > log1["budget_used"]
    assert log2["plan_budget"] == pytest.approx(
        log2["budget_used"] - log1["budget_used"], rel=1e-9)
    # the second plan's clock starts where the first ended
    assert log2["truth"][0, 0] > log1["truth"][-1, 0]


def test_early_stop_changes_nothing():
    """Stopping after the last live tick gives the flight that runs all
    t_cap ticks."""
    way, legs = plan(0, (JLeg.GLIDE, JLeg.SWIM), 1.0)
    a = TDR(TA.sim_defaults(), TRC(dt=0.1), device="cpu").fly_log(
        way, legs, seed=3, t_cap=400)
    b = TDR(TA.sim_defaults(), TRC(dt=0.1), device="cpu",
            early_stop=False).fly_log(way, legs, seed=3, t_cap=400)
    for k in ("truth", "estimates", "samples"):
        np.testing.assert_array_equal(a[k], b[k])


def test_pack_plan_raises_over_capacity():
    rt = TDR(TA.sim_defaults(), TRC(dt=0.1), device="cpu", w_cap=4,
             l_cap=3)
    way = np.zeros((5, 4))
    way[:, 3] = np.arange(5)
    with pytest.raises(ValueError, match="capacity"):
        rt.pack_plan(way, [(2, 1.0, 0.1)] * 4)
    with pytest.raises(ValueError, match="glide_stride"):
        TDR(TA.sim_defaults(), device="cpu", glide_stride=0)
