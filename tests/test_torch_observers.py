"""Parity of the port's rotation helpers and body-velocity observer
(``mfgp_tpu_torch.estimation.observers``) with ``mfgp_tpu`` on the CPU, in
float64, at 1e-12: every function on the same seeded numpy inputs, and
``BodyVelocityObserver.step`` over a sequence of ticks, its NaN reset
included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.estimation import observers as jobs
from mfgp_tpu_torch.estimation import observers as tobs

TOL = 1e-12
CPU = torch.device("cpu")


def t64(a):
    return torch.tensor(np.asarray(a, float), dtype=torch.float64)


def close(port, ref, tol=TOL):
    port = [port] if isinstance(port, torch.Tensor) else port
    ref = [ref] if not isinstance(ref, (tuple, list)) else ref
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=tol,
                                   atol=tol)


@pytest.fixture
def angles():
    return np.random.default_rng(3).uniform(-1.2, 1.2, (6, 3))


def test_skew(angles):
    for w in angles:
        close(tobs.skew(t64(w)), jobs.skew(jnp.asarray(w)))


def test_euler_to_rotm(angles):
    for r, p, y in angles:
        close(tobs.euler_to_rotm(t64(r), t64(p), t64(y)),
              jobs.euler_to_rotm(r, p, y))
    # plain numbers as the JAX function takes them
    close(tobs.euler_to_rotm(0.3, -0.2, 1.1), jobs.euler_to_rotm(0.3, -0.2,
                                                                 1.1))


def test_rotm_to_euler(angles):
    for r, p, y in angles:
        R = np.asarray(jobs.euler_to_rotm(r, p, y))
        close(tobs.rotm_to_euler(t64(R)), jobs.rotm_to_euler(jnp.asarray(R)))


def test_flow_frame_and_euler_rates(angles):
    for a, b, _ in angles:
        close(tobs.flow_frame(t64(a), t64(b)), jobs.flow_frame(a, b))
        close(tobs.euler_rate_matrix(t64(a), t64(b)),
              jobs.euler_rate_matrix(a, b))


def test_buoyancy_mass():
    p = tobs.GliderParams(lp=2.5, bc=0.55)
    assert tuple(p) == tuple(jobs.GliderParams(lp=2.5, bc=0.55))
    for ppx in (0.0, 0.55, 1.0, 0.3):
        assert tobs.buoyancy_mass(t64(ppx), p).item() == pytest.approx(
            float(jobs.buoyancy_mass(ppx, jobs.GliderParams(lp=2.5, bc=0.55))),
            rel=TOL, abs=TOL)


def observer_inputs(seed):
    rng = np.random.default_rng(seed)
    r, p, y = rng.uniform(-0.8, 0.8, 3)
    return dict(omega=rng.normal(0, 0.2, 3), vb=rng.normal(0, 0.3, 3),
                z=rng.uniform(0, 3), zhat=rng.uniform(0, 3),
                ppx=rng.uniform(0, 1), delta=rng.uniform(-0.5, 0.5),
                angles=(r, p, y))


@pytest.mark.parametrize("seed", range(4))
def test_body_velocity_observer(seed):
    """Both derivatives for random states, rates and depths; the params
    the runtime uses (``lp``, ``bc`` recalibrated) and non-unit gains."""
    a = observer_inputs(seed)
    pj = jobs.GliderParams(lp=0.61, bc=0.55)
    pt = tobs.GliderParams(lp=0.61, bc=0.55)
    gains = (1.0, 2.0, 0.5)
    Rj = jobs.euler_to_rotm(*a["angles"])
    Rt = tobs.euler_to_rotm(*(t64(v) for v in a["angles"]))
    ref = jobs.body_velocity_observer(Rj, jnp.asarray(a["omega"]),
                                      jnp.asarray(a["vb"]), a["z"], a["zhat"],
                                      a["ppx"], a["delta"], pj, gains)
    got = tobs.body_velocity_observer(Rt, t64(a["omega"]), t64(a["vb"]),
                                      a["z"], a["zhat"], a["ppx"], a["delta"],
                                      pt, gains)
    close(list(got), list(ref))


def test_body_velocity_observer_zero_velocity():
    """V = 0 and v2 = 0: the branches that guard the sideslip angle."""
    p = tobs.GliderParams()
    ref = jobs.body_velocity_observer(jnp.eye(3), jnp.zeros(3), jnp.zeros(3),
                                      2.0, 1.0, 1.0, 0.2, jobs.GliderParams())
    got = tobs.body_velocity_observer(torch.eye(3, dtype=torch.float64),
                                      torch.zeros(3, dtype=torch.float64),
                                      torch.zeros(3, dtype=torch.float64),
                                      2.0, 1.0, 1.0, 0.2, p)
    close(list(got), list(ref))


def test_body_velocity_observer_step_sequence():
    """``BodyVelocityObserver.step`` over 40 ticks of 0.02 s (a step the
    explicit Euler integration is stable at on these inputs) from ``init``
    with the same measurements, then a measurement that makes the step NaN:
    both packages reset to zeros."""
    jo = jobs.BodyVelocityObserver(jobs.GliderParams(lp=0.7, bc=0.55))
    to = tobs.BodyVelocityObserver(tobs.GliderParams(lp=0.7, bc=0.55))
    vj, vt = jo.init(), to.init(device="cpu")
    assert vt.dtype == torch.float64 and vt.device == CPU
    close(vt, vj)
    rng = np.random.default_rng(11)
    for _ in range(40):
        ang = rng.uniform(-0.5, 0.5, 3)
        om = rng.normal(0, 0.1, 3)
        z, zhat, ppx, delta = rng.uniform(0, 2), rng.uniform(0, 2), \
            rng.uniform(0, 1), rng.uniform(-0.3, 0.3)
        vj = jo.step(vj, (jobs.euler_to_rotm(*ang), jnp.asarray(om), z, zhat,
                          ppx, delta), 0.02)
        vt = to.step(vt, (tobs.euler_to_rotm(*(t64(v) for v in ang)),
                          t64(om), z, zhat, ppx, delta), 0.02)
        close(vt, vj)
    assert 0 < np.abs(np.asarray(vj)).max() < 1.0
    nan_meas = (jnp.eye(3), jnp.zeros(3), float("nan"), 0.0, 0.5, 0.0)
    vj = jo.step(vj, nan_meas, 0.1)
    vt = to.step(vt, (torch.eye(3, dtype=torch.float64),
                      torch.zeros(3, dtype=torch.float64), float("nan"), 0.0,
                      0.5, 0.0), 0.1)
    assert not torch.isnan(vt).any()
    close(vt, vj)
    assert float(vt.abs().max()) == 0.0


def test_init_on_the_card_by_default():
    """``init`` builds on the card unless asked; without CUDA it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tobs.BodyVelocityObserver(tobs.GliderParams()).init()
