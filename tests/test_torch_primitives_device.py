"""Parity of the port's motion-primitive synthesis and rollout
(``mfgp_tpu_torch.planning.primitives_device``) with
``mfgp_tpu.planning.primitives_device`` on the CPU, in float64.

``jax.random`` and ``torch.Generator`` draw different streams, so the port
is given the JAX package's own draws: ``jax_edge_uniforms`` and
``jax_plan_draws`` rebuild, from a key alone, every number a JAX edge or a
JAX plan reads (its key splits are the same whatever the state), in the
layout the port's functions take. The device planner's tests
(``test_torch_rig_device*.py``) import them from here.

One difference is not the port's: the glide close-out swims the remainder
``rem - glide_d``, which is zero up to rounding when the glide covers the
whole distance; JAX's and torch's ``atan2``/``tan`` differ in the last
bit of ~1 % of their results, so one package emits a swim of ~1e-16 m
where the other emits the padding row. Rows are compared with swims
shorter than 1e-12 m taken as padding (``_canon``); the rollouts, which
such a swim moves by ~1e-15, are compared as they are.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.planning import primitives_device as jpd
from mfgp_tpu.planning.primitives import AgentConfig as JCfg
from mfgp_tpu_torch.planning import primitives as tprim
from mfgp_tpu_torch.planning import primitives_device as tpd
from mfgp_tpu_torch.planning.primitives import AgentConfig as TCfg

TOL = 1e-12


@partial(jax.jit, static_argnums=(1, 2))
def jax_edge_uniforms(keys, num_legs: int, dtype):
    """(u (E, num_legs, 3), u_surf (E,)) that
    ``generate_trajectory_device(key, ...)`` draws from each key of
    ``keys`` (mfgp_tpu/planning/primitives_device.py:163-171,241,265)."""
    def one(key):
        ks = jax.random.split(key, num_legs + 1)

        def leg(k):
            k1, k2, k3 = jax.random.split(k, 3)
            return jnp.stack([jax.random.uniform(k1, dtype=dtype),
                              jax.random.uniform(k2, dtype=dtype),
                              jax.random.uniform(k3, dtype=dtype)])

        return (jax.vmap(leg)(ks[:num_legs]),
                jax.random.uniform(ks[-1], dtype=dtype))

    return jax.vmap(one)(keys)


def jax_plan_draws(key, max_iter: int, near_neighbors: int, cfg,
                   dtype=jnp.float64) -> np.ndarray:
    """(max_iter, width) draws of one ``DeviceRIG.plan`` from its key, in
    the port's layout (``DeviceRIG.draws``): per iteration the sample's two
    uniforms (``body``, mfgp_tpu/planning/rig_device.py:917-919), then per
    extension phase the E x num_legs leg choices, the edges' uniforms and
    their surfacing uniforms (``extend``, :497,518-520)."""
    E, nl = cfg.traj_count, cfg.num_legs
    logp = jnp.log(jnp.asarray(list(cfg.leg_probs), dtype))
    rows = []
    for _ in range(max_iter):
        key, k1 = jax.random.split(key)
        rec = [np.asarray(jax.random.uniform(k1, (2,), dtype))]
        for _phase in range(1 + near_neighbors):
            key, k_edges = jax.random.split(key)
            ek = jax.random.split(k_edges, E + 1)
            ch = jax.random.categorical(ek[0], logp, shape=(E, nl))
            u, us = jax_edge_uniforms(ek[1:], nl, dtype)
            rec += [np.asarray(ch, float).ravel(), np.asarray(u).ravel(),
                    np.asarray(us).ravel()]
        rows.append(np.concatenate(rec))
    return np.stack(rows)


def jax_lane_draws(key, lanes: int, max_iter: int, near_neighbors: int,
                   cfg, dtype=jnp.float64) -> np.ndarray:
    """(lanes, max_iter, width): one plan's draws (lanes 1) or a
    ``plan_ensemble``'s, whose lanes take ``jax.random.split(key, lanes)``
    (mfgp_tpu/planning/rig_device.py:1036)."""
    keys = [key] if lanes == 1 else list(jax.random.split(key, lanes))
    return np.stack([jax_plan_draws(k, max_iter, near_neighbors, cfg, dtype)
                     for k in keys])


def configs(spiral: bool, probs=(0.25, 0.25, 0.25, 0.25)):
    jc, tc = JCfg.sim_defaults(), TCfg.sim_defaults()
    for c in (jc, tc):
        c.surface_by_spiral = spiral
        c.leg_probs = probs
    return jc, tc


def edges(n: int, seed: int, num_legs: int = 3):
    """Keys, leg choices and distances of n edges, and the keys' uniforms."""
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), n)
    ch = rng.integers(0, 4, (n, num_legs))
    dist = rng.uniform(0.1, 8.0, n)
    u, us = jax_edge_uniforms(keys, num_legs, jnp.float64)
    return keys, ch, dist, np.array(u), np.array(us)


def jax_rows(cfg, keys, ch, dist):
    nl = ch.shape[1]
    return np.array(jax.vmap(
        lambda k, c, d: jpd.generate_trajectory_device(k, c, d, cfg, nl))(
            keys, jnp.asarray(ch), jnp.asarray(dist)))


def _canon(rows):
    """Swims shorter than 1e-12 m as padding rows (see module docstring)."""
    rows = rows.copy()
    tiny = (rows[..., 0] == tpd.SWIM) & (np.abs(rows[..., 1]) < 1e-12)
    rows[tiny] = [tpd.NOOP, 1.0, 1.0, 1.0]
    return rows, int(tiny.sum())


@pytest.mark.parametrize("spiral", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_generate_matches_jax(spiral, seed):
    """128 edges of every leg type through both packages' synthesis with
    the same draws: the same rows to 1e-12 (rounding-level remainder swims
    as padding), covering the close-out of the final leg, the overshoot
    close-out of an earlier leg, the glide close-out's remainder swim and
    the surfacing legs (spirals with ``surface_by_spiral``)."""
    jc, tc = configs(spiral)
    keys, ch, dist, u, us = edges(128, seed)
    ref = jax_rows(jc, keys, ch, dist)
    got = tpd.generate_trajectory_device(
        torch.as_tensor(ch), torch.as_tensor(dist), tc, torch.as_tensor(u),
        torch.as_tensor(us)).numpy()
    assert got.shape == ref.shape == (128, 7, 4)
    (g, _), (r, _) = _canon(got), _canon(ref)
    np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)
    # the rounding-level remainders are the only rows that differ, and few
    assert (np.abs(got - ref) > TOL).any(axis=(1, 2)).sum() <= 6
    # branch coverage of the JAX rows
    leg = ref[..., 0]
    early = (leg[:, 4] == tpd.NOOP) & (leg[:, 0] != tpd.NOOP)
    assert early.sum() >= 5  # overshoot closed before the last leg
    assert ((leg[:, 0::2][:, :3] == tpd.GLIDE)
            & (leg[:, 1::2][:, :3] == tpd.SWIM)).any(axis=1).sum() >= 5
    # a swim that closes submerged surfaces next (an emit_b slot)
    surf = tpd.SPIRAL if spiral else tpd.FLATDIVE
    assert (leg[:, 1::2] == surf).any(axis=1).sum() >= 5


@pytest.mark.parametrize("spiral", [False, True])
def test_evaluate_matches_jax(spiral):
    """The rollout of JAX's own rows: time, distance, max underwater time,
    waypoints and budget to 1e-12."""
    jc, tc = configs(spiral)
    keys, ch, dist, _, _ = edges(128, 5)
    rows = jax_rows(jc, keys, ch, dist)
    ref = jax.vmap(lambda p: jpd.evaluate_trajectory_device(p, jc))(
        jnp.asarray(rows))
    got = tpd.evaluate_trajectory_device(torch.as_tensor(rows), tc)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("spiral", [False, True])
def test_rollout_of_port_rows_matches_jax(spiral):
    """Synthesis and rollout together, each package on its own rows."""
    jc, tc = configs(spiral, probs=(0.0, 1 / 3, 1 / 3, 1 / 3))
    keys, ch, dist, u, us = edges(96, 7)
    ch = np.where(ch == 0, 2, ch)  # the simulator's agent never spirals
    ref = jax.vmap(lambda p: jpd.evaluate_trajectory_device(p, jc))(
        jnp.asarray(jax_rows(jc, keys, ch, dist)))
    got = tpd.evaluate_trajectory_device(tpd.generate_trajectory_device(
        torch.as_tensor(ch), torch.as_tensor(dist), tc, torch.as_tensor(u),
        torch.as_tensor(us)), tc)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=1e-11)


def test_leg_helpers_match_jax():
    """``_leg_time_dist``, ``_leg_budget`` and ``_swim_energy`` on random
    rows of every leg type (NOOP included)."""
    jc, tc = configs(False)
    rng = np.random.default_rng(3)
    leg = rng.integers(-1, 4, 200)
    p = rng.uniform(0.2, 3.0, (3, 200)) * rng.choice([-1.0, 1.0], (3, 200))
    jl, tl = jnp.asarray(leg), torch.as_tensor(leg)
    jp = [jnp.asarray(a) for a in p]
    tp = [torch.as_tensor(a) for a in p]
    for a, b in zip(tpd._leg_time_dist(tl, *tp, tc),
                    jpd._leg_time_dist(jl, *jp, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL)
    np.testing.assert_allclose(tpd._leg_budget(tl, *tp, tc).numpy(),
                               np.asarray(jpd._leg_budget(jl, *jp, jc)),
                               rtol=TOL)
    t = np.abs(p[0]) * 50
    np.testing.assert_allclose(
        tpd._swim_energy(torch.as_tensor(t), tc).numpy(),
        np.asarray(jpd._swim_energy(jnp.asarray(t), jc)), rtol=TOL)


def test_padded_to_prims_matches_jax():
    jc, _ = configs(True)
    keys, ch, dist, _, _ = edges(16, 9)
    rows = jax_rows(jc, keys, ch, dist)
    for r in rows:
        assert tpd.padded_to_prims(r) == jpd.padded_to_prims(r)
        assert tpd.padded_to_prims(torch.as_tensor(r)) == \
            jpd.padded_to_prims(r)


def test_generator_draws_keep_host_invariants():
    """The port's own draws (``generate_trajectories_batch`` from a seeded
    generator): reproducible, and every edge ends at the surface, covers
    its distance, and rolls out as the host ``evaluate_trajectory`` rolls
    out its primitives."""
    _, tc = configs(False, probs=(0.0, 1 / 3, 1 / 3, 1 / 3))
    rng = np.random.default_rng(4)
    ch = torch.as_tensor(rng.integers(1, 4, (64, 3)))
    dist = torch.as_tensor(rng.uniform(0.5, 6.0, 64))
    rows = tpd.generate_trajectories_batch(torch.Generator().manual_seed(2),
                                           ch, dist, tc)
    again = tpd.generate_trajectories_batch(torch.Generator().manual_seed(2),
                                            ch, dist, tc)
    assert torch.equal(rows, again)
    t, d, tuw, wpts, budget = tpd.evaluate_trajectory_device(rows, tc)
    np.testing.assert_allclose(d.numpy(), dist.numpy(), rtol=1e-9)
    assert np.all(np.abs(wpts[:, -1, 1].numpy()) < 0.02)  # at the surface
    for i in range(64):
        h = tprim.evaluate_trajectory(tpd.padded_to_prims(rows[i]), tc)
        np.testing.assert_allclose([h[0], h[1], h[2], h[4]],
                                   [t[i], d[i], tuw[i], budget[i]],
                                   rtol=1e-9, atol=1e-9)
