"""Glider motion primitives and trajectory synthesis.

SURVEY C8 (reference/GraceRIGV3.py:61-294,373-427): four leg types
(Spiral, Glide, Swim, FlatDive), random composition of ``num_legs`` legs
covering a node-to-node distance with surfacing fixups, a kinematic rollout
producing (distance, depth, time, accumulated-localization-variance)
waypoints, and the energy budget model.

Placement rationale (TPU-first does not mean everything-on-device): leg
composition is a few dozen scalar decisions with data-dependent branching —
it stays host-side numpy, driven by an explicit ``np.random.Generator`` for
determinism. The *hot* work — scoring hundreds of candidate paths against
GP posteriors and EID grids — happens in the batched, jitted scorers in
``planning.scoring``. Waypoint resampling produces fixed-rate arrays that
feed those device batches.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


class Leg(enum.IntEnum):
    SPIRAL = 0
    GLIDE = 1
    SWIM = 2
    FLATDIVE = 3


@dataclass
class AgentConfig:
    """Glider planning parameters (SURVEY C26; value defaults follow the
    reference agent's constructor, reference/GraceRIGV3.py:14-49, with the
    sim overrides applied by reference/exploreSimSettings.py:160-196)."""

    leg_probs: Sequence[float] = (0.25, 0.25, 0.25, 0.25)
    num_legs: int = 3
    traj_count: int = 20
    spiral_speed: float = 0.015
    vert_glide_speed: float = 0.015
    flat_dive_speed: float = 0.01
    swim_speed: float = 0.05
    meas_rate: float = 1.0  # Hz at which trajectory points are emitted
    max_depth: float = 1.0
    underwater_time_limit: float = 300.0
    variance_rate: float = 0.0  # localization variance growth per second
    min_radius: float = math.radians(40)
    max_radius: float = math.radians(90)
    min_glide_path: float = math.radians(30)
    max_glide_path: float = math.radians(90)
    surface_by_spiral: bool = False
    flat_dive_energy: float = 0.1
    glide_energy: float = 0.15
    time_energy: float = 0.005
    tail_amp: float = math.radians(45)
    tail_freq: float = 0.75
    tail_energy_scale: float = 0.5
    fid_levels: Sequence[float] = field(default_factory=list)

    @classmethod
    def sim_defaults(cls) -> "AgentConfig":
        """The simulation study's agent (reference/exploreSimSettings.py:
        160-196): no spirals, 10 m depth, Q-derived variance rate."""
        variance_rate = 0.005 + 0.05**2
        goal_var = 2.0**2
        return cls(
            leg_probs=(0.0, 1 / 3, 1 / 3, 1 / 3),
            traj_count=3, meas_rate=0.05, max_depth=10.0,
            swim_speed=0.3, spiral_speed=0.075, vert_glide_speed=0.075,
            flat_dive_speed=0.1, flat_dive_energy=0.1, glide_energy=0.15,
            tail_energy_scale=0.1, time_energy=0.005,
            variance_rate=variance_rate,
            underwater_time_limit=goal_var / variance_rate,
            fid_levels=((10 * np.array([0.05, 0.15, 0.25])) ** 2).tolist(),
        )


def swim_energy(t: float, cfg: AgentConfig) -> float:
    """Tail-flapping energy integral over a swim of duration t.

    The reference defines ``SwimEnergy(t, f, a) = 0.5 pi a^2 f (sin(wt)+wt)``
    with ``wt = 4 pi f t`` (reference/GraceRIGV3.py:61-63) but *calls* it as
    ``SwimEnergy(duration, tailAmp, tailFreq)`` (reference/GraceRIGV3.py:269)
    — amplitude lands in the frequency slot and vice versa. The budget
    numbers every experiment ran with use that argument order, so we keep
    its numerics (amp as "f", freq as "a") and document the quirk here.
    """
    f, a = cfg.tail_amp, cfg.tail_freq
    wt = 4 * math.pi * f * t
    return 0.5 * math.pi * a**2 * f * (math.sin(wt) + wt)


def _surface_prim(depth: float, cfg: AgentConfig, rng: np.random.Generator,
                  sign: float = -1.0):
    """Return-to-surface leg: spiral or flat dive per config
    (reference/GraceRIGV3.py:217-227)."""
    if cfg.surface_by_spiral:
        r = cfg.min_radius + rng.random() * (cfg.max_radius - cfg.min_radius)
        return (Leg.SPIRAL, -depth, r, sign * cfg.spiral_speed)
    return (Leg.FLATDIVE, -depth, sign * cfg.flat_dive_speed)


def evaluate_trajectory(prims, cfg: AgentConfig):
    """Kinematic rollout of a primitive sequence.

    Returns (time, distance, max_underwater_time, waypoints, budget) where
    waypoints is an (L+1, 4) array of (distance, depth, time, variance)
    rows. Semantics follow reference/GraceRIGV3.py:235-294: dive legs
    always accrue underwater time and localization variance; swims accrue
    them only while submerged; variance resets to zero at the surface; the
    underwater-time counter restarts on each resurfacing and the *max*
    segment is what the feasibility filter checks.
    """
    t = dist = budget = var = depth = 0.0
    tuws = [0.0]
    uw = False
    pts = [(0.0, 0.0, 0.0, 0.0)]
    for prim in prims:
        leg = prim[0]
        if leg == Leg.SPIRAL:
            _, dz, _, speed = prim
            leg_t = abs(dz / speed)
            t += leg_t; tuws[-1] += leg_t; var += cfg.variance_rate * leg_t
            depth += dz
            budget += cfg.glide_energy
        elif leg == Leg.GLIDE:
            _, gp, dz, speed = prim
            leg_t = abs(dz / speed)
            t += leg_t; tuws[-1] += leg_t; var += cfg.variance_rate * leg_t
            dist += dz / math.tan(gp)
            depth += dz
            budget += cfg.glide_energy
        elif leg == Leg.SWIM:
            _, d, speed = prim
            leg_t = d / speed
            t += leg_t
            tuws[-1] += uw * leg_t
            var += cfg.variance_rate * uw * leg_t
            dist += d
            budget += swim_energy(leg_t, cfg) * cfg.tail_energy_scale
        elif leg == Leg.FLATDIVE:
            _, dz, speed = prim
            leg_t = abs(dz / speed)
            t += leg_t; tuws[-1] += leg_t; var += cfg.variance_rate * leg_t
            depth += dz
            budget += cfg.flat_dive_energy
        if depth > 0:
            uw = True
        elif depth <= 0.1 and uw:
            uw = False
            tuws.append(0.0)
        if depth <= 0:
            var = 0.0
        pts.append((dist, depth, t, var))
    budget += cfg.time_energy * t
    return t, dist, max(tuws), np.array(pts), budget


def _leg_time_dist(prim, cfg):
    t, d, _, _, _ = evaluate_trajectory([prim], cfg)
    return t, d


def generate_trajectory(rng: np.random.Generator, choices, distance: float,
                        cfg: AgentConfig):
    """Compose a primitive sequence covering ``distance`` from leg-type
    choices, with the reference's end-of-sequence fixups
    (reference/GraceRIGV3.py:86-232): the last leg is stretched/shortened
    (glide at the minimum glide angle, swim of the remaining distance) and
    the glider always returns to the surface.

    Returns (total_time, prims). Raises if the invariant the reference
    checks interactively (surface + exact distance) is violated.
    """
    t_total = dist = depth = 0.0
    prims = []
    n = len(choices)
    for cnt, c in enumerate(choices, start=1):
        dz = 0.0
        if c == Leg.SPIRAL:
            d = rng.random() * cfg.max_depth
            dz = d - depth
            r = cfg.min_radius + rng.random() * (cfg.max_radius - cfg.min_radius)
            prim = (Leg.SPIRAL, dz, r, math.copysign(cfg.spiral_speed, dz))
        elif c == Leg.GLIDE:
            gp = cfg.min_glide_path + rng.random() * (cfg.max_glide_path
                                                      - cfg.min_glide_path)
            d = rng.random() * cfg.max_depth
            dz = d - depth
            prim = (Leg.GLIDE, gp * np.sign(dz), dz,
                    math.copysign(cfg.vert_glide_speed, dz))
        elif c == Leg.SWIM:
            d = rng.random() * (distance - dist)
            prim = (Leg.SWIM, d, cfg.swim_speed)
        elif c == Leg.FLATDIVE:
            d = rng.random() * cfg.max_depth
            dz = d - depth
            prim = (Leg.FLATDIVE, dz, math.copysign(cfg.flat_dive_speed, dz))
        else:
            continue
        tt, dt = _leg_time_dist(prim, cfg)

        if dist + dt < distance:
            if cnt == n:  # final leg: close out distance and surface
                if c == Leg.SPIRAL or c == Leg.FLATDIVE:
                    if c == Leg.SPIRAL:
                        prim = (Leg.SPIRAL, -depth, r, -cfg.spiral_speed)
                    else:
                        prim = (Leg.FLATDIVE, -depth, -cfg.flat_dive_speed)
                    depth = 0.0
                    tt, _ = _leg_time_dist(prim, cfg)
                    prims.append(prim)
                    prim = (Leg.SWIM, distance - dist, cfg.swim_speed)
                    tt2, dt2 = _leg_time_dist(prim, cfg)
                    t_total += tt + tt2
                    dist += dt2
                    prims.append(prim)
                elif c == Leg.SWIM:
                    prim = (Leg.SWIM, distance - dist, cfg.swim_speed)
                    tt, dt = _leg_time_dist(prim, cfg)
                    prims.append(prim)
                    if depth > 0:
                        sp = _surface_prim(depth, cfg, rng)
                        depth = 0.0
                        tt2, dt2 = _leg_time_dist(sp, cfg)
                        tt += tt2
                        dt += dt2
                        prims.append(sp)
                    t_total += tt
                    dist += dt
                elif c == Leg.GLIDE:
                    gp = -max(abs(math.atan2(depth, distance - dist)),
                              cfg.min_glide_path)
                    dz = -depth
                    prim = (Leg.GLIDE, gp, dz, -cfg.vert_glide_speed)
                    tt, dt = _leg_time_dist(prim, cfg)
                    prims.append(prim)
                    if distance > dist + dt:
                        prim = (Leg.SWIM, distance - dist - dt, cfg.swim_speed)
                        tt2, dt2 = _leg_time_dist(prim, cfg)
                        tt += tt2
                        dt += dt2
                        prims.append(prim)
                    t_total += tt
                    dist += dt
                    depth += dz
            else:
                t_total += tt
                dist += dt
                depth += dz
                prims.append(prim)
        else:  # leg overshoots the remaining distance
            if c == Leg.GLIDE:
                rem = distance - dist
                gp = math.copysign(
                    max(abs(math.atan2(depth, rem)), cfg.min_glide_path),
                    -1.0 if depth > 0 else 1.0)
                dz = -depth
                prim = (Leg.GLIDE, gp, dz, -cfg.vert_glide_speed)
                tt, dt = _leg_time_dist(prim, cfg)
                prims.append(prim)
                if distance > dist + dt:
                    prim = (Leg.SWIM, distance - dist - dt, cfg.swim_speed)
                    tt2, dt2 = _leg_time_dist(prim, cfg)
                    dt += dt2
                    tt += tt2
                    prims.append(prim)
                depth += dz
                t_total += tt
                dist += dt
            elif c == Leg.SWIM:
                prim = (Leg.SWIM, distance - dist, cfg.swim_speed)
                tt, dt = _leg_time_dist(prim, cfg)
                prims.append(prim)
                t_total += tt
                dist += dt
            break
    if depth > 0:  # still submerged after all legs: surface
        sp = _surface_prim(depth, cfg, rng, sign=+1.0)
        tt, dt = _leg_time_dist(sp, cfg)
        depth = 0.0
        t_total += tt
        dist += dt
        prims.append(sp)
    if abs(depth) > 0.01 or abs(dist - distance) > 0.001:
        raise RuntimeError(
            f"trajectory synthesis invariant violated: depth={depth}, "
            f"dist={dist} vs target {distance}, prims={prims}")
    return t_total, prims


def edge_points_to_traj_points(ps, pf, wpnts, meas_rate, t_off: float = 0.0):
    """Resample edge waypoints at the measurement rate and rotate into the
    workspace frame (reference/GraceRIVG3 edgePointsToTrajPoints,
    reference/GraceRIGV3.py:373-392).

    ps, pf: (2,) or (3,) endpoint planar states; wpnts: (L, 4) rollout rows
    (distance, depth, time, variance). Returns (T, 5) rows of
    (x, y, depth, t, variance).
    """
    ps = np.asarray(ps).reshape(-1)
    pf = np.asarray(pf).reshape(-1)
    b = math.atan2(pf[1] - ps[1], pf[0] - ps[0])
    wpnts = np.asarray(wpnts)
    tp = np.arange(0, wpnts[-1, 2], 1.0 / meas_rate) + t_off
    tsrc = wpnts[:, 2] + t_off
    d = np.interp(tp, tsrc, wpnts[:, 0])
    z = np.interp(tp, tsrc, wpnts[:, 1])
    v = np.interp(tp, tsrc, wpnts[:, 3])
    return np.column_stack([ps[0] + d * math.cos(b), ps[1] + d * math.sin(b),
                            z, tp, v])


def path_to_traj_points(node_states, edges, cfg: AgentConfig,
                        dense: bool = False, t_off: float = 0.0):
    """Concatenate a path's edges into one trajectory point array.

    node_states: mapping node idx -> planar state; edges: sequence of
    (idx1, idx2, prims) tuples in path order. ``dense=True`` resamples at
    ``cfg.meas_rate`` (reference/GraceRIGV3.py:394-427); otherwise raw
    rollout waypoints are used. Rows are (x, y, depth, t, variance),
    deduplicated at 1e-4 resolution preserving order, like the reference.

    Divergence note: the reference accumulates the next edge's time offset
    from the *last column* of the waypoint rows, which is the variance
    column when variances are tracked (reference/GraceRIGV3.py:422) —
    corrupting the (unused-by-scorers) time column. We accumulate from the
    time column.
    """
    rows = []
    for idx1, idx2, prims in edges:
        _, _, _, wpnts, _ = evaluate_trajectory(prims, cfg)
        ps = np.asarray(node_states[idx1]).reshape(-1)
        pf = np.asarray(node_states[idx2]).reshape(-1)
        if dense:
            rows.append(edge_points_to_traj_points(ps, pf, wpnts,
                                                   cfg.meas_rate, t_off))
        else:
            b = math.atan2(pf[1] - ps[1], pf[0] - ps[0])
            d = wpnts[:, 0]
            rows.append(np.column_stack([
                ps[0] + d * math.cos(b), ps[1] + d * math.sin(b),
                wpnts[:, 1], wpnts[:, 2] + t_off, wpnts[:, 3]]))
        t_off += wpnts[-1, 2]
    pts = np.concatenate(rows, axis=0) if rows else np.zeros((0, 5))
    _, ind = np.unique(np.round(pts, 4), axis=0, return_index=True)
    return pts[np.sort(ind)]
