"""Motion-primitive synthesis and rollout as tensor programs (counterpart
of ``mfgp_tpu/planning/primitives_device.py``).

The host synthesis (``planning/primitives.py``) grows a variable-length
primitive list with end-of-sequence fixups; here the same case analysis
runs with static shapes on whole batches of candidate edges, so the device
planner (``planning/rig_device.py``) synthesizes and rolls out every
candidate of an iteration on the device.

Layout: a trajectory is a fixed (MAX_LEGS, 4) array of rows
``(leg_type, p1, p2, p3)`` with ``leg_type == NOOP`` padding:

  SPIRAL   (dz, radius, speed)      GLIDE  (glide_path, dz, speed)
  SWIM     (dist, speed, 0)         FLATDIVE (dz, speed, 0)

``MAX_LEGS = 2 * num_legs + 1``: each drawn leg can emit up to two
primitives in the fixup cases (close-out + swim remainder) plus one final
surfacing leg, the exact worst case of the host algorithm.

Every function takes a leading batch axis (one row per candidate edge)
instead of being vmapped per edge. The random numbers come in as tensors:
per edge, (num_legs, 3) uniforms ``(u_d, u_r, u_g)`` for depth or swim
share, radius and glide path, and one surfacing uniform (the radius of a
spiral surfacing leg, used for both surfacing rows as in the JAX package).
``generate_trajectories_batch`` draws them from a ``torch.Generator``;
given the JAX package's draws, the rows equal its rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mfgp_tpu_torch.planning.primitives import AgentConfig, Leg

NOOP = -1
SPIRAL = int(Leg.SPIRAL)
GLIDE = int(Leg.GLIDE)
SWIM = int(Leg.SWIM)
FLATDIVE = int(Leg.FLATDIVE)


def _swim_energy(t, cfg: AgentConfig):
    """primitives.swim_energy on tensors (quirk preserved, see there)."""
    f, a = cfg.tail_amp, cfg.tail_freq
    wt = 4 * math.pi * f * t
    return 0.5 * math.pi * a**2 * f * (torch.sin(wt) + wt)


def _leg_time_dist(leg, p1, p2, p3, cfg: AgentConfig):
    """(time, horizontal distance) of primitive rows (closed form); 0 for
    NOOP rows."""
    t = torch.where(leg == SPIRAL, torch.abs(p1 / p3),
                    torch.where(leg == GLIDE, torch.abs(p2 / p3),
                                torch.where(leg == SWIM, p1 / p2,
                                            torch.where(leg == FLATDIVE,
                                                        torch.abs(p1 / p2),
                                                        0.0))))
    d = torch.where(leg == GLIDE, p2 / torch.tan(p1),
                    torch.where(leg == SWIM, p1, 0.0))
    return t, d


def _leg_budget(leg, p1, p2, p3, cfg: AgentConfig):
    t, _ = _leg_time_dist(leg, p1, p2, p3, cfg)
    z = torch.zeros_like(t)  # constants in t's dtype (torch.where of two
    # Python floats makes a float32 tensor)
    return torch.where(
        (leg == SPIRAL) | (leg == GLIDE), z + cfg.glide_energy,
        torch.where(leg == SWIM, _swim_energy(t, cfg) * cfg.tail_energy_scale,
                    torch.where(leg == FLATDIVE, z + cfg.flat_dive_energy, z)))


def _leg_dz(leg, p1, p2):
    return torch.where((leg == SPIRAL) | (leg == FLATDIVE), p1,
                       torch.where(leg == GLIDE, p2, 0.0))


def _leg_dist(leg, p1, p2):
    """The horizontal distance of ``_leg_time_dist`` alone."""
    return torch.where(leg == GLIDE, p2 / torch.tan(p1),
                       torch.where(leg == SWIM, p1, 0.0))


def evaluate_trajectory_device(prims: torch.Tensor, cfg: AgentConfig):
    """Rollout of padded primitive rows (B, MAX_LEGS, 4).

    Returns (time, dist, max_underwater_time, waypoints (B, MAX_LEGS+1, 4),
    budget), each (B,) but the waypoints: the counterpart of
    primitives.evaluate_trajectory with identical accounting (waypoint
    rows: dist, depth, time, variance; variance resets at the surface;
    per-submersion max underwater time). Padding rows produce
    zero-duration waypoints that repeat the state. What a row adds is
    computed for all rows at once; the running sums, in row order, are the
    only sequential part (the JAX package's scan adds in the same order).
    """
    leg = prims[..., 0].long()
    p1, p2, p3 = prims[..., 1], prims[..., 2], prims[..., 3]
    noop = leg == NOOP
    leg_t, leg_d = _leg_time_dist(leg, p1, p2, p3, cfg)
    bud = torch.where(noop, 0.0, _leg_budget(leg, p1, p2, p3, cfg))
    leg_t = torch.where(noop, 0.0, leg_t)
    leg_d = torch.where(noop, 0.0, leg_d)
    dz = _leg_dz(leg, p1, p2)
    # swims accrue underwater time/variance only while submerged
    swim = leg == SWIM
    base = torch.where(noop, 0.0, torch.ones_like(leg_t))
    z = prims.new_zeros(prims.shape[0])
    t = dist = depth = var = tuw_cur = tuw_max = budget = z
    uw = torch.zeros_like(z, dtype=torch.bool)
    cols = [[z], [z], [z], [z]]
    for r in range(prims.shape[1]):
        lt = leg_t[:, r]
        accrue = torch.where(swim[:, r], uw.to(prims.dtype), base[:, r])
        t = t + lt
        tuw_cur = tuw_cur + accrue * lt
        var = var + cfg.variance_rate * accrue * lt
        dist = dist + leg_d[:, r]
        depth = depth + dz[:, r]
        budget = budget + bud[:, r]
        submerged = depth > 0.0
        resurfaced = ~submerged & (depth <= 0.1) & uw
        tuw_max = torch.maximum(tuw_max, tuw_cur)
        tuw_cur = torch.where(resurfaced, 0.0, tuw_cur)
        uw = submerged | (uw & ~resurfaced)
        var = torch.where(depth <= 0.0, 0.0, var)
        for c, v in zip(cols, (dist, depth, t, var)):
            c.append(v)
    tuw_max = torch.maximum(tuw_max, tuw_cur)
    budget = budget + cfg.time_energy * t
    pts = torch.stack([torch.stack(c, dim=1) for c in cols], dim=-1)
    return t, dist, tuw_max, pts, budget


def _mk(leg: int, p1, p2, p3, like: torch.Tensor) -> torch.Tensor:
    """(B, 4) rows ``(leg, p1, p2, p3)``; a float parameter is broadcast."""
    def col(v):
        return (v if isinstance(v, torch.Tensor)
                else torch.full_like(like, float(v)))

    return torch.stack([torch.full_like(like, float(leg)), col(p1), col(p2),
                        col(p3)], dim=-1)


def generate_trajectory_device(choices, distance, cfg: AgentConfig, u,
                               u_surf):
    """Counterpart of primitives.generate_trajectory for a batch of edges.

    choices: (B, num_legs) integer leg types; distance: (B,); u:
    (B, num_legs, 3) uniforms (u_d, u_r, u_g) per leg; u_surf: (B,) the
    surfacing uniform. Returns (B, 2*num_legs+1, 4) padded primitive rows
    satisfying the host invariants (surface finish, exact distance
    coverage), in ``distance``'s dtype.
    """
    num_legs = choices.shape[1]
    dtype = distance.dtype
    ref = distance
    noop = _mk(NOOP, 1.0, 1.0, 1.0, ref)
    ones = torch.ones_like(ref)

    def swim(d):
        return _mk(SWIM, d, cfg.swim_speed, ones, ref)

    def surface_prim(depth, sign):
        if cfg.surface_by_spiral:
            r = cfg.min_radius + u_surf * (cfg.max_radius - cfg.min_radius)
            return _mk(SPIRAL, -depth, r, sign * cfg.spiral_speed, ref)
        return _mk(FLATDIVE, -depth, sign * cfg.flat_dive_speed, ones, ref)

    dist = torch.zeros_like(ref)
    depth = torch.zeros_like(ref)
    done = torch.zeros_like(ref, dtype=torch.bool)
    rows = []
    for cnt in range(num_legs):  # static loop: slots are fixed
        c = choices[:, cnt, None]
        u_d = u[:, cnt, 0].to(dtype)
        u_r = u[:, cnt, 1].to(dtype)
        u_g = u[:, cnt, 2].to(dtype)
        final = cnt == num_legs - 1

        d_depth = u_d * cfg.max_depth  # target absolute depth draw
        dz = d_depth - depth
        r = cfg.min_radius + u_r * (cfg.max_radius - cfg.min_radius)
        gp_draw = cfg.min_glide_path + u_g * (cfg.max_glide_path
                                              - cfg.min_glide_path)
        d_swim = u_d * (distance - dist)
        sdz = torch.sign(dz)

        # drawn primitive per leg type
        prim = torch.where(
            c == SPIRAL, _mk(SPIRAL, dz, r, sdz * cfg.spiral_speed, ref),
            torch.where(
                c == GLIDE, _mk(GLIDE, gp_draw * sdz, dz,
                                sdz * cfg.vert_glide_speed, ref),
                torch.where(
                    c == SWIM, swim(d_swim),
                    torch.where(c == FLATDIVE,
                                _mk(FLATDIVE, dz, sdz * cfg.flat_dive_speed,
                                    ones, ref), noop))))
        dt = _leg_dist(prim[:, 0].long(), prim[:, 1], prim[:, 2])
        overshoot = dist + dt >= distance

        # ---- close-out variants (final leg or overshoot) ----
        rem = distance - dist
        # glide close-out: descend/ascend -depth at >= min glide angle,
        # then swim any remainder
        gp_close = torch.where(depth > 0, -ones, ones) * torch.clamp_min(
            torch.abs(torch.atan2(depth, rem)), cfg.min_glide_path)
        glide_a = _mk(GLIDE, gp_close, -depth, -cfg.vert_glide_speed, ref)
        glide_d = glide_a[:, 2] / torch.tan(glide_a[:, 1])
        glide_b = swim(torch.clamp_min(rem - glide_d, 0.0))
        glide_use_b = (rem - glide_d > 0.0)[:, None]
        swim_a = swim(rem)

        # spiral/flatdive final: surface first, then swim the remainder
        vert_first = torch.where(
            c == SPIRAL, _mk(SPIRAL, -depth, r, -cfg.spiral_speed, ref),
            _mk(FLATDIVE, -depth, -cfg.flat_dive_speed, ones, ref))

        is_vert = (c == SPIRAL) | (c == FLATDIVE)
        closing = (overshoot | final)[:, None]
        # overshoot + non-final only closes for GLIDE/SWIM (host `break`);
        # vertical legs never overshoot (dt == 0), so closing == final there
        emit_a = torch.where(
            closing,
            torch.where(is_vert, vert_first,
                        torch.where(c == GLIDE, glide_a, swim_a)),
            prim)
        emit_b = torch.where(
            closing,
            torch.where(is_vert, swim_a,
                        torch.where((c == GLIDE) & glide_use_b, glide_b,
                                    noop)),
            noop)
        # host SWIM-final surfaces after the swim when submerged
        swim_final_surface = closing & (c == SWIM) & (depth > 0)[:, None]
        emit_b = torch.where(swim_final_surface, surface_prim(depth, -1.0),
                             emit_b)

        emit_a = torch.where(done[:, None], noop, emit_a)
        emit_b = torch.where(done[:, None], noop, emit_b)
        rows += [emit_a, emit_b]

        # both emitted rows at once: (B, 2) distances and depth changes
        ab = torch.stack([emit_a, emit_b], dim=1)
        leg = ab[..., 0].long()
        d = _leg_dist(leg, ab[..., 1], ab[..., 2])
        dzz = _leg_dz(leg, ab[..., 1], ab[..., 2])
        dist = dist + d[:, 0] + d[:, 1]
        depth = depth + dzz[:, 0] + dzz[:, 1]
        done = done | closing[:, 0]

    # final surfacing when still submerged
    rows.append(torch.where((depth > 0.01)[:, None],
                            surface_prim(depth, +1.0), noop))
    return torch.stack(rows, dim=1)


def draw_edge_uniforms(generator: torch.Generator, shape, num_legs: int,
                       dtype=torch.float64):
    """(u (*shape, num_legs, 3), u_surf (*shape,)) from ``generator`` (a CPU
    generator), the uniforms one edge's synthesis reads."""
    u = torch.rand(tuple(shape) + (num_legs, 3), generator=generator,
                   dtype=torch.float64)
    u_surf = torch.rand(tuple(shape), generator=generator,
                        dtype=torch.float64)
    return u.to(dtype), u_surf.to(dtype)


def generate_trajectories_batch(generator: torch.Generator, choices,
                                distances, cfg: AgentConfig):
    """Synthesis of a batch: choices (B, n) int, distances (B,) ->
    (B, 2n+1, 4), the uniforms drawn from ``generator`` and placed on the
    distances' device."""
    u, u_surf = draw_edge_uniforms(generator, (choices.shape[0],),
                                   choices.shape[1], distances.dtype)
    return generate_trajectory_device(choices, distances, cfg,
                                      u.to(distances.device),
                                      u_surf.to(distances.device))


def padded_to_prims(padded) -> list:
    """Padded (L, 4) rows -> host primitive tuples (NOOPs dropped).

    The inverse mapping used when a device-planned path is handed to host
    consumers (runtime flight plans, evaluate_trajectory)."""
    if isinstance(padded, torch.Tensor):
        padded = padded.detach().cpu().numpy()
    out = []
    for row in np.asarray(padded):
        leg = int(row[0])
        if leg == NOOP:
            continue
        if leg in (SPIRAL, GLIDE):
            out.append((Leg(leg), float(row[1]), float(row[2]),
                        float(row[3])))
        else:  # SWIM / FLATDIVE
            out.append((Leg(leg), float(row[1]), float(row[2])))
    return out
