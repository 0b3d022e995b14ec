"""Named reference trajectories (SURVEY C26, reference/
PhysicalExperimentCode/backsteppingConfig.py).

The reference's backstepping controller tracks parametric (x, y, z, pitch)
curves selected by name (circle / line / line2 / pringle / ellipse / fig8 /
test / test2). Rebuilt vectorized: each generator maps a time array to
(T, 4) rows, usable directly as Manual-variant waypoint chains or
controller references.

Counterpart of ``mfgp_tpu/hw/trajectories.py``, copied as it is (numpy only).
"""

from __future__ import annotations

import numpy as np

_TWO_PI = 2.0 * np.pi


def _circle(t):
    f1 = f2 = f3 = 1 / 150
    a1, a2, a3, a4 = 1.0, 1.0, 0.3, 20.0
    pitch = np.deg2rad(a4) * np.sign(
        np.sin(_TWO_PI * f3 * (t + 0.1)) - np.sin(_TWO_PI * f3 * t))
    return np.column_stack([
        a1 * np.sin(_TWO_PI * f1 * t), a2 * np.sin(_TWO_PI * f2 * t),
        0.3 + a3 * np.sin(_TWO_PI * f3 * t), pitch])


def _line(t):
    f, a = 1 / 90, 25.0
    pitch = np.deg2rad(a) * np.sign(
        np.cos(_TWO_PI * f * (t + 0.1)) - np.cos(_TWO_PI * f * t))
    return np.column_stack([
        -1 + 0.015 * t, np.zeros_like(t),
        0.35 - 0.2 * np.cos(_TWO_PI * f * t), pitch])


def _line2(t):
    f, a = 1 / 75, 35.0
    return np.column_stack([
        -1 + 0.012 * t, -1 + 0.01 * t,
        0.35 - 0.2 * np.cos(_TWO_PI * f * t),
        -np.deg2rad(a) * np.sin(_TWO_PI * f * t)])


def _pringle(t):
    f = 1 / 60
    f2 = 0.5 * f
    a = 0.5
    return np.column_stack([
        0.5 * a * np.sin(_TWO_PI * f2 * t), a * np.cos(_TWO_PI * f2 * t),
        0.4 - 0.1 * np.cos(_TWO_PI * f * t),
        -np.deg2rad(20) * np.sin(_TWO_PI * f * t)])


def _ellipse(t):
    f, f2 = 1 / 90, 1 / 270
    return np.column_stack([
        np.cos(_TWO_PI * f2 * t), np.sin(_TWO_PI * f2 * t),
        0.4 - 0.1 * np.cos(_TWO_PI * f * t),
        -np.deg2rad(20) * np.sin(_TWO_PI * f * t)])


def _fig8(t):
    f, f2 = 1 / 75, 1 / 540
    s = 1.5
    a1, a2 = 0.8 * s, 1.0 * s
    off = np.pi / 4
    u = _TWO_PI * f2 * t + off
    return np.column_stack([
        -a2 * np.cos(u), -a1 * np.cos(u) * np.sin(u),
        0.35 - 0.15 * np.cos(_TWO_PI * f * t),
        -np.deg2rad(35) * np.sin(_TWO_PI * f * t)])


def _test(t):
    z = np.full_like(t, 0.4)
    return np.column_stack([np.zeros_like(t), np.zeros_like(t), z,
                            np.full_like(t, np.deg2rad(-20))])


def _test2(t):
    f, a = 1 / 120, 25.0
    return np.column_stack([
        np.zeros_like(t), np.zeros_like(t),
        0.35 - 0.2 * np.cos(_TWO_PI * f * t),
        -np.deg2rad(a) * np.sin(_TWO_PI * f * t)])


TRAJECTORIES = {
    "circle": _circle, "line": _line, "line2": _line2, "pringle": _pringle,
    "ellipse": _ellipse, "fig8": _fig8, "test": _test, "test2": _test2,
}


def reference_trajectory(name: str, t) -> np.ndarray:
    """(T,) times -> (T, 4) [x, y, z, pitch] rows for a named curve."""
    t = np.atleast_1d(np.asarray(t, float))
    try:
        return TRAJECTORIES[name](t)
    except KeyError:
        raise KeyError(f"unknown trajectory {name!r}; "
                       f"have {sorted(TRAJECTORIES)}") from None


def scale_to_workspace(xyz: np.ndarray, WS, max_depth,
                       margin: float = 0.1) -> np.ndarray:
    """Affinely map a reference curve into the workspace box (the
    reference's curves live in tank coordinates around the origin)."""
    xyz = np.asarray(xyz, float)[:, :3]
    lo = xyz.min(axis=0)
    hi = xyz.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    unit = (xyz - lo) / span
    tgt_lo = np.array([WS[0][0], WS[1][0], 0.0])
    tgt_hi = np.array([WS[0][1], WS[1][1], max_depth])
    pad = margin * (tgt_hi - tgt_lo)
    return tgt_lo + pad + unit * (tgt_hi - tgt_lo - 2 * pad)
