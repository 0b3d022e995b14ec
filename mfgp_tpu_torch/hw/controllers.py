"""Feedback controllers and signal utilities (SURVEY C23).

The reference's ``PID`` (low-pass-filtered derivative) and ``KPID``
(Kalman-estimated derivative) classes
(reference/PhysicalExperimentCode/controllerHelper.py:233-295) redone as
pure step functions over explicit state, with thin stateful wrappers
matching the original call pattern for the host control loop.

Counterpart of ``mfgp_tpu/hw/controllers.py``, copied as it is (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np


def saturate(x, lower, upper):
    """Clamp (reference/controllerHelper.py:202-203)."""
    return np.minimum(np.maximum(x, lower), upper)


def angle_wrap(angle, wrap_val):
    """Wrap into [-wrap_val, wrap_val)
    (reference/controllerHelper.py:205-206)."""
    return (angle + wrap_val) % (2.0 * wrap_val) - wrap_val


def yaw_correction(yaw, yaw_d, wrap_val, min_val=-70.0, max_val=70.0, k=1.0):
    """Wrapped, gain-scaled, clipped yaw error
    (reference/controllerHelper.py:189-196)."""
    return saturate(k * angle_wrap(yaw - yaw_d, wrap_val), min_val, max_val)


def simple_lpf(x, last_state, r):
    """First-order low-pass (reference/controllerHelper.py:198-200)."""
    return r * x + (1 - r) * last_state


class PIDState(NamedTuple):
    sum_err: float
    last_err: float
    lpf_term: float


@dataclass(frozen=True)
class PIDGains:
    kp: float = 1.0
    ki: float = 1.0
    kd: float = 1.0
    smoothing: float = 0.8  # LPF factor on the derivative term
    clip: Optional[Tuple[float, float]] = None  # integral anti-windup


def pid_init() -> PIDState:
    return PIDState(0.0, 0.0, 0.0)


def pid_step(g: PIDGains, s: PIDState, e, dt):
    """One PID update; returns (u, state'). Derivative is LPF'd when
    smoothing < 1 (reference/controllerHelper.py:251-261)."""
    sum_err = s.sum_err + e * dt
    if g.clip is not None:
        sum_err = saturate(sum_err, g.clip[0], g.clip[1])
    raw_der = (e - s.last_err) / dt
    if g.smoothing < 1:
        der = g.smoothing * raw_der + (1 - g.smoothing) * s.lpf_term
        lpf = der
    else:
        der = raw_der
        lpf = s.lpf_term
    u = g.kp * e + g.ki * sum_err + g.kd * der
    return u, PIDState(sum_err, e, lpf)


class KPIDState(NamedTuple):
    x: np.ndarray  # (2, 1) [error, error-rate]
    P: np.ndarray  # (2, 2)
    sum_err: float


def kpid_init() -> KPIDState:
    return KPIDState(np.zeros((2, 1)), np.eye(2), 0.0)


def kpid_step(g: PIDGains, s: KPIDState, e, dt, r_meas: float = 0.01):
    """PID whose derivative comes from a 2-state constant-rate KF on the
    error signal (reference/controllerHelper.py:263-295)."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    x = A @ s.x
    P = A @ s.P @ A.T + np.eye(2)
    H = np.array([[1.0, 0.0]])
    K = P @ H.T / float((H @ P @ H.T).item() + r_meas)
    x = x + K * (e - float(x[0, 0]))
    P = (np.eye(2) - K @ H) @ P
    sum_err = s.sum_err + e * dt
    if g.clip is not None:
        sum_err = saturate(sum_err, g.clip[0], g.clip[1])
    u = g.kp * x[0, 0] + g.ki * sum_err + g.kd * x[1, 0]
    return u, KPIDState(x, P, sum_err)


class PID:
    """Stateful wrapper with the reference's constructor/``run`` signature."""

    def __init__(self, kp=1.0, ki=1.0, kd=1.0, clip=None,
                 smoothing_factor=0.8):
        self.gains = PIDGains(kp, ki, kd, max(smoothing_factor, 1e-4), clip)
        self.state = pid_init()

    def run(self, e, dt):
        u, self.state = pid_step(self.gains, self.state, e, dt)
        return u


class KPID:
    def __init__(self, kp=1.0, ki=1.0, kd=1.0, clip=None):
        self.gains = PIDGains(kp, ki, kd, 1.0, clip)
        self.state = kpid_init()

    def run(self, e, dt):
        u, self.state = kpid_step(self.gains, self.state, e, dt)
        return u


def tail_wave(t, bias, amp, freq, wave: str = "square"):
    """Instantaneous tail-servo angle of the swim gait — the pure function
    behind the reference's 50 Hz ``Swimming`` thread
    (reference/controllerHelper.py:297-344). Vectorizes over t for
    simulation/energy integration."""
    t = np.asarray(t, float)
    if wave == "square":
        phase = np.floor(2.0 * np.maximum(freq, 0.05) * t) % 2
        return bias + np.where(phase < 1, amp, -amp)
    if wave == "sin":
        return bias + amp * np.sin(2 * np.pi * freq * t)
    raise ValueError(wave)
