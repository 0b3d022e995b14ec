"""The robot runtime: the sense->estimate->control loop that FLIES plans.

This closes SURVEY L4/C25: it composes the pieces that existed separately —
``hw.io``/``hw.plant`` (sensors + actuators), ``hw.controllers`` (PID
utilities, tail gait), ``estimation.observers`` (body-velocity observer),
``estimation.kalman`` (KF core) — into the reference's main experiment loop
(reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
761-1033):

* per-tick sensing with noise, input-rate KF + tail first-order input
  estimator, and energy-budget integration ``BudgetUsed += sum(udot^2 * w)
  * dt`` (reference :795-806);
* fidelity timestamping of field samples by ``tr(Pxhat[0:2,0:2])``
  (reference :809-819);
* body-velocity observer + 6-state position KF with the reference's
  surface-gated measurement matrix (reference :821-872) and the
  depth-error KF feeding the pump control law (reference :874-875);
* the four per-primitive control laws: FlatDive (reference :884-900), Swim
  with the bearing -> tail bias/amp law (:902-934), Spiral (:937-955) and
  Glide with the rate-limited bias steering (:958-981), plus the
  end-of-path surfacing trim (:983-988);
* telemetry rows in the reference's estimates/control/trajInfo schemas.

Design stance: this is soft-real-time host robotics code, so the loop is
plain numpy (a few 6x6 KF ops per tick); the card does the heavy lifting
one level up, where the flown samples retrain the GP and re-score the
planner (sim.ExplorationSim with ``flight="dynamic"``).

Counterpart of ``mfgp_tpu/hw/runtime.py``. The one difference: the body-
velocity observer, which the JAX package calls as one jitted function per
tick, is the port's torch observer on the runtime's ``device`` (the card
unless asked otherwise), in float64 (:class:`ObserverStep`). On the card it
is captured once as a CUDA graph and replayed every tick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mfgp_tpu_torch.hw.controllers import saturate
from mfgp_tpu_torch.hw.controllers import yaw_correction as _yaw_correction
from mfgp_tpu_torch.hw.plant import GliderPlant, PlantParams
from mfgp_tpu_torch.planning.primitives import AgentConfig, Leg
from mfgp_tpu_torch.utils import profiling
from mfgp_tpu_torch.utils.device import CUDA, resolve

# -- control laws (reference/PhysicalExperimentCode/exploreExpSettings.py) --


def pump_spd_control2(depth, e_state, gains, k_max_depth, max_depth):
    """Pump-speed command from the depth-error KF state
    (reference/exploreExpSettings.py:43-54): a linear law on
    (e, de, dde, ddde) plus a hard term pushing the glider up past
    ``max_depth``. Returns %/s."""
    u1 = float(np.dot(gains, np.asarray(e_state).reshape(-1)))
    u1 += k_max_depth * (depth - max_depth) * ((depth + 0.001) > max_depth)
    return saturate(u1, -100.0, 100.0)


def mass_spd_control(pitch, theta_d, pitch_vel, gains):
    """Moving-mass speed command from pitch error
    (reference/exploreExpSettings.py:56-66). Returns %/s."""
    pkp, pkd = gains
    u2 = (saturate(pkd * (-pitch_vel), -100.0, 100.0)
          + saturate(pkp * (theta_d - pitch), -100.0, 100.0))
    return saturate(u2, -100.0, 100.0)


def yaw_correction(yaw, yaw_d, wrap_val=math.pi):
    """Wrapped heading error, the control laws' ``ch.yawCorrection(yaw,
    bearing, pi)`` call (reference/controllerHelper.py:190-196; the +/-70
    default clamp never binds in radians)."""
    return _yaw_correction(yaw, yaw_d, wrap_val)


# -- configuration -----------------------------------------------------------
@dataclass
class RuntimeConfig:
    """Loop rates, gains, KF noise and sensor-noise settings. Defaults are
    the reference's physical-experiment values
    (reference/PhysicalExperimentCode/exploreExpSettings.py:83-146,186-211)
    except where noted."""

    dt: float = 0.05  # fixed sim tick (the reference loop is ~1 kHz wall)
    control_rate: float = 10.0  # Hz (:94)
    pitch_control_rate: float = 4.0  # Hz (:95)
    linear_depth_gains: tuple = (100.0, 3000.0, 20.0, 3.0)  # (:84)
    linear_pitch_gains: tuple = (5.0, 0.5)  # (:87)
    k_max_depth: float = 500000.0  # (:85)
    max_bias_rate: float = 100.0  # deg/s (:96)
    k_delta: float = 5.0  # tail first-order input-estimator gain
    at_surface: float = 0.15  # (:186)
    blue_thresh: float = 0.95  # burst-sampling trigger (:74)
    # energy model: weights on (dmass^2, dpump^2, ddelta^2, 1) — the
    # reference ran with (1,1,1,1) (:211) whose actuator terms are tiny
    # next to the planner's per-leg costs. None (default) DERIVES the
    # tail weight from the planner's own SwimEnergy model: w_delta is the
    # closed-form ratio of the planner's swim-energy rate to the
    # first-order input estimator's integrated ddelta^2 on the commanded
    # tail gait (see derived_tail_weight); integrated budget then matches
    # evaluate_trajectory within ~15% on representative paths
    # (tests/test_runtime.py)
    udot_weights: Optional[tuple] = None
    time_energy: Optional[float] = None  # defaults to agent.time_energy
    # sensor noise (1-sigma)
    fix_rate: float = 2.0  # Hz position-fix availability (AprilTag stand-in)
    fix_noise: float = 0.05
    fix_vel_noise: float = 0.05
    depth_noise: float = 0.003
    euler_noise: float = 0.01
    gyro_noise: float = 0.01
    vel_var_mult: float = 3.0  # (:109)
    use_velocity_observer: bool = True
    vb_cap: float = 10.0  # |vb| divergence reset threshold (m/s); the
    # reference guards only NaN (:855-858) because its 31-param
    # hydrodynamic model matches its glider — against a generic plant the
    # observer can diverge finitely, so the same reset fires on blow-up too
    # 6-state position KF (:120-124)
    q_xhat: tuple = (0.001, 0.001, 0.001, 0.01, 0.01, 0.01)
    r_xhat: tuple = (0.1, 0.1, 0.05, 0.25, 0.25, 0.25, 0.35, 0.35, 0.35)
    damping: float = -0.01
    # input-rate KF (:127-131)
    q_inp: tuple = (0.05, 0.05, 0.05, 0.05)
    r_inp: tuple = (0.001, 0.001)
    # depth-error KF (:141-146)
    q_depth_err: tuple = (0.1, 0.1, 0.1, 0.1)
    r_depth_err: float = 0.05


def derived_tail_weight(agent: AgentConfig, dt: float,
                        k_delta: float, wave: str = "square",
                        horizon: float = 40.0) -> float:
    """Tail-flap energy weight DERIVED from the planner's SwimEnergy model.

    The planner charges ``swim_energy(t) * tail_energy_scale`` per swim
    leg (reference/GraceRIGV3.py:61-63,269); the runtime integrates
    ``w_delta * ddelta^2`` where ``ddelta`` is the first-order tail input
    estimator's output (reference/...MFEGP.py:795-806). This computes the
    weight that makes the two IDENTICAL on the commanded tail gait: run
    the exact estimator recurrence on ``tail_wave`` (the gait the Swim law
    commands) over a long horizon and take the ratio of the planner's
    energy to the integrated ddelta^2. Deterministic and closed-form given
    (tail_amp, tail_freq, tail_energy_scale, k_delta, dt) — no
    calibration against the closed loop. Continuous-time sanity check
    (sin gait): w = tail_energy_scale * (k^2 + omega^2) / k^2; the square
    default additionally folds in the estimator's pulse response and the
    dt discretization.
    """
    from mfgp_tpu_torch.hw.controllers import tail_wave
    from mfgp_tpu_torch.planning.primitives import swim_energy

    T = max(horizon / max(agent.tail_freq, 1e-3), horizon)
    ts = np.arange(0.0, T, dt)
    amp_deg = math.degrees(agent.tail_amp)
    delta = np.radians(tail_wave(ts, 0.0, amp_deg, agent.tail_freq, wave))
    dh, acc = 0.0, 0.0
    for u in delta:
        dd = k_delta * saturate(u - dh, -math.pi, math.pi)
        dh = saturate(dh + dd * dt - 0.5 * k_delta * dd * dt**2,
                      -math.radians(110), math.radians(110))
        acc += dd * dd * dt
    return float(swim_energy(T, agent) * agent.tail_energy_scale / acc)


ESTIMATES_HEADER = ("t,p_cnt,Phat_x,Phat_y,Phat_z,xh,yh,zh,vxh,vyh,vzh,"
                    "Pxx,Pyy,Pzz,Pvx,Pvy,Pvz,vb1,vb2,vb3,budgetUsed")
CONTROL_HEADER = "t,u2,u1,tailBias,tailAmp,tailFreq,dmass,dpump,deltaHat,ddelta"
TRAJINFO_HEADER = "t,x_tar,y_tar,z_tar,wx,wy,wz,theta_d,prim"
MEASUREMENTS_HEADER = ("t,mass,pump,tail,depth,roll,pitch,yaw,gx,gy,gz,blue")


@dataclass
class FlightLog:
    """Telemetry of one flown plan, in the reference's artifact schemas
    (reference/exploreExpSettings.py:265-292)."""

    estimates: np.ndarray
    control: np.ndarray
    traj_info: np.ndarray
    measurements: np.ndarray
    samples: np.ndarray  # (S, 9) GPData rows: t,x,y,z,xh,yh,zh,field,fidLev
    truth: np.ndarray  # (T, 7) t,x,y,depth,vx,vy,vz
    budget_used: float  # cumulative across the runtime's lifetime
    plan_budget: float  # energy spent flying THIS plan
    tracking_rmse: float  # 3D RMS distance to the commanded trajectory

    def save(self, out_dir: str, suffix: str = "") -> None:
        import os
        os.makedirs(out_dir, exist_ok=True)
        for name, header, arr in (
                ("estimates", ESTIMATES_HEADER, self.estimates),
                ("control", CONTROL_HEADER, self.control),
                ("trajInfo", TRAJINFO_HEADER, self.traj_info),
                ("measurements", MEASUREMENTS_HEADER, self.measurements)):
            np.savetxt(os.path.join(out_dir, f"{name}{suffix}.csv"), arr,
                       delimiter=",", header=header, comments="")


def chain_to_flight_plan(edge_triples, cfg):
    """Assemble (waypoints, legs) from an edge chain of
    ``(prims, src_xy, dst_xy)`` triples — the single implementation of the
    reference's pathPoints/edgeChain construction
    (reference/...MFEGP.py:449-461), shared by the host and device
    planners. ``legs[i]`` spans ``waypoints[i] -> waypoints[i+1]``.
    """
    from mfgp_tpu_torch.planning import primitives as prim

    rows = [None]
    legs = []
    t_off = 0.0
    for prims, src_xy, dst_xy in edge_triples:
        _, _, _, wpnts, _ = prim.evaluate_trajectory(prims, cfg)
        src_xy = np.asarray(src_xy, float).reshape(-1)
        dst_xy = np.asarray(dst_xy, float).reshape(-1)
        if rows[0] is None:
            rows[0] = np.array([[src_xy[0], src_xy[1], 0.0, 0.0]])
        b = math.atan2(dst_xy[1] - src_xy[1], dst_xy[0] - src_xy[0])
        d = wpnts[1:, 0]
        rows.append(np.column_stack([
            src_xy[0] + d * np.cos(b), src_xy[1] + d * np.sin(b),
            wpnts[1:, 1], wpnts[1:, 2] + t_off]))
        legs.extend(prims)
        t_off += wpnts[-1, 2]
    if rows[0] is None:
        return None, None
    return np.concatenate(rows, axis=0), legs


def flight_plan(planner):
    """(waypoints, legs) of a planner's best path (see
    chain_to_flight_plan). Planners that carry their own flight-plan
    builder (DeviceRIGAdapter) are delegated to."""
    if hasattr(planner, "flight_plan"):
        return planner.flight_plan()
    if planner.best_path.segments is None:
        return None, None
    triples = [
        (planner.E[(s.sn, s.en)][s.edge_idx].prims,
         np.asarray(planner.V[s.sn].state).reshape(-1)[:2],
         np.asarray(planner.V[s.en].state).reshape(-1)[:2])
        for s in planner.best_path.segments
    ]
    return chain_to_flight_plan(triples, planner.cfg)


def traj_point(t, waypoints):
    """Linear interpolation of the target point at time ``t``
    (reference/exploreExpSettings.py trajPnt :149)."""
    tv = waypoints[:, 3]
    return np.array([np.interp(t, tv, waypoints[:, 0]),
                     np.interp(t, tv, waypoints[:, 1]),
                     np.interp(t, tv, waypoints[:, 2])])


class ObserverStep:
    """The runtime's per-tick observer call: ``euler_to_rotm`` and
    ``body_velocity_observer`` on ``device`` in float64, from host numbers
    (roll, pitch, yaw, omega (3), vb (3), depth, estimated depth, pump,
    tail) to host numpy (dP (3,), dvb (3,), R (3, 3)).

    On the card with ``graph`` (the default there) the step is captured
    once as a CUDA graph on fixed input and output buffers and replayed
    every tick: one copy in, one replay, one copy out and a
    synchronisation, the counterpart of the JAX package's one jitted call
    per tick. Without it the step runs eagerly (on the card: some 60 small
    launches per tick)."""

    def __init__(self, params, device=CUDA, graph: bool | None = None):
        from mfgp_tpu_torch.estimation.observers import (
            body_velocity_observer, euler_to_rotm)

        self.params = params
        self.device = resolve(device)
        on_card = self.device.type == "cuda"
        self.graph = on_card if graph is None else bool(graph)
        if self.graph and not on_card:
            raise ValueError("a CUDA graph needs a CUDA device")
        self._rotm, self._observer = euler_to_rotm, body_velocity_observer
        z = dict(dtype=torch.float64)
        self._in = torch.zeros(13, device=self.device, **z)
        if on_card:  # pinned host buffers: asynchronous copies both ways
            self._host_in = torch.zeros(13, **z).pin_memory()
            self._host_out = torch.zeros(15, **z).pin_memory()
        self._cuda_graph = self._out = None

    def _compute(self, v: torch.Tensor) -> torch.Tensor:
        R = self._rotm(v[0], v[1], v[2])
        dP, dvb = self._observer(R, v[3:6], v[6:9], v[9], v[10], v[11],
                                 v[12], self.params)
        return torch.cat([dP, dvb, R.reshape(-1)])

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # warm-up outside the capture
            self._compute(self._in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        profiling.count("graph.captures")
        with torch.cuda.graph(graph):
            self._out = self._compute(self._in)
        self._cuda_graph = graph

    def __call__(self, roll, pitch, yaw, omega, vb, z, zhat, ppx, delta):
        vals = [roll, pitch, yaw, *omega, *vb, z, zhat, ppx, delta]
        if self.device.type != "cuda":
            out = self._compute(torch.tensor(vals, dtype=torch.float64,
                                             device=self.device)).numpy()
        else:
            self._host_in.numpy()[:] = vals
            self._in.copy_(self._host_in, non_blocking=True)
            if self.graph:
                if self._cuda_graph is None:
                    self._capture()
                self._cuda_graph.replay()
                res = self._out
            else:
                res = self._compute(self._in)
            self._host_out.copy_(res, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = self._host_out.numpy().copy()
        return out[0:3], out[3:6], out[6:15].reshape(3, 3)


class RobotRuntime:
    """Flies primitive plans through the full control stack against a
    :class:`~mfgp_tpu.hw.plant.GliderPlant` (or real hardware exposing the
    same surface). State (KFs, observer, budget) persists across plans like
    the reference's single long-running process."""

    def __init__(self, agent_cfg: AgentConfig, cfg: RuntimeConfig = None,
                 plant: GliderPlant = None, seed: int = 0,
                 field_fn: Callable = None, max_depth: float = None,
                 device=CUDA):
        """``device``: where the observer runs (the card unless asked
        otherwise; there its step is a CUDA graph)."""
        from mfgp_tpu_torch.estimation.observers import GliderParams

        self.cfg = cfg or RuntimeConfig()
        self.agent = agent_cfg
        self.rng = np.random.default_rng(seed)
        self.plant = plant or GliderPlant(PlantParams.from_agent(agent_cfg))
        if field_fn is not None:
            self.plant.attach_field(field_fn)
        self.max_depth = (max_depth if max_depth is not None
                          else agent_cfg.max_depth)
        c = self.cfg
        # ballast scale chosen so the observer's terminal vertical speed at
        # full pump offset matches the plant's (see hw/plant.py); the
        # reference's 31-parameter vector plays this calibration role
        # (reference/backsteppingConfig.py)
        p = GliderParams()
        v_term = self.plant.params.buoy_per_pct * 55.0
        lp = (0.5 * p.rho * p.S * p.CD0 * v_term**2) / (0.45 * p.g)
        self.glider_params = p._replace(lp=max(lp, 1e-6), bc=0.55)
        self._obs_fn = ObserverStep(self.glider_params, device)
        # persistent estimator state
        self.t = 0.0
        self.budget_used = 0.0
        self._w_udot_derived = None  # derived-weight cache (per dt/gait)
        self.delta_hat = 0.0
        self.inp_x = np.zeros((4, 1))  # mass, pump (normalized), rates
        self.inp_P = 0.1 * np.eye(4)
        self.pitch_x = np.zeros((2, 1))
        self.pitch_P = 0.1 * np.eye(2)
        self.xhat = np.zeros((6, 1))
        self.xhat_P = 1.0 * np.eye(6)
        self.zerr_x = np.zeros((4, 1))
        self.zerr_P = 0.1 * np.eye(4)
        self.vb_est = np.array([[1e-4], [0.0], [1e-4]])
        self.Phat = np.zeros(3)  # observer-integrated position
        self._last_fix = np.zeros(3)
        self._last_fix_vel = np.zeros(3)
        self._last_fix_t = -1e9
        self._last_sample_t = -1e9
        self._max_blue = 1e-12
        self._tlast_ctrl = -1e9
        self._tlast_p_ctrl = -1e9
        self.xhat[0, 0], self.xhat[1, 0] = self.plant.x, self.plant.y
        self.Phat[:] = (self.plant.x, self.plant.y, self.plant.depth)

    # -- pure-ish sub-steps --------------------------------------------------
    def _kf(self, x, P, A, Q, z, H, R):
        x = A @ x
        P = A @ P @ A.T + Q
        PHT = P @ H.T
        S = H @ PHT + R
        K = np.linalg.solve(S.T, PHT.T).T
        x = x + K @ (z - H @ x)
        P = (np.eye(P.shape[0]) - K @ H) @ P
        return x, P

    def _observer_step(self, roll, pitch, yaw, omega, depth, u, dt):
        dP, dvb, R = self._obs_fn(roll, pitch, yaw, omega,
                                  self.vb_est[:, 0], depth, self.Phat[2],
                                  u[1], u[2])
        self.Phat = self.Phat + dP * dt
        vb = self.vb_est[:, 0] + dvb * dt * (dt < 0.5)
        # singularity/divergence reset (reference :855-858 + vb_cap note)
        if np.isnan(vb).any() or np.linalg.norm(vb) > self.cfg.vb_cap:
            self.Phat = np.array([self._last_fix[0], self._last_fix[1],
                                  depth])
            vb = np.array([1e-4, 0.0, 1e-4])
        self.vb_est = vb[:, None]
        return R @ self.vb_est  # world-frame velocity estimate (3, 1)

    # -- the loop -------------------------------------------------------------
    def fly(self, waypoints: np.ndarray, legs: list) -> FlightLog:
        """Fly one plan. ``waypoints``: (L+1, 4) rows (x, y, z, t) in plan
        time; ``legs[i]`` is the primitive between rows i and i+1."""
        c, a = self.cfg, self.agent
        dt = c.dt
        time_energy = (c.time_energy if c.time_energy is not None
                       else a.time_energy)
        if c.udot_weights is None:
            if self._w_udot_derived is None:
                self._w_udot_derived = (
                    1.0, 1.0, derived_tail_weight(a, dt, c.k_delta), 1.0)
            w_udot = np.asarray(self._w_udot_derived, float)
        else:
            w_udot = np.asarray(c.udot_weights, float)
        waypoints = np.asarray(waypoints, float)
        t_end = waypoints[-1, 3]
        n_ticks = int(math.ceil(t_end / dt)) + 1
        A_inp = lambda d: np.eye(4) + np.diag([d, d], k=2)  # noqa: E731
        H_inp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
        Q_inp = np.diag(c.q_inp)
        R_inp = np.diag(c.r_inp)
        A_pitch = lambda d: np.array([[1.0, d], [0.0, 1.0]])  # noqa: E731
        H_pitch = np.diag([1.0, 0.0])
        R_pitch = 0.0175 * np.diag([1.0, 10.0])
        A_z = lambda d: (np.eye(4) + np.eye(4, k=1) * d  # noqa: E731
                         + np.eye(4, k=2) / 2 * d**2
                         + np.eye(4, k=3) / 6 * d**3)
        H_z = np.array([[1.0, 0, 0, 0]])
        R_z = np.array([[c.r_depth_err]])
        dmp = c.damping
        A_x = lambda d: (np.eye(6)  # noqa: E731
                         + np.diag([d, d, d], k=3)
                         + np.diag([0, 0, 0, dmp * d, dmp * d, dmp * d]))
        Q_x = np.diag(c.q_xhat)
        R_x = np.diag(c.r_xhat)

        est_rows, ctl_rows, trj_rows, mea_rows, smp_rows, tru_rows = (
            [], [], [], [], [], [])
        track_err2 = []
        t0 = self.t
        budget0 = self.budget_used
        theta_d = 0.0
        theta_gd = 0.0
        u1 = u2 = 0.0
        for _ in range(n_ticks):
            self.plant.step(dt)
            self.t += dt
            t = self.t - t0  # plan-relative time
            # primitive lookup (reference :763-774)
            if t > t_end or not legs:
                prim = None
                wypnt = waypoints[-1, :3]
            else:
                p_cnt = min(len(legs) - 1,
                            max(0, int(np.sum(t > waypoints[:, 3])) - 1))
                prim = legs[p_cnt]
                wypnt = waypoints[min(p_cnt + 1, waypoints.shape[0] - 1), :3]
            x_tar, y_tar, z_tar = traj_point(t, waypoints)

            # sensors (reference :780-792)
            roll, pitch, yaw_m = self.plant.read_euler()
            e_n = c.euler_noise * self.rng.standard_normal(3)
            roll, pitch, yaw_m = roll + e_n[0], pitch + e_n[1], yaw_m + e_n[2]
            gx, gy, gz = (np.asarray(self.plant.read_gyro())
                          + c.gyro_noise * self.rng.standard_normal(3))
            depth = (self.plant.read_depth()
                     + c.depth_noise * self.rng.standard_normal())
            mass_pct, pump_pct, tail_deg = self.plant.read_inputs()
            u = (mass_pct / 100.0, pump_pct / 100.0, math.radians(tail_deg))
            blue = self.plant.read_rgb()[2]

            # tail input estimator + input-rate KF + budget (:795-806)
            ddelta = c.k_delta * saturate(u[2] - self.delta_hat,
                                          -math.pi, math.pi)
            self.delta_hat = saturate(
                self.delta_hat + (ddelta * dt
                                  - 0.5 * c.k_delta * ddelta * dt**2),
                -math.radians(110), math.radians(110))
            self.inp_x, self.inp_P = self._kf(
                self.inp_x, self.inp_P, A_inp(dt), Q_inp * dt,
                np.array([[u[0]], [u[1]]]), H_inp, R_inp)
            dmass, dpump = self.inp_x[2, 0], self.inp_x[3, 0]
            udot = np.array([dmass**2, dpump**2, ddelta**2, time_energy])
            self.budget_used += float(np.sum(udot * w_udot)) * dt
            self.pitch_x, self.pitch_P = self._kf(
                self.pitch_x, self.pitch_P, A_pitch(dt),
                0.0175 * np.diag([2.0, 3.0]) * dt,
                np.array([[pitch], [gy]]), H_pitch, R_pitch)

            # fidelity-binned field sampling (:809-819)
            burst = (blue > c.blue_thresh * self._max_blue
                     and self.t - self._last_sample_t > 0.25 / a.meas_rate)
            if self.t - self._last_sample_t > 1.0 / a.meas_rate or burst:
                self._max_blue = max(self._max_blue, blue)
                self._last_sample_t = self.t
                cov_comp = float(np.trace(self.xhat_P[0:2, 0:2]))
                levs = list(a.fid_levels) or [0.25, 2.25, 6.25]
                fid = (1 if cov_comp < levs[0]
                       else 2 if cov_comp < levs[1] else 3)
                smp_rows.append([self.t, self.plant.x, self.plant.y,
                                 self.plant.depth, self.xhat[0, 0],
                                 self.xhat[1, 0], self.xhat[2, 0],
                                 blue, float(fid)])

            # position fix (AprilTag/GPS stand-in, :821-842)
            if self.t - self._last_fix_t >= 1.0 / c.fix_rate:
                self._last_fix = (self.plant.position
                                  + c.fix_noise * self.rng.standard_normal(3))
                self._last_fix_vel = (
                    self.plant.velocity
                    + c.fix_vel_noise * self.rng.standard_normal(3))
                self._last_fix_t = self.t
            tuav = (self.t - self._last_fix_t) < 1.0
            use_gps = depth < c.at_surface

            # body-velocity observer (:845-861)
            if c.use_velocity_observer:
                vel_obs = self._observer_step(roll, pitch, yaw_m,
                                              np.array([gx, gy, gz]),
                                              depth, u, dt)
                # Divergence note: the reference's gate
                # ``(prim[0]!='Swim' or prim[0]!=None)`` (:860) is always
                # true (should be ``and``) and its ``ddelta<np.rad2deg(10)``
                # compares radians to 573; here the gate does what was
                # intended — exclude swim legs and large tail transients.
                use_vel = (not np.isnan(self.vb_est).any()
                           and abs(ddelta) < math.radians(45)
                           and (prim is None or prim[0] != Leg.SWIM))
            else:
                vel_obs = np.zeros((3, 1))
                use_vel = False

            # 6-state position KF with gated H (:862-872)
            g = float(use_gps and tuav)
            tv = float(tuav)
            vo = float(use_vel)
            H = np.vstack([np.diag([g, g, 1.0, tv, tv, tv]),
                           np.hstack([np.zeros((3, 3)), vo * np.eye(3)])])
            z = np.concatenate([
                [self._last_fix[0], self._last_fix[1], depth],
                self._last_fix_vel, vel_obs[:, 0]])[:, None]
            self.xhat, self.xhat_P = self._kf(
                self.xhat, self.xhat_P, A_x(dt), Q_x * dt, z, H, R_x)

            # depth-error KF (:874-875)
            self.zerr_x, self.zerr_P = self._kf(
                self.zerr_x, self.zerr_P, A_z(dt),
                np.diag(c.q_depth_err) * dt,
                np.array([[depth - z_tar]]), H_z, R_z)

            # per-primitive control (:884-988)
            tail = self.plant.tail
            leg_type = None if prim is None else prim[0]
            if leg_type == Leg.FLATDIVE:
                _, dz, zdot_d = prim
                theta_d = 0.0
                theta_gd = math.pi / 2 * math.copysign(1.0, dz)
                if self.t - self._tlast_p_ctrl > 1.0 / c.pitch_control_rate:
                    u2 = mass_spd_control(pitch, theta_d, self.pitch_x[1, 0],
                                          c.linear_pitch_gains)
                    self.plant.set_mass_pos(saturate(
                        100 * u[0] + u2 / c.pitch_control_rate, 0, 100))
                    self._tlast_p_ctrl = self.t
                if self.t - self._tlast_ctrl > 1.0 / c.control_rate:
                    u1 = pump_spd_control2(
                        depth, self.zerr_x,
                        np.asarray(c.linear_depth_gains),
                        c.k_max_depth, self.max_depth)
                    self.plant.set_pump_pos(saturate(
                        100 * u[1] + u1 / c.control_rate, 0, 75))
                    self._tlast_ctrl = self.t
            if leg_type == Leg.SWIM:
                if self.t - self._tlast_p_ctrl > 1.0 / c.pitch_control_rate:
                    theta_d = 0.1
                    u2 = mass_spd_control(pitch, theta_d, self.pitch_x[1, 0],
                                          c.linear_pitch_gains)
                    self.plant.set_mass_pos(saturate(
                        100 * u[0] + u2 / c.pitch_control_rate, 0, 100))
                    self._tlast_p_ctrl = self.t
                if self.t - self._tlast_ctrl > 1.0 / c.control_rate:
                    rho2 = float(np.hypot(wypnt[1] - self._last_fix[1],
                                          wypnt[0] - self._last_fix[0]))
                    bearing = math.atan2(wypnt[1] - self._last_fix[1],
                                         wypnt[0] - self._last_fix[0])
                    heading_err = yaw_correction(yaw_m, bearing)
                    bias = saturate(3 * math.degrees(heading_err), -90, 90)
                    amp = (math.degrees(a.tail_amp) if rho2 > 0.5 else
                           100 * rho2 * a.tail_amp / 50
                           * (math.cos(heading_err) > 0))
                    tail.bias = bias
                    tail.amp = saturate(amp, 0, 50)
                    tail.freq = a.tail_freq
                    u1 = pump_spd_control2(
                        depth, self.zerr_x,
                        np.asarray(c.linear_depth_gains),
                        c.k_max_depth, self.max_depth)
                    self.plant.set_pump_pos(saturate(
                        100 * u[1] + u1 / c.control_rate, 0, 75))
                    self._tlast_ctrl = self.t
            else:
                tail.amp = 0.0  # the reference zeroes amp for non-swim legs
            if leg_type == Leg.SPIRAL:
                _, dz, delta_d, zdot_d = prim
                if self.t - self._tlast_ctrl > 1.0 / c.control_rate:
                    theta_d = pitch
                    u1 = pump_spd_control2(
                        depth, self.zerr_x,
                        np.asarray(c.linear_depth_gains),
                        c.k_max_depth, self.max_depth)
                    self.plant.set_pump_pos(saturate(
                        100 * u[1] + u1 / c.control_rate, 0, 75))
                    if use_gps and dz < 0:
                        self.plant.set_mass_pos(46.0)
                    elif dz > 0.1 or dz < 0:
                        self.plant.set_mass_pos(35.0 if dz > 0 else 60.0)
                    tail.bias = math.degrees(delta_d)
                    self._tlast_ctrl = self.t
            if leg_type == Leg.GLIDE:
                _, theta_gd, dz, zdot_d = prim
                if self.t - self._tlast_p_ctrl > 1.0 / c.pitch_control_rate:
                    if abs(theta_gd) < math.radians(45):
                        theta_d = -theta_gd
                    else:
                        theta_d = (-math.pi / 2 * math.copysign(1.0, theta_gd)
                                   + theta_gd)
                    if use_gps and dz < 0:
                        theta_d = 0.0
                    u2 = mass_spd_control(pitch, theta_d, self.pitch_x[1, 0],
                                          c.linear_pitch_gains)
                    self.plant.set_mass_pos(saturate(
                        100 * u[0] + u2 / c.pitch_control_rate, 0, 100))
                    self._tlast_p_ctrl = self.t
                if self.t - self._tlast_ctrl > 1.0 / c.control_rate:
                    bearing = math.atan2(wypnt[1] - self._last_fix[1],
                                         wypnt[0] - self._last_fix[0])
                    u1 = pump_spd_control2(
                        depth, self.zerr_x,
                        np.asarray(c.linear_depth_gains),
                        c.k_max_depth, self.max_depth)
                    self.plant.set_pump_pos(saturate(
                        100 * u[1] + u1 / c.control_rate, 0, 75))
                    tail.bias = saturate(
                        math.degrees(yaw_correction(yaw_m, bearing)),
                        tail.bias - c.max_bias_rate * dt,
                        tail.bias + c.max_bias_rate * dt)
                    self._tlast_ctrl = self.t
            if leg_type is None:
                # end-of-path surfacing trim (:983-988)
                if (depth > c.at_surface * 0.5
                        and self.t - self._tlast_ctrl
                        > 10.0 / c.control_rate):
                    self._tlast_ctrl = self.t
                    self.plant.set_pump_pos(saturate(100 * u[1] + 3, 0, 75))
                    self.plant.set_mass_pos(46.0)

            # telemetry (:990-998)
            leg_code = -1.0 if leg_type is None else float(leg_type)
            est_rows.append([self.t, leg_code,
                             *self.Phat, *self.xhat[:, 0],
                             *np.diagonal(self.xhat_P),
                             *self.vb_est[:, 0], self.budget_used])
            ctl_rows.append([self.t, u2, u1, tail.bias, tail.amp, tail.freq,
                             dmass, dpump, self.delta_hat, ddelta])
            trj_rows.append([self.t, x_tar, y_tar, z_tar, *wypnt, theta_d,
                             float(leg_type if leg_type is not None else -1)])
            mea_rows.append([self.t, u[0], u[1], u[2], depth, roll, pitch,
                             yaw_m, gx, gy, gz, blue])
            tru_rows.append([self.t, *self.plant.position,
                             *self.plant.velocity])
            track_err2.append((self.plant.x - x_tar)**2
                              + (self.plant.y - y_tar)**2
                              + (self.plant.depth - z_tar)**2)

        return FlightLog(
            estimates=np.asarray(est_rows), control=np.asarray(ctl_rows),
            traj_info=np.asarray(trj_rows),
            measurements=np.asarray(mea_rows),
            samples=(np.asarray(smp_rows) if smp_rows
                     else np.zeros((0, 9))),
            truth=np.asarray(tru_rows), budget_used=self.budget_used,
            plan_budget=self.budget_used - budget0,
            tracking_rmse=float(np.sqrt(np.mean(track_err2))))
