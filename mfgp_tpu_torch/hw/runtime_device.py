"""The robot runtime's sense->estimate->control loop as a device program
(counterpart of ``mfgp_tpu/hw/runtime_device.py``).

``hw.runtime.RobotRuntime`` flies a plan tick by tick in numpy on the
host. Here the same loop runs on tensors with a leading lane axis L on the
carry, the plan and the noise, so a solo flight is one lane and a flight
ensemble (or the flights of a mission ensemble, ``sim.mission_device``)
is L lanes of the same code:

* the :class:`~mfgp_tpu_torch.hw.plant.GliderPlant` dynamics (actuator
  slew, first-order pitch, buoyancy vertical speed, tail-wave propulsion +
  glide polar) branch-free;
* sensing with per-tick noise read from a tensor argument (L, t_cap, 13);
* the tail first-order input estimator, input-rate KF and energy-budget
  integration (reference :795-806), pitch KF, fidelity-binned field
  sampling by ``tr(Pxhat[0:2,0:2])`` (:809-819), the gated position fix,
  the body-velocity observer with its divergence reset (:845-861), the
  surface-gated 6-state position KF (:862-872) and depth-error KF (:874);
* the four per-primitive control laws (FlatDive, Swim, Spiral, Glide) and
  the end-of-path surfacing trim, selected by masks over the leg code.

Ticks past a lane's ``ceil(t_end/dt)+1`` (the host loop's length) freeze
its carry, so results do not depend on the padding to ``t_cap``. The carry
lives in one flat (L, 127) tensor between ticks and a tick's log row in
one (L, 35) row, so a tick ends with one select and two writes.

The tick reads no value back to the host (its small solves are
``kalman._solve``, which never checks its status), so on the card a chunk
of ticks is captured once as a CUDA graph on fixed buffers and replayed:
the capture serves every plan of the same lane count and capacity. With
``early_stop`` the flight reads the lanes' tick counts once and replays
only the chunks that hold a live tick; without it all ``t_cap`` ticks run.

``glide_stride > 1`` (multi-rate): a window of ``stride`` fine ticks
wholly inside one GLIDE leg advances with one coarse tick of
``stride * dt``; every other window takes the fine ticks. Logs keep one
row per fine tick (a coarse window: one live row and ``stride - 1`` dead
ones). Whether a window is coarse depends only on the plan and the tick
clock, not on the dynamics, so the flight computes every lane's schedule
on the host from the plan (one read per flight) and replays per run of
windows the coarse graph, the fine graph, or, where lanes disagree, a
graph that computes both and selects per lane. Deciding on the device in
every window instead, which must compute both sides every time (what the
JAX package's vmapped flight does), took 1.86-2.3x as long on the H100
(PERF.md §5), and was dropped.

The observer and the rotation are the port's
(``estimation.observers``) mapped over lanes with ``torch.func.vmap``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mfgp_tpu_torch.estimation.kalman import _solve
from mfgp_tpu_torch.estimation.observers import (GliderParams,
                                                 body_velocity_observer,
                                                 euler_to_rotm)
from mfgp_tpu_torch.hw.plant import PlantParams
from mfgp_tpu_torch.hw.runtime import RuntimeConfig, derived_tail_weight
from mfgp_tpu_torch.planning.primitives import AgentConfig, Leg
from mfgp_tpu_torch.planning.rig_device import _interp
from mfgp_tpu_torch.utils import profiling
from mfgp_tpu_torch.utils.device import CUDA, resolve


def _sat(x, lo, hi):
    return torch.clamp(x, lo, hi)


def _mod(a, b):
    """``jnp.remainder``: the exact ``fmod`` moved to the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _angle_wrap(a, wrap_val):
    return _mod(a + wrap_val, 2.0 * wrap_val) - wrap_val


def _yaw_correction(yaw, yaw_d, wrap_val=math.pi):
    """hw.controllers.yaw_correction at the runtime's radian call site
    (the +/-70 clamp never binds in radians)."""
    return _sat(_angle_wrap(yaw - yaw_d, wrap_val), -70.0, 70.0)


def _pump_spd_control2(depth, e_state, gains, k_max_depth, max_depth):
    u1 = torch.sum(e_state * gains, -1)
    u1 = u1 + k_max_depth * (depth - max_depth) * ((depth + 0.001)
                                                   > max_depth)
    return _sat(u1, -100.0, 100.0)


def _mass_spd_control(pitch, theta_d, pitch_vel, gains):
    pkp, pkd = gains
    return _sat(_sat(pkd * (-pitch_vel), -100.0, 100.0)
                + _sat(pkp * (theta_d - pitch), -100.0, 100.0),
                -100.0, 100.0)


def _tail_angle(t, bias, amp, freq):
    """hw.plant.TailWave.angle (square gait) branch-free; amp == 0
    degenerates to the bias exactly like the host early-return."""
    phase = _mod(torch.floor(2.0 * torch.clamp_min(freq, 0.05) * t),
                 torch.full_like(t, 2.0))
    return bias + torch.where(phase < 1, amp, -amp)


def _kf(x, P, A, Q, z, H, R):
    """One predict+update of each lane, hw.runtime.RobotRuntime._kf. The
    constant matrices are expanded to the lanes, so every product is a
    batched product of the same shapes whatever the lane count (a lane's
    result is then the same bits in a solo flight as in an ensemble)."""
    L = x.shape[0]
    A, H, R = (m.expand((L,) + m.shape[-2:]) for m in (A, H, R))
    x = A @ x
    P = A @ P @ A.mT + Q
    PHT = P @ H.mT
    S = H @ PHT + R
    K = _solve(S.mT, PHT.mT).mT
    x = x + K @ (z - H @ x)
    P = (torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
         - K @ H) @ P
    return x, P


class DevicePlan(NamedTuple):
    """Padded flight plans, one per lane: ``wp`` (L, Wcap, 4) rows
    (x, y, z, t), valid rows first, padding repeating the last valid row
    at strictly increasing times so interpolation clamps; ``legs``
    (L, Lcap, 4) rows (code, a, b, c) in the host runtime's unpacking
    order; ``n_wp``, ``n_legs`` (L,) long; ``t_end`` (L,)."""

    wp: torch.Tensor
    n_wp: torch.Tensor
    legs: torch.Tensor
    n_legs: torch.Tensor
    t_end: torch.Tensor


# the carry, flat: (name, shape) in the JAX package's init_carry order
_CARRY = (
    ("px", ()), ("py", ()), ("pz", ()), ("pitch", ()), ("yaw", ()),
    ("roll", ()), ("mass_pos", ()), ("pump_pos", ()), ("mass_cmd", ()),
    ("pump_cmd", ()), ("tail_bias", ()), ("tail_amp", ()),
    ("tail_freq", ()), ("pitch_rate", ()), ("yaw_rate", ()), ("vx", ()),
    ("vy", ()), ("vz", ()), ("delta_hat", ()), ("u2_prev", ()),
    ("inp_x", (4,)), ("inp_P", (4, 4)), ("pitch_x", (2,)),
    ("pitch_P", (2, 2)), ("xhat", (6,)), ("xhat_P", (6, 6)),
    ("zerr_x", (4,)), ("zerr_P", (4, 4)), ("vb", (3,)), ("Phat", (3,)),
    ("last_fix", (3,)), ("last_fix_vel", (3,)), ("last_fix_t", ()),
    ("last_sample_t", ()), ("max_blue", ()), ("tlast_ctrl", ()),
    ("tlast_p_ctrl", ()), ("t", ()), ("budget", ()))
# a tick's log row
_LOG = (("t", ()), ("truth", (3,)), ("vel", (3,)), ("xhat", (6,)),
        ("sample_xh", (3,)), ("Pdiag", (6,)), ("blue", ()), ("sample", ()),
        ("fid", ()), ("budget", ()), ("err2", ()), ("code", ()),
        ("Phat", (3,)), ("vb", (3,)), ("alive", ()))


def _slots(layout):
    out, o = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape)) if shape else 1
        out[name] = (o, n, shape)
        o += n
    return out, o


_CARRY_SLOTS, CARRY_WIDTH = _slots(_CARRY)
_LOG_SLOTS, LOG_WIDTH = _slots(_LOG)


def _unpack(flat, slots) -> dict:
    """Views of a flat (L, W) tensor by name: (L,), (L, n), (L, n, n)."""
    L = flat.shape[0]
    return {k: (flat[:, o] if not shape else
                flat[:, o:o + n].reshape((L,) + shape))
            for k, (o, n, shape) in slots.items()}


def _pack(d: dict, layout) -> torch.Tensor:
    L = d[layout[0][0]].shape[0]
    return torch.cat([d[k].reshape(L, -1).to(d[layout[0][0]].dtype)
                      for k, _ in layout], dim=1)


class DeviceRuntime:
    """The RobotRuntime loop on tensors with a lane axis. One instance per
    (agent, runtime config, capacities); ``fly`` flies L plans at once, on
    ``device`` (the card unless asked otherwise) in ``dtype`` (float64
    unless given). ``graph`` (card only): replay captured chunks of
    ``chunk`` windows (a window is one tick, or ``glide_stride`` ticks:
    128 windows at stride 1, 32 otherwise)."""

    def __init__(self, agent_cfg: AgentConfig,
                 cfg: RuntimeConfig | None = None,
                 plant_params: PlantParams | None = None,
                 field=None, max_depth: Optional[float] = None,
                 dtype=torch.float64, w_cap: int = 64, l_cap: int = 48,
                 glide_stride: int = 1, device=CUDA, graph: bool = True,
                 early_stop: bool = True):
        self.agent = agent_cfg
        self.cfg = cfg or RuntimeConfig()
        self.plant = plant_params or PlantParams.from_agent(agent_cfg)
        self.field = field  # fn (L, 3) points -> (L,) values, on device
        self.max_depth = (max_depth if max_depth is not None
                          else agent_cfg.max_depth)
        self.dtype = dtype
        self.device = resolve(device)
        self.w_cap, self.l_cap = int(w_cap), int(l_cap)
        self.glide_stride = int(glide_stride)
        if self.glide_stride < 1:
            raise ValueError("glide_stride must be >= 1")
        self.graph = bool(graph) and self.device.type == "cuda"
        self.chunk = 128 if self.glide_stride == 1 else 32
        self.early_stop = bool(early_stop)
        c = self.cfg
        if c.udot_weights is None:
            w_udot = [1.0, 1.0,
                      derived_tail_weight(agent_cfg, c.dt, c.k_delta), 1.0]
        else:
            w_udot = list(c.udot_weights)
        self.time_energy = (c.time_energy if c.time_energy is not None
                            else agent_cfg.time_energy)
        # observer constants: the same ballast calibration as
        # RobotRuntime.__init__ (terminal-sink match to the plant)
        p = GliderParams()
        v_term = self.plant.buoy_per_pct * 55.0
        lp = (0.5 * p.rho * p.S * p.CD0 * v_term**2) / (0.45 * p.g)
        self.glider_params = p._replace(lp=max(lp, 1e-6), bc=0.55)
        gp = self.glider_params
        self._rotm = torch.func.vmap(euler_to_rotm)
        self._observer = torch.func.vmap(
            lambda R, om, vb, z, zh, ppx, d: body_velocity_observer(
                R, om, vb, z, zh, ppx, d, gp))
        f = dict(dtype=dtype, device=self.device)
        self._f = f
        self.w_udot = torch.tensor(w_udot, **f)
        self._gains_d = torch.tensor(c.linear_depth_gains, **f)
        self._levs = torch.tensor(list(agent_cfg.fid_levels)
                                  or [0.25, 2.25, 6.25], **f)
        self._tail_amp_deg = torch.tensor(math.degrees(agent_cfg.tail_amp),
                                          **f)
        self._tail_freq = torch.tensor(agent_cfg.tail_freq, **f)
        self._vb0 = torch.tensor([1e-4, 0.0, 1e-4], **f)
        self._consts = {}
        for n_sub in {1, self.glide_stride}:  # built before any capture
            self._const(n_sub)
        self._engines = {}  # (lanes, t_cap) -> fixed buffers + graphs
        self.last_fly: dict = {}  # windows, replays, kinds of the last fly

    # -- constants of a tick of n_sub fine steps -----------------------------
    def _const(self, n_sub: int) -> dict:
        if n_sub in self._consts:
            return self._consts[n_sub]
        c, f = self.cfg, self._f
        dt_f = c.dt * n_sub
        dt = torch.tensor(dt_f, **f)
        dtf = torch.tensor(c.dt, **f)

        def diag(v, k=0):
            return torch.diag(torch.tensor(v, **f), k)

        def eye(n, k=0):
            return torch.diag(torch.ones(n - abs(k), **f), k)

        dmp = c.damping
        k = dict(
            dt=dt, dtf=dtf,
            H_inp=torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0]], **f),
            A_inp=eye(4) + torch.diag(torch.stack([dt, dt]), 2),
            Q_inp=diag(c.q_inp) * dt,
            A_f=eye(4) + torch.diag(torch.stack([dtf, dtf]), 2),
            Q_f=diag(c.q_inp) * dtf,
            R_inp=diag(c.r_inp),
            A_pitch=torch.tensor([[1.0, dt_f], [0.0, 1.0]], **f),
            Q_pitch=0.0175 * diag([2.0, 3.0]) * dt,
            H_pitch=diag([1.0, 0.0]),
            R_pitch=0.0175 * diag([1.0, 10.0]),
            A_x=(eye(6) + diag([dt_f] * 3, 3)
                 + diag([0, 0, 0, dmp * dt_f, dmp * dt_f, dmp * dt_f])),
            Q_x=diag(c.q_xhat) * dt, R_x=diag(c.r_xhat),
            A_z=(eye(4) + eye(4, 1) * dt + eye(4, 2) / 2 * dt**2
                 + eye(4, 3) / 6 * dt**3),
            Q_z=diag(c.q_depth_err) * dt,
            H_z=torch.tensor([[1.0, 0, 0, 0]], **f),
            R_z=torch.tensor([[c.r_depth_err]], **f))
        # the gated position-KF measurement matrix, as 0/1 masks per gate
        for name, cells in (("H_g", ((0, 0), (1, 1))), ("H_1", ((2, 2),)),
                            ("H_tv", ((3, 3), (4, 4), (5, 5))),
                            ("H_vo", ((6, 3), (7, 4), (8, 5)))):
            m = torch.zeros((9, 6), **f)
            for r, cc in cells:
                m[r, cc] = 1.0
            k[name] = m
        self._consts[n_sub] = k
        return k

    # -- state ----------------------------------------------------------------
    def init_carry(self, x0: float = 0.0, y0: float = 0.0,
                   lanes: int = 1) -> dict:
        """Fresh persistent state (plant + estimators + latches) of
        ``lanes`` lanes, the device image of RobotRuntime.__init__'s
        estimator block."""
        pp = self.plant
        vals = dict(px=x0, py=y0, mass_pos=pp.mass_neutral,
                    pump_pos=pp.pump_neutral, mass_cmd=pp.mass_neutral,
                    pump_cmd=pp.pump_neutral, tail_freq=1.0,
                    inp_P=0.1 * np.eye(4), pitch_P=0.1 * np.eye(2),
                    xhat=[x0, y0, 0, 0, 0, 0], xhat_P=np.eye(6),
                    zerr_P=0.1 * np.eye(4), vb=[1e-4, 0.0, 1e-4],
                    Phat=[x0, y0, 0.0], last_fix_t=-1e9,
                    last_sample_t=-1e9, max_blue=1e-12, tlast_ctrl=-1e9,
                    tlast_p_ctrl=-1e9)
        out = {}
        for name, shape in _CARRY:
            v = torch.as_tensor(np.asarray(vals.get(name, np.zeros(shape)),
                                           float), **self._f)
            out[name] = v.expand((lanes,) + shape).clone()
        return out

    def pack_plan(self, waypoints, legs) -> DevicePlan:
        """Host helper: pad (waypoints, legs) from
        hw.runtime.chain_to_flight_plan into a one-lane DevicePlan."""
        wp = np.asarray(waypoints, float)
        n_wp = wp.shape[0]
        if n_wp > self.w_cap or len(legs) > self.l_cap:
            raise ValueError(f"plan exceeds capacity ({n_wp}/{self.w_cap} "
                             f"waypoints, {len(legs)}/{self.l_cap} legs)")
        pad = np.repeat(wp[-1:], self.w_cap - n_wp, axis=0)
        pad[:, 3] = wp[-1, 3] + 1.0 + np.arange(pad.shape[0])
        wp_p = np.concatenate([wp, pad], axis=0)
        lrows = np.zeros((self.l_cap, 4))
        for i, prim in enumerate(legs):
            lrows[i, 0] = float(prim[0])
            for j, v in enumerate(prim[1:][:3]):
                lrows[i, 1 + j] = float(v)
        f = self._f
        i = dict(dtype=torch.long, device=self.device)
        return DevicePlan(
            wp=torch.as_tensor(wp_p[None], **f),
            n_wp=torch.tensor([n_wp], **i),
            legs=torch.as_tensor(lrows[None], **f),
            n_legs=torch.tensor([len(legs)], **i),
            t_end=torch.tensor([wp[-1, 3]], **f))

    # -- one tick -------------------------------------------------------------
    def _tick(self, st: dict, plan: dict, t0, noise, n_sub: int = 1):
        """One runtime tick of ``n_sub * cfg.dt`` seconds for every lane:
        ``st`` the carry by name, ``noise`` (L, 13). ``n_sub`` > 1 is a
        coarse multi-rate tick (same physics and estimator
        discretizations, a longer step) of the glide-stride windows.
        Returns (new carry by name, log row by name)."""
        c, a, pp = self.cfg, self.agent, self.plant
        k = self._const(n_sub)
        dt = k["dt"]
        L = t0.shape[0]
        dev = self.device

        # --- plant step (hw.plant.GliderPlant.step) -----------------------
        st = dict(st)
        mass_prev, pump_prev = st["mass_pos"], st["pump_pos"]
        st["mass_pos"] = st["mass_pos"] + _sat(
            st["mass_cmd"] - st["mass_pos"], -pp.mass_rate * dt,
            pp.mass_rate * dt)
        st["pump_pos"] = st["pump_pos"] + _sat(
            st["pump_cmd"] - st["pump_pos"], -pp.pump_rate * dt,
            pp.pump_rate * dt)
        pitch_ss = pp.pitch_per_pct * (st["mass_pos"] - pp.mass_neutral)
        dpitch = pp.pitch_response * (pitch_ss - st["pitch"])
        st["pitch_rate"] = dpitch
        st["pitch"] = st["pitch"] + dpitch * dt
        w = pp.buoy_per_pct * (pp.pump_neutral - st["pump_pos"])
        dyaw = -pp.yaw_per_bias * torch.deg2rad(st["tail_bias"])
        st["yaw_rate"] = dyaw
        st["yaw"] = st["yaw"] + dyaw * dt
        v_swim = torch.where(
            st["tail_amp"] != 0.0,
            (pp.swim_speed * (torch.abs(st["tail_amp"]) / pp.ref_amp_deg)
             * (st["tail_freq"] / pp.ref_freq)), 0.0)
        glide_ok = ((torch.abs(st["pitch"]) > pp.min_glide_pitch)
                    & (torch.abs(w) > 1e-9))
        ratio = torch.clamp_max(
            1.0 / torch.tan(torch.clamp_min(torch.abs(st["pitch"]), 1e-6)),
            pp.max_glide_ratio)
        v_h = v_swim + torch.where(glide_ok, torch.abs(w) * ratio, 0.0)
        st["vx"] = v_h * torch.cos(st["yaw"])
        st["vy"] = v_h * torch.sin(st["yaw"])
        st["vz"] = torch.where((st["pz"] > 0.0) | (w > 0.0), w, 0.0)
        st["px"] = st["px"] + st["vx"] * dt
        st["py"] = st["py"] + st["vy"] * dt
        st["pz"] = torch.clamp_min(st["pz"] + w * dt, 0.0)
        st["t"] = st["t"] + dt
        t_abs = st["t"]
        t = t_abs - t0  # plan-relative

        # --- primitive lookup (reference :763-774) ------------------------
        wp, n_wp = plan["wp"], plan["n_wp"]
        lanes = torch.arange(L, device=dev)
        valid_wp = torch.arange(self.w_cap, device=dev) < n_wp[:, None]
        cnt = torch.sum((t[:, None] > wp[..., 3]) & valid_wp, dim=1)
        p_cnt = torch.minimum(torch.clamp_min(cnt - 1, 0),
                              torch.clamp_min(plan["n_legs"] - 1, 0))
        in_plan = (t <= plan["t_end"]) & (plan["n_legs"] > 0)
        leg = plan["legs"][lanes, p_cnt]
        code = torch.where(in_plan, leg[:, 0], -1.0)
        is_fd = code == float(Leg.FLATDIVE)
        is_sw = code == float(Leg.SWIM)
        is_sp = code == float(Leg.SPIRAL)
        is_gl = code == float(Leg.GLIDE)
        is_none = code < 0
        wypnt = torch.where(
            in_plan[:, None],
            wp[lanes, torch.minimum(p_cnt + 1, n_wp - 1), :3],
            wp[lanes, n_wp - 1, :3])
        tar = torch.stack(_interp(t[:, None], wp[..., 3],
                                  (wp[..., 0], wp[..., 1], wp[..., 2])),
                          dim=-1)[:, 0]

        # --- sensors (reference :780-792) ---------------------------------
        roll = st["roll"] + c.euler_noise * noise[:, 0]
        pitch_m = st["pitch"] + c.euler_noise * noise[:, 1]
        yaw_m = st["yaw"] + c.euler_noise * noise[:, 2]
        gx = 0.0 + c.gyro_noise * noise[:, 3]
        gy = st["pitch_rate"] + c.gyro_noise * noise[:, 4]
        gz = st["yaw_rate"] + c.gyro_noise * noise[:, 5]
        depth = st["pz"] + c.depth_noise * noise[:, 6]
        tail_deg = _tail_angle(t_abs, st["tail_bias"], st["tail_amp"],
                               st["tail_freq"])
        u0 = st["mass_pos"] / 100.0
        u1_in = st["pump_pos"] / 100.0
        u2_in = torch.deg2rad(tail_deg)
        truth = torch.stack([st["px"], st["py"], st["pz"]], dim=-1)
        blue = (self.field(truth).to(self.dtype) if self.field is not None
                else torch.zeros_like(t_abs))

        # --- tail input estimator + input KF + budget (:795-806) ----------
        d110 = math.radians(110)
        if n_sub == 1:
            ix, iP = _kf(st["inp_x"][..., None], st["inp_P"], k["A_inp"],
                         k["Q_inp"], torch.stack([u0, u1_in], -1)[..., None],
                         k["H_inp"], k["R_inp"])
            st["inp_x"], st["inp_P"] = ix[..., 0], iP
            dmass, dpump = ix[:, 2, 0], ix[:, 3, 0]
            ddelta = c.k_delta * _sat(u2_in - st["delta_hat"], -math.pi,
                                      math.pi)
            st["delta_hat"] = _sat(
                st["delta_hat"] + ddelta * dt - 0.5 * c.k_delta * ddelta
                * dt**2, -d110, d110)
            udot = torch.stack([dmass**2, dpump**2, ddelta**2,
                                torch.full_like(dmass, self.time_energy)],
                               -1)
            st["budget"] = st["budget"] + torch.sum(udot * self.w_udot, -1) * dt
            st["u2_prev"] = u2_in
        else:
            # coarse tick: the input-rate estimators feed the ENERGY
            # integral with rate-SQUARED terms, so they see the fine
            # actuator ramp, sub-stepped at the fine dt (the JAX package's
            # reasoning, mfgp_tpu/hw/runtime_device.py:340-349)
            dtf = k["dtf"]
            wu = self.w_udot
            mp, pq = mass_prev, pump_prev
            ix, iP = st["inp_x"][..., None], st["inp_P"]
            rate2 = torch.zeros_like(t_abs)
            dd2 = torch.zeros_like(t_abs)
            ddelta = torch.zeros_like(t_abs)
            u2p = st["u2_prev"]
            for j in range(n_sub):
                mp = mp + _sat(st["mass_cmd"] - mp, -pp.mass_rate * dtf,
                               pp.mass_rate * dtf)
                pq = pq + _sat(st["pump_cmd"] - pq, -pp.pump_rate * dtf,
                               pp.pump_rate * dtf)
                ix, iP = _kf(ix, iP, k["A_f"], k["Q_f"],
                             torch.stack([mp / 100.0, pq / 100.0],
                                         -1)[..., None],
                             k["H_inp"], k["R_inp"])
                rate2 = rate2 + (ix[:, 2, 0]**2 * wu[0]
                                 + ix[:, 3, 0]**2 * wu[1])
                u2_j = u2p + (j + 1) / n_sub * (u2_in - u2p)
                ddelta = c.k_delta * _sat(u2_j - st["delta_hat"],
                                          -math.pi, math.pi)
                st["delta_hat"] = _sat(
                    st["delta_hat"] + ddelta * dtf
                    - 0.5 * c.k_delta * ddelta * dtf**2, -d110, d110)
                dd2 = dd2 + ddelta**2
            st["inp_x"], st["inp_P"] = ix[..., 0], iP
            st["budget"] = st["budget"] + (
                (rate2 + wu[2] * dd2) * dtf
                + self.time_energy * wu[3] * dt)
            st["u2_prev"] = u2_in
        px_, pP_ = _kf(st["pitch_x"][..., None], st["pitch_P"],
                       k["A_pitch"], k["Q_pitch"],
                       torch.stack([pitch_m, gy], -1)[..., None],
                       k["H_pitch"], k["R_pitch"])
        st["pitch_x"], st["pitch_P"] = px_[..., 0], pP_

        # --- fidelity-binned field sampling (:809-819) --------------------
        burst = ((blue > c.blue_thresh * st["max_blue"])
                 & (t_abs - st["last_sample_t"] > 0.25 / a.meas_rate))
        sample = (t_abs - st["last_sample_t"] > 1.0 / a.meas_rate) | burst
        st["max_blue"] = torch.where(sample,
                                     torch.maximum(st["max_blue"], blue),
                                     st["max_blue"])
        st["last_sample_t"] = torch.where(sample, t_abs,
                                          st["last_sample_t"])
        cov_comp = st["xhat_P"][:, 0, 0] + st["xhat_P"][:, 1, 1]
        levs = self._levs
        fid = torch.where(cov_comp < levs[0], 1,
                          torch.where(cov_comp < levs[1], 2, 3))
        # the host records the GPData row's position estimate HERE, with
        # this tick's position-KF update still pending (:816-819)
        sample_xh = st["xhat"][:, :3]

        # --- position fix (:821-842) --------------------------------------
        fix = t_abs - st["last_fix_t"] >= 1.0 / c.fix_rate
        vel = torch.stack([st["vx"], st["vy"], st["vz"]], dim=-1)
        st["last_fix"] = torch.where(fix[:, None],
                                     truth + c.fix_noise * noise[:, 7:10],
                                     st["last_fix"])
        st["last_fix_vel"] = torch.where(
            fix[:, None], vel + c.fix_vel_noise * noise[:, 10:13],
            st["last_fix_vel"])
        st["last_fix_t"] = torch.where(fix, t_abs, st["last_fix_t"])
        tuav = (t_abs - st["last_fix_t"]) < 1.0
        use_gps = depth < c.at_surface

        # --- body-velocity observer (:845-861) ----------------------------
        if c.use_velocity_observer:
            R = self._rotm(roll, pitch_m, yaw_m)
            dP, dvb = self._observer(
                R, torch.stack([gx, gy, gz], -1), st["vb"], depth,
                st["Phat"][:, 2], u1_in, u2_in)
            Phat = st["Phat"] + dP * dt
            vb = st["vb"] + dvb * dt * float(c.dt < 0.5)
            diverged = (torch.any(torch.isnan(vb), -1)
                        | (torch.sqrt(torch.sum(vb * vb, -1)) > c.vb_cap))
            st["Phat"] = torch.where(
                diverged[:, None],
                torch.stack([st["last_fix"][:, 0], st["last_fix"][:, 1],
                             depth], -1), Phat)
            st["vb"] = torch.where(diverged[:, None], self._vb0, vb)
            vel_obs = (R @ st["vb"][..., None])[..., 0]
            use_vel = (~torch.any(torch.isnan(st["vb"]), -1)
                       & (torch.abs(ddelta) < math.radians(45)) & ~is_sw)
        else:
            vel_obs = torch.zeros_like(vel)
            use_vel = torch.zeros_like(is_sw)

        # --- 6-state position KF with gated H (:862-872) ------------------
        def gate(m):
            return m.to(self.dtype)[:, None, None]

        H = (k["H_g"] * gate(use_gps & tuav) + k["H_1"]
             + k["H_tv"] * gate(tuav) + k["H_vo"] * gate(use_vel))
        z = torch.cat([st["last_fix"][:, :2], depth[:, None],
                       st["last_fix_vel"], vel_obs], dim=1)[..., None]
        xh, xP = _kf(st["xhat"][..., None], st["xhat_P"], k["A_x"],
                     k["Q_x"], z, H, k["R_x"])
        st["xhat"], st["xhat_P"] = xh[..., 0], xP

        # --- depth-error KF (:874-875) ------------------------------------
        zx, zP = _kf(st["zerr_x"][..., None], st["zerr_P"], k["A_z"],
                     k["Q_z"], (depth - tar[:, 2])[:, None, None],
                     k["H_z"], k["R_z"])
        st["zerr_x"], st["zerr_P"] = zx[..., 0], zP

        # --- per-primitive control (:884-988) -----------------------------
        gains_p = c.linear_pitch_gains
        p_gate = t_abs - st["tlast_p_ctrl"] > 1.0 / c.pitch_control_rate
        c_gate = t_abs - st["tlast_ctrl"] > 1.0 / c.control_rate
        u1c = _pump_spd_control2(depth, st["zerr_x"], self._gains_d,
                                 c.k_max_depth, self.max_depth)
        # coarse multi-rate ticks fire each gate once per window: scale the
        # increments by the host fine-tick firings the window replaces
        # (exactly 1 on fine ticks)
        g_ctrl = max(1.0, n_sub * min(1.0, c.dt * c.control_rate))
        g_pctrl = max(1.0, n_sub * min(1.0, c.dt * c.pitch_control_rate))
        pump_new = _sat(100 * u1_in + u1c * g_ctrl / c.control_rate,
                        0, 75)
        a1, a2 = leg[:, 1], leg[:, 2]

        # FlatDive: theta_d = 0; Swim: theta_d = 0.1, bearing -> (bias,
        # amp); Glide: theta_d from theta_gd with the surface gate
        lf = st["last_fix"]
        rho2 = torch.hypot(wypnt[:, 1] - lf[:, 1], wypnt[:, 0] - lf[:, 0])
        bearing = torch.atan2(wypnt[:, 1] - lf[:, 1], wypnt[:, 0] - lf[:, 0])
        heading_err = _yaw_correction(yaw_m, bearing)
        sw_bias = _sat(3 * torch.rad2deg(heading_err), -90, 90)
        sw_amp = torch.where(
            rho2 > 0.5, self._tail_amp_deg,
            100 * rho2 * a.tail_amp / 50 * (torch.cos(heading_err) > 0))
        theta_gd = a1
        th_gl = torch.where(torch.abs(theta_gd) < math.radians(45),
                            -theta_gd,
                            -math.pi / 2 * torch.sign(theta_gd) + theta_gd)
        th_gl = torch.where(use_gps & (a2 < 0), 0.0, th_gl)
        gl_bias = _sat(torch.rad2deg(_yaw_correction(yaw_m, bearing)),
                       st["tail_bias"] - c.max_bias_rate * dt,
                       st["tail_bias"] + c.max_bias_rate * dt)

        # pitch-gated mass law (FlatDive / Swim / Glide)
        zero = torch.zeros_like(t_abs)
        theta_d = torch.where(is_fd, zero,
                              torch.where(is_sw, zero + 0.1,
                                          torch.where(is_gl, th_gl, zero)))
        u2c = _mass_spd_control(pitch_m, theta_d, st["pitch_x"][:, 1],
                                gains_p)
        mass_new = _sat(100 * u0 + u2c * g_pctrl / c.pitch_control_rate,
                        0, 100)
        mass_fire_p = (is_fd | is_sw | is_gl) & p_gate
        st["mass_cmd"] = torch.where(mass_fire_p, mass_new, st["mass_cmd"])
        st["tlast_p_ctrl"] = torch.where(mass_fire_p, t_abs,
                                         st["tlast_p_ctrl"])

        # control-rate-gated laws; Spiral mass schedule (:948-953): a1=dz
        sp_mass = torch.where(use_gps & (a1 < 0), 46.0,
                              torch.where(a1 > 0, 35.0,
                                          torch.where(a1 < 0, 60.0,
                                                      st["mass_cmd"])))
        sp_mass_fire = is_sp & c_gate & ((use_gps & (a1 < 0))
                                         | (a1 > 0.1) | (a1 < 0))
        st["mass_cmd"] = torch.where(sp_mass_fire, _sat(sp_mass, 0, 100),
                                     st["mass_cmd"])
        # surfacing trim (:983-988)
        trim = (is_none & (depth > c.at_surface * 0.5)
                & (t_abs - st["tlast_ctrl"] > 10.0 / c.control_rate))
        pump_fire = (is_fd | is_sw | is_sp | is_gl) & c_gate
        st["pump_cmd"] = torch.where(
            pump_fire, pump_new,
            torch.where(trim, _sat(100 * u1_in + 3, 0, 75),
                        st["pump_cmd"]))
        st["mass_cmd"] = torch.where(trim, 46.0, st["mass_cmd"])
        st["tlast_ctrl"] = torch.where(pump_fire | trim, t_abs,
                                       st["tlast_ctrl"])

        # tail writes: swim sets (bias, amp, freq); others zero amp; spiral
        # and glide set bias (:931-933, :953-954, :990-993 order)
        st["tail_amp"] = torch.where(is_sw & c_gate, _sat(sw_amp, 0, 50),
                                     torch.where(~is_sw, 0.0,
                                                 st["tail_amp"]))
        st["tail_freq"] = torch.where(is_sw & c_gate, self._tail_freq,
                                      st["tail_freq"])
        st["tail_bias"] = torch.where(
            is_sw & c_gate, sw_bias,
            torch.where(is_sp & c_gate, torch.rad2deg(a2),
                        torch.where(is_gl & c_gate, gl_bias,
                                    st["tail_bias"])))

        err2 = ((st["px"] - tar[:, 0])**2 + (st["py"] - tar[:, 1])**2
                + (st["pz"] - tar[:, 2])**2)
        out = dict(t=t_abs, truth=truth, vel=vel, xhat=st["xhat"],
                   sample_xh=sample_xh,
                   Pdiag=torch.diagonal(st["xhat_P"], dim1=-2, dim2=-1),
                   blue=blue, sample=sample, fid=fid, budget=st["budget"],
                   err2=err2, code=code, Phat=st["Phat"], vb=st["vb"])
        return st, out

    # -- windows: the scheduled units of the flight ---------------------------
    def _row(self, out: dict, alive) -> torch.Tensor:
        out = dict(out, sample=out["sample"] & alive, alive=alive)
        return _pack(out, _LOG)

    def _fine(self, b, flat, i0):
        """``glide_stride`` fine ticks from tick ``i0``: (new flat carry,
        log rows (L, stride, LOG_WIDTH))."""
        rows = []
        for j in range(self.glide_stride):
            i = i0 + j
            st, out = self._tick(_unpack(flat, _CARRY_SLOTS), b["plan"],
                                 b["t0"], b["noise"].index_select(1, i)[:, 0])
            alive = i < b["n_ticks"]
            flat = torch.where(alive[:, None], _pack(st, _CARRY), flat)
            rows.append(self._row(out, alive))
        return flat, torch.stack(rows, dim=1)

    def _coarse(self, b, flat, i0):
        """One coarse tick covering the window at ``i0``: a window wholly
        past the plan rides it too and stays frozen."""
        s = self.glide_stride
        st, out = self._tick(_unpack(flat, _CARRY_SLOTS), b["plan"], b["t0"],
                             b["noise"].index_select(1, i0)[:, 0], n_sub=s)
        live = i0 < b["n_ticks"]
        flat = torch.where(live[:, None], _pack(st, _CARRY), flat)
        first = torch.arange(s, device=self.device) == 0
        row = self._row(out, torch.zeros_like(live))
        rows = row[:, None].expand(-1, s, -1).clone()
        a = _LOG_SLOTS["alive"][0]
        sm = _LOG_SLOTS["sample"][0]
        alive = (first[None] & live[:, None]).to(flat.dtype)
        rows[..., a] = alive
        rows[..., sm] = out["sample"][:, None].to(flat.dtype) * alive
        return flat, rows

    def _window(self, b, kind: str):
        """One window of ``kind`` on the fixed buffers ``b``, in place:
        ``fine``, ``coarse`` or ``mixed`` (both sides, each lane's choice
        from the host schedule ``b["sched"]``)."""
        i0, flat = b["i"], b["flat"]
        if kind == "fine":
            new, rows = self._fine(b, flat, i0)
        elif kind == "coarse":
            new, rows = self._coarse(b, flat, i0)
        else:
            w = torch.div(i0, self.glide_stride, rounding_mode="floor")
            ok = b["sched"].index_select(1, w)[:, 0]
            fc, rc = self._coarse(b, flat, i0)
            ff, rf = self._fine(b, flat, i0)
            new = torch.where(ok[:, None], fc, ff)
            rows = torch.where(ok[:, None, None], rc, rf)
        idx = i0 + torch.arange(self.glide_stride, device=self.device)
        b["logs"].index_copy_(1, idx, rows)
        flat.copy_(new)
        i0.add_(self.glide_stride)

    # -- the host schedule of a multi-rate flight ----------------------------
    def _schedule(self, b, n_windows: int) -> np.ndarray:
        """(L, n_windows) bool: which windows are coarse, from the plan and
        the tick clock alone (the clock advances by ``stride * dt`` per
        coarse window and by ``dt`` per live fine tick, in the runtime's
        dtype, so the host recurrence meets the device's clock exactly)."""
        c, s = self.cfg, self.glide_stride
        nd = np.float64 if self.dtype == torch.float64 else np.float32
        plan = {k: v.cpu().numpy() for k, v in b["plan"].items()}
        t0 = b["t0"].cpu().numpy()
        t = b["flat"][:, _CARRY_SLOTS["t"][0]].cpu().numpy()
        n = b["n_ticks"].cpu().numpy()
        dt_f, dt_c = nd(c.dt), nd(c.dt * s)
        L = t.shape[0]
        out = np.zeros((L, n_windows), bool)
        for l in range(L):
            wpt = plan["wp"][l, :plan["n_wp"][l], 3]
            nl = int(plan["n_legs"][l])
            codes = plan["legs"][l, :, 0]
            te = plan["t_end"][l]
            tl = t[l]
            for w in range(n_windows):
                i0 = w * s
                tw0 = nd(tl + nd(c.dt)) - t0[l]
                tw1 = nd(tl + nd(s * c.dt)) - t0[l]
                cnt0 = int(np.sum(tw0 > wpt))
                cnt1 = int(np.sum(tw1 > wpt))
                p = min(max(cnt0 - 1, 0), max(nl - 1, 0))
                code = codes[p] if (tw0 <= te and nl > 0 and p < nl) else -1
                dead = i0 >= n[l]
                ok = dead or (cnt0 == cnt1 and tw1 <= te
                              and code == float(Leg.GLIDE)
                              and i0 + s <= n[l])
                out[l, w] = ok
                if ok:
                    if not dead:
                        tl = nd(tl + dt_c)
                else:
                    for j in range(s):
                        if i0 + j < n[l]:
                            tl = nd(tl + dt_f)
        return out

    # -- the flight -----------------------------------------------------------
    def _engine(self, L: int, t_cap: int) -> dict:
        key = (L, t_cap)
        if key in self._engines:
            return self._engines[key]
        s, C = self.glide_stride, self.chunk
        T = -(-t_cap // s)  # windows
        Tn = (-(-T // C) * C) * s  # ticks in the buffers
        f = self._f
        i = dict(dtype=torch.long, device=self.device)
        b = dict(
            flat=torch.zeros((L, CARRY_WIDTH), **f),
            plan=dict(wp=torch.zeros((L, self.w_cap, 4), **f),
                      n_wp=torch.ones(L, **i),
                      legs=torch.zeros((L, self.l_cap, 4), **f),
                      n_legs=torch.zeros(L, **i),
                      t_end=torch.zeros(L, **f)),
            t0=torch.zeros(L, **f), n_ticks=torch.zeros(L, **i),
            noise=torch.zeros((L, Tn, 13), **f),
            logs=torch.zeros((L, Tn, LOG_WIDTH), **f),
            sched=torch.zeros((L, Tn // s), dtype=torch.bool,
                              device=self.device),
            i=torch.zeros(1, **i), T=T, graphs={})
        self._engines[key] = b
        return b

    def _run(self, b, kind: str, n: int, stats: dict) -> None:
        """``n`` windows of ``kind``: eager, or replays of a captured chunk
        of ``chunk`` windows and of a captured single window."""
        if not self.graph:
            for _ in range(n):
                self._window(b, kind)
            return
        C = self.chunk
        full, rest = divmod(n, C)
        for size, reps in ((C, full), (1, rest)):
            if not reps:
                continue
            g = b["graphs"].get((kind, size))
            if g is None:
                g = self._capture(b, kind, size)
                stats["captures"] += 1
            for _ in range(reps):
                g.replay()
            stats["replays"] += reps

    def _capture(self, b, kind: str, size: int):
        """Capture ``size`` windows of ``kind`` on the buffers ``b``: a
        warm-up outside the capture, on a side stream, whose effects on
        the carry and the tick counter are undone (its log rows are
        rewritten by the replay that follows)."""
        flat0, i0 = b["flat"].clone(), b["i"].clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(size):
                self._window(b, kind)
        torch.cuda.current_stream(self.device).wait_stream(side)
        b["flat"].copy_(flat0)
        b["i"].copy_(i0)
        g = torch.cuda.CUDAGraph()
        profiling.count("graph.captures")
        with torch.cuda.graph(g):
            for _ in range(size):
                self._window(b, kind)
        b["graphs"][(kind, size)] = g
        return g

    def fly(self, plan: DevicePlan, carry: dict, noise, t_cap: int):
        """Fly L plans: ``carry`` by name with a leading lane axis (see
        :meth:`init_carry`), ``noise`` (L, >= t_cap, 13) standard normal
        draws (tick i reads row i; a coarse window reads its first row).
        Returns (new carry, logs by name (L, t_cap, ...)); ticks past
        ``ceil(t_end/dt)+1`` (or ``t_cap``) are frozen and their rows dead
        (``alive``/``sample`` False)."""
        with torch.no_grad():
            return self._fly(plan, carry, noise, int(t_cap))

    def _fly(self, plan, carry, noise, t_cap):
        s = self.glide_stride
        L = plan.wp.shape[0]
        b = self._engine(L, t_cap)
        f = self._f
        b["flat"].copy_(_pack({k: torch.as_tensor(v, **f)
                               for k, v in carry.items()}, _CARRY))
        for k in ("wp", "n_wp", "legs", "n_legs", "t_end"):
            b["plan"][k].copy_(getattr(plan, k))
        t0 = b["flat"][:, _CARRY_SLOTS["t"][0]]
        b["t0"].copy_(t0)
        n_ticks = (torch.ceil(b["plan"]["t_end"] / self.cfg.dt).long() + 1)
        b["n_ticks"].copy_(torch.clamp_max(n_ticks, t_cap))
        noise = torch.as_tensor(noise, **f)
        Tn = b["noise"].shape[1]
        b["noise"].zero_()
        b["noise"][:, :min(Tn, noise.shape[1])] = noise[:, :Tn]
        b["logs"].zero_()
        b["i"].zero_()
        T = b["T"]
        stats = dict(windows=0, replays=0, captures=0, coarse=0, fine=0,
                     mixed=0)
        if self.early_stop:  # one host read: the last window with a live tick
            T = min(T, -(-int(b["n_ticks"].max()) // s))
        if s == 1:
            n = (-(-T // self.chunk) * self.chunk if self.graph and
                 not self.early_stop else T)
            self._run(b, "fine", n, stats)
            stats["windows"] = n
        else:
            sched = self._schedule(b, T)
            b["sched"][:, :T].copy_(torch.as_tensor(sched))
            kinds = np.where(sched.all(0), 0, np.where(sched.any(0), 2, 1))
            names = ("coarse", "fine", "mixed")
            w = 0
            while w < T:
                e = w
                while e < T and kinds[e] == kinds[w]:
                    e += 1
                self._run(b, names[kinds[w]], e - w, stats)
                stats[names[kinds[w]]] += e - w
                w = e
            stats["windows"] = T
        self.last_fly = stats
        new = {k: v.clone() for k, v in _unpack(b["flat"],
                                                _CARRY_SLOTS).items()}
        return new, self._logs(b["logs"][:, :t_cap])

    @staticmethod
    def _logs(rows) -> dict:
        L, T = rows.shape[:2]
        out = {}
        for k, (o, n, shape) in _LOG_SLOTS.items():
            v = rows[..., o:o + n].reshape((L, T) + shape).clone()
            if k in ("sample", "alive"):
                v = v != 0
            elif k == "fid":
                v = v.long()
            out[k] = v
        return out

    # -- host-facing wrapper for tests/CLI ------------------------------------
    def fly_log(self, waypoints, legs, carry=None, seed: int = 0,
                t_cap: Optional[int] = None, noise=None):
        """Host convenience: pack, fly one lane, and unpack into numpy
        arrays mirroring hw.runtime.FlightLog's core fields. The tick noise
        is ``noise`` (t_cap, 13) when given, else standard normal draws
        from a CPU ``torch.Generator`` seeded with ``seed``."""
        plan = self.pack_plan(waypoints, legs)
        if carry is None:
            carry = self.init_carry(float(waypoints[0][0]),
                                    float(waypoints[0][1]))
        if t_cap is None:
            t_cap = int(math.ceil(float(waypoints[-1][3]) / self.cfg.dt)) + 1
        if noise is None:
            noise = torch.randn((t_cap, 13),
                                generator=torch.Generator().manual_seed(seed),
                                dtype=torch.float64)
        noise = torch.as_tensor(np.array(noise), **self._f)[None]
        budget0 = float(carry["budget"][0])
        carry, logs = self.fly(plan, carry, noise, t_cap)
        lg = {k: v[0].cpu().numpy() for k, v in logs.items()}
        alive, smp = lg["alive"], lg["sample"]
        t, truth, xh = lg["t"], lg["truth"], lg["xhat"]
        samples = np.column_stack([
            t[smp], truth[smp], lg["sample_xh"][smp], lg["blue"][smp],
            lg["fid"][smp].astype(float)])
        err2 = lg["err2"][alive]
        budget = float(carry["budget"][0])
        return dict(
            carry=carry,
            truth=np.column_stack([t[alive], truth[alive],
                                   lg["vel"][alive]]),
            estimates=np.column_stack([t[alive], xh[alive],
                                       lg["Pdiag"][alive]]),
            samples=samples,
            budget_used=budget,
            plan_budget=budget - budget0,
            tracking_rmse=float(np.sqrt(err2.mean())) if err2.size else 0.0)
