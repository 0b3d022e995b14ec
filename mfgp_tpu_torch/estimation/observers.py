"""Rigid-body utilities and the glider body-velocity observer (counterpart
of ``mfgp_tpu/estimation/observers.py``).

Covers SURVEY C6 (the live model-based observer,
reference/GraceObservers.py:140-215) and the rotation helpers
(reference/GraceObservers.py:32-57). The reference's dead observers
(SMO/HGSMO/velEstimator2/vyt*/fullStateObserver, SURVEY C7) are not
ported; the :class:`Observer` protocol below is where new observers plug
into the simulation loop.

Every function is torch on its inputs' device and in their dtype (plain
floats follow the tensors they meet). They build no tensor from host
values: constants enter as Python scalars of tensor operations, so one
observer step can be captured as a CUDA graph (``hw.runtime``).
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import torch

from mfgp_tpu_torch.utils.device import CUDA, resolve


def _like(ref: torch.Tensor, *values) -> list:
    """``values`` as 0-d tensors in ``ref``'s dtype on its device; tensors
    pass through, numbers become fills (no host-to-device copy)."""
    return [v.to(ref.dtype) if isinstance(v, torch.Tensor)
            else ref.new_full((), float(v)) for v in values]


def _rows(*rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows])


# -- rotations --------------------------------------------------------------
def skew(w):
    """Cross-product matrix (reference/GraceObservers.py:32-35)."""
    wx, wy, wz = w[0], w[1], w[2]
    z = torch.zeros_like(wx)
    return _rows([z, -wz, wy], [wz, z, -wx], [-wy, wx, z])


def euler_to_rotm(roll, pitch, yaw):
    """ZYX Euler angles -> rotation matrix, matching the reference's
    convention (reference/GraceObservers.py:37-42)."""
    ref = next((v for v in (roll, pitch, yaw) if isinstance(v, torch.Tensor)),
               None)
    if ref is None:  # numbers alone: a tensor as torch.as_tensor makes one
        ref = torch.as_tensor(float(roll), dtype=torch.float64)
    roll, pitch, yaw = _like(ref, roll, pitch, yaw)
    ca, sa = torch.cos(roll), torch.sin(roll)
    cb, sb = torch.cos(pitch), torch.sin(pitch)
    cg, sg = torch.cos(yaw), torch.sin(yaw)
    o, z = torch.ones_like(ca), torch.zeros_like(ca)
    Rx = _rows([o, z, z], [z, ca, sa], [z, -sa, ca])
    Ry = _rows([cb, z, -sb], [z, o, z], [sb, z, cb])
    Rz = _rows([cg, sg, z], [-sg, cg, z], [z, z, o])
    return Rz @ Ry @ Rx


def rotm_to_euler(R):
    """Rotation matrix -> (roll, pitch, yaw); branch-free version of
    reference/GraceObservers.py:44-51 (the reference returns None in the
    singular branch; the standard gimbal-lock convention is used instead)."""
    sy = torch.sqrt(R[2, 1] ** 2 + R[2, 2] ** 2)
    roll = torch.atan2(R[2, 1], R[2, 2])
    pitch = torch.atan2(-R[2, 0], sy)
    yaw = torch.atan2(R[1, 0], R[0, 0])
    return roll, pitch, yaw


def flow_frame(alpha, beta):
    """Body->flow rotation (reference/GraceObservers.py:53-54)."""
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    return _rows([ca * cb, -ca * sb, -sa],
                 [sb, cb, torch.zeros_like(sa)],
                 [sa * cb, -sa * sb, cb])


def euler_rate_matrix(roll, pitch):
    """Body rates -> Euler angle rates (reference/GraceObservers.py:56-57)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    tp, cp = torch.tan(pitch), torch.cos(pitch)
    o, z = torch.ones_like(cr), torch.zeros_like(cr)
    return _rows([o, tp * sr, tp * cr],
                 [z, cr, -sr],
                 [z, sr / cp, cr / cp])


# -- glider hydrodynamic model ---------------------------------------------
class GliderParams(NamedTuple):
    """Hydrodynamic constants of the glider body-velocity observer.

    Field names follow the parameter unpacking order at
    reference/GraceObservers.py:157 (31-vector); only the entries the live
    observer actually reads are kept.
    """

    mc: float = 0.0  # chassis mass offset for ballast law
    lm: float = 0.0
    bc: float = 0.5  # ballast neutral position
    lp: float = 1.0  # pump position -> added mass scale
    g: float = 9.81
    m1: float = 1.0  # added-mass diagonal
    m2: float = 1.0
    m3: float = 1.0
    CD0: float = 0.2  # drag polar
    CaD: float = 1.0
    CdD: float = 0.1
    C_beta_FS: float = 0.5  # sideforce
    C_delta_FS: float = 0.1
    CL0: float = 0.0  # lift
    CaL: float = 5.0
    S: float = 0.01  # reference area
    rho: float = 1000.0  # water density


def buoyancy_mass(ppx, p: GliderParams):
    """Net ballast mass from pump position (reference/GraceObservers.py:172)."""
    return p.lp * (ppx - p.bc)


def body_velocity_observer(R, omega_b, vb_est, z, zhat, ppx, delta,
                           p: GliderParams, gains=(1.0, 1.0, 1.0)):
    """One derivative evaluation of the model-based body-velocity observer.

    Inputs: rotation matrix R (body->world), body rates omega_b (3,), current
    velocity estimate vb_est (3,) (tensors, one device and dtype), measured
    depth z, estimated depth zhat, pump position ppx, tail angle delta
    (tensors or numbers).
    Returns (dPos_est, dvb_est) world-position and body-velocity derivatives,
    reproducing the dynamics of reference/GraceObservers.py:140-215: drag /
    sideforce / lift in the flow frame, ballast gravity term, rigid-body
    Coriolis, and depth-error injection on both states.
    """
    z, zhat, ppx, delta = _like(vb_est, z, zhat, ppx, delta)
    v1, v2, v3 = vb_est[0], vb_est[1], vb_est[2]
    V = torch.sqrt(v1**2 + v2**2 + v3**2)
    alpha = torch.atan2(v3, v1)
    zero = torch.zeros_like(V)
    beta = torch.where(v2 == 0, zero, torch.arcsin(torch.where(
        V > 0, v2 / torch.clamp_min(V, 1e-12), zero)))

    q = 0.5 * p.rho * V**2 * p.S
    D = q * (p.CD0 + p.CaD * alpha**2 + p.CdD * delta**2)
    FS = q * (p.C_beta_FS * beta + p.C_delta_FS * delta)
    L = q * (p.CL0 + p.CaL * alpha) * torch.cos(alpha)

    R_bv = flow_frame(alpha, beta)
    F_ext = R_bv @ torch.stack([-D, FS, -L])
    M = torch.diag(torch.stack(_like(V, p.m1, p.m2, p.m3)))
    m0 = buoyancy_mass(ppx, p)
    coriolis = torch.linalg.cross(M @ vb_est, omega_b)
    # R^T k with k the world z axis: the third row of R
    rhs = coriolis + m0 * p.g * R[2] + F_ext
    # a 3 x 3 solve that never reads its status back (capturable)
    v_b_dot = torch.linalg.solve_ex(M, rhs, check_errors=False)[0]

    K = torch.diag(torch.stack(_like(V, *gains)))
    depth_err = torch.stack([zero, zero, z - zhat])
    dPos_est = R @ vb_est + 0.5 * depth_err
    dvb_est = v_b_dot + K @ (R.mT @ depth_err)
    return dPos_est, dvb_est


# -- extensible observer interface (replaces the reference's dead C7 zoo) ---
class Observer(Protocol):
    """An observer maps (state_estimate, measurements, dt) -> state_estimate.

    Implementations are pure tensor functions. The simulation loop and the
    drivers accept any Observer; ``BodyVelocityObserver`` is the one the
    reference exercises.
    """

    def init(self, dtype=torch.float64, device=CUDA) -> torch.Tensor: ...

    def step(self, state, measurement, dt): ...


class BodyVelocityObserver(NamedTuple):
    """Euler-integrated wrapper of :func:`body_velocity_observer` (the
    reference integrates it at ~10 Hz in the driver's main loop,
    reference/PhysicalExperimentCode/
    GraceExplorationExperiments_MFEGP.py:851-870, with a NaN reset guard)."""

    params: GliderParams
    gains: tuple = (1.0, 1.0, 1.0)

    def init(self, dtype=torch.float64, device=CUDA):
        """The zero estimate on ``device`` (the card unless asked)."""
        return torch.zeros(3, dtype=dtype, device=resolve(device))

    def step(self, vb_est, meas, dt):
        R, omega_b, z, zhat, ppx, delta = meas
        _, dvb = body_velocity_observer(R, omega_b, vb_est, z, zhat, ppx,
                                        delta, self.params, self.gains)
        vb_new = vb_est + dt * dvb
        # NaN-reset guard (reference/...MFEGP.py:855-858)
        return torch.where(torch.any(torch.isnan(vb_new)),
                           torch.zeros_like(vb_new), vb_new)
