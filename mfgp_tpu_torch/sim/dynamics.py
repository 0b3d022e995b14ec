"""Toy agent dynamics + RK4 integrator (SURVEY C22; counterpart of
``mfgp_tpu/sim/dynamics.py``).

The reference ships these in HowManyPoints.py as unused code with
undefined-variable bugs (``graceSimple`` reads names that don't exist,
reference/HowManyPoints.py:29-31); here they are working pure functions
of tensors, on the state's device and in its dtype, for quick closed-loop
experiments and tests.
"""

from __future__ import annotations

import torch


def rk4_step(f, x, u, dt):
    """Classic RK4 for ``dx = f(x, u)``
    (reference/HowManyPoints.py:17-23's integrator, corrected)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def single_integrator_3d(x, u):
    """dx = u; state (3,), input (3,)
    (reference/HowManyPoints.py ``singleIntegrator3D``)."""
    return torch.as_tensor(u, dtype=x.dtype, device=x.device)


def unicycle_3d(x, u):
    """Planar unicycle + vertical rate: state (x, y, z, yaw),
    input (v, vz, yaw_rate) (reference/HowManyPoints.py ``Unicycle3D``)."""
    v, vz, w = u[0], u[1], u[2]
    yaw = x[3]
    return torch.stack([v * torch.cos(yaw), v * torch.sin(yaw),
                        torch.as_tensor(vz, dtype=x.dtype, device=x.device),
                        torch.as_tensor(w, dtype=x.dtype, device=x.device)])


def glider_simple(x, u, g: float = 9.81, drag: float = 0.5):
    """Minimal longitudinal glider: state (x, z, vx, vz),
    input (thrust, pitch) — the intent of the reference's broken
    ``graceSimple`` (undefined vars at reference/HowManyPoints.py:29-31),
    made well-defined: gravity, quadratic drag, thrust along pitch."""
    thrust, pitch = u[0], u[1]
    vx, vz = x[2], x[3]
    sp = torch.sqrt(vx**2 + vz**2)
    ax = thrust * torch.cos(pitch) - drag * sp * vx
    az = -g + thrust * torch.sin(pitch) - drag * sp * vz
    return torch.stack([vx, vz, ax, az])
