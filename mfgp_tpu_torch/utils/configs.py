"""Declarative configuration (counterpart of ``mfgp_tpu/utils/configs.py``).

Plain frozen dataclasses with the reference's parameter names
(reference/exploreSimSettings.py), no side effects, and explicit
constructors for derived objects (the Kalman model, the evaluation grid).
``SimConfig.agent()`` and ``ExperimentConfig`` of the JAX package belong to
the planner and the explorer and are not here yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np
import torch

from mfgp_tpu_torch.utils.device import CUDA, resolve


@dataclass(frozen=True)
class KFConfig:
    """6-state constant-velocity filter constants
    (reference/exploreSimSettings.py:143-153)."""

    p0: float = 0.001
    q_diag: Tuple[float, ...] = (0.005, 0.005, 0.005, 0.05, 0.05, 0.05)
    r_diag: Tuple[float, ...] = (0.1, 0.1, 0.05, 0.25, 0.25, 0.25)
    meas_noise: Tuple[float, ...] = (0.05, 0.05, 0.02, 0.2, 0.2, 0.2)
    at_surface: float = 0.2

    def model(self, dtype=torch.float64, device=CUDA):
        """The filter's matrices as tensors on ``device`` (the card unless
        asked otherwise)."""
        from mfgp_tpu_torch.estimation.kalman import KFModel

        z = dict(dtype=dtype, device=resolve(device))
        return KFModel(
            P0=self.p0 * torch.eye(6, **z),
            Q=torch.diag(torch.tensor(self.q_diag, **z)),
            R=torch.diag(torch.tensor(self.r_diag, **z)),
            meas_noise_std=torch.tensor(self.meas_noise, **z),
            at_surface=self.at_surface,
        )


@dataclass(frozen=True)
class SimConfig:
    """Simulation-pipeline settings (reference/exploreSimSettings.py:88-206).

    Parameter names follow the reference so recorded artifacts and settings
    files line up 1:1.
    """

    seed: int = 0
    WS: Tuple[Tuple[float, float], ...] = ((0.0, 10.0), (0.0, 20.0))
    max_depth: float = 10.0
    vmn: float = 0.2  # velocity measurement noise (m/s)^2
    dt: float = 0.1
    at_surface: float = 0.2
    meas_noise: float = 0.125  # field measurement noise
    meas_rate: float = 0.2  # Hz, GP-data downsample (reference/prepGPData.py:17)
    t_cut: float = 3600.0  # dataset time cutoff (reference/GPTrainers.py:37)
    field_offset: float = 0.0
    # planner (reference/exploreSimSettings.py:198-205)
    B: float = 150.0
    BD: int = 10
    same_node_distance: float = 1.0
    max_iter: int = 100
    Rd: float = 5.0
    near_rad: float = 1.25
    step_size: float = 10.0
    goal_var: float = 4.0  # 2**2
    normalize_wmse: bool = True
    kf: KFConfig = field(default_factory=KFConfig)

    @property
    def fidlevels(self) -> Tuple[float, float, float]:
        """``(min(diff(WS)) * [.05,.15,.25])**2``
        (reference/exploreSimSettings.py:108)."""
        spans = [hi - lo for lo, hi in self.WS]
        m = min(spans)
        return tuple((m * f) ** 2 for f in (0.05, 0.15, 0.25))

    @property
    def kf_meas_noise(self) -> Tuple[float, ...]:
        """Measurement-noise std vector with the velocity-noise level
        spliced in (reference/exploreSimSettings.py:154)."""
        return (0.05, 0.05, 0.02, self.vmn, self.vmn, self.vmn)

    def kf_model(self, dtype=torch.float64, device=CUDA):
        return replace(self.kf, meas_noise=self.kf_meas_noise,
                       at_surface=self.at_surface).model(dtype, device)

    def test_points(self, nums=(10, 20, 10)) -> np.ndarray:
        """The 2000-point eval grid, Fortran raveled to match the
        reference's ``testPoints`` ordering
        (reference/exploreSimSettings.py:116-119)."""
        return _grid([(self.WS[0][0], self.WS[0][1], nums[0]),
                      (self.WS[1][0], self.WS[1][1], nums[1]),
                      (0.0, self.max_depth, nums[2])])

    def agent(self):
        raise NotImplementedError(
            "SimConfig.agent() waits for mfgp_tpu_torch.planning.primitives "
            "(AgentConfig), which is not ported yet")


def _grid(specs) -> np.ndarray:
    """Fortran-raveled meshgrid, the reference's grid convention."""
    g = np.meshgrid(*[np.linspace(a, b, n) for a, b, n in specs])
    return np.array([x.ravel("F") for x in g]).T


DEFAULT_SIM = SimConfig()
