"""Closed-loop exploration simulation (counterpart of ``mfgp_tpu/sim``)."""

from mfgp_tpu_torch.sim.dynamics import (glider_simple, rk4_step,  # noqa: F401
                                         single_integrator_3d, unicycle_3d)
from mfgp_tpu_torch.sim.explore import (ExplorationResult, ExplorationSim,
                                        ReplanRecord)
