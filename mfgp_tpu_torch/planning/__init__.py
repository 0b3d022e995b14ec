"""The host planner of the port (counterpart of ``mfgp_tpu/planning``):
the motion primitives and the RIG graph planner (NumPy copies of the JAX
package's modules) and the six path costs, which score candidate paths as
lanes on the model's device. ``DeviceRIG`` (the whole planner as one
device program) is not ported yet."""

from mfgp_tpu_torch.planning.primitives import (  # noqa: F401
    AgentConfig, Leg, generate_trajectory, evaluate_trajectory,
    edge_points_to_traj_points, path_to_traj_points, swim_energy,
)
from mfgp_tpu_torch.planning.scoring import (  # noqa: F401
    ErgodicCost, FourierErgodicCost, SFInfoGainCost, MFInfoGainCost,
    BatchLogDetCost,
    MFBatchLogDetCost,
)
from mfgp_tpu_torch.planning.rig import RIGPlanner, Node, PathSegment  # noqa: F401
