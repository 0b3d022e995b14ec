"""The planners of the port (counterpart of ``mfgp_tpu/planning``): the
motion primitives and the host RIG graph planner (NumPy copies of the JAX
package's modules), the six path costs, which score candidate paths as
lanes on the model's device, and ``DeviceRIG``, the whole RIG loop on the
device (``rig_device``, on ``primitives_device``).

``DeviceRIG`` draws its random numbers from a ``torch.Generator`` seeded
per plan; it reproduces the JAX package's plans only when given that
package's ``jax.random`` draws (``plan(draws=...)``). Not carried over:
``MFGP_TPU_PLAN_GATHER`` and ``plan(gather=)``, the TPU's A/B between two
index lowerings (the port has one). ``plan_ensemble(mesh=)`` shards the
ensemble's lanes over the dp ranks of a ``parallel.make_mesh`` mesh.

    python -m pytest tests/test_torch_primitives_device.py \
        tests/test_torch_rig_device.py -q        # CPU parity with JAX
    python3 chip_smoke.py --only device_planner  # on the card
"""

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
from mfgp_tpu_torch.planning.rig_device import DeviceRIG  # noqa: F401,E402
