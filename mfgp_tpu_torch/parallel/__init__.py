"""Multi-device parallelism on ``torch.distributed`` (counterpart of
``mfgp_tpu/parallel``): mp-sharded posteriors and gradients, the
distributed Cholesky, dp-sharded restart fits and the process-sharded
sweep. Every rank calls the same functions after ``init_ranks`` (ranks
started by ``torchrun``) or ``torch.distributed.init_process_group``;
``make_mesh`` lays the ranks out as a (dp, mp) ``DeviceMesh``.

In place of the JAX package's ``replicated``/``dp_sharding``/
``mp_sharding`` (``NamedSharding`` layouts), ``shard_rows`` takes a rank's
block of a tensor and ``all_gather`` makes a sharded result whole again.
"""

from mfgp_tpu_torch.parallel.mesh import (DP_AXIS, MP_AXIS, all_gather,
                                          init_ranks, make_mesh,
                                          pad_to_multiple, shard_rows)
from mfgp_tpu_torch.parallel.sharded import (make_sharded_ar1_cross_cov,
                                             make_sharded_nlml_value_and_grad,
                                             make_sharded_gp_predict,
                                             make_sharded_mfgp_predict,
                                             make_sharded_weighted_mse)
from mfgp_tpu_torch.parallel.train import (TrainState, fit_sharded,
                                           init_restarts,
                                           make_mfgp_train_step,
                                           train_state_from_numpy)
from mfgp_tpu_torch.parallel.sweep import (env_shard, process_shard,
                                           run_sweep, trainer_sweep)
from mfgp_tpu_torch.parallel.chol import make_sharded_cholesky
from mfgp_tpu_torch.parallel.chol import (
    make_fully_sharded_nlml_value_and_grad, make_sharded_tri_solves)
from mfgp_tpu_torch.parallel.chol import fit_memory_scaled, panel_width
