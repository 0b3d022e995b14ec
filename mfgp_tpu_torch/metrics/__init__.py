"""Coverage and information metrics of the port (counterpart of
``mfgp_tpu/metrics``): the ergodic KL and Fourier metrics, the EID, the
closed-form information gains, and the error metrics of ``ops.linalg``."""

from mfgp_tpu_torch.metrics.ergodic import (  # noqa: F401
    softmax, config_grid, gaussian_sensor, trajectory_distribution,
    kl_divergence, combined_trajectory_distribution,
)
from mfgp_tpu_torch.metrics.fourier import (  # noqa: F401
    config_k, basis_norms, sobolev_weights, fourier_basis,
    fourier_coefficients, merge_coefficients, sobolev_norm,
)
from mfgp_tpu_torch.metrics.eid import (  # noqa: F401
    expected_information_density, eid_grid,
)
from mfgp_tpu_torch.metrics.info_gain import (  # noqa: F401
    sequential_gain_from_cov, sequential_gain_cross, batch_logdet_gain,
)
from mfgp_tpu_torch.ops.linalg import rmse, weighted_mse  # noqa: F401
