"""mfgp_tpu_torch — the PyTorch / CUDA port of ``mfgp_tpu`` for one H100.

The JAX package ``mfgp_tpu`` stays the reference; this package mirrors its
module names so each function has an obvious counterpart:

ops.kernels       RBF / Matern32-ARD and the AR1 multi-fidelity covariance
ops.linalg        Cholesky, triangular solves/products, posterior helpers
ops.cuda_kernels  the three hand-written sm_90a kernels (the Pallas kernels'
                  counterparts) beside their plain PyTorch versions
ops.build         nvcc build + ctypes binding of ops/csrc/*.cu
ops.covariance    dispatch between the kernels and the plain composition;
                  the differentiable Gram (B1 forward, closed-form backward)
ops.optimize      scipy L-BFGS-B and the restart-batched L-BFGS
models.mfgp       the AR1 MFGP: NLML (autodiff and analytic gradient),
                  conditioning, grid posteriors, fits, the ``MFGP`` class
models.gp         the single-fidelity GP and its ``GP`` class
models.nigp       the input-noise GP: alternating and native fits, posteriors
models.mfgp_recursive  the recursive (per-level residual) multi-fidelity GP
fields.wrbf       the WRBF field, the random-field draw, FieldSettings files
estimation.kalman the Kalman steps and the batched trajectory filter
estimation.observers  rotation helpers and the glider body-velocity
                  observer (torch; capturable as a CUDA graph)
utils.configs     ``KFConfig`` / ``SimConfig`` / ``ExperimentConfig``;
                  utils.device: the device rule
metrics           the ergodic KL and Fourier metrics, the EID, the
                  closed-form information gains (a lane axis throughout)
planning.scoring  the six path costs, a batch's candidates as lanes of B1
planning.rig      the host RIG planner; planning.primitives its motion
                  primitives (both NumPy)
data.io           the reference's CSV / text artifacts (numpy only)
data.aggregate    ``MSE_*.txt`` files to ``results.csv`` and mean metrics
data.pipeline     trajectory -> KF estimates -> field measurements -> bins
data.trainers     fit {MFGP, SFGP, SFGP-TP, NIGP}, RMSE / WMSE, artifacts
data.study        the model-comparison study and the training-size study
hw                the robot layer: controllers, I/O, geo, trajectories,
                  xbee, the glider plant (NumPy copies), the AprilTag
                  fusion, and ``hw.runtime`` (the sense->estimate->control
                  loop, its observer step on the card)
sim.explore       ``ExplorationSim``: the closed loop (EID, replan, flight,
                  refit); sim.dynamics: RK4 and toy models
utils.checkpoint  npz checkpoints of a closed-loop run (the JAX package's
                  layout) and model restore
utils.profiling   the span recorder (stage spans, counters, observations;
                  on under a ``torch.profiler`` or ``enable()``) and
                  ``device_trace`` (Chrome trace + ``spans.json``)
parallel          multi-device on ``torch.distributed``: the (dp, mp) mesh,
                  mp-sharded posteriors and gradients, the distributed
                  Cholesky, dp-sharded restart fits, the sweep
serve             the model, planner, router and mission services over HTTP
viz               model replay from artifacts and the headless figures
native            ctypes binding of the repository's C++ CSV reader/writer
cli               ``python -m mfgp_tpu_torch.cli explore ...`` and the JAX
                  package's thirteen other commands

Everything that builds tensors takes ``device``: the card by default, an
error where there is no CUDA device, the CPU only when asked
(``device="cpu"``, ``--cpu``).

Importing the package loads nothing heavy: submodules import ``torch`` on
first use, and CUDA code is built only when a kernel is first launched on a
CUDA tensor. Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
