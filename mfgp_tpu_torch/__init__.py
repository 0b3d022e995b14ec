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

Importing the package loads nothing heavy: submodules import ``torch`` on
first use, and CUDA code is built only when a kernel is first launched on a
CUDA tensor. Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
