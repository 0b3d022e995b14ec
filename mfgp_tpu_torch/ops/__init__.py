"""Covariance kernels, linear algebra and the hand-written CUDA kernels.

Precision policy: every float32 product in the port runs in IEEE fp32. The
distance cross term of a covariance cancels (r2 = |a|^2 + |b|^2 - 2 a.b),
and TF32's ~3 decimal digits turn that into visible covariance error, so
TF32 is switched off for cuBLAS matmuls and for cuDNN here, once, for every
module of the port (all of them import this package).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
