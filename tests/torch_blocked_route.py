"""The NLML and its analytic gradient by the blocked route, composed from
the port's parts: the reference that the tests hold the port's one route
(the inverse factor and B2) against. Imported by the CPU tests and by the
card tests, which run without the conftest."""

import math

import torch

from mfgp_tpu_torch.models import mfgp as tm
from mfgp_tpu_torch.ops import covariance as tcov
from mfgp_tpu_torch.ops import cuda_kernels as ck
from mfgp_tpu_torch.ops import linalg as tla


def blocked_evaluation(p: tm.MFGPParams, X, fid, y, kernel: str,
                       jitter=0.0):
    """(value, MFGPParams of gradients, the rhos' zero): alpha by two
    triangular solves, K^-1 by blocked solves on the identity, the
    trace-identity contractions on K^-1."""
    v, ls, rhos, nz = p.variances, p.lengthscales, p.rhos, p.noises
    L = tla.chol(tcov.mf_train_cov(v, ls, rhos, nz, X, fid, jitter, kernel))
    alpha = tla.solve_posterior(L, y)
    Kinv = tla.chol_solve_blocked(
        L, torch.eye(X.shape[0], dtype=X.dtype, device=X.device))
    gv, gl, gn = ck.grad_from_kinv(Kinv, alpha, X, fid, v, ls, rhos, nz,
                                   kernel)
    val = (0.5 * torch.dot(y, alpha) + 0.5 * tla.logdet_from_chol(L)
           + 0.5 * X.shape[0] * math.log(2.0 * math.pi))
    return val, tm.MFGPParams(gv, gl, torch.zeros_like(rhos), gn)
