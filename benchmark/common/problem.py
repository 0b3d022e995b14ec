"""The unit's problem: a frozen copy of ``bench.py``'s ``build_problem`` and
``_theta`` (the JAX-era benchmark script at the root of the repository,
``bench.py:58-82``), kept here so that the benchmark's inputs cannot move
when that file does. Only the imports differ. Nothing here imports the
program under test.
"""

from __future__ import annotations

import numpy as np

N_TRAIN = 20_000
M_GRID = 10_571
D_IN = 3
N_FID = 3


def build_problem(N=N_TRAIN, M=M_GRID, D=D_IN, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lo = np.zeros(D)
    hi = np.array([60.0, 110.0, 4.5][:D])
    X = (lo + (hi - lo) * rng.random((N, D))).astype(dtype)
    centers = lo + (hi - lo) * rng.random((4, D))
    y = np.zeros(N)
    for c in centers:
        y += 30.0 * np.exp(-0.004 * np.sum((X - c) ** 2, axis=1))
    y = (y + 0.1 * rng.standard_normal(N)).astype(dtype)
    fid = rng.integers(0, N_FID, N).astype(np.int32)
    grid = (lo + (hi - lo) * rng.random((M, D))).astype(dtype)
    grid_fid = np.full((M,), N_FID - 1, np.int32)
    return X, fid, y, grid, grid_fid


def _theta(D=D_IN, dtype=np.float64):
    """Plausible mid-optimization hyperparameters (fixed for the bench)."""
    variances = np.array([25.0, 10.0, 5.0], dtype)
    lengthscales = np.tile(np.array([[12.0, 20.0, 1.5]], dtype), (N_FID, 1))
    rhos = np.ones(N_FID - 1, dtype)
    noises = np.array([0.5, 0.2, 0.1], dtype)
    return variances, lengthscales, rhos, noises
