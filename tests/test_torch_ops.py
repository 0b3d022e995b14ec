"""Parity of the PyTorch port's ops (``mfgp_tpu_torch.ops``: kernels,
linalg, covariance) with the JAX package's, on the CPU in float64.

Both packages get the same numpy arrays (made from a seed) and evaluate the
same mathematics in the same precision, so they agree to rtol 1e-7 /
atol 1e-9. Sizes are small and ragged (not multiples of any block size).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.ops import covariance as jcov
from mfgp_tpu.ops import kernels as jk
from mfgp_tpu.ops import linalg as jla
from mfgp_tpu_torch.ops import covariance as tcov
from mfgp_tpu_torch.ops import kernels as tk
from mfgp_tpu_torch.ops import linalg as tla

RTOL, ATOL = 1e-7, 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def both(*arrays):
    """Each numpy array as a (jax, torch) pair."""
    return [(jnp.asarray(a), torch.as_tensor(a)) for a in arrays]


@pytest.fixture
def spd(rng):
    """A well-conditioned SPD matrix (N=97) and its numpy pieces."""
    n = 97
    X = rng.normal(size=(n, 3))
    K = np.asarray(jk.rbf(jnp.asarray(X), jnp.asarray(X), 1.3,
                          jnp.asarray([0.9, 1.2, 0.7]))) + 0.1 * np.eye(n)
    return K, rng.normal(size=(n, 5)), rng.normal(size=n)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_base_kernels(rng, kernel):
    (X1j, X1t), (X2j, X2t), (lj, lt) = both(rng.normal(size=(37, 3)),
                                            rng.normal(size=(23, 3)),
                                            rng.uniform(0.5, 2.0, 3))
    close(tk.sqdist(X1t, X2t, 1.0 / lt), jk.sqdist(X1j, X2j, 1.0 / lj))
    close(tk.KERNELS[kernel](X1t, X2t, 1.7, lt),
          jk.KERNELS[kernel](X1j, X2j, 1.7, lj))
    # scalar lengthscale broadcast to every dimension
    close(tk.KERNELS[kernel](X1t, X1t, 0.6, 1.3),
          jk.KERNELS[kernel](X1j, X1j, 0.6, 1.3))


@pytest.mark.parametrize("rhos", [[0.9, 0.7], [0.0, 1.3], [0.0, 0.0]])
def test_ar1_fidelity_weights(rhos):
    """Row-by-row weights: finite and equal to JAX's even at rho = 0."""
    W = tk.ar1_fidelity_weights(torch.as_tensor(rhos, dtype=torch.float64),
                                3)
    assert torch.isfinite(W).all()
    close(W, jk.ar1_fidelity_weights(jnp.asarray(rhos), 3))


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
def test_ar1_cov(rng, kernel, F):
    N, M, D = 41, 29, 3
    arrays = (rng.normal(size=(N, D)), rng.integers(0, F, N),
              rng.normal(size=(M, D)), rng.integers(0, F, M),
              rng.uniform(0.5, 2.0, F), rng.uniform(0.5, 2.0, (F, D)),
              rng.uniform(0.7, 1.2, F - 1))
    j, t = zip(*both(*arrays))
    close(tk.ar1_cov(*t, kernel=kernel), jk.ar1_cov(*j, kernel=kernel))


def test_cholesky_and_solves(spd):
    K, B, y = spd
    (Kj, Kt), (Bj, Bt), (yj, yt) = both(K, B, y)
    Lj, Lt = jla.chol(Kj), tla.chol(Kt)
    close(Lt, Lj)
    close(tla.tri_solve(Lt, Bt), jla.tri_solve(Lj, Bj))
    close(tla.tri_solve(Lt.T, yt, lower=False),
          jla.tri_solve(Lj.T, yj, lower=False))
    close(tla.chol_solve(Lt, Bt), jla.chol_solve(Lj, Bj))
    close(tla.solve_posterior(Lt, yt), jla.solve_posterior(Lj, yj))
    close(tla.logdet_from_chol(Lt), jla.logdet_from_chol(Lj))
    d = np.linspace(0.1, 1.0, K.shape[0])
    close(tla.diag_add(Kt, torch.as_tensor(d)),
          jla.diag_add(Kj, jnp.asarray(d)))


def test_chol_not_positive_definite(spd):
    """A matrix that is not positive definite: JAX's chol gives NaN in the
    lower triangle and zeros above it, without an exception; so does the
    port's, per matrix of a batch."""
    bad = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    (bj, bt), = both(bad)
    ref = np.asarray(jla.chol(bj))
    got = tla.chol(bt).numpy()
    assert np.isnan(ref[np.tril_indices(3)]).all()
    assert not np.triu(ref, 1).any()
    np.testing.assert_array_equal(got, ref)  # NaN == NaN here
    good = spd[0][:3, :3]
    (Sj, St), = both(np.stack([good, bad]))
    got, ref = tla.chol(St).numpy(), np.asarray(jla.chol(Sj))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)


def test_chol_gradient(spd):
    """chol stays differentiable: its autograd gradient equals JAX's."""
    import jax

    K = spd[0][:20, :20]
    W = np.tril(np.random.default_rng(3).normal(size=K.shape))
    Kt = torch.as_tensor(K).requires_grad_(True)
    got, = torch.autograd.grad(torch.sum(tla.chol(Kt) * torch.as_tensor(W)),
                               Kt)
    ref = jax.grad(lambda a: jnp.sum(jla.chol(a) * W))(jnp.asarray(K))
    # JAX's cholesky VJP symmetrises its cotangent, torch's does not:
    # compare the gradients as functions of a symmetric input
    close(got + got.T, ref + ref.T)


def test_chol_append_block(spd):
    K = spd[0]
    n = 80
    (Lj, Lt), (Bj, Bt), (Cj, Ct) = both(np.linalg.cholesky(K[:n, :n]),
                                        K[:n, n:], K[n:, n:])
    got = tla.chol_append_block(Lt, Bt, Ct)
    close(got, jla.chol_append_block(Lj, Bj, Cj))
    close(got, np.linalg.cholesky(K))


@pytest.mark.parametrize("block", [16, 40])
def test_blocked_solves(spd, block):
    K, B, y = spd
    (Kj, Kt), (Bj, Bt), (yj, yt) = both(K, B, y)
    Lj, Lt = jla.chol(Kj), tla.chol(Kt)
    close(tla.tri_solve_blocked(Lt, Bt, block),
          jla.tri_solve_blocked(Lj, Bj, block))
    close(tla.tri_solve_blocked(Lt, yt, block),
          jla.tri_solve_blocked(Lj, yj, block))
    close(tla.chol_solve_blocked(Lt, Bt, block),
          jla.chol_solve_blocked(Lj, Bj, block))


@pytest.mark.parametrize("base", [16, 128])
def test_tri_inv_recursive(spd, base):
    K = spd[0]
    (Kj, Kt), = both(K)
    Linv = tla.tri_inv_recursive(tla.chol(Kt), base=base)
    assert Linv.is_contiguous()
    close(Linv, jla.tri_inv_recursive(jla.chol(Kj), base=base))


@pytest.mark.parametrize("block", [16, 200])
def test_triangular_products(spd, rng, block):
    K, B, _ = spd
    (Kj, Kt), (Bj, Bt), (Cj, Ct) = both(K, B, rng.normal(size=(7, 97)))
    Lj, Lt = jla.chol(Kj), tla.chol(Kt)
    close(tla.tri_lower_matmul(Lt, Bt, block=block),
          jla.tri_lower_matmul(Lj, Bj, block=block))
    close(tla.tri_lower_matmul_right(Ct, Lt, block=block),
          jla.tri_lower_matmul_right(Cj, Lj, block=block))
    close(tla.syrk_tri_lower(Lt, block=block),
          jla.syrk_tri_lower(Lj, block=block))


@pytest.mark.parametrize("blocked", [False, True])
def test_posterior_helpers(spd, rng, monkeypatch, blocked):
    K, _, y = spd
    n = K.shape[0]
    Kxs = rng.normal(size=(13, n)) * 0.3
    Kss = np.eye(13) * 2.0
    (Kj, Kt), (Xj, Xt), (Sj, St), (yj, yt) = both(K, Kxs, Kss, y)
    Lj, Lt = jla.chol(Kj), tla.chol(Kt)
    if blocked:  # route posterior_cov through the blocked solve
        monkeypatch.setattr(jla, "_BLOCK_SOLVE_ELEMS", 1)
        monkeypatch.setattr(tla, "_BLOCK_SOLVE_ELEMS", 1)
    close(tla.posterior_cov(St, Xt, Lt), jla.posterior_cov(Sj, Xj, Lj))
    close(tla.posterior_var(torch.diagonal(St), Xt, Lt),
          jla.posterior_var(jnp.diagonal(Sj), Xj, Lj))
    close(tla.posterior_mean(Xt, yt), jla.posterior_mean(Xj, yj))


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_covariance_forward(rng, kernel):
    """ops.covariance on the CPU: the plain compositions, equal to JAX's."""
    N, M, D, F = 33, 19, 3, 3
    arrays = (rng.uniform(0.5, 2.0, F), rng.uniform(0.5, 2.0, (F, D)),
              rng.uniform(0.7, 1.2, F - 1), rng.uniform(0.01, 0.1, F),
              rng.normal(size=(N, D)), rng.integers(0, F, N),
              rng.normal(size=(M, D)), rng.integers(0, F, M))
    (vj, vt), (lj, lt), (rj, rt), (nj, nt), (Xj, Xt), (fj, ft), \
        (Yj, Yt), (gj, gt) = both(*arrays)
    close(tcov.mf_train_cov(vt, lt, rt, nt, Xt, ft, 1e-6, kernel),
          jcov.mf_train_cov(vj, lj, rj, nj, Xj, fj, 1e-6, kernel))
    close(tcov.mf_cross_cov(vt, lt, rt, Xt, ft, Yt, gt, kernel),
          jcov.mf_cross_cov(vj, lj, rj, Xj, fj, Yj, gj, kernel))
    close(tcov.sf_train_cov(1.7, lt[0], 0.05, Xt, kernel),
          jcov.sf_train_cov(1.7, lj[0], 0.05, Xj, kernel))
    close(tcov.sf_cross_cov(1.7, lt[0], Xt, Yt, kernel),
          jcov.sf_cross_cov(1.7, lj[0], Xj, Yj, kernel))


def test_cuda_gate_on_cpu():
    """The kernels' gate needs a CUDA tensor, float32 and rbf/matern32."""
    x32 = torch.zeros(4, 3, dtype=torch.float32)
    for kernel in ("rbf", "matern32", "cosine"):
        assert not tcov.use_cuda_kernels(x32, kernel)
        assert not tcov.use_cuda_kernels(x32.double(), kernel)


def test_port_imports_without_jax_or_triton():
    """The port never imports jax (nor triton): checked in a fresh
    interpreter that imports every module of the package."""
    code = (
        "import sys\n"
        "import mfgp_tpu_torch\n"
        "from mfgp_tpu_torch.models import gp, mfgp\n"
        "from mfgp_tpu_torch.ops import build, covariance, cuda_kernels, "
        "kernels, linalg, optimize\n"
        "bad = [m for m in ('jax', 'triton', 'mfgp_tpu') if m in "
        "sys.modules]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
