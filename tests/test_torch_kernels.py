"""The port's three kernels (``mfgp_tpu_torch.ops.cuda_kernels``).

On the CPU each wrapper takes its plain PyTorch version; those are held
against the JAX Pallas kernels run in interpret mode (as
tests/test_pallas_kernels.py runs them), in float32, at the JAX tests' own
tolerances: 1e-5 for the covariance (B1), 2e-3 for the fused gradient
sums (B2), 2e-5 for the fused posterior (B3). The CUDA kernels themselves
are compared with their plain versions on the card by
tests/test_torch_cuda.py (``cuda``-marked, skipped where there is no card)
and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from mfgp_tpu.ops import pallas_kernels as pk
from mfgp_tpu_torch.ops import build
from mfgp_tpu_torch.ops import cuda_kernels as ck
from mfgp_tpu_torch.ops import kernels as tk

F32 = np.float32


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _cov_problem(rng, F, N=300, M=270, D=3):
    """B1 inputs, deliberately not multiples of any tile size."""
    return (rng.normal(size=(N, D)).astype(F32), rng.integers(0, F, N),
            rng.normal(size=(M, D)).astype(F32), rng.integers(0, F, M),
            np.array([2.0, 1.5, 0.7][:F], F32),
            rng.uniform(0.5, 2.0, (F, D)).astype(F32),
            np.array([1.1, 0.9][:F - 1], F32))


def _grad_problem(rng, F, N=180, D=3):
    """B2 inputs: Linv and alpha of a conditioned AR1 problem (float64
    factorization, handed to both packages as float32)."""
    X = rng.normal(size=(N, D))
    fid = rng.integers(0, F, N)
    y = rng.normal(size=N)
    var = np.array([1.4, 0.8, 0.6][:F])
    ls = rng.uniform(0.7, 1.8, (F, D))
    rho = np.array([0.9, 0.8][:F - 1])
    noise = np.array([0.05, 0.02, 0.03][:F])
    K = tk.ar1_cov(*_t(X, fid, X, fid, var, ls, rho)).numpy()
    L = np.linalg.cholesky(K + np.diag(noise[fid] + 1e-6))
    Linv = sla.solve_triangular(L, np.eye(N), lower=True)
    alpha = sla.cho_solve((L, True), y)
    return tuple(a.astype(F32) if a.dtype.kind == "f" else a
                 for a in (Linv, alpha, X, fid, var, ls, rho, noise))


def _post_problem(rng, N, M, F, D=3):
    """B3 inputs as tests/test_pallas_kernels.py builds them."""
    return (np.tril(rng.random((N, N))).astype(F32),
            rng.random(N).astype(F32),
            (rng.random((N, D)) * 5).astype(F32), rng.integers(0, F, N),
            (rng.random((M, D)) * 5).astype(F32), np.full(M, F - 1),
            np.array([1.5, 1.0, 0.5][:F], F32),
            rng.uniform(0.5, 2.0, (F, D)).astype(F32),
            np.array([0.9, 0.8][:F - 1], F32))


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("noise", [False, True])
def test_ar1_cov_plain_matches_pallas(rng, kernel, F, noise):
    X1, f1, X2, f2, var, ls, rho = _cov_problem(rng, F)
    if noise:  # the training Gram with its noise diagonal
        X2, f2 = X1, f1
        nz = rng.uniform(0.1, 0.5, X1.shape[0]).astype(F32)
    ref = pk.ar1_cov_fused(X1, jnp.asarray(f1, jnp.int32), X2,
                           jnp.asarray(f2, jnp.int32), var, ls, rho,
                           noise_diag=nz if noise else None,
                           interpret=True, kern=kernel)
    got = ck.ar1_cov_fused(*_t(X1, f1, X2, f2, var, ls, rho),
                           noise_diag=torch.as_tensor(nz) if noise else None,
                           kern=kernel)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
def test_ar1_cov_split_plain_matches_pallas(rng, kernel, F):
    """B3's staged operand: the TF32 planes of K(grid, train), whose sum is
    the Pallas covariance to float32 accuracy."""
    Xs, fs, X, fid, var, ls, rho = _cov_problem(rng, F)
    ref = pk.ar1_cov_fused(Xs, jnp.asarray(fs, jnp.int32), X,
                           jnp.asarray(fid, jnp.int32), var, ls, rho,
                           interpret=True, kern=kernel)
    hi, lo = ck.ar1_cov_split(*_t(Xs, fs, X, fid, var, ls, rho), kern=kernel)
    for plane in (hi, lo):
        assert plane.dtype == torch.float32
        assert not (plane.numpy().view(np.uint32) & 0x1FFF).any()
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(),
                               np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_rbf_cov_plain_matches_pallas(rng, kernel):
    X1, _, X2, _, _, _, _ = _cov_problem(rng, 1)
    ls = np.array([1.0, 2.0, 0.5], F32)
    ref = pk.rbf_cov_fused(X1, X2, 1.7, ls, interpret=True, kern=kernel)
    got = ck.rbf_cov_fused(*_t(X1, X2), 1.7, torch.as_tensor(ls),
                           kern=kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
def test_syrk_grad_plain_matches_pallas(rng, kernel, F):
    Linv, alpha, X, fid, var, ls, rho, noise = _grad_problem(rng, F)
    ref = pk.syrk_grad_fused(Linv, alpha, X, jnp.asarray(fid, jnp.int32),
                             var, ls, rho, noise, interpret=True, tile=128,
                             kern=kernel)
    got = ck.syrk_grad_fused(*_t(Linv, alpha, X, fid, var, ls, rho, noise),
                             kern=kernel)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("shape", [(96, 48, 3), (70, 33, 1)])
def test_posterior_plain_matches_pallas(rng, kernel, shape):
    Linv, alpha, X, fid, Xs, fs, var, ls, rho = _post_problem(rng, *shape)
    ref = pk.posterior_fused(Linv, alpha, X, jnp.asarray(fid, jnp.int32),
                             Xs, jnp.asarray(fs, jnp.int32), var, ls, rho,
                             interpret=True, kern=kernel, tile_n=32,
                             tile_g=16)
    got = ck.posterior_fused(*_t(Linv, alpha, X, fid, Xs, fs, var, ls, rho),
                             kern=kernel)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


def test_wrappers_take_plain_version_on_cpu(rng):
    """A CPU tensor goes to the plain version: same result, no launch."""
    ck.reset_launches()
    X1, f1, X2, f2, var, ls, rho = _t(*_cov_problem(rng, 3, N=40, M=30))
    assert torch.equal(ck.ar1_cov_fused(X1, f1, X2, f2, var, ls, rho),
                       ck.ar1_cov_fused_plain(X1, f1, X2, f2, var, ls, rho))
    for a, b in zip(ck.ar1_cov_split(X1, f1, X2, f2, var, ls, rho),
                    ck.ar1_cov_split_plain(X1, f1, X2, f2, var, ls, rho)):
        assert torch.equal(a, b)
    g = _t(*_grad_problem(rng, 2, N=50))
    for a, b in zip(ck.syrk_grad_fused(*g), ck.syrk_grad_fused_plain(*g)):
        assert torch.equal(a, b)
    p = _t(*_post_problem(rng, 40, 20, 2))
    for a, b in zip(ck.posterior_fused(*p), ck.posterior_fused_plain(*p)):
        assert torch.equal(a, b)
    assert ck.LAUNCHES == {name: 0 for name in ck.LAUNCHES}


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes build() raise and leaves no library."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kb")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert not list((tmp_path / "kb").rglob(build.LIB_NAME))
