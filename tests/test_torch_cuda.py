"""The port's CUDA kernels on the card, each against its plain PyTorch
version (float64 evaluation of the same float32 inputs where the plain
float32 version would carry its own rounding), at small ragged shapes.

Every test here is ``cuda``-marked and skips where there is no CUDA
device. The file imports neither jax nor the JAX package, so on a machine
with a card and no jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.models import mfgp as tm
from mfgp_tpu_torch.ops import covariance as tcov
from mfgp_tpu_torch.ops import cuda_kernels as ck
from mfgp_tpu_torch.ops import linalg as tla

pytestmark = pytest.mark.cuda
KERNELS = ["rbf", "matern32"]


@pytest.fixture
def dev():
    """The CUDA device, or a skip where there is none (decided at run
    time, never at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _t(dev, *arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else None,
                            device=dev) for a in arrays]


def _f64(*tensors):
    return [t.double() if t.is_floating_point() else t for t in tensors]


def test_gate(dev):
    x = torch.zeros(4, 3, dtype=torch.float32, device=dev)
    assert tcov.use_cuda_kernels(x, "rbf")
    assert tcov.use_cuda_kernels(x, "matern32")
    assert not tcov.use_cuda_kernels(x, "cosine")
    assert not tcov.use_cuda_kernels(x.double(), "rbf")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("noise", [False, True])
def test_ar1_cov_fused(dev, gen, kernel, noise):
    N, M, D, F = 301, 157, 3, 3  # ragged against the 32-wide tile
    X1, X2 = gen.normal(size=(N, D)), gen.normal(size=(M, D))
    f1, f2 = gen.integers(0, F, N), gen.integers(0, F, M)
    if noise:
        X2, f2 = X1, f1
    args = _t(dev, X1, f1, X2, f2, np.array([2.0, 1.5, 0.7]),
              gen.uniform(0.5, 2.0, (F, D)), np.array([1.1, 0.9]))
    nz = (torch.as_tensor(gen.uniform(0.1, 0.5, N), dtype=torch.float32,
                          device=dev) if noise else None)
    got = ck.ar1_cov_fused(*args, noise_diag=nz, kern=kernel)
    ref = ck.ar1_cov_fused_plain(*_f64(*args), noise_diag=None if nz is None
                                 else nz.double(), kern=kernel)
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("F", [1, 3])
def test_syrk_grad_fused(dev, gen, kernel, F):
    N, D = 333, 3
    X = gen.random((N, D)) * 4
    fid = gen.integers(0, F, N)
    raw = (np.log([1.4, 0.9, 0.6][:F]), np.log(gen.uniform(0.8, 1.8, (F, D))),
           np.array([0.9, 0.8][:F - 1]), np.log([0.05, 0.03, 0.02][:F]))
    p = tm.params_from_numpy(*raw, dev, torch.float64)
    Xd, fd, yd = _t(dev, X, fid, gen.normal(size=N), dtype=torch.float64)
    _, _, st = tm.nlml_value_grad_state_inv(p, Xd, fd, yd, kernel=kernel,
                                            jitter=1e-6)
    args = (st.Linv.float().contiguous(), st.alpha.float(), Xd.float(), fd,
            p.variances.float(), p.lengthscales.float(), p.rhos.float(),
            p.noises.float())
    got = ck.syrk_grad_fused(*args, kern=kernel)
    ref = ck.syrk_grad_fused_plain(*_f64(*args), kern=kernel)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.double(), r, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kernel", KERNELS)
def test_posterior_fused(dev, gen, kernel):
    N, M, D, F = 300, 130, 3, 3
    args = _t(dev, np.tril(gen.random((N, N))), gen.random(N),
              gen.random((N, D)) * 5, gen.integers(0, F, N),
              gen.random((M, D)) * 5, np.full(M, F - 1),
              np.array([1.5, 1.0, 0.5]), gen.uniform(0.5, 2.0, (F, D)),
              np.array([0.9, 0.8]))
    got = ck.posterior_fused(*args, kern=kernel)
    ref = ck.posterior_fused_plain(*_f64(*args), kern=kernel)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.double(), r, rtol=2e-5, atol=2e-5)


def _grad_args(dev, gen, kernel, N, F):
    """float32 Linv/alpha (conditioned in float64) and parameters of an
    F-fidelity AR1 problem at N points."""
    D = 3
    X = gen.random((N, D)) * 4
    fid = gen.integers(0, F, N)
    raw = (np.log([1.4, 0.9, 0.6][:F]), np.log(gen.uniform(0.8, 1.8, (F, D))),
           np.array([0.9, 0.8][:F - 1]), np.log([0.05, 0.03, 0.02][:F]))
    p = tm.params_from_numpy(*raw, dev, torch.float64)
    Xd, fd, yd = _t(dev, X, fid, gen.normal(size=N), dtype=torch.float64)
    _, _, st = tm.nlml_value_grad_state_inv(p, Xd, fd, yd, kernel=kernel,
                                            jitter=1e-6)
    return (st.Linv.float().contiguous(), st.alpha.float(), Xd.float(), fd,
            p.variances.float(), p.lengthscales.float(), p.rhos.float(),
            p.noises.float())


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("N,F", [(50, 1), (50, 3), (200, 1), (1031, 3)])
def test_syrk_grad_fused_ragged(dev, gen, kernel, N, F):
    """Shapes ragged against B2's 128-wide tiles and 32-deep stages, N
    below one tile included."""
    args = _grad_args(dev, gen, kernel, N, F)
    got = ck.syrk_grad_fused(*args, kern=kernel)
    ref = ck.syrk_grad_fused_plain(*_f64(*args), kern=kernel)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.double(), r, rtol=2e-3, atol=2e-3)


def test_syrk_grad_fused_g_logvar_normwise_n4096(dev):
    """The rbf g_logvar sums ~N^2 entries of W o T that cancel, so a bias
    in the tensor-core K^-1 shows there first: normwise within 1e-4 of
    the float64 path at N = 4096 (bench's problem and hyperparameters)."""
    from bench import _theta, build_problem

    X, fid, y, _, _ = build_problem(4096, 16, seed=1)
    v, ls, rho, nz = _theta()
    p = tm.params_from_numpy(np.log(v), np.log(ls), rho, np.log(nz), dev,
                             torch.float64)
    Xd, fd, yd = _t(dev, X, fid, y, dtype=torch.float64)
    _, _, st = tm.nlml_value_grad_state_inv(p, Xd, fd, yd, kernel="rbf",
                                            jitter=1e-6)
    args = (st.Linv.float().contiguous(), st.alpha.float(), Xd.float(), fd,
            p.variances.float(), p.lengthscales.float(), p.rhos.float(),
            p.noises.float())
    got = ck.syrk_grad_fused(*args, kern="rbf")
    ref = ck.syrk_grad_fused_plain(*_f64(*args), kern="rbf")
    err = float((got[0].double() - ref[0]).abs().max() / ref[0].abs().max())
    assert err <= 1e-4, err


def test_syrk_grad_fused_repeats(dev):
    """B2's sums past each thread's own products are float64, so the order
    of its atomics no longer moves the gradient: 20 runs on chip_smoke's
    N=333, F=3 rbf problem agree to 1e-6 of each field's largest entry,
    and every run is within the 2e-3 bar (float32 in-block sums gave a
    small entry a run-to-run std of 1.2e-3 there)."""
    from bench import _theta, build_problem

    N, F = 333, 3
    X, fid, y, _, _ = build_problem(N, 16, seed=1)
    v, ls, rho, nz = _theta()
    p = tm.params_from_numpy(np.log(v), np.log(ls), rho, np.log(nz), dev,
                             torch.float64)
    Xd, fd, yd = _t(dev, X, fid % F, y, dtype=torch.float64)
    _, _, st = tm.nlml_value_grad_state_inv(p, Xd, fd, yd, jitter=1e-6)
    args = (st.Linv.float().contiguous(), st.alpha.float(), Xd.float(), fd,
            p.variances.float(), p.lengthscales.float(), p.rhos.float(),
            p.noises.float())
    ref = ck.syrk_grad_fused_plain(*_f64(*args))
    runs = [ck.syrk_grad_fused(*args) for _ in range(20)]
    for i, r in enumerate(ref):
        got = torch.stack([g[i].double() for g in runs])
        spread = float((got.max(0).values - got.min(0).values).max())
        assert spread <= 1e-6 * float(r.abs().max()), (i, spread)
        for g in got:
            torch.testing.assert_close(g, r, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("N,M,F", [(50, 1, 1), (50, 130, 3), (333, 1, 3),
                                   (1031, 130, 1)])
def test_posterior_fused_ragged(dev, gen, kernel, N, M, F):
    """Shapes ragged against B3's 128-wide tiles: N below one tile, one
    grid point, 130 grid points."""
    args = _t(dev, np.tril(gen.random((N, N))), gen.random(N),
              gen.random((N, 3)) * 5, gen.integers(0, F, N),
              gen.random((M, 3)) * 5, np.full(M, F - 1),
              np.array([1.5, 1.0, 0.5][:F]), gen.uniform(0.5, 2.0, (F, 3)),
              np.array([0.9, 0.8][:F - 1]))
    got = ck.posterior_fused(*args, kern=kernel)
    ref = ck.posterior_fused_plain(*_f64(*args), kern=kernel)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.double(), r, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("transpose", [False, True])
def test_tf32_split_matches_plain(dev, gen, transpose):
    x = gen.standard_normal((333, 1031)) * 10.0 ** gen.integers(-30, 30,
                                                                (333, 1031))
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    hi, lo = ck.tf32_split(x, transpose=transpose)
    rhi, rlo = ck.tf32_split_plain(x.cpu(), transpose=transpose)
    for got, ref in ((hi, rhi), (lo, rlo)):
        assert torch.equal(got.cpu().contiguous().view(torch.int32),
                           ref.contiguous().view(torch.int32))


@pytest.mark.parametrize("kernel", KERNELS)
def test_ar1_cov_split_matches_plain_split(dev, gen, kernel):
    """B1's TF32 planes (B3's staged S^T) are the plain split of B1's own
    output, bit for bit, at a shape ragged against the 32-wide tile."""
    M, N, D, F = 157, 301, 3, 3
    args = _t(dev, gen.normal(size=(M, D)), gen.integers(0, F, M),
              gen.normal(size=(N, D)), gen.integers(0, F, N),
              np.array([2.0, 1.5, 0.7]), gen.uniform(0.5, 2.0, (F, D)),
              np.array([1.1, 0.9]))
    hi, lo = ck.ar1_cov_split(*args, kern=kernel)
    rhi, rlo = ck.tf32_split_plain(ck.ar1_cov_fused(*args, kern=kernel).cpu())
    for got, ref in ((hi, rhi), (lo, rlo)):
        assert torch.equal(got.cpu().contiguous().view(torch.int32),
                           ref.contiguous().view(torch.int32))


@pytest.mark.parametrize("kernel", KERNELS)
def test_unit_slice_runs_through_the_kernels(dev, gen, kernel):
    """The unit at a small size in float32 on the card: every kernel is
    launched, and the result agrees with the float64 plain path."""
    N, M, D, F = 700, 90, 3, 3
    X, Xs = gen.random((N, D)) * 6, gen.random((M, D)) * 6
    fid, fs = gen.integers(0, F, N), np.full(M, F - 1)
    y = np.sin(X).sum(1) + 0.1 * gen.normal(size=N)
    raw = (np.log([1.4, 0.9, 0.6]), np.log(gen.uniform(0.8, 1.8, (F, D))),
           np.array([0.9, 0.8]), np.log([0.05, 0.03, 0.02]))
    out = {}
    for dt in (torch.float32, torch.float64):
        p = tm.params_from_numpy(*raw, dev, dt)
        Xt, ft, yt, Xst, fst = _t(dev, X, fid, y, Xs, fs, dtype=dt)
        ck.reset_launches()
        val, grad, st = tm.nlml_value_grad_state_inv(p, Xt, ft, yt,
                                                     kernel=kernel,
                                                     jitter=1e-6)
        mu, var = tm.predict_fused(p, st, Xst, fst, kernel=kernel)
        out[dt] = (val, grad, mu, var, dict(ck.LAUNCHES))
    v32, g32, mu32, var32, launched = out[torch.float32]
    v64, g64, mu64, var64, none = out[torch.float64]
    assert all(n > 0 for n in launched.values()), launched
    assert all(n == 0 for n in none.values()), none  # float64: plain path
    torch.testing.assert_close(v32.double(), v64, rtol=1e-4, atol=0)
    for a, b in zip(g32, g64):
        torch.testing.assert_close(a.double(), b, rtol=2e-3,
                                   atol=2e-3 * float(b.abs().max()))
    torch.testing.assert_close(mu32.double(), mu64, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(var32.double(), var64, rtol=1e-3, atol=1e-3)


def test_wrappers_raise_instead_of_falling_back(dev, gen):
    X = torch.as_tensor(gen.normal(size=(50, 3)), dtype=torch.float32,
                        device=dev)
    fid = torch.zeros(50, dtype=torch.long, device=dev)
    v = torch.ones(1, device=dev)
    ls = torch.ones(1, 3, device=dev)
    rho = v[:0]
    with pytest.raises(TypeError, match="float32"):
        ck.ar1_cov_fused(X.double(), fid, X.double(), fid, v, ls, rho)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ck.ar1_cov_fused(X, fid, X, fid, v, ls, rho, kern="cosine")
    with pytest.raises(ValueError, match="not contiguous"):
        ck.syrk_grad_fused(torch.eye(50, device=dev).T[:, :], v.new_ones(50),
                           X.T.contiguous().T, fid, v, ls, rho, v)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("N,F", [(50, 1), (333, 3), (1031, 1), (1031, 3)])
def test_ar1_train_cov_function_on_card(dev, gen, kernel, N, F):
    """The differentiable Gram on the card: forward through B1 (launched,
    never a fallback), closed-form backward, against float64 autograd of
    the plain composition for an asymmetric cotangent (max |err| / max
    |ref| <= 2e-3 per field)."""
    X, fid = gen.random((N, 3)) * 4, gen.integers(0, F, N)
    raw = (np.array([1.4, 0.9, 0.6][:F]), gen.uniform(0.8, 1.8, (F, 3)),
           np.array([0.9, 0.8][:F - 1]))
    Ct = gen.normal(size=(N, N))
    grads = {}
    for dt in (torch.float32, torch.float64):
        args = [torch.tensor(a, dtype=dt, device=dev, requires_grad=True)
                for a in raw]
        Xt, ft, Ctt = _t(dev, X, fid, Ct, dtype=dt)
        ck.reset_launches()
        K = tcov.ar1_cov_diff(*args, Xt, ft, kernel)
        launched = ck.LAUNCHES["ar1_cov_fused"]
        assert launched == (1 if dt == torch.float32 else 0)
        # at F=1 the (empty) rhos do not enter the plain graph
        grads[dt] = (K, torch.autograd.grad(K, args, Ctt,
                                            allow_unused=True,
                                            materialize_grads=True))
    (K32, g32), (K64, g64) = grads[torch.float32], grads[torch.float64]
    torch.testing.assert_close(K32.double(), K64, rtol=0, atol=1e-5)
    for a, b in zip(g32, g64):
        if b.numel():
            err = float((a.double() - b).abs().max() / b.abs().max())
            assert err <= 2e-3, err


def test_chol_nan_semantics_on_card(dev):
    """A matrix that is not positive definite gives NaN below and on the
    diagonal and zeros above, per batch entry, with no exception."""
    bad = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                       device=dev)
    L = tla.chol(torch.stack([torch.eye(3, device=dev) * 4.0, bad]))
    torch.cuda.synchronize()
    assert torch.equal(L[0], torch.eye(3, device=dev) * 2.0)
    low = torch.tril(torch.ones(3, 3, dtype=torch.bool, device=dev))
    assert torch.isnan(L[1][low]).all() and not L[1][~low].any()


def test_optimize_restarts_through_b1(dev, gen):
    """A two-iteration restart fit at N=1,000 in float32 on the card: B1
    carries every evaluation's Gram, every lane ends finite, and the NLML
    does not rise."""
    N, F = 1000, 3
    X = gen.random((N, 3)) * 6
    fid = gen.integers(0, F, N)
    y = np.sin(X).sum(1) + 0.1 * gen.normal(size=N)
    m = tm.MFGP(*_t(dev, X, fid, y), jitter=1e-6)
    m.params = tm.params_from_numpy(np.log([1.4, 0.9, 0.6]),
                                    np.log(np.full((F, 3), 1.5)),
                                    np.ones(F - 1), np.log([0.05, 0.03, 0.02]),
                                    dev, torch.float32)
    # lane 0 starts from the current params, so its first evaluation is
    # this one and its NLML can only fall
    f0 = float(tm.nlml_value_and_grad(m.params, m.X, m.fid, m.y,
                                      jitter=1e-6)[0])
    ck.reset_launches()
    f = m.optimize_restarts(n_restarts=2, maxiter=2, tol=1e-3)
    assert ck.LAUNCHES["ar1_cov_fused"] > 0
    assert np.isfinite(f) and f <= f0
    assert all(bool(torch.isfinite(p).all()) for p in m.params)
    mu, var = m.predict(_t(dev, gen.random((70, 3)) * 6)[0])
    assert bool(torch.isfinite(mu).all()) and bool((var > 0).all())


def test_gp_unit_through_b2(dev, gen):
    """The single-fidelity unit on the card: B1 assembles, B2 at F=1 takes
    the gradient from Linv; against the float64 plain path."""
    N = 700
    X = gen.random((N, 3)) * 6
    y = np.sin(X).sum(1) + 0.1 * gen.normal(size=N)
    raw = (np.log(1.3), np.log([1.0, 2.0, 0.7]), np.log(0.05))
    out = {}
    for dt in (torch.float32, torch.float64):
        p = tg.gp_params_from_numpy(*raw, dev, dt)
        Xt, yt = _t(dev, X, y, dtype=dt)
        ck.reset_launches()
        val, grad, st = tg.nlml_value_grad_state_inv(p, Xt, yt, jitter=1e-6)
        out[dt] = (val, grad, dict(ck.LAUNCHES))
    (v32, g32, launched), (v64, g64, _) = (out[torch.float32],
                                           out[torch.float64])
    assert launched["ar1_cov_fused"] > 0 and launched["syrk_grad_fused"] > 0
    torch.testing.assert_close(v32.double(), v64, rtol=1e-4, atol=0)
    for a, b in zip(g32, g64):
        torch.testing.assert_close(a.double(), b, rtol=2e-3,
                                   atol=2e-3 * float(b.abs().max()))
