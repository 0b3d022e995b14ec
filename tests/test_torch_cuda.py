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
from torch_blocked_route import blocked_evaluation

from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.models import mfgp as tm
from mfgp_tpu_torch.ops import covariance as tcov
from mfgp_tpu_torch.ops import cuda_kernels as ck
from mfgp_tpu_torch.ops import linalg as tla
from mfgp_tpu_torch.utils import profiling

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


# (N, M, D, F) ragged against B1's 128-wide tiles and 4-wide runs: one
# point, odd M (no 16-byte stores), D of 1, 3, 5 (padded to 8) and 8, F of
# 1 to 5 (F > 3 takes the runtime loop over fidelities)
B1_SHAPES = [(301, 157, 3, 3), (1, 1, 1, 1), (33, 127, 8, 5),
             (129, 1537, 1, 2), (1537, 129, 3, 3), (127, 33, 5, 1),
             (1537, 1536, 3, 5)]


def _ar1_args(dev, gen, N, M, D, F, square=False):
    X1, X2 = gen.normal(size=(N, D)), gen.normal(size=(M, D))
    f1, f2 = gen.integers(0, F, N), gen.integers(0, F, M)
    if square:
        X2, f2 = X1.copy(), f1.copy()
    return _t(dev, X1, f1, X2, f2, gen.uniform(0.5, 2.0, F),
              gen.uniform(0.5, 2.0, (F, D)), gen.uniform(0.7, 1.2, F - 1))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("shape", B1_SHAPES)
def test_ar1_cov_fused(dev, gen, kernel, noise, shape):
    N, M, D, F = shape
    args = _ar1_args(dev, gen, N, M, D, F, square=noise)
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
@pytest.mark.parametrize("shape", [(157, 301, 3, 3), (1, 1, 1, 1),
                                   (129, 1537, 3, 3), (1537, 33, 8, 5)])
def test_ar1_cov_split_matches_plain_split(dev, gen, kernel, shape):
    """B1's TF32 planes (B3's staged S^T) are the plain split of B1's own
    output, bit for bit, at shapes ragged against the 128-wide tile."""
    M, N, D, F = shape
    args = _ar1_args(dev, gen, M, N, D, F)
    hi, lo = ck.ar1_cov_split(*args, kern=kernel)
    rhi, rlo = ck.tf32_split_plain(ck.ar1_cov_fused(*args, kern=kernel).cpu())
    for got, ref in ((hi, rhi), (lo, rlo)):
        assert torch.equal(got.cpu().contiguous().view(torch.int32),
                           ref.contiguous().view(torch.int32))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("N", [1, 31, 33, 1000, 1031])
def test_ar1_cov_symmetric_matches_general(dev, gen, kernel, noise, F, N):
    """The same tensors twice take the symmetric half grid; the same points
    as two distinct tensors force the full grid. Both agree bit for bit,
    and so does rbf_cov_fused at F=1."""
    X, fid, X2, fid2, v, ls, rho = _ar1_args(dev, gen, N, N, 3, F,
                                             square=True)
    nz = (torch.as_tensor(gen.uniform(0.1, 0.5, N), dtype=torch.float32,
                          device=dev) if noise else None)
    assert ck.same_points(X, fid, X, fid)
    assert not ck.same_points(X, fid, X2, fid2)
    sym = ck.ar1_cov_fused(X, fid, X, fid, v, ls, rho, nz, kernel)
    full = ck.ar1_cov_fused(X, fid, X2, fid2, v, ls, rho, nz, kernel)
    assert torch.equal(sym.view(torch.int32), full.view(torch.int32))
    if F == 1:
        sym = ck.rbf_cov_fused(X, X, v, ls, nz, kernel)
        full = ck.rbf_cov_fused(X, X2, v, ls, nz, kernel)
        assert torch.equal(sym.view(torch.int32), full.view(torch.int32))


def test_numpy_built_model_fits_on_the_card(dev, gen):
    """A model built from numpy float32 arrays with no device lands on the
    card, and its restart fit goes through B1."""
    N, F = 500, 3
    X = (gen.random((N, 3)) * 6).astype(np.float32)
    fid = gen.integers(0, F, N)
    y = (np.sin(X).sum(1) + 0.1 * gen.normal(size=N)).astype(np.float32)
    m = tm.MFGP(X, fid, y, jitter=1e-6)
    assert m.X.is_cuda and m.X.dtype == torch.float32
    g = tg.GP(X, y, jitter=1e-6)
    assert g.X.is_cuda
    before = ck.LAUNCHES["ar1_cov_fused"]
    f = m.optimize_restarts(n_restarts=2, maxiter=2, tol=1e-3)
    assert ck.LAUNCHES["ar1_cov_fused"] > before
    assert np.isfinite(f)


@pytest.mark.parametrize("kernel", KERNELS)
def test_unit_slice_runs_through_the_kernels(dev, gen, kernel):
    """The unit at a small size in float32 on the card: every kernel is
    launched (but ``tri_gemm``: at N = 700, under ``tri_inv_recursive``'s
    base of 1,024, Linv is one triangular solve), and the result agrees
    with the float64 plain path."""
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
    assert launched.pop("tri_gemm") == 0
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
    X9 = torch.zeros(50, 9, device=dev)
    with pytest.raises(ValueError, match="D=9"):
        ck.ar1_cov_fused(X9, fid, X9, fid, v, torch.ones(1, 9, device=dev),
                         rho)
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


def _evaluation_errors(v, g, v64, g64):
    """(|v - v64| / |v64|, max |g - g64| / max |g64|): the fit cell's
    ``nlml_rel`` and ``grad_rel`` (benchmark/generators/fit_eval.py)."""
    flat = [torch.cat([t.double().reshape(-1) for t in x]) for x in (g, g64)]
    return (abs(float(v) - float(v64)) / abs(float(v64)),
            float((flat[0] - flat[1]).abs().max() / flat[1].abs().max()))


@pytest.mark.parametrize("kernel", KERNELS)
def test_fit_evaluation_takes_linv_and_b2_on_the_card(dev, kernel):
    """``nlml_value_and_grad`` at N=4,096 in float32 takes the inverse
    factor and B2 (``mfgp.inv`` and one B2 launch, no ``mfgp.kinv``),
    within the fit cell's limits of the float64 evaluation (``nlml_rel``
    0.012, ``grad_rel`` 0.05), and no further from it than the blocked
    route at the same theta (``torch_blocked_route``)."""
    X, fid, y, _, _, p = _parallel_problem(dev, N=4096)
    profiling.enable()
    profiling.reset()
    try:
        ck.reset_launches()
        v, g = tm.nlml_value_and_grad(p, X, fid, y, kernel=kernel)
        spans = profiling.snapshot()["spans"]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert "mfgp.inv" in spans and "mfgp.kinv" not in spans
    assert ck.LAUNCHES["syrk_grad_fused"] == 1
    vb, gb = blocked_evaluation(p, X, fid, y, kernel)
    v64, g64 = tm.nlml_value_and_grad(tm.MFGPParams(*_f64(*p)),
                                      *_f64(X, fid, y), kernel=kernel)
    inv = _evaluation_errors(v, g, v64, g64)
    blocked = _evaluation_errors(vb, gb, v64, g64)
    assert inv[0] <= 0.012 and inv[1] <= 0.05, (inv, blocked)
    # both routes start from one float32 factor, whose rounding sets both
    # errors; their own last roundings may differ by float32's 2^-23
    assert all(a <= b + 2.0 ** -23 for a, b in zip(inv, blocked)), (
        inv, blocked)


def test_fit_evaluation_is_nan_where_the_gram_does_not_factor(dev):
    """A float32 Gram that is not positive definite (a near-constant
    kernel over 4,096 points with a 1e-9 noise) gives a NaN value and
    gradient on the inverse route, for the fits' ``penalize_nonfinite``,
    with no exception."""
    X, fid, y, _, _, p = _parallel_problem(dev, N=4096)
    p = p._replace(log_lengthscales=torch.full_like(p.log_lengthscales, 9.0),
                   log_noises=torch.full_like(p.log_noises, -20.7))
    v, g = tm.nlml_value_and_grad(p, X, fid, y)
    assert torch.isnan(v)
    assert all(bool(torch.isnan(t).any()) for t in (g.log_variances,
                                                    g.log_lengthscales,
                                                    g.log_noises))


# (M, N, K) of tri_gemm on the card: levels of inverses of n = 705 and
# 1,250, K at and off multiples of 128 and 32, one row or column tile
TRI_GEMM_SHAPES = [(353, 352, 352), (625, 625, 625), (300, 261, 288),
                   (261, 300, 256), (130, 1, 261), (1, 129, 129)]


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("tri", ["left", "right"])
@pytest.mark.parametrize("shape", TRI_GEMM_SHAPES)
def test_tri_gemm_matches_plain(dev, shape, tri, planes):
    """The triangular tile product on the 3xTF32 engine against its plain
    version in float64 on the same float32 inputs: float32-level, within
    four times the error of the plain version's own float32 (cuBLAS)
    products, written into a strided view or as the TF32 planes of the
    transpose."""
    M, N, K = shape
    g = torch.Generator().manual_seed(M * N + K)
    A, B = (torch.randn(r, K, generator=g) for r in (M, N))
    ref, = ck.tri_gemm_plain([A.double()], [B.double()], tri, alpha=-1.0,
                             out=[torch.empty(M, N, dtype=torch.float64)])
    f32, = ck.tri_gemm_plain([A.to(dev)], [B.to(dev)], tri, alpha=-1.0,
                             out=[torch.empty(M, N, device=dev)])
    f32 = f32.cpu()
    before = ck.LAUNCHES["tri_gemm"]
    if planes:
        hi, lo = ck.tri_gemm([A.to(dev)], [B.to(dev)], tri, alpha=-1.0)
        got = (hi.double() + lo.double()).T.cpu()
    else:
        big = torch.full((M + 1, N + 3), 7.0, device=dev)
        ck.tri_gemm([A.to(dev)], [B.to(dev)], tri, alpha=-1.0,
                    out=[big[1:, 2:N + 2]])
        torch.cuda.synchronize()
        got = big[1:, 2:N + 2].cpu()
        big[1:, 2:N + 2] = 7.0
        assert bool((big == 7.0).all())
    assert ck.LAUNCHES["tri_gemm"] == before + 1

    def normwise(x):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    assert normwise(got) <= max(4 * normwise(f32), 2.0 ** -22), (
        normwise(got), normwise(f32))


def _bench_factor(dev, N):
    """The float32 lower factor of the unit's rbf Gram at N points
    (bench.py's problem and hyperparameters) on the card."""
    from bench import _theta, build_problem

    X, fid, _, _, _ = build_problem(N, 1, seed=0)
    v, ls, rho, nz = _theta()
    X, fid = _t(dev, X, fid.astype(np.int64))
    K = tcov.mf_train_cov(*_t(dev, v, ls, rho, nz), X, fid, 0.0, "rbf")
    return tla.chol(K)


@pytest.mark.parametrize("N", [705, 1250, 3001, 5000, 20000])
def test_tri_inv_recursive_on_the_tensor_cores(dev, N):
    """Linv of the unit's float32 factor (at N = 3,001 the recursion's nodes
    and base cases come in two sizes per level): above ``base`` (1,024) by
    the tensor-core products, counted once per call under one
    ``linalg.tri_inv`` span; row-major contiguous, zero above the diagonal,
    and against the float64 inverse of the same factor no worse than twice
    the strips' error, with max |L Linv - I| no more than twice theirs."""
    L = _bench_factor(dev, N)
    L64 = L.double()
    eye = torch.eye(N, dtype=torch.float64, device=dev)
    ref = torch.linalg.solve_triangular(L64, eye, upper=False)
    profiling.enable()
    profiling.reset()
    try:
        Linv = tla.tri_inv_recursive(L)
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert snap["spans"]["linalg.tri_inv"]["calls"] == 1
    assert snap["counters"].get("linalg.tri_inv_tc", 0) == int(N > 1024)
    assert Linv.is_contiguous() and Linv.dtype == torch.float32
    assert bool((torch.triu(Linv, 1) == 0).all())
    strips = tla._tri_inv_strips(L, 1024)
    errs = {}
    for name, x in (("tc", Linv), ("strips", strips)):
        x = x.double()
        errs[name] = (float((x - ref).abs().max() / ref.abs().max()),
                      float((L64 @ x - eye).abs().max()))
    assert errs["tc"][0] <= 2 * errs["strips"][0] + 2.0 ** -22, errs
    assert errs["tc"][1] <= 2 * errs["strips"][1] + 2.0 ** -22, errs


def test_fit_evaluation_n20k_on_the_tensor_cores(dev):
    """The ``fit_eval_rbf`` cell's evaluation (N=20,000, its problem and
    hyperparameters) in float32: one ``linalg.tri_inv`` span with the
    tensor-core route counted once, within the cell's limits of its float64
    reference (``nlml_rel``, ``grad_rel``)."""
    import json
    from pathlib import Path

    from benchmark.common.problem import build_problem
    from benchmark.reference import gp as ref

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "benchmark/configs/mfgp_ar1_rbf_n20k.json")
                     .read_text())
    limits = json.loads((root / "benchmark/traffic/fit_eval_closed.json")
                        .read_text())["limits"]
    X, fid, y, _, _ = build_problem(cfg["N"], 1, cfg["D"], seed=3)
    X, y, fid = _t(dev, X, y, fid.astype(np.int64))
    th = {k: np.asarray(v, float) for k, v in cfg["theta"].items()}
    p = tm.params_from_numpy(np.log(th["variances"]),
                             np.log(th["lengthscales"]), th["rhos"],
                             np.log(th["noises"]), dev, torch.float32)
    profiling.enable()
    profiling.reset()
    try:
        v, g = tm.nlml_value_and_grad(p, X, fid, y, kernel="rbf",
                                      jitter=cfg["jitter"])
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert snap["spans"]["linalg.tri_inv"]["calls"] == 1
    assert snap["counters"]["linalg.tri_inv_tc"] == 1
    r = ref.nlml_grad(X, fid, y, th, "rbf", cfg["jitter"])
    g_ref = ref.grad_vector(r).double().cpu()
    got = torch.cat([g.log_variances, g.log_lengthscales.reshape(-1),
                     g.log_noises]).double().cpu()
    nlml_rel = abs(float(v) - float(r["value"])) / abs(float(r["value"]))
    grad_rel = float((got - g_ref).abs().max() / g_ref.abs().max())
    assert nlml_rel <= limits["nlml_rel"] and grad_rel <= limits["grad_rel"], (
        nlml_rel, grad_rel)


@pytest.mark.parametrize("model", ["gp", "nigp"])
def test_single_fidelity_inverse_paths_take_the_tensor_cores(dev, gen, model):
    """The other users of ``tri_inv_recursive`` on the card, above its
    base: the GP's (F=1) fit evaluation (against its float64 evaluation)
    and NIGP's cached inverse factor behind ``predict_blocked`` (against
    the float64 model's), each counting the tensor-core route once."""
    from mfgp_tpu_torch.models import nigp as tn

    N = 1500
    X = gen.uniform(0, 6, (N, 3))
    y = np.sin(X).sum(1) + 0.1 * gen.normal(size=N)
    Xs = gen.uniform(0, 6, (300, 3))
    out = {}
    for dt in (torch.float32, torch.float64):
        profiling.enable()
        profiling.reset()
        try:
            if model == "gp":
                p = tg.gp_params_from_numpy(np.log(1.3),
                                            np.log([1.0, 2.0, 0.7]),
                                            np.log(0.05), dev, dt)
                Xt, yt = _t(dev, X, y, dtype=dt)
                r = tg.nlml_value_and_grad(p, Xt, yt, jitter=1e-6)
                r = [r[0].reshape(1)] + list(r[1])
            else:
                m = tn.nigp_from_numpy(
                    np.log([1.0, 2.0, 0.7, 1.3, 0.2, 0.1, 0.15, 0.05]),
                    X, y, device=dev, dtype=dt)
                r = [torch.as_tensor(a) for a in
                     m.predict_blocked(Xs, block_size=128)]
            snap = profiling.snapshot()
        finally:
            profiling.enable(False)
            profiling.reset()
        out[dt] = ([t.double().reshape(-1).cpu() for t in r],
                   snap["counters"].get("linalg.tri_inv_tc", 0))
    (r32, tc32), (r64, tc64) = out[torch.float32], out[torch.float64]
    assert tc32 == 1 and tc64 == 0
    for a, b in zip(r32, r64):
        torch.testing.assert_close(a, b, rtol=2e-3,
                                   atol=2e-3 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the study path on the card
# ---------------------------------------------------------------------------
def _nigp_problem(gen, N=300):
    X = gen.uniform(0, 4, (N, 3)).astype(np.float32)
    y = (np.sin(X).sum(1) + 0.1 * gen.normal(size=N)).astype(np.float32)
    return X, y


def test_nigp_gradients_through_b1(dev, gen):
    """float32 autodiff gradients of ``nlml`` and ``nlml_native`` on the
    card (B1 forward, closed-form backward on the summed cotangent of the
    Gram's three uses) against the float64 plain path: max |err| / max
    |ref| <= 2e-3."""
    from mfgp_tpu_torch.models import nigp as tn

    X, y = _nigp_problem(gen)
    lh = np.log([1.2, 0.9, 1.5, 1.3, 0.2, 0.1, 0.15, 0.05])
    gf = gen.normal(size=X.shape)
    for fn in (lambda h, X, y, g: tn.nlml(h, X, y, g),
               lambda h, X, y, g: tn.nlml_native(h, X, y)):
        out = {}
        for dt in (torch.float32, torch.float64):
            h = torch.tensor(lh, dtype=dt, device=dev, requires_grad=True)
            args = _t(dev, X, y, gf, dtype=dt)
            before = ck.LAUNCHES["ar1_cov_fused"]
            v = fn(h, *args)
            g, = torch.autograd.grad(v, h)
            out[dt] = (v.detach().double(), g.double(),
                       ck.LAUNCHES["ar1_cov_fused"] - before)
        v32, g32, n32 = out[torch.float32]
        v64, g64, n64 = out[torch.float64]
        assert n32 >= 1 and n64 == 0
        assert abs(float(v32 - v64)) <= 1e-3 * abs(float(v64))
        assert float((g32 - g64).abs().max() / g64.abs().max()) <= 2e-3


def test_nigp_fits_through_b1(dev, gen):
    """Both NIGP fits on the card in float32: B1 launched, the data on the
    card, finite parameters inside the bounds, the NLML not above its
    start, ``predict`` and ``predict_blocked`` agreeing."""
    from mfgp_tpu_torch.models import nigp as tn

    X, y = _nigp_problem(gen)
    for fit in (lambda m: m.fit(X, y, maxiter_opt=8),
                lambda m: m.fit_native(X, y, maxiter=8)):
        m = tn.NIGP(n_restarts=2, iters=1)
        before = ck.LAUNCHES["ar1_cov_fused"]
        fit(m)
        assert ck.LAUNCHES["ar1_cov_fused"] > before
        assert m.X_train_.is_cuda and m.X_train_.dtype == torch.float32
        p = m.get_params()
        assert np.isfinite(p).all() and (p >= 1e-6 * 0.999).all() and (
            p <= 1e6 * 1.001).all()
        Xs = gen.uniform(0, 4, (257, 3)).astype(np.float32)
        mu, var = m.predict(Xs)
        mu_b, var_b = m.predict_blocked(Xs, block_size=100)
        assert np.isfinite(mu).all() and (var >= 1e-12).all()
        np.testing.assert_allclose(mu_b, mu, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(var_b, var, rtol=1e-2, atol=1e-3)
        mu_c, cov = m.predict(Xs, return_cov=True, as_numpy=False)
        assert cov.is_cuda and cov.shape == (257, 257)


def test_median_heuristic_on_the_card(dev, gen):
    from mfgp_tpu_torch.models import nigp as tn

    X = gen.uniform(0, 5, (400, 3))
    pair = np.sqrt(np.maximum(0, np.sum(
        (X[:, None, :] - X[None, :, :]) ** 2, axis=2)))
    ref = np.median(pair[pair > 0])
    got = tn.median_pairwise_distance(torch.as_tensor(X, device=dev), 5000)
    assert abs(got - ref) <= 1e-12 * ref


def test_filter_on_the_card_matches_cpu(dev, gen):
    """The filter on the card, as CUDA graphs (chunks that do and do not
    divide the steps) and eagerly, against the CPU loop on the same noise:
    1e-9 (float64 on both)."""
    from mfgp_tpu_torch.estimation import kalman as tkf
    from mfgp_tpu_torch.utils.configs import SimConfig

    cfg = SimConfig(vmn=0.1)
    T = 501
    t = np.arange(T) * 0.1
    pos = np.stack([np.column_stack([
        5 + 3 * np.sin(t / 4 + k), 10 + 6 * np.cos(t / 5 + k),
        np.clip(1.5 * np.sin(t / 3 + k), 0.0, None)]) for k in range(3)])
    tb = np.broadcast_to(t, (3, T)).copy()
    noise = gen.normal(size=(3, T - 1, 6))
    ref = tkf.filter_trajectory(cfg.kf_model(device="cpu"), tb, pos,
                                noise=noise)
    model = cfg.kf_model()
    assert model.P0.is_cuda
    for steps in (None, 64, 500, 0):
        got = tkf.filter_trajectory(model, tb, pos, noise=noise,
                                    graph_steps=steps)
        for k in ref:
            assert got[k].is_cuda and got[k].shape == ref[k].shape
            np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(),
                                       rtol=1e-9, atol=1e-9)
    one = tkf.filter_trajectory(model, t, pos[1], noise=noise[1])
    np.testing.assert_allclose(one["xh"].cpu().numpy(), ref["xh"][1].numpy(),
                               rtol=1e-9, atol=1e-9)


def test_process_dataset_float32_device_mode(dev, tmp_path, monkeypatch):
    """One dataset through the pipeline and ``process_dataset`` in the
    float32 device mode on the card (the restart fits cut to 2 lanes x 8
    iterations): B1 launched in the fits and in the evaluation, finite
    RMSEs, finite WMSEs after the counted float64 repairs, the artifacts
    written; beside the float64 scipy mode, which launches no kernel."""
    from mfgp_tpu_torch.data import pipeline, study, trainers
    from mfgp_tpu_torch.data.io import parse_mse
    from mfgp_tpu_torch.fields.wrbf import default_sim_field
    from mfgp_tpu_torch.models import nigp as tn
    from mfgp_tpu_torch.utils.configs import SimConfig

    for cls, name, kw in ((tm.MFGP, "optimize_restarts",
                           dict(n_restarts=2, maxiter=8)),
                          (tg.GP, "optimize_restarts",
                           dict(n_restarts=2, maxiter=8)),
                          (tn.NIGP, "fit_native", dict(maxiter=8))):
        orig = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, _o=orig, _kw=kw,
                            **k: _o(self, *a, **{**k, **_kw}))
    cfg = SimConfig(seed=0, vmn=0.1)
    traj = study.scripted_trajectory(0, cfg, duration=400.0)
    field = default_sim_field(cfg.WS, cfg.max_depth)
    pipeline.run_pipeline(traj, cfg, out_dir=str(tmp_path),
                          traj_name="T0_0.1", field=field)
    data = str(tmp_path / "GPDataSets" / "GPData_0.2_fieldMeas_0_T0_0.1.csv")
    settings = str(tmp_path / "FieldData" / "FieldSettings0.txt")
    ck.reset_launches()
    models, metrics = trainers.process_dataset(
        data, settings, str(tmp_path / "f32"), cfg=cfg, fit_mode="device",
        dtype=np.float32)
    assert ck.LAUNCHES["ar1_cov_fused"] > 12
    assert models.mf.X.is_cuda and models.nigp.X_train_.is_cuda
    assert models.mf.X.dtype == torch.float32
    assert 0 <= metrics[trainers.F64_KEY] <= 4
    for k, v in metrics.items():
        assert np.isfinite(v), k
    parsed = parse_mse(tmp_path / "f32" / "MSE_0.2_fieldMeas_0_T0_0.1.txt")
    assert len(parsed) == 8 and trainers.F64_KEY not in parsed
    ck.reset_launches()
    _, m64 = trainers.process_dataset(data, settings, None, cfg=cfg,
                                      fit_mode="scipy", dtype=np.float64,
                                      optimize=False)
    assert ck.LAUNCHES["ar1_cov_fused"] == 0
    assert np.isfinite(m64["RMSE mf"])


def test_wmse_f64_repairs_on_the_card(dev, gen):
    """An indefinite float32 covariance on the card: ``weighted_mse`` is
    NaN, ``wmse_f64`` repairs it there, 1e-9 from the host's
    ``wmse_host64``."""
    from mfgp_tpu_torch.data import trainers
    from mfgp_tpu_torch.ops.linalg import weighted_mse

    M = 300
    Q, _ = np.linalg.qr(gen.normal(size=(M, M)))
    bad = ((Q * np.r_[np.full(M - 1, 1.0), -1e-3]) @ Q.T).astype(np.float32)
    err = gen.normal(size=M).astype(np.float32)
    e, S = torch.as_tensor(err, device=dev), torch.as_tensor(bad, device=dev)
    assert not np.isfinite(float(weighted_mse(e, S)))
    for normalize in (True, False):
        got = trainers.wmse_f64(e, S, normalize)
        ref = trainers.wmse_host64(err, bad, normalize)
        assert np.isfinite(got) and abs(got - ref) <= 1e-9 * abs(ref)


def test_recursive_mfgp_on_the_card(dev, gen):
    from mfgp_tpu_torch.models.mfgp_recursive import RecursiveMFGP

    Xs = [gen.uniform(0, 4, (n, 3)) for n in (200, 120, 60)]
    ys = [np.sin(x).sum(1) + 0.2 * i for i, x in enumerate(Xs)]
    m = RecursiveMFGP.from_fidelity_lists(Xs, ys, dtype=torch.float32)
    before = ck.LAUNCHES["ar1_cov_fused"]
    m.optimize(n_restarts=2, maxiter=4)
    assert ck.LAUNCHES["ar1_cov_fused"] > before
    assert all(lvl.X.is_cuda for lvl in m.levels)
    mu, var = m.predict(gen.uniform(0, 4, (50, 3)))
    assert np.isfinite(mu).all() and (var > 0).all()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("L,N,M,F", [(1, 33, 33, 3), (3, 130, 130, 1),
                                     (5, 129, 61, 3)])
def test_ar1_cov_fused_lanes(dev, gen, kernel, L, N, M, F):
    """B1's lane axis: one launch for L lanes, each lane bit for bit the
    single-lane launch on its inputs (the symmetric Gram on the same
    tensors, the full grid otherwise), within 1e-5 of the float64 plain
    version."""
    X = torch.as_tensor(gen.uniform(0, 3, (L, N, 3)), dtype=torch.float32,
                        device=dev)
    fid = torch.as_tensor(gen.integers(0, F, (L, N)), device=dev)
    if M == N:
        X2, fid2 = X, fid
    else:
        X2 = torch.as_tensor(gen.uniform(0, 3, (L, M, 3)),
                             dtype=torch.float32, device=dev)
        fid2 = torch.as_tensor(gen.integers(0, F, (L, M)), device=dev)
    v, ls, rho = _t(dev, gen.uniform(0.5, 2.0, (L, F)),
                    gen.uniform(0.5, 2.0, (L, F, 3)),
                    gen.uniform(0.7, 1.2, (L, F - 1)))
    nz = (torch.as_tensor(gen.uniform(0.1, 0.3, (L, N)), dtype=torch.float32,
                          device=dev) if M == N else None)
    before = ck.LAUNCHES["ar1_cov_fused"]
    K = ck.ar1_cov_fused_lanes(X, fid, X2, fid2, v, ls, rho, nz, kernel)
    assert ck.LAUNCHES["ar1_cov_fused"] == before + 1
    for l in range(L):
        b = X[l] if M == N else X2[l]
        fb = fid[l] if M == N else fid2[l]
        one = ck.ar1_cov_fused(X[l], fid[l], b, fb, v[l], ls[l], rho[l],
                               None if nz is None else nz[l], kernel)
        assert torch.equal(K[l].view(torch.int32), one.view(torch.int32))
        ref = ck.ar1_cov_fused_plain(*_f64(X[l], fid[l], b, fb, v[l], ls[l],
                                           rho[l]),
                                     None if nz is None else nz[l].double(),
                                     kern=kernel)
        assert float((K[l].double() - ref).abs().max()) <= 1e-5


# the planner's B1 lane launches: the candidates' path points per lane on
# one side, on the other a training set or grid shared by every lane as a
# broadcast view, the same path points (Kcc, the log-det C with noise), or
# the same points under other labels (Kpc)
PLANNER_LANE_CASES = ["path_x_train", "train_x_path", "Kcc", "Kpc",
                      "C_noise"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("case", PLANNER_LANE_CASES)
def test_ar1_cov_lanes_planner_shapes(dev, gen, kernel, case):
    """B1's lane axis at the planner's launches: one launch for the L
    candidates, each lane bit for bit the single-lane launch on its inputs
    (the symmetric half grid where both sides are the same tensors, the
    full grid for Kpc, whose labels differ), within 1e-5 x max(1, largest
    entry) of the float64 plain version."""
    L, T, N, F = 7, 29, 131, 3
    t32 = dict(dtype=torch.float32, device=dev)
    P = torch.as_tensor(gen.uniform(0, 10, (L, T, 3)), **t32)
    fid_c = torch.as_tensor(gen.integers(0, F, (L, T)), device=dev)
    fid_p = torch.zeros_like(fid_c)
    X = torch.as_tensor(gen.uniform(0, 10, (N, 3)), **t32)
    fX = torch.as_tensor(gen.integers(0, F, N), device=dev)
    Xb, fXb = X.expand(L, N, 3), fX.expand(L, N)
    v, ls, rho = _t(dev, gen.uniform(0.5, 2.0, F),
                    gen.uniform(1.0, 4.0, (F, 3)), gen.uniform(0.7, 1.2, F - 1))
    nz = None
    A, fa, B, fb = {"path_x_train": (P, fid_c, Xb, fXb),
                    "train_x_path": (Xb, fXb, P, fid_c),
                    "Kcc": (P, fid_c, P, fid_c),
                    "Kpc": (P, fid_p, P, fid_c),
                    "C_noise": (P, fid_c, P, fid_c)}[case]
    if case == "C_noise":
        nz = torch.as_tensor(gen.uniform(0.01, 0.1, (L, T)), **t32)
    sym = case in ("Kcc", "C_noise")
    assert ck.same_points(A, fa, B, fb) == sym
    args = (v.expand(L, F), ls.expand(L, F, 3), rho.expand(L, F - 1))
    before = ck.LAUNCHES["ar1_cov_fused"]
    K = tcov.ar1_cov_lanes(*args, A, fa, B, fb, kernel, nz)
    assert ck.LAUNCHES["ar1_cov_fused"] == before + 1
    for l in range(L):
        a, f = A[l].contiguous(), fa[l].contiguous()
        b, g = (a, f) if sym else (a if B is A else B[l].contiguous(),
                                   fb[l].contiguous())
        one = ck.ar1_cov_fused(a, f, b, g, v, ls, rho,
                               None if nz is None else nz[l], kernel)
        assert torch.equal(K[l].view(torch.int32), one.view(torch.int32))
        ref = ck.ar1_cov_fused_plain(*_f64(A[l], fa[l], B[l], fb[l], v, ls,
                                           rho),
                                     None if nz is None else nz[l].double(),
                                     kern=kernel)
        top = max(1.0, float(ref.abs().max()))
        assert float((K[l].double() - ref).abs().max()) <= 1e-5 * top


PLANNER_B1 = {"ergodic": 0, "fourier": 0, "sf_gain": 2, "mf_gain": 4,
              "sf_logdet": 3, "mf_logdet": 3}


@pytest.mark.parametrize("name", list(PLANNER_B1))
def test_cost_batch_float32_vs_float64_on_card(dev, gen, name):
    """Each cost's ``batch`` on a float32 model on the card against the
    same cost on its float64 copy: B1's lane axis once per covariance block
    per batch (not once per candidate), the float32 scores within 1e-4
    (ergodic) or 1e-2 (information gain) of the largest float64 score."""
    from mfgp_tpu_torch.planning import scoring as sc

    N, G = 90, 60
    X = gen.uniform([0, 0, 0], [10, 20, 10], (N, 3))
    fid = gen.integers(0, 3, N)
    y = np.sin(0.4 * X[:, 0]) + np.cos(0.2 * X[:, 1]) + 0.05 * gen.normal(
        size=N)
    grid = gen.uniform([0, 0, 0], [10, 20, 10], (G, 3))
    eid = gen.uniform(0, 1, G)
    eid /= eid.sum()
    paths = []
    for n in gen.integers(3, 30, 40):
        xyz = gen.uniform([0, 0, 0], [10, 20, 10], (n, 3))
        paths.append(np.column_stack([xyz, np.cumsum(gen.uniform(1, 5, n)),
                                      np.sort(gen.uniform(0, 8, n))]))
    mfv = np.array([1.4, 3.0, 4.0, 2.5, 0.8, 2.0, 3.5, 2.0, 0.5, 2.5, 3.0,
                    1.5, 1.0, 1.0, 0.04, 0.02, 0.01])
    scores, b1 = {}, None
    for dtype in (torch.float32, torch.float64):
        Xt = torch.as_tensor(X, dtype=dtype, device=dev)
        yt = torch.as_tensor(y, dtype=dtype, device=dev)
        mf = tm.MFGP(Xt, torch.as_tensor(fid, device=dev), yt, jitter=1e-6)
        mf.set_param_array(mfv)
        gp = tg.GP(Xt, yt, jitter=1e-6)
        gp.set_param_array(np.array([1.3, 3.0, 4.0, 2.5, 0.03]))
        kw = dict(device=dev, dtype=dtype)
        bounds = np.array([[0, 10], [0, 20], [0, 10]], float)
        cost = {"ergodic": lambda: sc.ErgodicCost(eid, grid, **kw),
                "fourier": lambda: sc.FourierErgodicCost(eid, grid, bounds,
                                                         **kw),
                "sf_gain": lambda: sc.SFInfoGainCost(gp),
                "mf_gain": lambda: sc.MFInfoGainCost(mf, (0.25, 2.25, 6.25)),
                "sf_logdet": lambda: sc.BatchLogDetCost(gp, grid),
                "mf_logdet": lambda: sc.MFBatchLogDetCost(
                    mf, grid, (0.25, 2.25, 6.25))}[name]()
        before = ck.LAUNCHES["ar1_cov_fused"]
        scores[dtype] = cost.batch(paths)
        if dtype == torch.float32:
            b1 = ck.LAUNCHES["ar1_cov_fused"] - before
    assert b1 == PLANNER_B1[name]
    s32, s64 = scores[torch.float32], scores[torch.float64]
    assert np.isfinite(s64).all() and np.isfinite(s32).all()
    rtol = 1e-4 if name in ("ergodic", "fourier") else 1e-2
    assert np.abs(s32 - s64).max() <= rtol * np.abs(s64).max()


# ---------------------------------------------------------------------------
# the closed loop: the runtime's observer step and the simulator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph", [True, False])
def test_observer_step_on_the_card(dev, gen, graph):
    """The runtime's per-tick observer call on the card (float64, replayed
    as a CUDA graph or eager) against the same call on the CPU, over ticks
    whose inputs change: 1e-12."""
    from mfgp_tpu_torch.estimation.observers import GliderParams
    from mfgp_tpu_torch.hw.runtime import ObserverStep

    params = GliderParams(lp=0.61, bc=0.55)
    card = ObserverStep(params, dev, graph=graph)
    cpu = ObserverStep(params, "cpu")
    assert card.graph == graph and not cpu.graph
    for _ in range(20):
        args = (*gen.uniform(-0.8, 0.8, 3), gen.normal(0, 0.2, 3),
                gen.normal(0, 0.3, 3), *gen.uniform(0, 3, 2),
                gen.uniform(0, 1), gen.uniform(-0.5, 0.5))
        for a, b in zip(card(*args), cpu(*args)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert (card._cuda_graph is not None) == graph


def test_explore_float32_on_the_card(dev, tmp_path):
    """A short MFGP run on the card in float32 (the sim's default there):
    B1 launched in the refit and in the EID of every replan, the models on
    the card, the artifacts written, a finite RMSE."""
    from mfgp_tpu_torch.sim import ExplorationSim
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    sim = ExplorationSim(ExperimentConfig(multi_fidelity=True, ergodic=False,
                                          B=20, BD=2), seed=1, plan_iters=8,
                         out_dir=str(tmp_path))
    assert sim.dtype == torch.float32 and sim.device.type == "cuda"
    counts = {"eid": [], "fit": []}
    eid, fit = sim._eid, sim._fit

    def counted(fn, key):
        def run(model):
            n0 = ck.LAUNCHES["ar1_cov_fused"]
            out = fn(model)
            counts[key].append(ck.LAUNCHES["ar1_cov_fused"] - n0)
            return out
        return run

    sim._eid, sim._fit = counted(eid, "eid"), counted(fit, "fit")
    res = sim.run()
    assert len(res.replans) >= 1
    assert counts["eid"] and min(counts["eid"]) >= 1
    assert counts["fit"] and min(counts["fit"]) >= 1
    assert res.model.X.is_cuda and res.model.X.dtype == torch.float32
    assert res.rmse is not None and np.isfinite(res.rmse)
    assert res.budget_used <= 20.0 + 1e-9
    assert (tmp_path / "replans.csv").exists()


# ---------------------------------------------------------------------------
# the device planner
# ---------------------------------------------------------------------------
def _planner(dev, cost, max_iter=6, graph=True):
    """A DeviceRIG on the card (float32 covariance tiles) at small sizes,
    with the padded state of a 40-point model of its family."""
    from mfgp_tpu_torch.metrics.eid import eid_grid
    from mfgp_tpu_torch.planning.primitives import AgentConfig
    from mfgp_tpu_torch.planning.rig_device import (DeviceRIG,
                                                    prepare_mf_gain_state,
                                                    prepare_sf_gain_state)

    rng = np.random.default_rng(3)
    cfg = AgentConfig.sim_defaults()
    cfg.variance_rate = 0.01
    grid = eid_grid([[0, 10], [0, 20]], 5.0, nums=(6, 5, 2))
    eid = rng.random(grid.shape[0])
    X = rng.uniform([0, 0, 0], [10, 20, 5], (40, 3)).astype(np.float32)
    y = (np.sin(X[:, 0]) + np.cos(X[:, 1] / 3)).astype(np.float32)
    gp = None
    if cost.startswith("mf"):
        m = tm.MFGP(X, rng.integers(0, 3, 40), y, jitter=1e-6, device=dev)
        gp = prepare_mf_gain_state(m, cfg.fid_levels, 64)
    elif cost.startswith("sf"):
        gp = prepare_sf_gain_state(tg.GP(X, y, jitter=1e-6, device=dev), 64)
    rig = DeviceRIG(cfg, delta=2.0, B=12.0, WS=[[0, 10], [0, 20]], R=3.0,
                    Rd=2.0, same_node_distance=0.5, budget_cutoff=0.5,
                    max_iter=max_iter, grid=grid, cost=cost, max_nodes=16,
                    max_paths=4, samples_per_edge=8, max_path_points=48,
                    graph=graph, device=dev)
    return rig, dict(eid=eid / eid.sum() if cost in ("ergodic", "fourier")
                     else None, gp=gp)


def _same(a, b):
    return (a.n_nodes == b.n_nodes and a.info == b.info
            and a.budget == b.budget and a.chain == b.chain
            and np.array_equal(a.points, b.points)
            and np.array_equal(a.trace, b.trace))


@pytest.mark.parametrize("cost", ["ergodic", "sf_gain", "mf_logdet"])
def test_device_planner_graph_equals_eager(dev, cost):
    """Iteration 0 eager, one iteration captured as a CUDA graph and
    replayed: the plan equals the eager loop's bit for bit."""
    g, kw = _planner(dev, cost, graph=True)
    e, _ = _planner(dev, cost, graph=False)
    assert g.graph and not e.graph
    a, b = g.plan([1.0, 1.0], seed=2, **kw), e.plan([1.0, 1.0], seed=2, **kw)
    assert _same(a, b) and a.n_nodes > 1
    assert g.stats["replays"] == 5 and e.stats["replays"] == 0


@pytest.mark.parametrize("cost", ["ergodic", "mf_gain", "sf_logdet"])
def test_device_planner_loop_has_no_host_sync(dev, cost):
    """The whole eager loop (the plan's constants, the state, every
    iteration) runs under ``set_sync_debug_mode("error")``."""
    rig, kw = _planner(dev, cost, graph=False)
    args = rig._args([1.0, 1.0], None, kw["eid"], kw["gp"])
    draws = rig.draws(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = rig._run(*args, draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(st["n_nodes"][0]) > 1


@pytest.mark.parametrize("cost", ["mf_gain", "mf_logdet", "sf_gain"])
def test_device_planner_b1_matches_plain(dev, cost):
    """Every lane-axis launch of B1 in a plan (edges, paths, (path, edge)
    pairs as lanes) against its plain version in float64 on the same
    inputs: 1e-5 x max(1, largest entry); the padded training rows
    exactly 0."""
    rig, kw = _planner(dev, cost, graph=False)
    seen, real = [], ck.ar1_cov_fused_lanes

    def record(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    ck.ar1_cov_fused_lanes = record
    try:
        rig.plan([1.0, 1.0], seed=1, **kw)
    finally:
        ck.ar1_cov_fused_lanes = real
    assert len(seen) >= 3 * rig.max_iter
    for args, out in seen[:40]:
        A, fa, B, fb, v, ls, rho, nz, kern = args
        ref = ck.ar1_cov_fused_lanes_plain(
            A.double(), fa, B.double(), fb, v.double(), ls.double(),
            rho.double(), None if nz is None else nz.double(), kern)
        top = max(1.0, float(ref.abs().max()))
        assert float((out.double() - ref).abs().max()) <= 1e-5 * top
        for X, pad in ((A, out[:, 40:, :]), (B, out[:, :, 40:])):
            if X.shape[1] == 64 and bool((X[:, 40:] == 1e6).all()):
                assert not bool(pad.any())


@pytest.mark.parametrize("cost", ["ergodic", "sf_gain"])
def test_device_planner_ensemble_equals_solo(dev, cost):
    """A 2-lane ensemble runs each lane as the solo plan of its draws: the
    same graphs and best paths, scores within 1e-6 (a lane's reductions
    may be split differently at another lane count); the winner is the
    better solo plan."""
    rig, kw = _planner(dev, cost)
    draws = rig.draws(torch.Generator().manual_seed(4), lanes=2)
    ens = rig._to_host(rig._run(*rig._args(np.array([[1.0, 1.0]] * 2),
                                           None, kw["eid"], kw["gp"]),
                                draws))
    lanes = [rig._extract(ens, i) for i in range(2)]
    solos = [rig.plan([1.0, 1.0], draws=draws[i:i + 1], **kw)
             for i in range(2)]
    for a, b in zip(lanes, solos):
        assert (a.n_nodes, a.chain) == (b.n_nodes, b.chain)
        np.testing.assert_allclose(a.info, b.info, rtol=1e-6)
        np.testing.assert_allclose(a.points, b.points, rtol=1e-5,
                                   atol=1e-5)
    best = rig.plan_ensemble([1.0, 1.0], n_plans=2, draws=draws, **kw)
    win = max(solos, key=lambda r: (r.info, -r.budget))
    assert best.chain == win.chain


# ---------------------------------------------------------------------------
# the device runtime and the mission
# ---------------------------------------------------------------------------
def _runtime(dev, graph, stride=1):
    """A runtime on the card (float64) and two plans of two legs each."""
    from mfgp_tpu_torch.hw.runtime import RuntimeConfig
    from mfgp_tpu_torch.hw.runtime_device import DevicePlan, DeviceRuntime
    from mfgp_tpu_torch.planning.primitives import (AgentConfig, Leg,
                                                    evaluate_trajectory,
                                                    generate_trajectory)

    cfg = AgentConfig.sim_defaults()
    rt = DeviceRuntime(cfg, RuntimeConfig(dt=0.1), device=dev,
                       graph=graph, glide_stride=stride)
    plans, carries = [], []
    for seed, dist in ((0, 2.0), (4, 1.5)):
        _, prims = generate_trajectory(np.random.default_rng(seed),
                                       [Leg.GLIDE, Leg.SWIM], dist, cfg)
        _, _, _, w, _ = evaluate_trajectory(prims, cfg)
        way = np.column_stack([w[:, 0], np.zeros(len(w)), w[:, 1],
                               w[:, 2]])
        plans.append(rt.pack_plan(way, prims))
        carries.append(rt.init_carry(way[0, 0], way[0, 1]))
    plan = DevicePlan(*[torch.cat([getattr(p, k) for p in plans])
                        for k in DevicePlan._fields])
    carry = {k: torch.cat([c[k] for c in carries]) for k in carries[0]}
    return rt, plan, carry


@pytest.mark.parametrize("stride", [1, 4])
def test_runtime_captured_chunk_equals_eager(dev, stride):
    """Two lanes flown by chunks of ticks captured as CUDA graphs and
    replayed (with glide_stride 4: coarse, fine and mixed windows) equal
    the eager loop bit for bit: every log row and the carry."""
    noise = torch.randn((2, 700, 13), generator=torch.Generator()
                        .manual_seed(3), dtype=torch.float64)
    outs = []
    for graph in (True, False):
        rt, plan, carry = _runtime(dev, graph, stride)
        outs.append(rt.fly(plan, carry, noise, 700))
        assert (rt.last_fly["replays"] > 0) == graph
    (ca, la), (cb, lb) = outs
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for k in ca:
        assert torch.equal(ca[k], cb[k]), k


@pytest.mark.parametrize("kind", ["fine", "mixed"])
def test_runtime_window_has_no_host_sync(dev, kind):
    """A window of ticks (the unit a graph captures) runs under
    ``set_sync_debug_mode("error")``."""
    rt, plan, carry = _runtime(dev, False, 1 if kind == "fine" else 4)
    noise = torch.zeros((2, 64, 13), dtype=torch.float64)
    rt.fly(plan, carry, noise, 64)
    b = rt._engines[(2, 64)]
    b["i"].zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            rt._window(b, kind)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(b["i"]) == 3 * rt.glide_stride


def test_mission_float32_on_the_card(dev):
    """A small float32 mission (MF, sequential gain, refits) on the card:
    B1 launched in every replan, a finite result."""
    from mfgp_tpu_torch.sim.mission_device import DeviceMission
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    m = DeviceMission(ExperimentConfig(B=20.0, BD=2, multi_fidelity=True,
                                       ergodic=False, update_hyps=True),
                      seed=0, plan_iters=12, e_max=6, max_nodes=16,
                      samples_per_edge=6, device=dev)
    assert m.dtype == torch.float32
    counts, body = [], m._body

    def counted(r, st, run):
        n0 = ck.LAUNCHES["ar1_cov_fused"]
        out = body(r, st, run)
        counts.append(ck.LAUNCHES["ar1_cov_fused"] - n0)
        return out

    m._body = counted
    res = m.run()
    assert len(counts) == 2 and all(c > 0 for c in counts)
    assert res.n_replans >= 1 and np.isfinite(res.rmse)
    assert np.all(np.isfinite(res.test_mu))


@pytest.mark.parametrize("cost", ["ergodic", "mf_gain"])
def test_device_planner_reused_graph_equals_eager(dev, cost):
    """A second plan of the same shapes replays the first plan's captured
    iteration on its own values (nothing captured): it equals the eager
    loop's plan of the same draws bit for bit."""
    g, kw = _planner(dev, cost, graph=True)
    e, _ = _planner(dev, cost, graph=False)
    g.plan([1.0, 1.0], seed=2, **kw)
    a = g.plan([2.0, 3.0], seed=5, **kw)
    assert g.stats["eager_iterations"] == 0 and g.stats["capture_s"] == 0.0
    assert _same(a, e.plan([2.0, 3.0], seed=5, **kw)) and a.n_nodes > 1


@pytest.mark.parametrize("ls", [0.1, 0.01, 0.002])
def test_ar1_cov_small_lengthscales(dev, ls):
    """B1 scales each difference itself, so close points far from the
    origin keep their digits at small lengthscales (a refit's trial
    hyperparameters): every lane within 1e-5 x max(1, largest entry) of
    float64 on the same inputs (points scaled first were off by 2.6e-4
    relative at lengthscale 0.002)."""
    g = np.random.default_rng(5)
    base = np.array([7.3, 14.1, 3.2])
    X = (base + np.cumsum(g.normal(0, 0.5 * ls, (2, 300, 3)), 1)).astype(
        np.float32)
    fid = g.integers(0, 3, (2, 300))
    v = np.array([[1.3, 0.8, 2.1]] * 2, np.float32)
    lsv = np.full((2, 3, 3), ls, np.float32)
    rho = np.array([[0.9, 1.1]] * 2, np.float32)
    Xt, ft, vt, lt, rt = _t(dev, X, fid, v, lsv, rho)
    got = ck.ar1_cov_fused_lanes(Xt, ft, Xt, ft, vt, lt, rt)
    ref = ck.ar1_cov_fused_lanes_plain(*_f64(Xt, ft, Xt, ft, vt, lt, rt))
    top = max(1.0, float(ref.abs().max()))
    assert float((got.double() - ref).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("ls", [0.1, 0.01, 0.002])
def test_ar1_train_cov_backward_small_lengthscales(dev, kern, ls):
    """The refit's differentiable Gram on the card (B1's lane axis forward,
    closed-form backward) at small trial lengthscales, close points far
    from the origin: each lane's cotangents within 1e-5 normwise of
    float64 autograd through the plain composition on the same inputs."""
    g = np.random.default_rng(5)
    X = (np.array([7.3, 14.1, 3.2]) + np.cumsum(
        g.normal(0, 0.5 * ls, (2, 300, 3)), 1)).astype(np.float32)
    fid = g.integers(0, 3, (2, 300))
    u = g.normal(size=(2, 300, 1))
    Ct = u @ u.transpose(0, 2, 1) + 0.1 * g.normal(size=(2, 300, 300))
    v = np.array([[1.3, 0.8, 2.1]] * 2)
    lsv = np.full((2, 3, 3), ls)
    rho = np.array([[0.9, 1.1]] * 2)
    Xt, ft, vt, lt, rt, Ctt = _t(dev, X, fid, v, lsv, rho, Ct)
    args = [a.clone().requires_grad_() for a in (vt, lt, rt)]
    K = tcov._AR1TrainCov.apply(kern, *args, Xt, ft)
    got = torch.autograd.grad(K, args, Ctt)
    for l in range(2):
        ref = [a[l].detach().cpu().double().requires_grad_()
               for a in (vt, lt, rt)]
        Kl = tcov._k.ar1_cov(*_f64(Xt[l].cpu(), ft[l].cpu(), Xt[l].cpu(),
                                   ft[l].cpu()), *ref, kern)
        ref = torch.autograd.grad(Kl, ref, Ctt[l].cpu().double())
        for a, b in zip(got, ref):
            assert float((a[l].cpu().double() - b).norm() / b.norm()) <= 1e-5


def _c5_problem(dev, case, kern):
    """float32 (Linv, Kinv, alpha, X, fid, v, ls, rho, noises) on the card
    at ROADMAP C5's inputs (the CPU test's, tests/test_torch_fit.py::
    kinv_problem): ("box", ls), 300 points uniform over the simulator's
    10 x 20 x 10 m box; ("close", 0.002), 60 points near (15, 15, 15),
    spread 0.003. The factors come from the float64 Gram, then rounded."""
    g = np.random.default_rng(1)
    name, ls = case
    X = (g.uniform(0, 1, (300, 3)) * [10, 20, 10] if name == "box"
         else 15 + g.normal(0, 0.003, (60, 3)))
    N = X.shape[0]
    fid = g.integers(0, 3, N)
    X, fid, v, lsv, rho, nz = _t(
        dev, X, fid, np.array([1.3, 0.8, 2.1]), np.full((3, 3), ls),
        np.array([0.9, 1.1]), np.array([0.05, 0.03, 0.02]),
        dtype=torch.float64)
    K = ck.ar1_cov_fused_plain(X, fid, X, fid, v, lsv, rho, nz[fid] + 1e-6,
                               kern)
    Linv = torch.linalg.inv(torch.linalg.cholesky(K)).contiguous()
    Kinv = Linv.T @ Linv
    alpha = Kinv @ torch.as_tensor(np.sin(X.cpu().numpy()).sum(1)
                                   + 0.1 * g.normal(size=N), device=dev)
    return [a.float() if a.is_floating_point() else a
            for a in (Linv, Kinv, alpha, X, fid, v, lsv, rho, nz)]


C5_CASES = [("box", 1.0), ("box", 0.3), ("close", 0.002)]


def _worst_component(got, ref) -> float:
    return max(float(((g.double() - h).abs() / h.abs()).max())
               for g, h in zip(got, ref))


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("case", C5_CASES)
def test_grad_from_kinv_float32_on_card(dev, kern, case):
    """ROADMAP C5 on the card: the float32 analytic gradient of the
    restart fits within 2e-3 per component of its float64 evaluation on
    the same K^-1 and alpha."""
    _, Kinv, *rest = _c5_problem(dev, case, kern)
    got = ck.grad_from_kinv(Kinv, *rest, kern)
    assert _worst_component(got, ck.grad_from_kinv(*_f64(Kinv, *rest),
                                                   kern)) <= 2e-3


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("case", C5_CASES)
def test_syrk_grad_fused_c5_inputs(dev, kern, case):
    """B2 at ROADMAP C5's inputs: within 2e-3 per component of the float64
    evaluation on K^-1 = Linv^T Linv of the same float32 Linv."""
    Linv, _, *rest = _c5_problem(dev, case, kern)
    got = ck.syrk_grad_fused(Linv, *rest, kern)
    L64, *r64 = _f64(Linv, *rest)
    assert _worst_component(got, ck.grad_from_kinv(L64.T @ L64, *r64,
                                                   kern)) <= 2e-3


def _served_mfgp(dev, n=(60, 40, 30), seed=0):
    """A float32 MFGP on the card over the simulator's 10 x 20 x 10 m
    box."""
    g = np.random.default_rng(seed)
    Xl = [(g.uniform(0, 1, (k, 3)) * [10, 20, 10]).astype(np.float32)
          for k in n]
    yl = [(np.sin(x[:, 0]) + 0.1 * g.standard_normal(x.shape[0])).astype(
        np.float32) for x in Xl]
    return tm.MFGP.from_fidelity_lists(Xl, yl, jitter=1e-6, device=dev)


def test_served_checkpoint_is_float32_and_launches_b1(dev, tmp_path):
    """A checkpoint served on the card restores in float32 (the kernels'
    dtype) whatever it was saved in, and every /predict launches B1; the
    served answers equal the model's own predict."""
    from mfgp_tpu_torch import serve
    from mfgp_tpu_torch.utils import checkpoint as ckpt

    m = _served_mfgp(dev)
    m64 = tm.MFGP(m.X.double(), m.fid, m.y.double(), n_fidelities=3,
                  jitter=1e-6)
    ckpt.save_checkpoint(str(tmp_path / "m"), ckpt.ExplorationCheckpoint(
        plan_num=0, t_now=0.0, planned_budget=0.0, x0=np.zeros((2, 1)),
        model=ckpt.capture_model(m64), data_rows=np.zeros((0, 9)),
        rng_state=np.random.default_rng(0).bit_generator.state))
    srv = serve.ModelServer.from_checkpoint(str(tmp_path / "m"))
    try:
        assert srv.model.X.dtype == torch.float32 and srv.model.X.is_cuda
        pts = np.random.default_rng(1).uniform(0, 10, (300, 3))
        n0 = ck.LAUNCHES["ar1_cov_fused"]
        out = srv.handle("/predict", {"points": pts.tolist()})
        assert ck.LAUNCHES["ar1_cov_fused"] > n0
        mu, var = srv.model.predict(pts)
        np.testing.assert_allclose(out["mean"], mu.cpu().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out["var"], var.cpu().numpy(), rtol=1e-6,
                                   atol=1e-6)
    finally:
        srv.close()


def test_plan_capture_under_predict_load(dev):
    """The planner service's first plan captures its iteration while four
    clients hammer /predict on the same model over HTTP: every request
    answers, with the unloaded values, and the captured planner plans
    what a service built without load plans (the device lock keeps other
    threads' CUDA calls out of the capture)."""
    import http.client
    import json
    import threading
    import time

    from mfgp_tpu_torch import serve

    ms = serve.ModelServer(_served_mfgp(dev))
    srv = serve.make_http_server(ms, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    q = np.random.default_rng(2).uniform(0, 10, (200, 3))
    mu_q, var_q = ms._predict_device(q)
    stop, answers = threading.Event(), []

    def hammer():
        while not stop.is_set():
            conn = http.client.HTTPConnection(*srv.server_address,
                                              timeout=60)
            try:
                conn.request("POST", "/predict",
                             json.dumps({"points": q.tolist()}))
                r = conn.getresponse()
                answers.append((time.perf_counter(), r.status,
                                json.loads(r.read())))
            finally:
                conn.close()

    hammers = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    svc = quiet = None
    try:
        for t in hammers:
            t.start()
        t_end = time.monotonic() + 60
        while len(answers) < 4 and time.monotonic() < t_end:
            time.sleep(0.005)
        t0 = time.perf_counter()
        svc = serve.PlannerService(ms, cost="mf_gain", plan_iters=12,
                                   warm=True)
        t1 = time.perf_counter()
        stop.set()
        for t in hammers:
            t.join(timeout=60)
            assert not t.is_alive()
        assert svc.planner.stats["replays"] > 0  # captured and replayed
        assert any(t0 < a[0] < t1 for a in answers)
        for _, status, body in answers:
            assert status == 200, body
            np.testing.assert_allclose(body["mean"], mu_q, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(body["var"], var_q, rtol=1e-5,
                                       atol=1e-5)
        req = {"start": [3.0, 5.0], "budget": 15.0, "seed": 4}
        quiet = serve.PlannerService(serve.ModelServer(ms.model),
                                     cost="mf_gain", plan_iters=12,
                                     warm=True)
        assert svc.handle("/plan", req) | {"plan_seconds": 0} == \
            quiet.handle("/plan", req) | {"plan_seconds": 0}
    finally:
        stop.set()
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
        for s in (svc, quiet):
            if s is not None:
                s.close()
        if svc is None:
            ms.close()


@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """A (1, 1) mesh of ``mfgp_tpu_torch.parallel`` over an NCCL group of
    world size 1 (the production backend of a multi-GPU node), torn down
    after the test."""
    import torch.distributed as dist

    from mfgp_tpu_torch import parallel as par

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield par.make_mesh(device=dev)
    finally:
        dist.destroy_process_group()


def _parallel_problem(dev, N=2000, M=301):
    """N training points on the unit's 60 x 110 x 4.5 m box with the
    unit's parameters (bench.py's problem and theta, F=3), float32."""
    g = np.random.default_rng(0)
    X = g.uniform(0, 1, (N, 3)) * [60.0, 110.0, 4.5]
    grid = g.uniform(0, 1, (M, 3)) * [60.0, 110.0, 4.5]
    y = np.sin(X[:, 0] / 7) + np.cos(X[:, 1] / 11) + 0.1 * g.normal(size=N)
    X, fid, y, grid, gfid = _t(dev, X, g.integers(0, 3, N), y, grid,
                               np.full(M, 2))
    p = tm.params_from_numpy(np.log([25.0, 10.0, 5.0]),
                             np.log(np.tile([12.0, 20.0, 1.5], (3, 1))),
                             np.ones(2), np.log([0.5, 0.2, 0.1]), dev,
                             torch.float32)
    return X, fid, y, grid, gfid, p


def test_parallel_nccl_mesh_matches_one_device(nccl_mesh, dev):
    """On the NCCL (1, 1) mesh the sharded MFGP predict equals the
    one-device predict, and the fully sharded NLML (both layouts, 250-wide
    panels) is within 1e-4 of the float64 value on the same float32
    inputs (the one-device float32 value itself is 2e-4 off there), each
    launching B1."""
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.parallel import mesh as pm

    X, fid, y, grid, gfid, p = _parallel_problem(dev)
    st = tm.condition(p, X, fid, y, jitter=1e-6)
    b0 = ck.LAUNCHES["ar1_cov_fused"]
    mu, var = par.make_sharded_mfgp_predict(nccl_mesh)(p, st, grid, gfid)
    assert ck.LAUNCHES["ar1_cov_fused"] > b0
    mu1, var1 = tm.predict(p, st, grid, gfid)
    assert torch.equal(mu, mu1) and torch.equal(var, var1)
    v64 = float(tm.nlml(tm.MFGPParams(*_f64(*p)), *_f64(X, fid, y),
                        jitter=1e-6))
    for layout in ("block", "cyclic"):
        b0 = ck.LAUNCHES["ar1_cov_fused"]
        v, g = par.make_fully_sharded_nlml_value_and_grad(
            nccl_mesh, X.shape[0], block=250, jitter=1e-6, layout=layout)(
                p, X, fid, y)
        assert ck.LAUNCHES["ar1_cov_fused"] > b0
        assert abs(float(v) - v64) <= 1e-4 * abs(v64)
        assert all(bool(torch.isfinite(a).all()) for a in g)
    assert pm.COLLECTIVES["host_staged"] == 0


@pytest.mark.parametrize("case", [("box", 1.0), ("box", 0.3),
                                  ("close", 0.002)])
def test_sharded_grad_c5_inputs(nccl_mesh, dev, case):
    """The sharded gradients' contraction (the lengthscale term from
    differences, B1's kernel columns) at ROADMAP C5's inputs in float32:
    within 2e-3 per component of ``grad_from_kinv`` in float64 on the same
    K^-1 and alpha."""
    from mfgp_tpu_torch.parallel.sharded import _sharded_grad

    _, Kinv, alpha, X, fid, v, ls, rho, nz = _c5_problem(dev, case, "rbf")
    p = tm.MFGPParams(torch.log(v), torch.log(ls), rho, torch.log(nz))
    cols = torch.arange(X.shape[0], device=dev)
    b0 = ck.LAUNCHES["ar1_cov_fused"]
    g = _sharded_grad(nccl_mesh, Kinv.clone(), alpha, X, fid, cols, p)
    assert ck.LAUNCHES["ar1_cov_fused"] == b0 + 3  # one per fidelity
    ref = ck.grad_from_kinv(*_f64(Kinv, alpha, X, fid, v, ls, rho, nz),
                            "rbf")
    assert _worst_component((g.log_variances, g.log_lengthscales,
                             g.log_noises), ref) <= 2e-3


def _full_sweeps_evaluation(mesh, p, X, fid, y, block, jitter):
    """The fully sharded NLML and gradient on a one-rank mesh with the
    general sweeps over the full height of every identity column (K^-1
    whole), as the fit computed them before its sweeps were cut to K^-1's
    block-lower part."""
    import math

    from mfgp_tpu_torch.ops import kernels as tk
    from mfgp_tpu_torch.parallel import chol, sharded

    n = X.shape[0]
    cols = torch.arange(n, device=X.device)
    K = tcov.mf_cross_cov(p.variances, p.lengthscales, p.rhos, X, fid, X,
                          fid, "rbf")
    K[cols, cols] += tk.mf_noise_diag(fid, p.noises) + jitter
    L = chol._chol_cols_body(mesh, K, n, block)
    Kinv = chol._tri_solve_upper_body(mesh, L, chol._tri_solve_lower_body(
        mesh, L, sharded._eye_cols(n, cols, X), n, block), n, block)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    del L, K
    alpha = Kinv @ y
    val = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * n * math.log(
        2.0 * math.pi)
    return val, sharded._sharded_grad(mesh, Kinv, alpha, X, fid, cols, p)


def test_fully_sharded_block_lower_route_on_the_card(nccl_mesh, dev):
    """On the NCCL (1, 1) mesh at N=8,000, panels of 250, float32: the
    fully sharded NLML and gradient from K^-1's block-lower part are no
    further from the float64 reference (``nlml_rel``, ``grad_rel`` as the
    sharded cell reads them) than the full sweeps composed here, plus
    2^-20."""
    from benchmark.reference import gp as ref
    from mfgp_tpu_torch import parallel as par

    X, fid, y, _, _, p = _parallel_problem(dev, N=8000)
    v, g = par.make_fully_sharded_nlml_value_and_grad(
        nccl_mesh, 8000, block=250, jitter=1e-6)(p, X, fid, y)
    vf, gf = _full_sweeps_evaluation(nccl_mesh, p, X, fid, y, 250, 1e-6)
    r = ref.nlml_grad(X, fid, y, dict(
        variances=p.variances.double(), lengthscales=p.lengthscales.double(),
        rhos=p.rhos.double(), noises=p.noises.double()), "rbf", 1e-6)
    v64, g64 = float(r["value"]), ref.grad_vector(r)

    def errors(val, grad):
        flat = torch.cat([grad.log_variances, grad.log_lengthscales.reshape(
            -1), grad.log_noises]).double()
        return (abs(float(val) - v64) / abs(v64),
                float(torch.max(torch.abs(flat - g64))
                      / torch.max(torch.abs(g64))))

    new, full = errors(v, g), errors(vf, gf)
    assert all(a <= b + 2.0 ** -20 for a, b in zip(new, full)), (new, full)


# the fully sharded NLML across four GPUs, as the nlml_sharded_n80k_4chip
# cell runs it, at a size the test holds: 2 x 2 tiles of 2,000 points
FOUR_GPU_N = 8000


def _four_gpu_rank(rank, port, tmp):
    """One of four NCCL ranks started as ``torchrun`` would: the launcher's
    environment, ``parallel.init_ranks``, the fully sharded NLML at the
    default panel width; its value, gradient, device and collectives
    saved to ``tmp``."""
    import os

    import torch.distributed as dist

    from benchmark.common import tiles
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.parallel import mesh as pm

    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = par.init_ranks(timeout_s=120.0)
    try:
        X, fid, y = tiles.build_tiles(_four_gpu_config(), 7)
        X, y = (torch.as_tensor(a, device=dev) for a in (X, y))
        fid = torch.as_tensor(fid, device=dev)
        p = tm.params_from_numpy(*_four_gpu_theta(), dev, torch.float32)
        pm.reset_collectives()
        v, g = par.make_fully_sharded_nlml_value_and_grad(
            par.make_mesh(mp=4), FOUR_GPU_N)(p, X, fid, y)
        torch.save(dict(v=float(v), g=[a.double().cpu() for a in g],
                        device=str(X.device),
                        collectives=dict(pm.COLLECTIVES)),
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _four_gpu_config():
    return dict(N=FOUR_GPU_N, D=3, tiles=[2, 2], tile_shift=[60.0, 110.0])


def _four_gpu_theta():
    return (np.log([25.0, 10.0, 5.0]),
            np.log(np.tile([12.0, 20.0, 1.5], (3, 1))), np.ones(2),
            np.log([0.5, 0.2, 0.1]))


def test_fully_sharded_nlml_on_four_gpus(dev, tmp_path):
    """Four NCCL ranks, one per GPU through ``init_ranks``: each rank's
    tensors on its own card, the value and gradient within the
    ``nlml_sharded_n80k_4chip`` cell's limits of the float64 reference,
    every collective on the cards (none staged through the host)."""
    import json
    import socket
    import time
    from pathlib import Path

    import torch.multiprocessing as mproc

    from benchmark.common import tiles
    from benchmark.reference import gp as ref

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mproc.start_processes(_four_gpu_rank, args=(port, str(tmp_path)),
                                 nprocs=4, join=False, start_method="spawn")
    X, fid, y = (torch.as_tensor(a, device=dev)
                 for a in tiles.build_tiles(_four_gpu_config(), 7))
    lv, ll, rho, ln = _four_gpu_theta()
    r = ref.nlml_grad(X, fid, y, dict(variances=np.exp(lv),
                                      lengthscales=np.exp(ll), rhos=rho,
                                      noises=np.exp(ln)), "rbf", 0.0)
    v_ref, g_ref = float(r["value"]), ref.grad_vector(r).cpu()
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("four-GPU ranks still running after 300 s")
    root = Path(__file__).resolve().parents[1]
    limits = json.loads((root / "benchmark/traffic/"
                         "fit_eval_sharded_closed.json").read_text())["limits"]
    for rank in range(4):
        out = torch.load(tmp_path / f"rank{rank}.pt")
        assert out["device"] == f"cuda:{rank}"
        g = torch.cat([out["g"][0], out["g"][1].reshape(-1), out["g"][3]])
        assert abs(out["v"] - v_ref) / abs(v_ref) <= limits["nlml_rel"]
        assert (float(torch.max(torch.abs(g - g_ref)))
                / float(torch.max(torch.abs(g_ref)))) <= limits["grad_rel"]
        assert out["collectives"]["host_staged"] == 0
        assert out["collectives"]["broadcast"] > 0
