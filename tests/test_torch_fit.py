"""Parity of the port's fit paths for the AR1 MFGP with ``mfgp_tpu`` on the
CPU: the differentiable training Gram (``ops.covariance._AR1TrainCov``,
``ar1_cov_diff``), the autodiff ``nlml``, both L-BFGS optimizers
(``ops.optimize``), the restart-batched fit and the ``MFGP`` class.

Both packages get the same numpy arrays (from a seed). In float64 the
mathematics is the same, so values, gradients and single evaluations agree
to rtol 1e-7 (the closed-form backward to 1e-9); a fit's iterates to rtol
1e-6, lane by lane with the same iteration counts. In float32 the
Function is held against JAX's custom VJP with the Pallas forward in
interpret mode at rtol = atol = 2e-4 (tests/test_pallas_kernels.py's bar).
``jax.random`` streams cannot be drawn in torch, so restart fits take the
same numpy inits on both sides, and the class method that draws them is
tested for its behaviour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.models import mfgp as jm
from mfgp_tpu.ops import covariance as jcov
from mfgp_tpu.ops import optimize as jopt
from mfgp_tpu_torch.models import mfgp as tm
from mfgp_tpu_torch.ops import covariance as tcov
from mfgp_tpu_torch.ops import optimize as topt

RTOL, ATOL = 1e-7, 1e-9
FIT_RTOL = 1e-6
JITTER = 1e-6
KERNELS = ["rbf", "matern32"]


def close(port, ref, rtol=RTOL, atol=ATOL):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def raw_params(rng, F, D=3):
    """(log_variances, log_lengthscales, rhos, log_noises) as numpy."""
    return (np.log([1.4, 0.9, 0.6][:F]), np.log(rng.uniform(0.8, 1.8, (F, D))),
            np.array([0.9, 0.8][:F - 1]), np.log([0.05, 0.03, 0.02][:F]))


def problem(seed, F, N=60, D=3):
    """numpy (X, fid, y) of one AR1 problem with a smooth signal."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    fid = rng.integers(0, F, N)
    y = np.sin(X).sum(1) + 0.1 * rng.normal(size=N)
    return rng, X, fid, y


def jx(*arrays):
    return [jnp.asarray(a, jnp.int32) if a.dtype.kind == "i"
            else jnp.asarray(a) for a in arrays]


def tt(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# ---------------------------------------------------------------------------
# the differentiable Gram
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("F", [1, 3])
def test_ar1_train_cov_gradcheck(kernel, F):
    rng, X, fid, _ = problem(0, F, N=12)
    raw = raw_params(rng, F)
    args = tuple(torch.tensor(a, requires_grad=True)
                 for a in (np.exp(raw[0]), np.exp(raw[1]), raw[2]))
    Xt, ft = tt(X, fid)
    assert torch.autograd.gradcheck(
        lambda v, ls, r: tcov._AR1TrainCov.apply(kernel, v, ls, r, Xt, ft),
        args)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("F", [1, 3])
def test_ar1_train_cov_backward_matches_jax(kernel, F):
    """The Function's backward against JAX's ``_ar1_bwd`` for an
    asymmetric cotangent; its forward against the plain composition."""
    rng, X, fid, _ = problem(1, F, N=45)
    raw = raw_params(rng, F)
    v, ls, r = np.exp(raw[0]), np.exp(raw[1]), raw[2]
    Ct = rng.normal(size=(45, 45))
    ref = jcov._ar1_bwd(kernel, tuple(jx(v, ls, r, X, fid)), jnp.asarray(Ct))
    args = [torch.tensor(a, requires_grad=True) for a in (v, ls, r)]
    K = tcov._AR1TrainCov.apply(kernel, *args, *tt(X, fid))
    got = torch.autograd.grad(K, args, torch.as_tensor(Ct))
    for g, h in zip(got, ref[:3]):
        close(g, h, rtol=1e-9, atol=1e-12)
    close(K, jcov._k.ar1_cov(*jx(X, fid, X, fid, v, ls, r), kernel))


@pytest.mark.parametrize("kernel", KERNELS)
def test_ar1_train_cov_float32_matches_pallas_vjp(kernel):
    """float32: the Function (plain forward here) against JAX's custom VJP
    around the Pallas forward in interpret mode, every parameter."""
    rng, X, fid, _ = problem(2, 3, N=23)
    raw = raw_params(rng, 3)
    f32 = [a.astype(np.float32) for a in
           (np.exp(raw[0]), np.exp(raw[1]), raw[2], X)]
    R = rng.normal(size=(23, 23)).astype(np.float32)
    fj = jnp.asarray(fid, jnp.int32)
    ref = jax.grad(lambda v, ls, r: jnp.sum(
        R * jcov._ar1_train_cov_fused(kernel, v, ls, r, jnp.asarray(f32[3]),
                                      fj)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in f32[:3]))
    args = [torch.tensor(a, requires_grad=True) for a in f32[:3]]
    K = tcov._AR1TrainCov.apply(kernel, *args, torch.as_tensor(f32[3]),
                                torch.as_tensor(fid))
    got = torch.autograd.grad(torch.sum(torch.as_tensor(R) * K), args)
    for g, h in zip(got, ref):
        assert g.dtype == torch.float32
        close(g, h, rtol=2e-4, atol=2e-4)


def test_ar1_cov_diff_dispatch(monkeypatch):
    """Plain autograd on the CPU; the Function where the kernels apply,
    with the same gradients."""
    rng, X, fid, _ = problem(3, 3, N=20)
    raw = raw_params(rng, 3)
    out = []
    for gate in (False, True):
        monkeypatch.setattr(tcov, "use_cuda_kernels", lambda *a, g=gate: g)
        args = [torch.tensor(a, requires_grad=True)
                for a in (np.exp(raw[0]), np.exp(raw[1]), raw[2])]
        K = tcov.ar1_cov_diff(*args, *tt(X, fid), "matern32")
        assert (K.grad_fn.name() == "_AR1TrainCovBackward") == gate
        out.append(torch.autograd.grad(torch.sum(K * K), args))
    for a, b in zip(*out):
        close(a, b)


# ---------------------------------------------------------------------------
# the autodiff NLML
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("F", [1, 3])
def test_nlml_autodiff_gradient(kernel, F):
    """Gradient of every parameter, rhos included, against jax.grad."""
    rng, X, fid, y = problem(4, F)
    raw = raw_params(rng, F)
    jv, jg = jax.value_and_grad(lambda p: jm.nlml(
        p, *jx(X, fid, y), kernel=kernel, jitter=JITTER))(
        jm.MFGPParams(*jx(*raw)))
    p = tm.MFGPParams(*(torch.tensor(a, requires_grad=True) for a in raw))
    v = tm.nlml(p, *tt(X, fid, y), kernel=kernel, jitter=JITTER)
    close(v, jv)
    # at F=1 the (empty) rhos do not enter the graph
    for g, h in zip(torch.autograd.grad(v, list(p), allow_unused=True,
                                        materialize_grads=True), jg):
        close(g, h)


def test_nlml_not_positive_definite():
    """A singular Gram (duplicated points, noise 1e-30): NaN on both sides,
    where the port used to raise."""
    rng, X, fid, y = problem(5, 3, N=20)
    X[10:] = X[:10]
    fid[10:] = fid[:10]
    raw = list(raw_params(rng, 3))
    raw[3] = np.full(3, np.log(1e-30))
    ref = jm.nlml(jm.MFGPParams(*jx(*raw)), *jx(X, fid, y))
    got = tm.nlml(tm.params_from_numpy(*raw, "cpu", torch.float64),
                  *tt(X, fid, y))
    assert np.isnan(float(ref)) and torch.isnan(got)


@pytest.mark.parametrize("kernel", KERNELS)
def test_nlml_value_grad_state(kernel):
    rng, X, fid, y = problem(6, 3)
    raw = raw_params(rng, 3)
    v0, g0, s0 = jm.nlml_value_grad_state(jm.MFGPParams(*jx(*raw)),
                                          *jx(X, fid, y), kernel=kernel,
                                          jitter=JITTER)
    v1, g1, s1 = tm.nlml_value_grad_state(
        tm.params_from_numpy(*raw, "cpu", torch.float64), *tt(X, fid, y),
        kernel=kernel, jitter=JITTER)
    close(v1, v0)
    for a, b in zip(g1, g0):
        close(a, b)
    close(s1.L, s0.L)
    close(s1.alpha, s0.alpha)


# ---------------------------------------------------------------------------
# the L-BFGS optimizers
# ---------------------------------------------------------------------------
def _quad(lib):
    w = lib.asarray([1.0, 3.0, 10.0, 30.0])
    return lambda x: lib.sum(w * (x - 1.5) ** 2)


def _rosen(lib):
    return lambda x: lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                             + (1.0 - x[:-1]) ** 2)


def _mixed(lib):
    return lambda x: (100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
                      + lib.sum(x[2:] ** 2))


LBFGS_CASES = {
    # lanes that converge at different iterations
    "quadratic": (_quad, lambda r: r.normal(size=(3, 4)),
                  dict(maxiter=100, tol=1e-8)),
    # projected onto an upper bound (the lanes run to maxiter there)
    "bounded": (_quad, lambda r: r.normal(size=(3, 4)),
                dict(maxiter=40, upper=1.0)),
    "rosenbrock": (_rosen, lambda r: np.stack([np.full(8, -1.2), np.zeros(8),
                                               r.normal(size=8)]),
                   dict(maxiter=500, tol=1e-10)),
    # a straggler that only the ftol stagnation stop ends
    "straggler_ftol": (_mixed, lambda r: np.stack([np.full(4, -1.2),
                                                   np.zeros(4)]),
                       dict(maxiter=400, tol=1e-12, ftol=1e-9)),
}


@pytest.mark.parametrize("case", sorted(LBFGS_CASES))
def test_batched_lbfgs_matches_vmap(case):
    """The explicit restart axis against JAX's vmapped single-lane loop:
    the same (x, f) and the same iteration count per lane."""
    fun, x0, kw = LBFGS_CASES[case]
    x0 = x0(np.random.default_rng(7))
    jkw, tkw = dict(kw), dict(kw)
    if "upper" in kw:
        jkw["upper"] = jnp.full(x0.shape[1], kw["upper"])
        tkw["upper"] = torch.full((x0.shape[1],), kw["upper"],
                                  dtype=torch.float64)
    xj, fj, kj = jax.vmap(lambda v: jopt.batched_lbfgs(fun(jnp), v, **jkw))(
        jnp.asarray(x0))
    xt, ft, kt = topt.batched_lbfgs(fun(torch), torch.as_tensor(x0), **tkw)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    close(xt, xj, rtol=FIT_RTOL, atol=1e-9)
    close(ft, fj, rtol=FIT_RTOL, atol=1e-12)
    assert len(set(kt.tolist())) > 1 or case == "bounded"


def test_scipy_lbfgsb_matches_jax():
    """The host optimizer on an autograd closure: same optimum, same number
    of evaluations; a non-finite value is the 1e20 penalty."""
    c = np.array([-3.0, 0.5, 1.0, 2.0])

    def fun(lib):
        # NaN left of -2 in the first coordinate, toward the unconstrained
        # minimum, so scipy's line searches meet the penalty
        return lambda x: lib.where(x[0] < -2.0, lib.nan, lib.sum(
            (x - lib.asarray(c)) ** 2 * lib.asarray([1.0, 2.0, 3.0, 4.0])))
    x0 = np.array([-1.0, 0.3, 2.0, -1.0])
    xj, fj, nj = jopt.scipy_lbfgsb(fun(jnp), x0)
    xt, ft, nt = topt.scipy_lbfgsb(
        topt.autograd_value_and_grad(fun(torch), torch.float64, "cpu"), x0)
    close(xt, xj, rtol=FIT_RTOL)
    close(ft, fj, rtol=FIT_RTOL)
    assert nt == nj
    vg = topt.autograd_value_and_grad(fun(torch), torch.float64, "cpu")
    assert np.isnan(vg(np.array([-3.0, 0, 0, 0]))[0])


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", KERNELS)
def test_mf_fit_restarts_matches_jax(kernel):
    """R=3 lanes from the same numpy inits; lane 2 starts at a variance of
    e^800, whose NLML is not finite (a stuck 1e20 lane on both sides)."""
    rng, X, fid, y = problem(8, 3)
    n = 3 + 9 + 3
    x0 = np.concatenate([np.zeros(3), np.log(np.full(9, 1.5)),
                         np.log(np.full(3, 0.1))])
    inits = x0 + 0.3 * rng.normal(size=(3, n))
    inits[2, 0] = 800.0
    lower, upper = np.full(n, -np.inf), np.full(n, np.inf)
    lower[3:12], upper[3:12] = np.log(1e-4), np.log(100.0)
    rhos = np.ones(2)
    xj, fj = jm._mf_fit_restarts(*jx(inits, X, fid, y, rhos, lower, upper),
                                 kernel, JITTER, 30, 1e-6)
    xt, ft = tm._mf_fit_restarts(*tt(inits, X, fid, y, rhos, lower, upper),
                                 kernel, JITTER, 30, 1e-6)
    close(xt, xj, rtol=FIT_RTOL, atol=1e-9)
    close(ft, fj, rtol=FIT_RTOL)
    assert float(ft[2]) == 1e20 and float(ft[0]) < 1e3


@pytest.mark.parametrize("fix_rhos", [True, False])
def test_mfgp_optimize_matches_jax(fix_rhos):
    """scipy on the autodiff NLML through the class, free rhos included:
    the same params and final NLML."""
    _, X, fid, y = problem(9, 3)
    kw = dict(kernel="rbf", jitter=JITTER)
    mj = jm.MFGP(X, fid, y, **kw)
    mt = tm.MFGP(X, fid, y, **kw)
    fj = mj.optimize(maxiter=25, fix_rhos=fix_rhos,
                     lengthscale_bounds=(1e-4, 100.0))
    ft = mt.optimize(maxiter=25, fix_rhos=fix_rhos,
                     lengthscale_bounds=(1e-4, 100.0))
    close(ft, fj, rtol=FIT_RTOL)
    close(mt.param_array, mj.param_array, rtol=FIT_RTOL, atol=1e-9)
    close(mt.log_likelihood(), mj.log_likelihood(), rtol=FIT_RTOL)
    if fix_rhos:
        assert mt.params.rhos.tolist() == [1.0, 1.0]


def _fidelity_lists(seed):
    rng = np.random.default_rng(seed)
    Xs = [rng.uniform(0, 10, (n, 3)) for n in (30, 0, 12)]
    ys = [(np.sin(x[:, 0]) + 0.3 * (2 - i)).reshape(-1, 1)
          for i, x in enumerate(Xs)]  # (N, 1) columns, as the reference
    return Xs, ys


def test_mfgp_class_surface_matches_jax():
    """from_fidelity_lists with an empty fidelity, (N, 1) y, predict
    before any fit, augmented inputs, predict_covariance, extend_data and
    the param_array round trip."""
    Xs, ys = _fidelity_lists(10)
    mj = jm.MFGP.from_fidelity_lists(Xs, ys, jitter=JITTER)
    mt = tm.MFGP.from_fidelity_lists(Xs, ys, jitter=JITTER)
    assert mt.X.shape == (42, 3) and mt.y.shape == (42,)
    np.testing.assert_array_equal(mt.fid.numpy(), np.asarray(mj.fid))
    for a, b in zip(tm.stack_fidelity_lists(Xs), jm.stack_fidelity_lists(Xs)):
        close(a, b)
    close(tm.augment(mt.X, 2), jm.augment(mj.X, 2))
    close(mt.log_likelihood(), mj.log_likelihood())
    rng = np.random.default_rng(11)
    Xq = rng.uniform(0, 10, (9, 3))
    for args in ((Xq,), (Xq, 1), (np.hstack([Xq, np.full((9, 1), 0.0)]),)):
        for a, b in zip(mt.predict(*args), mj.predict(*args)):
            close(a, b)
    close(mt.predict_covariance(Xq), mj.predict_covariance(Xq))
    for a, b in zip(mt.predict(Xq, block_size=4), mj.predict(Xq)):
        close(a, b)

    vec = np.array([1.2, 2.0, 1.5, 0.7, 0.4, 1.1, 1.3, 0.9, 0.8, 0.6, 1.7,
                    2.2, 0.9, 1.1, 0.1, 0.05, 0.01])
    mj.set_param_array(vec)
    mt.set_param_array(vec)
    close(mt.param_array, vec, rtol=1e-12)
    Xn = rng.uniform(0, 10, (5, 3))
    fn, yn = np.array([0, 2, 2, 1, 0]), np.sin(Xn[:, 0])
    mj.extend_data(Xn, fn, yn)
    mt.extend_data(Xn, fn, yn)
    close(mt.state.L, mj.state.L)
    for a, b in zip(mt.predict(Xq), mj.predict(Xq)):
        close(a, b)
    # extend_data equals conditioning on all the data at once
    full = tm.MFGP(mt.X, mt.fid, mt.y, jitter=JITTER)
    full.set_param_array(vec)
    for a, b in zip(full.predict(Xq), mt.predict(Xq)):
        close(a, b)


def test_optimize_restarts_behaviour(monkeypatch):
    """Row 0 of the inits is the current params, the best finite lane
    wins, and a seed repeats (torch draws cannot match jax.random's)."""
    _, X, fid, y = problem(12, 3, N=30)
    seen = []

    def fake(inits, *args):
        seen.append(inits.clone())
        fs = torch.tensor([float("nan"), 3.0, 2.0, float("inf")],
                          dtype=inits.dtype)
        return inits + 1.0, fs

    monkeypatch.setattr(tm, "_mf_fit_restarts", fake)
    m = tm.MFGP(X, fid, y)
    x0 = torch.cat([m.params.log_variances,
                    m.params.log_lengthscales.reshape(-1),
                    m.params.log_noises])
    assert m.optimize_restarts(n_restarts=4, seed=3) == 2.0
    assert torch.equal(seen[0][0], x0)
    close(torch.cat([m.params.log_variances,
                     m.params.log_lengthscales.reshape(-1),
                     m.params.log_noises]), seen[0][2] + 1.0)
    tm.MFGP(X, fid, y).optimize_restarts(n_restarts=4, seed=3)
    tm.MFGP(X, fid, y).optimize_restarts(n_restarts=4, seed=4)
    assert torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[0][1:], seen[2][1:])
    with pytest.raises(NotImplementedError, match="free rhos"):
        m.optimize_restarts(fix_rhos=False)


def test_optimize_restarts_improves():
    """The real restart fit: a lower NLML than the default params, rhos
    untouched, lengthscales inside their bounds."""
    _, X, fid, y = problem(13, 3, N=36)
    m = tm.MFGP(X, fid, y, jitter=1e-8)
    f0 = -m.log_likelihood()
    f = m.optimize_restarts(n_restarts=3, maxiter=40,
                            lengthscale_bounds=(1e-4, 100.0))
    assert f < f0
    close(-m.log_likelihood(), f, rtol=1e-9)
    assert m.params.rhos.tolist() == [1.0, 1.0]
    ls = m.params.lengthscales
    assert bool((ls >= 1e-4 - 1e-12).all() and (ls <= 100.0 + 1e-9).all())
