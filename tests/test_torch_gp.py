"""Parity of the port's single-fidelity GP (``mfgp_tpu_torch.models.gp``)
with ``mfgp_tpu.models.gp`` on the CPU.

Both packages get the same numpy arrays (from a seed); parameters cross
with ``gp_params_from_numpy``, fitted models with ``set_param_array``. In
float64 values, gradients and posteriors agree to rtol 1e-7, fits to rtol
1e-6; ``sf_cov_diff``'s Function is held against JAX's custom VJP with the
Pallas forward in interpret mode in float32 at 2e-4.

Routing note: on a CUDA float32 problem the port assembles the Gram of the
analytic gradient through B1 and takes its gradient from B2 at F=1; on the
CPU both run their plain versions, which is what is compared here (the
kernels are held against those on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.models import gp as jg
from mfgp_tpu.ops import covariance as jcov
from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.ops import covariance as tcov

RTOL, ATOL = 1e-7, 1e-9
FIT_RTOL = 1e-6
JITTER = 1e-6
KERNELS = ["rbf", "matern32"]
RAW = (np.log(1.3), np.log([1.0, 2.0, 0.7]), np.log(0.05))


def close(port, ref, rtol=RTOL, atol=ATOL):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def data(seed, n=50, d=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 6, (n, d))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(0.7 * X[:, 1]) + 0.05 * rng.normal(
        size=n)
    return rng, X, y


def params(raw=RAW):
    return (jg.GPParams(*(jnp.asarray(a) for a in raw)),
            tg.gp_params_from_numpy(*raw, "cpu", torch.float64))


@pytest.mark.parametrize("kernel", KERNELS)
def test_sf_cov_diff(kernel, monkeypatch):
    """The plain autograd path in float64, and the Function (forced, its
    plain forward here) in float32 against JAX's custom VJP around the
    Pallas forward in interpret mode."""
    rng, X, _ = data(0, n=19)
    R = rng.normal(size=(19, 19))
    ls = np.array([1.1, 0.9, 1.4])
    loss = {lib: (lambda K, lib=lib: lib.sum(lib.asarray(R, dtype=K.dtype)
                                             * K)) for lib in (jnp, torch)}
    ref = jax.grad(lambda v, l: loss[jnp](jcov.sf_cov_diff(
        v, l, jnp.asarray(X), kernel)), argnums=(0, 1))(1.7, jnp.asarray(ls))
    args = [torch.tensor(a, requires_grad=True) for a in (1.7, ls)]
    got = torch.autograd.grad(loss[torch](tcov.sf_cov_diff(
        *args, torch.as_tensor(X), kernel)), args)
    for g, h in zip(got, ref):
        close(g, h)

    monkeypatch.setattr(jcov, "use_pallas", lambda *a: True)
    monkeypatch.setattr(tcov, "use_cuda_kernels", lambda *a: True)
    X32, ls32 = X.astype(np.float32), ls.astype(np.float32)
    ref = jax.grad(lambda v, l: loss[jnp](jcov.sf_cov_diff(
        v, l, jnp.asarray(X32), kernel)), argnums=(0, 1))(
        jnp.float32(1.7), jnp.asarray(ls32))
    args = [torch.tensor(a, requires_grad=True)
            for a in (np.float32(1.7), ls32)]
    K = tcov.sf_cov_diff(*args, torch.as_tensor(X32), kernel)
    assert K.grad_fn.name() == "_AR1TrainCovBackward"
    got = torch.autograd.grad(loss[torch](K), args)
    for g, h in zip(got, ref):
        close(g, h, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kernel", KERNELS)
def test_nlml_autodiff_gradient(kernel):
    """The autodiff NLML, with a per-point extra noise (the NIGP's)."""
    rng, X, y = data(1)
    extra = rng.uniform(0.0, 0.01, X.shape[0])
    jp, _ = params()
    jv, jgr = jax.value_and_grad(lambda p: jg.nlml(
        p, jnp.asarray(X), jnp.asarray(y), jnp.asarray(extra), kernel=kernel,
        jitter=JITTER))(jp)
    tp = tg.GPParams(*(torch.tensor(np.asarray(a), requires_grad=True)
                       for a in RAW))
    tv = tg.nlml(tp, torch.as_tensor(X), torch.as_tensor(y),
                 torch.as_tensor(extra), kernel=kernel, jitter=JITTER)
    close(tv, jv)
    for g, h in zip(torch.autograd.grad(tv, list(tp)), jgr):
        close(g, h)


def test_nlml_not_positive_definite():
    _, X, y = data(2, n=20)
    X[10:] = X[:10]
    raw = (RAW[0], RAW[1], np.log(1e-30))
    jp, tp = params(raw)
    assert np.isnan(float(jg.nlml(jp, jnp.asarray(X), jnp.asarray(y))))
    assert torch.isnan(tg.nlml(tp, torch.as_tensor(X), torch.as_tensor(y)))


@pytest.mark.parametrize("kernel", KERNELS)
def test_value_and_grad_with_extra_noise(kernel):
    """The analytic gradient (the port's F=1 MFGP core, the route that
    reaches B2 at F=1 on the card) with a per-point extra noise, against
    the JAX package's."""
    rng, X, y = data(3)
    extra = rng.uniform(0.0, 0.01, X.shape[0])
    jp, tp = params()
    kw = dict(kernel=kernel, jitter=JITTER)
    v1, g1 = tg.nlml_value_and_grad(
        tp, *(torch.as_tensor(a) for a in (X, y, extra)), **kw)
    v0, g0 = jg.nlml_value_and_grad(
        jp, *(jnp.asarray(a) for a in (X, y, extra)), **kw)
    close(v1, v0)
    for a, b in zip(g1, g0):
        close(a, b)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("jax_route", [None, "highest"])
def test_value_grad_state(kernel, jax_route):
    """The analytic gradient with its state against either route of the
    JAX package: K^-1 by blocked solves (``inv_mode=None``) or its own
    inverse factor (``"highest"``), whose Linv the port's must equal."""
    _, X, y = data(3)
    jp, tp = params()
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    kw = dict(kernel=kernel, jitter=JITTER)
    v1, g1, s1 = tg.nlml_value_grad_state_inv(tp, Xt, yt, **kw)
    v0, g0, s0 = jg.nlml_value_grad_state_inv(jp, Xj, yj, **kw,
                                              inv_mode=jax_route)
    if jax_route is not None:
        close(s1.Linv, s0.Linv)
    close(v1, v0)
    for a, b in zip(g1, g0):
        close(a, b)
    close(s1.alpha, s0.alpha)


@pytest.mark.parametrize("kernel", KERNELS)
def test_condition_predict(kernel):
    rng, X, y = data(4)
    Xs = rng.uniform(0, 6, (23, 3))
    jp, tp = params()
    Xj, yj, Sj = (jnp.asarray(a) for a in (X, y, Xs))
    Xt, yt, St = (torch.as_tensor(a) for a in (X, y, Xs))
    sj = jg.condition(jp, Xj, yj, kernel=kernel, jitter=JITTER)
    st = tg.condition(tp, Xt, yt, kernel=kernel, jitter=JITTER)
    close(st.L, sj.L)
    for full_cov in (False, True):
        for include_noise in (False, True):
            for a, b in zip(
                    tg.predict(tp, st, St, kernel, full_cov, include_noise),
                    jg.predict(jp, sj, Sj, kernel, full_cov, include_noise)):
                close(a, b)
    for a, b in zip(tg.predict_blocked(tp, st, St, kernel, block_size=8),
                    jg.predict_blocked(jp, sj, Sj, kernel, block_size=8)):
        close(a, b)
    _, _, si = jg.nlml_value_grad_state_inv(jp, Xj, yj, kernel=kernel,
                                            jitter=JITTER)
    _, _, ti = tg.nlml_value_grad_state_inv(tp, Xt, yt, kernel=kernel,
                                            jitter=JITTER)
    for a, b in zip(tg.predict_blocked_inv(tp, ti, St, kernel, block_size=8),
                    jg.predict_blocked_inv(jp, si, Sj, kernel,
                                           block_size=8)):
        close(a, b)


@pytest.mark.parametrize("kernel", KERNELS)
def test_fit_restarts_matches_jax(kernel):
    """R=3 lanes from the same numpy inits, lane 2 from a non-finite NLML
    (variance e^800): the same (x, f) per lane."""
    rng, X, y = data(5, n=60)
    x0 = np.array([0.0, 0.3, 0.3, 0.3, np.log(0.1)])
    inits = x0 + 0.3 * rng.normal(size=(3, 5))
    inits[2, 0] = 800.0
    xj, fj = jg._fit_restarts(jnp.asarray(inits), jnp.asarray(X),
                              jnp.asarray(y), kernel, JITTER, 40, 1e-6)
    xt, ft = tg._fit_restarts(torch.as_tensor(inits), torch.as_tensor(X),
                              torch.as_tensor(y), kernel, JITTER, 40, 1e-6)
    close(xt, xj, rtol=FIT_RTOL, atol=1e-9)
    close(ft, fj, rtol=FIT_RTOL)
    assert float(ft[2]) == 1e20 and float(ft[0]) < 1e3


@pytest.mark.parametrize("kernel", KERNELS)
def test_gp_optimize_matches_jax(kernel):
    """scipy on the autodiff NLML through the class: same params and
    NLML."""
    _, X, y = data(6, n=40)
    gj = jg.GP(X, y, kernel=kernel, jitter=JITTER)
    gt = tg.GP(X, y, kernel=kernel, jitter=JITTER, device="cpu")
    close(gt.optimize(maxiter=25), gj.optimize(maxiter=25), rtol=FIT_RTOL)
    close(gt.param_array, gj.param_array, rtol=FIT_RTOL, atol=1e-9)
    close(gt.log_likelihood(), gj.log_likelihood(), rtol=FIT_RTOL)


def test_gp_class_surface_matches_jax():
    """(N, 1) y, predict before any fit (GPy's defaults), full_cov,
    extend_data (equal to conditioning on all the data at once), set_XY
    and the param_array round trip."""
    rng, X, y = data(7, n=30)
    Xq = rng.uniform(0, 6, (11, 3))
    gj = jg.GP(X, y.reshape(-1, 1), jitter=JITTER)
    gt = tg.GP(X, y.reshape(-1, 1), jitter=JITTER, device="cpu")
    assert gt.y.shape == (30,)
    close(gt.log_likelihood(), gj.log_likelihood())
    for kw in ({}, {"full_cov": True}, {"include_noise": False},
               {"block_size": 4}):
        for a, b in zip(gt.predict(Xq, **kw), gj.predict(Xq, **kw)):
            close(a, b)
    vec = np.array([2.0, 1.1, 2.2, 3.3, 0.05])
    gj.set_param_array(vec)
    gt.set_param_array(vec)
    close(gt.param_array, vec, rtol=1e-12)
    Xn, yn = rng.uniform(0, 6, (7, 3)), rng.normal(size=7)
    gj.extend_data(Xn, yn)
    gt.extend_data(Xn, yn)
    close(gt.state.L, gj.state.L)
    for a, b in zip(gt.predict(Xq), gj.predict(Xq)):
        close(a, b)
    full = tg.GP(gt.X, gt.y, jitter=JITTER)
    full.set_param_array(vec)
    for a, b in zip(full.predict(Xq), gt.predict(Xq)):
        close(a, b)
    gt.set_XY(X[:10], y[:10])
    gj.set_XY(X[:10], y[:10])
    close(gt.log_likelihood(), gj.log_likelihood())


def test_optimize_restarts_behaviour(monkeypatch):
    """Row 0 of the inits is the current params, the best finite lane wins,
    a seed repeats; and the real fit lowers the NLML."""
    _, X, y = data(8, n=30)
    g = tg.GP(X, y, jitter=1e-8, device="cpu")
    f0 = -g.log_likelihood()
    f = g.optimize_restarts(n_restarts=3, maxiter=40, seed=1)
    assert f < f0
    close(-g.log_likelihood(), f, rtol=1e-9)

    seen = []

    def fake(inits, *args):
        seen.append(inits.clone())
        return inits + 1.0, torch.tensor([float("nan"), 3.0, 2.0])

    monkeypatch.setattr(tg, "_fit_restarts", fake)
    g = tg.GP(X, y, device="cpu")
    x0 = g.params.to_vector().log()
    assert g.optimize_restarts(n_restarts=3, seed=5) == 2.0
    close(seen[0][0], x0)
    close(g.params.to_vector().log(), seen[0][2] + 1.0)
    tg.GP(X, y, device="cpu").optimize_restarts(n_restarts=3, seed=5)
    assert torch.equal(seen[0], seen[1])
