"""Parity of the port's NIGP (``mfgp_tpu_torch.models.nigp``) with
``mfgp_tpu.models.nigp`` on the CPU.

Both packages get the same numpy arrays (from a seed). In float64 values
agree to 1e-9 and autodiff gradients to 1e-7 (against ``jax.grad``); fits
from the same seed reach the same ``get_params()`` to 1e-5 (both draw their
restart points from ``np.random.default_rng(seed)``); predictions from
carried-over hyperparameters agree to 1e-8. In float32 the NLML is held
against JAX's Pallas route in interpret mode at 2e-4
(tests/test_pallas_kernels.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.models import nigp as jn
from mfgp_tpu.ops import covariance as jcov
from mfgp_tpu_torch.models import nigp as tn

CPU = "cpu"


def close(port, ref, tol):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def problem(seed=0, N=40, D=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 4, (N, D))
    y = np.sin(X).sum(1) + 0.1 * rng.normal(size=N)
    log_hyp = np.concatenate([np.log(rng.uniform(0.8, 1.6, D)),
                              [np.log(1.3), np.log(0.15)],
                              np.log(rng.uniform(0.05, 0.2, D))])
    return rng, X, y, log_hyp


def test_params_view():
    _, _, _, lh = problem()
    pt, pj = tn.NIGPParams(torch.as_tensor(lh)), jn.NIGPParams(jnp.asarray(lh))
    assert pt.D == pj.D == 3
    for name in ("lengthscales", "sigma_f", "sigma_y", "sigma_x"):
        close(getattr(pt, name), getattr(pj, name), 1e-12)


@pytest.mark.parametrize("with_noise", [False, True])
def test_posterior_mean_grads(with_noise):
    rng, X, y, lh = problem(1)
    nd = rng.uniform(0.0, 0.1, X.shape[0]) if with_noise else None
    ls, sf, sy = np.exp(lh[:3]), np.exp(lh[3]), np.exp(lh[4])
    ref = jn.posterior_mean_grads(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(ls), sf, sy,
                                  None if nd is None else jnp.asarray(nd))
    got = tn.posterior_mean_grads(torch.as_tensor(X), torch.as_tensor(y),
                                  torch.as_tensor(ls), sf, sy,
                                  None if nd is None else torch.as_tensor(nd))
    for g, r in zip(got, ref):
        close(g, r, 1e-9)


def test_nlml_values_and_gradients():
    """nlml (with and without the extra noise) and nlml_native: values
    1e-9, autodiff gradients 1e-7 against jax.grad."""
    rng, X, y, lh = problem(2)
    gf = rng.normal(size=X.shape)
    extra = rng.uniform(0, 0.05, X.shape[0])
    Xj, yj, Xt, yt = jnp.asarray(X), jnp.asarray(y), torch.as_tensor(X), \
        torch.as_tensor(y)
    cases = (
        (lambda h: jn.nlml(h, Xj, yj, jnp.asarray(gf)),
         lambda h: tn.nlml(h, Xt, yt, torch.as_tensor(gf))),
        (lambda h: jn.nlml(h, Xj, yj, jnp.asarray(gf), jnp.asarray(extra)),
         lambda h: tn.nlml(h, Xt, yt, torch.as_tensor(gf),
                           torch.as_tensor(extra))),
        (lambda h: jn.nlml_native(h, Xj, yj),
         lambda h: tn.nlml_native(h, Xt, yt)),
    )
    for fj, ft in cases:
        vj, gj = jax.value_and_grad(fj)(jnp.asarray(lh))
        h = torch.tensor(lh, requires_grad=True)
        vt = ft(h)
        gt, = torch.autograd.grad(vt, h)
        close(vt, vj, 1e-9)
        close(gt, gj, 1e-7)


def test_nlml_native_gradcheck():
    _, X, y, lh = problem(3, N=12)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    assert torch.autograd.gradcheck(
        lambda h: tn.nlml_native(h, Xt, yt),
        (torch.tensor(lh, requires_grad=True),), eps=1e-6, atol=1e-6,
        rtol=1e-5)


def test_nlml_float32_matches_pallas_route(monkeypatch):
    """float32: the port's NLML (plain forward here) against JAX's through
    the Pallas kernel in interpret mode, value and gradient at 2e-4
    relative to the largest entry."""
    rng, X, y, lh = problem(4, N=29)
    gf = rng.normal(size=X.shape).astype(np.float32)
    X32, y32, lh32 = (a.astype(np.float32) for a in (X, y, lh))
    monkeypatch.setattr(jcov, "use_pallas", lambda dtype, kernel: True)
    vj, gj = jax.value_and_grad(jn.nlml.__wrapped__)(
        jnp.asarray(lh32), jnp.asarray(X32), jnp.asarray(y32),
        jnp.asarray(gf))
    h = torch.tensor(lh32, requires_grad=True)
    vt = tn.nlml(h, torch.as_tensor(X32), torch.as_tensor(y32),
                 torch.as_tensor(gf))
    gt, = torch.autograd.grad(vt, h)
    assert vt.dtype == gt.dtype == torch.float32
    assert abs(float(vt.detach()) - float(vj)) <= 2e-4 * abs(float(vj))
    gj = np.asarray(gj)
    assert np.abs(gt.numpy() - gj).max() <= 2e-4 * np.abs(gj).max()


@pytest.mark.parametrize("N", [7, 8, 30])
def test_median_heuristic_matches_numpy(N):
    """Even and odd counts of positive distances, a duplicated point
    (distance 0 is left out), and row blocks smaller than the set."""
    rng = np.random.default_rng(N)
    X = rng.uniform(0, 5, (N, 3))
    X[1] = X[0]
    pair = np.sqrt(np.maximum(0, np.sum(
        (X[:, None, :] - X[None, :, :]) ** 2, axis=2)))
    ref = np.median(pair[pair > 0])
    assert (N * (N - 1) // 2 - 1) % 2 == (0 if N in (7, 30) else 1)
    for block in (1 << 25, 3 * N * 2):
        got = tn.median_pairwise_distance(torch.as_tensor(X), block)
        assert abs(got - ref) <= 1e-12 * ref
    assert tn.median_pairwise_distance(torch.zeros((4, 3))) == 1.0


def test_fit_matches_jax():
    """The alternating fit, 2 iterations x 2 restarts from the same seed:
    get_params() within 1e-5."""
    _, X, y, _ = problem(5, N=30)
    mj = jn.NIGP(n_restarts=2, iters=2, seed=3).fit(X, y, maxiter_opt=30)
    mt = tn.NIGP(n_restarts=2, iters=2, seed=3, device=CPU).fit(
        X, y, maxiter_opt=30)
    close(mt.get_params(), mj.get_params(), 1e-5)
    close(mt.noise_diag_train_, mj.noise_diag_train_, 1e-5)


def test_fit_native_matches_jax():
    """The native fit, 2 restarts from the same seed: get_params() within
    1e-5."""
    _, X, y, _ = problem(6, N=30)
    mj = jn.NIGP(n_restarts=2, seed=1).fit_native(X, y, maxiter=15)
    mt = tn.NIGP(n_restarts=2, seed=1, device=CPU).fit_native(X, y,
                                                              maxiter=15)
    close(mt.get_params(), mj.get_params(), 1e-5)
    close(mt.noise_diag_train_, mj.noise_diag_train_, 1e-5)


def test_zero_iteration_fit():
    """``NIGP(n_restarts=0, iters=0)``: conditioned at the heuristic init,
    equal to JAX's (the median heuristic included)."""
    _, X, y, _ = problem(7, N=25)
    mj = jn.NIGP(n_restarts=0, iters=0).fit(X, y)
    mt = tn.NIGP(n_restarts=0, iters=0, device=CPU).fit(X, y)
    close(mt.get_params(), mj.get_params(), 1e-12)
    assert float(mt.noise_diag_train_.abs().max()) == 0.0
    Xs = np.random.default_rng(0).uniform(0, 4, (9, 3))
    for a, b in zip(mt.predict(Xs), mj.predict(Xs)):
        close(a, b, 1e-8)


def carried(seed=8, N=35):
    """A JAX NIGP fitted briefly and the port's model carried over from
    its numpy attributes."""
    rng, X, y, _ = problem(seed, N=N)
    mj = jn.NIGP(n_restarts=1, iters=1, seed=0).fit(X, y, maxiter_opt=10)
    hyp = (mj.lengthscales_, mj.sigma_f_, mj.sigma_y_, mj.sigma_x_)
    mt = tn.nigp_from_numpy(hyp, X, y, np.asarray(mj.noise_diag_train_),
                            device=CPU)
    return rng, mj, mt


def test_predict_modes_from_carried_weights():
    """mean; mean + var; full cov; cov with test input noise of shape (D,)
    and (M, D); var with input noise; the ValueError; predict_blocked:
    1e-8."""
    rng, mj, mt = carried()
    Xs = rng.uniform(0, 4, (17, 3))
    close(mt.get_params(), mj.get_params(), 0)
    close(mt.predict(Xs, return_var=False), mj.predict(Xs, return_var=False),
          1e-8)
    modes = (dict(), dict(return_cov=True),
             dict(return_cov=True, Xs_input_noise=np.array([0.1, 0.2, 0.3])),
             dict(return_cov=True,
                  Xs_input_noise=rng.uniform(0.05, 0.3, (17, 3))),
             dict(Xs_input_noise=mj.sigma_x_))
    for kw in modes:
        got, ref = mt.predict(Xs, **kw), mj.predict(Xs, **kw)
        for a, b in zip(got, ref):
            assert isinstance(a, np.ndarray) and a.shape == np.shape(b)
            close(a, b, 1e-8)
    mu, cov = mt.predict(Xs, return_cov=True, as_numpy=False)
    assert isinstance(cov, torch.Tensor) and cov.shape == (17, 17)
    with pytest.raises(ValueError, match="Xs_input_noise"):
        mt.predict(Xs, return_cov=True, Xs_input_noise=np.ones((4, 3)))
    for kw in (dict(), dict(include_noise=True, block_size=5)):
        for a, b in zip(mt.predict_blocked(Xs, **kw),
                        mj.predict_blocked(Xs, **kw)):
            close(a, b, 1e-8)
    # blocked and direct marginal variances are the same posterior
    close(mt.predict_blocked(Xs)[1], mt.predict(Xs)[1], 1e-8)


def test_carried_from_log_hyp_and_caches():
    """``nigp_from_numpy`` also takes the log-space vector; a refit drops
    the cached factor."""
    _, X, y, lh = problem(9, N=20)
    m = tn.nigp_from_numpy(lh, X, y, device=CPU)
    close(m.get_params(), np.concatenate([np.exp(lh[5:]), np.exp(lh[3:5]),
                                          np.exp(lh[:3])]), 1e-15)
    assert m.noise_diag_train_ is None
    L1, _ = m._condition()
    assert m._condition()[0] is L1 and m._condition_inv()[0].shape == (20, 20)
    m.fit_native(X, y, n_restarts=1, maxiter=2)
    assert m._cond_cache is None and m._cond_inv_cache is None
    assert m.X_train_.dtype == torch.float64
    m32 = tn.NIGP(n_restarts=0, iters=0, device=CPU).fit(
        X.astype(np.float32), y)
    assert m32.X_train_.dtype == m32.y_train_.dtype == torch.float32
