"""Parity of the port's ``RecursiveMFGP`` with ``mfgp_tpu``'s on the CPU in
float64: both residual modes, an empty level, free rhos, the posterior at
each level, ``param_array``. After a fit from the same seed everything
agrees to 1e-6. ``jax.random`` streams cannot be drawn in torch, so the
port's restart points are JAX's own draws for the fit's seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.models import mfgp_recursive as jr
from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.models import mfgp_recursive as tr

TOL = 1e-6


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.fixture
def jax_restart_draws(monkeypatch):
    """The port's ``GP.optimize_restarts`` starts from the points JAX's
    draws for the same seed."""
    def inits(x0, n_restarts, spread, seed):
        draws = np.asarray(jax.random.normal(
            jax.random.key(seed), (n_restarts, x0.shape[0]), jnp.float64))
        out = x0[None, :] + spread * torch.as_tensor(draws).to(x0)
        out[0] = x0
        return out

    monkeypatch.setattr(tg, "restart_inits", inits)


def lists(seed=0, sizes=(30, 18, 10), nested=False):
    rng = np.random.default_rng(seed)
    Xs, ys = [], []
    for m, n in enumerate(sizes):
        X = (Xs[-1][:n].copy() if nested and Xs
             else rng.uniform(0, 4, (n, 2)))
        Xs.append(X)
        ys.append(np.sin(X).sum(1) * (1 + 0.2 * m) + 0.3 * m
                  + 0.05 * rng.normal(size=n))
    return rng, Xs, ys


def both(Xs, ys, **kw):
    return (jr.RecursiveMFGP.from_fidelity_lists(Xs, ys, **kw),
            tr.RecursiveMFGP.from_fidelity_lists(Xs, ys, device="cpu", **kw))


def agree(mj, mt, Xq):
    close(mt.param_array, mj.param_array)
    close(mt.rhos, mj.rhos)
    for level in range(mj.F):
        for noise in (True, False):
            got = mt.predict(Xq, level=level, include_noise=noise)
            ref = mj.predict(Xq, level=level, include_noise=noise)
            for a, b in zip(got, ref):
                assert isinstance(a, np.ndarray)
                close(a, b)
    for a, b in zip(mt.predict(Xq), mj.predict(Xq)):
        close(a, b)


@pytest.mark.parametrize("mode,nested", [("posterior_mean", False),
                                         ("observed", True)])
def test_fit_matches_jax(jax_restart_draws, mode, nested):
    rng, Xs, ys = lists(1, nested=nested)
    mj, mt = both(Xs, ys, residual_mode=mode)
    Xq = rng.uniform(0, 4, (11, 2))
    agree(mj, mt, Xq)  # before any fit: default hyperparameters
    mj.optimize(n_restarts=2, maxiter=12, seed=3)
    mt.optimize(n_restarts=2, maxiter=12, seed=3)
    agree(mj, mt, Xq)
    for m in range(3):
        close(mt._level_residuals(m), mj._level_residuals(m))


def test_free_rhos_and_empty_level(jax_restart_draws):
    """``fix_rhos=False`` estimates the couplings; a level without points
    predicts zero and is skipped by the fit."""
    rng, Xs, ys = lists(2, sizes=(25, 0, 12))
    mj, mt = both(Xs, ys, fix_rhos=False)
    assert mt.levels[1] is None
    mj.optimize(n_restarts=2, maxiter=10)
    mt.optimize(n_restarts=2, maxiter=10)
    agree(mj, mt, rng.uniform(0, 4, (7, 2)))
    rng, Xs, ys = lists(3)
    mj, mt = both(Xs, ys, fix_rhos=False, kernel="matern32")
    mj.optimize(n_restarts=1, maxiter=10)
    mt.optimize(n_restarts=1, maxiter=10)
    assert not np.allclose(mt.rhos, 1.0)
    agree(mj, mt, rng.uniform(0, 4, (7, 2)))


def test_set_param_array_carries_a_fit_over():
    """A JAX fit's ``param_array`` set on an unfitted port model gives
    JAX's posterior."""
    rng, Xs, ys = lists(4, sizes=(20, 0, 9))
    mj, mt = both(Xs, ys)
    mj.optimize(n_restarts=1, maxiter=8)
    mt.set_param_array(mj.param_array)
    agree(mj, mt, rng.uniform(0, 4, (6, 2)))
    assert mt.levels[0].X.dtype == torch.float64


def test_float32_levels():
    _, Xs, ys = lists(5)
    m = tr.RecursiveMFGP.from_fidelity_lists(Xs, ys, device="cpu",
                                             dtype=torch.float32)
    assert all(lvl.X.dtype == torch.float32 for lvl in m.levels)
    mu, var = m.predict(Xs[2])
    assert mu.dtype == np.float64 and np.isfinite(mu).all() and (var > 0).all()
