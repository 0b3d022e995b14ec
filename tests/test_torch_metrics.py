"""Parity of the port's metrics (``mfgp_tpu_torch.metrics``) with
``mfgp_tpu.metrics`` on the CPU, in float64.

Every public function of the four modules (ergodic, fourier, eid,
info_gain) gets the same seeded numpy inputs in both packages; results
agree to 1e-9 relative or 1e-12 absolute. The lane axis (one candidate
per lane) is held against ``jax.vmap`` of the JAX function, and each lane
against the port's own single-lane call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu import metrics as jmet
from mfgp_tpu.metrics import eid as jeid
from mfgp_tpu.metrics import ergodic as jerg
from mfgp_tpu.metrics import fourier as jfou
from mfgp_tpu.metrics import info_gain as jig
from mfgp_tpu_torch import metrics as tmet
from mfgp_tpu_torch.metrics import eid as teid
from mfgp_tpu_torch.metrics import ergodic as terg
from mfgp_tpu_torch.metrics import fourier as tfou
from mfgp_tpu_torch.metrics import info_gain as tig

RTOL, ATOL = 1e-9, 1e-12


def close(port, ref, rtol=RTOL, atol=ATOL):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def t(a):
    return torch.tensor(np.asarray(a))


def trajectories(seed, B=3, T=17, d=3):
    """B seeded trajectories (t (B, T), x (B, T, d)), a (B, T) mask with
    padding at the end of some lanes, and a (G, d) grid."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.5, 2.0, (B, T)), axis=1)
    x = rng.uniform(0, 5, (B, T, d))
    lengths = [T, T - 5, 4][:B]
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    grid = rng.uniform(0, 5, (40, d))
    return rng, times, x, mask, grid


def spd(rng, B, P, jitter=0.5):
    A = rng.normal(size=(B, P, P))
    return A @ np.swapaxes(A, -1, -2) / P + jitter * np.eye(P)


# ---------------------------------------------------------------------------
# ergodic
# ---------------------------------------------------------------------------
def test_softmax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=23) * 50.0  # the raw exp would overflow
    close(terg.softmax(t(a)), jerg.softmax(a))
    A = rng.normal(size=(4, 23))
    close(terg.softmax(t(A)), jax.vmap(jerg.softmax)(A))


def test_config_grid():
    specs = [(0.0, 10.0, 4), (0.0, 20.0, 5), (0.0, 3.0, 3)]
    for got, want in zip(terg.config_grid(*specs), jerg.config_grid(*specs)):
        close(got, want, 0, 0)


@pytest.mark.parametrize("per_point", [False, True])
def test_gaussian_sensor(per_point):
    rng, _, x, _, _ = trajectories(2)
    sig = (rng.uniform(0.1, 1.0, x.shape[1:]) if per_point
           else np.array([0.25, 0.5, 1.5]))
    s = rng.uniform(0, 5, 3)
    close(terg.gaussian_sensor(t(x[0]), t(s), t(sig)),
          jerg.gaussian_sensor(x[0], s, sig))
    close(terg.gaussian_sensor(t(x), t(s), t(sig)),
          jax.vmap(lambda xi: jerg.gaussian_sensor(xi, s, sig))(x))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("parity_drop_last", [False, True])
@pytest.mark.parametrize("per_point", [False, True])
def test_trajectory_distribution(masked, parity_drop_last, per_point):
    """Single path and lanes, with and without the padding mask, the
    reference's dropped last cell, shared or per-point sensor variances."""
    rng, times, x, mask, grid = trajectories(3)
    sig = (rng.uniform(0.2, 1.0, x.shape) if per_point
           else np.array([0.25, 0.5, 1.0]))
    m = mask if masked else None

    def ref(i):
        return jerg.trajectory_distribution(
            times[i], x[i], grid, sig[i] if per_point else sig,
            mask=None if m is None else m[i],
            parity_drop_last=parity_drop_last)

    lanes = terg.trajectory_distribution(
        t(times), t(x), t(grid), t(sig), mask=None if m is None else t(m),
        parity_drop_last=parity_drop_last)
    assert lanes.shape == (3, 40)
    for i in range(3):
        close(lanes[i], ref(i))
        one = terg.trajectory_distribution(
            t(times[i]), t(x[i]), t(grid), t(sig[i] if per_point else sig),
            mask=None if m is None else t(m[i]),
            parity_drop_last=parity_drop_last)
        close(one, ref(i))
    if parity_drop_last:
        assert bool((lanes[:, -1] == 0).all())


def test_kl_divergence():
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 1, 30)
    p[[3, 7]] = 0.0  # zero entries of p contribute nothing
    q = rng.uniform(0.01, 1, 30)
    close(terg.kl_divergence(t(p), t(q)), jerg.kl_divergence(p, q))
    Q = rng.uniform(0.01, 1, (5, 30))
    close(terg.kl_divergence(t(Q), t(p)),
          jax.vmap(lambda qi: jerg.kl_divergence(qi, p))(Q))


def test_combined_trajectory_distribution():
    rng = np.random.default_rng(5)
    q1, q2 = rng.uniform(0, 1, 12), rng.uniform(0, 1, 12)
    close(terg.combined_trajectory_distribution(3.0, 7.5, t(q1), t(q2)),
          jerg.combined_trajectory_distribution(3.0, 7.5, q1, q2))


# ---------------------------------------------------------------------------
# fourier
# ---------------------------------------------------------------------------
def kset():
    return jfou.config_k((4, 1.0), (3, 2.0), (2, 0.5))


def test_config_k_norms_weights():
    specs = [(4, 1.0), (3, 2.0), (2, 0.5)]
    close(tfou.config_k(*specs), jfou.config_k(*specs), 0, 0)
    k = kset()
    close(tfou.basis_norms(t(k)), jfou.basis_norms(k))
    close(tfou.sobolev_weights(t(k)), jfou.sobolev_weights(k))


def test_fourier_basis_and_coefficients():
    rng = np.random.default_rng(6)
    k = kset()
    x = rng.uniform(0, 1, (3, 21, 3))
    w = rng.uniform(0, 1, 21)
    close(tfou.fourier_basis(t(x[0]), t(k)), jfou.fourier_basis(x[0], k))
    close(tfou.fourier_basis(t(x), t(k)),
          jax.vmap(lambda xi: jfou.fourier_basis(xi, k))(x))
    hk = jfou.basis_norms(k)
    close(tfou.fourier_coefficients(t(x[0]), t(w), t(k)),
          jfou.fourier_coefficients(x[0], w, k))
    close(tfou.fourier_coefficients(t(x[0]), t(w[:, None]), t(k),
                                    t(hk)),
          jfou.fourier_coefficients(x[0], w[:, None], k, hk))
    close(tfou.fourier_coefficients(t(x), t(np.ones((3, 21))), t(k)),
          jax.vmap(lambda xi: jfou.fourier_coefficients(
              xi, np.ones(21), k))(x))


def test_merge_and_sobolev_norm():
    rng = np.random.default_rng(7)
    k = kset()
    c1, c2 = rng.normal(size=k.shape[0]), rng.normal(size=k.shape[0])
    close(tfou.merge_coefficients(t(c1), t(c2), 2.0, 5.0),
          jfou.merge_coefficients(c1, c2, 2.0, 5.0))
    close(tfou.sobolev_norm(t(c1), t(c2), t(k)),
          jfou.sobolev_norm(c1, c2, k))
    C1 = rng.normal(size=(4, k.shape[0]))
    close(tfou.sobolev_norm(t(C1), t(c2), t(k)),
          jax.vmap(lambda ci: jfou.sobolev_norm(ci, c2, k))(C1))


# ---------------------------------------------------------------------------
# eid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("guard", ["uniform", "clamp"])
@pytest.mark.parametrize("negative", [False, True])
def test_expected_information_density(auto, guard, negative):
    """The fixed and the auto alpha, both negative-variance guards, with
    and without a negative variance on the grid."""
    rng = np.random.default_rng(8)
    mu = rng.normal(size=60) * 3.0
    sig = rng.uniform(0.05, 2.0, 60)
    if negative:
        sig[[4, 31]] = -1e-3
    got = teid.expected_information_density(t(mu), t(sig), 2.5, auto=auto,
                                            neg_var_guard=guard)
    want = jeid.expected_information_density(mu, sig, 2.5, auto=auto,
                                             neg_var_guard=guard)
    close(got, want)
    close(torch.sum(got), 1.0)
    if negative and guard == "uniform":
        close(got, np.full(60, 1 / 60), 1e-15, 0)


def test_eid_grid():
    WS = [[0.0, 10.0], [0.0, 20.0]]
    close(teid.eid_grid(WS, 10.0), jeid.eid_grid(WS, 10.0), 0, 0)
    close(teid.eid_grid(WS, 10.0, nums=(10, 6, 5)),
          jeid.eid_grid(WS, 10.0, nums=(10, 6, 5)), 0, 0)


# ---------------------------------------------------------------------------
# info_gain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_sequential_gain_from_cov(first, masked):
    """Both settings of ``first_self_conditioned``, with and without a
    mask; lanes against ``jax.vmap`` and each lane against its own call."""
    rng, _, _, mask, _ = trajectories(9, T=11)
    S = spd(rng, 3, 11)
    m = mask if masked else None
    kw = dict(first_self_conditioned=first, factor=0.7)
    got = tig.sequential_gain_from_cov(t(S), 0.05, mask=None if m is None
                                       else t(m), **kw)
    for i in range(3):
        want = jig.sequential_gain_from_cov(
            S[i], 0.05, mask=None if m is None else m[i], **kw)
        close(got[i], want)
        close(tig.sequential_gain_from_cov(
            t(S[i]), 0.05, mask=None if m is None else t(m[i]), **kw), want)


@pytest.mark.parametrize("masked", [False, True])
def test_sequential_gain_cross(masked):
    rng, _, _, mask, _ = trajectories(10, T=9)
    C = spd(rng, 3, 9)
    Spc = rng.normal(size=(3, 9, 9)) * 0.1
    spp = rng.uniform(1.0, 2.0, (3, 9))
    m = mask if masked else None
    got = tig.sequential_gain_cross(t(spp), t(Spc), t(C), 0.1, 0.05,
                                    factor=1.3,
                                    mask=None if m is None else t(m))
    for i in range(3):
        close(got[i], jig.sequential_gain_cross(
            spp[i], Spc[i], C[i], 0.1, 0.05, factor=1.3,
            mask=None if m is None else m[i]))


def test_logdet_batch_gain_and_exact_mi():
    rng = np.random.default_rng(11)
    K = spd(rng, 3, 12)
    Sp = spd(rng, 3, 12, jitter=0.2)
    close(tig.logdet(t(K)), jax.vmap(jig.logdet)(K))
    close(tig.batch_logdet_gain(t(K[0]), t(Sp[0])),
          jig.batch_logdet_gain(K[0], Sp[0]))
    close(tig.batch_logdet_gain(t(K), t(Sp)),
          jax.vmap(jig.batch_logdet_gain)(K, Sp))
    close(tig.exact_mutual_information(t(K[1]), 0.1),
          jig.exact_mutual_information(K[1], 0.1))
    close(tig.exact_mutual_information(t(K), 0.1),
          jax.vmap(lambda k: jig.exact_mutual_information(k, 0.1))(K))


def test_failed_cholesky_scores_nan_alone():
    """A lane whose covariance is not positive definite scores NaN; the
    other lanes keep their scores (as under ``jax.vmap``)."""
    rng = np.random.default_rng(12)
    S = spd(rng, 3, 6)
    S[1] = -np.eye(6) * 5.0  # + sig_n still negative definite
    got = tig.sequential_gain_from_cov(t(S), 0.05).numpy()
    want = np.asarray(jax.vmap(lambda s: jig.sequential_gain_from_cov(
        s, 0.05))(S))
    assert np.isnan(got[1]) and np.isnan(want[1])
    close(got[[0, 2]], want[[0, 2]])


def test_package_reexports():
    """``mfgp_tpu_torch.metrics`` re-exports the JAX package's names, the
    error metrics from the port's ``ops.linalg``."""
    from mfgp_tpu_torch.ops import linalg as tla

    names = [n for n in dir(jmet) if not n.startswith("_")
             and callable(getattr(jmet, n))]
    missing = [n for n in names if not hasattr(tmet, n)]
    assert not missing, missing
    assert tmet.rmse is tla.rmse and tmet.weighted_mse is tla.weighted_mse
    err = np.random.default_rng(13).normal(size=8)
    close(tmet.rmse(t(err)), jmet.rmse(jnp.asarray(err)))
