"""Parity of the port's AR1 MFGP core (``mfgp_tpu_torch.models.mfgp``)
with ``mfgp_tpu.models.mfgp`` on the CPU in float64.

Both packages get the same numpy arrays (from a seed); parameters and
states are carried across with ``params_from_numpy`` /
``state_inv_from_numpy``. Same mathematics in the same precision: rtol 1e-7,
atol 1e-9. Sizes are small and ragged (N=90, M=37).

Routing note: on a CUDA float32 problem the port assembles the training
Gram of ``_nlml_vg_core`` through its B1 kernel (``ar1_cov_fused``), where
the JAX package uses an XLA composition of the same mathematics. On the CPU
both run the plain composition, which is what these tests compare; the
kernel is held against that composition on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.models import mfgp as jm
from mfgp_tpu_torch.models import mfgp as tm

RTOL, ATOL = 1e-7, 1e-9
JITTER = 1e-6


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def close_params(port: tm.MFGPParams, ref: jm.MFGPParams):
    for p, r in zip(port, ref):
        close(p, r)


def problem(seed: int, F: int, N: int = 90, M: int = 37, D: int = 3):
    """(jax inputs, torch inputs) of one AR1 problem; params are
    (log_variances, log_lengthscales, rhos, log_noises)."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    fid = rng.integers(0, F, N).astype(np.int32)
    y = rng.normal(size=N)
    Xs = rng.random((M, D)) * 4
    fid_s = np.full(M, F - 1, np.int32)
    raw = (np.log([1.4, 0.9, 0.6][:F]),
           np.log(rng.uniform(0.8, 1.8, (F, D))),
           np.array([0.9, 0.8][:F - 1]),
           np.log([0.05, 0.03, 0.02][:F]))
    jax_in = (jm.MFGPParams(*(jnp.asarray(a) for a in raw)),
              *(jnp.asarray(a) for a in (X, fid, y, Xs, fid_s)))
    torch_in = (tm.params_from_numpy(*raw, "cpu", torch.float64),
                torch.as_tensor(X), torch.as_tensor(fid, dtype=torch.long),
                torch.as_tensor(y), torch.as_tensor(Xs),
                torch.as_tensor(fid_s, dtype=torch.long))
    return jax_in, torch_in


def test_params_vector_layout():
    (jp, *_), (tp, *_) = problem(0, 3)
    close(tp.to_vector(), jp.to_vector())
    assert tp.to_vector().shape == (17,)
    close_params(tm.MFGPParams.from_vector(tp.to_vector(), 3, 3),
                 jm.MFGPParams.from_vector(jp.to_vector(), 3, 3))


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
def test_nlml_and_gradient(kernel, F):
    (jp, X, fid, y, _, _), (tp, Xt, ft, yt, _, _) = problem(1, F)
    close(tm.nlml(tp, Xt, ft, yt, kernel=kernel, jitter=JITTER),
          jm.nlml(jp, X, fid, y, kernel=kernel, jitter=JITTER))
    v1, g1 = tm.nlml_value_and_grad(tp, Xt, ft, yt, kernel=kernel,
                                    jitter=JITTER)
    v0, g0 = jm.nlml_value_and_grad(jp, X, fid, y, kernel=kernel,
                                    jitter=JITTER)
    close(v1, v0)
    close_params(g1, g0)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("inv_mode", [None, "highest"])
def test_value_grad_state_inv(kernel, inv_mode):
    (jp, X, fid, y, _, _), (tp, Xt, ft, yt, _, _) = problem(2, 3)
    v1, g1, s1 = tm.nlml_value_grad_state_inv(tp, Xt, ft, yt, kernel=kernel,
                                              jitter=JITTER,
                                              inv_mode=inv_mode)
    v0, g0, s0 = jm.nlml_value_grad_state_inv(jp, X, fid, y, kernel=kernel,
                                              jitter=JITTER,
                                              inv_mode=inv_mode)
    close(v1, v0)
    close_params(g1, g0)
    close(s1.alpha, s0.alpha)
    if inv_mode is None:
        assert s1.Linv is None and s0.Linv is None
    else:
        close(s1.Linv, s0.Linv)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("full_cov", [False, True])
def test_condition_predict(kernel, full_cov):
    (jp, X, fid, y, Xs, fs), (tp, Xt, ft, yt, Xst, fst) = problem(3, 3)
    st = tm.condition(tp, Xt, ft, yt, kernel=kernel, jitter=JITTER)
    sj = jm.condition(jp, X, fid, y, kernel=kernel, jitter=JITTER)
    close(st.L, sj.L)
    close(st.alpha, sj.alpha)
    for include_noise in (True, False):
        got = tm.predict(tp, st, Xst, fst, kernel=kernel, full_cov=full_cov,
                         include_noise=include_noise)
        ref = jm.predict(jp, sj, Xs, fs, kernel=kernel, full_cov=full_cov,
                         include_noise=include_noise)
        for a, b in zip(got, ref):
            close(a, b)
    if not full_cov:  # blocked over ragged row blocks
        got = tm.predict_blocked(tp, st, Xst, fst, kernel=kernel,
                                 block_size=16)
        ref = jm.predict_blocked(jp, sj, Xs, fs, kernel=kernel,
                                 block_size=16)
        for a, b in zip(got, ref):
            close(a, b)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
def test_unit_slice(kernel, F):
    """The benchmark unit end to end: NLML + gradient + inverse-factor
    state, then the grid posterior. The port's predict_fused (its B3 path;
    the plain composition here) against JAX's predict_blocked_inv, the
    same contract at full precision (JAX's predict_fused is the float32
    Pallas kernel only)."""
    (jp, X, fid, y, Xs, fs), (tp, Xt, ft, yt, Xst, fst) = problem(4, F)
    v1, g1, s1 = tm.nlml_value_grad_state_inv(tp, Xt, ft, yt, kernel=kernel,
                                              jitter=JITTER)
    v0, g0, s0 = jm.nlml_value_grad_state_inv(jp, X, fid, y, kernel=kernel,
                                              jitter=JITTER)
    close(v1, v0)
    close_params(g1, g0)
    got = tm.predict_fused(tp, s1, Xst, fst, kernel=kernel)
    ref = jm.predict_blocked_inv(jp, s0, Xs, fs, kernel=kernel,
                                 block_size=16)
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_posteriors_from_carried_state(kernel):
    """A JAX state carried across with state_inv_from_numpy gives the
    same posterior through the port's predict_blocked_inv and
    predict_fused."""
    (jp, X, fid, y, Xs, fs), (tp, _, _, _, Xst, fst) = problem(5, 3)
    _, _, s0 = jm.nlml_value_grad_state_inv(jp, X, fid, y, kernel=kernel,
                                            jitter=JITTER)
    st = tm.state_inv_from_numpy(*(np.asarray(a) for a in s0), "cpu",
                                 torch.float64)
    ref = jm.predict_blocked_inv(jp, s0, Xs, fs, kernel=kernel,
                                 block_size=16)
    for got in (tm.predict_blocked_inv(tp, st, Xst, fst, kernel=kernel,
                                       block_size=16),
                tm.predict_fused(tp, st, Xst, fst, kernel=kernel)):
        for a, b in zip(got, ref):
            close(a, b)


def test_reduced_precision_inv_mode_is_rejected():
    """The port has no TF32 analogue of JAX's inv_mode="high"."""
    _, (tp, Xt, ft, yt, _, _) = problem(6, 3)
    with pytest.raises(ValueError, match="inv_mode"):
        tm.nlml_value_grad_state_inv(tp, Xt, ft, yt, inv_mode="high")
