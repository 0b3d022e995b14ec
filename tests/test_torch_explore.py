"""Parity of the port's closed-loop simulator (``mfgp_tpu_torch.sim``)
with ``mfgp_tpu`` on the CPU, in float64: kinematic runs of every variant
and all six path costs, at the JAX package's own test configurations
(tests/test_sim_cli.py: the MFEGP run, the deterministic SFGP run, the
SFEGP artifacts run, the frozen-hyperparameter run's MFGP setting, the last
two also with the batch log-det and the Fourier ergodic cost).

The Kalman filter's measurement noise is the one stream the packages
cannot share (``jax.random`` against ``torch.Generator``), so the port's
sim is given the JAX package's own draws, one ``split`` of the run's key
per replan (``kf_noise``); everything else (the field noise, the planner's
seeds) is NumPy in both. Held: ``gp_data`` within 1e-8; each replan's
number, tranche, graph size, fit mode and path points; ``best_info``,
``budget_used`` and ``rmse`` within 1e-6.

Also here: a kernel that fails inside a refit leaves ``run()`` (the sim
keeps the last hyperparameters only on numerical failures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.sim import ExplorationSim as JSim
from mfgp_tpu.utils.configs import ExperimentConfig as JExp
from mfgp_tpu_torch.ops import covariance as tcov
from mfgp_tpu_torch.ops import cuda_kernels as ck
from mfgp_tpu_torch.sim import ExplorationSim as TSim
from mfgp_tpu_torch.sim import explore as texplore
from mfgp_tpu_torch.utils.configs import ExperimentConfig as TExp

# name -> (ExperimentConfig keywords, seed, plan_iters)
CONFIGS = {
    # tests/test_sim_cli.py:13-17 (small_run)
    "MFEGP": (dict(multi_fidelity=True, ergodic=True, B=20, BD=2), 0, 8),
    # :40-45 (test_explore_deterministic)
    "SFGP": (dict(multi_fidelity=False, ergodic=False, B=10, BD=1), 5, 6),
    # :48-56 (test_explore_artifacts)
    "SFEGP": (dict(multi_fidelity=False, ergodic=True, B=10, BD=1), 2, 6),
    # :116-149 (the frozen-hyperparameter run's setting, refitting)
    "MFGP": (dict(multi_fidelity=True, ergodic=False, B=20, BD=2), 1, 8),
    "MFGP-batch": (dict(multi_fidelity=True, ergodic=False, B=20, BD=2,
                        info_cost="batch"), 1, 8),
    "SFEGP-fourier": (dict(multi_fidelity=False, ergodic=True, B=10, BD=1,
                           ergodic_metric="fourier"), 2, 6),
    "SFGP-batch": (dict(multi_fidelity=False, ergodic=False, B=10, BD=1,
                        info_cost="batch"), 5, 6),
}
_RUNS: dict = {}


def jax_kf_noise(seed: int):
    """The JAX sim's filter draws: replan ``k`` flies with the second half
    of the (k+1)-th ``split`` of ``jax.random.key(seed)``, drawing
    ``normal(sub, (n, 6))`` (mfgp_tpu/sim/explore.py:334,427-428)."""
    def draws(plan_num, n):
        key = jax.random.key(seed)
        for _ in range(plan_num + 1):
            key, sub = jax.random.split(key)
        return np.array(jax.random.normal(sub, (n, 6), jnp.float64))
    return draws


def runs(name):
    """Both packages' runs of one configuration, once per session."""
    if name not in _RUNS:
        kw, seed, iters = CONFIGS[name]
        ref = JSim(JExp(**kw), seed=seed, plan_iters=iters).run()
        got = TSim(TExp(**kw), seed=seed, plan_iters=iters, device="cpu",
                   kf_noise=jax_kf_noise(seed)).run()
        _RUNS[name] = (got, ref)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gp_data_matches_jax(name):
    got, ref = runs(name)
    assert got.gp_data.headers == ref.gp_data.headers
    assert got.gp_data.data.shape == ref.gp_data.data.shape
    assert got.gp_data.data.shape[0] >= 4
    np.testing.assert_allclose(got.gp_data.data, ref.gp_data.data,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.estimates, ref.estimates, rtol=1e-8,
                               atol=1e-8)
    assert set(np.unique(got.gp_data.col("fidLev")).astype(int)) <= {1, 2, 3}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_replans_match_jax(name):
    got, ref = runs(name)
    assert len(got.replans) == len(ref.replans) >= 1
    for a, b in zip(got.replans, ref.replans):
        assert (a.plan_num, a.nodes, a.edges, a.fit_mode, a.plan_truncated) \
            == (b.plan_num, b.nodes, b.edges, b.fit_mode, b.plan_truncated)
        assert a.budget_tranche == b.budget_tranche
        assert a.t_start == pytest.approx(b.t_start, rel=1e-12)
        assert a.best_info == pytest.approx(b.best_info, rel=1e-6, abs=1e-6)
        assert a.path_points.shape == b.path_points.shape
        np.testing.assert_allclose(a.path_points, b.path_points, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_result_matches_jax(name):
    got, ref = runs(name)
    assert got.budget_used == pytest.approx(ref.budget_used, rel=1e-6,
                                            abs=1e-6)
    assert got.budget_used <= CONFIGS[name][0]["B"] + 1e-9
    assert got.rmse == pytest.approx(ref.rmse, rel=1e-6, abs=1e-6)
    assert got.rmse < 3.0  # tests/test_sim_cli.py:34-37
    np.testing.assert_allclose(got.model.param_array, ref.model.param_array,
                               rtol=1e-4, atol=1e-6)
    assert got.model.X.dtype == torch.float64
    assert got.model.X.device == torch.device("cpu")


def test_port_default_draws_are_seeded():
    """Without injected draws the filter's noise comes from the sim's own
    generator seeded with ``seed``: two runs are equal, a third seed's
    differs, and the plans (which do not read the noise at the first
    replan) are JAX's."""
    kw, seed, iters = CONFIGS["SFGP"]
    r1 = TSim(TExp(**kw), seed=seed, plan_iters=iters, device="cpu").run()
    r2 = TSim(TExp(**kw), seed=seed, plan_iters=iters, device="cpu").run()
    assert r1.budget_used == r2.budget_used
    np.testing.assert_array_equal(r1.gp_data.data, r2.gp_data.data)
    got, ref = runs("SFGP")
    assert r1.budget_used == ref.budget_used
    assert not np.array_equal(r1.gp_data.data, got.gp_data.data)


def small_exp():
    return TExp(multi_fidelity=True, ergodic=False, B=10, BD=1)


def test_kernel_fault_in_refit_leaves_run(monkeypatch):
    """B1's wrapper raising (a kernel that fails to build or launch)
    inside a refit is not a fit failure to swallow: ``run()`` raises it.
    The float32 covariances on the CPU are routed to the kernel wrapper as
    on the card, and the wrapper raises while ``_fit`` runs."""
    in_fit = []

    def broken(*a, **k):
        if in_fit:
            raise RuntimeError("mfgp_ar1_cov_f32: CUDA error 719 "
                               "(unspecified launch failure)")
        return ck.ar1_cov_fused_plain(*a, **k)

    monkeypatch.setattr(tcov, "use_cuda_kernels",
                        lambda x, kernel: x.dtype == torch.float32)
    monkeypatch.setattr(ck, "ar1_cov_fused", broken)
    sim = TSim(small_exp(), seed=1, plan_iters=4, device="cpu",
               dtype=torch.float32)
    fit = sim._fit

    def fit_flagged(model):
        in_fit.append(1)
        try:
            return fit(model)
        finally:
            in_fit.pop()

    sim._fit = fit_flagged
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        sim.run()


def test_numerical_fit_failure_keeps_hyps(monkeypatch):
    """A numerical failure of the fit keeps the last hyperparameters and
    the run goes on, as in the JAX package."""
    from mfgp_tpu_torch.models.mfgp import MFGP

    def fails(self, *a, **k):
        raise FloatingPointError("non-finite NLML")

    monkeypatch.setattr(MFGP, "optimize", fails)
    res = TSim(small_exp(), seed=1, plan_iters=4, device="cpu").run()
    assert len(res.replans) == 1 and res.rmse is not None
    assert np.isfinite(res.model.param_array).all()
    assert texplore.NUMERICAL_FAILURES[0] is ArithmeticError


def test_device_planner_and_ensemble_raise():
    """The device planner and the plan ensemble run (on the CPU when asked
    for it): every replan by the device loop (SFGP's sequential gain with
    the gain state padded to a static size; SFEGP with 2 plans as lanes).
    What raises: a ``mesh`` argument (the simulator takes none: as the JAX
    package's, it shards the ensemble over an initialised process group by
    itself, tests/test_torch_parallel.py), an ensemble without the device
    planner, a stopwatch for a fixed-iteration loop (the JAX package's
    rules), and the card without CUDA."""
    for ergodic, ens, cost, nmax in ((False, 1, "sf_gain", 512),
                                     (True, 2, "ergodic", None)):
        sim = TSim(TExp(multi_fidelity=False, ergodic=ergodic, B=10, BD=1),
                   seed=1, plan_iters=4, device="cpu",
                   planner_backend="device", plan_ensemble=ens)
        res = sim.run()
        assert len(res.replans) == 1 and res.rmse is not None
        rig = sim._device_planner
        assert rig._planner.cost == cost and rig._n_plans == ens
        assert rig._planner.device == torch.device("cpu")
        assert sim._gain_nmax == nmax
        assert res.replans[0].path_points.shape[1] == 4
    with pytest.raises(TypeError, match="mesh"):
        TSim(small_exp(), device="cpu", planner_backend="device",
             plan_ensemble=2, mesh=object())
    with pytest.raises(ValueError, match="device planner"):
        TSim(small_exp(), device="cpu", plan_ensemble=2)
    with pytest.raises(ValueError, match="plan_iters"):
        TSim(TExp(ergodic=True, plan_wallclock=10.0), device="cpu",
             planner_backend="device")
    with pytest.raises(ValueError):
        TSim(small_exp(), device="cpu", planner_backend="mesh")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSim(small_exp())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSim(small_exp(), planner_backend="device")
