"""The plain reference against the program's own plain path on the CPU in
float64, at small sizes: the two are independent writings of the same
mathematics, so they agree to rounding. (The test imports the program;
the reference does not.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.common import ar1, gen
from benchmark.common.problem import _theta, build_problem
from benchmark.reference import gp as ref
from benchmark.reference import mission as mref

F64 = torch.float64


def _problem(N, M, seed):
    X, fid, y, grid, gfid = build_problem(N, M, seed=seed)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    return (t(X), torch.as_tensor(fid).long(), t(y), t(grid),
            torch.as_tensor(gfid).long())


def _theta_dict(row):
    config = dict(F=3, D=3, theta=dict(rhos=[1.0, 1.0]))
    return ar1.theta_of(row, config)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_nlml_and_gradient_match_the_program(kernel):
    from mfgp_tpu_torch.models import mfgp as mf

    X, fid, y, _, _ = _problem(300, 10, seed=3)
    v, ls, r, nz = _theta()
    base = gen.log_theta(dict(variances=v, lengthscales=ls, noises=nz))
    row = base + 0.1 * np.random.default_rng(0).standard_normal(15)
    th = _theta_dict(row)
    p = mf.MFGPParams(torch.as_tensor(np.log(th["variances"])),
                      torch.as_tensor(np.log(th["lengthscales"])),
                      torch.as_tensor(th["rhos"]),
                      torch.as_tensor(np.log(th["noises"])))
    val, g = mf.nlml_value_and_grad(p, X, fid, y, kernel=kernel)
    out = ref.nlml_grad(X, fid, y, th, kernel, 0.0, block=128)
    assert float(val) == pytest.approx(float(out["value"]), rel=1e-10)
    got = torch.cat([g.log_variances, g.log_lengthscales.reshape(-1),
                     g.log_noises])
    np.testing.assert_allclose(got.numpy(), ref.grad_vector(out).numpy(),
                               rtol=1e-7, atol=1e-9)
    a = mf.condition(p, X, fid, y, kernel=kernel).alpha
    np.testing.assert_allclose(a.numpy(), out["alpha"].numpy(), rtol=1e-8,
                               atol=1e-10)


def test_posterior_matches_the_program():
    from mfgp_tpu_torch.models import mfgp as mf

    X, fid, y, G, gf = _problem(300, 500, seed=4)
    v, ls, r, nz = _theta()
    th = dict(variances=v, lengthscales=ls, rhos=r, noises=nz)
    p = mf.MFGPParams(*(torch.as_tensor(a) for a in
                        (np.log(v), np.log(ls), r, np.log(nz))))
    model = mf.MFGP(X, fid, y, params=p, device="cpu")
    mu, var = model.predict(G, block_size=128)
    L, alpha, _ = ref.factor(X, fid, y, th, "rbf", 0.0)
    mu_r, var_r = ref.predict(L, alpha, X, fid, th, "rbf", G, gf, block=100)
    np.testing.assert_allclose(mu.numpy(), mu_r.numpy(), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(var.numpy(), var_r.numpy(), rtol=1e-7,
                               atol=1e-9)


def test_mission_field_and_grids_match_the_program(bench, root):
    import json

    from mfgp_tpu_torch.fields.wrbf import default_sim_field
    from mfgp_tpu_torch.metrics.eid import eid_grid
    from mfgp_tpu_torch.utils.configs import SimConfig

    with open(root / "benchmark/configs/mission_mfegp_default.json") as f:
        cfg = json.load(f)
    sim = SimConfig()
    np.testing.assert_array_equal(mref.test_grid(cfg), sim.test_points())
    np.testing.assert_array_equal(
        mref.eid_grid(cfg), np.asarray(eid_grid([list(b) for b in sim.WS],
                                                sim.max_depth)))
    pts = mref.test_grid(cfg)
    field = default_sim_field(sim.WS, sim.max_depth, device="cpu")
    np.testing.assert_allclose(mref.field(cfg, pts), field.numpy(pts),
                               rtol=1e-12, atol=1e-12)


def test_tf32_rounds_the_mantissa_and_keeps_nan_and_inf():
    import torch

    from benchmark.reference import gp

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.14159,
                      float("inf"), -float("inf")])
    assert gp.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, -3.140625,
                                   float("inf"), -float("inf")]
    # the NaNs of a GPU (0x7fffffff) and of a CPU (0x7fc00000), both signs
    nans = torch.tensor([0x7FFFFFFF, 0x7FC00000, -1, -0x400000],
                        dtype=torch.int32).view(torch.float32)
    assert torch.isnan(gp.tf32(nans)).all()
