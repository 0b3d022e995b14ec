"""Parity of the port's batched study (``data/study_batched.py``) and of
what it adds beneath it (B1's lane axis, the lane-batched Gram and its
closed-form backward, ``batched_lbfgs``'s lane-batched evaluator, the
lane-batched NLMLs) with the port's per-lane functions and with
``mfgp_tpu`` on the CPU, in float64 unless said.

Two tiny datasets (150 s scripted trajectories through the port's
pipeline, 29 points each) are written once. JAX's batched study runs once
on them (a few iterations per fit, chunks of both datasets) and the port's
with JAX's ``jax.random`` restart points injected; the fits agree to
1e-6, the metrics to 1e-6 (the NIGP's WMSE, whose posterior covariance is
singular to working precision on the 2,000-point grid, is held finite),
the evaluations on a 45-point grid to 1e-8. Lane by lane against the
port's own per-lane functions: values and gradients to 1e-8 relative, the
optimiser's iterates to 1e-10 with equal iteration counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.data import study_batched as jsb
from mfgp_tpu.models import gp as jg
from mfgp_tpu.models import mfgp as jm
from mfgp_tpu.models import nigp as jn
from mfgp_tpu_torch.data import io as tio
from mfgp_tpu_torch.data import pipeline as tpl
from mfgp_tpu_torch.data import study as tstudy
from mfgp_tpu_torch.data import study_batched as tsb
from mfgp_tpu_torch.data import trainers as ttr
from mfgp_tpu_torch.fields import wrbf as tw
from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.models import mfgp as tm
from mfgp_tpu_torch.models import nigp as tn
from mfgp_tpu_torch.ops import covariance as tcov
from mfgp_tpu_torch.ops import cuda_kernels as tck
from mfgp_tpu_torch.ops import optimize as topt
from mfgp_tpu_torch.utils import configs as tcfg

CPU = "cpu"
MAXITER = 4
RUN = dict(dtype=np.float64, maxiter=MAXITER, fit_chunk=2, eval_chunk=2)
NAMES = ("T0_0.1", "T1_0.2")


def close(port, ref, tol):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def jax_inits(x0, n_restarts, spread, seed):
    """``restart_inits`` with JAX's draws: the points JAX's batched study
    starts its SFGP and MFGP lanes from."""
    draws = np.array(jax.random.normal(
        jax.random.key(seed), (n_restarts, x0.shape[0]), jnp.float64))
    out = x0[None, :] + spread * torch.as_tensor(draws).to(x0)
    out[0] = x0
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(GPData paths, FieldSettings path, directory) of two tiny datasets."""
    root = tmp_path_factory.mktemp("batched")
    paths = []
    for name in NAMES:
        tseed, vmn = int(name[1]), float(name[3:])
        cfg = tcfg.SimConfig(seed=0, vmn=vmn)
        traj = tstudy.scripted_trajectory(tseed, cfg, duration=150.0)
        field = tw.default_sim_field(cfg.WS, cfg.max_depth, device=CPU)
        tpl.run_pipeline(traj, cfg, out_dir=str(root), traj_name=name,
                         field=field, device=CPU)
        paths.append(str(root / "GPDataSets" /
                         f"GPData_0.2_fieldMeas_0_{name}.csv"))
    return paths, str(root / "FieldData" / "FieldSettings0.txt"), root


@pytest.fixture(scope="module")
def runs(data):
    """JAX's batched study and the port's on the two datasets (JAX's
    restart points injected), with the port's per-family statistics."""
    paths, settings, root = data
    ref = jsb.process_datasets_batched(paths, settings,
                                       out_dir=str(root / "j"), **RUN)
    mp = pytest.MonkeyPatch()
    mp.setattr(tsb, "restart_inits", jax_inits)
    stats = {}
    try:
        got = tsb.process_datasets_batched(paths, settings,
                                           out_dir=str(root / "t"),
                                           device=CPU, stats=stats, **RUN)
    finally:
        mp.undo()
    return ref, got, stats


@pytest.fixture(scope="module")
def stacked(data):
    """The arrays both packages' batched fits take (numpy, float64)."""
    ds = [tio.load_gp_dataset(p) for p in data[0]]
    X = np.stack([d.X_est for d in ds])
    Xtp = np.stack([d.X_true for d in ds])
    y = np.stack([d.y for d in ds])
    rows = [tm.stack_fidelity_lists(*d.fidelity_lists(True), device=CPU)
            for d in ds]
    Xmf, fmf, ymf = (np.stack([r[i].numpy() for r in rows])
                     for i in range(3))
    return dict(X=X, Xtp=Xtp, y=y, Xmf=Xmf, fmf=fmf, ymf=ymf, ds=ds)


# ---------------------------------------------------------------------------
# B1's lane axis and the lane-batched Gram
# ---------------------------------------------------------------------------
def lanes_problem(seed, L=3, N=17, M=11, F=3, D=3):
    rng = np.random.default_rng(seed)
    t = torch.as_tensor
    return dict(X=t(rng.uniform(0, 3, (L, N, D))),
                fid=t(rng.integers(0, F, (L, N))),
                G=t(rng.uniform(0, 3, (L, M, D))),
                gfid=t(rng.integers(0, F, (L, M))),
                v=t(rng.uniform(0.5, 2.0, (L, F))),
                ls=t(rng.uniform(0.5, 2.0, (L, F, D))),
                rho=t(rng.uniform(0.7, 1.2, (L, F - 1))),
                noise=t(rng.uniform(0.1, 0.3, (L, N))), Ct=t(
                    rng.normal(size=(L, N, N))))


@pytest.mark.parametrize("kern", ["rbf", "matern32"])
def test_lane_b1_plain_equals_single_lane(kern):
    """The lane-axis B1 (its plain version on the CPU) is the single-lane
    plain B1 of each lane, bit for bit, Gram with noise and cross;
    ``_prep`` of all lanes is each lane's."""
    p = lanes_problem(0)
    for args, noise in (((p["X"], p["fid"], p["X"], p["fid"]), p["noise"]),
                        ((p["G"], p["gfid"], p["X"], p["fid"]), None)):
        K = tck.ar1_cov_fused_lanes(*args, p["v"], p["ls"], p["rho"], noise,
                                    kern)
        for l in range(3):
            one = tck.ar1_cov_fused_plain(
                *(a[l] for a in args), p["v"][l], p["ls"][l], p["rho"][l],
                None if noise is None else noise[l], kern)
            assert torch.equal(K[l], one)
    X32 = p["X"].float()
    A, w = tck._prep(X32, p["fid"], p["v"], p["ls"], p["rho"])
    for l in range(3):
        a, b = tck._prep(X32[l], p["fid"][l], p["v"][l], p["ls"][l],
                         p["rho"][l])
        assert torch.equal(A[l], a) and torch.equal(w[l], b)


@pytest.mark.parametrize("kern", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
def test_lane_gram_backward_equals_per_lane(kern, F):
    """``_AR1TrainCov`` over lanes: its closed-form backward (through the
    lane-axis B1's plain version) equals the per-lane Function's, lane by
    lane, for an asymmetric cotangent, 1e-12; and autograd through the
    plain composition, 1e-9."""
    p = lanes_problem(1, F=F)
    args = [p[k].clone().requires_grad_(True) for k in ("v", "ls", "rho")]
    K = tcov._AR1TrainCov.apply(kern, *args, p["X"], p["fid"])
    got = torch.autograd.grad(K, args, p["Ct"])
    for l in range(3):
        one = [p[k][l].clone().requires_grad_(True)
               for k in ("v", "ls", "rho")]
        Kl = tcov._AR1TrainCov.apply(kern, *one, p["X"][l], p["fid"][l])
        assert torch.equal(K[l].detach(), Kl.detach())
        want = torch.autograd.grad(Kl, one, p["Ct"][l])
        plain = [p[k][l].clone().requires_grad_(True)
                 for k in ("v", "ls", "rho")]
        Kp = tck._k.ar1_cov(p["X"][l], p["fid"][l], p["X"][l], p["fid"][l],
                            *plain, kern)
        auto = torch.autograd.grad(Kp, plain, p["Ct"][l], allow_unused=True)
        for g, w, a in zip(got, want, auto):
            close(g[l], w, 1e-12)
            if a is not None:
                close(g[l], a, 1e-9)


def test_sf_cov_diff_lanes_dispatch():
    """``sf_cov_diff`` over a lane axis: on the CPU the lanes' plain
    kernels, differentiable; the lane-axis Function only on the card (its
    gate)."""
    p = lanes_problem(2, F=1)
    v = p["v"][:, 0].clone().requires_grad_(True)
    K = tcov.sf_cov_diff(v, p["ls"][:, 0], p["X"], "rbf")
    for l in range(3):
        close(K[l], tck._k.rbf(p["X"][l], p["X"][l], p["v"][l, 0],
                               p["ls"][l, 0]), 1e-14)
    assert K.grad_fn is not None
    assert not tcov.use_cuda_kernels(p["X"], "rbf")


def _spd_lanes(rng, L, n):
    A = rng.normal(size=(L, n, n))
    return torch.as_tensor(A @ np.swapaxes(A, 1, 2) + n * np.eye(n))


@pytest.mark.parametrize("fn", ["solve_posterior", "posterior_cov",
                                "weighted_mse", "weighted_mse_raw",
                                "posterior_mean_grads", "nigp_nlml"])
def test_lane_axis_equals_per_lane(fn):
    """The functions the batched study calls with a leading lane axis give,
    lane by lane, what the same function gives on that lane alone, 1e-12."""
    rng = np.random.default_rng(4)
    L, n, m, D = 3, 9, 5, 3
    K = _spd_lanes(rng, L, n)
    Lc = torch.linalg.cholesky(K)
    y = torch.as_tensor(rng.normal(size=(L, n)))
    X = torch.as_tensor(rng.uniform(0, 3, (L, n, D)))
    ls = torch.as_tensor(rng.uniform(0.5, 2.0, (L, D)))
    sf, sy = (torch.as_tensor(rng.uniform(0.5, 2.0, L)) for _ in range(2))
    lh = torch.as_tensor(rng.normal(scale=0.3, size=(L, 2 * D + 2)))
    grads = torch.as_tensor(rng.normal(size=(L, n, D)))
    Kxs = torch.as_tensor(rng.normal(size=(L, m, n)))
    Kss = _spd_lanes(rng, L, m)
    la = tsb._la
    call = {
        "solve_posterior": lambda *a: la.solve_posterior(*a),
        "posterior_cov": lambda *a: la.posterior_cov(*a),
        "weighted_mse": lambda *a: la.weighted_mse(*a),
        "weighted_mse_raw": lambda *a: la.weighted_mse(*a, normalize=False),
        "posterior_mean_grads": lambda *a: (lambda Ka, g: torch.cat(
            [Ka, g.flatten(-2)], -1))(*tn.posterior_mean_grads(*a)),
        "nigp_nlml": lambda *a: tn.nlml(*a),
    }[fn]
    args = {"solve_posterior": (Lc, y), "posterior_cov": (Kss, Kxs, Lc),
            "weighted_mse": (y, K), "weighted_mse_raw": (y, K),
            "posterior_mean_grads": (X, y, ls, sf, sy),
            "nigp_nlml": (lh, X, y, grads)}[fn]
    lanes = call(*args)
    for l in range(L):
        close(lanes[l], call(*(a[l] for a in args)), 1e-12)


# ---------------------------------------------------------------------------
# lane-batched NLMLs and the optimiser
# ---------------------------------------------------------------------------
def family_lanes(family, stacked, seed=3):
    """(per-lane-of-the-port, lanes-of-the-port, JAX-per-lane) value and
    gradient functions of one family on 2 datasets x 2 points each, and the
    (4, n) points."""
    rng = np.random.default_rng(seed)
    s = stacked
    d = torch.tensor([0, 0, 1, 1])
    F, D = 3, 3
    if family == "sf":
        X, y = torch.as_tensor(s["X"]), torch.as_tensor(s["y"])
        xs = torch.as_tensor(rng.normal(scale=0.4, size=(4, D + 2)))

        def one(l, x):
            v, g = tg.nlml_value_and_grad(
                tg.GPParams(x[0], x[1:1 + D], x[1 + D]), X[d[l]], y[d[l]],
                jitter=1e-6)
            return v, torch.cat([g.log_variance[None], g.log_lengthscales,
                                 g.log_noise[None]])

        def lanes(x):
            v, g = tg.nlml_value_and_grad_lanes(
                tg.GPParams(x[:, 0], x[:, 1:1 + D], x[:, 1 + D]), X[d], y[d],
                jitter=1e-6)
            return v, torch.cat([g.log_variance[:, None], g.log_lengthscales,
                                 g.log_noise[:, None]], 1)

        def ref(l, x):
            v, g = jg.nlml_value_and_grad(
                jg.GPParams(x[0], x[1:1 + D], x[1 + D]), s["X"][d[l]],
                s["y"][d[l]], jitter=1e-6)
            return v, np.concatenate([[g.log_variance], g.log_lengthscales,
                                      [g.log_noise]])
    elif family == "mf":
        X, f, y = (torch.as_tensor(s[k]) for k in ("Xmf", "fmf", "ymf"))
        n = 2 * F + F * D
        xs = torch.as_tensor(rng.normal(scale=0.4, size=(4, n)))
        ones = torch.ones(F - 1, dtype=torch.float64)

        def unpack(x, r):
            return (x[..., :F], x[..., F:F + F * D].reshape(*r, F, D),
                    ones.expand(*r, F - 1), x[..., F + F * D:])

        def grads(g, r):
            return torch.cat([g.log_variances,
                              g.log_lengthscales.reshape(*r, -1),
                              g.log_noises], -1)

        def one(l, x):
            v, g = tm.nlml_value_and_grad(tm.MFGPParams(*unpack(x, ())),
                                          X[d[l]], f[d[l]], y[d[l]],
                                          jitter=1e-6)
            return v, grads(g, ())

        def lanes(x):
            v, g = tm.nlml_value_and_grad_lanes(
                tm.MFGPParams(*unpack(x, (4,))), X[d], f[d], y[d],
                jitter=1e-6)
            return v, grads(g, (4,))

        def ref(l, x):
            v, g = jm.nlml_value_and_grad(
                jm.MFGPParams(x[:F], x[F:F + F * D].reshape(F, D),
                              jnp.ones(F - 1), x[F + F * D:]),
                s["Xmf"][d[l]], jnp.asarray(s["fmf"][d[l]], jnp.int32),
                s["ymf"][d[l]], jitter=1e-6)
            return v, np.concatenate([g.log_variances,
                                      np.ravel(g.log_lengthscales),
                                      g.log_noises])
    else:
        X, y = torch.as_tensor(s["X"]), torch.as_tensor(s["y"])
        xs = torch.as_tensor(np.log([2.0, 3.0, 1.5, 1.2, 0.3, 0.05, 0.05,
                                     0.02]) + rng.normal(scale=0.2,
                                                         size=(4, 8)))

        def one(l, x):
            x = x.detach().requires_grad_(True)
            v = tn.nlml_native(x, X[d[l]], y[d[l]])
            return v.detach(), torch.autograd.grad(v, x)[0]

        def lanes(x):
            x = x.detach().requires_grad_(True)
            v = tn.nlml_native(x, X[d], y[d])
            return v.detach(), torch.autograd.grad(v.sum(), x)[0]

        def ref(l, x):
            v, g = jax.value_and_grad(jn.nlml_native)(
                jnp.asarray(x), s["X"][d[l]], s["y"][d[l]])
            return v, g
    return one, lanes, ref, xs


@pytest.mark.parametrize("family", ["sf", "mf", "nigp"])
def test_lane_value_and_grad_matches(family, stacked):
    """Each family's lane-batched NLML and gradient on 4 lanes over 2
    datasets against the port's per-lane function and JAX's, 1e-8
    relative."""
    one, lanes, ref, xs = family_lanes(family, stacked)
    v, g = lanes(xs)
    for l in range(4):
        v1, g1 = one(l, xs[l])
        vr, gr = ref(l, xs[l].numpy())
        for a, b in ((v[l], v1), (v[l], vr)):
            assert abs(float(a) - float(b)) <= 1e-8 * abs(float(b))
        for b in (g1.numpy(), np.asarray(gr)):
            np.testing.assert_allclose(g[l].numpy(), b, rtol=1e-8,
                                       atol=1e-8 * np.abs(b).max())


@pytest.mark.parametrize("evaluator", ["loop", "sf", "mf"])
def test_batched_lbfgs_lane_evaluator(evaluator, stacked):
    """``batched_lbfgs`` with ``value_and_grad_lanes`` against the per-lane
    evaluator on the same 4 lanes (2 datasets x 2 restarts): equal
    iteration counts, x and f within 1e-10. ``loop`` evaluates the lanes
    one by one inside the lane evaluator (the bookkeeping alone); ``sf``
    and ``mf`` are the lane-batched analytic NLMLs."""
    family = "sf" if evaluator == "loop" else evaluator
    one, lanes, _, xs = family_lanes(family, stacked, seed=5)
    calls = []

    def per_lane(l):
        return lambda x: topt.penalize_nonfinite(*one(l, x))

    def vg_lanes(idx, x):
        calls.append(idx.clone())
        if evaluator == "loop":
            out = [per_lane(int(i))(xi) for i, xi in zip(idx, x)]
            return (torch.stack([o[0] for o in out]),
                    torch.stack([o[1] for o in out]))
        full = xs.clone()
        full[idx] = x
        v, g = topt.penalize_nonfinite(*lanes(full))
        return v[idx], g[idx]

    kw = dict(maxiter=8, tol=1e-3, ftol=1e-6)
    x, f, k = topt.batched_lbfgs(None, xs, value_and_grad_lanes=vg_lanes,
                                 **kw)
    for l in range(4):
        xl, fl, kl = topt.batched_lbfgs(None, xs[l:l + 1],
                                        value_and_grad=per_lane(l), **kw)
        assert int(k[l]) == int(kl[0]), (l, k, kl)
        close(x[l], xl[0], 1e-10)
        close(f[l], fl[0], 1e-10)
    assert torch.equal(calls[0], torch.arange(4))
    assert all(c.numel() >= 1 for c in calls)


def test_penalize_nonfinite_lanes():
    v = torch.tensor([1.0, float("nan"), 2.0], dtype=torch.float64)
    g = torch.tensor([[1.0, float("inf")], [3.0, 4.0], [5.0, 6.0]],
                     dtype=torch.float64)
    pv, pg = topt.penalize_nonfinite(v, g)
    assert pv.tolist() == [1.0, 1e20, 2.0]
    assert pg.tolist() == [[1.0, 0.0], [0.0, 0.0], [5.0, 6.0]]


# ---------------------------------------------------------------------------
# the batched fits, evaluations and whole study against JAX's
# ---------------------------------------------------------------------------
def test_fit_batches_match_jax(stacked):
    """``_fit_{sf,mf,nigp}_batch`` on the two datasets from the same
    points: every dataset's best lane within 1e-6 of JAX's (the same
    shapes and static arguments as the ``runs`` fixture's JAX study, so
    its compiled sweeps are reused)."""
    s = stacked
    D, F = 3, 3
    ini_sf = jax_inits(torch.zeros(D + 2, dtype=torch.float64), 8, 1.0, 0)
    ini_mf = jax_inits(torch.zeros(2 * F + F * D, dtype=torch.float64), 8,
                       1.0, 0)
    args = ("rbf", 1e-6, MAXITER, 1e-3, 1e-6)
    t = torch.as_tensor
    got = tsb._fit_sf_batch(ini_sf, t(s["X"]), t(s["y"]), *args)
    ref = jsb._fit_sf_batch(jnp.asarray(ini_sf.numpy()), s["X"], s["y"],
                            *args)
    close(got.x, ref, 1e-6)
    assert got.k.shape == got.evals.shape == (2, 8)
    assert bool((got.evals >= got.k + 1).all())
    inf = np.full(2 * F + F * D, np.inf)
    got = tsb._fit_mf_batch(ini_mf, t(s["Xmf"]), t(s["fmf"]), t(s["ymf"]),
                            torch.ones(F - 1, dtype=torch.float64),
                            t(-inf), t(inf), *args)
    ref = jsb._fit_mf_batch(jnp.asarray(ini_mf.numpy()), s["Xmf"],
                            jnp.asarray(s["fmf"], jnp.int32), s["ymf"],
                            jnp.ones(F - 1), -inf, inf, *args)
    close(got.x, ref, 1e-6)
    ini = tsb._nigp_inits(s["ds"], D, 2, 0, np.float64)
    lo, hi = np.full(2 * D + 2, np.log(1e-6)), np.full(2 * D + 2,
                                                        np.log(1e6))
    got = tsb._fit_nigp_batch(t(ini), t(s["X"]), t(s["y"]), t(lo), t(hi),
                              MAXITER, 1e-6)
    ref = jsb._fit_nigp_batch(jnp.asarray(ini), s["X"], s["y"], lo, hi,
                              MAXITER, 1e-6)
    close(got.x, ref, 1e-6)


@pytest.mark.parametrize("family", ["sf", "mf", "nigp"])
def test_eval_one_matches_jax(family, stacked):
    """``_eval_{sf,mf,nigp}_one`` on the same vectors over 2 lanes and a
    45-point grid: RMSE, WMSE, mean and the covariance's diagonal within
    1e-8 of JAX's (vmapped)."""
    s = stacked
    rng = np.random.default_rng(7)
    tp = tcfg.SimConfig().test_points(nums=(3, 5, 3))
    ft = rng.normal(size=(2, tp.shape[0]))
    t = torch.as_tensor
    if family == "sf":
        vec = np.log([[1.5, 4.0, 6.0, 2.0, 0.05], [0.8, 7.0, 3.0, 1.0, 0.1]])
        got = tsb._eval_sf_one(t(vec), t(s["X"]), t(s["y"]), t(tp), t(ft),
                               "rbf", 1e-6, True)
        ref = jax.vmap(lambda v, X, y, f: jsb._eval_sf_one(
            v, X, y, tp, f, "rbf", 1e-6, True))(vec, s["X"], s["y"], ft)
    elif family == "mf":
        per = np.tile([1.2, 5.0, 6.0, 2.0], (2, 3)) * rng.uniform(
            0.7, 1.3, (2, 12))
        vec = np.concatenate([per, np.ones((2, 2)),
                              [[0.05, 0.03, 0.02], [0.1, 0.05, 0.04]]], 1)
        got = tsb._eval_mf_one(t(vec), t(s["Xmf"]), t(s["fmf"]),
                               t(s["ymf"]), t(tp), t(ft), 3, "rbf", 1e-6,
                               True)
        ref = jax.vmap(lambda v, X, fi, y, f: jsb._eval_mf_one(
            v, X, fi, y, tp, f, 3, "rbf", 1e-6, True))(
            vec, s["Xmf"], jnp.asarray(s["fmf"], jnp.int32), s["ymf"], ft)
    else:
        vec = np.log([[5.0, 7.0, 2.0, 2.0, 0.3, 0.05, 0.05, 0.02],
                      [4.0, 6.0, 1.5, 1.5, 0.2, 0.04, 0.03, 0.01]])
        got = tsb._eval_nigp_one(t(vec), t(s["X"]), t(s["y"]), t(tp), t(ft),
                                 True)
        ref = jax.vmap(lambda v, X, y, f: jsb._eval_nigp_one(
            v, X, y, tp, f, True))(vec, s["X"], s["y"], ft)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-8 * float(np.abs(b).max()))


def test_process_datasets_batched_matches_jax(runs, data):
    """The same artifact files, hyperparameters within 1e-6, the metrics
    within 1e-6 (the NIGP's WMSE finite), no repair needed in float64; the
    statistics have every dataset's lanes."""
    ref, got, stats = runs
    root = data[2]
    assert sorted(os.listdir(root / "t")) == sorted(os.listdir(root / "j"))
    assert len(os.listdir(root / "t")) == 12
    for f in os.listdir(root / "t"):
        if f.endswith(".txt") and not f.startswith("MSE"):
            close(tio.load_hyp_vector(root / "t" / f),
                  tio.load_hyp_vector(root / "j" / f), 1e-6)
        elif f.startswith("MSE"):
            assert list(tio.parse_mse(root / "t" / f)) == list(
                tio.parse_mse(root / "j" / f))
    assert list(got) == list(ref)
    for base in ref:
        assert got[base].pop(ttr.F64_KEY) == 0
        assert list(got[base]) == list(ref[base])
        for k, r in ref[base].items():
            if k == "WRMSE nisf":
                assert np.isfinite(got[base][k])
                continue
            assert abs(got[base][k] - r) <= 1e-6 * max(1.0, abs(r)), k
    for key in tsb.FAMILIES:
        assert len(stats[key]["k"]) == 2 and len(stats[key]["rounds"]) == 2
        assert stats[key]["repairs"] == 0
        best = [min(f) for f in stats[key]["f"]]
        assert all(b <= f0[0] for b, f0 in zip(best, stats[key]["f0"]))


def test_fit_chunk_one_equals_all(runs, data):
    """One dataset per call gives the same results as both in one call."""
    _, got, stats = runs
    paths, settings, root = data
    mp = pytest.MonkeyPatch()
    mp.setattr(tsb, "restart_inits", jax_inits)
    st1 = {}
    try:
        one = tsb.process_datasets_batched(
            paths, settings, device=CPU, stats=st1,
            **{**RUN, "fit_chunk": 1, "eval_chunk": 1})
    finally:
        mp.undo()
    for base in got:
        for k, v in got[base].items():
            assert abs(one[base][k] - v) <= 1e-10 * max(1.0, abs(v)), k
    for key in tsb.FAMILIES:
        assert st1[key]["k"] == stats[key]["k"]
        assert st1[key]["evals"] == stats[key]["evals"]


def test_nonfinite_lane_repaired(data, monkeypatch):
    """A float32 SFGP lane whose WMSE comes out NaN is redone in float64
    from its fitted vector: finite, counted once per family it hit, and
    within rtol 0.2 of the healthy float32 value; the other families are
    untouched."""
    paths, settings, _ = data
    kw = dict(dtype=np.float32, maxiter=MAXITER, device=CPU)
    healthy = tsb.process_datasets_batched(paths[:1], settings, **kw)
    real = tsb._eval_sf_one

    def poisoned(*a):
        e = real(*a)
        return e._replace(wmse=torch.full_like(e.wmse, float("nan")))

    monkeypatch.setattr(tsb, "_eval_sf_one", poisoned)
    stats = {}
    repaired = tsb.process_datasets_batched(paths[:1], settings,
                                            stats=stats, **kw)
    base = os.path.basename(paths[0])
    assert repaired[base][ttr.F64_KEY] == 2
    assert stats["sf"]["repairs"] == stats["sfTP"]["repairs"] == 1
    for k in ("RMSE sf", "WRMSE sf", "RMSE sfTP", "WRMSE sfTP"):
        assert np.isfinite(repaired[base][k])
        np.testing.assert_allclose(repaired[base][k], healthy[base][k],
                                   rtol=0.2)
    for k in ("RMSE mf", "WRMSE mf", "RMSE nisf"):
        assert repaired[base][k] == healthy[base][k]
