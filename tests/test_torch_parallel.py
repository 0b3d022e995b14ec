"""Parity of the port's multi-device layer (``mfgp_tpu_torch.parallel`` and
the ``mesh=`` ensembles) with ``mfgp_tpu.parallel`` on the CPU, in float64.

The JAX functions run on the 8-device virtual CPU mesh of
``tests/conftest.py`` with ``make_mesh(2, mp=2)`` and ``make_mesh(4,
mp=2)``; the port's run on four gloo ranks, spawned once for the module,
with the same mesh shapes (``make_mesh(2, mp=2)`` holds ranks 0 and 1).
The ranks import neither JAX nor the JAX package; they rendezvous through
a ``FileStore`` in the test's temporary directory and write their results
there. The JAX side is computed while the ranks run. Tolerances are the
JAX package's own (``tests/test_parallel.py``).
"""

import os
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESHES = ("2", "4")  # make_mesh(2, mp=2) and make_mesh(4, mp=2)
WORLD = 4
RANKS_TIMEOUT_S = 240.0


class _MeshShape:
    """The shape of a (dp=2, mp=1) ``parallel.make_mesh`` mesh: all that
    the ensembles read before their first collective, for the checks of
    their arguments in a single process."""

    mesh_dim_names = ("dp", "mp")

    def size(self, i):
        return (2, 1)[i]


MESH_DP2 = _MeshShape()


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _rank_main(rank, world, tmp, work):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=timedelta(seconds=120))
    try:
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        out = work(rank, inputs)
        out["jax_imported"] = "jax" in sys.modules
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(work, inputs: dict, tmp, world: int = WORLD):
    """Start ``world`` gloo ranks on the CPU running ``work(rank,
    inputs)``; returns a handle for ``join_ranks``."""
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    return mp.start_processes(_rank_main, args=(world, str(tmp), work),
                              nprocs=world, join=False,
                              start_method="spawn")


def join_ranks(ctx, tmp, world: int = WORLD,
               timeout: float = RANKS_TIMEOUT_S) -> list:
    """Every rank's result dict; a rank that raised raises here, a hang
    past ``timeout`` kills the ranks and fails."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _np(t):
    return t.detach().cpu().numpy()


def _mf_params(inp, prefix):
    from mfgp_tpu_torch.models import mfgp as mf

    return mf.params_from_numpy(*(inp[f"{prefix}_{k}"] for k in (
        "lv", "ll", "rho", "ln")), "cpu", torch.float64)


def _raises(fn, exc=ValueError) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _mesh_work(mesh, inp, out, tag):
    """Every sharded function of ``mfgp_tpu_torch.parallel`` on ``mesh``."""
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.models import gp, mfgp as mf

    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    X, fid, y, grid = t["X"], t["fid"], t["y"], t["grid"]
    gpp = gp.gp_params_from_numpy(inp["gp_lv"], inp["gp_ll"], inp["gp_ln"],
                                  "cpu", torch.float64)
    gst = gp.condition(gpp, X, y, jitter=1e-10)
    out[f"gp_pred{tag}"] = [_np(a) for a in par.make_sharded_gp_predict(
        mesh)(gpp, gst, grid)]
    p = _mf_params(inp, "mf")
    mst = mf.condition(p, X, fid, y, jitter=1e-10)
    out[f"mf_pred{tag}"] = [_np(a) for a in par.make_sharded_mfgp_predict(
        mesh)(p, mst, grid, t["grid_fid2"])]
    out[f"wmse{tag}"] = float(par.make_sharded_weighted_mse(mesh)(
        t["err"], t["Sigma"]))
    out[f"xcov{tag}"] = _np(par.make_sharded_ar1_cross_cov(mesh)(
        grid, t["grid_fid"], X, fid, p))
    q = _mf_params(inp, "nl")
    f = par.make_sharded_nlml_value_and_grad(mesh, jitter=1e-6)
    v, g = f(q, t["nl_X"], t["nl_fid"], t["nl_y"])
    out[f"nlml{tag}"] = (float(v), [_np(a) for a in g])
    out[f"nlml_raises{tag}"] = _raises(lambda: f(
        q, t["nl_X"][:47], t["nl_fid"][:47], t["nl_y"][:47]))
    for layout, cases in (("block", ((64, 8), (128, 32))),
                          ("cyclic", ((64, 8), (128, 16)))):
        for n, b in cases:
            out[f"chol_{layout}{n}_{tag}"] = _np(par.make_sharded_cholesky(
                mesh, n, block=b, layout=layout)(t[f"K{n}"]))
    out[f"chol_raises{tag}"] = [_raises(lambda: par.make_sharded_cholesky(
        mesh, 63)), _raises(lambda: par.make_sharded_cholesky(
            mesh, 64, block=24)), _raises(lambda: par.make_sharded_cholesky(
                mesh, 64, layout="diag"))]
    lower, upper = par.make_sharded_tri_solves(mesh, 128, 128, block=32)
    L128 = torch.linalg.cholesky(t["K128"])
    X1 = lower(L128, t["B128"])
    out[f"tri{tag}"] = (_np(X1), _np(upper(L128, X1)))
    r = _mf_params(inp, "fs")
    for layout, b in (("block", 16), ("cyclic", 8)):
        v, g = par.make_fully_sharded_nlml_value_and_grad(
            mesh, 64, block=b, jitter=1e-8, layout=layout)(
                r, t["fs_X"], t["fs_fid"], t["fs_y"])
        out[f"fully_{layout}{tag}"] = (float(v), [_np(a) for a in g])
        out[f"kinv_{layout}{tag}"] = _kinv_work(mesh, t["K64"], 64, b,
                                                layout)


def _kinv_work(mesh, K, n, block, layout):
    """This rank's block-lower K^-1 columns from the distributed factor of
    K in ``layout``: (its mp index, their global columns, the columns, the
    recorder's ``par.sweep_macs``)."""
    from mfgp_tpu_torch.parallel import chol
    from mfgp_tpu_torch.parallel.mesh import MP_AXIS
    from mfgp_tpu_torch.utils import profiling

    my = chol._my_cols(mesh, n, block, layout)
    L = chol._chol_cols_body(mesh, K[:, my].contiguous(), n, block, layout)
    profiling.reset()
    profiling.enable()
    try:
        cols, B = chol._kinv_block_lower_cols(mesh, L, n, block, layout)
    finally:
        profiling.enable(False)
    macs = profiling.snapshot()["counters"].get("par.sweep_macs")
    profiling.reset()
    return mesh.get_local_rank(MP_AXIS), _np(cols), _np(B), macs


def _rig():
    from mfgp_tpu_torch.planning.primitives import AgentConfig
    from mfgp_tpu_torch.planning.rig_device import DeviceRIG

    rig = DeviceRIG(AgentConfig.sim_defaults(), device="cpu", cost="ergodic",
                    grid=RIG_GRID, eid=RIG_EID, **RIG_KW)
    seen = {}
    extract = rig._extract

    def keep(st, i):  # the lanes' host state, kept beside the winner
        seen["st"], seen["i"] = st, i
        return extract(st, i)

    rig._extract = keep
    return rig, seen


def _ensemble_work(mesh, out):
    """plan_ensemble, run_ensemble, run_campaign and ExplorationSim with
    their lanes/members sharded over dp."""
    from mfgp_tpu_torch.sim import ExplorationSim
    from mfgp_tpu_torch.sim.mission_device import run_campaign

    rig, seen = _rig()
    res = rig.plan_ensemble(RIG_X0, seed=3, n_plans=8, B=12.0, mesh=mesh)
    out["plan"] = (res, seen["st"], seen["i"])
    out["plan_raises"] = _raises(lambda: rig.plan_ensemble(
        RIG_X0, n_plans=3, mesh=mesh))
    m = _mission()
    out["members"] = m.run_ensemble(4, mesh=mesh)
    out["members_raises"] = _raises(lambda: m.run_ensemble(3, mesh=mesh))
    out["campaign"] = run_campaign(variants=("SFGP",), n_seeds=2, mesh=mesh,
                                   device="cpu", exp_kw=MISSION_EXP,
                                   **MISSION_SMALL)["SFGP"]["rmse"]
    sim = ExplorationSim(_sim_exp(), seed=1, plan_iters=4, device="cpu",
                         planner_backend="device", plan_ensemble=2)
    r = sim.run()
    out["sim"] = (sim._device_planner._mesh is not None,
                  r.replans[0].path_points, r.rmse, r.budget_used)


def _work(rank, inp):
    from mfgp_tpu_torch import parallel as par

    out = {"rank": rank}
    m2 = par.make_mesh(2, mp=2, device="cpu")
    m4 = par.make_mesh(4, mp=2, device="cpu")
    m14 = par.make_mesh(4, mp=4, device="cpu")
    out["shapes"] = (tuple(m2.shape), tuple(m4.shape), tuple(m14.shape),
                     tuple(par.make_mesh(device="cpu").shape))
    out["too_many"] = _raises(lambda: par.make_mesh(5, device="cpu"))
    out["no_card"] = (torch.cuda.is_available()
                      or _raises(par.make_mesh, RuntimeError))
    if m2.get_coordinate() is not None:
        _mesh_work(m2, inp, out, "2")
    _mesh_work(m4, inp, out, "4")
    out["chol_mp4"] = _np(par.make_sharded_cholesky(m14, 128, block=16)(
        torch.as_tensor(inp["K128"])))
    p, hist = par.fit_memory_scaled(m4, inp["fs_X"], inp["fs_fid"],
                                    inp["fs_y"], steps=30, block=16,
                                    device="cpu")
    f32 = [torch.as_tensor(inp[k], dtype=torch.float32)
           for k in ("fs_X", "fs_y")]
    val, _ = par.make_fully_sharded_nlml_value_and_grad(
        m4, 64, block=16, jitter=1e-6)(p, f32[0], torch.as_tensor(
            inp["fs_fid"]), f32[1])
    out["fit_memory_scaled"] = ([_np(a) for a in p], hist, float(val))
    out["default_panel"] = _default_panel_work(m14, inp)
    K1000 = torch.as_tensor(inp["K1000"])
    for layout in ("block", "cyclic"):
        out[f"kinv_{layout}_mp4"] = _kinv_work(m14, K1000, 1000, 250, layout)
    lower, upper = par.make_sharded_tri_solves(m14, 1000, 40, block=250)
    L1000 = torch.linalg.cholesky(K1000)
    X1 = lower(L1000, torch.as_tensor(inp["B1000"]))
    out["tri_mp4"] = (_np(X1), _np(upper(L1000, X1)))
    _ensemble_work(m4, out)
    return out


def _default_panel_work(mesh, inp):
    """The fully sharded NLML at N=1,000 over mp=4 at the default panel
    width, with the recorder on: the value, the gradient, the span records
    (name, id, parent), the collectives' bytes, counted both ways, and the
    sweeps' multiply-adds (``par.sweep_macs``)."""
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.parallel import mesh as pm
    from mfgp_tpu_torch.utils import profiling

    X, fid, y = (torch.as_tensor(inp[f"dp_{k}"]) for k in ("X", "fid", "y"))
    f = par.make_fully_sharded_nlml_value_and_grad(mesh, X.shape[0])
    pm.reset_collectives()
    profiling.reset()
    profiling.enable()
    try:
        v, g = f(_mf_params(inp, "dp"), X, fid, y)
    finally:
        profiling.enable(False)
    recs = [(r["name"], r["id"], r["parent"])
            for r in profiling.RECORDER.records()]
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    return dict(vg=(float(v), [_np(a) for a in g]), records=recs,
                counted=counters.get("par.collective_bytes"),
                bytes=pm.COLLECTIVES["bytes"],
                sweep_macs=counters.get("par.sweep_macs"))


# ---------------------------------------------------------------------------
# inputs and the parent's side
# ---------------------------------------------------------------------------
RIG_X0 = np.array([1.0, 1.0])
RIG_KW = dict(delta=2.0, B=8.0, WS=np.array([[0.0, 10.0], [0.0, 20.0]]),
              R=3.0, Rd=2.0, same_node_distance=0.5, budget_cutoff=0.5,
              max_iter=4, max_nodes=16, max_paths=4, samples_per_edge=8,
              max_path_points=32)


def _rig_grid():
    from mfgp_tpu_torch.metrics.eid import eid_grid

    g = np.asarray(eid_grid([[0, 10], [0, 20]], 5.0, nums=(6, 5, 2)))
    e = np.random.default_rng(0).random(g.shape[0])
    return g, e / e.sum()


RIG_GRID, RIG_EID = _rig_grid()
MISSION_SMALL = dict(plan_iters=6, e_max=6, max_nodes=16,
                     samples_per_edge=6)
MISSION_EXP = dict(B=20.0, BD=2, update_hyps=False)


def _mission():
    from mfgp_tpu_torch.sim.mission_device import DeviceMission
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    return DeviceMission(ExperimentConfig(multi_fidelity=False, ergodic=True,
                                          **MISSION_EXP),
                         seed=0, device="cpu", **MISSION_SMALL)


def _sim_exp():
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    return ExperimentConfig(multi_fidelity=False, ergodic=True, B=10, BD=1)


def _mf_leaves(prefix, lv, ll, rho, ln) -> dict:
    return {f"{prefix}_lv": np.log(lv), f"{prefix}_ll": np.log(ll),
            f"{prefix}_rho": np.asarray(rho, float),
            f"{prefix}_ln": np.log(ln)}


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    N, D, M = 40, 3, 37  # N, M not divisible by the shard count
    inp = dict(X=rng.normal(size=(N, D)), grid=rng.normal(size=(M, D)))
    inp["y"] = np.sin(inp["X"].sum(1))
    inp["fid"] = rng.integers(0, 3, N)
    inp["grid_fid"] = rng.integers(0, 3, M)
    inp["grid_fid2"] = np.full(M, 2)
    inp.update(gp_lv=np.log(1.7), gp_ll=np.log(rng.uniform(0.5, 2, D)),
               gp_ln=np.log(0.1))
    inp.update(_mf_leaves("mf", [1.5, 0.7, 0.4], rng.uniform(0.5, 2, (3, D)),
                          [1.1, 0.9], [0.2, 0.1, 0.05]))
    A = rng.normal(size=(37, 37))
    inp["Sigma"] = A @ A.T + 37 * np.eye(37)
    inp["err"] = rng.normal(size=37)
    for name, n in (("nl", 48), ("fs", 64)):
        inp[f"{name}_X"] = rng.uniform(0, 10, (n, D))
        inp[f"{name}_fid"] = rng.integers(0, 3, n)
        inp[f"{name}_y"] = np.sin(inp[f"{name}_X"].sum(1))
        inp.update(_mf_leaves(name, [2.0, 1.0, 0.5],
                              rng.uniform(0.5, 3, (3, D)), [1.2, 0.8],
                              [0.3, 0.1, 0.05]))
    for n in (64, 128):
        A = rng.normal(size=(n, n))
        inp[f"K{n}"] = A @ A.T + n * np.eye(n)
    inp["B128"] = rng.normal(size=(128, 128))
    A = rng.normal(size=(1000, 1000))
    inp["K1000"] = A @ A.T + 1000 * np.eye(1000)
    inp["B1000"] = rng.normal(size=(1000, 40))
    inp["dp_X"] = rng.uniform(0, 1, (1000, D)) * [30.0, 55.0, 4.5]
    inp["dp_fid"] = rng.integers(0, 3, 1000)
    inp["dp_y"] = np.sin(inp["dp_X"][:, 0] / 7) + 0.1 * rng.normal(size=1000)
    inp.update(_mf_leaves("dp", [25.0, 10.0, 5.0], [[12.0, 20.0, 1.5]] * 3,
                          [1.0, 1.0], [0.5, 0.2, 0.1]))
    return inp


def _plain_default_panel(inp):
    """The plain float64 reference (``benchmark/reference/gp.nlml_grad``)
    of ``_default_panel_work``'s NLML: (value, [g_logvar, g_logls,
    g_lognoise])."""
    from benchmark.reference import gp as ref

    th = dict(variances=np.exp(inp["dp_lv"]),
              lengthscales=np.exp(inp["dp_ll"]), rhos=inp["dp_rho"],
              noises=np.exp(inp["dp_ln"]))
    r = ref.nlml_grad(torch.as_tensor(inp["dp_X"]),
                      torch.as_tensor(inp["dp_fid"]),
                      torch.as_tensor(inp["dp_y"]), th, "rbf", 0.0)
    return float(r["value"]), [_np(r[k]) for k in ("g_logvar", "g_logls",
                                                   "g_lognoise")]


def _jax_side(inp) -> dict:
    """The JAX package's sharded functions on the same inputs and mesh
    shapes (8 virtual CPU devices)."""
    import jax
    import jax.numpy as jnp

    from mfgp_tpu.models import gp as jgp
    from mfgp_tpu.models import mfgp as jmf
    from mfgp_tpu.parallel import chol as jchol
    from mfgp_tpu.parallel import make_mesh
    from mfgp_tpu.parallel import sharded as jsh

    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    a = {k: jnp.asarray(v) for k, v in inp.items()}

    def params(prefix):
        return jmf.MFGPParams(*(a[f"{prefix}_{k}"] for k in (
            "lv", "ll", "rho", "ln")))

    ref = {"mesh_mp": {n: make_mesh(n).shape["mp"] for n in range(1, 9)}}
    X, fid, y, grid = a["X"], a["fid"].astype(jnp.int32), a["y"], a["grid"]
    gpp = jgp.GPParams(a["gp_lv"], a["gp_ll"], a["gp_ln"])
    gst = jgp.condition(gpp, X, y, jitter=1e-10)
    p = params("mf")
    mst = jmf.condition(p, X, fid, y, jitter=1e-10)
    for tag in MESHES:
        mesh = make_mesh(int(tag), mp=2)
        ref[f"gp_pred{tag}"] = jsh.make_sharded_gp_predict(mesh)(gpp, gst,
                                                                  grid)
        ref[f"mf_pred{tag}"] = jsh.make_sharded_mfgp_predict(mesh)(
            p, mst, grid, a["grid_fid2"].astype(jnp.int32))
        ref[f"wmse{tag}"] = jsh.make_sharded_weighted_mse(mesh)(
            a["err"], a["Sigma"])
        ref[f"xcov{tag}"] = jsh.make_sharded_ar1_cross_cov(mesh)(
            grid, a["grid_fid"].astype(jnp.int32), X, fid, p)
        ref[f"nlml{tag}"] = jsh.make_sharded_nlml_value_and_grad(
            mesh, jitter=1e-6)(params("nl"), a["nl_X"],
                               a["nl_fid"].astype(jnp.int32), a["nl_y"])
        for layout, b in (("block", 16), ("cyclic", 8)):
            ref[f"fully_{layout}{tag}"] = \
                jchol.make_fully_sharded_nlml_value_and_grad(
                    mesh, 64, block=b, jitter=1e-8, layout=layout)(
                        params("fs"), a["fs_X"],
                        a["fs_fid"].astype(jnp.int32), a["fs_y"])
        ref[f"chol_block64_{tag}"] = jchol.make_sharded_cholesky(
            mesh, 64, block=8)(a["K64"])
        ref[f"chol_cyclic64_{tag}"] = jchol.make_sharded_cholesky(
            mesh, 64, block=8, layout="cyclic")(a["K64"])
        lower, upper = jchol.make_sharded_tri_solves(mesh, 128, 128,
                                                     block=32)
        L = jnp.linalg.cholesky(a["K128"])
        X1 = lower(L, a["B128"])
        ref[f"tri{tag}"] = (X1, upper(L, X1))
    ref["nlml_local"] = jmf.nlml_value_and_grad(
        params("nl"), a["nl_X"], a["nl_fid"].astype(jnp.int32), a["nl_y"],
        jitter=1e-6)
    ref["fully_local"] = jmf.nlml_value_and_grad(
        params("fs"), a["fs_X"], a["fs_fid"].astype(jnp.int32), a["fs_y"],
        jitter=1e-8)
    ref["panel"] = {(n, m, b, lay): jchol.panel_utilization(n, m, b, lay)
                    for n, m, b in ((2048, 8, 64), (8192, 8, 64), (64, 2, 8),
                                    (20000, 2, 250), (20000, 4, 250))
                    for lay in ("block", "cyclic")}
    ref["perm"] = {(n, m, b): jchol.cyclic_permutation(n, m, b)
                   for n, m, b in ((64, 2, 8), (128, 4, 16),
                                   (20000, 2, 250))}
    return jax.tree.map(np.asarray, ref)


def _solo(sim_exp):
    """The parent's one-device references of the ensembles."""
    from mfgp_tpu_torch.sim import ExplorationSim
    from mfgp_tpu_torch.sim.mission_device import run_campaign

    rig, seen = _rig()
    res = rig.plan_ensemble(RIG_X0, seed=3, n_plans=8, B=12.0)
    sim = ExplorationSim(sim_exp, seed=1, plan_iters=4, device="cpu",
                         planner_backend="device", plan_ensemble=2)
    r = sim.run()
    return {"plan": (res, seen["st"], seen["i"]),
            "members": _mission().run_ensemble(4),
            "campaign": run_campaign(variants=("SFGP",), n_seeds=2,
                                     device="cpu", exp_kw=MISSION_EXP,
                                     **MISSION_SMALL)["SFGP"]["rmse"],
            "sim": (r.replans[0].path_points, r.rmse, r.budget_used)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, JAX references, one-device port references, the
    inputs): the ranks run while the parent computes the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("ranks")
        inp = _inputs()
        ctx = spawn_ranks(_work, inp, tmp)
        try:
            ref = _jax_side(inp)
            solo = _solo(_sim_exp())
            solo["default_panel"] = _plain_default_panel(inp)
        finally:
            ranks = join_ranks(ctx, tmp)
    finally:
        torch.set_num_threads(n)
    return ranks, ref, solo, inp


def _owners(ranks, tag):
    return ranks[:2] if tag == "2" else ranks


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_ranks_import_no_jax(runs):
    ranks, *_ = runs
    assert [r["jax_imported"] for r in ranks] == [False] * WORLD


def test_mesh_shape(runs):
    """make_mesh's shapes and default mp rule are JAX's; more ranks than
    the group has raises; no process group raises, and so does the card
    by default where there is none."""
    from mfgp_tpu_torch.parallel import make_mesh
    from mfgp_tpu_torch.parallel.mesh import default_mp

    ranks, ref, _, _ = runs
    for r in ranks:
        mp4 = ref["mesh_mp"][4]
        assert r["shapes"] == ((1, 2), (2, 2), (1, 4), (4 // mp4, mp4))
        assert r["too_many"] and r["no_card"]
    assert {n: default_mp(n) for n in ref["mesh_mp"]} == ref["mesh_mp"]
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(1, device="cpu")


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_gp_predict_matches_jax(runs, tag):
    ranks, ref, _, _ = runs
    for r in _owners(ranks, tag):
        mu, var = r[f"gp_pred{tag}"]
        np.testing.assert_allclose(mu, ref[f"gp_pred{tag}"][0], rtol=1e-12)
        np.testing.assert_allclose(var, ref[f"gp_pred{tag}"][1], rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_mfgp_predict_matches_jax(runs, tag):
    ranks, ref, _, _ = runs
    for r in _owners(ranks, tag):
        mu, var = r[f"mf_pred{tag}"]
        np.testing.assert_allclose(mu, ref[f"mf_pred{tag}"][0], rtol=1e-12)
        np.testing.assert_allclose(var, ref[f"mf_pred{tag}"][1], rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_wmse_matches_jax(runs, tag):
    ranks, ref, _, _ = runs
    w = float(ref[f"wmse{tag}"])
    for r in _owners(ranks, tag):
        assert abs(r[f"wmse{tag}"] - w) < 1e-12 * max(1.0, abs(w))


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_cross_cov_matches_jax(runs, tag):
    ranks, ref, _, _ = runs
    for r in _owners(ranks, tag):
        np.testing.assert_allclose(r[f"xcov{tag}"], ref[f"xcov{tag}"],
                                   rtol=1e-12)


def _assert_vg(got, ref):
    v, g = got
    np.testing.assert_allclose(v, float(ref[0]), rtol=1e-12)
    for a, b in zip(g, ref[1]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-10)


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_nlml_grad_matches_jax(runs, tag):
    """The column-sharded K^-1 gradient == JAX's sharded and local
    gradients; an N the mp extent does not divide raises."""
    ranks, ref, _, _ = runs
    for r in _owners(ranks, tag):
        _assert_vg(r[f"nlml{tag}"], ref[f"nlml{tag}"])
        _assert_vg(r[f"nlml{tag}"], ref["nlml_local"])
        assert r[f"nlml_raises{tag}"]


@pytest.mark.parametrize("layout", ["block", "cyclic"])
@pytest.mark.parametrize("tag", MESHES)
def test_fully_sharded_nlml_grad_matches_jax(runs, tag, layout):
    """Assembly, distributed Cholesky, distributed solves and psum'd
    contractions == JAX's fully sharded and local gradients, in both
    layouts."""
    ranks, ref, _, _ = runs
    for r in _owners(ranks, tag):
        _assert_vg(r[f"fully_{layout}{tag}"], ref[f"fully_{layout}{tag}"])
        _assert_vg(r[f"fully_{layout}{tag}"], ref["fully_local"])


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_cholesky_matches_dense_and_jax(runs, tag):
    """Both layouts == numpy's factor (and each other) at the JAX test's
    panel widths; == JAX's sharded factor; layout violations raise."""
    ranks, ref, _, inp = runs
    for r in _owners(ranks, tag):
        for n in (64, 128):
            L = np.linalg.cholesky(inp[f"K{n}"])
            for layout in ("block", "cyclic"):
                np.testing.assert_allclose(r[f"chol_{layout}{n}_{tag}"], L,
                                           atol=1e-12)
            np.testing.assert_allclose(r[f"chol_cyclic{n}_{tag}"],
                                       r[f"chol_block{n}_{tag}"], atol=1e-12)
        for layout in ("block", "cyclic"):
            np.testing.assert_allclose(r[f"chol_{layout}64_{tag}"],
                                       ref[f"chol_{layout}64_{tag}"],
                                       atol=1e-12)
        assert r[f"chol_raises{tag}"] == [True, True, True]
    for r in ranks:  # mp=4
        np.testing.assert_allclose(r["chol_mp4"],
                                   np.linalg.cholesky(inp["K128"]),
                                   atol=1e-12)


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_tri_solves_match_scipy_and_jax(runs, tag):
    import scipy.linalg as sla

    ranks, ref, _, inp = runs
    L = np.linalg.cholesky(inp["K128"])
    for r in _owners(ranks, tag):
        X1, X2 = r[f"tri{tag}"]
        np.testing.assert_allclose(
            X1, sla.solve_triangular(L, inp["B128"], lower=True), atol=1e-12)
        np.testing.assert_allclose(
            X2, sla.solve_triangular(L.T, X1, lower=False), atol=1e-12)
        np.testing.assert_allclose(X1, ref[f"tri{tag}"][0], atol=1e-12)
        np.testing.assert_allclose(X2, ref[f"tri{tag}"][1], atol=1e-12)


def test_sharded_tri_solves_mp4_match_scipy(runs):
    """The general sweeps (arbitrary right-hand sides, full height) over
    mp=4 at N=1,000, panels of 250, == scipy's triangular solves."""
    import scipy.linalg as sla

    ranks, _, _, inp = runs
    L = np.linalg.cholesky(inp["K1000"])
    X1_ref = sla.solve_triangular(L, inp["B1000"], lower=True)
    for r in ranks:
        X1, X2 = r["tri_mp4"]
        np.testing.assert_allclose(X1, X1_ref, atol=1e-12)
        np.testing.assert_allclose(
            X2, sla.solve_triangular(L.T, X1_ref, lower=False), atol=1e-12)


# (mp, n, panel, result key; the key names L's layout): the mp=2 meshes at
# the JAX test's panel widths, and mp=4 at N=1,000 with panels of 250
KINV_CASES = [(2, 64, 16, "kinv_block2"), (2, 64, 8, "kinv_cyclic2"),
              (2, 64, 16, "kinv_block4"), (2, 64, 8, "kinv_cyclic4"),
              (4, 1000, 250, "kinv_block_mp4"),
              (4, 1000, 250, "kinv_cyclic_mp4")]


def _kinv_ranks(ranks, key):
    """The results ``key`` of every rank that computed it."""
    return [r[key] for r in ranks if key in r]


def _sweep_macs(n, n_mp, block, idx):
    """The closed form of rank ``idx``'s block-lower sweeps: each of its
    block-cyclic panels p (of n / block) is live in both sweeps while the
    panel step's trailing rows remain, block^3 (P - p)(P - p - 1) / 2 for
    each sweep, P = n / block."""
    P = n // block
    return block ** 3 * sum((P - p) * (P - p - 1)
                            for p in range(idx, P, n_mp))


@pytest.mark.parametrize("n_mp,n,block,key", KINV_CASES,
                         ids=[c[-1] for c in KINV_CASES])
def test_block_lower_kinv_matches_the_dense_inverse(runs, n_mp, n, block,
                                                     key):
    """Each rank's block-lower K^-1 columns, from either layout of L, are
    its block-cyclic identity columns, equal the dense inverse's entries
    in the panels at and below each column's own to 1e-12 in float64, and
    are exactly zero above."""
    from mfgp_tpu_torch.parallel.chol import _local_to_global_cols

    ranks, _, _, inp = runs
    Kinv = np.linalg.inv(inp[f"K{n}"])
    got = _kinv_ranks(ranks, key)
    assert len(got) == (2 if key.endswith("2") else 4)
    for idx, cols, B, _ in got:
        np.testing.assert_array_equal(cols, _local_to_global_cols(
            idx, n // n_mp, block, n_mp, "cyclic"))
        live = (np.arange(n)[:, None] // block) >= (cols[None, :] // block)
        np.testing.assert_allclose(B[live], Kinv[:, cols][live], rtol=0,
                                   atol=1e-12)
        assert not np.any(B[~live])


@pytest.mark.parametrize("n_mp,n,block,key", KINV_CASES,
                         ids=[c[-1] for c in KINV_CASES])
def test_sweep_macs_match_the_closed_form(runs, n_mp, n, block, key):
    """The recorder's ``par.sweep_macs`` is the closed form of the
    block-lower sweeps' multiply-adds on each rank, and the same from
    either layout of L at one panel width."""
    ranks, *_ = runs
    for idx, _, _, macs in _kinv_ranks(ranks, key):
        assert macs == _sweep_macs(n, n_mp, block, idx)
    if n_mp == 4:
        for r in ranks:
            assert r["kinv_block_mp4"][3] == r["kinv_cyclic_mp4"][3]


def test_fully_sharded_counts_its_sweep_macs(runs):
    """The fully sharded NLML at N=1,000 over mp=4 (panels of 250, block
    layout) counts its sweeps' closed form on each rank: together 20 of
    the full-height sweeps' 48 panel cubes."""
    ranks, *_ = runs
    got = [r["default_panel"]["sweep_macs"] for r in ranks]
    assert got == [_sweep_macs(1000, 4, 250, i) for i in range(4)]
    assert sum(got) == 20 * 250 ** 3


def test_panel_utilization_and_permutation_match_jax(runs):
    from mfgp_tpu_torch.parallel.chol import (cyclic_permutation,
                                              panel_utilization)

    _, ref, _, _ = runs
    for (n, m, b, lay), u in ref["panel"].items():
        assert panel_utilization(n, m, b, lay) == float(u)
    for (n, m, b), perm in ref["perm"].items():
        np.testing.assert_array_equal(cyclic_permutation(n, m, b), perm)
    assert sorted(cyclic_permutation(64, 2, 8).tolist()) == list(range(64))


def test_fully_sharded_default_panel_matches_plain_reference(runs):
    """At N=1,000 over mp=4 with no panel width given (250, from the
    shard), the fully sharded NLML and gradient equal the plain float64
    reference to 1e-10 on every rank."""
    ranks, _, solo, _ = runs
    v_ref, g_ref = solo["default_panel"]
    scale = max(np.max(np.abs(g)) for g in g_ref)
    for r in ranks:
        v, g = r["default_panel"]["vg"]
        assert abs(v - v_ref) <= 1e-10 * abs(v_ref)
        for got, want in zip((g[0], g[1], g[3]), g_ref):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)
        assert not np.any(g[2])  # rhos held fixed


def test_fully_sharded_spans_and_collective_bytes(runs):
    """With the recorder on, one call records one ``par.nlml`` on every
    rank, with ``par.gram``, ``par.chol``, ``par.trisolve``, ``par.grad``
    and every ``par.comm`` inside it, and the recorder's
    ``par.collective_bytes`` equals ``COLLECTIVES["bytes"]``."""
    ranks, *_ = runs
    for r in ranks:
        dp = r["default_panel"]
        names = [name for name, _, _ in dp["records"]]
        assert names.count("par.nlml") == 1
        for stage in ("par.gram", "par.chol", "par.trisolve", "par.grad"):
            assert names.count(stage) == 1, stage
        assert names.count("par.comm") > 3 * 4  # every panel's broadcast
        by_id = {i: (name, parent) for name, i, parent in dp["records"]}
        for name, _, parent in dp["records"]:
            if name == "par.nlml":
                continue
            while by_id[parent][0] != "par.nlml":
                parent = by_id[parent][1]
        assert dp["counted"] == dp["bytes"] > 0


@pytest.mark.parametrize("n", [80_000, 20_000, 1_000])
def test_panel_width_from_the_shard(n):
    from mfgp_tpu_torch.parallel import panel_width

    assert panel_width(n, 4) == 250


def test_panel_width_raises():
    """Under 32 the default raises and names the nearest n that works; an
    explicit width that does not divide the shard raises as before."""
    from mfgp_tpu_torch.parallel import panel_width

    with pytest.raises(ValueError, match="nearest n that works is 3984"):
        panel_width(3988, 4)
    with pytest.raises(ValueError, match="nearest n that works is 128"):
        panel_width(8, 4)
    assert panel_width(3984, 4) == 249
    with pytest.raises(ValueError,
                       match="column block 20000 not divisible by panel 256"):
        panel_width(80_000, 4, 256)
    with pytest.raises(ValueError, match="not divisible by mp=4"):
        panel_width(1002, 4)


def test_init_ranks_binds_local_rank(monkeypatch):
    """``init_ranks`` reads torchrun's environment, binds ``cuda:LOCAL_RANK``
    before the group is made, and makes the group bound to that device with
    a finite timeout; without that environment it raises."""
    from mfgp_tpu_torch.parallel import init_ranks

    calls = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append(("init", a, k)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_ranks()
    monkeypatch.setenv("RANK", "6")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    dev = init_ranks(timeout_s=90.0)
    assert dev == torch.device("cuda", 2)
    assert calls == [("set_device", dev), ("init", ("nccl",), dict(
        init_method="env://", rank=6, world_size=8,
        timeout=timedelta(seconds=90.0), device_id=dev))]


def test_init_ranks_joins_a_gloo_group(monkeypatch):
    """A real gloo group of one rank through the launcher's environment:
    the rank's device is the CPU and ``make_mesh`` runs on the group."""
    import socket

    from mfgp_tpu_torch.parallel import init_ranks, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    try:
        assert init_ranks("gloo", timeout_s=30.0) == torch.device("cpu")
        assert dist.get_world_size() == 1
        assert tuple(make_mesh(device="cpu").shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_fit_memory_scaled_converges(runs):
    """Adam over the fully sharded gradient (float32) decreases the NLML,
    and the sharded objective at the returned parameters is the local
    NLML (the JAX test's holds)."""
    from mfgp_tpu_torch.models import mfgp as mf

    ranks, _, _, inp = runs
    f32 = [torch.as_tensor(inp[k], dtype=torch.float32)
           for k in ("fs_X", "fs_y")]
    for r in ranks:
        leaves, hist, val_shard = r["fit_memory_scaled"]
        assert hist[-1] < hist[0] and np.isfinite(hist).all()
        p = mf.MFGPParams(*(torch.as_tensor(a) for a in leaves))
        assert p.log_variances.dtype == torch.float32
        val = float(mf.nlml(p, f32[0], torch.as_tensor(inp["fs_fid"]),
                            f32[1], jitter=1e-6))
        np.testing.assert_allclose(val_shard, val, rtol=1e-4)


def test_plan_ensemble_sharded_equals_one_device(runs):
    """8 lanes over dp=2: every lane's state is the one-device ensemble's
    lane, and the winner is the same plan; n_plans not divisible by dp
    raises."""
    ranks, _, solo, _ = runs
    res0, st0, i0 = solo["plan"]
    for r in ranks:
        res, st, i = r["plan"]
        assert i == i0 and set(st) == set(st0)
        for k in st0:
            np.testing.assert_array_equal(st[k], st0[k], err_msg=k)
        assert (res.info, res.budget, res.chain) == (res0.info, res0.budget,
                                                     res0.chain)
        np.testing.assert_array_equal(res.points, res0.points)
        assert r["plan_raises"]


def test_run_ensemble_sharded_equals_one_device(runs):
    """4 members over dp=2 (and a 2-seed campaign) == the one-device
    ensemble member by member; a launch width not divisible by dp
    raises."""
    ranks, _, solo, _ = runs
    for r in ranks:
        assert len(r["members"]) == 4 and r["members_raises"]
        for a, b in zip(r["members"], solo["members"]):
            assert a.n_replans == b.n_replans and a.replans == b.replans
            np.testing.assert_array_equal(a.flown_mask, b.flown_mask)
            for k in ("flown", "eids", "test_mu", "test_var"):
                np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                           rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(a.gp_data.data, b.gp_data.data,
                                       rtol=1e-10, atol=1e-12)
            assert a.rmse == pytest.approx(b.rmse, rel=1e-10)
        np.testing.assert_allclose(r["campaign"], solo["campaign"],
                                   rtol=1e-10)


def test_exploration_sim_shards_its_plan_ensemble(runs):
    """Under a process group of 4 ranks the simulator's 2-plan ensemble
    shards over dp=2 by itself (make_mesh's default layout), and plans
    what the one-device simulator plans."""
    ranks, _, solo, _ = runs
    pts, rmse, budget = solo["sim"]
    for r in ranks:
        sharded, p, rm, bu = r["sim"]
        assert sharded
        np.testing.assert_array_equal(p, pts)
        assert (rm, bu) == (rmse, budget)
