"""Parity of the port's restart-sharded training and sweep
(``mfgp_tpu_torch.parallel.train`` / ``sweep``) with ``mfgp_tpu.parallel``
on the CPU, in float64.

The JAX training step runs on the 8-device virtual CPU mesh with
``make_mesh(2, mp=2)`` and ``make_mesh(4, mp=2)``; the port's on four gloo
ranks (``test_torch_parallel.spawn_ranks``) with the same shapes. jax.random
cannot be reproduced, so the ranks start from JAX's own initial
``TrainState`` (``train_state_from_numpy``) and each dp rank advances its
block of the 8 restarts; the losses and parameters of 10 steps are held to
JAX's at 1e-8. The sweep runs with the live 4-rank topology: each rank
trains its own dataset file.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel import MESHES, WORLD, join_ranks, spawn_ranks

STEPS = 10
R = 8


def _np(t):
    return t.detach().cpu().numpy()


def _leaves(inp, name):
    return [inp[f"{name}{i}"] for i in range(4)]


def _train_work(rank, inp):
    """The injected JAX state through 9 update-only steps and a full step;
    fit_sharded and the grid preparation; the sweep by the live topology."""
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.models.mfgp import MFGP

    out = {"rank": rank}
    X, fid, y, grid = (torch.as_tensor(inp[k]) for k in ("X", "fid", "y",
                                                          "grid"))
    for tag in MESHES:
        mesh = par.make_mesh(int(tag), mp=2, device="cpu")
        if mesh.get_coordinate() is None:
            continue
        fns = par.make_mfgp_train_step(mesh, learning_rate=0.05)
        state = par.train_state_from_numpy(
            _leaves(inp, "p"), _leaves(inp, "mu"), _leaves(inp, "nu"),
            inp["count"], inp["step"], mesh=mesh, device="cpu")
        g, gf, M = fns.prepare_grid(inp["grid"], None, torch.float64, 3,
                                    "cpu")
        losses = []
        for _ in range(STEPS - 1):
            state, lo = fns.loss_step_fn(state, X, fid, y)
            losses.append(_np(lo))
        state, lo, mu, var = fns.step_fn(state, X, fid, y, g, gf)
        out[f"train{tag}"] = dict(
            losses=losses, last=_np(lo), mu=_np(mu)[:M], var=_np(var)[:M],
            params=[_np(p) for p in state.params], step=state.step,
            count=state.opt_state.count, grid_fid=_np(gf), M=M,
            dp=mesh.get_local_rank("dp"))
    mesh = par.make_mesh(4, mp=2, device="cpu")
    best, losses, mu, var = par.fit_sharded(mesh, inp["X"], inp["fid"],
                                            inp["y"], inp["grid"], steps=5,
                                            dtype=torch.float64,
                                            device="cpu")
    m = MFGP(X, fid, y, jitter=1e-6, device="cpu")
    m.params = best
    mu_ref, var_ref = m.predict(grid)
    out["fit"] = dict(best=[_np(p) for p in best], losses=_np(losses),
                      mu=_np(mu), var=_np(var), mu_ref=_np(mu_ref),
                      var_ref=_np(var_ref),
                      nlml=float(m.log_likelihood()))
    out["shard"] = par.process_shard(list(range(10)))
    out["env_shard"] = par.env_shard()
    d = inp["sweep_dir"].item()
    args = (os.path.join(d, "GPDataSets"), os.path.join(d, "FieldData"),
            os.path.join(d, "GPResults"))
    out["sweep"] = par.trainer_sweep(*args, device="cpu")
    torch.distributed.barrier()
    out["sweep_again"] = par.trainer_sweep(*args, device="cpu")
    return out


def _sweep_files(d, rng):
    """Four small GPData files (one per rank) and their field settings,
    written by the port's own artifact helpers."""
    from mfgp_tpu_torch.data.io import GPDATA_HEADER, Table
    from mfgp_tpu_torch.fields.wrbf import (default_sim_field,
                                            write_field_settings)

    data_dir, field_dir = d / "GPDataSets", d / "FieldData"
    data_dir.mkdir()
    field_dir.mkdir()
    field = default_sim_field([[0, 10], [0, 20]], 10.0, device="cpu")
    write_field_settings(str(field_dir / "FieldSettings0.txt"), field)
    for t in range(WORLD):
        n = 40
        X = rng.uniform(0, 10, (n, 3)) * [1, 2, 1]
        yv = field(torch.as_tensor(X)).numpy()
        rows = np.column_stack([
            np.arange(n, dtype=float), X,
            X + 0.05 * rng.standard_normal((n, 3)), yv,
            rng.integers(1, 4, n).astype(float)])
        Table(GPDATA_HEADER.split(","), rows).save(
            str(data_dir / f"GPData_0.2_fieldMeas_0_T{t}_0.csv"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, JAX's per-mesh losses/params/posterior, inputs)."""
    import jax
    import jax.numpy as jnp

    from mfgp_tpu.parallel import make_mesh
    from mfgp_tpu.parallel.train import make_mfgp_train_step

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("train_ranks")
        rng = np.random.default_rng(0)
        N, D, M = 40, 3, 37
        inp = dict(X=rng.normal(size=(N, D)), fid=rng.integers(0, 3, N),
                   grid=rng.normal(size=(M, D)))
        inp["y"] = np.sin(inp["X"].sum(1))
        fns = {tag: make_mfgp_train_step(make_mesh(int(tag), mp=2),
                                         learning_rate=0.05)
               for tag in MESHES}
        state = fns["2"].init_fn(jax.random.key(0), R, 3, D, jnp.float64)
        adam = state.opt_state[0]
        for name, leaves in (("p", state.params), ("mu", adam.mu),
                             ("nu", adam.nu)):
            for i, a in enumerate(leaves):
                inp[f"{name}{i}"] = np.asarray(a)
        inp["count"], inp["step"] = np.asarray(adam.count), np.asarray(
            state.step)
        _sweep_files(tmp, rng)
        inp["sweep_dir"] = np.asarray(str(tmp))
        ctx = spawn_ranks(_train_work, inp, tmp)
        try:
            ref = {}
            Xj, fj, yj = (jnp.asarray(inp["X"]),
                          jnp.asarray(inp["fid"], jnp.int32),
                          jnp.asarray(inp["y"]))
            for tag in MESHES:
                st = fns[tag].init_fn(jax.random.key(0), R, 3, D,
                                      jnp.float64)
                gpad, gfpad, _ = fns[tag].prepare_grid(inp["grid"], None,
                                                       jnp.float64)
                losses = []
                for _ in range(STEPS - 1):
                    st, lo = fns[tag].loss_step_fn(st, Xj, fj, yj)
                    losses.append(np.asarray(lo))
                st, lo, mu, var = fns[tag].step_fn(st, Xj, fj, yj, gpad,
                                                   gfpad)
                ref[tag] = dict(losses=losses, last=np.asarray(lo),
                                mu=np.asarray(mu)[:M], var=np.asarray(var)[:M],
                                params=[np.asarray(p) for p in st.params],
                                count=int(st.opt_state[0].count),
                                step=int(st.step), grid_fid=np.asarray(gfpad))
        finally:
            ranks = join_ranks(ctx, tmp)
    finally:
        torch.set_num_threads(n)
    return ranks, ref, inp


def _block(a, r, tag):
    """The restarts rank r holds on mesh ``tag`` (dp blocks of R)."""
    dp = 2 if tag == "4" else 1
    b = R // dp
    i = r["train" + tag]["dp"]
    return a[i * b:(i + 1) * b]


def test_ranks_import_no_jax(runs):
    ranks, _, _ = runs
    assert [r["jax_imported"] for r in ranks] == [False] * WORLD


@pytest.mark.parametrize("tag", MESHES)
def test_train_step_from_jax_state_matches_jax(runs, tag):
    """10 Adam steps from JAX's initial state: every step's losses, the
    parameters and optimiser count, the best restart's grid posterior."""
    ranks, ref, _ = runs
    want = ref[tag]
    for r in ranks[:2] if tag == "2" else ranks:
        got = r["train" + tag]
        for a, b in zip(got["losses"], want["losses"]):
            np.testing.assert_allclose(a, _block(b, r, tag), rtol=1e-8)
        np.testing.assert_allclose(got["last"], want["last"], rtol=1e-8)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, _block(b, r, tag), rtol=1e-8,
                                       atol=1e-8)
        assert (got["step"], got["count"]) == (want["step"], want["count"])
        np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-8)
        np.testing.assert_allclose(got["var"], want["var"], rtol=1e-8)
        # the loss fell and the rhos stayed fixed (kern.scale.fix([1, 1]))
        assert got["last"].min() < got["losses"][0].min()
        np.testing.assert_array_equal(got["params"][2],
                                      np.ones((got["params"][2].shape[0],
                                               2)))


@pytest.mark.parametrize("tag", MESHES)
def test_prepare_grid_defaults_to_highest_fidelity(runs, tag):
    ranks, ref, _ = runs
    for r in ranks[:2] if tag == "2" else ranks:
        gf = r["train" + tag]["grid_fid"]
        assert (gf == 2).all()
        np.testing.assert_array_equal(gf, ref[tag]["grid_fid"])


def test_fit_sharded_end_to_end(runs):
    """fit_sharded on dp=2, mp=2: every rank returns the same best
    restart; its posterior is MFGP.predict's at the default (highest)
    fidelity, and its NLML is finite."""
    ranks, _, inp = runs
    f0 = ranks[0]["fit"]
    for r in ranks:
        f = r["fit"]
        assert f["mu"].shape == (inp["grid"].shape[0],)
        assert np.isfinite(f["losses"]).all() and f["losses"].shape == (R,)
        for a, b in zip(f["best"], f0["best"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(f["mu"], f["mu_ref"], rtol=1e-8)
        np.testing.assert_allclose(f["var"], f["var_ref"], rtol=1e-8)
        assert np.isfinite(f["nlml"])


def test_train_state_from_numpy_shards_over_dp():
    from mfgp_tpu_torch.parallel import train_state_from_numpy

    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=(R,) + s) for s in ((3,), (3, 3), (2,), (3,))]
    st = train_state_from_numpy(leaves, leaves, leaves, 4, 4, device="cpu")
    assert st.step == 4 and st.opt_state.count == 4
    for a, b in zip(st.params, leaves):
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.dtype == torch.float64


def test_process_shard_partition(runs):
    from mfgp_tpu_torch.parallel.sweep import process_shard

    tasks = list(range(10))
    shards = [process_shard(tasks, i, 3) for i in range(3)]
    assert sorted(sum(shards, [])) == tasks
    assert shards[0] == [0, 3, 6, 9]
    assert process_shard(tasks) == tasks  # no process group here
    ranks, _, _ = runs
    for r in ranks:  # the live topology of the 4 ranks
        assert r["shard"] == tasks[r["rank"]::WORLD]
        assert r["env_shard"] == (r["rank"], WORLD)


def test_env_shard(monkeypatch):
    from mfgp_tpu_torch.parallel.sweep import env_shard

    assert env_shard() == (0, 1)
    monkeypatch.setenv("MFGP_SWEEP_INDEX", "2")
    monkeypatch.setenv("MFGP_SWEEP_COUNT", "5")
    assert env_shard() == (2, 5)


def test_run_sweep_isolates_failures():
    from mfgp_tpu_torch.parallel.sweep import run_sweep

    def worker(t):
        if t == 2:
            raise ValueError("boom")
        return t * 10

    res = run_sweep([1, 2, 3], worker, process_index=0, process_count=1)
    assert res[1] == 10 and res[3] == 30
    assert isinstance(res[2], ValueError)
    with pytest.raises(ValueError):
        run_sweep([2], worker, on_error="raise")


def test_trainer_sweep_end_to_end(runs, tmp_path):
    """Each of the 4 ranks trains its own dataset file; every MSE artifact
    is written once; a re-run skips everything."""
    ranks, _, inp = runs
    names = sorted(f for r in ranks for f in r["sweep"])
    assert len(names) == WORLD == len(set(names))
    for r in ranks:
        (name, metrics), = r["sweep"].items()
        assert isinstance(metrics, dict), metrics
        assert all(np.isfinite(v) for k, v in metrics.items()
                   if k.startswith("rmse"))
        assert list(r["sweep_again"].values()) == ["skipped"]
    out = os.path.join(inp["sweep_dir"].item(), "GPResults")
    assert len([f for f in os.listdir(out) if f.startswith("MSE")]) == WORLD
