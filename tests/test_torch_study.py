"""Parity of the port's trainer harness, study sweep and command line
with ``mfgp_tpu``'s on the CPU, in float64 unless said.

One tiny dataset (a 150 s scripted trajectory over the fixed 5-source
field through the port's pipeline, 29 points) is written once and read by
both packages. Fits are cut to a few iterations on both sides alike (the
optimisers' parity at length is ``test_torch_fit.py``'s), and the port's
restart points are JAX's own draws, so fitted hyperparameters agree to
1e-5 and the metrics computed from carried-over hyperparameters to 1e-6.
The NIGP's posterior covariance carries no output noise and is singular
to working precision on the 2,000-point grid, so its WMSE is compared
only where the grid is small; elsewhere it is held to be finite.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu import cli as jcli
from mfgp_tpu.data import study as jstudy
from mfgp_tpu.data import trainers as jtr
from mfgp_tpu.data import io as jio
from mfgp_tpu.fields import wrbf as jw
from mfgp_tpu.models import gp as jg
from mfgp_tpu.models import mfgp as jm
from mfgp_tpu.models import nigp as jn
from mfgp_tpu.utils import configs as jcfg
from mfgp_tpu_torch import cli as tcli
from mfgp_tpu_torch.data import io as tio
from mfgp_tpu_torch.data import pipeline as tpl
from mfgp_tpu_torch.data import study as tstudy
from mfgp_tpu_torch.data import trainers as ttr
from mfgp_tpu_torch.fields import wrbf as tw
from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.models import mfgp as tm
from mfgp_tpu_torch.models import nigp as tn
from mfgp_tpu_torch.utils import configs as tcfg

CPU = "cpu"
RMSE_KEYS = ["RMSE mf", "RMSE sf", "RMSE nisf", "RMSE sfTP"]
WMSE_KEYS = ["WRMSE mf", "WRMSE sf", "WRMSE sfTP"]


def close(port, ref, tol):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(GPData path, FieldSettings path, directory) of one tiny dataset."""
    root = tmp_path_factory.mktemp("study")
    cfg = tcfg.SimConfig(seed=0, vmn=0.1)
    traj = tstudy.scripted_trajectory(0, cfg, duration=150.0)
    field = tw.default_sim_field(cfg.WS, cfg.max_depth, device=CPU)
    tpl.run_pipeline(traj, cfg, out_dir=str(root), traj_name="T0_0.1",
                     field=field, device=CPU)
    traj.save(root / "traj.csv")
    return (str(root / "GPDataSets" / "GPData_0.2_fieldMeas_0_T0_0.1.csv"),
            str(root / "FieldData" / "FieldSettings0.txt"), root)


@pytest.fixture
def short_fits(monkeypatch):
    """Every fit of both packages cut to a few iterations, and the port's
    restart points taken from JAX's draws for the same seed."""
    def cap(cls, name, **kw):
        orig = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, **k: orig(
            self, *a, **{**k, **kw}))

    for mf, gp, ni in ((jm, jg, jn), (tm, tg, tn)):
        for cls in (mf.MFGP, gp.GP):
            cap(cls, "optimize", maxiter=5)
            cap(cls, "optimize_restarts", n_restarts=2, maxiter=4)
        cap(ni.NIGP, "fit", maxiter_opt=4)
        cap(ni.NIGP, "fit_native", maxiter=4)

    def inits(x0, n_restarts, spread, seed):
        draws = np.array(jax.random.normal(
            jax.random.key(seed), (n_restarts, x0.shape[0]), jnp.float64))
        out = x0[None, :] + spread * torch.as_tensor(draws).to(x0)
        out[0] = x0
        return out

    monkeypatch.setattr(tm, "restart_inits", inits)
    monkeypatch.setattr(tg, "restart_inits", inits)


def carry(mj: jtr.TrainedModels, ds) -> ttr.TrainedModels:
    """The port's four models with JAX's fitted hyperparameters."""
    mt = ttr.train_models(ds, optimize=False, device=CPU)
    mt.mf.set_param_array(mj.mf.param_array)
    mt.sf.set_param_array(mj.sf.param_array)
    mt.sf_tp.set_param_array(mj.sf_tp.param_array)
    n = mj.nigp
    nigp = tn.nigp_from_numpy(
        (n.lengthscales_, n.sigma_f_, n.sigma_y_, n.sigma_x_),
        np.asarray(n.X_train_), np.asarray(n.y_train_),
        np.asarray(n.noise_diag_train_), device=CPU)
    return ttr.TrainedModels(mt.mf, mt.sf, mt.sf_tp, nigp)


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fit_mode", ["scipy", "device"])
def test_train_models_matches_jax(dataset, short_fits, fit_mode):
    """The four fits, both modes: hyperparameters within 1e-5."""
    ds_j, ds_t = jio.load_gp_dataset(dataset[0]), tio.load_gp_dataset(
        dataset[0])
    kw = dict(nigp_restarts=2, nigp_iters=2, fit_mode=fit_mode)
    mj = jtr.train_models(ds_j, **kw)
    mt = ttr.train_models(ds_t, device=CPU, **kw)
    close(mt.mf.param_array, mj.mf.param_array, 1e-5)
    close(mt.sf.param_array, mj.sf.param_array, 1e-5)
    close(mt.sf_tp.param_array, mj.sf_tp.param_array, 1e-5)
    close(mt.nigp.get_params(), mj.nigp.get_params(), 1e-5)
    assert mt.mf.X.dtype == torch.float64 and mt.mf.n_fidelities == 3


def test_train_models_without_optimize(dataset):
    ds_j, ds_t = jio.load_gp_dataset(dataset[0]), tio.load_gp_dataset(
        dataset[0])
    mj = jtr.train_models(ds_j, optimize=False)
    mt = ttr.train_models(ds_t, optimize=False, device=CPU,
                          dtype=np.float32)
    close(mt.nigp.get_params(), mj.nigp.get_params(), 1e-6)
    close(mt.mf.param_array, np.ones(17), 0)
    assert mt.sf.X.dtype == mt.nigp.X_train_.dtype == torch.float32
    with pytest.raises(ValueError):
        ttr.train_models(ds_t, fit_mode="other", device=CPU)


def test_evaluate_models_matches_jax(dataset, short_fits):
    """Metrics from carried-over hyperparameters on a 45-point grid: 1e-6,
    no host repair; grids 1e-8."""
    ds_j, ds_t = jio.load_gp_dataset(dataset[0]), tio.load_gp_dataset(
        dataset[0])
    mj = jtr.train_models(ds_j, nigp_restarts=1, nigp_iters=1)
    mt = carry(mj, ds_t)
    tp = tcfg.SimConfig().test_points(nums=(3, 5, 3))
    fj = jw.parse_field_settings(dataset[1])
    ft = tw.parse_field_settings(dataset[1], device=CPU)
    for normalize in (True, False):
        ref, grids_j = jtr.evaluate_models(mj, tp, fj, normalize=normalize)
        got, grids_t = ttr.evaluate_models(mt, tp, ft, normalize=normalize)
        assert got.pop(ttr.F64_KEY) == 0
        assert list(got) == list(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6 * max(1.0, abs(ref[k])), k
        for k in grids_j:
            for a, b in zip(grids_t[k], grids_j[k]):
                close(a, b, 1e-8)


class _Fixed:
    """A model whose posterior is given."""

    def __init__(self, mu, cov):
        self.mu, self.cov = torch.as_tensor(mu), torch.as_tensor(cov)

    def predict(self, tp, **kw):
        return self.mu, self.cov.clone()


def test_evaluate_models_counts_host_repairs(dataset):
    """Two of the four covariances indefinite (one negative eigenvalue):
    those two WMSEs come from ``wmse_f64`` on the covariance's own device
    (1e-10 from the host's ``wmse_host64``) and the count says 2; the
    others are the float32 ones."""
    rng = np.random.default_rng(0)
    M = 30
    tp = rng.uniform(0, 10, (M, 3))
    ft = tw.parse_field_settings(dataset[1], device=CPU)
    Q, _ = np.linalg.qr(rng.normal(size=(M, M)))
    good = (Q * np.linspace(0.5, 2.0, M)) @ Q.T
    bad = (Q * np.r_[np.full(M - 1, 1.0), -1e-3]) @ Q.T
    mu = rng.normal(size=M)
    models = ttr.TrainedModels(
        _Fixed(mu, good.astype(np.float32)), _Fixed(mu, bad.astype(np.float32)),
        _Fixed(mu, good.astype(np.float32)), _Fixed(mu, bad.astype(np.float32)))
    metrics, _ = ttr.evaluate_models(models, tp, ft)
    assert metrics[ttr.F64_KEY] == 2
    err = mu - ft.numpy(tp)
    for key, cov in (("mf", good), ("sf", bad), ("sfTP", good),
                     ("nisf", bad)):
        assert np.isfinite(metrics[f"WRMSE {key}"])
    bad32 = bad.astype(np.float32)
    want = ttr.wmse_f64(torch.as_tensor(err, dtype=torch.float32),
                        torch.as_tensor(bad32))
    assert metrics["WRMSE sf"] == metrics["WRMSE nisf"] == want
    host = ttr.wmse_host64(err.astype(np.float32), bad32)
    assert abs(want - host) <= 1e-10 * abs(host)
    direct = float(ttr.weighted_mse(torch.as_tensor(err, dtype=torch.float32),
                                    torch.as_tensor(good.astype(np.float32))))
    assert metrics["WRMSE mf"] == direct


@pytest.mark.parametrize("normalize", [True, False])
def test_wmse_host64(normalize):
    """1e-10 against JAX's, on a definite and on an indefinite matrix
    (the jitter retries)."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(25, 25))
    e = rng.normal(size=25)
    for S in (A @ A.T + np.eye(25), A @ A.T - 3.0 * np.eye(25)):
        ref = jtr.wmse_host64(e, S, normalize)
        for got in (ttr.wmse_host64(e, S, normalize),
                    ttr.wmse_f64(torch.as_tensor(e), torch.as_tensor(S),
                                 normalize)):
            assert got == ref or abs(got - ref) <= 1e-10 * abs(ref) or (
                np.isnan(got) and np.isnan(ref))


def test_process_dataset_artifacts(dataset, short_fits, tmp_path):
    """load -> fit x4 -> evaluate -> artifacts on the 2,000-point grid: the
    files have JAX's names and parse to JAX's numbers (hyperparameters and
    RMSEs 1e-5, grids 1e-5, WMSEs of the models with output noise 1e-4
    relative)."""
    kw = dict(optimize=True, fit_mode="scipy")
    _, mj = jtr.process_dataset(dataset[0], dataset[1], str(tmp_path / "j"),
                                **kw)
    models, mt = ttr.process_dataset(dataset[0], dataset[1],
                                     str(tmp_path / "t"), device=CPU, **kw)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) and len(os.listdir(tmp_path / "t")) == 6
    assert isinstance(models, ttr.TrainedModels)
    assert set(mt) == set(mj) | {ttr.F64_KEY}
    base = "GPData_0.2_fieldMeas_0_T0_0.1_"
    for suffix in ("emuGP", "sfGP", "sfGPTP", "nisfGP"):
        close(tio.load_hyp_vector(tmp_path / "t" / f"{base}{suffix}.txt"),
              jio.load_hyp_vector(tmp_path / "j" / f"{base}{suffix}.txt"),
              1e-5)
    name = "GPRes_0.2_fieldMeas_0_T0_0.1.csv"
    gt, gj = tio.load_table(tmp_path / "t" / name), jio.load_table(
        str(tmp_path / "j" / name))
    assert gt.headers == gj.headers and gt.data.shape == (2000, 8)
    close(gt.data, gj.data, 1e-5)
    name = "MSE_0.2_fieldMeas_0_T0_0.1.txt"
    pt, pj = tio.parse_mse(tmp_path / "t" / name), jio.parse_mse(
        tmp_path / "j" / name)
    assert list(pt) == list(pj)
    for k in RMSE_KEYS:
        assert abs(pt[k] - pj[k]) <= 1e-5, k
    for k in WMSE_KEYS:
        assert abs(pt[k] - pj[k]) <= 1e-4 * abs(pj[k]), k
    assert np.isfinite(pt["WRMSE nisf"])


def test_dataset_task_and_directory_resume(dataset, tmp_path):
    data_dir, field_dir = dataset[2] / "GPDataSets", dataset[2] / "FieldData"
    fname = "GPData_0.2_fieldMeas_0_T0_0.1.csv"
    args = (fname, str(data_dir), str(field_dir), str(tmp_path))
    assert ttr.dataset_task(*args) == jtr.dataset_task(*args)
    assert ttr.dataset_task(*args)[0] is False
    kw = dict(optimize=False, device=CPU)
    res = ttr.process_directory(str(data_dir), str(field_dir), str(tmp_path),
                                **kw)
    assert list(res) == [fname] and ttr.F64_KEY in res[fname]
    assert ttr.dataset_task(*args)[0] is True
    assert ttr.process_directory(str(data_dir), str(field_dir),
                                 str(tmp_path), **kw) == {}
    again = ttr.process_directory(str(data_dir), str(field_dir),
                                  str(tmp_path), resume=False, **kw)
    assert again[fname]["RMSE mf"] == res[fname]["RMSE mf"]


@pytest.fixture
def short_batched(monkeypatch):
    """The batched study's sweeps cut to a few iterations."""
    from mfgp_tpu_torch.data import study_batched as tsb

    orig = tsb.batched_lbfgs
    monkeypatch.setattr(tsb, "batched_lbfgs", lambda *a, **k: orig(
        *a, **{**k, "maxiter": 3}))
    return tsb


def test_not_implemented_routes(dataset, short_batched, tmp_path,
                                monkeypatch):
    """``device-batched`` routes to the batched study from
    ``process_directory`` (the same results as calling it) and from
    ``run_study`` (its statistics under ``timings["batched"]``), and not
    from ``train_models``. ``run_study(closed_loop=True)`` runs on the
    port's ``closed_loop_trajectory``, whose trajectory (given the JAX
    package's filter draws) is JAX's."""
    data_dir, field_dir = dataset[2] / "GPDataSets", dataset[2] / "FieldData"
    fname = "GPData_0.2_fieldMeas_0_T0_0.1.csv"
    res = ttr.process_directory(str(data_dir), str(field_dir),
                                str(tmp_path / "d"),
                                fit_mode="device-batched", device=CPU)
    direct = short_batched.process_datasets_batched(
        [str(data_dir / fname)], [str(field_dir / "FieldSettings0.txt")],
        dtype=np.float64, device=CPU)
    assert list(res) == [fname] and res == direct
    assert ttr.F64_KEY in res[fname] and len(res[fname]) == 9
    assert len(os.listdir(tmp_path / "d")) == 6
    assert ttr.process_directory(str(data_dir), str(field_dir),
                                 str(tmp_path / "d"),
                                 fit_mode="device-batched", device=CPU) == {}
    timings = {}
    rep = tstudy.run_study(str(tmp_path / "s"), traj_seeds=(0,),
                           vmn_levels=(0.1,), duration=100.0,
                           fit_mode="device-batched", device=CPU,
                           timings=timings, fit_chunk=1, eval_chunk=1)
    assert rep["overall"]["n"] == 1
    assert set(timings["batched"]) == set(short_batched.FAMILIES)
    assert len(os.listdir(tmp_path / "s" / "GPResults")) == 7
    with pytest.raises(ValueError):
        ttr.train_models(tio.load_gp_dataset(str(data_dir / fname)),
                         fit_mode="device-batched", device=CPU)
    used, closed_loop = [], tstudy.closed_loop_trajectory

    def with_jax_draws(seed, cfg, **kw):
        key = jax.random.key(seed)

        def draws(plan_num, n):
            k = key
            for _ in range(plan_num + 1):
                k, sub = jax.random.split(k)
            return np.array(jax.random.normal(sub, (n, 6), jnp.float64))
        used.append(closed_loop(seed, cfg, kf_noise=draws, **kw))
        return used[-1]

    monkeypatch.setattr(tstudy, "closed_loop_trajectory", with_jax_draws)
    rep = tstudy.run_study(str(tmp_path / "c"), traj_seeds=(0,),
                           vmn_levels=(0.1,), closed_loop=True,
                           fit_mode="device-batched", device=CPU,
                           fit_chunk=1, eval_chunk=1)
    assert rep["overall"]["n"] == 1 and len(used) == 1
    ref = jstudy.closed_loop_trajectory(0, jcfg.SimConfig(seed=0, vmn=0.0))
    assert used[0].headers == ref.headers
    assert used[0].data.shape == ref.data.shape
    np.testing.assert_allclose(used[0].data, ref.data, rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# study
# ---------------------------------------------------------------------------
def test_study_helpers_match_jax():
    cj, ct = jcfg.SimConfig(), tcfg.SimConfig()
    assert np.array_equal(tstudy.grid_samples(ct.WS, ct.max_depth),
                          jstudy.grid_samples(cj.WS, cj.max_depth))
    a = tstudy.scripted_trajectory(3, ct, duration=50.0)
    b = jstudy.scripted_trajectory(3, cj, duration=50.0)
    assert a.headers == b.headers and np.array_equal(a.data, b.data)
    got = tstudy.training_size_study([12, 20], optimize=False, device=CPU)
    ref = jstudy.training_size_study([12, 20], optimize=False)
    for g, r in zip(got, ref):
        assert g["n"] == r["n"]
        assert abs(g["rmse"] - r["rmse"]) <= 1e-8
        assert abs(g["nlml"] - r["nlml"]) <= 1e-8 * abs(r["nlml"])


def test_run_study_matches_jax(short_fits, tmp_path):
    """2 trajectories x 1 noise level x 1 field seed of 120 s, JAX's filter
    noise injected: the same artifact tree, and the summary within 1e-5
    (the NIGP's RMSE 1e-3, its WMSE finite)."""
    kw = dict(traj_seeds=(0, 1), vmn_levels=(0.1,), field_seeds=(0,),
              duration=120.0)
    ref = jstudy.run_study(str(tmp_path / "j"), **kw)
    n = int(120.0 / 0.1) - 1
    draws = np.asarray(jax.random.normal(jax.random.key(0), (n, 6),
                                         jnp.float64))
    timings = {}
    got = tstudy.run_study(str(tmp_path / "t"), device=CPU, timings=timings,
                           filter_noises={(0, 0.1): [draws, draws]}, **kw)
    tree = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                            for d, _, fs in os.walk(r) for f in fs)
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    assert got.keys() == ref.keys()
    for section in ref:
        assert got[section].keys() == ref[section].keys()
        assert got[section]["n"] == ref[section]["n"] == 2
        for k in RMSE_KEYS + WMSE_KEYS:
            # the NIGP's alternating fit chains 20 short optimisations that
            # run into the bounds on this near-zero field, which spreads
            # the last-bit differences of the field values
            tol = 1e-3 if k == "RMSE nisf" else 1e-5
            assert abs(got[section][k] - ref[section][k]) <= tol * max(
                1.0, abs(ref[section][k])), (section, k)
        assert np.isfinite(got[section]["WRMSE nisf"])
    assert set(timings) == {"filter_s", "pipeline_s", "trainers_s",
                            "aggregate_s", ttr.F64_KEY}
    assert 0 <= timings[ttr.F64_KEY] <= 8


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------
def run_cli(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out)


def keys(doc):
    """The nested key structure of a JSON document."""
    if isinstance(doc, dict):
        return {k: keys(v) for k, v in doc.items()}
    return None


COMMANDS = ["sfgp", "nigp", "mfgp", "pipeline", "trainers", "aggregate",
            "study", "infogain-test", "explore"]
# driven in tests/test_torch_mission_paths.py
MISSION_COMMANDS = ["mission", "mission-server", "campaign"]
# driven in tests/test_torch_serve.py and tests/test_torch_viz.py
SERVE_COMMANDS = ["serve", "plot"]


@pytest.mark.parametrize("cmd", COMMANDS)
def test_cli_commands(cmd, dataset, short_fits, tmp_path, capsys):
    """Each command with ``--cpu`` on the tiny dataset: the JSON document
    has the keys of the JAX package's, and the numbers agree where both are
    deterministic."""
    data, settings, root = dataset
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    argv = {
        "sfgp": lambda o: ["sfgp", data, "--field-settings", settings],
        "nigp": lambda o: ["nigp", data, "--iters", "1"],
        "mfgp": lambda o: ["mfgp", data, "--field-settings", settings],
        "pipeline": lambda o: ["pipeline", str(root / "traj.csv"), "--out",
                               o, "--seed", "1", "--vmn", "0.1"],
        "trainers": lambda o: ["trainers", "--data-dir",
                               str(root / "GPDataSets"), "--field-dir",
                               str(root / "FieldData"), "--out", o],
        "aggregate": lambda o: ["aggregate",
                                str(tmp_path / "MSE_*.txt"), "--out",
                                os.path.join(o, "results.csv")],
        "study": lambda o: ["study", "--out", o, "--trajectories", "1",
                            "--vmn", "0.1", "--duration", "100"],
        "infogain-test": lambda o: ["infogain-test", "--seed", "2"],
        "explore": lambda o: ["explore", "--variant", "SFEGP", "--budget",
                              "10", "--bd", "1", "--plan-iters", "6",
                              "--seed", "2", "--out", o],
    }[cmd]
    if cmd == "aggregate":
        for T in range(2):
            tio.save_mse(tmp_path / f"MSE_0.2_fieldMeas_0_T{T}_0.1.txt",
                         {"RMSE mf": 1.0 + T, "WRMSE mf": 0.5})
    ref = run_cli(jcli.main, argv(str(tmp_path / "j")), capsys)
    got = run_cli(tcli.main, ["--cpu"] + argv(str(tmp_path / "t")), capsys)
    if cmd == "pipeline":
        ref["out"] = got["out"] = None
    assert keys(got) == keys(ref)
    if cmd in ("sfgp", "mfgp"):
        close(got["param_array"], ref["param_array"], 1e-5)
        assert abs(got["rmse"] - ref["rmse"]) <= 1e-5
        assert abs(got["nlml"] - ref["nlml"]) <= 1e-5 * abs(ref["nlml"])
    elif cmd == "nigp":
        close(got["params"], ref["params"], 1e-5)
        close(got["mu_head"], ref["mu_head"], 1e-5)
    elif cmd == "pipeline":
        assert got == ref
    elif cmd == "aggregate":
        assert got == ref
    elif cmd == "explore":
        # the filter's draws differ (jax.random against torch), so the
        # rows' values and the RMSE do; the first replan reads none of them
        assert {k: got[k] for k in ("variant", "replans", "n_data")} == \
            {k: ref[k] for k in ("variant", "replans", "n_data")}
        assert abs(got["budget_used"] - ref["budget_used"]) <= 1e-6
        assert np.isfinite(got["rmse"])
        assert sorted(os.listdir(tmp_path / "t")) == \
            sorted(os.listdir(tmp_path / "j"))
    elif cmd == "infogain-test":
        close([got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)],
              1e-12)


def test_cli_surface(capsys):
    ap = tcli.build_parser()
    sub = next(a for a in ap._actions if a.dest == "cmd")
    every = COMMANDS + MISSION_COMMANDS + SERVE_COMMANDS
    assert sorted(sub.choices) == sorted(every)
    jsub = next(a for a in jcli.build_parser()._actions if a.dest == "cmd")
    assert sorted(jsub.choices) == sorted(every)
    for cmd in every:
        flags = lambda p: sorted(o for a in p._actions
                                 for o in a.option_strings or [a.dest])
        assert flags(sub.choices[cmd]) == flags(jsub.choices[cmd]), cmd
    # explore prints the JAX package's keys
    argv = ["explore", "--variant", "SFGP", "--budget", "8", "--bd", "1",
            "--plan-iters", "5"]
    ref = run_cli(jcli.main, argv, capsys)
    got = run_cli(tcli.main, ["--cpu"] + argv, capsys)
    assert keys(got) == keys(ref)
    assert got["variant"] == ref["variant"] == "SFGP"


def test_cli_device_batched(short_batched, tmp_path, capsys):
    """``study --fit-mode device-batched`` with its chunk and ``ftol``
    flags runs the batched study: the summary has the keys of the JAX
    package's, over the one dataset."""
    got = run_cli(tcli.main, ["--cpu", "study", "--out", str(tmp_path),
                              "--trajectories", "1", "--vmn", "0.1",
                              "--duration", "100", "--fit-mode",
                              "device-batched", "--fit-chunk", "1",
                              "--eval-chunk", "1", "--ftol", "0"], capsys)
    assert got["overall"]["n"] == 1
    assert set(got["overall"]) >= {"RMSE mf", "WRMSE nisf", "n"}
