"""Where the port's model classes, pipeline and commands put their data.

``MFGP``, ``MFGP.from_fidelity_lists`` (with ``stack_fidelity_lists``) and
``GP`` keep a tensor on its own device and put any other input (numpy
arrays, lists) on ``device``, which is the card unless the caller asks for
the CPU. Where torch has no CUDA device, a model built from numpy with no
``device`` raises rather than running on the CPU; with ``device="cpu"`` it
computes exactly what a model built from CPU tensors computes. The same
rule holds for the study path: the NIGP, the recursive MFGP, the fields, the
Kalman model, the trainers, the study and every command of the CLI.
"""

import numpy as np
import pytest
import torch

from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.models import mfgp as tm


def _problem(seed=0, N=24, F=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 5, (N, 3))
    fid = rng.integers(0, F, N)
    y = np.sin(X).sum(1) + 0.1 * rng.normal(size=N)
    return X, fid, y


def _build(ctor, to=lambda a: a, **kw):
    """One model of each constructor from the same numpy problem, its
    arrays passed through ``to``."""
    X, fid, y = _problem()
    if ctor == "MFGP":
        return tm.MFGP(to(X), to(fid), to(y), jitter=1e-6, **kw)
    if ctor == "GP":
        return tg.GP(to(X), to(y), jitter=1e-6, **kw)
    lists = [(to(X[fid == f]), to(y[fid == f])) for f in range(3)]
    return tm.MFGP.from_fidelity_lists([a for a, _ in lists],
                                       [b for _, b in lists], jitter=1e-6,
                                       **kw)


CTORS = ["MFGP", "GP", "from_fidelity_lists"]


@pytest.mark.parametrize("ctor", CTORS)
def test_numpy_built_model_goes_to_the_card(ctor):
    """No ``device``: the card where there is one, else an error, never a
    quiet CPU model."""
    if torch.cuda.is_available():
        m = _build(ctor)
        assert m.X.is_cuda and m.y.is_cuda and m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _build(ctor)


@pytest.mark.parametrize("ctor", CTORS)
def test_cpu_device_matches_tensor_built_model(ctor):
    """``device="cpu"`` on numpy gives the NLML and posterior of the model
    built from CPU tensors, bit for bit; later numpy data follows the
    model's device."""
    m = _build(ctor, device="cpu")
    ref = _build(ctor, to=torch.as_tensor)
    assert m.X.device.type == "cpu" and m.device == torch.device("cpu")
    assert m.log_likelihood() == ref.log_likelihood()
    Xq = np.random.default_rng(1).uniform(0, 5, (7, 3))
    for a, b in zip(m.predict(Xq), ref.predict(torch.as_tensor(Xq))):
        assert torch.equal(a, b)
    X, fid, y = _problem(seed=2)
    if ctor == "GP":
        m.set_XY(X, y)
    else:
        m.set_data(X, fid, y)
    assert m.X.device.type == "cpu" and m.y.device.type == "cpu"


def test_stack_fidelity_lists_devices():
    """Tensors keep their device; other inputs go to ``device``."""
    X, _, y = _problem()
    Xs, ys = [X[:10], X[10:]], [y[:10], y[10:]]
    Xc, fc, yc = tm.stack_fidelity_lists(Xs, ys, device="cpu")
    assert Xc.device.type == fc.device.type == yc.device.type == "cpu"
    assert torch.equal(Xc, torch.as_tensor(X))
    Xt, _ = tm.stack_fidelity_lists([torch.as_tensor(x) for x in Xs],
                                    device="cuda")
    assert Xt.device.type == "cpu"


# ---------------------------------------------------------------------------
# the study path: NIGP, the recursive MFGP, fields, the filter's model, the
# trainers, the study and the command line
# ---------------------------------------------------------------------------
def _study_calls(tmp_path):
    """name -> a call that builds on the default device (no ``device``)."""
    from mfgp_tpu_torch import cli
    from mfgp_tpu_torch.data import io, pipeline, study, trainers
    from mfgp_tpu_torch.estimation import kalman
    from mfgp_tpu_torch.fields import wrbf
    from mfgp_tpu_torch.models import mfgp_recursive as tr
    from mfgp_tpu_torch.models import nigp as tn
    from mfgp_tpu_torch.utils import configs

    X, fid, y = _problem()
    cfg = configs.SimConfig()
    traj = study.scripted_trajectory(0, cfg, duration=30.0)
    ds = io.GPDataset(np.arange(24.0), X, X, y, fid + 1)
    settings = tmp_path / "FieldSettings0.txt"
    wrbf.write_field_settings(settings, wrbf.default_sim_field(
        cfg.WS, cfg.max_depth, device="cpu"))
    traj.save(tmp_path / "traj.csv")
    lists = [X[fid == f] for f in range(3)], [y[fid == f] for f in range(3)]
    return {
        "NIGP.fit": lambda **kw: tn.NIGP(n_restarts=0, iters=0, **kw).fit(X, y),
        "NIGP.fit_native": lambda **kw: tn.NIGP(**kw).fit_native(
            X, y, n_restarts=1, maxiter=1),
        "nigp_from_numpy": lambda **kw: tn.nigp_from_numpy(
            np.zeros(8), X, y, **kw),
        "RecursiveMFGP": lambda **kw: tr.RecursiveMFGP.from_fidelity_lists(
            *lists, **kw),
        "default_sim_field": lambda **kw: wrbf.default_sim_field(
            cfg.WS, cfg.max_depth, **kw),
        "random_field": lambda **kw: wrbf.random_field(
            np.random.default_rng(0), cfg.WS, cfg.max_depth, **kw),
        "parse_field_settings": lambda **kw: wrbf.parse_field_settings(
            settings, **kw),
        "kf_model": lambda **kw: cfg.kf_model(**kw),
        "KFModel.A": lambda **kw: kalman.KFModel.A(0.1, **kw),
        "generate_estimates": lambda **kw: pipeline.generate_estimates(
            traj, cfg, **kw),
        "run_pipeline": lambda **kw: pipeline.run_pipeline(traj, cfg, **kw),
        "train_models": lambda **kw: trainers.train_models(
            ds, optimize=False, **kw),
        "training_size_study": lambda **kw: study.training_size_study(
            [8], optimize=False, **kw),
        "run_study": lambda **kw: study.run_study(
            str(tmp_path / "s"), traj_seeds=(0,), vmn_levels=(0.1,),
            duration=40.0, optimize=False, **kw),
    }


STUDY_CALLS = ["NIGP.fit", "NIGP.fit_native", "nigp_from_numpy",
                  "RecursiveMFGP", "default_sim_field", "random_field",
                  "parse_field_settings", "kf_model", "KFModel.A",
                  "generate_estimates",
                  "run_pipeline", "train_models", "training_size_study",
                  "run_study"]


@pytest.mark.parametrize("name", STUDY_CALLS)
def test_study_path_goes_to_the_card(name, tmp_path):
    """No ``device``: the card where there is one, else an error, never a
    quiet CPU run; ``device="cpu"`` runs here."""
    build = _study_calls(tmp_path)[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    else:
        build()
    build(device="cpu")


CLI_COMMANDS = {
    "sfgp": ["sfgp", "{data}"],
    "nigp": ["nigp", "{data}", "--iters", "0"],
    "mfgp": ["mfgp", "{data}"],
    "pipeline": ["pipeline", "{traj}", "--out", "{out}"],
    "trainers": ["trainers", "--data-dir", "{data_dir}", "--field-dir",
                 "{out}", "--out", "{out}"],
    "study": ["study", "--out", "{out}", "--trajectories", "1", "--vmn",
              "0.1", "--duration", "40"],
}


@pytest.mark.parametrize("cmd", sorted(CLI_COMMANDS))
def test_cli_needs_the_card_unless_asked_for_the_cpu(cmd, tmp_path):
    """Without ``--cpu`` and without a CUDA device a command raises before
    it computes or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the commands run on it")
    from mfgp_tpu_torch import cli

    fill = dict(data=str(tmp_path / "GPData_0.2_fieldMeas_0_T0_0.1.csv"),
                traj=str(tmp_path / "traj.csv"), out=str(tmp_path / "out"),
                data_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a.format(**fill) for a in CLI_COMMANDS[cmd]])
    assert not (tmp_path / "out").exists()


def test_default_params_follow_the_data():
    """``GPParams.default`` / ``MFGPParams.default`` build on the CPU when
    given no device; every caller in the package passes the data's, so a
    model's default hyperparameters live where its data lives."""
    from mfgp_tpu_torch.models import nigp as tn

    X, fid, y = _problem()
    for m in (_build("MFGP", device="cpu"), _build("GP", device="cpu")):
        assert all(p.device == m.X.device for p in m.params)
    n = tn.NIGP(n_restarts=0, iters=0, device="cpu").fit(X, y)
    mu, var = n.predict_blocked(X[:5])
    assert mu.shape == var.shape == (5,) and (var >= 1e-12).all()


@pytest.mark.parametrize("ctor", ["MFGP", "GP", "NIGP"])
def test_numpy_layout_does_not_reach_the_model(ctor):
    """A numpy array that is not row-major (a column selection of a table,
    as ``GPDataset`` hands out) becomes a contiguous tensor, as the CUDA
    kernels take it, with the same posterior as its row-major copy."""
    from mfgp_tpu_torch.models import nigp as tn

    X, fid, y = _problem()
    table = np.asfortranarray(np.column_stack([y, X, X]))
    Xf = table[:, [1, 2, 3]]
    assert not Xf.flags["C_CONTIGUOUS"] and np.array_equal(Xf, X)

    def build(x):
        if ctor == "MFGP":
            return tm.MFGP(x, fid, y, jitter=1e-6, device="cpu")
        if ctor == "GP":
            return tg.GP(x, y, jitter=1e-6, device="cpu")
        return tn.NIGP(n_restarts=0, iters=0, device="cpu").fit(x, y)

    a, b = build(Xf), build(X)
    xa = a.X_train_ if ctor == "NIGP" else a.X
    assert xa.is_contiguous()
    for u, v in zip(a.predict(X[:5]), b.predict(X[:5])):
        assert np.array_equal(np.asarray(u), np.asarray(v))


def test_every_covariance_call_gets_contiguous_points(monkeypatch):
    """The trainers' path on layouts numpy hands out by itself (column
    selections of a table, the transposed evaluation grid): every point set
    that reaches the covariance dispatch is contiguous, as the CUDA kernels
    require (the plain versions on the CPU would not notice)."""
    from mfgp_tpu_torch.data import io, trainers
    from mfgp_tpu_torch.fields import wrbf
    from mfgp_tpu_torch.ops import covariance as tcov
    from mfgp_tpu_torch.utils.configs import SimConfig

    seen = []
    for name in ("mf_train_cov", "mf_cross_cov", "sf_train_cov",
                 "sf_cross_cov", "ar1_cov_diff", "sf_cov_diff"):
        orig = getattr(tcov, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            seen.extend((_name, t.is_contiguous()) for t in args
                        if isinstance(t, torch.Tensor) and t.dim() == 2)
            return _orig(*args, **kw)

        monkeypatch.setattr(tcov, name, spy)
    X, fid, y = _problem()
    table = np.asfortranarray(np.column_stack([np.arange(24.0), X, X + 0.01,
                                               y, fid + 1.0]))
    ds = io.GPDataset(table[:, 0], table[:, [1, 2, 3]], table[:, [4, 5, 6]],
                      table[:, 7], table[:, 8].astype(int))
    assert not ds.X_est.flags["C_CONTIGUOUS"]
    cfg = SimConfig()
    tp = cfg.test_points(nums=(3, 4, 2))
    assert not tp.flags["C_CONTIGUOUS"]
    field = wrbf.default_sim_field(cfg.WS, cfg.max_depth, device="cpu")
    for mode in ("scipy", "device"):
        models = trainers.train_models(ds, device="cpu", fit_mode=mode,
                                       optimize=(mode == "scipy"),
                                       nigp_iters=1, nigp_restarts=1)
        trainers.evaluate_models(models, tp, field)
    models.nigp.predict_blocked(tp)
    assert len(seen) > 20 and {n for n, _ in seen} >= {
        "mf_train_cov", "mf_cross_cov", "sf_train_cov", "sf_cross_cov",
        "ar1_cov_diff", "sf_cov_diff"}
    assert all(ok for _, ok in seen), [n for n, ok in seen if not ok]
