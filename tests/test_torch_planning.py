"""Parity of the port's host planner (``mfgp_tpu_torch.planning``,
``ExperimentConfig`` and ``SimConfig.agent()``, ``cli infogain-test``)
with ``mfgp_tpu`` on the CPU, in float64.

Both packages get the same seeded numpy inputs: the same training data and
hyperparameters (carried across with ``set_param_array``), the same padded
candidate set (some of it masked), the same RIG seeds. The six costs'
``__call__`` and ``batch`` agree to 1e-9 relative or 1e-12 absolute; a
seeded ``RIGPlanner.plan`` with each cost picks the same best path (nodes
and edges) with the same score and the same ``stats``.

Routing note: on a CUDA float32 model each covariance block of a batch is
one launch of B1's lane axis; on the CPU (and in float64) the lanes take
B1's plain version, which is what is compared here (B1's lanes are held
against single-lane launches on the card, ``tests/test_torch_cuda.py``).
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mfgp_tpu.models import gp as jgp
from mfgp_tpu.models import mfgp as jmf
from mfgp_tpu.planning import primitives as jpr
from mfgp_tpu.planning import rig as jrig
from mfgp_tpu.planning import scoring as jsc
from mfgp_tpu.utils import configs as jcfg
from mfgp_tpu_torch import planning as tplan
from mfgp_tpu_torch.models import gp as tgp
from mfgp_tpu_torch.models import mfgp as tmf
from mfgp_tpu_torch.ops import cuda_kernels as ck
from mfgp_tpu_torch.planning import primitives as tpr
from mfgp_tpu_torch.planning import rig as trig
from mfgp_tpu_torch.planning import scoring as tsc
from mfgp_tpu_torch.utils import configs as tcfg

RTOL, ATOL = 1e-9, 1e-12
WS = np.array([[0.0, 10.0], [0.0, 20.0]])
MAX_DEPTH = 10.0
FID_LEVELS = (0.25, 2.25, 6.25)
# 17 entries: per fidelity [var, l_x, l_y, l_z], the two rhos, three noises
MF_VEC = np.array([1.4, 3.0, 4.0, 2.5, 0.8, 2.0, 3.5, 2.0, 0.5, 2.5, 3.0,
                   1.5, 0.9, 1.1, 0.04, 0.02, 0.01])
SF_VEC = np.array([1.3, 3.0, 4.0, 2.5, 0.03])
COSTS = ["ergodic", "fourier", "sf_gain", "mf_gain", "sf_logdet",
         "mf_logdet"]


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def training(seed=0, N=45):
    rng = np.random.default_rng(seed)
    X = rng.uniform([0, 0, 0], [10, 20, MAX_DEPTH], (N, 3))
    fid = rng.integers(0, 3, N)
    y = np.sin(0.4 * X[:, 0]) + np.cos(0.2 * X[:, 1]) - 0.1 * X[:, 2] \
        + 0.05 * rng.normal(size=N)
    return X, fid, y


def models(kernel="rbf"):
    """The same 3-fidelity MFGP and GP in both packages (param_array
    carried across)."""
    X, fid, y = training()
    out = {}
    for lib, MF, GP, kw in (("jax", jmf.MFGP, jgp.GP, {}),
                            ("torch", tmf.MFGP, tgp.GP,
                             {"device": "cpu"})):
        mf = MF(X, fid, y, kernel=kernel, jitter=1e-6, **kw)
        mf.set_param_array(MF_VEC)
        gp = GP(X, y, kernel=kernel, jitter=1e-6, **kw)
        gp.set_param_array(SF_VEC)
        out[lib] = (mf, gp)
    return out


def grids():
    from mfgp_tpu.metrics.eid import eid_grid

    eid_g = eid_grid(WS.tolist(), MAX_DEPTH, nums=(5, 6, 4))  # 120 points
    ig_g = eid_grid(WS.tolist(), MAX_DEPTH, nums=(4, 3, 3))  # 36 points
    rng = np.random.default_rng(3)
    eid = rng.uniform(0, 1, eid_g.shape[0])
    eid[[5, 17]] = 0.0  # zero mass: the reference's floor applies
    return eid / eid.sum(), eid_g, ig_g


def candidates(seed=1):
    """Paths of 3 to 29 rows (x, y, depth, t, variance): padded to one
    bucket of 32, so most lanes carry a mask."""
    rng = np.random.default_rng(seed)
    paths = []
    for n in (3, 9, 29, 14, 6):
        xyz = rng.uniform([0, 0, 0], [10, 20, MAX_DEPTH], (n, 3))
        tt = np.cumsum(rng.uniform(1.0, 5.0, n))
        var = np.sort(rng.uniform(0.0, 8.0, n))
        paths.append(np.column_stack([xyz, tt, var]))
    return paths


def make_cost(lib, name, kernel="rbf"):
    sc = {"jax": jsc, "torch": tsc}[lib]
    mf, gp = models(kernel)[lib]
    eid, eid_g, ig_g = grids()
    dev = {"device": "cpu", "dtype": torch.float64} if lib == "torch" else {}
    bounds = np.array([[0, 10], [0, 20], [0, MAX_DEPTH]], float)
    return {
        "ergodic": lambda: sc.ErgodicCost(eid=eid, grid=eid_g, **dev),
        "fourier": lambda: sc.FourierErgodicCost(eid=eid, grid=eid_g,
                                                 bounds=bounds, **dev),
        "sf_gain": lambda: sc.SFInfoGainCost(gp),
        "mf_gain": lambda: sc.MFInfoGainCost(mf, FID_LEVELS),
        "sf_logdet": lambda: sc.BatchLogDetCost(gp, ig_g),
        "mf_logdet": lambda: sc.MFBatchLogDetCost(mf, ig_g, FID_LEVELS),
    }[name]()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_experiment_config_against_jax():
    """Grids, physical hyperparameters, the field transform and the
    variant names of ``ExperimentConfig``; ``SimConfig.agent()``."""
    for kw in ({}, {"multi_fidelity": False, "ergodic": False},
               {"ergodic": False}, {"multi_fidelity": False}):
        te, je = tcfg.ExperimentConfig(**kw), jcfg.ExperimentConfig(**kw)
        assert te.variant == je.variant
        for f in ("erg_grid", "ig_grid", "robot_test_points"):
            close(getattr(te, f)(), getattr(je, f)(), 0, 0)
    te, je = tcfg.ExperimentConfig(), jcfg.ExperimentConfig()
    close(te.physical_init_hyps_sf(), je.physical_init_hyps_sf(), 0, 0)
    close(te.physical_init_hyps_mf(), je.physical_init_hyps_mf(), 0, 0)
    x = np.linspace(0.0, 255.0, 7)
    close(te.field_transform(x), je.field_transform(x), 0, 0)
    assert [f.name for f in dataclasses.fields(te)] == \
        [f.name for f in dataclasses.fields(je)]
    assert (dataclasses.asdict(tcfg.SimConfig(vmn=0.1).agent())
            == dataclasses.asdict(jcfg.SimConfig(vmn=0.1).agent()))
    assert tcfg.ExperimentConfig().sim.agent().fid_levels == FID_LEVELS


# ---------------------------------------------------------------------------
# primitives (a copy)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dense", [False, True])
def test_primitives_copy(dense):
    """The same trajectories, rollouts and path points from the same
    ``np.random.default_rng`` seed."""
    cfgs = (tpr.AgentConfig.sim_defaults(), jpr.AgentConfig.sim_defaults())
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
    outs = []
    for pr, cfg in zip((tpr, jpr), cfgs):
        rng = np.random.default_rng(11)
        legs = [pr.Leg.GLIDE, pr.Leg.SWIM, pr.Leg.FLATDIVE]
        edges, states = [], {0: np.array([[1.0], [2.0]])}
        for i in range(4):
            choices = rng.choice(3, cfg.num_legs)
            tt, prims = pr.generate_trajectory(
                rng, [legs[c] for c in choices], 6.0 + i, cfg)
            states[i + 1] = states[i] + np.array([[3.0], [2.0 + i]])
            edges.append((i, i + 1, prims))
        rollout = pr.evaluate_trajectory(edges[0][2], cfg)
        pts = pr.path_to_traj_points(states, edges, cfg, dense=dense)
        outs.append((tt, [[int(p[0])] + list(p[1:]) for e in edges
                          for p in e[2]], rollout[3], rollout[4], pts))
    (tt, prims, wp, bu, pts), (jtt, jprims, jwp, jbu, jpts) = outs
    assert tt == jtt and prims == jprims and bu == jbu
    close(wp, jwp, 0, 0)
    close(pts, jpts, 0, 0)


# ---------------------------------------------------------------------------
# the six costs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kernel",
                         [(c, "rbf") for c in COSTS]
                         + [(c, "matern32") for c in COSTS[2:]])
def test_cost_parity(name, kernel):
    """``__call__`` on each path and ``batch`` on the padded set against
    ``mfgp_tpu``; the empty path scores -inf in both."""
    paths = candidates()
    tc, jc = make_cost("torch", name, kernel), make_cost("jax", name, kernel)
    got = tc.batch(paths)
    assert got.dtype == np.float64 and got.shape == (len(paths),)
    close(got, jc.batch(paths))
    for p in paths[:3]:
        close(tc(p), jc(p))
    assert tc(np.zeros((0, 5))) == jc(np.zeros((0, 5))) == -np.inf
    if name.endswith("logdet"):
        close(tc._logdet_prior, jc._logdet_prior)


@pytest.mark.parametrize("name", COSTS)
def test_batch_equals_serial(name):
    """Within the port: one batch of lanes scores each path as its own
    call does (padding and masks change nothing but rounding)."""
    paths = candidates(seed=2)
    cost = make_cost("torch", name)
    close(cost.batch(paths), [cost(p) for p in paths])


def test_mf_gain_covariances_through_b1_lanes(monkeypatch):
    """Each covariance block of a batch is one call of B1's lane axis
    (4 for the MF sequential gain, 2 for the SF one, 3 per log-det batch,
    none for the ergodic costs), with the candidates as lanes; ``Kcc``
    gets the same tensors twice (the symmetric half grid), ``Kpc`` other
    labels."""
    calls = []
    real = ck.ar1_cov_fused_lanes_plain

    def spy(X1, fid1, X2, fid2, *a, **kw):
        calls.append((tuple(X1.shape), tuple(X2.shape),
                      ck.same_points(X1, fid1, X2, fid2)))
        return real(X1, fid1, X2, fid2, *a, **kw)

    monkeypatch.setattr(ck, "ar1_cov_fused_lanes_plain", spy)
    paths = candidates()
    expect = {"ergodic": 0, "fourier": 0, "sf_gain": 2, "mf_gain": 4,
              "sf_logdet": 3, "mf_logdet": 3}
    for name, n in expect.items():
        cost = make_cost("torch", name)
        calls.clear()
        cost.batch(paths)
        assert len(calls) == n, (name, calls)
        assert all(c[0][0] == len(paths) for c in calls)
        if name == "mf_gain":
            assert [c[2] for c in calls] == [False, False, True, False]


# ---------------------------------------------------------------------------
# the slice as a whole: a seeded plan
# ---------------------------------------------------------------------------
def plan(lib, cost):
    pr, rig = {"jax": (jpr, jrig), "torch": (tpr, trig)}[lib]
    cfg = pr.AgentConfig.sim_defaults()
    cfg.traj_count = 2
    p = rig.RIGPlanner(cfg=cfg, delta=10.0, B=150.0, WS=WS, R=1.25, Rd=5.0,
                       same_node_distance=1.0, max_iter=8, seed=4,
                       cost=cost)
    return p, p.plan(np.array([0.5, 0.5]))


@pytest.mark.parametrize("name", COSTS)
def test_plan_parity(name):
    """A seeded ``RIGPlanner.plan`` with each cost: the same graph, the
    same best path (nodes and edges), score and ``stats``."""
    tp, tb = plan("torch", make_cost("torch", name))
    jp, jb = plan("jax", make_cost("jax", name))
    assert tb.segments is not None and np.isfinite(tb.info)
    assert tp.stats == jp.stats and tp.stats["score_batches"] > 0
    assert sorted(tp.V) == sorted(jp.V) and sorted(tp.E) == sorted(jp.E)
    for i in tp.V:
        close(tp.V[i].state, jp.V[i].state, 0, 0)
    strip = [s._replace(info=0.0) for s in tb.segments]
    assert strip == [s._replace(info=0.0) for s in jb.segments]
    assert tb.node_idx == jb.node_idx and tb.budget == jb.budget
    close(tb.info, jb.info)
    close([s.info for s in tb.segments], [s.info for s in jb.segments])


# ---------------------------------------------------------------------------
# cli infogain-test
# ---------------------------------------------------------------------------
def test_cli_infogain_test(monkeypatch):
    """``infogain-test --cpu`` prints the JSON of the JAX package's
    command to 1e-12."""
    from mfgp_tpu import cli as jcli
    from mfgp_tpu_torch import cli as tcli

    monkeypatch.setenv("MFGP_TPU_COMPILE_CACHE", "0")
    outs = []
    for main, argv in ((tcli.main, ["--cpu", "infogain-test", "--seed",
                                    "3"]),
                       (jcli.main, ["infogain-test", "--seed", "3"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(argv)
        outs.append(json.loads(buf.getvalue()))
    got, want = outs
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], 1e-12, 1e-12)
    assert got["rel_err"] < 1e-10


def test_package_names():
    """``mfgp_tpu_torch.planning`` has the JAX package's names,
    ``DeviceRIG`` (the device planner) included."""
    import mfgp_tpu.planning as jplan

    names = {n for n in dir(jplan) if not n.startswith("_")
             and n[0].isupper()}
    assert "DeviceRIG" in names
    assert names <= set(dir(tplan)), names - set(dir(tplan))


@pytest.mark.parametrize("entry", ["ergodic", "fourier", "infogain-test"])
def test_entry_points_follow_the_device_rule(entry):
    """Without ``device`` (``--cpu``) the ergodic costs and
    ``infogain-test`` go to the card, and raise where there is none; asked
    for the CPU they run there. The model costs keep the model's device."""
    from mfgp_tpu_torch import cli as tcli

    eid, eid_g, _ = grids()
    bounds = np.array([[0, 10], [0, 20], [0, MAX_DEPTH]], float)

    def build(**kw):
        if entry == "ergodic":
            return tsc.ErgodicCost(eid=eid, grid=eid_g, **kw)
        if entry == "fourier":
            return tsc.FourierErgodicCost(eid=eid, grid=eid_g, bounds=bounds,
                                          **kw)
        with redirect_stdout(io.StringIO()):
            return tcli.main((["--cpu"] if kw else []) + ["infogain-test"])

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    cost = build(device="cpu")
    if entry != "infogain-test":
        assert cost.device == torch.device("cpu")
        assert cost.dtype == torch.float32
    mf, gp = models()["torch"]
    assert tsc.MFInfoGainCost(mf, FID_LEVELS)._X.device == mf.X.device
