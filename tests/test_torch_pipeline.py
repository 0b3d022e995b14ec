"""Parity of the port's data pipeline with ``mfgp_tpu`` on the CPU: the
WRBF field, the Kalman filter, the configuration objects, the CSV
artifacts and ``run_pipeline``.

Both packages get the same numpy arrays (from a seed), in float64. Field
values and single Kalman steps agree to 1e-12, a filtered trajectory (300
steps, JAX's own measurement noise injected into the port) to 1e-9 in
every column, and a file either package writes from the same numbers is
the same bytes.
``jax.random`` streams cannot be drawn in torch, so the filter takes the
standard normal draws as an argument; its own seeded stream is tested for
what it promises.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu.data import io as jio
from mfgp_tpu.data import pipeline as jpl
from mfgp_tpu.estimation import kalman as jkf
from mfgp_tpu.fields import wrbf as jw
from mfgp_tpu.utils import configs as jcfg
from mfgp_tpu_torch.data import aggregate as tagg
from mfgp_tpu_torch.data import io as tio
from mfgp_tpu_torch.data import pipeline as tpl
from mfgp_tpu_torch.estimation import kalman as tkf
from mfgp_tpu_torch.fields import wrbf as tw
from mfgp_tpu_torch.utils import configs as tcfg

CPU = "cpu"


def close(port, ref, tol):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def same_file(a, b):
    assert filecmp.cmp(a, b, shallow=False), f"{a} and {b} differ"


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------
def fields(seed=5):
    """(jax field, port field) from one numpy generator state each."""
    WS, depth = [[0, 10], [0, 20]], 10.0
    fj = jw.random_field(np.random.default_rng(seed), WS, depth)
    ft = tw.random_field(np.random.default_rng(seed), WS, depth, device=CPU)
    return fj, ft


def test_wrbf_values(rng):
    """Values, column shape, the host closure and the carried-over field:
    1e-12."""
    fj, ft = fields()
    x = rng.uniform(0, 10, (57, 3))
    close(ft(x), fj(jnp.asarray(x)), 1e-12)
    close(ft(x[0]), fj(jnp.asarray(x[0])), 1e-12)
    assert ft.column(x).shape == (57, 1)
    close(ft.numpy(x), fj(jnp.asarray(x)), 1e-12)
    assert abs(ft.point_fn()(*x[3]) - fj.point_fn()(*x[3])) <= 1e-12
    carried = tw.wrbf_from_numpy(*(np.asarray(a) for a in fj[:4]),
                                 offset=0.5, device=CPU)
    close(carried(x), fj._replace(offset=0.5)(jnp.asarray(x)), 1e-12)
    dj = jw.default_sim_field(((0., 10.), (0., 20.)), 10.0)
    dt = tw.default_sim_field(((0., 10.), (0., 20.)), 10.0, device=CPU)
    close(dt(x), dj(jnp.asarray(x)), 1e-12)


def test_field_settings_round_trip(tmp_path):
    """The written file equals JAX's byte for byte, with and without the
    optional lines, and parses back to the same field in both."""
    fj, ft = fields()
    for i, kw in enumerate((dict(meas_noise=0.125),
                            dict(WS=[[0, 10], [0, 20]], max_depth=10.0))):
        a, b = tmp_path / f"j{i}.txt", tmp_path / f"t{i}.txt"
        jw.write_field_settings(a, fj, **kw)
        tw.write_field_settings(b, ft, **kw)
        same_file(a, b)
    back = tw.parse_field_settings(tmp_path / "j0.txt", device=CPU)
    ref = jw.parse_field_settings(tmp_path / "t0.txt")
    for got, want in zip(back[:4], ref[:4]):
        close(got, want, 0)
    x = np.random.default_rng(1).uniform(0, 10, (9, 3))
    close(back(x), ft(x), 1e-7)  # str() keeps 8 significant digits


# ---------------------------------------------------------------------------
# Kalman filter
# ---------------------------------------------------------------------------
def models(vmn=0.2):
    cj = jcfg.SimConfig(vmn=vmn)
    ct = tcfg.SimConfig(vmn=vmn)
    return cj.kf_model(), ct.kf_model(device=CPU)


def test_kf_model_carried():
    mj, mt = models()
    carried = tkf.kf_model_from_numpy(*(np.asarray(a) for a in mj[:4]),
                                      mj.at_surface, device=CPU)
    for a, b, c in zip(mt[:4], mj[:4], carried[:4]):
        close(a, b, 0)
        close(c, b, 0)
    assert mt.at_surface == mj.at_surface == carried.at_surface
    close(tkf.KFModel.A(0.1, device=CPU), jkf.KFModel.A(0.1), 0)
    assert tkf.KFModel.A(torch.tensor([0.1, 0.3])).shape == (2, 6, 6)


def test_kf_steps(rng):
    """kf_update / kf_predict / kf_step, single and batched: 1e-12."""
    mj, mt = models()
    x = rng.normal(size=(6, 1))
    A0 = rng.normal(size=(6, 6))
    P = A0 @ A0.T + np.eye(6)
    z = rng.normal(size=(6, 1))
    u = rng.normal(size=(2, 1))
    Bm = rng.normal(size=(6, 2))
    H = np.diag([0., 0., 1., 1., 1., 1.])
    A = np.asarray(jkf.KFModel.A(0.1))
    j = [jnp.asarray(a) for a in (x, P, z, u, Bm, H, A)]
    t = [torch.tensor(a) for a in (x, P, z, u, Bm, H, A)]
    for got, ref in zip(tkf.kf_update(t[0], t[1], t[2], t[5], mt.R),
                        jkf.kf_update(j[0], j[1], j[2], j[5], mj.R)):
        close(got, ref, 1e-12)
    for got, ref in zip(tkf.kf_predict(t[0], t[3], t[6], t[4], t[1], mt.Q),
                        jkf.kf_predict(j[0], j[3], j[6], j[4], j[1], mj.Q)):
        close(got, ref, 1e-12)
    for got, ref in zip(tkf.kf_predict(t[0], None, t[6], None, t[1], mt.Q),
                        jkf.kf_predict(j[0], None, j[6], None, j[1], mj.Q)):
        close(got, ref, 1e-12)
    ref = jkf.kf_step(j[0], j[1], j[3], j[2], j[6], j[4], mj.Q, j[5], mj.R)
    for got, want in zip(tkf.kf_step(t[0], t[1], t[3], t[2], t[6], t[4],
                                     mt.Q, t[5], mt.R), ref):
        close(got, want, 1e-12)
    # a leading batch axis computes each member's step
    xb = torch.stack([t[0], 2 * t[0]])
    Pb = torch.stack([t[1], 3 * t[1]])
    got = tkf.kf_step(xb, Pb, t[3], torch.stack([t[2], -t[2]]), t[6], t[4],
                      mt.Q, t[5], mt.R)
    one = tkf.kf_step(2 * t[0], 3 * t[1], t[3], -t[2], t[6], t[4], mt.Q,
                      t[5], mt.R)
    close(got[0][0], ref[0], 1e-12)
    close(got[0][1], one[0], 1e-12)
    close(got[1][1], one[1], 1e-12)


def trajectory(T=301, seed=0, dt=0.1):
    """A dive-and-surface track: depth crosses the GPS gate (0.2) both
    ways."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) * dt
    ph = rng.uniform(0, 2 * np.pi, 3)
    pos = np.column_stack([5 + 3 * np.sin(t / 4 + ph[0]),
                           10 + 6 * np.cos(t / 5 + ph[1]),
                           np.clip(1.5 * np.sin(t / 3 + ph[2]), 0.0, None)])
    return t, pos


def jax_noise(seed, n):
    """The standard normal draws ``filter_trajectory`` of the JAX package
    makes for ``jax.random.key(seed)`` over n steps."""
    return np.asarray(jax.random.normal(jax.random.key(seed), (n, 6),
                                        jnp.float64))


def test_filter_trajectory_matches_jax():
    """300 steps, JAX's noise injected: every column within 1e-9, with
    steps on both sides of the GPS gate."""
    mj, mt = models()
    t, pos = trajectory()
    gate = pos[:-1, 2] <= mj.at_surface
    assert gate.any() and (~gate).any()
    ref = jkf.filter_trajectory(mj, jnp.asarray(t), jnp.asarray(pos),
                                jax.random.key(3))
    got = tkf.filter_trajectory(mt, t, pos, noise=jax_noise(3, 300))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape
        close(got[k], ref[k], 1e-9)


@pytest.mark.parametrize("T", [1, 2])
def test_filter_trajectory_short(T):
    """A one-row trajectory has no step: empty (0,) and (0, 3) columns, as
    JAX's scan gives; two rows give one step, JAX's noise injected, within
    1e-9."""
    t = np.arange(T) * 0.1
    pos = np.zeros((T, 3))
    ref = jkf.filter_trajectory(jcfg.KFConfig().model(), jnp.asarray(t),
                                jnp.asarray(pos), jax.random.key(0))
    got = tkf.filter_trajectory(tcfg.KFConfig().model(device=CPU), t, pos,
                                noise=jax_noise(0, T - 1))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape == ((T - 1,) if k == "t" else
                                                (T - 1, 3)), k
        close(got[k], ref[k], 1e-9)


def test_filter_trajectory_batch_and_streams():
    """The batched loop equals the single one member by member on ragged
    lengths (through ``generate_estimates_batch``'s padding); a seed
    repeats, another seed differs, a generator is taken."""
    _, mt = models()
    ct = tcfg.SimConfig()
    tabs = []
    for T, seed in ((301, 0), (187, 1), (240, 2)):
        t, pos = trajectory(T, seed)
        tabs.append(tio.Table(["t", "x", "y", "z"],
                              np.column_stack([t, pos])))
    batch = tpl.generate_estimates_batch(tabs, ct, seeds=[4, 5, 6],
                                         device=CPU)
    for tab, seed, est in zip(tabs, (4, 5, 6), batch):
        one = tpl.generate_estimates(tab, ct, seed=seed, device=CPU)
        assert est.data.shape == one.data.shape == (tab.data.shape[0] - 1, 13)
        np.testing.assert_allclose(est.data, one.data, rtol=0, atol=1e-12)
    t, pos = trajectory()
    a = tkf.filter_trajectory(mt, t, pos, seed=7)["xh"]
    assert torch.equal(a, tkf.filter_trajectory(mt, t, pos, seed=7)["xh"])
    assert not torch.equal(a, tkf.filter_trajectory(mt, t, pos, seed=8)["xh"])
    g = torch.Generator().manual_seed(7)
    assert torch.equal(a, tkf.filter_trajectory(mt, t, pos,
                                                generator=g)["xh"])


def test_fidelity_bin():
    c = np.array([0.0, 0.2499, 0.25, 1.0, 2.2499, 2.25, 9.0])
    lev = tcfg.SimConfig().fidlevels
    assert lev == jcfg.SimConfig().fidlevels
    ref = np.asarray(jkf.fidelity_bin(jnp.asarray(c), lev))
    assert np.array_equal(tkf.fidelity_bin(c, lev), ref)
    assert np.array_equal(tkf.fidelity_bin(torch.as_tensor(c), lev).numpy(),
                          ref)


# ---------------------------------------------------------------------------
# configs, io, aggregate
# ---------------------------------------------------------------------------
def test_configs_match():
    cj, ct = jcfg.SimConfig(seed=3, vmn=0.1), tcfg.SimConfig(seed=3, vmn=0.1)
    assert ct.kf_meas_noise == cj.kf_meas_noise
    assert np.array_equal(ct.test_points(), cj.test_points())
    assert np.array_equal(tcfg._grid([(0, 1, 3), (0, 2, 4)]),
                          jcfg._grid([(0, 1, 3), (0, 2, 4)]))
    assert tcfg.DEFAULT_SIM.t_cut == jcfg.DEFAULT_SIM.t_cut
    import dataclasses

    names = [f.name for f in dataclasses.fields(jcfg.SimConfig)]
    assert names == [f.name for f in dataclasses.fields(tcfg.SimConfig)]
    for n in names:
        if n != "kf":
            assert getattr(ct, n) == getattr(cj, n)
    assert dataclasses.asdict(ct.kf) == dataclasses.asdict(cj.kf)
    assert dataclasses.asdict(ct.agent()) == dataclasses.asdict(cj.agent())


def test_io_artifacts_byte_for_byte(tmp_path, rng):
    """Every saver writes JAX's bytes; every loader reads JAX's numbers."""
    assert (tio.EST_HEADER, tio.FIELD_HEADER, tio.GPDATA_HEADER,
            tio.GPRES_HEADER) == (jio.EST_HEADER, jio.FIELD_HEADER,
                                  jio.GPDATA_HEADER, jio.GPRES_HEADER)
    data = rng.normal(size=(30, 9))
    data[:, 0] = np.arange(30) * 150.0
    data[:, 8] = rng.integers(1, 4, 30)
    heads = tio.GPDATA_HEADER.split(",")
    jio.Table(heads, data).save(tmp_path / "j.csv")
    tio.Table(heads, data).save(tmp_path / "t.csv")
    same_file(tmp_path / "j.csv", tmp_path / "t.csv")
    tj, tt = jio.load_table(str(tmp_path / "j.csv")), tio.load_table(
        tmp_path / "j.csv")
    assert tt.headers == tj.headers and np.array_equal(tt.data, tj.data)
    assert np.array_equal(tt.cols("x", "fidLev"), tj.cols("x", "fidLev"))
    dj = jio.load_gp_dataset(str(tmp_path / "j.csv"), t_cut=3600.0)
    dt = tio.load_gp_dataset(tmp_path / "j.csv", t_cut=3600.0)
    assert dt.n == dj.n == 24
    for a, b in zip(dt, dj):
        assert np.array_equal(a, b)
    for (Xa, ya), (Xb, yb) in zip(zip(*dt.fidelity_lists()),
                                  zip(*dj.fidelity_lists())):
        assert np.array_equal(Xa, Xb) and np.array_equal(ya, yb)
    vec = rng.uniform(0.1, 3, 17)
    for row in (True, False):
        jio.save_hyp_vector(tmp_path / "jh.txt", vec, row=row)
        tio.save_hyp_vector(tmp_path / "th.txt", vec, row=row)
        same_file(tmp_path / "jh.txt", tmp_path / "th.txt")
        assert np.array_equal(tio.load_hyp_vector(tmp_path / "jh.txt"),
                              jio.load_hyp_vector(tmp_path / "jh.txt"))
    tp = rng.normal(size=(12, 3))
    cols = [rng.normal(size=12) for _ in range(4)] + [rng.normal(size=(12, 1))]
    jio.save_gpres(tmp_path / "jg.csv", tp, *cols)
    tio.save_gpres(tmp_path / "tg.csv", tp, *cols)
    same_file(tmp_path / "jg.csv", tmp_path / "tg.csv")
    metrics = {"WRMSE sf": 0.25, "RMSE mf": 1.5, "RMSE nisf": float("nan"),
               "extra": 3}
    jio.save_mse(tmp_path / "MSE_0.2_fieldMeas_1_T3_0.1.txt", metrics)
    tio.save_mse(tmp_path / "tm.txt", metrics)
    same_file(tmp_path / "MSE_0.2_fieldMeas_1_T3_0.1.txt", tmp_path / "tm.txt")
    pj = jio.parse_mse(tmp_path / "tm.txt")
    pt = tio.parse_mse(tmp_path / "tm.txt")
    assert pt.keys() == pj.keys() and pt["RMSE mf"] == 1.5
    name = "MSE_0.2_fieldMeas_1_T3_0.1.txt"
    assert tio.parse_mse_filename(name) == jio.parse_mse_filename(name)
    assert tio.parse_mse_filename("other.txt") == {}


def test_aggregate_matches_jax(tmp_path):
    from mfgp_tpu.data import aggregate as jagg

    rng = np.random.default_rng(2)
    for T in range(2):
        for vmn in (0.1, 0.2):
            tio.save_mse(tmp_path / f"MSE_0.2_fieldMeas_0_T{T}_{vmn:g}.txt",
                         {m: float(rng.uniform()) for m in tagg.METRICS})
    rows_t = tagg.collect_results(str(tmp_path / "MSE_*.txt"),
                                  str(tmp_path / "t.csv"))
    rows_j = jagg.collect_results(str(tmp_path / "MSE_*.txt"),
                                  str(tmp_path / "j.csv"))
    assert rows_t == rows_j
    same_file(tmp_path / "t.csv", tmp_path / "j.csv")
    assert tagg.summary(rows_t) == jagg.summary(rows_j)
    assert tagg.mean_metrics(rows_t, {"T": 1}) == jagg.mean_metrics(
        rows_j, {"T": 1})


# ---------------------------------------------------------------------------
# the pipeline as a whole
# ---------------------------------------------------------------------------
def listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_run_pipeline_files_byte_for_byte(tmp_path):
    """Estimates from JAX's filter handed to both packages: the settings
    file, the estimates and the drawn field's settings are the same bytes.
    The two files that carry field values (which pass through each
    library's own ``exp`` and differ in the last bit) have the same header
    and the same numbers to 1e-12; the same Table saves to the same bytes
    (``test_io_artifacts_byte_for_byte``)."""
    t, pos = trajectory(400, seed=1)
    traj = np.column_stack([t, pos])
    cj, ct = jcfg.SimConfig(seed=2, vmn=0.1), tcfg.SimConfig(seed=2, vmn=0.1)
    tj = jio.Table(["t", "x", "y", "z"], traj)
    tt = tio.Table(["t", "x", "y", "z"], traj)
    est_j = jpl.generate_estimates(tj, cj)
    est_t = tpl.generate_estimates(tt, ct, noise=jax_noise(2, 399),
                                   device=CPU)
    np.testing.assert_allclose(est_t.data, est_j.data, rtol=0, atol=1e-9)
    shared = tio.Table(est_j.headers, est_j.data)
    jpl.run_pipeline(tj, cj, out_dir=str(tmp_path / "j"), est=est_j)
    out = tpl.run_pipeline(tt, ct, out_dir=str(tmp_path / "t"), est=shared,
                           device=CPU)
    files = listing(tmp_path / "j")
    assert files == listing(tmp_path / "t") and len(files) == 5
    for f in files:
        if "fieldMeas" not in f:
            same_file(tmp_path / "j" / f, tmp_path / "t" / f)
            continue
        a = tio.load_table(tmp_path / "j" / f)
        b = tio.load_table(tmp_path / "t" / f)
        assert a.headers == b.headers
        np.testing.assert_allclose(b.data, a.data, rtol=0, atol=1e-12)
    assert out[2].data.shape[1] == 9 and out[2].data.shape[0] > 3
    # stage by stage on the same inputs
    fj, ft = fields()
    mj = jpl.generate_field_measurements(est_j, fj, cj,
                                         np.random.default_rng(4))
    mt = tpl.generate_field_measurements(shared, ft, ct,
                                         np.random.default_rng(4))
    np.testing.assert_allclose(mt.data, mj.data, rtol=0, atol=1e-12)
    bj = jpl.bin_fidelity(est_j, mj, cj)
    bt = tpl.bin_fidelity(shared, tio.Table(mj.headers, mj.data), ct)
    assert np.array_equal(bt.data, bj.data)
