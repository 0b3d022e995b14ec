"""The fully sharded cell (``nlml_sharded_n80k_4chip``) on the CPU at a small
size: four gloo ranks, rank 0 the test's process and ranks 1-3 processes
of their own, as on the cards. A sound run is correct; a run whose rank 0
is broken underneath is not, for each fault the cell can have: a step
that returns its first result again, and a panel of the distributed
Cholesky whose trailing update rank 0 leaves out (the exchange reaches
the other ranks, its use on rank 0 is skipped). A program without the
launcher fails at once, with no rank started. And the plain reference
that holds K once equals the plain reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch

CELL = "nlml_sharded_n80k_4chip"
# 4 tiles of 400: 400 columns a rank, panels of 200, so that rank 0 has a
# trailing update of its own
SMALL_N = 1600


@pytest.fixture(scope="module")
def sharded_run(root, bench):
    from benchmark.common import harness

    def run(seed=12345678901, **over):
        r = harness.resolve(root, bench, CELL)
        config = dict(r["config"], N=SMALL_N)
        traffic = dict(r["traffic"], **over)
        return harness.run_cell(root, bench, CELL, seed, 0.3, False,
                                torch.device("cpu"), config=config,
                                traffic=traffic)

    return run


def test_a_sound_run_is_correct(sharded_run):
    res = sharded_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _stale(mp):
    """Every evaluation runs (the ranks stay in step), and rank 0 returns
    its first result again."""
    from mfgp_tpu_torch import parallel as par

    real = par.make_fully_sharded_nlml_value_and_grad

    def make(*a, **k):
        f, memo = real(*a, **k), []

        def stale(*fa):
            out = f(*fa)
            if not memo:
                memo.append(out)
            return memo[0]
        return stale
    mp.setattr(par, "make_fully_sharded_nlml_value_and_grad", make)


def _panel_skipped(mp):
    """Rank 0 receives the first panel of each factorization and applies
    zeros in its place to its own trailing columns."""
    from mfgp_tpu_torch.parallel import chol

    real_body, real_bc = chol._chol_cols_body, chol.broadcast

    def body(*a, **k):
        calls = []

        def bc(*ba, **bk):
            out = real_bc(*ba, **bk)
            calls.append(1)
            return out.zero_() if len(calls) == 1 else out
        chol.broadcast = bc
        try:
            return real_body(*a, **k)
        finally:
            chol.broadcast = real_bc
    mp.setattr(chol, "_chol_cols_body", body)


@pytest.mark.parametrize("fault", [_stale, _panel_skipped])
def test_a_broken_rank_0_is_caught(fault, sharded_run, monkeypatch):
    fault(monkeypatch)
    res = sharded_run()
    assert not res["correct"], res["checks"]


def test_a_program_without_the_launcher_fails_at_once(sharded_run,
                                                       monkeypatch):
    import subprocess

    from mfgp_tpu_torch import parallel as par

    started = []
    monkeypatch.delattr(par, "init_ranks")
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(ImportError):
        sharded_run()
    assert started == []


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("block,rows", [(64, 48), (128, 1000), (600, 16384)])
def test_inplace_reference_equals_the_reference(kernel, block, rows):
    """``reference/gp_inplace`` (K held once, factored in place, K^-1 a
    block column at a time) == ``reference/gp.nlml_grad`` at N=600 in
    float64, to 1e-10."""
    from benchmark.common.problem import build_problem
    from benchmark.reference import gp, gp_inplace

    X, fid, y, _, _ = build_problem(600, 1, 3, seed=3)
    X, fid, y = (torch.as_tensor(a) for a in (X, fid.astype(np.int64), y))
    th = dict(variances=np.array([25.0, 10.0, 5.0]),
              lengthscales=np.tile([12.0, 20.0, 1.5], (3, 1)),
              rhos=np.array([0.9, 1.1]), noises=np.array([0.5, 0.2, 0.1]))
    want = gp.nlml_grad(X, fid, y, th, kernel, 1e-6)
    got = gp_inplace.nlml_grad(X, fid, y, th, kernel, 1e-6, block=block,
                               rows=rows)
    assert abs(float(got["value"] - want["value"])) <= 1e-10 * abs(
        float(want["value"]))
    for k in ("alpha", "g_logvar", "g_logls", "g_lognoise"):
        assert gp.rel_err(got[k], want[k]) <= 1e-10, k


def test_tiles_keep_the_survey_and_its_density():
    """Tile t is ``build_problem``'s survey with its own seed, shifted by
    whole tile widths; the seed decides the data."""
    from benchmark.common import tiles
    from benchmark.common.problem import build_problem

    c = dict(N=800, D=3, tiles=[2, 2], tile_shift=[60.0, 110.0])
    X, fid, y = tiles.build_tiles(c, 2 ** 33 + 5)
    X1, fid1, y1, _, _ = build_problem(200, 1, 3,
                                       seed=tiles.tile_seed(2 ** 33 + 5, 3))
    np.testing.assert_array_equal(X[600:], X1 + np.float32([60, 110, 0]))
    np.testing.assert_array_equal(fid[600:], fid1)
    np.testing.assert_array_equal(y[600:], y1)
    assert X.dtype == np.float32 and fid.dtype == np.int64
    assert np.all(X.max(0) <= [120.0, 220.0, 4.5])
    assert not np.array_equal(tiles.build_tiles(c, 1)[0], X)
