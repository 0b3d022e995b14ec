"""The harness's pieces on the CPU: the generators repeat for a seed, the
operation counts and shares, the tail over every request, the resolution
of every cell by name, a cell added as data alone, the import guard, and a
run's refusal without a card."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark.common import counts, gen, guard, harness, stats

BIG_SEED = 2 ** 31 + 12345


def test_step_params_repeat_for_a_seed():
    theta = dict(variances=[25.0, 10.0, 5.0],
                 lengthscales=[[12.0, 20.0, 1.5]] * 3,
                 noises=[0.5, 0.2, 0.1])
    a = gen.step_params(BIG_SEED, 50, theta, 0.1)
    np.testing.assert_array_equal(a, gen.step_params(BIG_SEED, 50, theta,
                                                     0.1))
    # a longer table starts with the shorter one
    np.testing.assert_array_equal(a, gen.step_params(BIG_SEED, 80, theta,
                                                     0.1)[:50])
    assert not np.array_equal(a, gen.step_params(BIG_SEED + 1, 50, theta,
                                                 0.1))
    assert a.shape == (50, 15)
    assert np.allclose(a.mean(0), gen.log_theta(theta), atol=0.06)


def test_fleet_requests_repeat_and_keep_each_rounds_sizes():
    mix = dict(clients=8, grid_per_round=2, min_points=64, max_points=1024)
    box = [60.0, 110.0, 4.5]
    sizes = sorted(gen.fleet_sizes(mix))
    assert sizes[0] >= 64 and sizes[-1] <= 1024 and len(sizes) == 6
    for seed in (0, BIG_SEED):
        for i in range(3):
            got = [gen.fleet_request(seed, mix, k, i, box) for k in range(8)]
            again = [gen.fleet_request(seed, mix, k, i, box)
                     for k in range(8)]
            for a, b in zip(got, again):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
                    assert np.all((a >= 0) & (a <= box))
            assert sum(r is None for r in got) == 2
            assert sorted(len(r) for r in got if r is not None) == sizes
    deals = {tuple(gen.fleet_request(s, mix, k, 0, box) is None
                   for k in range(8)) for s in range(20)}
    assert len(deals) > 1  # the seed moves who asks for the grid


def test_mission_seeds_and_samples_repeat():
    assert [gen.mission_seed(BIG_SEED, k) for k in range(5)] == \
        [gen.mission_seed(BIG_SEED, k) for k in range(5)]
    assert len({gen.mission_seed(BIG_SEED, k) for k in range(50)}) == 50
    s = gen.sample(BIG_SEED, 100, 5)
    assert s == gen.sample(BIG_SEED, 100, 5)
    assert len(set(s)) == 5 and s[-1] == 99 and s == sorted(s)
    assert gen.sample(BIG_SEED, 3, 5) == [0, 1, 2]


def test_operation_counts_and_bounds():
    N, M = 20_000, 10_571
    assert counts.eval_ops(N) == 8.0e12
    assert counts.unit_ops(N, M) == pytest.approx(1.22284e13)
    peak = 495e12 / 3
    # B2 and B3 are bound by operations at the unit's shape
    assert counts.bound_s(counts.b2_ops(N), counts.b2_bytes(N)) == \
        pytest.approx(N ** 3 / 3 / peak)
    assert counts.bound_s(counts.b2_ops(N), counts.b2_bytes(N)) * 1e3 == \
        pytest.approx(16.16, abs=0.01)
    assert counts.bound_s(counts.b3_ops(N, M), counts.b3_bytes(N, M)) \
        * 1e3 == pytest.approx(25.63, abs=0.01)
    # a kernel moving bytes only is bound by bandwidth
    assert counts.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.mfu_pct(8e12, 0.577) == pytest.approx(
        100 * 8e12 / 0.577 / peak)
    assert counts.share_pct(0.5, 1.0) == 50.0
    assert counts.share_pct(0.5, 0.0) is None


def test_p95_counts_every_request_and_failures_as_missing():
    lat = [float(i) for i in range(1, 101)]  # 1 .. 100
    assert stats.latency_p95(lat, 0) == 95.0
    # five failures of 105 requests: rank 100 of 105 is a success
    assert stats.latency_p95(lat, 5) == 100.0
    assert stats.latency_p95(lat, 6) == math.inf
    assert stats.latency_p95([0.2], 0) == 0.2
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_every_cell_resolves_by_name(root, bench):
    for cell in bench["workloads"]:
        r = harness.resolve(root, bench, cell["name"])
        assert r["config"]["name"] == cell["config"]
        for key in ("generator", "limits"):
            assert key in r["traffic"]
        e2e = {m["name"] for m in r["e2e"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert r["layer"] and set(r["readers"]) == {m["name"]
                                                    for m in r["layer"]}
        for fn in ("setup", "window", "release", "check"):
            assert callable(getattr(r["generator"], fn))


def test_every_metric_and_file_is_named_by_the_contract(root, bench):
    for m in bench["per_layer"]:
        assert harness.reader_path(root, m["name"]).is_file()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert (root / c["file"]).is_file()
    for cell in bench["workloads"]:
        assert (root / "benchmark" / "traffic"
                / f"{cell['traffic']}.json").is_file()


def test_a_cell_added_as_data_alone_is_picked_up(tmp_path, root, bench,
                                                 small_run):
    """A copy of the benchmark with one more traffic file and one more
    entry in BENCHMARK.json, and no code: the new cell resolves and runs."""
    dst = tmp_path / "checkout"
    shutil.copytree(root / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(root / "benchmark/traffic/fit_eval_closed.json") as f:
        mix = json.load(f)
    mix.update(param_spread=0.3, check_steps=1)
    with open(dst / "benchmark/traffic/fit_eval_wide.json", "w") as f:
        json.dump(mix, f)
    b = json.loads(json.dumps(bench))
    b["workloads"].append(dict(
        name="fit_eval_wide", config="mfgp_ar1_rbf_n20k",
        traffic="fit_eval_wide", chips=1, why="a dummy cell made of data"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "fit_eval_rbf" in m.get("workloads", []):
            m["workloads"].append("fit_eval_wide")
    r = harness.resolve(dst, b, "fit_eval_wide")
    assert r["traffic"]["param_spread"] == 0.3
    res = small_run("fit_eval_wide", root=dst, bench=b, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"eval_mfu"}  # nothing on a CPU trace
    res = small_run("fit_eval_wide", root=dst, bench=b)
    assert set(res["metrics"]) == {"setup_s", "eval_s"}


@pytest.mark.parametrize("names,bad", [
    (["jax"], ["jax"]),
    (["jax.numpy", "os"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["mfgp_tpu"], ["mfgp_tpu"]),
    (["mfgp_tpu.models.mfgp"], ["mfgp_tpu"]),
    (["mfgp_tpu_torch", "mfgp_tpu_torch.models.mfgp"], []),
    (["jaxtyping", "mfgp_tpu_torchx", "numpy"], []),
])
def test_import_guard_compares_whole_top_level_names(names, bad):
    assert guard.forbidden(names) == bad


def test_reference_and_harness_import_nothing_of_the_program(root):
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.gp, benchmark.reference.mission;"
            "import benchmark.common.harness;"
            "print(sorted(m for m in sys.modules"
            " if m.split('.')[0].startswith(('mfgp_tpu', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(root), check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_exits_nonzero_and_prints_nothing(root):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fit_eval_rbf",
         "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(root),
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout == ""
