"""Shared fixtures of the benchmark's CPU tests: the repository root, the
benchmark file, and small versions of each cell's configuration."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell's configuration cut to a size a CPU test holds
SMALL = {
    "mfgp_ar1_rbf_n20k": {"N": 400, "M": 300},
    "mission_mfegp_default": {"B": 20.0, "BD": 2, "plan_iters": 12,
                              "e_max": 6},
}


@pytest.fixture(scope="module")
def root() -> Path:
    return ROOT


@pytest.fixture(scope="module")
def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_run(bench):
    """``run(cell, seed=, seconds=, trace=, root=, bench=, **traffic)``:
    one CPU run of ``cell`` at its small size, the chip's look skipped;
    keyword arguments replace traffic keys."""
    import torch

    from benchmark.common import harness

    def run(cell, seed=12345678901, seconds=0.3, trace=False, root=ROOT,
            bench=bench, **over):
        r = harness.resolve(root, bench, cell)
        config = dict(r["config"], **SMALL[r["cell"]["config"]])
        traffic = dict(r["traffic"], **over)
        return harness.run_cell(root, bench, cell, seed, seconds, trace,
                                torch.device("cpu"), config=config,
                                traffic=traffic)

    return run
