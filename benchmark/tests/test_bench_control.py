"""The control, at the cells' own sizes on the card: each cell run one
precision below its configuration (``harness.run_control``, as the
traffic file's ``control`` names it) is not correct, and on each number
whose upper reading it sets it reads at least three times what a sound run
of the same seed reads, and above the cell's limit; a number the control
leaves without a reading (NaN: a factorization that broke down) fails as
not finite. The value and the gradient of the unit, the served mean and
the planner's score are not among the numbers it separates (PERF.md §6).
The card tests skip elsewhere; the evaluation's control also runs on the
CPU at a size where its factorization takes TF32 updates."""

from __future__ import annotations

import math

import pytest

SEPARATED = {
    "fit_eval_rbf": ("nlml_rel", "grad_rel"),
    "unit_rbf": ("mean_rel", "var_rel"),
    "fleet_predict": ("var_rel",),
    "mission_default": ("eid_rel", "mean_rel", "var_rel", "rmse_rel"),
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _separated(value, sound: float, limit: float) -> bool:
    """A control's reading fails its number: not finite (the judge prints
    it as a string), or three times the sound run's and above the limit."""
    if isinstance(value, str) or value is None or not math.isfinite(value):
        return True
    return value >= 3.0 * sound and value > limit


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SEPARATED))
def test_control_reads_three_times_a_sound_run(cell, card, root, bench):
    from benchmark.common import harness

    r = harness.resolve(root, bench, cell)
    seconds = float(r["traffic"].get("control_seconds", 0.0))
    runs = (harness.run_cell(root, bench, cell, 424242, seconds, False,
                             card),
            harness.run_control(root, bench, cell, 424242, card))
    sound, control = ({k: c["value"] for k, c in res["checks"].items()}
                      for res in runs)
    for k in SEPARATED[cell]:
        assert _separated(control[k], sound[k], r["traffic"]["limits"][k]), \
            (k, sound, control)
    assert runs[0]["correct"] and not runs[1]["correct"]


def test_the_evaluations_control_is_not_correct_on_the_cpu(root, bench):
    import torch

    from benchmark.common import harness

    r = harness.resolve(root, bench, "fit_eval_rbf")
    config = dict(r["config"], N=1536, M=64)
    res = harness.run_control(root, bench, "fit_eval_rbf", 12345678901,
                              torch.device("cpu"), config=config)
    assert res["control"] == "reference_tf32"
    assert not res["correct"], res["checks"]
    sound = harness.run_cell(root, bench, "fit_eval_rbf", 12345678901, 0.0,
                             False, torch.device("cpu"), config=config)
    assert sound["correct"], sound["checks"]
