"""Runs of each cell on the CPU at a small size, the chip's look skipped:
a sound run is correct, and a run with its timed path broken underneath
is not, for each fault the cell can have: an answer altered where it is
produced, a step that returns its state unchanged, and (for the served
fleet, whose launches coalesce requests) half of a batch left out. The
cells run on one chip, so there is no exchange between chips to leave
out."""

from __future__ import annotations

import pytest
import torch

CELLS = ["fit_eval_rbf", "unit_rbf", "fleet_predict", "mission_default"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, small_run):
    res = small_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _stale(fn):
    """``fn`` that computes once and then returns its first result."""
    memo = []

    def stale(*a, **k):
        if not memo:
            memo.append(fn(*a, **k))
        return memo[0]
    return stale


def _fit_altered(mp):
    from mfgp_tpu_torch.models import mfgp as mf

    real = mf.nlml_value_and_grad

    def altered(*a, **k):
        v, g = real(*a, **k)
        return v, g._replace(log_lengthscales=3.0 * g.log_lengthscales)
    mp.setattr(mf, "nlml_value_and_grad", altered)


def _fit_nan(mp):
    """A value that comes out NaN: the check's worst reading keeps it."""
    from mfgp_tpu_torch.models import mfgp as mf

    real = mf.nlml_value_and_grad

    def nan(*a, **k):
        v, g = real(*a, **k)
        return v * float("nan"), g
    mp.setattr(mf, "nlml_value_and_grad", nan)


def _fit_stale(mp):
    from mfgp_tpu_torch.models import mfgp as mf

    mp.setattr(mf, "nlml_value_and_grad", _stale(mf.nlml_value_and_grad))


def _unit_altered(mp):
    from mfgp_tpu_torch.models import mfgp as mf

    real = mf.predict_fused

    def altered(*a, **k):
        mu, var = real(*a, **k)
        return 3.0 * mu, var
    mp.setattr(mf, "predict_fused", altered)


def _unit_stale(mp):
    from mfgp_tpu_torch.models import mfgp as mf

    mp.setattr(mf, "nlml_value_grad_state_inv",
               _stale(mf.nlml_value_grad_state_inv))
    mp.setattr(mf, "predict_fused", _stale(mf.predict_fused))


def _fleet_altered(mp):
    from mfgp_tpu_torch.models import mfgp as mf

    real = mf.MFGP.predict

    def altered(self, *a, **k):
        mu, var = real(self, *a, **k)
        return mu, 3.0 * var
    mp.setattr(mf.MFGP, "predict", altered)


def _fleet_half_batch(mp):
    """Each coalesced launch computes the first half of its rows and
    answers the rest with them."""
    from mfgp_tpu_torch import serve

    real = serve.ModelServer._predict_device

    def half(self, pts, include_noise=True):
        n = len(pts)
        h = max(1, n // 2)
        mu, var = real(self, pts[:h], include_noise)
        idx = [i % h for i in range(n)]
        return mu[idx], var[idx]
    mp.setattr(serve.ModelServer, "_predict_device", half)


def _fleet_stale(mp):
    from mfgp_tpu_torch import serve

    real = serve.ModelServer._predict_device
    memo = {}

    def stale(self, pts, include_noise=True):
        # every launch answers with the first launch's rows (cycled)
        if "out" not in memo:
            memo["out"] = real(self, pts, include_noise)
        mu, var = memo["out"]
        idx = [i % len(mu) for i in range(len(pts))]
        return mu[idx], var[idx]
    mp.setattr(serve.ModelServer, "_predict_device", stale)


def _mission_altered(mp):
    from mfgp_tpu_torch.sim.mission_device import DeviceMission

    real = DeviceMission._grid_post

    def altered(self, *a, **k):
        mu, var = real(self, *a, **k)
        return mu + 3.0, var
    mp.setattr(DeviceMission, "_grid_post", altered)


def _mission_stale(mp):
    """The arena's extension returns the arena unchanged."""
    from mfgp_tpu_torch.sim.mission_device import DeviceMission

    def unchanged(self, params, ar, *a, **k):
        return {k2: v for k2, v in ar.items()}
    mp.setattr(DeviceMission, "_extend_arena", unchanged)


def _mission_positions(mp):
    """The filter's estimated positions 5 m off in x where it makes them."""
    from mfgp_tpu_torch.sim import mission_device

    real = mission_device.filter_trajectory

    def shifted(*a, **k):
        out = dict(real(*a, **k))
        out["xh"] = out["xh"] + out["xh"].new_tensor([5.0, 0.0, 0.0])
        return out
    mp.setattr(mission_device, "filter_trajectory", shifted)


FAULTS = [
    ("fit_eval_rbf", _fit_altered), ("fit_eval_rbf", _fit_stale),
    ("fit_eval_rbf", _fit_nan),
    ("unit_rbf", _unit_altered), ("unit_rbf", _unit_stale),
    ("fleet_predict", _fleet_altered), ("fleet_predict", _fleet_half_batch),
    ("fleet_predict", _fleet_stale),
    ("mission_default", _mission_altered),
    ("mission_default", _mission_stale),
    ("mission_default", _mission_positions),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, small_run,
                                            monkeypatch):
    fault(monkeypatch)
    # a stale step returns at once: a closed loop then runs its least
    # number of steps; the fleet's clients need a window to send at all
    seconds = 0.3 if cell == "fleet_predict" else 0.0
    with torch.no_grad():
        res = small_run(cell, seconds=seconds)
    assert not res["correct"], res["checks"]
