"""Everything a run draws from ``--seed``: the hyperparameters of each
step, the requests of each client, the seeds of each mission, and the
samples that the checks take. Each draw has its own stream, keyed by the
seed, a tag and the draw's indices, so that it repeats exactly and does
not depend on how many other draws a run made.

Where a mix fixes sizes, every seed gets the same multiset of sizes in
another order (``fleet_request``): the seed changes which points are asked
and when, not how much work is asked.
"""

from __future__ import annotations

import math

import numpy as np

_MASK = (1 << 64) - 1
# stream tags
_PARAMS, _SAMPLE, _ORDER, _POINTS, _MISSION = 1, 2, 3, 4, 5


def rng(seed: int, *key: int) -> np.random.Generator:
    """The stream of ``key`` under ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) & _MASK, *key])


def log_theta(theta: dict) -> np.ndarray:
    """[log variances (F), log lengthscales (F*D), log noises (F)] of a
    configuration's hyperparameters."""
    return np.concatenate([np.log(np.asarray(theta["variances"], float)),
                           np.log(np.asarray(theta["lengthscales"],
                                             float)).reshape(-1),
                           np.log(np.asarray(theta["noises"], float))])


def step_params(seed: int, n: int, theta: dict, spread: float) -> np.ndarray:
    """(n, 2F + F*D) log-hyperparameters, one row per step: the
    configuration's plus ``spread`` times standard normal draws."""
    base = log_theta(theta)
    return base + spread * rng(seed, _PARAMS).standard_normal(
        (n, base.shape[0]))


def sample(seed: int, n_items: int, k: int, tag: int = 0) -> list[int]:
    """``k`` distinct indices of ``range(n_items)`` (all of them when there
    are no more than ``k``), sorted, always holding the last."""
    if n_items <= k:
        return list(range(n_items))
    rest = rng(seed, _SAMPLE, tag).choice(n_items - 1, size=k - 1,
                                          replace=False)
    return sorted(int(i) for i in rest) + [n_items - 1]


def fleet_sizes(mix: dict) -> list[int]:
    """The sizes of one round's small requests: quantiles of the
    log-uniform law on [min_points, max_points], one per stratum."""
    lo, hi = math.log(mix["min_points"]), math.log(mix["max_points"])
    k = mix["clients"] - mix["grid_per_round"]
    return [int(round(math.exp(lo + (j + 0.5) / k * (hi - lo))))
            for j in range(k)]


def fleet_request(seed: int, mix: dict, client: int, i: int, box):
    """``client``'s request in round ``i``: ``None`` for the whole grid,
    else an (n, D) array of points uniform in ``box``. Each round of
    ``clients`` requests holds ``grid_per_round`` grid requests and one
    request of each of ``fleet_sizes(mix)``, dealt to the clients in an
    order drawn from the seed."""
    order = rng(seed, _ORDER, i).permutation(mix["clients"])
    kind = int(order[client])
    if kind < mix["grid_per_round"]:
        return None
    n = fleet_sizes(mix)[kind - mix["grid_per_round"]]
    box = np.asarray(box, float)
    return rng(seed, _POINTS, client, i).random((n, box.shape[0])) * box


def mission_seed(seed: int, k: int) -> int:
    """The seed of the k-th mission of a run."""
    return int(rng(seed, _MISSION, k).integers(0, 2 ** 31 - 1))
