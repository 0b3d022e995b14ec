"""Expected Information Density (counterpart of ``mfgp_tpu/metrics/eid.py``).

SURVEY C12: GP posterior on a grid -> faux-UCB blend of mean and posterior
std -> softmax distribution (reference/exploreSimSettings.py:6-37 sim
variant; reference/PhysicalExperimentCode/exploreExpSettings.py:8-30
physical variant). The two variants differ only in their negative-variance
guard: the sim one collapses the whole EID to uniform, the physical one
clamps negative variances to the prior variance first — both are provided
via ``neg_var_guard``.
"""

from __future__ import annotations

import numpy as np
import torch

from mfgp_tpu_torch.metrics.ergodic import softmax


def expected_information_density(mu, sig, prior_sig, alpha=1.0 / 11,
                                 auto: bool = False,
                                 neg_var_guard: str = "uniform"):
    """EID = softmax(alpha * mu + (1 - alpha) * sqrt(|sig|)).

    mu, sig: posterior mean / marginal variance on the grid, (G,) tensors
    (the model's ``predict``), on their own device.
    prior_sig: data-free variance (kernel variance + noise; for the MF
    model the sum of the per-fidelity variances + top noise, the
    ``param_array[[0,4,8,-1]]`` selection at
    reference/exploreSimSettings.py:16).
    auto: adaptive exploitation weight ``alpha = 1 - mean(sig)/prior_sig``
    (reference/exploreSimSettings.py:20-21).
    neg_var_guard: "uniform" (sim: any sig<0 -> uniform EID,
    reference/exploreSimSettings.py:30-35) or "clamp" (physical:
    sig[sig<0] = prior_sig, reference/PhysicalExperimentCode/
    exploreExpSettings.py:24).

    Returns (G,) normalized distribution.
    """
    mu = torch.as_tensor(mu).reshape(-1)
    sig = torch.as_tensor(sig, dtype=mu.dtype, device=mu.device).reshape(-1)
    had_neg = torch.any(sig < 0)
    if neg_var_guard == "clamp":
        sig = torch.where(sig < 0, torch.as_tensor(prior_sig, dtype=sig.dtype,
                                                   device=sig.device), sig)
        had_neg = torch.zeros((), dtype=torch.bool, device=sig.device)
    if auto:
        alpha = 1.0 - torch.mean(sig) / prior_sig
    faux_ucb = alpha * mu + (1.0 - alpha) * torch.sqrt(torch.abs(sig))
    eid = softmax(faux_ucb)
    uniform = torch.full_like(eid, 1.0 / eid.shape[0])
    return torch.where(had_neg, uniform, eid)


def eid_grid(WS, max_depth, nums=(10, 20, 10)):
    """The sim EID evaluation grid: meshgrid over workspace x depth with the
    reference's axis ordering and ravel layout
    (reference/exploreSimSettings.py:8-11); numpy."""
    specs = [(WS[0][0], WS[0][1], nums[0]),
             (WS[1][0], WS[1][1], nums[1]),
             (0.0, max_depth, nums[2])]
    grids = np.meshgrid(*[np.linspace(s[0], s[1], s[2]) for s in specs])
    return np.array([g.ravel() for g in grids]).T
