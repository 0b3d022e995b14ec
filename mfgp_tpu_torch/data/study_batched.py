"""Whole-matrix batched study (counterpart of
``mfgp_tpu/data/study_batched.py``): every dataset of the study's matrix
fitted and evaluated as lanes of one batch.

The per-dataset path (``data.trainers.process_dataset``) runs each fit as
8 restart lanes evaluated one at a time; at the study's N ~ 700 an
evaluation is ~100 microsecond-long launches behind eager Python, and the
card idles. The reference's design is embarrassingly parallel and its
datasets share one shape (same trajectory duration and sampling rate, so
the same N), so this module stacks the datasets on a lane axis and runs,
per model family (MFGP / SFGP / SFGP-TP / NIGP),

    one restart-batched L-BFGS sweep over datasets x restarts lanes, whose
    every round evaluates all active lanes in one call
    (``batched_lbfgs(value_and_grad_lanes=...)``: one launch of B1's lane
    axis for all lanes' Grams, batched Cholesky, K^-1 and contractions),
    then one evaluation over dataset lanes (condition -> full-covariance
    grid posterior -> RMSE + precision-weighted MSE),

where the JAX package vmaps one compiled sweep and one compiled
evaluation. Artifacts are written per dataset in the reference's schemas,
with the same names and formats as the per-dataset path
(reference/GPTrainers.py:70-170).

Datasets of differing N are grouped by N and each group is batched.
``fit_chunk`` / ``eval_chunk`` datasets go into one call (the memory
bound; nothing is compiled, so nothing is padded). A lane whose float32
evaluation is not finite is redone in float64 on the same device: its
posterior recomputed from its fitted vector, then ``trainers.wmse_f64``
(the JAX package's host repair, ``_host64_wmse``), all bad lanes of a
family as one batch; the repairs are counted per dataset.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.data.io import (load_gp_dataset, save_gpres,
                                    save_hyp_vector, save_mse)
from mfgp_tpu_torch.data.trainers import F64_KEY, wmse_f64
from mfgp_tpu_torch.fields.wrbf import parse_field_settings
from mfgp_tpu_torch.models import gp as gpm
from mfgp_tpu_torch.models import mfgp as mfm
from mfgp_tpu_torch.models import nigp as nim
from mfgp_tpu_torch.ops import covariance as _cov
from mfgp_tpu_torch.ops import linalg as _la
from mfgp_tpu_torch.ops.optimize import (batched_lbfgs, penalize_nonfinite,
                                         restart_inits)
from mfgp_tpu_torch.utils.configs import SimConfig
from mfgp_tpu_torch.utils.device import CUDA, resolve

FAMILIES = ("mf", "sf", "sfTP", "nisf")


# ---------------------------------------------------------------------------
# batched fits: datasets x restarts lanes of one L-BFGS sweep
# ---------------------------------------------------------------------------
class FitSweep(NamedTuple):
    """One family's sweep over B datasets x R restart lanes."""

    x: torch.Tensor  # (B, n) every dataset's best lane
    f: torch.Tensor  # (B, R) final NLML per lane
    f0: torch.Tensor  # (B, R) NLML at each lane's start (row 0: x0)
    k: torch.Tensor  # (B, R) L-BFGS iterations per lane
    evals: torch.Tensor  # (B, R) objective evaluations per lane
    rounds: torch.Tensor  # (B,) evaluator calls of the dataset's sweep


def _sweep(inits, B: int, vg, lower, upper, maxiter: int, tol: float,
           ftol: float) -> FitSweep:
    """``batched_lbfgs`` over B datasets x R restarts: ``inits`` (R, n),
    shared by every dataset, or (B, R, n); ``vg(dataset_of_lane (r,), xs
    (r, n)) -> (f (r,), g (r, n))`` evaluates any set of lanes at once."""
    R, n = inits.shape[-2:]
    x0 = inits.expand(B, R, n).reshape(B * R, n)
    evals = torch.zeros(B * R, dtype=torch.long, device=x0.device)
    first, rounds = [], [0]

    def lanes_vg(lanes, xs):
        f, g = vg(lanes // R, xs)
        evals.index_add_(0, lanes, torch.ones_like(lanes))
        rounds[0] += 1
        if not first:
            first.append(f)
        return f, g

    with torch.no_grad():
        xs, fs, ks = batched_lbfgs(None, x0, lower=lower, upper=upper,
                                   maxiter=maxiter, tol=tol, ftol=ftol,
                                   value_and_grad_lanes=lanes_vg)
    fs = fs.reshape(B, R)
    best = torch.argmin(torch.where(torch.isfinite(fs), fs, torch.inf), 1)
    x = xs.reshape(B, R, n)[torch.arange(B, device=xs.device), best]
    return FitSweep(x, fs, first[0].reshape(B, R), ks.reshape(B, R),
                    evals.reshape(B, R),
                    torch.full((B,), rounds[0], device=xs.device))


def _fit_sf_batch(inits, Xb, yb, kernel, jitter, maxiter, tol,
                  ftol=0.0) -> FitSweep:
    """SFGP restart fits of B datasets (Xb (B, N, D), yb (B, N)) from the
    shared ``inits`` (R, D + 2) log-space rows, on the analytic gradient
    (``gp.nlml_value_and_grad_lanes``); non-finite NLMLs count as 1e20
    with a zero gradient, lane by lane (``gp._fit_restarts``)."""
    D = Xb.shape[-1]

    def vg(d, xs):
        p = gpm.GPParams(xs[:, 0], xs[:, 1:1 + D], xs[:, 1 + D])
        v, g = gpm.nlml_value_and_grad_lanes(p, Xb[d], yb[d], kernel,
                                             jitter)
        return penalize_nonfinite(v, torch.cat(
            [g.log_variance[:, None], g.log_lengthscales,
             g.log_noise[:, None]], 1))

    return _sweep(inits, Xb.shape[0], vg, None, None, maxiter, tol, ftol)


def _fit_mf_batch(inits, Xb, fidb, yb, fixed_rhos, lower, upper, kernel,
                  jitter, maxiter, tol, ftol=0.0) -> FitSweep:
    """AR1 MFGP restart fits of B datasets (rows in emukit fidelity order)
    from the shared ``inits`` (R, 2F + F D), rhos fixed
    (``mfgp._mf_fit_restarts``), on ``mfgp.nlml_value_and_grad_lanes``."""
    F = fixed_rhos.shape[0] + 1
    D = Xb.shape[-1]

    def vg(d, xs):
        r = xs.shape[0]
        p = mfm.MFGPParams(xs[:, :F], xs[:, F:F + F * D].reshape(r, F, D),
                           fixed_rhos.expand(r, F - 1), xs[:, F + F * D:])
        v, g = mfm.nlml_value_and_grad_lanes(p, Xb[d], fidb[d], yb[d],
                                             kernel, jitter)
        return penalize_nonfinite(v, torch.cat(
            [g.log_variances, g.log_lengthscales.reshape(r, -1),
             g.log_noises], 1))

    return _sweep(inits, Xb.shape[0], vg, lower, upper, maxiter, tol, ftol)


def _fit_nigp_batch(initsb, Xb, yb, lower, upper, maxiter,
                    ftol=0.0) -> FitSweep:
    """NIGP native fits of B datasets from per-dataset ``initsb``
    (B, R, 2D + 2), by autograd through ``nigp.nlml_native``; a
    non-finite NLML counts as 1e20 (``nigp._nigp_fit_restarts``)."""
    def vg(d, xs):
        with torch.enable_grad():
            x = xs.detach().requires_grad_(True)
            v = nim.nlml_native(x, Xb[d], yb[d])
            v = torch.where(torch.isfinite(v), v, 1e20)
            g, = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    return _sweep(initsb, Xb.shape[0], vg, lower, upper, maxiter, 1e-6,
                  ftol)


# ---------------------------------------------------------------------------
# batched evaluation (the mathematics of trainers.evaluate_models)
# ---------------------------------------------------------------------------
def _chunked_launch(fn, *arrs, chunk: int):
    """``fn`` over ``chunk`` datasets at a time of the leading axis of
    ``arrs`` (the memory bound of one call), outputs concatenated field by
    field."""
    outs = [fn(*(a[c0:c0 + chunk] for a in arrs))
            for c0 in range(0, arrs[0].shape[0], chunk)]
    return type(outs[0])(*(torch.cat(parts) for parts in zip(*outs)))


def _diag(d, n: int):
    """A per-lane scalar (c,) as a (c, n) diagonal."""
    return d[:, None].expand(-1, n).contiguous()


def _metrics_from_cov(err, cov, normalize):
    """RMSE and precision-weighted MSE of each lane, with the non-finite
    jitter retry of ``evaluate_models``, lane by lane (branch-free, as the
    JAX package vmaps it)."""
    rmse = torch.sqrt(torch.mean(err ** 2, dim=-1))
    w = _la.weighted_mse(err, cov, normalize=normalize)
    M = cov.shape[-1]
    # dtype-aware retry jitter: the Cholesky of a near-singular posterior
    # (NIGP with vanishing noise) needs ~eps * lambda_max to succeed; the
    # float64-sized 1e-10 * trace/M is invisible in float32
    eps = torch.finfo(cov.dtype).eps
    jit = 10.0 * eps * torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) + 1e-12
    w2 = _la.weighted_mse(err, _la.diag_add(cov, _diag(jit, M)),
                          normalize=normalize)
    return rmse, torch.where(torch.isfinite(w), w, w2)


def _posterior(Kn, Kxs, Kss, y, out_noise):
    """Grid posterior mean (c, M) and covariance (c, M, M) of each lane
    from its noisy Gram, cross- and grid covariances."""
    L = _la.chol(Kn)
    del Kn
    alpha = _la.solve_posterior(L, y)
    mu = (Kxs @ alpha[..., None])[..., 0]
    cov = _la.posterior_cov(Kss, Kxs, L)
    return mu, _la.diag_add(cov, out_noise)


def _post_sf(vec, X, y, tp, kernel, jitter):
    """SFGP posterior of each lane from its log-space vector (c, D + 2)."""
    c, N, D = X.shape
    M = tp.shape[0]
    var, ls = torch.exp(vec[:, :1]), torch.exp(vec[:, 1:1 + D])[:, None, :]
    noise = torch.exp(vec[:, 1 + D])
    r0 = vec.new_zeros((c, 0))
    z = torch.zeros((c, N), dtype=torch.long, device=X.device)
    zs = torch.zeros((c, M), dtype=torch.long, device=X.device)
    T = tp.expand(c, M, D)
    Kn = _cov.ar1_cov_lanes(var, ls, r0, X, z, X, z, kernel,
                            _diag(noise + jitter, N))
    Kxs = _cov.ar1_cov_lanes(var, ls, r0, T, zs, X, z, kernel)
    Kss = _cov.ar1_cov_lanes(var, ls, r0, T, zs, T, zs, kernel)
    return _posterior(Kn, Kxs, Kss, y, _diag(noise, M))


def _post_mf(vec, X, fid, y, tp, F, kernel, jitter):
    """AR1 MFGP posterior at the highest fidelity of each lane from its
    positive-space GPy vector (c, F (D + 1) + F - 1 + F)."""
    c, N, D = X.shape
    M = tp.shape[0]
    per = vec[:, :F * (D + 1)].reshape(c, F, D + 1)
    p = mfm.MFGPParams(torch.log(per[..., 0]), torch.log(per[..., 1:]),
                       vec[:, F * (D + 1):F * (D + 1) + F - 1],
                       torch.log(vec[:, F * (D + 1) + F - 1:]))
    v, ls, rhos, nz = p.variances, p.lengthscales, p.rhos, p.noises
    fid_s = torch.full((c, M), F - 1, dtype=torch.long, device=X.device)
    T = tp.expand(c, M, D)
    Kn = _cov.ar1_cov_lanes(v, ls, rhos, X, fid, X, fid, kernel,
                            torch.gather(nz, -1, fid) + jitter)
    Kxs = _cov.ar1_cov_lanes(v, ls, rhos, T, fid_s, X, fid, kernel)
    Kss = _cov.ar1_cov_lanes(v, ls, rhos, T, fid_s, T, fid_s, kernel)
    return _posterior(Kn, Kxs, Kss, y, torch.gather(nz, -1, fid_s))


def _post_nigp(lh, X, y, tp):
    """NIGP posterior of each lane from its log-space vector (c, 2D + 2):
    the input-noise inflation from the posterior-mean gradients at the
    training points, no output noise, the 1e-12 floor."""
    c, N, D = X.shape
    M = tp.shape[0]
    ls, sf = torch.exp(lh[:, :D]), torch.exp(lh[:, D])
    sy, sx = torch.exp(lh[:, D + 1]), torch.exp(lh[:, D + 2:])
    _, grads = nim.posterior_mean_grads(X, y, ls, sf, sy)
    v = torch.sum((grads ** 2) * (sx[:, None, :] ** 2), dim=-1)
    var, l1 = sf[:, None], ls[:, None, :]
    r0 = lh.new_zeros((c, 0))
    z = torch.zeros((c, N), dtype=torch.long, device=X.device)
    zs = torch.zeros((c, M), dtype=torch.long, device=X.device)
    T = tp.expand(c, M, D)
    Kn = _cov.ar1_cov_lanes(var, l1, r0, X, z, X, z, "rbf",
                            _diag(sy ** 2, N) + v)
    Kxs = _cov.ar1_cov_lanes(var, l1, r0, T, zs, X, z, "rbf")
    Kss = _cov.ar1_cov_lanes(var, l1, r0, T, zs, T, zs, "rbf")
    return _posterior(Kn, Kxs, Kss, y, lh.new_full((c, M), 1e-12))


class LaneEval(NamedTuple):
    rmse: torch.Tensor  # (c,)
    wmse: torch.Tensor  # (c,)
    mu: torch.Tensor  # (c, M)
    var: torch.Tensor  # (c, M) the posterior covariance's diagonal


def _eval(post, f_true, normalize) -> LaneEval:
    mu, cov = post
    rmse, w = _metrics_from_cov(mu - f_true, cov, normalize)
    return LaneEval(rmse, w, mu, torch.diagonal(cov, dim1=-2, dim2=-1))


def _eval_sf_one(vec, X, y, tp, f_true, kernel, jitter, normalize):
    """SFGP evaluation of a chunk of lanes: log-space vectors (c, D + 2),
    X (c, N, D), y (c, N), the shared grid tp (M, D), f_true (c, M)."""
    return _eval(_post_sf(vec, X, y, tp, kernel, jitter), f_true, normalize)


def _eval_mf_one(vec, X, fid, y, tp, f_true, F, kernel, jitter, normalize):
    """AR1 MFGP evaluation of a chunk of lanes (positive-space vectors)."""
    return _eval(_post_mf(vec, X, fid, y, tp, F, kernel, jitter), f_true,
                 normalize)


def _eval_nigp_one(lh, X, y, tp, f_true, normalize):
    """NIGP evaluation of a chunk of lanes (log-space vectors)."""
    return _eval(_post_nigp(lh, X, y, tp), f_true, normalize)


def _repair64(post64, f_true, normalize):
    """(RMSE, WMSE) of lanes whose float32 evaluation was not finite, from
    their posteriors recomputed in float64 (``post64``: mean and covariance
    of all of them, one batch) and ``trainers.wmse_f64``'s jitter retries
    (the JAX package's host ``_host64_wmse``)."""
    mu, cov = post64
    err = mu - f_true.double()
    rmse = torch.sqrt(torch.mean(err ** 2, dim=-1)).cpu().numpy()
    return [(float(rmse[i]), wmse_f64(err[i], cov[i], normalize))
            for i in range(err.shape[0])]


# ---------------------------------------------------------------------------
# the whole study
# ---------------------------------------------------------------------------
def _nigp_inits(dss, D, nigp_restarts, seed, dtype):
    """NIGP restart points per dataset (B, R, 2D + 2): the heuristics of
    ``NIGP.fit_native`` on the host, one ``default_rng(seed)`` stream over
    the datasets in order (the JAX package's draws, exactly)."""
    nig_inits = []
    nrng = np.random.default_rng(seed)
    for d in dss:
        Xn = np.asarray(d.X_est, dtype)
        pair = np.sqrt(np.maximum(0, np.sum(
            (Xn[:, None, :] - Xn[None, :, :]) ** 2, axis=2)))
        pos = pair[pair > 0]
        med = np.median(pos) if pos.size else 1.0
        std_y = np.std(np.asarray(d.y)) or 1.0
        lh0 = np.concatenate([
            np.log(np.ones(D) * (med if med > 0 else 1.0)),
            [np.log(std_y), np.log(0.1 * std_y)],
            np.log(np.maximum(np.ones(D) * 0.01 * np.std(Xn, axis=0),
                              1e-8))])
        ini = (lh0[None, :] + 0.3 * nrng.standard_normal(
            (max(nigp_restarts, 1), lh0.shape[0])))
        ini[0] = lh0
        nig_inits.append(ini)
    return np.stack(nig_inits)


def process_datasets_batched(gpdata_paths, field_settings, out_dir=None,
                             cfg: SimConfig | None = None,
                             kernel: str = "rbf", jitter: float = 1e-6,
                             dtype=np.float32, n_restarts: int = 8,
                             maxiter: int = 200, tol: float = 1e-3,
                             nigp_restarts: int = 2, seed: int = 0,
                             verbose: bool = False, eval_chunk: int = 8,
                             fit_chunk: int = 8, ftol: float = 1e-6,
                             device=CUDA, stats: dict | None = None):
    """Fit and evaluate every dataset, per same-N group one batched sweep
    and one batched evaluation per model family. ``field_settings``: one
    path, or a list aligned with ``gpdata_paths``. Returns {basename:
    metrics}, each with the count of its families whose WMSE was redone
    in float64 (``wmse_f64_count``, as ``evaluate_models`` reports it);
    writes the per-dataset reference artifacts when ``out_dir`` is given
    (the ``MSE_*.txt`` files keep the reference's keys).

    ``fit_chunk`` / ``eval_chunk``: datasets per call of a family's sweep /
    evaluation (the memory bound: a fit lane holds a few N x N buffers, an
    evaluation lane a few M x M ones). SFGP and MFGP restarts start from
    ``restart_inits(0, n_restarts, 1.0, seed)``, the per-dataset
    ``optimize_restarts``' own points; the NIGP's from the JAX package's
    host heuristics and draws.

    ``ftol``: relative-f stagnation stop of the restart lanes (scipy
    L-BFGS-B's ``factr`` criterion, the optimiser of the reference's GPy
    fits, reference/GPTrainers.py:68): a lane that decreases f by less
    than ``ftol * max(1, |f|)`` in an accepted step stops, which ends the
    straggling lanes that a round of the sweep waits for. 0.0 keeps the
    pure max|g| < tol criterion.

    ``stats``, when given, collects per family the sweep's ``FitSweep``
    fields (per lane: final and starting NLML, iterations, evaluations; per
    dataset: rounds) as lists, the seconds of its fits and evaluation, and
    the float64 repairs. ``verbose`` reports each stage on standard
    error."""
    if not gpdata_paths:
        return {}
    cfg = cfg or SimConfig()
    device = resolve(device)
    tdt = torch.float32 if np.dtype(dtype) == np.float32 else torch.float64
    z = dict(dtype=tdt, device=device)
    if isinstance(field_settings, (str, os.PathLike)):
        field_settings = [field_settings] * len(gpdata_paths)
    datasets = [load_gp_dataset(p, t_cut=cfg.t_cut) for p in gpdata_paths]
    tp_np = np.asarray(cfg.test_points(), dtype)
    fields = [parse_field_settings(f, device=device) for f in field_settings]
    f_true = np.stack([f.numpy(tp_np) for f in fields]).astype(dtype)
    normalize = cfg.normalize_wmse
    tp = torch.as_tensor(tp_np, **z)
    stats = stats if stats is not None else {}
    clock = time.perf_counter

    groups: dict[int, list[int]] = {}
    for i, ds in enumerate(datasets):
        groups.setdefault(ds.n, []).append(i)

    results: dict[str, dict] = {}
    for n, idxs in sorted(groups.items()):
        t0 = clock()
        dss = [datasets[i] for i in idxs]
        D = dss[0].X_est.shape[1]
        F = 3

        def stack(arrs, dt=None):
            return torch.as_tensor(np.stack(arrs), **(dt or z)).contiguous()

        X_sf, X_tp = stack([d.X_est for d in dss]), stack([d.X_true
                                                           for d in dss])
        y_b = stack([d.y for d in dss])
        mf_rows = [mfm.stack_fidelity_lists(*d.fidelity_lists(True),
                                            device="cpu") for d in dss]
        Xmf = stack([r[0].numpy() for r in mf_rows])
        fmf = stack([r[1].numpy() for r in mf_rows],
                    dict(dtype=torch.long, device=device))
        ymf = stack([r[2].numpy() for r in mf_rows])
        ft = torch.as_tensor(f_true[idxs], **z)

        # restart points: the per-dataset path's (optimize_restarts with
        # default params and seed), shared by every dataset
        inits_sf = restart_inits(torch.zeros(D + 2, **z), n_restarts, 1.0,
                                 seed)
        n_mf = F + F * D + F  # log vars + log ls + log noises
        inits_mf = restart_inits(torch.zeros(n_mf, **z), n_restarts, 1.0,
                                 seed)
        fixed_rhos = torch.ones(F - 1, **z)
        inf = torch.full((n_mf,), torch.inf, **z)
        nig_inits = torch.as_tensor(
            _nigp_inits(dss, D, nigp_restarts, seed, dtype), **z)
        nig_lo = torch.full((2 * D + 2,), float(np.log(1e-6)), **z)
        nig_hi = torch.full((2 * D + 2,), float(np.log(1e6)), **z)

        # --- four fit sweeps ------------------------------------------------
        sweeps, fit_s = {}, {}
        runs = (
            ("mf", lambda X, f, y: _fit_mf_batch(
                inits_mf, X, f, y, fixed_rhos, -inf, inf, kernel, jitter,
                maxiter, tol, ftol), (Xmf, fmf, ymf)),
            ("sf", lambda X, y: _fit_sf_batch(
                inits_sf, X, y, kernel, jitter, maxiter, tol, ftol),
             (X_sf, y_b)),
            ("sfTP", lambda X, y: _fit_sf_batch(
                inits_sf, X, y, kernel, jitter, maxiter, tol, ftol),
             (X_tp, y_b)),
            ("nisf", lambda ini, X, y: _fit_nigp_batch(
                ini, X, y, nig_lo, nig_hi, maxiter, ftol),
             (nig_inits, X_sf, y_b)))
        for key, fn, arrs in runs:
            t1 = clock()
            sweeps[key] = _chunked_launch(fn, *arrs, chunk=fit_chunk)
            fit_s[key] = clock() - t1
            if verbose:
                print(f"  fit {key}: {fit_s[key]:.1f}s, "
                      f"{int(sweeps[key].evals.sum())} lane evaluations",
                      file=sys.stderr, flush=True)

        # --- four evaluations (chunked: an evaluation lane holds several
        # (M, M) covariances) -------------------------------------------
        # the MFGP's GPy param_array (positive space), as the evaluation
        # and the emuGP artifact take it
        x = sweeps["mf"].x
        B = x.shape[0]
        mf_vec = torch.cat([
            torch.exp(torch.cat([x[:, :F, None],
                                 x[:, F:F + F * D].reshape(B, F, D)], -1))
            .reshape(B, -1), fixed_rhos.expand(B, F - 1),
            torch.exp(x[:, F + F * D:])], 1)
        vecs = {"mf": mf_vec, "sf": sweeps["sf"].x, "sfTP": sweeps["sfTP"].x,
                "nisf": sweeps["nisf"].x}
        tp64 = tp.double()
        evals = {
            "mf": (lambda v, X, f, y, t: _eval_mf_one(
                v, X, f, y, tp, t, F, kernel, jitter, normalize),
                (Xmf, fmf, ymf),
                lambda v, X, f, y: _post_mf(v, X, f, y, tp64, F, kernel,
                                            jitter)),
            "sf": (lambda v, X, y, t: _eval_sf_one(
                v, X, y, tp, t, kernel, jitter, normalize), (X_sf, y_b),
                lambda v, X, y: _post_sf(v, X, y, tp64, kernel, jitter)),
            "sfTP": (lambda v, X, y, t: _eval_sf_one(
                v, X, y, tp, t, kernel, jitter, normalize), (X_tp, y_b),
                lambda v, X, y: _post_sf(v, X, y, tp64, kernel, jitter)),
            "nisf": (lambda v, X, y, t: _eval_nigp_one(
                v, X, y, tp, t, normalize), (X_sf, y_b),
                lambda v, X, y: _post_nigp(v, X, y, tp64)),
        }

        def f64(a):
            return a.double() if a.is_floating_point() else a

        ev, eval_s, repairs = {}, {}, {}
        for key, (fn, arrs, post64) in evals.items():
            t1 = clock()
            with torch.no_grad():
                e = _chunked_launch(fn, vecs[key], *arrs, ft,
                                    chunk=eval_chunk)
                rm, wm = e.rmse.cpu().numpy(), e.wmse.cpu().numpy()
                bad = np.nonzero(~(np.isfinite(rm) & np.isfinite(wm)))[0]
                fixed = []
                for c0 in range(0, len(bad), eval_chunk):
                    b = torch.as_tensor(bad[c0:c0 + eval_chunk],
                                        device=device)
                    fixed += _repair64(post64(
                        vecs[key][b].double(), *(f64(a[b]) for a in arrs)),
                        ft[b], normalize)
            for b, (r, w) in zip(bad, fixed):
                rm[b], wm[b] = r, w
            ev[key] = (rm, wm, e.mu.cpu().numpy(), e.var.cpu().numpy())
            repairs[key] = bad.tolist()
            eval_s[key] = clock() - t1
        if verbose:
            print(f"group N={n}: {len(idxs)} datasets, fits "
                  f"{sum(fit_s.values()):.1f}s, evaluations "
                  f"{sum(eval_s.values()):.1f}s, float64 repairs "
                  f"{ {k: len(v) for k, v in repairs.items()} }",
                  file=sys.stderr, flush=True)

        for key in FAMILIES:
            st = stats.setdefault(key, {})
            for field in FitSweep._fields:
                st.setdefault(field, []).extend(
                    getattr(sweeps[key], field).cpu().tolist())
            st["fit_s"] = st.get("fit_s", 0.0) + fit_s[key]
            st["eval_s"] = st.get("eval_s", 0.0) + eval_s[key]
            st["repairs"] = st.get("repairs", 0) + len(repairs[key])

        mf_np = mf_vec.cpu().numpy()
        sf_np = np.exp(sweeps["sf"].x.cpu().numpy())
        tp_vec_np = np.exp(sweeps["sfTP"].x.cpu().numpy())
        ni_np = sweeps["nisf"].x.cpu().numpy()
        for b, i in enumerate(idxs):
            base = os.path.basename(gpdata_paths[i])
            metrics = {}
            for key in ("mf", "sf", "sfTP", "nisf"):
                metrics[f"RMSE {key}"] = float(ev[key][0][b])
                metrics[f"WRMSE {key}"] = float(ev[key][1][b])
            metrics = {k: metrics[k] for k in (
                "RMSE mf", "WRMSE mf", "RMSE sf", "WRMSE sf", "RMSE sfTP",
                "WRMSE sfTP", "RMSE nisf", "WRMSE nisf")}
            results[base] = {**metrics, F64_KEY: sum(
                b in repairs[key] for key in FAMILIES)}
            if out_dir is None:
                continue
            os.makedirs(out_dir, exist_ok=True)
            stem = base.replace(".csv", "_")
            save_hyp_vector(os.path.join(out_dir, stem + "emuGP.txt"),
                            mf_np[b], row=True)
            save_hyp_vector(os.path.join(out_dir, stem + "sfGP.txt"),
                            sf_np[b])
            save_hyp_vector(os.path.join(out_dir, stem + "sfGPTP.txt"),
                            tp_vec_np[b])
            lh = ni_np[b]
            save_hyp_vector(os.path.join(out_dir, stem + "nisfGP.txt"),
                            np.hstack([np.exp(lh[D + 2:]), np.exp(lh[D]),
                                       np.exp(lh[D + 1]), np.exp(lh[:D])]))
            save_gpres(os.path.join(out_dir,
                                    base.replace("GPData", "GPRes")),
                       tp_np, f_true[i], ev["sf"][2][b], ev["sf"][3][b],
                       ev["mf"][2][b], ev["mf"][3][b])
            save_mse(os.path.join(out_dir, base.replace("GPData", "MSE")
                                  .replace(".csv", ".txt")), metrics)
        if verbose:
            print(f"group N={n}: done in {clock() - t0:.1f}s",
                  file=sys.stderr, flush=True)
    return results
