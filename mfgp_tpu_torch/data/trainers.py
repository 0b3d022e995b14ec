"""GP training & evaluation harness (SURVEY C19, reference/GPTrainers.py;
counterpart of ``mfgp_tpu/data/trainers.py``).

Per dataset, train four model families and evaluate on the test grid:

* MFGP  - 3-fidelity AR1 on KF-estimated positions
* SFGP  - single-fidelity on estimated positions
* SFGP-TP - single-fidelity on true positions (oracle baseline)
* NIGP  - input-noise GP on estimated positions

Metrics: RMSE and the precision-weighted WMSE
``e^T (Sigma^-1/|Sigma^-1|_F) e / n`` (reference/GPTrainers.py:121-137),
computed via Cholesky solves (``ops.linalg.weighted_mse``), never an
explicit inverse. Artifacts (hyp vectors, GPRes grids, MSE summaries) are
written in the reference's exact formats so its result parser and plotters
work unchanged on these outputs.

The models and the evaluation live on ``device``, the card unless the
caller asks for the CPU, and nothing leaves it but scalars and diagonals.
A WMSE whose float32 posterior covariance is numerically indefinite is
redone in float64 with jitter retries on the same device (``wmse_f64``),
and ``evaluate_models`` counts how often that happened. The JAX package
makes both of its repairs on the host: ``wmse_host64`` on the
per-dataset path, and on the batched study's (``_host64_wmse``) a float64
recomputation of the lane's whole posterior first, which the port's
``data.study_batched`` makes on the device before ``wmse_f64``.

``fit_mode="device-batched"`` (``process_directory``) fits and evaluates
every dataset of a directory at once, as lanes of one batch per model
family (``data.study_batched.process_datasets_batched``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.data.io import (GPDataset, load_gp_dataset, save_gpres,
                                    save_hyp_vector, save_mse)
from mfgp_tpu_torch.fields.wrbf import WRBFField, parse_field_settings
from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.models.mfgp import MFGP
from mfgp_tpu_torch.models.nigp import NIGP
from mfgp_tpu_torch.ops.linalg import weighted_mse
from mfgp_tpu_torch.utils.configs import SimConfig
from mfgp_tpu_torch.utils.device import CUDA

FIT_MODES = ("scipy", "device", "device-batched")
# the key under which evaluate_models reports its float64 WMSE repairs
F64_KEY = "wmse_f64_count"


class TrainedModels(NamedTuple):
    mf: MFGP
    sf: GP
    sf_tp: GP
    nigp: NIGP


def _check_fit_mode(fit_mode: str, batched: bool = False) -> None:
    """``fit_mode`` is one of ``FIT_MODES``; ``device-batched`` only where
    the caller batches (``batched``): a single dataset's models are fitted
    by the other two."""
    if fit_mode not in FIT_MODES or (fit_mode == "device-batched"
                                     and not batched):
        raise ValueError(fit_mode)


def train_models(ds: GPDataset, kernel: str = "rbf", jitter: float = 1e-6,
                 optimize: bool = True, nigp_restarts: int = 2,
                 nigp_iters: int = 10, dtype=np.float64,
                 fit_mode: str = "scipy", device=CUDA) -> TrainedModels:
    """Fit the four model families on one dataset
    (reference/GPTrainers.py:60-104).

    ``fit_mode="scipy"`` is the reference-style L-BFGS-B run on the
    autodiff NLML, one evaluation per host step. ``fit_mode="device"`` runs
    every fit restart-batched (``optimize_restarts`` on the analytic
    gradient, ``NIGP.fit_native``). In float32 on the card both go through
    the B1 kernel.
    """
    _check_fit_mode(fit_mode)
    dtype = np.dtype(dtype)
    Xs, ys = ds.fidelity_lists(use_estimates=True)
    mf = MFGP.from_fidelity_lists(
        [x.astype(dtype) for x in Xs], [y.astype(dtype) for y in ys],
        device=device, kernel=kernel, jitter=jitter)
    sf = GP(ds.X_est.astype(dtype), ds.y.astype(dtype), kernel=kernel,
            jitter=jitter, device=device)
    sf_tp = GP(ds.X_true.astype(dtype), ds.y.astype(dtype), kernel=kernel,
               jitter=jitter, device=device)
    if optimize:
        nigp = NIGP(n_restarts=nigp_restarts, iters=nigp_iters, device=device)
        if fit_mode == "device":
            # f32 fits never reach the 1e-6 gradient norm, so the default
            # tol runs every lane to maxiter; 1e-3 exits at f32
            # convergence (summary metrics unchanged, PARITY r3)
            tol = 1e-3 if dtype == np.float32 else 1e-6
            mf.optimize_restarts(fix_rhos=True, tol=tol)
            sf.optimize_restarts(tol=tol)
            sf_tp.optimize_restarts(tol=tol)
            nigp.fit_native(ds.X_est.astype(dtype), ds.y.astype(dtype),
                            n_restarts=max(nigp_restarts, 1))
            return TrainedModels(mf, sf, sf_tp, nigp)
        mf.optimize(fix_rhos=True)  # kern.scale.fix([1,1]), GPTrainers.py:67
        sf.optimize()
        sf_tp.optimize()
    else:
        # zero-iteration fit: condition on the data at the heuristic init
        # hyperparameters without any NLML optimization
        nigp = NIGP(n_restarts=0, iters=0, device=device)
    nigp.fit(ds.X_est.astype(dtype), ds.y.astype(dtype))
    return TrainedModels(mf, sf, sf_tp, nigp)


def wmse_f64(err: torch.Tensor, cov: torch.Tensor,
             normalize: bool = True) -> float:
    """Precision-weighted MSE in float64 on ``cov``'s device: the repair
    for lanes whose f32 posterior covariance is numerically indefinite
    (same mathematics as ops.linalg.weighted_mse; trace-scaled jitter
    retries, the schedule of ``wmse_host64``). NaN if no retry factors."""
    cov = cov.double()
    err = err.double()
    n = err.shape[0]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    jit = 1e-12
    for _ in range(6):
        L, info = torch.linalg.cholesky_ex(cov + jit * eye)
        if int(info) == 0:
            break
        jit = max(jit * 1e3, 1e-10 * float(torch.trace(cov)) / n)
    else:
        return float("nan")
    quad = torch.dot(err, torch.cholesky_solve(err[:, None], L)[:, 0])
    if normalize:
        A = torch.linalg.solve_triangular(L, eye, upper=False)
        quad = quad / torch.linalg.matrix_norm(A.T @ A)
    return float(quad) / n


def wmse_host64(err, cov, normalize: bool = True) -> float:
    """``wmse_f64`` in host numpy/scipy, as the JAX package has it: the
    reference that the tests hold ``wmse_f64`` against. Nothing in the
    port's paths calls it."""
    from scipy.linalg import cho_factor, cho_solve, solve_triangular

    cov = np.asarray(cov, np.float64)
    err = np.asarray(err, np.float64)
    n = err.shape[0]
    jit = 1e-12
    for _ in range(6):
        try:
            cf = cho_factor(cov + jit * np.eye(n), lower=True)
            break
        except np.linalg.LinAlgError:
            jit = max(jit * 1e3, 1e-10 * np.trace(cov) / n)
    else:
        return float("nan")
    quad = float(err @ cho_solve(cf, err))
    if normalize:
        A = solve_triangular(np.tril(cf[0]), np.eye(n), lower=True)
        quad /= float(np.linalg.norm(A.T @ A))
    return quad / n


@torch.no_grad()
def evaluate_models(models: TrainedModels, test_points: np.ndarray,
                    true_field: WRBFField, normalize: bool = True):
    """Posterior grids + RMSE/WMSE for all four models
    (reference/GPTrainers.py:107-170). Returns (metrics, grids).

    The (M, M) covariances stay on the models' device: the WMSE solve
    consumes them there and only scalars and diagonals come back. Where a
    WMSE is not finite (a near-singular float32 posterior covariance: the
    ``Kss - V^T V`` cancellation), that one metric is redone there in
    float64 (``wmse_f64``); ``metrics["wmse_f64_count"]`` says how many of
    the four took that route.
    """
    tp = np.asarray(test_points, np.float64)
    f_true = true_field.numpy(tp)

    mu_mf, cov_mf = models.mf.predict(tp, full_cov=True)
    mu_sf, cov_sf = models.sf.predict(tp, full_cov=True)
    mu_tp, cov_tp = models.sf_tp.predict(tp, full_cov=True)
    mu_ni, cov_ni = models.nigp.predict(tp, return_cov=True, as_numpy=False)

    metrics = {}
    grids = {}
    repairs = 0
    for key, mu, cov in (("mf", mu_mf, cov_mf), ("sf", mu_sf, cov_sf),
                         ("nisf", mu_ni, cov_ni), ("sfTP", mu_tp, cov_tp)):
        mu = mu.detach().cpu().numpy().reshape(-1)
        err = mu - f_true
        metrics[f"RMSE {key}"] = float(np.sqrt(np.mean(err ** 2)))
        err_t = torch.as_tensor(err, dtype=cov.dtype, device=cov.device)
        w = float(weighted_mse(err_t, cov, normalize=normalize))
        if not np.isfinite(w):
            w = wmse_f64(err_t, cov, normalize)
            repairs += 1
        metrics[f"WRMSE {key}"] = w
        grids[key] = (mu, torch.diagonal(cov).cpu().numpy())
    metrics[F64_KEY] = repairs
    return metrics, grids


def process_dataset(gpdata_path: str, field_settings_path: str,
                    out_dir: str | None = None, cfg: SimConfig | None = None,
                    kernel: str = "rbf", optimize: bool = True,
                    fit_mode: str = "scipy", dtype=np.float64, device=CUDA):
    """One full GPTrainers unit: load -> fit x4 -> evaluate -> artifacts.

    Artifact names mirror the reference (reference/GPTrainers.py:70-170):
    ``<base>_emuGP.txt / _sfGP.txt / _sfGPTP.txt / _nisfGP.txt``,
    ``GPRes_*.csv``, ``MSE_*.txt``. The count of float64 WMSE repairs
    stays in the returned metrics and out of the ``MSE_*.txt`` file, whose
    keys are the reference's.
    """
    cfg = cfg or SimConfig()
    ds = load_gp_dataset(gpdata_path, t_cut=cfg.t_cut)
    field = parse_field_settings(field_settings_path, device=device)
    models = train_models(ds, kernel=kernel, optimize=optimize,
                          fit_mode=fit_mode, dtype=dtype, device=device)
    tp = cfg.test_points()
    metrics, grids = evaluate_models(models, tp, field,
                                     normalize=cfg.normalize_wmse)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.basename(gpdata_path).replace(".csv", "_")
        save_hyp_vector(os.path.join(out_dir, base + "emuGP.txt"),
                        models.mf.param_array, row=True)
        save_hyp_vector(os.path.join(out_dir, base + "sfGP.txt"),
                        models.sf.param_array)
        save_hyp_vector(os.path.join(out_dir, base + "sfGPTP.txt"),
                        models.sf_tp.param_array)
        save_hyp_vector(os.path.join(out_dir, base + "nisfGP.txt"),
                        models.nigp.get_params())
        save_gpres(
            os.path.join(out_dir, os.path.basename(gpdata_path)
                         .replace("GPData", "GPRes")),
            tp, field.numpy(tp), grids["sf"][0], grids["sf"][1],
            grids["mf"][0], grids["mf"][1])
        save_mse(os.path.join(out_dir, os.path.basename(gpdata_path)
                              .replace("GPData", "MSE")
                              .replace(".csv", ".txt")),
                 {k: v for k, v in metrics.items() if k != F64_KEY})
    return models, metrics


def dataset_task(fname: str, gpdata_dir: str, field_dir: str, out_dir: str,
                 resume: bool = True):
    """Resolve one ``GPData_*.csv`` into (done, gpdata_path, settings_path).

    The single source of truth for the sweep conventions: resume by
    MSE-output existence (the reference's skip-to-last-file logic,
    reference/GPTrainers.py:21-22) and the ``fieldMeas_<seed>`` filename ->
    FieldSettings mapping."""
    mse_name = fname.replace("GPData", "MSE").replace(".csv", ".txt")
    done = resume and os.path.exists(os.path.join(out_dir, mse_name))
    field_seed = fname.split("_")[3]
    settings = os.path.join(field_dir, f"FieldSettings{field_seed}.txt")
    return done, os.path.join(gpdata_dir, fname), settings


def process_directory(gpdata_dir: str, field_dir: str, out_dir: str,
                      cfg: SimConfig | None = None, kernel: str = "rbf",
                      resume: bool = True, optimize: bool = True,
                      fit_mode: str = "scipy", dtype=np.float64,
                      verbose: bool = False, device=CUDA):
    """Sweep a GPDataSets directory (resumable by output existence);
    returns ``{file name: metrics}`` of the datasets processed now.

    ``fit_mode="device-batched"``: every dataset still to do is fitted and
    evaluated at once, as lanes of one batch per model family
    (``data.study_batched.process_datasets_batched``)."""
    _check_fit_mode(fit_mode, batched=True)
    tasks = []
    for fname in sorted(os.listdir(gpdata_dir)):
        if not fname.endswith(".csv"):
            continue
        done, gpdata_path, settings = dataset_task(
            fname, gpdata_dir, field_dir, out_dir, resume)
        if not done:
            tasks.append((fname, gpdata_path, settings))
    if fit_mode == "device-batched":
        from mfgp_tpu_torch.data.study_batched import \
            process_datasets_batched

        return process_datasets_batched(
            [t[1] for t in tasks], [t[2] for t in tasks], out_dir, cfg=cfg,
            kernel=kernel, dtype=dtype, verbose=verbose, device=device)
    results = {}
    for fname, gpdata_path, settings in tasks:
        _, metrics = process_dataset(gpdata_path, settings, out_dir, cfg,
                                     kernel=kernel, optimize=optimize,
                                     fit_mode=fit_mode, dtype=dtype,
                                     device=device)
        if verbose:
            print(f"{fname}: {metrics}", flush=True)
        results[fname] = metrics
    return results
