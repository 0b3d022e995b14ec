"""CSV dataset I/O, byte-compatible with the reference ``Data/`` schemas
(counterpart of ``mfgp_tpu/data/io.py``; numpy, and ``native``'s
parser where it is built).

Schemas covered (SURVEY §5 metrics/observability):

* trajectory estimates ``T<seed>_<vmn>.csv``:
  ``t,x,y,z,xh,yh,zh,sigx,sigy,sigz,xe,ye,ze``
  (reference/trajectoryEstimateGenerator.py:47)
* field measurements ``fieldMeas_<seed>_<traj>.csv``: ``t,x,y,z,fieldVal``
  (reference/measFieldData.py:60)
* GP datasets ``GPData_<rate>_fieldMeas_...csv``:
  ``t,x,y,z,xh,yh,zh,fieldVal,fidLev`` (reference/prepGPData.py:48)
* hyperparameter vectors ``*_emuGP/sfGP/sfGPTP/nisfGP.txt`` (one comma row /
  one value per line, reference/GPTrainers.py:70-103)
* posterior grids ``GPRes_*.csv``:
  ``x,y,z,trueField,sfMean,sfVar,mfMean,mfVar`` (reference/GPTrainers.py:146)
* error summaries ``MSE_*.txt``: ``RMSE mf:<v>`` lines
  (reference/GPTrainers.py:150-170)
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

EST_HEADER = "t,x,y,z,xh,yh,zh,sigx,sigy,sigz,xe,ye,ze"
FIELD_HEADER = "t,x,y,z,fieldVal"
GPDATA_HEADER = "t,x,y,z,xh,yh,zh,fieldVal,fidLev"
GPRES_HEADER = " x,y,z,trueField,sfMean,sfVar,mfMean,mfVar"


def _load_csv(path):
    with open(path) as f:
        headers = f.readline().strip().lstrip("#").split(",")
    headers = [h.strip() for h in headers]
    from mfgp_tpu_torch import native

    # native single-pass strtod parser when built, numpy otherwise
    data = native.load_csv(path, skiprows=1)
    return headers, data


class Table(NamedTuple):
    headers: list
    data: np.ndarray

    def col(self, name) -> np.ndarray:
        return self.data[:, self.headers.index(name)]

    def cols(self, *names) -> np.ndarray:
        idx = [self.headers.index(n) for n in names]
        return self.data[:, idx]

    def save(self, path):
        with open(path, "w") as f:
            f.write(",".join(self.headers) + "\n")
            np.savetxt(f, self.data, delimiter=",")


def load_table(path) -> Table:
    h, d = _load_csv(path)
    return Table(h, d)


class GPDataset(NamedTuple):
    """A fidelity-binned training set (one ``GPData_*.csv``)."""

    t: np.ndarray
    X_true: np.ndarray  # (N, 3) true positions
    X_est: np.ndarray  # (N, 3) KF-estimated positions
    y: np.ndarray  # (N,) field values
    fid_lev: np.ndarray  # (N,) in {1, 2, 3}; 1 = best localization

    def fidelity_lists(self, use_estimates: bool = True):
        """emukit-ordered [lowest..highest] fidelity lists: the reference
        passes [Xf3, Xf2, Xf1] (reference/GPTrainers.py:60), i.e. fidLev 3
        (worst localization) is emukit fidelity 0."""
        X = self.X_est if use_estimates else self.X_true
        Xs, ys = [], []
        for lev in (3, 2, 1):
            m = self.fid_lev == lev
            Xs.append(X[m])
            ys.append(self.y[m])
        return Xs, ys

    @property
    def n(self):
        return self.y.shape[0]


def load_gp_dataset(path, t_cut: float = 3600.0) -> GPDataset:
    """Read a ``GPData_*.csv`` with the reference's time cutoff
    (reference/GPTrainers.py:37)."""
    tab = load_table(path)
    keep = tab.col("t") < t_cut
    d = Table(tab.headers, tab.data[keep])
    return GPDataset(
        t=d.col("t"),
        X_true=d.cols("x", "y", "z"),
        X_est=d.cols("xh", "yh", "zh"),
        y=d.col("fieldVal"),
        fid_lev=d.col("fidLev").astype(int),
    )


def save_hyp_vector(path, vec, row: bool = False):
    """``*_emuGP.txt`` stores one comma-separated row; the sfGP variants
    store one value per line (reference/GPTrainers.py:70-88)."""
    v = np.asarray(vec, np.float64).reshape(1, -1) if row else \
        np.asarray(vec, np.float64).reshape(-1)
    np.savetxt(path, v, delimiter=",")


def load_hyp_vector(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",").reshape(-1)


def save_gpres(path, test_points, f_true, sf_mean, sf_var, mf_mean, mf_var):
    """``GPRes_*.csv`` posterior-grid artifact (reference/GPTrainers.py:146)."""
    cols = [np.asarray(c, np.float64).reshape(-1, 1) if np.ndim(c) < 2
            else np.asarray(c, np.float64)
            for c in (f_true, sf_mean, sf_var, mf_mean, mf_var)]
    out = np.concatenate([np.asarray(test_points, np.float64)] + cols, axis=1)
    np.savetxt(path, out, delimiter=",", header=GPRES_HEADER, comments="")


def save_mse(path, metrics: dict):
    """``MSE_*.txt``: ``<name>:<value>`` lines in the reference's key order
    (reference/GPTrainers.py:150-170 — RMSEs first, then WRMSEs; WRMSE
    values are rendered as 1x1 brackets by the reference, which its parser
    strips — we write plain floats, which the same parser also accepts)."""
    order = ["RMSE mf", "RMSE sf", "RMSE nisf", "RMSE sfTP",
             "WRMSE mf", "WRMSE sf", "WRMSE nisf", "WRMSE sfTP"]
    with open(path, "w") as f:
        for k in order:
            if k in metrics:
                f.write(f"{k}:{metrics[k]}\n")
        for k, v in metrics.items():
            if k not in order:
                f.write(f"{k}:{v}\n")


def parse_mse(path) -> dict:
    """Read an ``MSE_*.txt`` (ours or the reference's; bracket-tolerant —
    same grammar as reference/Data/.../resultParser.py:12-35)."""
    out = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        line = line.strip()
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        v = v.replace("[", "").replace("]", "").strip()
        try:
            out[k.strip()] = float(v)
        except ValueError:
            continue
    return out


def parse_mse_filename(fname) -> dict:
    """``MSE_<rate>_fieldMeas_<field>_T<traj>_<vmn>.txt`` -> run parameters
    (reference/Data/.../resultParser.py:37-57)."""
    import re

    m = re.match(r"MSE_([0-9.]+)_fieldMeas_([0-9]+)_T([0-9]+)_([0-9.]+)\.txt",
                 os.path.basename(fname))
    if not m:
        return {}
    return {"fieldNum": int(m.group(2)), "T": int(m.group(3)),
            "velVariance": float(m.group(4))}
