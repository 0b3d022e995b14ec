"""Result aggregation (SURVEY C20, reference resultParser.py/averageErrors.py;
counterpart of ``mfgp_tpu/data/aggregate.py``, numpy/csv only).

Parses ``MSE_*.txt`` summaries (ours or the reference's) into a
``results.csv`` with the reference's exact header, then computes the mean
metric slices (overall, by velocity-noise level, by field seed) that the
reference prints in ``averageErrors.py``.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from mfgp_tpu_torch.data.io import parse_mse, parse_mse_filename

METRICS = ["RMSE mf", "RMSE nisf", "RMSE sf", "RMSE sfTP",
           "WRMSE mf", "WRMSE nisf", "WRMSE sf", "WRMSE sfTP"]


def collect_results(input_pattern: str, output_csv: str | None = None):
    """``MSE_*`` files -> list of row dicts (+ optional results.csv with the
    reference's sorted-header format, reference/Data/.../resultParser.py:59-87).
    """
    rows = []
    for path in sorted(glob.glob(input_pattern)):
        row = {"filename": os.path.basename(path)}
        row.update(parse_mse(path))
        row.update(parse_mse_filename(path))
        rows.append(row)
    if output_csv and rows:
        headers = set()
        for r in rows:
            headers.update(r)
        headers = ["filename"] + sorted(h for h in headers if h != "filename")
        with open(output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=headers)
            w.writeheader()
            w.writerows(rows)
    return rows


def mean_metrics(rows, where: dict | None = None) -> dict:
    """Mean of each metric over rows matching ``where``
    (reference/averageErrors.py slices by velVariance and fieldNum)."""
    sel = [r for r in rows
           if all(r.get(k) == v for k, v in (where or {}).items())]
    out = {"n": len(sel)}
    for m in METRICS:
        vals = [r[m] for r in sel if m in r]
        out[m] = float(np.mean(vals)) if vals else float("nan")
    return out


def summary(rows) -> dict:
    """The full averageErrors report: overall + per-noise + per-field means."""
    rep = {"overall": mean_metrics(rows)}
    for vmn in sorted({r.get("velVariance") for r in rows} - {None}):
        rep[f"velVariance={vmn}"] = mean_metrics(
            rows, {"velVariance": vmn})
    for fld in sorted({r.get("fieldNum") for r in rows} - {None}):
        rep[f"fieldNum={fld}"] = mean_metrics(rows, {"fieldNum": fld})
    return rep
