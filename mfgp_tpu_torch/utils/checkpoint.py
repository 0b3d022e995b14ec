"""Checkpoint / resume (SURVEY §5; counterpart of
``mfgp_tpu/utils/checkpoint.py``).

The reference checkpoints informally: hyperparameter vectors appended to
CSVs per replan (reference/PhysicalExperimentCode/
GraceExplorationExperiments_MFEGP.py:412-417), GPy model pickles, and
planner graph dumps ``graphNodes{n}.txt``/``graphEdges{n}.txt``
(reference/GraceRIGV3.py:877-906) with an unimplemented resume stub
(``cplan``, reference/GraceRIGV3.py:1364-1365).

Here one ``ExplorationCheckpoint`` carries a closed-loop run's state (model
hyperparameters and data, the host RNG state, the Kalman filter's torch
generator state, the budget, the planner graph) in the JAX package's npz
layout, so each package reads the other's files. A file the JAX package
wrote holds a ``jax.random`` key instead of a torch generator state: it
loads (model, rows, budget, RNG state), but a run cannot resume from it.
The JAX package's orbax backend is not ported: ``orbax.checkpoint``
imports ``jax``, which this package never does.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from mfgp_tpu_torch.utils.device import CUDA

# the npz key of the Kalman filter's generator state (the JAX package
# stores its key under "jax_key_data")
KF_GENERATOR_KEY = "torch_kf_generator_state"


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class ModelCheckpoint:
    """Everything needed to resurrect a GP/MFGP/NIGP at fixed hyps —
    mirrors what the reference's plot scripts rebuild models from
    (reference/MFplottingData.py:17,58-60: hyp CSV + data pointer)."""

    kind: str  # "gp" | "mfgp" | "nigp"
    kernel: str
    param_array: np.ndarray
    X: np.ndarray
    y: np.ndarray
    fid: Optional[np.ndarray] = None  # mfgp only
    extra: dict = field(default_factory=dict)

    def restore(self, jitter: float = 1e-6, device=CUDA, dtype=None):
        """The model as a port model on ``device`` (the card unless asked
        otherwise), its data in ``dtype`` (default: as saved)."""
        X = self.X if dtype is None else np.asarray(self.X, dtype)
        y = self.y if dtype is None else np.asarray(self.y, dtype)
        if self.kind == "gp":
            from mfgp_tpu_torch.models.gp import GP

            m = GP(X, y, kernel=self.kernel, jitter=jitter, device=device)
            m.set_param_array(self.param_array)
            return m
        if self.kind == "mfgp":
            from mfgp_tpu_torch.models.mfgp import MFGP

            m = MFGP(X, self.fid, y, kernel=self.kernel,
                     n_fidelities=int(self.extra.get("n_fidelities", 3)),
                     jitter=jitter, device=device)
            m.set_param_array(self.param_array)
            return m
        if self.kind == "nigp":
            from mfgp_tpu_torch.models.nigp import NIGP

            m = NIGP(device=device)
            D = X.shape[1]
            v = np.asarray(self.param_array)
            # artifact layout [sigma_x (D), sigma_f, sigma_y, ls (D)]
            # (reference/NIGP.py:188-189)
            m.sigma_x_ = v[:D]
            m.sigma_f_ = float(v[D])
            m.sigma_y_ = float(v[D + 1])
            m.lengthscales_ = v[D + 2:]
            m._set_data(X, y)
            m.noise_diag_train_ = None
            return m
        raise ValueError(f"unknown model kind {self.kind!r}")


def capture_model(model) -> ModelCheckpoint:
    from mfgp_tpu_torch.models.gp import GP
    from mfgp_tpu_torch.models.mfgp import MFGP
    from mfgp_tpu_torch.models.nigp import NIGP

    if isinstance(model, MFGP):
        return ModelCheckpoint("mfgp", model.kernel, model.param_array,
                               _np(model.X), _np(model.y), fid=_np(model.fid),
                               extra={"n_fidelities": model.n_fidelities})
    if isinstance(model, GP):
        return ModelCheckpoint("gp", model.kernel, model.param_array,
                               _np(model.X), _np(model.y))
    if isinstance(model, NIGP):
        return ModelCheckpoint("nigp", "rbf", model.get_params(),
                               _np(model.X_train_), _np(model.y_train_))
    raise TypeError(type(model))


@dataclass
class ExplorationCheckpoint:
    """Full closed-loop-run state (the reference never had this; resume was
    a stub). ``kf_generator_state`` is the Kalman filter's CPU
    ``torch.Generator`` state (None in a file the JAX package wrote); the
    planner graph is the JSON-able node/edge dict pair from RIGPlanner."""

    plan_num: int
    t_now: float
    planned_budget: float
    x0: np.ndarray
    model: ModelCheckpoint
    data_rows: np.ndarray  # accumulated GPData-schema rows
    rng_state: dict  # np.random.Generator bit generator state
    kf_generator_state: Optional[np.ndarray] = None  # uint8 bytes
    graph_nodes: dict = field(default_factory=dict)
    graph_edges: dict = field(default_factory=dict)


def _to_npz_dict(ck: ExplorationCheckpoint) -> dict:
    flat = {
        "plan_num": np.asarray(ck.plan_num),
        "t_now": np.asarray(ck.t_now),
        "planned_budget": np.asarray(ck.planned_budget),
        "x0": np.asarray(ck.x0),
        "data_rows": np.asarray(ck.data_rows),
        "model_kind": np.asarray(ck.model.kind),
        "model_kernel": np.asarray(ck.model.kernel),
        "model_params": np.asarray(ck.model.param_array),
        "model_X": np.asarray(ck.model.X),
        "model_y": np.asarray(ck.model.y),
        "meta_json": np.asarray(json.dumps({
            "rng_state": _jsonify(ck.rng_state),
            "graph_nodes": ck.graph_nodes,
            "graph_edges": ck.graph_edges,
            "model_extra": ck.model.extra,
        })),
    }
    if ck.kf_generator_state is not None:
        flat[KF_GENERATOR_KEY] = np.asarray(ck.kf_generator_state, np.uint8)
    if ck.model.fid is not None:
        flat["model_fid"] = np.asarray(ck.model.fid)
    return flat


def _jsonify(o):
    if isinstance(o, dict):
        return {k: _jsonify(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonify(v) for v in o]
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    return o


def _no_orbax():
    return NotImplementedError(
        "the orbax backend is not ported: orbax.checkpoint imports jax, "
        "which mfgp_tpu_torch never does; use backend='npz'")


def save_checkpoint(path: str, ck: ExplorationCheckpoint,
                    backend: str = "npz"):
    """Write a checkpoint as a single-file .npz (atomic rename), the JAX
    package's npz layout. ``backend="orbax"`` raises
    ``NotImplementedError`` (see the module docstring)."""
    if backend == "orbax":
        raise _no_orbax()
    if backend != "npz":
        raise ValueError(backend)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_to_npz_dict(ck))
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def load_checkpoint(path: str) -> ExplorationCheckpoint:
    """Load an npz checkpoint (this package's or the JAX package's). Where
    only the JAX package's orbax directory exists, raises
    ``NotImplementedError``."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    orbax_dir = path if path.endswith(".orbax") else path + ".orbax"
    if not os.path.exists(npz_path) and os.path.isdir(orbax_dir):
        raise _no_orbax()
    z = np.load(npz_path, allow_pickle=False)
    meta = json.loads(str(z["meta_json"]))
    model = ModelCheckpoint(
        kind=str(z["model_kind"]), kernel=str(z["model_kernel"]),
        param_array=np.asarray(z["model_params"]), X=np.asarray(z["model_X"]),
        y=np.asarray(z["model_y"]),
        fid=np.asarray(z["model_fid"]) if "model_fid" in z else None,
        extra=meta.get("model_extra", {}),
    )
    return ExplorationCheckpoint(
        plan_num=int(z["plan_num"]), t_now=float(z["t_now"]),
        planned_budget=float(z["planned_budget"]), x0=np.asarray(z["x0"]),
        model=model, data_rows=np.asarray(z["data_rows"]),
        rng_state=meta["rng_state"],
        kf_generator_state=(np.asarray(z[KF_GENERATOR_KEY])
                            if KF_GENERATOR_KEY in z else None),
        graph_nodes=meta.get("graph_nodes", {}),
        graph_edges=meta.get("graph_edges", {}),
    )


def save_hyp_history(path: str, param_array, plan_num: int):
    """Append a hyp row per replan — the reference's ``emuGP.csv`` pattern
    (reference/PhysicalExperimentCode/
    GraceExplorationExperiments_MFEGP.py:412-417)."""
    row = np.concatenate([[float(plan_num)], np.asarray(param_array,
                                                        np.float64)])
    with open(path, "a") as f:
        np.savetxt(f, row.reshape(1, -1), delimiter=",")
