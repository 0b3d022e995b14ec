"""Model serving: posterior queries over HTTP, stdlib only (counterpart of
``mfgp_tpu/serve.py``).

The production surface of a trained field model: load a checkpoint
(utils/checkpoint.py), keep the conditioned state resident on the card,
and answer batched posterior queries. Endpoints:

  GET  /health            -> {"status": "ok", "model": <kind>, "n": N}
  GET  /models            -> {"models": [name, ...]}   (router only)
  POST /predict           body {"points": [[x,y,z], ...],
                                "full_cov": false, "include_noise": true}
                          -> {"mean": [...], "var": [...]}
  POST /eid               body {"points": [...], "alpha": 1/11}
                          -> {"eid": [...]}  (Expected Information Density)
  POST /extend            body {"points": [...], "y": [...], "fid": [...]}
                          -> {"n": N}  (online conditioning)
  POST /refit             body {"restarts": 8, "maxiter": 200, "seed": 0}
                          -> {"nlml": f, "n": N, "prior_sig": s}
  POST /models/<name>/predict|eid|...   routed to the named model

Concurrent requests are coalesced by a batching queue: requests arriving
within the batching window are concatenated into ONE predict call and the
results split back per caller, so the card sees large batches instead of
one launch sequence per HTTP connection. The call runs in row blocks of
one shape (``PREDICT_BLOCK``), so each request gets the answer it would
get alone. (The JAX package pads each batch to a power of two for XLA's
compile cache; eager PyTorch compiles nothing, so the port does not.)

Every service in a process launches on the card under one lock,
``DEVICE_LOCK``: the planner and the mission runtime capture CUDA graphs,
and a capture is invalidated by a CUDA call that another thread makes
while it runs (``torch.cuda.graph``'s default "global" error mode). So the
batcher's predicts, the planner's plans, the mutation routes and the
mission worker's runs take turns on the card; host work (JSON, queueing,
extraction from host copies) runs outside it.
"""

from __future__ import annotations

import inspect
import itertools
import json
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mfgp_tpu_torch.utils import profiling
from mfgp_tpu_torch.utils.device import CUDA, resolve

# one per process, as the card is: see the module docstring
DEVICE_LOCK = threading.RLock()
# rows per predict block: GP/MFGP predictions run in blocks of this many
# rows, the last padded (models.mfgp._blocked), so a row's answer does not
# depend on the requests coalesced with it; in float32 at N=20,000 a
# different blocking moves a variance by up to 5e-3 of the largest
PREDICT_BLOCK = 1024


def _host(a) -> np.ndarray:
    """A tensor (or array) as a flat float64 numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64).reshape(-1)


def _jsonable(o):
    """``json.dumps``'s fallback: a numpy array as nested lists."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


class _Pending:
    __slots__ = ("pts", "include_noise", "event", "mu", "var", "err",
                 "t_submit")

    def __init__(self, pts, include_noise):
        self.pts = pts
        self.include_noise = include_noise
        self.event = threading.Event()
        self.mu = self.var = self.err = None
        # the queue wait's start, read only while the recorder is on
        self.t_submit = time.perf_counter() if profiling.active() else None


class BatchingQueue:
    """Coalesces concurrent predict calls into single predict calls.

    ``submit`` blocks the calling (HTTP handler) thread until its slice of
    a batched call returns. The dispatcher thread drains the queue after
    a short batching window (``max_wait`` seconds), concatenates all
    same-flag requests up to ``max_batch`` rows, runs ONE ``predict_fn``
    call, and distributes the row slices back.

    Observability: ``launches`` counts predict calls, ``batched_requests``
    counts requests served, ``max_requests_per_launch`` the best coalesce.
    While the recorder is on (``utils/profiling``), each request's wait
    from ``submit`` to the start of the call that serves it (the batching
    window and the launches ahead of it) is the observation
    ``serve.queue_wait``, and each call, with its wait for the device
    lock and its host copy, the span ``serve.launch``.
    """

    def __init__(self, predict_fn, max_batch: int = 4096,
                 max_wait: float = 0.005):
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._stop = False
        self.launches = 0
        self.batched_requests = 0
        self.max_requests_per_launch = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, pts: np.ndarray, include_noise: bool = True):
        p = _Pending(np.atleast_2d(np.asarray(pts, np.float64)),
                     bool(include_noise))
        with self._cv:
            if self._stop:
                raise RuntimeError("queue closed")
            self._queue.append(p)
            self._cv.notify()
        p.event.wait()
        if p.err is not None:
            raise p.err
        return p.mu, p.var

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    # -- dispatcher ----------------------------------------------------------
    def _take_batch(self) -> list[_Pending]:
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(timeout=0.1)
            if self._stop and not self._queue:
                return []
        # batching window: let concurrent callers join the launch
        time.sleep(self.max_wait)
        with self._cv:
            if not self._queue:
                return []
            flag = self._queue[0].include_noise
            batch, rows, rest = [], 0, []
            for p in self._queue:
                # the head request is always taken, even when larger than
                # max_batch (an oversized request runs as its own launch;
                # otherwise it would starve forever)
                if not batch or (p.include_noise == flag
                                 and rows + p.pts.shape[0]
                                 <= self.max_batch):
                    batch.append(p)
                    rows += p.pts.shape[0]
                else:
                    rest.append(p)
            self._queue = rest
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop:
                    return
                continue
            try:
                pts = np.concatenate([p.pts for p in batch], axis=0)
                t = time.perf_counter()
                for p in batch:
                    if p.t_submit is not None:
                        profiling.observe("serve.queue_wait",
                                          t - p.t_submit)
                with profiling.span("serve.launch"):
                    mu, var = self.predict_fn(
                        pts, include_noise=batch[0].include_noise)
                self.launches += 1
                self.batched_requests += len(batch)
                self.max_requests_per_launch = max(
                    self.max_requests_per_launch, len(batch))
                off = 0
                for p in batch:
                    n = p.pts.shape[0]
                    p.mu = mu[off:off + n]
                    p.var = var[off:off + n]
                    off += n
            except Exception as e:  # noqa: BLE001 (delivered to callers)
                for p in batch:
                    p.err = e
            for p in batch:
                p.event.set()


class _PendingPlan:
    __slots__ = ("x0", "B", "seed", "alpha", "event", "res", "err")

    def __init__(self, x0, B, seed, alpha):
        self.x0, self.B, self.seed, self.alpha = x0, B, seed, alpha
        self.event = threading.Event()
        self.res = self.err = None


class PlanBatchingQueue:
    """Coalesces concurrent /plan requests into single planner runs.

    The planner analogue of :class:`BatchingQueue`: requests arriving
    within the batching window become independent (start, budget, seed)
    lanes of ONE ``DeviceRIG.plan_batch`` loop, so a fleet of robots
    replanning against the same served model costs one device loop
    instead of one per HTTP connection. Requests are grouped by ``alpha``
    (they must share the EID).
    """

    def __init__(self, launch_fn, max_batch: int = 8,
                 max_wait: float = 0.01):
        self.launch_fn = launch_fn  # list[_PendingPlan] -> list[result]
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._queue: list[_PendingPlan] = []
        self._cv = threading.Condition()
        self._stop = False
        self.launches = 0
        self.batched_requests = 0
        self.max_requests_per_launch = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, x0, B, seed, alpha):
        p = _PendingPlan(np.asarray(x0, float).reshape(-1), float(B),
                         int(seed), float(alpha))
        with self._cv:
            if self._stop:
                raise RuntimeError("queue closed")
            self._queue.append(p)
            self._cv.notify()
        p.event.wait()
        if p.err is not None:
            raise p.err
        return p.res

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _take_batch(self) -> list[_PendingPlan]:
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(timeout=0.1)
            if self._stop and not self._queue:
                return []
        time.sleep(self.max_wait)  # batching window
        with self._cv:
            if not self._queue:
                return []
            alpha = self._queue[0].alpha
            batch, rest = [], []
            for p in self._queue:
                if p.alpha == alpha and len(batch) < self.max_batch:
                    batch.append(p)
                else:
                    rest.append(p)
            self._queue = rest
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop:
                    return
                continue
            try:
                results = self.launch_fn(batch)
                self.launches += 1
                self.batched_requests += len(batch)
                self.max_requests_per_launch = max(
                    self.max_requests_per_launch, len(batch))
                for p, r in zip(batch, results):
                    p.res = r
            except Exception as e:  # noqa: BLE001 (delivered to callers)
                for p in batch:
                    p.err = e
            for p in batch:
                p.event.set()


class ModelServer:
    """Wraps a restored model for query serving.

    Query routes (/predict, /eid) are read-only; the live-update routes
    (/extend: bordered-Cholesky online conditioning; /refit:
    restart-batched refit) mutate the served model under the device lock
    the predictions take, so a robot in the field can push measurements
    and retrain between replans: the reference's per-replan `set_data` +
    `optimize` loop
    (reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:385-397)
    served over HTTP. ``handle`` returns the posterior's arrays ("mean",
    "var", "cov", "eid") as float64 numpy arrays; the HTTP server writes
    them as JSON lists."""

    def __init__(self, model, prior_sig: float | None = None,
                 batch_wait: float = 0.005):
        self.model = model
        self.n_train = self._rows(model)
        self._prior_sig_inferred = prior_sig is None
        self.prior_sig = (self._infer_prior_sig(model)
                          if prior_sig is None else prior_sig)
        takes = inspect.signature(model.predict).parameters
        self._takes_noise_kwarg = "include_noise" in takes
        # GP/MFGP: every predict in blocks of one shape (see PREDICT_BLOCK)
        self._block = ({"block_size": PREDICT_BLOCK} if "block_size" in takes
                       else {})
        self.batcher = BatchingQueue(self._predict_device,
                                     max_wait=batch_wait)
        _ = self._predict_device(np.zeros((1, self._dim())))  # warm

    @classmethod
    def from_checkpoint(cls, path: str, device=CUDA, dtype=None, **kw):
        """Serve the model of a checkpoint (this package's or the JAX
        package's npz) on ``device``. ``dtype`` (a numpy dtype) is the
        data's: by default float32 on the card, where the CUDA kernels
        take float32 (the JAX package's own default on the TPU, where
        x64 is off), and as saved on the CPU."""
        from mfgp_tpu_torch.utils.checkpoint import load_checkpoint

        device = resolve(device)
        if dtype is None and device.type == "cuda":
            dtype = np.float32
        ck = load_checkpoint(path)
        return cls(ck.model.restore(device=device, dtype=dtype), **kw)

    @staticmethod
    def _rows(model) -> int:
        X = getattr(model, "X", None)
        return int((model.X_train_ if X is None else X).shape[0])

    @staticmethod
    def _infer_prior_sig(model):
        """Prior variance (kernel + noise) from the model's parameters:
        the EID's normalizer (reference/exploreExpSettings.py:20-24)."""
        if hasattr(model, "param_array"):
            pa = np.asarray(model.param_array)
            return float(pa[0] + pa[-1])
        # NIGP layout [sigma_x (D), sigma_f, sigma_y, ls (D)]
        pa = np.asarray(model.get_params())
        D = int(model.X_train_.shape[1])
        return float(pa[D] ** 2 + pa[D + 1] ** 2)

    def _dim(self):
        X = getattr(self.model, "X", None)
        return int((self.model.X_train_ if X is None else X).shape[1])

    def _predict_device(self, pts, include_noise: bool = True):
        """One predict call (from the batcher thread): marginal means and
        variances as float64 numpy arrays."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        with DEVICE_LOCK:
            if self._takes_noise_kwarg:
                mu, var = self.model.predict(pts, include_noise=include_noise,
                                             **self._block)
            else:  # NIGP: no likelihood-noise switch in its predict
                mu, var = self.model.predict(pts)
            return _host(mu), _host(var)

    def _predict(self, pts, include_noise: bool = True):
        return self.batcher.submit(pts, include_noise=include_noise)

    def handle(self, route: str, payload: dict) -> dict:
        if route == "/health":
            return {"status": "ok",
                    "model": type(self.model).__name__, "n": self.n_train,
                    "launches": self.batcher.launches,
                    "batched_requests": self.batcher.batched_requests,
                    "max_requests_per_launch":
                        self.batcher.max_requests_per_launch}
        if route == "/refit":
            if not hasattr(self.model, "optimize_restarts"):
                raise ValueError(
                    f"{type(self.model).__name__} has no restart-batched "
                    "refit (optimize_restarts)")
            with DEVICE_LOCK:
                nlml = self.model.optimize_restarts(
                    n_restarts=int(payload.get("restarts", 8)),
                    maxiter=int(payload.get("maxiter", 200)),
                    seed=int(payload.get("seed", 0)))
                if self._prior_sig_inferred:
                    self.prior_sig = self._infer_prior_sig(self.model)
            return {"nlml": float(nlml), "n": self.n_train,
                    "prior_sig": self.prior_sig}
        pts = np.asarray(payload.get("points", []), np.float64)
        if pts.size == 0:
            raise ValueError("no points")
        if route == "/extend":
            if not hasattr(self.model, "extend_data"):
                raise ValueError(
                    f"{type(self.model).__name__} has no online "
                    "conditioning (extend_data)")
            pts = np.atleast_2d(pts)
            if pts.shape[1] != self._dim():
                raise ValueError(
                    f"points must be (n, {self._dim()})")
            y_new = np.asarray(payload.get("y", []), np.float64).reshape(-1)
            if y_new.size != pts.shape[0]:
                raise ValueError("y must align with points")
            if hasattr(self.model, "fid"):  # multi-fidelity
                fid = payload.get("fid")
                if fid is None:
                    raise ValueError(
                        "multi-fidelity model needs per-point fid")
                fid = np.asarray(fid, int).reshape(-1)
                if fid.size != pts.shape[0]:
                    raise ValueError("fid must align with points")
                with DEVICE_LOCK:
                    self.model.extend_data(pts, fid, y_new)
                    self.n_train = self._rows(self.model)
            else:
                with DEVICE_LOCK:
                    self.model.extend_data(pts, y_new)
                    self.n_train = self._rows(self.model)
            return {"n": self.n_train}
        if route == "/predict":
            if payload.get("full_cov", False):
                # full covariance bypasses the batching queue (row-slice
                # splitting does not compose across requests)
                with DEVICE_LOCK:
                    if self._takes_noise_kwarg:
                        mu, cov = self.model.predict(
                            np.atleast_2d(pts), full_cov=True,
                            include_noise=payload.get("include_noise",
                                                      True))
                    else:  # NIGP spells it return_cov
                        mu, cov = self.model.predict(np.atleast_2d(pts),
                                                     return_cov=True)
                    n = cov.shape[0]
                    cov = _host(cov).reshape(n, n)
                    mu = _host(mu)
                return {"mean": mu, "cov": cov}
            mu, var = self._predict(
                pts, include_noise=payload.get("include_noise", True))
            return {"mean": mu, "var": var}
        if route == "/eid":
            from mfgp_tpu_torch.metrics.eid import expected_information_density

            mu, var = self._predict(pts)
            eid = expected_information_density(
                mu, var, self.prior_sig,
                alpha=payload.get("alpha", 1.0 / 11))
            return {"eid": _host(eid)}
        raise KeyError(route)

    def close(self):
        self.batcher.close()


class PlannerService:
    """Replan-as-a-service around a ModelServer.

    The reference robot replans on-board inside a 45 s wall-clock budget
    (reference/PhysicalExperimentCode/exploreExpSettings.py:214-218); this
    service answers the same decision over HTTP from the device planner
    (planning/rig_device), so a fleet of robots can offload replanning to
    one GPU host:

      POST /plan   body {"start": [x, y], "budget": B, "seed": 0,
                         "alpha": 1/11}
                   -> {"path": [[x, y, z, t], ...], "budget": b,
                       "info": i, "n_nodes": n, "n_edges": e,
                       "plan_seconds": s}

    The ensemble width is fixed at construction (``n_plans``), not per
    request. A request's ``start`` may carry extra components (e.g. a 3D
    robot's z); the planner samples in 2D and only [x, y] are used.

    Concurrent /plan requests coalesce: a fleet of robots replanning
    within the batching window becomes independent (start, budget, seed)
    lanes of ONE planner loop (``PlanBatchingQueue`` ->
    ``DeviceRIG.plan_batch``, lanes padded to a power of two). The planner
    captures one iteration per lane width as a CUDA graph and replays it
    for every later plan of that width.

    ``cost`` fixes the scoring family at construction: "ergodic" (default)
    / "fourier" score against the EID computed from the wrapped model over
    the workspace grid; "sf_gain" / "mf_gain" condition the sequential
    information gain on the model's training set; "sf_logdet" /
    "mf_logdet" use the coarse IG grid (reference's separate 10x6x5 grid,
    exploreExpSettings.py:158-173). Every other route passes through to
    the wrapped ModelServer; the mutation routes (/extend, /refit)
    additionally invalidate the cached EID / gain state, so the full
    reference field loop (measure, retrain, replan;
    GraceExplorationExperiments_MFEGP.py:358-483) runs over HTTP against
    one warm planner.
    """

    _GAIN_COSTS = ("sf_gain", "mf_gain", "sf_logdet", "mf_logdet")

    def __init__(self, model_server: ModelServer, cost: str = "ergodic",
                 plan_iters: int = 100, exp=None, n_plans: int = 1,
                 warm: bool = False):
        from mfgp_tpu_torch.metrics.eid import eid_grid
        from mfgp_tpu_torch.planning.rig_device import DeviceRIGAdapter
        from mfgp_tpu_torch.utils.configs import ExperimentConfig

        self.model_server = model_server
        self.exp = exp or ExperimentConfig()
        cfg = self.exp.sim
        ws = np.asarray(cfg.WS, float)
        bounds = [list(b) for b in cfg.WS]
        self.grid = np.asarray(eid_grid(bounds, cfg.max_depth))
        self.cost = cost
        model = model_server.model
        if cost in self._GAIN_COSTS:
            needs_mf = cost.startswith("mf")
            has_state = (hasattr(model, "state") and hasattr(model, "params")
                         and hasattr(model, "X"))
            if not has_state:
                raise ValueError(
                    f"cost={cost!r} needs a conditioned GP/MFGP model, "
                    f"got {type(model).__name__}")
            is_mf = hasattr(model, "fid")
            if needs_mf != is_mf:
                raise ValueError(
                    f"cost={cost!r} does not match model "
                    f"{type(model).__name__}")
        plan_grid = (np.asarray(eid_grid(bounds, cfg.max_depth,
                                         nums=(10, 6, 5)))
                     if cost.endswith("_logdet") else self.grid)
        X = getattr(model, "X", None)
        device = (model.X_train_ if X is None else X).device
        self.agent_cfg = cfg.agent()
        self._adapter = DeviceRIGAdapter(
            n_plans=n_plans,
            cfg=self.agent_cfg, delta=cfg.step_size, B=self.exp.B,
            WS=ws, R=cfg.near_rad, Rd=cfg.Rd,
            same_node_distance=cfg.same_node_distance,
            budget_cutoff=0.9, max_iter=plan_iters, grid=plan_grid,
            kernel=getattr(model, "kernel", "rbf"), cost=cost,
            device=device)
        self._gain_nmax = None
        # the EID (per alpha) and the padded gain state are computed once
        # and reused across requests until /extend or /refit changes the
        # model, instead of re-running the grid predict / the O(nmax^2)
        # re-pad per /plan
        self._eid_cache: dict = {}
        self._gain_cache = None
        # fleet coalescing: concurrent single-plan requests become lanes
        # of ONE plan_batch loop (ensemble services keep the direct path;
        # they already batch internally)
        self.plan_queue = (PlanBatchingQueue(self._launch_plans)
                           if n_plans == 1 else None)
        if warm:
            # build and capture the planner's iteration at startup so the
            # first request replays it (start/budget/seed/EID are values
            # copied into the captured buffers)
            ws_lo = ws[:, 0]
            self.handle("/plan", {"start": ws_lo.tolist(),
                                  "budget": float(self.exp.B), "seed": 0})

    @property
    def planner(self):
        """The ``DeviceRIG`` behind the service (its ``stats`` describe the
        last plan)."""
        return self._adapter._planner

    def _eid(self, alpha):
        from mfgp_tpu_torch.metrics.eid import expected_information_density

        key = float(alpha)
        if key not in self._eid_cache:
            mu, var = self.model_server._predict_device(self.grid)
            self._eid_cache[key] = _host(expected_information_density(
                mu, var, self.model_server.prior_sig, alpha=alpha))
        return self._eid_cache[key]

    def _plan_args(self, alpha) -> dict:
        if self.cost in self._GAIN_COSTS:
            return {"eid": None, "gp": self._gain_state()}
        return {"eid": self._eid(alpha), "gp": None}

    def _launch_plans(self, batch):
        """PlanBatchingQueue launch: one lane per request."""
        with DEVICE_LOCK:
            return self._adapter.plan_batch(
                np.stack([p.x0 for p in batch]),
                [p.seed for p in batch],
                np.asarray([p.B for p in batch]),
                **self._plan_args(batch[0].alpha))

    def _gain_state(self):
        from mfgp_tpu_torch.planning.rig_device import (prepare_mf_gain_state,
                                                        prepare_sf_gain_state)

        if self._gain_cache is not None:
            return self._gain_cache
        model = self.model_server.model
        n = int(model.X.shape[0])
        # size the static train pad generously so the captured plan
        # survives model growth (same policy as sim/explore.py)
        if self._gain_nmax is None or n > self._gain_nmax:
            self._gain_nmax = 1 << max(9, (4 * max(n, 1) - 1).bit_length())
        with DEVICE_LOCK:
            if self.cost.startswith("mf"):
                self._gain_cache = prepare_mf_gain_state(
                    model, self.agent_cfg.fid_levels, self._gain_nmax)
            else:
                self._gain_cache = prepare_sf_gain_state(model,
                                                         self._gain_nmax)
        return self._gain_cache

    def handle(self, route: str, payload: dict) -> dict:
        if route != "/plan":
            out = self.model_server.handle(route, payload)
            if route in ("/extend", "/refit"):
                # the served model changed: the next /plan recomputes the
                # EID / re-pads the gain state from the updated posterior
                # (the captured planner iteration survives: the EID and
                # gain state are values copied into it as long as the gain
                # pad capacity holds, see _gain_state)
                self._eid_cache.clear()
                self._gain_cache = None
            return out
        start = np.asarray(payload.get("start", ()), np.float64).reshape(-1)
        if start.size < 2:
            raise ValueError("start must give at least [x, y]")
        start = start[:2]  # planner samples in 2D; ignore z and beyond
        B = float(payload.get("budget", self.exp.B))
        seed = int(payload.get("seed", 0))
        alpha = payload.get("alpha", 1.0 / 11)
        t0 = time.perf_counter()
        if self.plan_queue is not None:
            res = self.plan_queue.submit(start, B, seed, alpha)
            return {"path": np.asarray(res.points).tolist(),
                    "budget": float(res.budget),
                    "info": float(res.info),
                    "n_nodes": int(res.n_nodes),
                    "n_edges": int(res.n_feasible_edges),
                    "plan_seconds": round(time.perf_counter() - t0, 4)}
        # the lock covers plan + extraction: the adapter caches its last
        # result, which a concurrent /plan would overwrite
        with DEVICE_LOCK:
            best = self._adapter.plan(start, seed=seed, B=B,
                                      **self._plan_args(alpha))
            pts = self._adapter.best_path_points()
            summary = self._adapter.graph_summary()
        return {"path": np.asarray(pts).tolist() if pts is not None else [],
                "budget": float(best.budget),
                "info": float(best.info),
                "n_nodes": int(summary["nodes"]),
                "n_edges": int(summary["edges"]),
                "plan_seconds": round(time.perf_counter() - t0, 4)}

    def close(self):
        if self.plan_queue is not None:
            self.plan_queue.close()
        self.model_server.close()


class ModelRouter:
    """Routes requests across multiple named models.

    ``/models`` lists them; ``/models/<name>/<op>`` targets one; bare
    ``/predict``/``/eid``/``/health`` hit the default model (the first).
    """

    def __init__(self, servers: dict[str, ModelServer],
                 default: str | None = None):
        if not servers:
            raise ValueError("no models")
        self.servers = dict(servers)
        self.default = default or next(iter(self.servers))

    def handle(self, route: str, payload: dict) -> dict:
        if route == "/models":
            return {"models": sorted(self.servers),
                    "default": self.default}
        if route.startswith("/models/"):
            parts = route.split("/", 3)  # '', 'models', name, op
            if len(parts) != 4 or parts[2] not in self.servers:
                raise KeyError(route)
            return self.servers[parts[2]].handle("/" + parts[3], payload)
        return self.servers[self.default].handle(route, payload)

    def close(self):
        for s in self.servers.values():
            s.close()


class MissionService:
    """Mission submission against a long-lived process that keeps each
    mission configuration's built ``DeviceMission``.

    A mission's first run builds its state (fields, grids, the planner and
    the runtime) and captures the planner's iteration and the runtime's
    chunks as CUDA graphs. Every later submission of the same
    configuration (``_FIELDS``; any seed) reuses that mission with its
    ``seed`` set to the job's, so it replays the captured graphs and
    captures nothing: the command line's warm run
    (``cli mission``), kept across submissions. (The JAX package transplants
    its compiled executables between missions for the same purpose.)

      POST /mission  {"variant": "MFEGP", "seed": 0, "budget": 20.0,
                      "bd": 2, "plan_iters": 40, "e_max": 16, ...}
                     -> {"job": i, "state": "queued", "warm": bool}
      GET  /mission/<id>  -> {"state": queued|running|done|error, ...}
      GET  /missions      -> {"jobs": [...]}

    Jobs run on ONE worker thread, under the device lock: missions share
    the single card, so submissions serialize; the point is reuse of the
    built missions, not parallelism.
    """

    _FIELDS = ("variant", "budget", "bd", "update_hyps", "plan_iters",
               "e_max", "flight", "ergodic_metric", "info_cost",
               "fit_restarts", "glide_stride", "t_cap", "max_nodes",
               "samples_per_edge")

    def __init__(self, device=CUDA):
        self.device = resolve(device)
        self._jobs: list[dict] = []
        self._missions: dict[tuple, object] = {}  # config key -> mission
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run_worker,
                                        daemon=True)
        self._worker.start()

    @classmethod
    def _spec(cls, payload: dict) -> dict:
        variant = str(payload.get("variant", "MFEGP")).upper()
        if variant not in ("MFEGP", "MFGP", "SFEGP", "SFGP"):
            raise ValueError(f"unknown variant {variant}")
        return {
            "variant": variant,
            "budget": float(payload.get("budget", 20.0)),
            "bd": int(payload.get("bd", 2)),
            "update_hyps": bool(payload.get("update_hyps", False)),
            "plan_iters": int(payload.get("plan_iters", 40)),
            "e_max": int(payload.get("e_max", 16)),
            "flight": str(payload.get("flight", "kinematic")),
            "ergodic_metric": str(payload.get("ergodic_metric", "kl")),
            "info_cost": str(payload.get("info_cost", "sequential")),
            "fit_restarts": int(payload.get("fit_restarts", 1)),
            "glide_stride": int(payload.get("glide_stride", 1)),
            "t_cap": int(payload.get("t_cap", 8192)),
            "max_nodes": int(payload.get("max_nodes", 64)),
            "samples_per_edge": int(payload.get("samples_per_edge", 24)),
            "seed": int(payload.get("seed", 0)),
        }

    def _build(self, spec: dict):
        from mfgp_tpu_torch.sim.mission_device import DeviceMission
        from mfgp_tpu_torch.utils.configs import ExperimentConfig

        v = spec["variant"]
        exp = ExperimentConfig(
            multi_fidelity=v.startswith("MF"),
            ergodic=v in ("MFEGP", "SFEGP"),
            ergodic_metric=spec["ergodic_metric"],
            info_cost=spec["info_cost"],
            update_hyps=spec["update_hyps"],
            B=spec["budget"], BD=spec["bd"])
        return DeviceMission(
            exp, seed=spec["seed"], flight=spec["flight"],
            plan_iters=spec["plan_iters"], e_max=spec["e_max"],
            fit_restarts=spec["fit_restarts"],
            glide_stride=spec["glide_stride"], t_cap=spec["t_cap"],
            max_nodes=spec["max_nodes"],
            samples_per_edge=spec["samples_per_edge"], device=self.device)

    def _run_worker(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            key = tuple(job["spec"][f] for f in self._FIELDS)
            with self._lock:
                job["state"] = "running"
            t0 = time.perf_counter()
            try:
                with DEVICE_LOCK:
                    mission = self._missions.get(key)
                    warm = mission is not None
                    if not warm:
                        mission = self._build(job["spec"])
                    mission.seed = job["spec"]["seed"]
                    res = mission.run()
                    self._missions[key] = mission
                with self._lock:
                    job.update(
                        state="done", warm=warm,
                        seconds=round(time.perf_counter() - t0, 3),
                        result={
                            "rmse": float(res.rmse),
                            "replans": int(res.n_replans),
                            "budget_used": float(res.budget_used),
                            "n_data": int(res.gp_data.data.shape[0]),
                        })
            except Exception as e:  # noqa: BLE001 (reported to the client)
                traceback.print_exc()
                with self._lock:
                    job.update(state="error", error=repr(e),
                               seconds=round(time.perf_counter() - t0, 3))

    def handle(self, route: str, payload: dict) -> dict:
        if route == "/health":
            with self._lock:
                return {"status": "ok", "jobs": len(self._jobs),
                        "warm_configs": len(self._missions)}
        if route == "/mission":
            spec = self._spec(payload)
            key = tuple(spec[f] for f in self._FIELDS)
            with self._lock:
                job = {"id": len(self._jobs), "state": "queued",
                       "spec": spec, "warm": key in self._missions}
                self._jobs.append(job)
            self._queue.put(job)
            return {"job": job["id"], "state": job["state"],
                    "warm": job["warm"]}
        if route == "/missions":
            with self._lock:
                return {"jobs": [{k: v for k, v in j.items()
                                  if k != "spec"} for j in self._jobs]}
        if route.startswith("/mission/"):
            try:
                i = int(route.rsplit("/", 1)[1])
                with self._lock:
                    job = self._jobs[i]
            except (ValueError, IndexError):
                raise KeyError(route) from None
            with self._lock:
                return {k: v for k, v in job.items() if k != "spec"}
        raise KeyError(route)

    def close(self):
        self._queue.put(None)
        self._worker.join(timeout=5)


class _FleetServer(ThreadingHTTPServer):
    """A threading HTTP server whose listen backlog holds a fleet's
    clients connecting at once: with socketserver's default of 5 the
    kernel drops the connections beyond it, and their clients retry a
    second later, after any batching window."""

    request_queue_size = 128


def make_http_server(server, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around a ModelServer, a
    PlannerService, a ModelRouter or a MissionService;
    ``.server_address`` has the bound port when port=0.

    While the recorder is on (``utils/profiling``), a POST is the spans
    ``serve.decode`` (the body's read and ``json.loads``) and
    ``serve.encode`` (the reply's arrays to lists, ``json.dumps`` and the
    write), both carrying the request's id."""
    request_ids = itertools.count()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, obj):
            body = json.dumps(obj, default=_jsonable).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, payload) -> tuple:
            try:
                return 200, server.handle(self.path, payload)
            except KeyError as e:
                return 404, {"error": str(e)}
            except ValueError as e:
                return 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 (the server keeps serving)
                traceback.print_exc()
                return 500, {"error": str(e)}

        def do_GET(self):
            if self.path in ("/health", "/models", "/missions") or \
                    self.path.startswith(("/models/", "/mission/")):
                self._send(*self._reply({}))
            else:
                self._send(404, {"error": "unknown route"})

        def do_POST(self):
            rid = next(request_ids)
            try:
                with profiling.span("serve.decode", rid=rid):
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # bad length or JSON
                self._send(400, {"error": str(e)})
                return
            reply = self._reply(payload)
            with profiling.span("serve.encode", rid=rid):
                self._send(*reply)

    return _FleetServer((host, port), Handler)


def _serve(srv: ThreadingHTTPServer, service) -> None:
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        service.close()


def serve_checkpoint(path: str, host: str = "127.0.0.1", port: int = 8080,
                     plan_cost: str | None = None, plan_iters: int = 100,
                     device=CUDA):
    """Blocking entry point: load checkpoint, serve until interrupted.

    ``plan_cost`` additionally enables POST /plan (PlannerService) with
    that scoring family."""
    server = ModelServer.from_checkpoint(path, device=device)
    if plan_cost:
        server = PlannerService(server, cost=plan_cost,
                                plan_iters=plan_iters, warm=True)
    srv = make_http_server(server, host, port)
    print(f"serving on {srv.server_address}", flush=True)
    _serve(srv, server)


def serve_missions(host: str = "127.0.0.1", port: int = 8080, device=CUDA):
    """Blocking mission-submission entry point (MissionService): a
    long-lived process whose built missions are reused across
    submissions."""
    svc = MissionService(device=device)
    srv = make_http_server(svc, host, port)
    print(f"mission server on {srv.server_address}", flush=True)
    _serve(srv, svc)


def serve_checkpoints(paths: dict[str, str], host: str = "127.0.0.1",
                      port: int = 8080, device=CUDA):
    """Blocking multi-model entry point: {name: checkpoint path}."""
    router = ModelRouter({name: ModelServer.from_checkpoint(p, device=device)
                          for name, p in paths.items()})
    srv = make_http_server(router, host, port)
    print(f"serving {sorted(router.servers)} on {srv.server_address}",
          flush=True)
    _serve(srv, router)
