"""Closed-loop adaptive exploration simulator (counterpart of
``mfgp_tpu/sim/explore.py``).

The reference's physical drivers (reference/PhysicalExperimentCode/
GraceExplorationExperiments_{MFEGP,MFGP,SFEGP,SFGP}.py, SURVEY C25, call
stack §3.4) run: sense -> estimate (KF) -> control along the planned
primitive trajectory -> accumulate fidelity-binned field measurements ->
on path completion: retrain GP -> recompute EID -> replan with a budget
tranche. The *simulation* driver that produced the committed datasets is
not in the reference tree (SURVEY §3.5 note); this module is that missing
closed-loop simulator:

* trajectory following is kinematic: the planner's waypoint trajectories
  (already time-stamped at meas_rate) are the flown path — no 1 kHz
  actuator loop, no hardware sockets (deliberately not ported, SURVEY §7);
  ``flight="dynamic"`` flies them through ``hw.runtime`` instead
* localization uncertainty comes from the same 6-state constant-velocity
  KF as the offline pipeline (``estimation.kalman.filter_trajectory``)
* per replan: the model refit (scipy L-BFGS-B on the autodiff NLML) and
  the posterior-grid EID run on the sim's ``device`` in its ``dtype``; on
  the card in float32 every covariance goes through B1 (``ar1_cov.cu``)
* every replan emits the reference's artifact set (plannedTraj{n}.csv,
  EID{n}.csv, hyp rows) so existing comparison tooling works.

Variant matrix = ExperimentConfig(multi_fidelity, ergodic): MFEGP / MFGP /
SFEGP / SFGP, mirroring the reference's four scripts
(reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:670,
_MFGP.py:687-691, _SFEGP.py:628, _SFGP.py:631).

What differs from the JAX package:

* ``dtype``: the model's precision, float32 on the card and float64 on the
  CPU by default, which is what the JAX package computes on each platform
  (x64 is on for its CPU runs and off on the TPU).
* The filter's measurement noise is drawn from a CPU ``torch.Generator``
  seeded with ``seed`` (torch cannot reproduce ``jax.random``'s stream),
  or taken from ``kf_noise(plan_num, n)``, which returns the (n, 6)
  standard normal draws of a flight (a test passes the JAX package's own).
* The device planner (``planner_backend="device"``, the whole RIG loop on
  the device, ``planning.rig_device``) draws from a ``torch.Generator``
  seeded with ``seed + plan_num`` per replan, or takes
  ``plan_draws(seed, lanes)``, which returns the (lanes, plan_iters,
  width) draws of one replan (a test passes the JAX package's own, from
  ``jax.random.key(seed)``; an ensemble's lanes from its ``split``).
  ``plan_ensemble = K`` runs K planner instances as lanes of one loop;
  where a process group of more than one rank is initialised and K
  divides by its dp extent, the lanes shard over the ranks
  (``DeviceRIG.plan_ensemble(mesh=)``), as the JAX package shards them
  over its devices. Its plans equal the JAX
  package's only under that package's draws: ``python -m pytest
  tests/test_torch_rig_device*.py`` holds them on the CPU, ``python3
  chip_smoke.py --only device_planner`` drives it on the card.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mfgp_tpu_torch.data.io import GPDATA_HEADER, Table
from mfgp_tpu_torch.estimation.kalman import filter_trajectory
from mfgp_tpu_torch.fields.wrbf import WRBFField, default_sim_field
from mfgp_tpu_torch.metrics.eid import eid_grid, expected_information_density
from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.models.mfgp import MFGP
from mfgp_tpu_torch.planning import scoring
from mfgp_tpu_torch.planning.primitives import AgentConfig
from mfgp_tpu_torch.planning.rig import RIGPlanner
from mfgp_tpu_torch.utils.configs import ExperimentConfig, SimConfig
from mfgp_tpu_torch.utils.device import CUDA, resolve

# a fit that fails numerically keeps the last hyperparameters, as the
# reference's blow-up recovery keeps going; any other error (a kernel that
# does not build or launch) leaves the run
NUMERICAL_FAILURES = (ArithmeticError, np.linalg.LinAlgError,
                      torch.linalg.LinAlgError)
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclass
class ReplanRecord:
    plan_num: int
    t_start: float
    budget_tranche: float
    best_info: float
    path_points: np.ndarray  # (P, >=4) x,y,z,t
    nodes: int
    edges: int
    fit_seconds: float = 0.0  # model-update wall-clock (online vs refit)
    fit_mode: str = "refit"  # "refit" | "extend" (online bordered Cholesky)
    # kept for the artifact schema (the JAX package's device planner sets
    # it); the host planner never truncates a plan
    plan_truncated: bool = False
    tracking_rmse: Optional[float] = None  # dynamic flight only
    flown_budget: Optional[float] = None  # energy integrated by the runtime


@dataclass
class ExplorationResult:
    gp_data: Table  # fidelity-binned training table (GPData schema)
    estimates: np.ndarray  # (T, 13) estimate telemetry rows
    replans: list
    model: object  # final trained model (GP or MFGP)
    budget_used: float
    rmse: float | None = None
    wmse: float | None = None


class ExplorationSim:
    """Budgeted replanning loop over a synthetic WRBF field, on ``device``
    (the card unless asked otherwise; without CUDA it raises).

    >>> sim = ExplorationSim(ExperimentConfig(), seed=0)
    >>> result = sim.run()
    """

    def __init__(self, exp: ExperimentConfig | None = None, seed: int = 0,
                 field_env: Optional[WRBFField] = None,
                 out_dir: Optional[str] = None, plan_iters: int = 40,
                 flight: str = "kinematic", runtime_cfg=None,
                 planner_backend: str = "host", plan_ensemble: int = 1,
                 device=CUDA, dtype: torch.dtype | None = None,
                 kf_noise: Callable[[int, int], np.ndarray] | None = None,
                 plan_draws: Callable[[int, int], np.ndarray] | None = None):
        self.exp = exp or ExperimentConfig()
        self.cfg: SimConfig = self.exp.sim
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.device = resolve(device)
        self.dtype = dtype or (torch.float32 if self.device.type == "cuda"
                               else torch.float64)
        if self.dtype not in _NP_DTYPES:
            raise ValueError(f"dtype {self.dtype}: float32 or float64")
        self.field = field_env or default_sim_field(
            self.cfg.WS, self.cfg.max_depth, device=self.device)
        self.out_dir = out_dir
        self.plan_iters = plan_iters
        self.agent_cfg: AgentConfig = self.cfg.agent()
        self.kf_model = self.cfg.kf_model(device=self.device)
        self.kf_noise = kf_noise
        self._kf_gen = torch.Generator().manual_seed(seed)
        # flight="kinematic": planner waypoints are the flown path, KF noise
        # only (the reference's offline-sim fidelity). flight="dynamic":
        # plans are flown by the full sense->estimate->control runtime
        # (hw.runtime) against the glider plant — tracking AND localization
        # error, like the physical drivers (SURVEY §3.4).
        if flight not in ("kinematic", "dynamic"):
            raise ValueError(flight)
        self.flight = flight
        # planner_backend="device": the whole RIG loop runs on the device
        # (planning.rig_device), all six costs and both flight modes (the
        # adapter rebuilds runtime flight plans from the extracted
        # primitive chain)
        if planner_backend not in ("host", "device"):
            raise ValueError(planner_backend)
        if planner_backend == "device" and self.exp.plan_wallclock:
            raise ValueError(
                "the device planner runs a fixed iteration count, not a "
                "wall-clock stopwatch; set plan_iters instead of "
                "plan_wallclock")
        self.planner_backend = planner_backend
        self.plan_ensemble = int(plan_ensemble)
        if self.plan_ensemble > 1 and planner_backend != "device":
            raise ValueError("plan_ensemble requires the device planner "
                             "(--planner device)")
        self.plan_draws = plan_draws
        self._device_planner = None
        self._gain_nmax = None
        self._runtime_cfg = runtime_cfg
        self._runtime = None
        # grid the EID / replanning posterior is evaluated on
        self.grid = eid_grid([list(b) for b in self.cfg.WS],
                             self.cfg.max_depth)
        # coarse information-gain grid for the batch log-det costs — the
        # reference keeps a SEPARATE 10x6x5 IG grid next to the dense
        # ergodic/EID grid (reference/PhysicalExperimentCode/
        # exploreExpSettings.py:158-173); an O(G^3) determinant per
        # candidate on the full EID grid would be prohibitive
        self.ig_grid = eid_grid([list(b) for b in self.cfg.WS],
                                self.cfg.max_depth, nums=(10, 6, 5))
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    # -- model handling -----------------------------------------------------
    def _make_model(self, X, fid, y):
        dtype = _NP_DTYPES[self.dtype]
        if self.exp.multi_fidelity:
            Xs = [X[fid == lev] for lev in (3, 2, 1)]
            ys = [y[fid == lev] for lev in (3, 2, 1)]
            m = MFGP.from_fidelity_lists(
                [x.astype(dtype) for x in Xs], [v.astype(dtype) for v in ys],
                device=self.device, kernel=self.exp.kernel, jitter=1e-6)
        else:
            m = GP(X.astype(dtype), y.astype(dtype), kernel=self.exp.kernel,
                   jitter=1e-6, device=self.device)
        return m

    def _fit(self, model):
        if not self.exp.update_hyps:
            return
        try:
            if isinstance(model, MFGP):
                model.optimize(fix_rhos=True,
                               lengthscale_bounds=(1e-4, 100.0))
            else:
                model.optimize()
        except NUMERICAL_FAILURES:
            pass  # keep last hyps (reference's blow-up recovery keeps going)
        self._recover_hyps(model)

    def _recover_hyps(self, model):
        """Hyperparameter blow-up recovery: clamp params > 90 to 1
        (reference/PhysicalExperimentCode/
        GraceExplorationExperiments_MFEGP.py:398-410)."""
        v = np.asarray(model.param_array)
        if np.any(~np.isfinite(v)) or np.any(np.abs(v) > 90.0):
            v = np.where(~np.isfinite(v) | (np.abs(v) > 90.0), 1.0, v)
            model.set_param_array(v)

    def _eid(self, model) -> torch.Tensor:
        """The EID on the grid, a tensor on the model's device."""
        mu, sig = model.predict(self.grid)
        pa = model.param_array
        if isinstance(model, MFGP):
            prior_sig = float(pa[[0, 4, 8, -1]].sum())  # emukit slots
        else:
            prior_sig = float(pa[0] + pa[-1])
        return expected_information_density(mu, sig, prior_sig,
                                            auto=self.exp.alpha_auto)

    def _make_cost(self, model, eid):
        if self.exp.ergodic:
            erg = dict(device=self.device, dtype=self.dtype)
            if self.exp.ergodic_metric == "fourier":
                bounds = np.asarray(
                    list(self.cfg.WS) + [(0.0, self.cfg.max_depth)], float)
                return scoring.FourierErgodicCost(eid=eid, grid=self.grid,
                                                  bounds=bounds, **erg)
            return scoring.ErgodicCost(eid=eid, grid=self.grid, **erg)
        if self.exp.info_cost == "batch":
            # the reference's physical drivers score with the grid
            # log-det (SURVEY C25: SFGP=C13b) on the coarse IG grid
            if isinstance(model, MFGP):
                return scoring.MFBatchLogDetCost(
                    model=model, grid=self.ig_grid,
                    fid_levels=self.agent_cfg.fid_levels)
            return scoring.BatchLogDetCost(model=model, grid=self.ig_grid)
        if isinstance(model, MFGP):
            return scoring.MFInfoGainCost(model=model,
                                          fid_levels=self.agent_cfg.fid_levels)
        return scoring.SFInfoGainCost(model=model)

    def _device_rig(self):
        """The device planner, built once: B, the EID, the GP state and the
        seed are per-plan arguments."""
        if self._device_planner is None:
            from mfgp_tpu_torch.planning.rig_device import DeviceRIGAdapter

            exp, cfg = self.exp, self.cfg
            if exp.ergodic:
                cost = ("fourier" if exp.ergodic_metric == "fourier"
                        else "ergodic")
            elif exp.info_cost == "batch":
                cost = "mf_logdet" if exp.multi_fidelity else "sf_logdet"
            else:
                cost = "mf_gain" if exp.multi_fidelity else "sf_gain"
            self._device_planner = DeviceRIGAdapter(
                n_plans=self.plan_ensemble, plan_draws=self.plan_draws,
                mesh=self._ensemble_mesh(),
                cfg=self.agent_cfg, delta=cfg.step_size, B=exp.B,
                WS=np.asarray(cfg.WS, float), R=cfg.near_rad, Rd=cfg.Rd,
                same_node_distance=cfg.same_node_distance,
                budget_cutoff=0.9, max_iter=self.plan_iters,
                grid=self.ig_grid if cost.endswith("_logdet") else self.grid,
                kernel=exp.kernel, cost=cost, device=self.device,
                dtype=self.dtype)
        return self._device_planner

    def _ensemble_mesh(self):
        """The mesh the plan ensemble's lanes shard over: where a process
        group of more than one rank is initialised and the ensemble divides
        by its dp extent (``parallel.make_mesh``'s default layout), as the
        JAX package shards it when it has more than one device; else
        None (the lanes on this rank's device)."""
        import torch.distributed as dist

        if (self.plan_ensemble < 2 or not dist.is_available()
                or not dist.is_initialized() or dist.get_world_size() < 2):
            return None
        from mfgp_tpu_torch.parallel.mesh import (DP_AXIS, axis_size,
                                                  make_mesh)

        mesh = make_mesh(device=self.device)
        if self.plan_ensemble % axis_size(mesh, DP_AXIS):
            return None
        return mesh

    def _gain_state(self, model):
        """The model padded to a static train size for the device
        planner's gain and log-det costs (None for the ergodic ones)."""
        if self.exp.ergodic:
            return None
        from mfgp_tpu_torch.planning.rig_device import (
            prepare_mf_gain_state, prepare_sf_gain_state)

        n = int(model.X.shape[0])
        # the pad is sized generously once and grows only on overflow, as
        # the JAX package sizes it for its compiled plan
        if self._gain_nmax is None or n > self._gain_nmax:
            self._gain_nmax = 1 << max(9, (4 * max(n, 1) - 1).bit_length())
        if self.exp.multi_fidelity:
            return prepare_mf_gain_state(model, self.agent_cfg.fid_levels,
                                         self._gain_nmax)
        return prepare_sf_gain_state(model, self._gain_nmax)

    # -- flight + measurement -----------------------------------------------
    def _fly(self, path_points, t_offset, plan_num: int):
        """KF-filter the flown trajectory and synthesize measurements.

        path_points: (P, >=4) waypoint rows (x, y, z, t). Returns
        (telemetry rows, GPData rows, time flown). The filter's draws are
        ``kf_noise(plan_num, T - 1)`` when given, else the sim's generator's.
        """
        xyz = np.asarray(path_points[:, :3], float)
        t = np.asarray(path_points[:, 3], float) + t_offset
        keep = np.concatenate([[True], np.diff(t) > 0])
        xyz, t = xyz[keep], t[keep]
        if t.shape[0] < 3:
            return None, None, 0.0
        noise = (None if self.kf_noise is None
                 else np.asarray(self.kf_noise(plan_num, t.shape[0] - 1)))
        # a flight is tens of steps, one graph chunk: its capture's warm-up
        # alone costs an eager run, so the filter runs eagerly
        out = filter_trajectory(self.kf_model, t, xyz, noise=noise,
                                generator=self._kf_gen, graph_steps=0)
        tt, pos, xh, sig, err = (out[k].cpu().numpy()
                                 for k in ("t", "pos", "xh", "sig", "err"))
        telemetry = np.column_stack([tt, pos, xh, sig, err])

        # field measurement + fidelity binning at the flown points
        vals = self.field.numpy(pos)
        noisy = np.maximum(0.0, vals + self.cfg.meas_noise
                           * self.rng.standard_normal(vals.shape[0]))
        lev1, lev2, _ = self.cfg.fidlevels
        cov_comp = 0.5 * (sig[:, 0] + sig[:, 1])
        fid = np.where(cov_comp < lev1, 1, np.where(cov_comp < lev2, 2, 3))
        rows = np.column_stack([tt, pos, xh, noisy, fid.astype(float)])
        return telemetry, rows, float(t[-1] - t[0])

    def _ensure_runtime(self, x0):
        if self._runtime is not None:
            return self._runtime
        from mfgp_tpu_torch.hw.plant import GliderPlant, PlantParams
        from mfgp_tpu_torch.hw.runtime import RobotRuntime, RuntimeConfig

        plant = GliderPlant(PlantParams.from_agent(self.agent_cfg),
                            x=float(x0[0, 0]), y=float(x0[1, 0]))
        cfg = self._runtime_cfg or RuntimeConfig(dt=0.1)
        self._runtime = RobotRuntime(
            self.agent_cfg, cfg, plant=plant, seed=self.seed,
            field_fn=self.field.point_fn(), max_depth=self.cfg.max_depth,
            device=self.device)
        return self._runtime

    def _fly_dynamic(self, planner, x0):
        """Fly the planner's best path through the full runtime control
        stack. Returns (telemetry, GPData rows, time flown, FlightLog)."""
        from mfgp_tpu_torch.hw.runtime import flight_plan

        way, legs = flight_plan(planner)
        if way is None or way.shape[0] < 2:
            return None, None, 0.0, None
        rt = self._ensure_runtime(x0)
        log = rt.fly(way, legs)
        est = log.estimates
        pos = log.truth[:, 1:4]
        xh = est[:, 5:8]
        telemetry = np.column_stack([est[:, 0], pos, xh, est[:, 11:14],
                                     pos - xh])
        rows = np.asarray(log.samples)
        if rows.shape[0]:
            rows = rows.copy()
            rows[:, 7] = np.maximum(
                0.0, rows[:, 7] + self.cfg.meas_noise
                * self.rng.standard_normal(rows.shape[0]))
        else:
            rows = None
        return telemetry, rows, float(way[-1, 3]), log

    # -- checkpointing (SURVEY §5: the reference's resume was a stub) -------
    def _checkpoint(self, path, plan_num, t_now, planned_budget, x0, model,
                    data_rows):
        from mfgp_tpu_torch.utils import checkpoint as ckpt

        rows = (np.concatenate(data_rows) if data_rows
                else np.zeros((0, 9)))
        ck = ckpt.ExplorationCheckpoint(
            plan_num=plan_num, t_now=t_now, planned_budget=planned_budget,
            x0=np.asarray(x0), model=ckpt.capture_model(model),
            data_rows=rows, rng_state=self.rng.bit_generator.state,
            kf_generator_state=self._kf_gen.get_state().numpy())
        ckpt.save_checkpoint(path, ck)

    def resume_state(self, path):
        """Load a checkpoint into (plan_num, t_now, budget, x0, model,
        data_rows) and restore the host RNG stream and the filter's
        generator. A checkpoint the JAX package wrote holds no generator
        state (a ``jax.random`` key instead): resuming from it raises
        ``ValueError``."""
        from mfgp_tpu_torch.utils import checkpoint as ckpt

        ck = ckpt.load_checkpoint(path)
        if ck.kf_generator_state is None:
            raise ValueError(
                f"{path}: no torch generator state for the Kalman filter "
                "(a checkpoint of the JAX package holds a jax.random key, "
                "whose stream torch cannot continue); load it with "
                "load_checkpoint, but a run cannot resume from it")
        self.rng.bit_generator.state = ck.rng_state
        self._kf_gen.set_state(torch.from_numpy(
            np.asarray(ck.kf_generator_state, np.uint8).copy()))
        rows = [ck.data_rows] if ck.data_rows.shape[0] else []
        model = ck.model.restore(jitter=1e-6, device=self.device,
                                 dtype=_NP_DTYPES[self.dtype])
        return (ck.plan_num, ck.t_now, ck.planned_budget,
                np.asarray(ck.x0), model, rows)

    # -- main loop ----------------------------------------------------------
    def run(self, max_replans: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            resume_from: Optional[str] = None) -> ExplorationResult:
        exp, cfg = self.exp, self.cfg
        B, BD = exp.B, exp.BD
        max_replans = BD if max_replans is None else max_replans

        telemetry_all, replans = [], []
        if resume_from is not None:
            (plan_num, t_now, planned_budget, x0, model,
             data_rows) = self.resume_state(resume_from)
        else:
            x0 = np.array([[0.05 * (cfg.WS[0][1] - cfg.WS[0][0])],
                           [0.05 * (cfg.WS[1][1] - cfg.WS[1][0])]])
            planned_budget = 0.0
            t_now = 0.0
            plan_num = 0
            data_rows = []
            self._kf_gen.manual_seed(self.seed)
            # initial model: single dummy point at the origin, like the
            # drivers (reference/PhysicalExperimentCode/
            # GraceExplorationExperiments_MFEGP.py:621-666)
            dummy_X = np.array([[x0[0, 0], x0[1, 0], 0.0]])
            dummy_y = np.zeros(1)
            dummy_fid = np.array([1])
            model = self._make_model(dummy_X, dummy_fid, dummy_y)

        while plan_num < max_replans and (B - planned_budget) > 0.5 * B / BD:
            tranche = min(B / BD, B - planned_budget)
            eid = self._eid(model)
            if self.planner_backend == "device":
                planner = self._device_rig()
                best = planner.plan(x0, seed=self.seed + plan_num, B=tranche,
                                    eid=eid, gp=self._gain_state(model))
            else:
                cost = self._make_cost(model, eid)
                planner = RIGPlanner(
                    cfg=self.agent_cfg, delta=cfg.step_size, B=tranche,
                    WS=np.asarray(cfg.WS, float), R=cfg.near_rad, Rd=cfg.Rd,
                    same_node_distance=cfg.same_node_distance,
                    budget_cutoff=0.9, max_iter=self.plan_iters,
                    wallclock_limit=exp.plan_wallclock,
                    seed=self.seed + plan_num, cost=cost,
                    env=self.field.numpy,
                )
                best = planner.plan(x0)
            pts = planner.best_path_points(dense=True)
            if pts is None or best.segments is None:
                break
            planned_budget += best.budget

            flog = None
            if self.flight == "dynamic":
                telemetry, rows, t_flown, flog = self._fly_dynamic(planner,
                                                                   x0)
            else:
                telemetry, rows, t_flown = self._fly(pts, t_now, plan_num)
            if rows is not None:
                telemetry_all.append(telemetry)
                data_rows.append(rows)
                t_now += t_flown

            # retrain on everything gathered so far; with frozen hyps the
            # new rows extend the conditioned state online (bordered
            # Cholesky block) instead of a full refit
            fit_t0 = time.perf_counter()
            fit_mode = "refit"
            allrows = np.concatenate(data_rows) if data_rows else None
            if allrows is not None and allrows.shape[0] >= 4:
                can_extend = (not self.exp.update_hyps and plan_num > 0
                              and rows is not None
                              and allrows.shape[0] > rows.shape[0])
                if can_extend:
                    fit_mode = "extend"
                    if isinstance(model, MFGP):
                        # fidLev {3,2,1} -> emukit index {0,1,2}
                        # (the [Xf3, Xf2, Xf1] stacking order)
                        model.extend_data(rows[:, 4:7],
                                          3 - rows[:, 8].astype(int),
                                          rows[:, 7])
                    else:
                        model.extend_data(rows[:, 4:7], rows[:, 7])
                else:
                    X = allrows[:, 4:7]
                    y = allrows[:, 7]
                    fid = allrows[:, 8].astype(int)
                    model = self._make_model(X, fid, y)
                    self._fit(model)
            fit_secs = time.perf_counter() - fit_t0

            summary = planner.graph_summary()
            rec = ReplanRecord(plan_num, t_now, tranche, best.info,
                               np.asarray(pts), summary["nodes"],
                               summary["edges"], fit_seconds=fit_secs,
                               fit_mode=fit_mode,
                               tracking_rmse=(flog.tracking_rmse if flog
                                              else None),
                               flown_budget=(flog.plan_budget if flog
                                             else None))
            replans.append(rec)
            if self.out_dir:
                np.savetxt(os.path.join(self.out_dir,
                                        f"plannedTraj{plan_num}.csv"),
                           pts, delimiter=",")
                np.savetxt(os.path.join(self.out_dir, f"EID{plan_num}.csv"),
                           np.column_stack([self.grid,
                                            eid.detach().cpu().numpy()]),
                           delimiter=",")
                if flog is not None:  # reference telemetry CSV schemas
                    flog.save(self.out_dir, suffix=str(plan_num))
            # next plan starts where this path ended — in dynamic mode,
            # where the robot BELIEVES it is (the reference replans from
            # the live estimate, reference/...MFEGP.py:428-439)
            if self.flight == "dynamic" and self._runtime is not None:
                x0 = np.asarray(self._runtime.xhat[:2, 0],
                                float).reshape(2, 1)
            else:
                x0 = np.asarray(pts[-1, :2], float).reshape(2, 1)
            plan_num += 1
            if checkpoint_path is not None:
                self._checkpoint(checkpoint_path, plan_num, t_now,
                                 planned_budget, x0, model, data_rows)

        if self.out_dir and replans:
            # per-replan fit stats: the online bordered-Cholesky extension's
            # measured win over refit is recorded here (VERDICT r1 item 4)
            with open(os.path.join(self.out_dir, "replans.csv"), "w") as f:
                f.write("planNum,tStart,tranche,bestInfo,nodes,edges,"
                        "fitSeconds,fitMode,trackingRmse,flownBudget,"
                        "planTruncated\n")
                for r in replans:
                    f.write(f"{r.plan_num},{r.t_start},{r.budget_tranche},"
                            f"{r.best_info},{r.nodes},{r.edges},"
                            f"{r.fit_seconds:.6f},{r.fit_mode},"
                            f"{'' if r.tracking_rmse is None else r.tracking_rmse},"
                            f"{'' if r.flown_budget is None else r.flown_budget},"
                            f"{int(r.plan_truncated)}\n")
        return self._finish(data_rows, telemetry_all, replans, model,
                            planned_budget)

    def _finish(self, data_rows, telemetry_all, replans, model,
                planned_budget) -> ExplorationResult:
        cfg = self.cfg
        gp_data = Table(GPDATA_HEADER.split(","),
                        np.concatenate(data_rows) if data_rows
                        else np.zeros((0, 9)))
        est = np.concatenate(telemetry_all) if telemetry_all else \
            np.zeros((0, 13))

        rmse = wmse = None
        if model is not None and gp_data.data.shape[0] >= 4:
            tp = cfg.test_points()
            f_true = self.field.numpy(tp)
            mu, _ = model.predict(tp)
            rmse = float(np.sqrt(np.mean(
                (mu.detach().cpu().double().numpy().reshape(-1)
                 - f_true) ** 2)))
        return ExplorationResult(gp_data, est, replans, model,
                                 planned_budget, rmse=rmse, wmse=wmse)

    # -- Manual variant (SURVEY C25: GraceExplorationExperiments_Manual) ----
    def run_manual(self, waypoints: np.ndarray,
                   speed: Optional[float] = None) -> ExplorationResult:
        """Teleoperated data-collection run: no planner, the operator's
        waypoint chain is flown directly; measurements are gathered,
        energy is integrated from the actuator-rate model, and the GP is
        trained once at the end (reference/PhysicalExperimentCode/
        GraceExplorationExperiments_Manual.py:475-704 — zero ``plan()``
        calls, end-of-run model save).

        waypoints: (W, 3) x/y/z targets, visited at ``speed`` (defaults to
        the agent swim speed) with measurements at meas_rate.
        """
        cfg = self.cfg
        speed = speed or self.agent_cfg.swim_speed
        wp = np.asarray(waypoints, float)
        segs = [wp[0][None]]
        t_rows = [0.0]
        t_acc = 0.0
        dt = 1.0 / max(cfg.meas_rate * 25.0, 1.0)  # dense flight sampling
        for a, b in zip(wp[:-1], wp[1:]):
            d = float(np.linalg.norm(b - a))
            n = max(int(d / (speed * dt)), 1)
            for k in range(1, n + 1):
                t_acc += dt
                segs.append((a + (b - a) * k / n)[None])
                t_rows.append(t_acc)
        path = np.concatenate(segs)
        pts = np.column_stack([path, np.asarray(t_rows)])

        self._kf_gen.manual_seed(self.seed)
        telemetry, rows, t_flown = self._fly(pts, 0.0, 0)
        data_rows = [rows] if rows is not None else []
        # energy: tail-flap swim cost + time cost over the flown duration
        # (the physical driver integrates actuator-rate-KF udot^2 weights,
        # reference _Manual.py:516-520; the kinematic sim uses the same
        # energy model as the planner's swim primitive)
        from mfgp_tpu_torch.planning.primitives import swim_energy

        budget_used = (swim_energy(t_flown, self.agent_cfg)
                       * self.agent_cfg.tail_energy_scale
                       + self.agent_cfg.time_energy * t_flown)

        model = None
        if data_rows and data_rows[0].shape[0] >= 4:
            allrows = np.concatenate(data_rows)
            model = self._make_model(allrows[:, 4:7],
                                     allrows[:, 8].astype(int),
                                     allrows[:, 7])
            self._fit(model)
            if self.out_dir:
                from mfgp_tpu_torch.utils import checkpoint as ckpt

                ckpt.save_checkpoint(
                    os.path.join(self.out_dir, "manual_model"),
                    ckpt.ExplorationCheckpoint(
                        plan_num=0, t_now=t_flown, planned_budget=budget_used,
                        x0=wp[-1][:2].reshape(2, 1),
                        model=ckpt.capture_model(model),
                        data_rows=allrows,
                        rng_state=self.rng.bit_generator.state,
                        kf_generator_state=self._kf_gen.get_state().numpy()))
        return self._finish(data_rows, [telemetry] if telemetry is not None
                            else [], [], model, budget_used)
