#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``mfgp_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one H100

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for cuBLAS and cuDNN.
2. Build: nvcc compiles ``mfgp_tpu_torch/ops/csrc/*.cu`` for sm_90a.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, both base kernels, at small shapes ragged against the tiles
   (B2/B3: N below one 128-wide tile, M of 1 and 130, F of 1 and 3), and
   the TF32 planes (``tf32_split`` and B1's) against the plain split bit
   for bit. B1 also: its symmetric half grid against the full grid bit for
   bit, and 420 ragged shapes per base against float64 (``b1_checks``).
   ``tri_gemm`` (the triangular inverse's two per-level products) against
   its plain version in float64 on the same float32 inputs, both k-range
   rules and both outputs, at the unit's level shapes (10,000 to 1,250,
   the nodes of a level in one launch) and at ragged ones, within four
   times the plain float32 products' own error (``tri_gemm_checks``).
   The build phase reports B1's registers and spills.
4. Unit: the benchmark unit of ``bench.py`` at full size (N=20,000
   training points, the M=10,571-point grid, F=3, D=3, float32) for rbf and
   matern32: ``nlml_value_grad_state_inv`` then
   ``predict_fused``. The NLML is held against the recorded float64 NumPy
   values, the gradient against the plain float64 path (every entry, and
   the rbf g_logvar normwise), and the launch counters show that every
   kernel ran.
5. Times: the unit's wall time and phases, each kernel beside its plain
   version at the unit's shapes, B2's and B3's achieved TFLOP/s, and the
   TF32 split passes, on CUDA events; B1 at each of its main-path launch
   shapes (the unit's Gram, B3's S^T planes, the GP's F=1 Gram) with its
   bound and share of it; the unit's TF32 planes (Linv, Linv^T, B1's S^T)
   against the plain split bit for bit; ``tri_gemm``'s ten launches of one
   Linv, replayed as the unit made them, beside its plain version at the
   same operands (bound: N^3/3 float32-equivalent flop at the 3xTF32
   rate).
6. Fit: the fit paths. First three checks at a small size: the autodiff
   NLML gradient in float32 on the card (through B1's autograd Function,
   rhos included, N=2,000, both bases) against float64, the Function's
   backward for an asymmetric cotangent (N=1,000), and the analytic
   gradient at ROADMAP C5's inputs (``grad_from_kinv`` and B2 within 2e-3
   per component of float64). Then,
   with the launch counters from 0, the full-width fits (N=20,000):
   ``MFGP.optimize_restarts`` (rbf, matern32), ``MFGP.optimize`` (scipy on
   the autodiff NLML, rbf) and ``GP.optimize_restarts`` (rbf), each a few
   iterations, then ``predict`` on the grid; and the single-fidelity unit
   (``gp.nlml_value_grad_state_inv`` through B2 at F=1, then
   ``gp.predict_blocked_inv``). Each fit is held to: every lane finite, the
   best NLML no higher than at the start, finite params, a finite grid
   posterior with var > 0 on >= 99.9 % of points, B1 launched.

7. Study: the model-comparison study through the port's command line,
   ``mfgp_tpu_torch.cli.main(["study", "--fit-mode", "device", ...])``, at
   the reference's own dataset shape: ``duration=3600`` (36,000 filter
   steps per trajectory, N of about 705 points per dataset at 0.2 Hz), the
   2,000-point grid with full 2,000 x 2,000 posterior covariances, float32,
   one dataset (trajectory seed 0, velocity-noise level 0.2, field seed
   0): one dataset at a time is launch-bound and takes 1 to 2.5 minutes
   at the pace of the host, and phase 10 runs the whole design. Held to:
   every artifact written and parsed, all RMSE finite, every WRMSE finite
   after the counted float64 repairs (made on the card), each fit's best
   NLML no higher than at its start, B1 launched in every fit and every
   evaluation, the models on the card.
   ``study_f64``: that dataset through ``process_dataset`` in
   float64 with scipy's L-BFGS-B on the card (the plain composition by the
   gate's rule, so B1's count stays 0), the yardstick for the float32 MFGP
   RMSE. Then B1 at the study's launch shapes, held against its plain
   version in float64 and timed, and the device's idle share over one
   dataset (``torch.profiler``).
8. NIGP at the unit's width (N=20,000, float32): ``NIGP.fit_native`` (2
   restarts, 3 iterations), ``NIGP.fit`` (1 x 1, 3 iterations), then
   ``predict_blocked`` and ``predict`` on the 10,571-point grid; beside it
   the float32 autodiff gradients of ``nlml`` and ``nlml_native`` at
   N=2,000 against the float64 plain path, B1 at the NIGP's launch shapes
   (the 20,000 x 20,000 Gram at F=1 with and without noise, the 10,571 x
   20,000 and 1,024 x 20,000 cross-covariances) against its plain version
   in float64, one evaluation's forward and backward times, and the idle
   share over one fit.
9. Recursive: ``RecursiveMFGP`` on the same problem's three fidelity lists
   (2 restarts x 3 iterations per level), then the grid posterior; B1 at a
   level's launch shapes against its plain version in float64.
10. Batched study (run after phase 7's parts, whose dataset it uses):
   B1's lane axis held bit for bit against single-lane
   launches (every lane) and its full grid (every symmetric lane), and
   against its float64 plain version, at L = 1, 3 and 64 lanes and the
   study's seven launch shapes, and at the lane counts the study gives it
   (the fits' Grams at 288 lanes, the NIGP's at 72, every shape at the
   10-lane evaluation chunk), and timed at 288 lanes; one batched SFGP
   evaluation of 288 lanes phase by phase; then
   ``cli.main(["study", "--fit-mode", "device-batched", ...])`` over 4 of
   the reference design's 10 trajectory seeds (4 x 3 x 3 = 36 datasets of
   its 90; cut so that phase 14 fits in the call) at the same shape
   (one sweep of 288 restart lanes per family, the NIGP's 72), with the
   launch counters from 0. Held to: every artifact written and parsed,
   every RMSE finite and every WRMSE finite after the counted float64
   repairs, each dataset's best NLML no higher than its row-0 start, the
   sweeps on the card in float32, B1 launched once per round (twice per
   NIGP round) and 13 times per evaluation chunk, not once per lane; and
   the batched path with ``ftol=0`` on phase 7's dataset within rtol 0.05
   of phase 7's RMSEs (MFGP, SFGP, SFGP-TP). Prints the wall and stages,
   rounds and evaluations per lane and family (by velocity-noise level),
   peak memory, the repairs per family and the idle share over a bounded
   window.
11. Planner: the study's dataset (trajectory 0, vmn 0.2, field seed 0;
   N of about 705) through the filter and the pipeline, the 3-fidelity
   MFGP and the GP on it in float32 with one short ``optimize_restarts``
   each, then, with the launch counters from 0, one replan per cost as the
   simulator makes it: the EID on the 2,000-point grid through
   ``predict``, the cost (ErgodicCost and FourierErgodicCost on the EID
   grid, SFInfoGainCost, MFInfoGainCost, and BatchLogDetCost and
   MFBatchLogDetCost on the 300-point IG grid), and ``RIGPlanner.plan``
   at the simulator's settings (``SimConfig()``, ``max_iter=40``, a
   fixed seed, the WRBF field as the edges' environment) but the planner
   benchmark's budget ``B=150`` (bench.py:208-213). Held to: a best path
   with a finite score per replan, B1 launched exactly once per
   covariance block per scoring call (4 MF sequential, 2 SF sequential, 3
   log-det; none for the ergodic costs), not once per candidate, and the
   first lane-axis launch of each kind those replans made bit for bit
   against single-lane launches and within 1e-5 x max(1, largest entry)
   of float64. Then one replan per cost at the simulator's own budget, its
   first tranche ``B=15`` (sim/explore.py:343-345), with the same holds on
   its path, its B1 count and its lane-axis launches. Then, on 512 paths of a replan's graph scored as one batch,
   every cost in float32 against the same cost on float64 copies of the
   models on the card (1e-4 of the largest score for the ergodic costs,
   1e-2 for the others; non-finite float32 scores counted), B1's lane
   launches of that batch bit for bit against single-lane launches and
   within 1e-5 x max(1, largest entry) of float64 (and timed, with their
   bounds), the log-det costs' grid blocks against float64
   (``b1_path_check``), and ``cli infogain-test`` on the card. Prints per
   cost the replan's wall and stages, the planner's stats, the seconds in
   scoring calls, peak memory and the idle share over one replan
   (``torch.profiler``).

12. Explore: the closed loop through the port's command line,
   ``cli.main(["explore", ...])`` at its defaults, the simulator's own
   budget (``--budget 150 --bd 10 --plan-iters 40 --seed 0``: ten
   replans of a 15-unit tranche), float32 on the card, for MFEGP, SFEGP,
   MFGP and SFGP, then MFGP with ``--info-cost batch`` and SFEGP with
   ``--ergodic-metric fourier`` (all six path costs), with the launch
   counters from 0. Each run is held to: at least one replan and no more
   than the budget, fidelity levels in {1, 2, 3} and 13-wide telemetry,
   the models on the card in float32, B1 launched in every replan's refit
   and EID, every scoring call at the design's count (4 / 2 / 3 / 0, as
   phase 11), the first lane-axis launch of each kind bit for bit against
   single-lane launches and within 1e-5 x max(1, largest entry) of
   float64, every artifact written (``plannedTraj{n}``, ``EID{n}`` whose
   density sums to 1 within 1e-5, ``replans.csv``), a finite final RMSE
   below 3.0 (the JAX test's bar), and no fit failure swallowed but
   numerical ones (``ExploreProbe``). Then: B1 at the closed loop's
   shapes against float64 and timed; one flight's filter eager against
   one CUDA graph; MFEGP in float64 on the card (the yardstick: the
   float32 RMSE within 2x of it); MFGP with frozen hyperparameters in
   float64 (later replans take ``extend``, whose posterior equals a
   recondition within 1e-6); MFEGP stopped after replan 2 with a
   checkpoint and resumed (the same replans, rows and budget as the
   uninterrupted run within 1e-6; replan 2 alone under the profiler);
   MFEGP flying through the robot runtime, cut to 3 replans (tracking
   RMSE > 0.01, flown budget > 0, the runtime's files written), and the
   runtime's observer step on the card eager against its CUDA graph.
   Prints per run the wall, per replan the seconds of each stage (EID,
   plan, flight, fit) and B1's launches there, evaluations per fit, peak
   memory, scoring calls, and the idle share over one whole run (the
   Fourier run, traced) and over one replan; for the dynamic flight the
   ticks, microseconds per tick and the runtime's share of a replan.

13. Device planner: the whole RIG loop on the card
   (``planning.rig_device.DeviceRIG``). (a) bench.py's planner unit
   (``run_planner_tpu``): one ergodic plan of 200 iterations at B=150 on
   the 2,000-point grid from (1, 1), then 8 lanes of ``plan_batch``, min of
   3 after a warm-up each with one iteration captured as a CUDA graph and
   replayed, and eagerly (one solo plan and one batch after one
   warm-up), the two held bit for bit; a 10-iteration plan of each under
   the profiler. (b) One plan per cost (the six) at the
   simulator's settings (``SimConfig()``, 40 iterations, its first tranche
   B=15, the planner phase's dataset and models, the training set padded
   as the simulator pads it) with float32 covariance tiles (B1) and float64
   posterior algebra for the model costs, replayed, against float64 eager
   on the card with the same draws (the same nodes and best path: score
   within 1e-4 relative; a float32 flip of a beam selection is reported)
   and against the host cost re-scoring its path in float64 (1e-4; the
   ergodic cost 5e-3). (c) The float32 eager loop of each cost under
   ``torch.cuda.set_sync_debug_mode("error")``, bit for bit the replayed
   one. (e) B1 at this path's launch shapes: the first lane-axis launch of
   each shape held and timed (``planner_lane_check``), the padded training
   rows exactly 0, the log-det costs' grid blocks against float64. (d) The
   closed loop through ``cli explore --planner device`` at its defaults
   for MFEGP, SFEGP, MFGP and SFGP, then MFEGP with ``--plan-ensemble 8``,
   with the launch counters from 0: phase 12's holds
   (``explore_run_checks``),
   every replan through the device loop (its lanes, its replays, B1 in
   every gain plan), per replan the stage times, per run the wall and peak
   memory; then the idle share over one SFGP replan at the same tranche
   (``--budget 15 --bd 1``; a whole run is ~1.3 million kernel events for
   the profiler). Its B1 launches count each replay of a captured launch
   (``LAUNCHES`` counts it once).

14. Mission: the whole budgeted mission on the card
   (``sim.mission_device.DeviceMission``, ``hw.runtime_device``) through
   ``cli.main(["mission", ...])``, with the launch counters from 0: (a) at
   its defaults (MFEGP, ``--budget 80 --bd 4 --plan-iters 40 --e-max 16``,
   kinematic flight, float32): the cold and warm seconds, replans,
   ``n_data`` and RMSE, the same seed in float64 (the float32 RMSE within
   2x of it), per replan the seconds of each stage (EID, plan, flight,
   extension, refit) and B1's launches (> 0 in every replan; the
   planner's captured launches counted once per replay), the planner's
   replays and capture seconds, one flight's filter eager against a graph,
   peak memory, and the idle share over a warm one-tranche mission
   (``torch.profiler``); (b) MFGP with ``--update-hyps --fit-restarts 4``
   (cut to ``--budget 40 --bd 2``, two replans per run, to keep the
   script within its time): each refit's evaluations, rounds and NLML
   (finite, never above its warm start; B1 in every replan); (c) SFEGP
   with ``--flight dynamic``, then
   ``--glide-stride 4``: tracking RMSE and flown budget per replan, no
   ``meas_overflow``, and the first flight flown again by fresh runtimes:
   microseconds per tick eager and replayed, with ``glide_stride`` 4
   beside 1, and a short flight with and without the early stop; (d)
   ``--ensemble 8``: its seconds against the warm solo mission (which
   includes the 8-lane captures), a warm 8-member ensemble against a warm
   solo run of one float32 mission, and in float64 member 0 of an
   8-member ensemble against
   the solo run of its seed (the same replans and chains, RMSE within 1e-6
   relative); (e) ``campaign`` at its defaults (4 variants x 5 seeds,
   ``B=20``, ``BD=2``): seconds per variant, RMSE per seed; (f) the first
   lane-axis B1 launch of each shape the runs made held and timed
   (``planner_lane_check``) with its bound. Prints ``mission_seconds``,
   its parts' seconds.

15. Serve: the services of ``mfgp_tpu_torch.serve`` over HTTP (port 0,
   stdlib clients in threads). The launches counted are those of the
   served calls alone, each counted from just before it to just after it
   (``ServedLaunches``; the planner's replays of captured launches
   included); references and kernel checks run outside. (a) The
   unit's MFGP (N=20,000, F=3, float32) saved with the port's checkpoint
   and served by ``ModelServer.from_checkpoint``: 8 clients each POST
   /predict with one eighth of the 10,571-point grid at once (held to
   more than one request per launch, B1 launched, mean and variance
   within 1e-5 of the largest |value| of one direct ``predict``), /eid
   over the grid (sums to 1), /extend of 64 points (the grid's posterior
   against a model conditioned from scratch in float64 on the same N+64
   points: within 3e-3 (mean) and 2e-2 (var) of the largest |value|, and
   within 1.5x the error of a float32 model conditioned from scratch);
   B1 at the served shapes (a
   predict block, /extend's cross-covariance) against float64 and timed.
   (b) The planner phase's study-size MFGP (N of about 705, the
   simulator's workspace) behind ``PlannerService`` (mf_gain, then
   ergodic; 40 iterations, ``warm=True``): for mf_gain the warm plan's
   capture happens while 4 clients hammer /predict (every answer 200 and
   within 1e-5 of the unloaded values; the captured service plans what a
   service built without load plans); 8 concurrent /plan requests
   coalesce into one ``plan_batch`` launch of 8 lanes, each lane's path
   within 1e-4 of its solo plan (solo plans capture nothing); /refit (4
   restarts, 20 iterations), then a /plan on the cleared caches. (c)
   ``MissionService``: the command line's default mission (MFEGP,
   B=80, BD=4) submitted at seeds 0 and 1 (the second warm, with no
   capture; times to result), seed 0's RMSE against a direct run and
   phase 14's, then ``cli mission --submit URL``. Prints
   ``serve_seconds``, its parts' seconds. ``viz`` is not imported: the
   chip machine's matplotlib is not relied on.

16. Parallel: ``mfgp_tpu_torch.parallel`` and the ``mesh=`` ensembles,
   one rank per process, every rank on the one card (NCCL does not put two
   ranks on one GPU, so the ranks that share it talk over gloo, whose
   collectives take CUDA tensors here: ranks sharing one card measure
   correctness, not scaling, and no multi-GPU number is taken). First B1
   at the sharded paths' launch shapes (a 5,286 x 20,000 grid shard, the
   20,000 x 10,000 K columns at F=3 and kernel columns at F=1) against
   float64 and timed. (a) NCCL at world size 1 in this process, mesh
   (1, 1), and (b) gloo with 2 ranks, mesh (1, 2), at the unit's width
   (N=20,000, M=10,571, F=3, float32, rbf): every ``make_sharded_*``
   function (the MF and GP grid posteriors, the cross-covariance, the WMSE
   of a 2,000-point posterior covariance, the column-sharded NLML
   gradient), the fully sharded NLML with 250-wide panels in the block and
   the cyclic layout, the sharded Cholesky of the 20,000 x 20,000 Gram and
   both tri-solves of 2,000 columns, each timed with its B1 launches and
   collectives. Held to: the NLML values within 1e-4 of the one-device
   value and 1e-3 of float64; the cross-covariance within 1e-5 of its
   largest entry of one device; the posterior means and variances and the
   WMSE no further from float64 (beyond 1e-5 of the largest entry), the
   factor's backward error and the solves' residuals no larger, than twice
   the one-device float32 result's; B1 launched in every call that assembles a
   covariance; the gradients' contraction within 2e-3 per component of
   float64 at C5's inputs (the unit's box at two lengthscales, the close
   points); every function in float64 at N=4,000 within 1e-10 of one
   device; no rank importing jax. (c) gloo with 4 ranks, mesh (2, 2):
   ``fit_sharded`` of the planner phase's study-size MFGP (8 restarts, 200
   steps; finite losses, the best no higher than its start, grid variances
   > 0), then ``plan_ensemble`` of 8 mf_gain lanes at the simulator's
   settings and ``run_ensemble`` of 8 members of the command line's default
   mission, each against the one-device ensemble on the card (every lane's
   plan state bit for bit; members' replans and masks equal, RMSE within
   1e-6). Prints seconds per function, B1 launches per call, collectives
   and their bytes, what gloo staged through the host, peak memory per
   rank and the card's name and power limit.
17. Triangular inverse: Linv of the unit's float32 rbf factor (``bench.py``'s
   problem and hyperparameters) at N = 705, 1,250, 3,001, 5,000 and
   20,000, by ``tri_inv_recursive`` (the tensor-core route above 1,024)
   and by its strips (``linalg._tri_inv_strips``): the median of eight
   CUDA-event times each, the routes in turns, the normwise error against the float64 inverse
   of the same factor and max |L Linv - I|, both held to twice the strips'
   (plus 2^-22), the result row-major and ``linalg.tri_inv_tc`` counted
   once a call above 1,024. Then one tensor-core Linv at N=20,000 under
   ``torch.profiler`` (device ms per kernel name and per ``tri_gemm``
   launch), and B2 on the unit's Linv by either route, each time just
   after a Linv by either route, with and without
   ``torch.cuda.empty_cache()`` between the two, in turns (whether B2's
   time follows its data, or what ran before it: the caching allocator's
   state, the card's clock).

Every phase prints one JSON line (the fit phase one per part). A failed
build or launch raises; a failed check is reported and the script exits 1
after the last phase. The last line, on success only, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs a CUDA device and the repository around it; without either it
exits non-zero and prints no result.

    python3 chip_smoke.py --only study,study_f64,study_batched,nigp,recursive,planner,explore,device_planner,mission,serve,parallel,tri_inv

runs the build and only the named phases of 7 to 17 (while working on
them; ``study_batched`` runs ``study`` first, whose dataset it is held
to); it prints no result line.

    python3 chip_smoke.py --b1-times ROOT

times only B1 at its main-path launch shapes (with its registers, static
SASS and a checksum of its output bits) and the unit's wall for the port package of the checkout at
ROOT, so that two commits can be timed in turns on one card. It prints
no result line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = (
    ("ar1_cov_fused", "mfgp_tpu_torch/ops/csrc/ar1_cov.cu",
     "mfgp_tpu/ops/pallas_kernels.py:121"),
    ("syrk_grad_fused", "mfgp_tpu_torch/ops/csrc/syrk_grad.cu",
     "mfgp_tpu/ops/pallas_kernels.py:486"),
    ("posterior_fused", "mfgp_tpu_torch/ops/csrc/posterior.cu",
     "mfgp_tpu/ops/pallas_kernels.py:300"),
    # the TF32 hi/lo operand planes of B2 and B3 (the Pallas kernels'
    # HIGHEST-precision products split their operands inside the dot)
    ("tf32_split", "mfgp_tpu_torch/ops/csrc/tf32_split.cu",
     "mfgp_tpu/ops/pallas_kernels.py:486"),
    # the triangular inverse's two per-level products (no Pallas kernel:
    # the JAX package leaves them to XLA's products)
    ("tri_gemm", "mfgp_tpu_torch/ops/csrc/tri_gemm.cu",
     "none (XLA's products in tri_inv_recursive)"),
)
BASES = ("rbf", "matern32")
FAILURES: list[str] = []
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory bytes/s, float32 outside the tensor cores, and 3xTF32 (three TF32
# passes per float32-equivalent product)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3


T0 = time.perf_counter()  # the script's start: every JSON line's "t_s"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T0}), flush=True)


def check(name: str, ok: bool, detail: str) -> None:
    print(f"check {'ok  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        FAILURES.append(f"{name}: {detail}")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def allclose(a, b, rtol: float, atol: float) -> bool:
    a, b = a.double(), b.double()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean milliseconds per call on CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def b3_check(torch, ck, dev, rng, kern, N, M, F):
    """B3 against its plain version evaluated in float64 on the same
    float32 inputs (random lower-triangular Linv); 2e-5 rtol/atol."""
    f32, f64 = torch.float32, torch.float64

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    X = rng.random((N, 3)) * 5
    fid = rng.integers(0, F, N)
    Xs = rng.random((M, 3)) * 5
    fs = np.full(M, F - 1)
    var = np.array([1.5, 1.0, 0.5][:F])
    ls = rng.uniform(0.5, 2.0, (F, 3))
    rho = np.array([0.9, 0.8][:F - 1])
    fi, fsi = t(fid, torch.long), t(fs, torch.long)
    Lf = t(np.tril(rng.random((N, N))), f32)
    af, Xf, Xsf = t(rng.random(N), f32), t(X, f32), t(Xs, f32)
    mu, quad = ck.posterior_fused(Lf, af, Xf, fi, Xsf, fsi, t(var, f32),
                                  t(ls, f32), t(rho, f32), kern=kern)
    mu_r, quad_r = ck.posterior_fused_plain(
        Lf.double(), af.double(), Xf.double(), fi, Xsf.double(), fsi,
        t(var, f64), t(ls, f64), t(rho, f64), kern=kern)
    torch.cuda.synchronize()
    e = max(max_err(mu, mu_r), max_err(quad, quad_r))
    ok = (allclose(mu, mu_r, 2e-5, 2e-5)
          and allclose(quad, quad_r, 2e-5, 2e-5))
    rel = max(max_err(mu, mu_r) / float(mu_r.abs().max()),
              max_err(quad, quad_r) / float(quad_r.abs().max()))
    check(f"B3 {kern} N={N} M={M} F={F}", ok,
          f"max abs err {e:.3e}, max err / max |ref| {rel:.3e} "
          "(rtol 2e-5, atol 2e-5)")
    return e


def b2_check(torch, ck, mf, dev, kern, N, F):
    """B2 on the Linv/alpha of the benchmark's problem at N points and F
    fidelities (conditioned in float64), against its plain version on the
    same float32 Linv/alpha evaluated in float64; 2e-3 rtol/atol."""
    from bench import _theta, build_problem

    f32, f64 = torch.float32, torch.float64

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    Xn, fidn, yn, _, _ = build_problem(N, 16, seed=1)
    fidn = fidn % F
    v, l, r, nz = _theta()
    v, l, r, nz = v[:F], l[:F], r[:F - 1], nz[:F]
    p64 = mf.params_from_numpy(np.log(v), np.log(l), r, np.log(nz), dev, f64)
    Xd, fd, yd = t(Xn, f64), t(fidn, torch.long), t(yn, f64)
    _, _, st = mf.nlml_value_grad_state_inv(p64, Xd, fd, yd, kernel=kern,
                                            jitter=1e-6)
    L32, a32 = st.Linv.float(), st.alpha.float()
    got = ck.syrk_grad_fused(L32, a32, Xd.float(), fd, t(v, f32), t(l, f32),
                             t(r, f32), t(nz, f32), kern=kern)
    ref = ck.syrk_grad_fused_plain(L32.double(), a32.double(), Xd, fd,
                                   t(v, f64), t(l, f64), t(r, f64),
                                   t(nz, f64), kern=kern)
    torch.cuda.synchronize()
    e = max(max_err(g, h) for g, h in zip(got, ref))
    ok = all(allclose(g, h, 2e-3, 2e-3) for g, h in zip(got, ref))
    check(f"B2 {kern} N={N} F={F}", ok,
          f"max abs err {e:.3e} (rtol 2e-3, atol 2e-3)")
    return e


# (Z, M, N, K) of tri_gemm's checks: the unit's levels (N=20,000; a
# level's Z nodes of one size in one launch, M = N = K = half a node), and
# shapes ragged against the 128-wide tiles and 32-deep stages
TRI_GEMM_CHECKS = ((1, 10000, 10000, 10000), (2, 5000, 5000, 5000),
                   (4, 2500, 2500, 2500), (8, 1250, 1250, 1250),
                   (3, 353, 352, 352), (1, 300, 261, 288),
                   (1, 261, 300, 256), (1, 130, 1, 261), (1, 1, 129, 129))


def tri_gemm_checks(torch, ck, dev) -> float:
    """Phase 3, ``tri_gemm``: Z products ``-A_z B_z^T`` of random float32
    operands in one launch against ``tri_gemm_plain`` evaluated in float64
    on the same inputs, for both k-range rules, B given as the triangular
    inverse gives it (``right``: column-major views, as Ai^T; ``left``:
    stacked TF32 planes, as B Ai's), into both outputs (strided views of
    one larger matrix, nothing around them written; the TF32 planes of the
    transposes). Each product is held normwise (max |x - ref| / max |ref|)
    to four times the error of the plain version's own float32 products on
    the card, or 2^-22. Returns the max abs error."""
    f64 = torch.float64
    g = torch.Generator(device=dev).manual_seed(18)
    worst = 0.0
    for Z, M, N, K in TRI_GEMM_CHECKS:
        As = [torch.randn(M, K, device=dev, generator=g) for _ in range(Z)]
        Bs = [torch.randn(K, N, device=dev, generator=g).T for _ in range(Z)]
        for tri in ("left", "right"):
            # stacked planes as tri_gemm returns them (rows padded to 32
            # floats: the engine's TMA maps take 16-byte row strides)
            B = (ck.tf32_split(torch.cat([b.contiguous() for b in Bs]))
                 if tri == "left" else Bs)
            ref = ck.tri_gemm_plain(
                [a.double() for a in As], [b.double() for b in Bs], tri,
                -1.0, out=[torch.empty(M, N, dtype=f64, device=dev)
                           for _ in range(Z)])
            plain = ck.tri_gemm_plain(
                As, Bs, tri, -1.0,
                out=[torch.empty(M, N, device=dev) for _ in range(Z)])
            big = torch.full((Z * M + 2, N + 3), 7.0, device=dev)
            outs = [big[1 + z * M:1 + (z + 1) * M, 2:N + 2] for z in range(Z)]
            ck.tri_gemm(As, B, tri, -1.0, out=outs)
            hi, lo = ck.tri_gemm(As, B, tri, -1.0)
            planes = [x.T for x in torch.chunk(hi.double() + lo.double(), Z)]
            torch.cuda.synchronize()
            rest = big.clone()
            rest[1:Z * M + 1, 2:N + 2] = 7.0
            untouched = bool((rest == 7.0).all())
            del rest

            def normwise(xs):
                return [max_err(x, r) / max(float(r.abs().max()), 1e-300)
                        for x, r in zip(xs, ref)]

            e_plain = normwise(plain)
            for label, got in (("out", outs), ("planes", planes)):
                e = normwise(got)
                ok = all(a <= max(4 * b, 2.0 ** -22)
                         for a, b in zip(e, e_plain))
                worst = max(worst, *(max_err(x, r) for x, r in zip(got, ref)))
                check(f"tri_gemm {tri} {label} Z={Z} ({M}, {N}, {K})",
                      ok and (untouched or label == "planes"),
                      f"normwise err {max(e):.3e} (<= 4 x plain f32 "
                      f"{max(e_plain):.3e}, or 2^-22)"
                      + ("" if untouched else "; wrote outside its views"))
            del ref, plain, big, outs, hi, lo, planes
    return worst


def kernel_checks(torch, ck, mf, dev):
    """Phase 3: each kernel against its plain version (float64 reference
    on the same inputs) at small ragged shapes; returns the max abs error
    per kernel over both bases."""
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(0)
    errs = {name: 0.0 for name, _, _ in KERNELS}
    for kern in BASES:
        # B1: N=1000 x M=1537 (neither a multiple of the 32-wide tile), F=3,
        # noise on the diagonal of the square Gram; 1e-5 atol
        N, M, D, F = 1000, 1537, 3, 3
        X1 = rng.normal(size=(N, D))
        X2 = rng.normal(size=(M, D))
        f1 = rng.integers(0, F, N)
        f2 = rng.integers(0, F, M)
        var = np.array([2.0, 1.5, 0.7])
        ls = rng.uniform(0.5, 2.0, (F, D))
        rho = np.array([1.1, 0.9])
        noise = rng.uniform(0.1, 0.5, N)

        def t(a, dt):
            return torch.as_tensor(a, dtype=dt, device=dev)

        fi1, fi2 = t(f1, torch.long), t(f2, torch.long)
        for X2_, fi2_, nz, label in ((X2, fi2, None, "cross"),
                                     (X1, fi1, noise, "gram+noise")):
            args32 = (t(X1, f32), fi1, t(X2_, f32), fi2_, t(var, f32),
                      t(ls, f32), t(rho, f32))
            args64 = (t(X1, f64), fi1, t(X2_, f64), fi2_, t(var, f64),
                      t(ls, f64), t(rho, f64))
            got = ck.ar1_cov_fused(*args32, noise_diag=None if nz is None
                                   else t(nz, f32), kern=kern)
            ref = ck.ar1_cov_fused_plain(*args64, noise_diag=None if nz is None
                                         else t(nz, f64), kern=kern)
            torch.cuda.synchronize()
            e = max_err(got, ref)
            errs["ar1_cov_fused"] = max(errs["ar1_cov_fused"], e)
            check(f"B1 {kern} {label} {tuple(got.shape)}", e <= 1e-5,
                  f"max abs err {e:.3e} (atol 1e-5)")

        # B3 (2e-5 rtol/atol) and B2 (2e-3 rtol/atol) at shapes ragged
        # against the engine's 128-wide tiles and 32-deep stages: N below
        # one tile, M of 1 and 130, F of 1 and 3
        for N, M, F_ in ((2000, 1500, 3), (50, 130, 1), (333, 1, 3),
                         (1000, 130, 1)):
            e = b3_check(torch, ck, dev, rng, kern, N, M, F_)
            errs["posterior_fused"] = max(errs["posterior_fused"], e)
        for N, F_ in ((1500, 3), (50, 1), (333, 3), (1031, 1)):
            e = b2_check(torch, ck, mf, dev, kern, N, F_)
            errs["syrk_grad_fused"] = max(errs["syrk_grad_fused"], e)

    # the TF32 planes against the plain split, bit for bit: tf32_split in
    # both layouts, and B1's planes (B3's staged S^T) against the plain
    # split of B1's own output, at shapes ragged against the 32-wide tiles
    x = rng.standard_normal((333, 1031)) * 10.0 ** rng.integers(-30, 30,
                                                                 (333, 1031))
    x = torch.as_tensor(x, dtype=f32, device=dev)
    for transpose in (False, True):
        planes = ck.tf32_split(x, transpose=transpose)
        same = planes_match(torch, planes,
                            lambda r0, r1, tr=transpose: ck.tf32_split_plain(
                                x[:, r0:r1] if tr else x[r0:r1], tr))
        e = max(max_err(a, b) for a, b in zip(
            planes, ck.tf32_split_plain(x, transpose)))
        errs["tf32_split"] = max(errs["tf32_split"], e)
        check(f"tf32_split transpose={transpose} (333, 1031)", same,
              f"bit-identical to tf32_split_plain (max abs err {e:.1e})")
    for kern in BASES:
        args = (t(X2, f32), fi2, t(X1, f32), fi1, t(var, f32), t(ls, f32),
                t(rho, f32))
        K = ck.ar1_cov_fused(*args, kern=kern)
        same = planes_match(torch, ck.ar1_cov_split(*args, kern=kern),
                            lambda r0, r1: ck.tf32_split_plain(K[r0:r1]))
        check(f"B1 {kern} TF32 planes {tuple(K.shape)}", same,
              "bit-identical to tf32_split_plain of B1's output")
    errs["tri_gemm"] = tri_gemm_checks(torch, ck, dev)
    emit("kernels", max_abs_err=errs)
    return errs


def b1_checks(torch, ck, dev):
    """Phase 3, B1's redesign: the symmetric half grid (the same tensors
    twice) against the full grid (the same points as two distinct
    tensors) bit for bit, at N of 1, 31, 33, 1000 and 1031, F of 1 and 3,
    noise on and off; then B1 against its plain version in float64 at
    ragged shapes (N in 1, 33, 127, 129, 1537; M also 128 and 1536, so
    that both the 16-byte and the scalar stores run; D of 1, 3, 8; F of 1,
    2, 3, 5), atol 1e-5. Returns the max abs error."""
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(4)

    def t(a, dt=f32):
        return torch.as_tensor(a, dtype=dt if a.dtype.kind == "f" else None,
                               device=dev)

    def problem(N, M, D, F):
        return (rng.normal(size=(N, D)), rng.integers(0, F, N),
                rng.normal(size=(M, D)), rng.integers(0, F, M),
                rng.uniform(0.5, 2.0, F), rng.uniform(0.5, 2.0, (F, D)),
                rng.uniform(0.7, 1.2, F - 1))

    for kern in BASES:
        for F in (1, 3):
            differ = []
            for N in (1, 31, 33, 1000, 1031):
                X, fid, _, _, v, ls, rho = (t(a) for a in problem(N, 1, 3, F))
                nz = t(rng.uniform(0.1, 0.5, N))
                for noise in (None, nz):
                    sym = ck.ar1_cov_fused(X, fid, X, fid, v, ls, rho, noise,
                                           kern)
                    full = ck.ar1_cov_fused(X, fid, X.clone(), fid.clone(), v,
                                            ls, rho, noise, kern)
                    if not torch.equal(sym.view(torch.int32),
                                       full.view(torch.int32)):
                        differ.append((N, noise is not None))
            check(f"B1 {kern} F={F} symmetric = general", not differ,
                  f"bit-identical at N in (1, 31, 33, 1000, 1031), noise on "
                  f"and off; differing (N, noise): {differ}")
    worst = {}
    sizes = (1, 33, 127, 129, 1537)
    for kern in BASES:
        e_max, at, n = 0.0, None, 0
        for N in sizes:
            for M in sizes + (128, 1536):
                for D in (1, 3, 8):
                    for F in (1, 2, 3, 5):
                        a = problem(N, M, D, F)
                        got = ck.ar1_cov_fused(*(t(x) for x in a), kern=kern)
                        ref = ck.ar1_cov_fused_plain(*(t(x, f64) for x in a),
                                                     kern=kern)
                        e = max_err(got, ref)
                        n += 1
                        if e > e_max or at is None:
                            e_max, at = e, (N, M, D, F)
        torch.cuda.synchronize()
        worst[kern] = e_max
        check(f"B1 {kern} ragged vs plain f64", e_max <= 1e-5,
              f"{n} shapes; max abs err {e_max:.3e} at (N, M, D, F) = {at} "
              "(atol 1e-5)")
    emit("b1_checks", max_abs_err=worst)
    return max(worst.values())


# max abs errors of B1 against its plain version at the later paths' launch
# shapes (b1_path_check); the kernels line folds them into B1's max_abs_err
B1_PATH_ERRS = []


def b1_path_check(torch, ck, label: str, X1, f1, X2, f2, v, ls, rho,
                  noise=None, step: int = 2048) -> float:
    """B1 through the wrapper a path calls (``rbf_cov_fused`` at F=1, else
    ``ar1_cov_fused``; rbf, float32) at that path's launch shape, held
    against ``ar1_cov_fused_plain`` in float64 on the same inputs, ``step``
    rows at a time: max abs err <= 1e-5 times the largest entry (or 1, if
    that is larger: fitted variances run to the hundreds). A Gram of the
    same tensors twice (the symmetric half grid) is also held bit for bit
    against the full grid, which distinct tensors of equal values force."""
    F = v.shape[0]
    sym = X1 is X2

    def run(A, fa, B, fb):
        if F == 1:
            return ck.rbf_cov_fused(A, B, v[0], ls[0], noise)
        return ck.ar1_cov_fused(A, fa, B, fb, v, ls, rho, noise)

    got = run(X1, f1, X2, f2)
    same = None
    if sym:
        # rbf_cov_fused shares one label tensor between equal-length sides,
        # so the full grid at F=1 is asked of ar1_cov_fused directly
        full = ck.ar1_cov_fused(X1, f1, X1.clone(), f1.clone(), v, ls, rho,
                                noise)
        same = torch.equal(got.view(torch.int32), full.view(torch.int32))
        del full
    d = [a.double() for a in (X2, v, ls, rho)]
    err, top = 0.0, 1.0
    for r0 in range(0, X1.shape[0], step):
        r1 = min(X1.shape[0], r0 + step)
        ref = ck.ar1_cov_fused_plain(X1[r0:r1].double(), f1[r0:r1], d[0], f2,
                                     *d[1:])
        if noise is not None:
            i = torch.arange(r1 - r0, device=ref.device)
            ref[i, i + r0] += noise[r0:r1].double()
        err = max(err, max_err(got[r0:r1], ref))
        top = max(top, float(ref.abs().max()))
        del ref
    shape = f"{tuple(got.shape)} F={F}" + (" +noise" if noise is not None
                                           else "")
    check(f"B1 {label} {shape} vs plain f64",
          err <= 1e-5 * top and same is not False,
          f"max abs err {err:.3e} (<= 1e-5 x {top:.4g}, the largest entry "
          "or 1)" + ("" if same is None else
          f"; symmetric half grid bit-identical to the full grid: {same}"))
    B1_PATH_ERRS.append(err)
    return err


def b1_launches(torch, ck, problem, kern: str):
    """B1's launch shapes on the main path, each as (name, kernel call,
    plain call, bytes, flop): the unit's Gram with noise (N^2, F=3), B3's
    S^T staged as TF32 planes (M x N, two planes) and the GP's Gram (F=1).
    Bytes: each input read once, each output written once. Flop: per
    evaluation of one fidelity's term 3D + 5 for rbf (D differences and
    FMAs, the scale, the exponential, the weight product and the sum),
    3D + 8 for matern32 (and its guard, sqrt and polynomial); a symmetric
    Gram needs N(N+1)/2 evaluations per fidelity."""
    Xt, ft, _, gt, gft, p = problem
    v, ls, rho, nz = p.variances, p.lengthscales, p.rhos, p.noises
    N, D = Xt.shape
    M = gt.shape[0]
    F = v.shape[0]
    noise = nz[ft] + 1e-6
    per = 3 * D + (5 if kern == "rbf" else 8)
    z = torch.zeros(N, dtype=torch.long, device=Xt.device)
    sym = N * (N + 1) / 2
    pts = (N * D + N) * 4 + N * 8  # X, noise and labels, float32 / int64
    return (
        ("gram", lambda: ck.ar1_cov_fused(Xt, ft, Xt, ft, v, ls, rho, noise,
                                          kern),
         lambda: ck.ar1_cov_fused_plain(Xt, ft, Xt, ft, v, ls, rho, noise,
                                        kern),
         4 * N * N + pts, sym * F * per),
        ("st_planes", lambda: ck.ar1_cov_split(gt, gft, Xt, ft, v, ls, rho,
                                               kern),
         lambda: ck.ar1_cov_split_plain(gt, gft, Xt, ft, v, ls, rho, kern),
         2 * 4 * M * N + pts + (M * D) * 4 + M * 8, M * N * F * per),
        ("gp_gram", lambda: ck.rbf_cov_fused(Xt, Xt, v[2], ls[2], noise,
                                             kern),
         lambda: ck.ar1_cov_fused_plain(Xt, z, Xt, z, v[2:], ls[2:], rho[:0],
                                        noise, kern),
         4 * N * N + pts, sym * per),
    )


def b1_times(torch, ck, problem, kern: str, plain: bool = True,
             launches=None, reps: int = 10) -> dict:
    """B1 at each main-path launch shape (``b1_launches``, or the given
    ``launches``), on CUDA events: min of two runs of ``reps`` launches,
    with ``plain`` its plain version in
    turns (plain, kernel, kernel, plain); beside each its bound (the larger
    of bytes over 3.35 TB/s and flop over 67 TFLOP/s), which of the two
    sets it, the share of the bound reached, and the write rate achieved."""
    out = {}
    for name, fused, ref, nbytes, flop in (
            launches or b1_launches(torch, ck, problem, kern)):
        p1 = cuda_ms(torch, ref, reps=1) if plain else None
        k1 = cuda_ms(torch, fused, reps=reps)
        k2 = cuda_ms(torch, fused, reps=reps)
        p2 = cuda_ms(torch, ref, reps=1) if plain else None
        ms = min(k1, k2)
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flop / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        out[name] = {"ms": ms, "ms_runs": [k1, k2],
                     "plain_ms": min(p1, p2) if plain else None,
                     "plain_ms_runs": [p1, p2] if plain else None,
                     "bytes": nbytes, "flop": flop, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "share_of_bound": bound / ms,
                     "write_tb_per_s": nbytes / ms / 1e9}
    return out


def ptxas_report(log_lines, part: str) -> dict:
    """Registers, spills and shared memory per kernel whose mangled name
    holds ``part``, from the ``-Xptxas -v`` lines of build.log."""
    out, name = {}, None
    for ln in log_lines:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            name = m.group(1) if part in m.group(1) else None
            continue
        if name is None:
            continue
        rec = out.setdefault(short_name(name), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln)
        if m:
            rec["registers"], rec["smem"] = map(int, m.groups())
    return out


def short_name(mangled: str) -> str:
    """B1's instantiation as 'base D' (D padded: 3 or 8), with ' lanes'
    for the lane-axis instantiation; other names as they are."""
    m = re.search(r"ar1_cov_kernelILi(\d+)ELi(\d+)E(Lb1E)?", mangled)
    if not m:
        return mangled
    k, d = int(m.group(1)), int(m.group(2))
    return f"{BASES[k]} D{d}" + (" lanes" if m.group(3) else "")


def sass_report(lib_path, part: str, keep) -> dict:
    """Static SASS of the kernels whose mangled name holds ``part``
    (``cuobjdump -sass`` on the built library), for the names ``keep``
    accepts: instructions in all, and the inner loop, taken as the loop
    (a backward branch) with the most ``MUFU.EX2``: its instructions, its
    exponentials, its instructions per exponential (each output costs one
    exponential per fidelity, so this is the instruction cost of one
    output's term), and its opcodes."""
    import collections

    from mfgp_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if part in m.group(1) else None
            if name is not None:
                funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)([^;]*)", ln)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for mangled, ins in funcs.items():
        short = short_name(mangled)
        if not keep(short):
            continue
        at = {a: i for i, (a, _, _) in enumerate(ins)}
        loop = []
        for i, (a, op, rest) in enumerate(ins):
            m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if m and int(m.group(1), 16) in at and int(m.group(1), 16) < a:
                body = ins[at[int(m.group(1), 16)]:i + 1]
                if (sum(o == "MUFU.EX2" for _, o, _ in body)
                        > sum(o == "MUFU.EX2" for _, o, _ in loop)):
                    loop = body
        ops = collections.Counter(o if o.startswith("MUFU") else
                                  o.split(".")[0] for _, o, _ in loop)
        n, ex2 = sum(ops.values()) - ops["NOP"], ops["MUFU.EX2"]
        out[short] = {"instructions": len(ins), "loop_instructions": n,
                      "loop_mufu_ex2": ex2,
                      "loop_per_exp": n / ex2 if ex2 else None,
                      "loop_ops": dict(ops.most_common(12))}
    return out


def main_path_b1(short: str) -> bool:
    """The instantiations of B1 the main path runs (D=3), and a kernel
    without template arguments (an earlier version's)."""
    return short.endswith(" D3") or "ar1_cov_kernel" in short


def make_problem(torch, mf, dev):
    """The benchmark unit's problem on the card: (X, fid, y, grid, grid
    fid, params), float32."""
    from bench import M_GRID, N_TRAIN, _theta, build_problem

    X, fid, y, grid, gfid = build_problem(N_TRAIN, M_GRID)
    v, l, r, nz = _theta()
    params = mf.params_from_numpy(np.log(v), np.log(l), r, np.log(nz), dev,
                                  torch.float32)

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    return (t(X), t(fid, torch.long), t(y), t(grid), t(gfid, torch.long),
            params)


def b1_times_only(root: str) -> int:
    """``--b1-times ROOT``: B1's kernel times at the main path's launch
    shapes for the port package of the checkout at ROOT (another commit's,
    so that two versions can be timed in turns on one card), with its
    registers and static SASS, and the unit's wall (``unit_walls``); no
    checks, no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mfgp_tpu_torch.models import mfgp as mf
    from mfgp_tpu_torch.ops import build
    from mfgp_tpu_torch.ops import cuda_kernels as ck

    if not os.path.abspath(ck.__file__).startswith(root + os.sep):
        print(f"chip_smoke: imported {ck.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    emit("b1_build", root=root, nvidia_smi=nvidia_smi(),
         seconds=time.perf_counter() - t0,
         ptxas=ptxas_report(log, "ar1_cov_kernel"),
         sass=sass_report(lib_path, "ar1_cov_kernel", main_path_b1))
    problem = make_problem(torch, mf, dev)
    for kern in BASES:
        emit("b1_times", root=root, base=kern,
             times=b1_times(torch, ck, problem, kern, plain=False),
             bits=b1_bits(torch, ck, problem, kern),
             unit_wall_s=unit_walls(torch, mf, problem, kern, reps=4))
    return 0


def b1_bits(torch, ck, problem, kern: str) -> dict:
    """A checksum of B1's output bits at each main-path launch shape: the
    sum of every output float's 32-bit pattern as an integer, so that two
    checkouts timed in turns show whether they compute the same bits."""
    out = {}
    for name, fused, *_ in b1_launches(torch, ck, problem, kern):
        res = fused()
        planes = res if isinstance(res, tuple) else (res,)
        out[name] = sum(int(p.contiguous().view(torch.int32).sum(
            dtype=torch.int64)) for p in planes)
        del res, planes
    return out


def planes_match(torch, planes, plain_rows, step: int = 2048) -> bool:
    """Whether the (hi, lo) planes equal, bit for bit, the plain planes of
    their rows, which ``plain_rows(r0, r1)`` returns, taken ``step`` rows
    at a time."""
    torch.cuda.synchronize()
    rows = planes[0].shape[0]
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        for got, ref in zip(planes, plain_rows(r0, r1)):
            if not torch.equal(got[r0:r1].contiguous().view(torch.int32),
                               ref.contiguous().view(torch.int32)):
                return False
    return True


def run_unit(torch, ck, mf, problem, kern: str, nlml_ref: float):
    """Phase 4: the benchmark unit at full size, checked."""
    Xt, ft, yt, gt, gft, params = problem
    before = dict(ck.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, grad, state = mf.nlml_value_grad_state_inv(
        params, Xt, ft, yt, kernel=kern, jitter=1e-6)
    mu, var = mf.predict_fused(params, state, gt, gft, kernel=kern)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    nlml = float(val)
    rel = abs(nlml - nlml_ref) / abs(nlml_ref)
    check(f"unit {kern} nlml", rel <= 1e-3,
          f"{nlml:.4f} vs recorded f64 {nlml_ref}: rel err {rel:.3e} "
          "(<= 1e-3)")
    finite = all(bool(torch.isfinite(g).all()) for g in grad) and bool(
        torch.isfinite(mu).all()) and bool(torch.isfinite(var).all())
    check(f"unit {kern} finite", finite, "gradient, mu and var finite")
    pos = float((var > 0).double().mean())
    check(f"unit {kern} var>0", pos >= 0.999,
          f"share of grid with var > 0: {pos:.6f} (>= 0.999)")
    check(f"unit {kern} launches", all(n > 0 for n in launched.values()),
          f"kernel launches in this unit: {launched}")

    # gradient against the plain path (structure-aware syrk + contractions)
    # at the same N, on the same float32 Linv/alpha evaluated in float64:
    # every entry within 2e-3 relative. The plain float32 path's own errors
    # are printed beside the kernel's (at this N its sequential float32
    # K^-1 sums lose the rbf g_logvar to a few per cent).
    args = (state.Linv, state.alpha, Xt, ft, params.variances,
            params.lengthscales, params.rhos, params.noises)
    ref = ck.syrk_grad_fused_plain(*(a.double() if a.is_floating_point()
                                     else a for a in args), kern=kern)
    plain32 = ck.syrk_grad_fused_plain(*args, kern=kern)
    got = (grad.log_variances, grad.log_lengthscales, grad.log_noises)

    def errs(gs):
        norms = [max_err(g, h) / float(h.abs().max()) for g, h in zip(gs, ref)]
        comp = max(float(((g.double() - h).abs() / h.abs()).max())
                   for g, h in zip(gs, ref))
        return norms, comp

    gnorms, gcomp = errs(got)
    pnorms, pcomp = errs(plain32)
    gnorm, pnorm = max(gnorms), max(pnorms)
    check(f"unit {kern} gradient", gcomp <= 2e-3,
          f"max rel err vs plain f64 {gcomp:.3e} (rtol 2e-3; plain f32 "
          f"path {pcomp:.3e}); max |err| / max |ref| per field {gnorm:.3e} "
          f"(plain f32 {pnorm:.3e})")
    # g_logvar sums ~N^2 entries of W o T that cancel, so a bias in K^-1 of
    # 1e-7 shows here first; cuBLAS' float32 path sits at ~3e-2
    if kern == "rbf":
        check(f"unit {kern} g_logvar normwise", gnorms[0] <= 1e-4,
              f"max |err| / max |ref| {gnorms[0]:.3e} (<= 1e-4; plain f32 "
              f"{pnorms[0]:.3e})")
    emit("unit", base=kern, N=int(Xt.shape[0]), M=int(gt.shape[0]),
         nlml=nlml, nlml_rel_err=rel, grad_normwise_err=gnorm,
         g_logvar_normwise_err=gnorms[0], grad_normwise_errs=gnorms,
         grad_componentwise_err=gcomp, plain_f32_grad_normwise_err=pnorm,
         plain_f32_grad_componentwise_err=pcomp, var_pos_share=pos,
         launches=launched, first_call_s=first_s, peak_mem_gb=peak_gb,
         grad=[g.double().cpu().numpy().round(6).tolist() for g in got],
         grad_ref=[h.cpu().numpy().round(6).tolist() for h in ref])
    del ref, plain32
    return state


def unit_walls(torch, mf, problem, kern: str, reps: int = 3) -> list:
    """Seconds of each of ``reps`` units (NLML, gradient, conditioning,
    grid posterior), host clock; the first carries any one-time set-up
    the caller has not paid yet."""
    Xt, ft, yt, gt, gft, p = problem
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, st = mf.nlml_value_grad_state_inv(p, Xt, ft, yt, kernel=kern,
                                                jitter=1e-6)
        mf.predict_fused(p, st, gt, gft, kernel=kern)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del st
    return walls


def recorded_tri_gemm(ck, la, L):
    """``tri_inv_recursive(L)`` with every ``tri_gemm`` call it makes
    recorded as (args, kwargs): the calls, in order, and the inverse they
    wrote into."""
    calls, real = [], ck.tri_gemm

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    ck.tri_gemm = record
    try:
        Linv = la.tri_inv_recursive(L)
    finally:
        ck.tri_gemm = real
    return calls, Linv


def tri_gemm_times(torch, ck, la, L) -> dict:
    """Phase 5, ``tri_gemm`` at the unit's shapes: the launches of one
    Linv of the unit's factor L, replayed with the operands and outputs the
    unit gave them (their TF32 splits of float32 operands included, as the
    other kernels' wrapper passes are), beside ``tri_gemm_plain``'s float32
    products of the same operands, in turns; and the whole Linv by the
    tensor-core route beside its strips."""
    calls, Linv = recorded_tri_gemm(ck, la, L)

    def replay(fn):
        for args, kwargs in calls:
            fn(*args, **kwargs)

    p1 = cuda_ms(torch, lambda: replay(ck.tri_gemm_plain), reps=1)
    k1 = cuda_ms(torch, lambda: replay(ck.tri_gemm))
    k2 = cuda_ms(torch, lambda: replay(ck.tri_gemm))
    p2 = cuda_ms(torch, lambda: replay(ck.tri_gemm_plain), reps=1)
    launches = len(calls)
    del calls, Linv
    s1 = cuda_ms(torch, lambda: la._tri_inv_strips(L, 1024), reps=1)
    t1 = cuda_ms(torch, lambda: la.tri_inv_recursive(L), reps=1)
    t2 = cuda_ms(torch, lambda: la.tri_inv_recursive(L), reps=1)
    s2 = cuda_ms(torch, lambda: la._tri_inv_strips(L, 1024), reps=1)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2),
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
            "launches_per_linv": launches,
            "linv_ms_runs": [t1, t2], "strips_ms_runs": [s1, s2]}


def unit_times(torch, ck, mf, la, cov, problem, kern: str, state):
    """Phase 5: wall time of the unit, its phases, and each kernel beside
    its plain version at the unit's shapes (CUDA events)."""
    Xt, ft, yt, gt, gft, p = problem
    walls = unit_walls(torch, mf, problem, kern)

    # the unit's steps one by one, as _nlml_vg_core + predict_fused run them
    v, ls, rho, nz = p.variances, p.lengthscales, p.rhos, p.noises
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    torch.cuda.synchronize()
    ev[0].record()
    Kn = cov.mf_train_cov(v, ls, rho, nz, Xt, ft, 1e-6, kern)
    ev[1].record()
    L = la.chol(Kn)
    del Kn
    ev[2].record()
    Linv = la.tri_inv_recursive(L)
    ev[3].record()
    z = la.tri_lower_matmul(Linv, yt[:, None])
    alpha = la.tri_lower_matmul_right(z.reshape(1, -1), Linv).reshape(-1)
    la.logdet_from_chol(L)
    ev[4].record()
    ck.syrk_grad_fused(Linv, alpha, Xt, ft, v, ls, rho, nz, kern=kern)
    ev[5].record()
    mf.predict_fused(p, state, gt, gft, kernel=kern)
    ev[6].record()
    torch.cuda.synchronize()
    names = ("assembly", "chol", "tri_inv", "alpha_logdet", "gradient",
             "posterior")
    phases = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    del Linv, alpha, z
    tri = tri_gemm_times(torch, ck, la, L)
    del L

    noise = nz[ft] + 1e-6
    S, a = state.Linv, state.alpha
    runs = {
        "syrk_grad_fused": (
            lambda: ck.syrk_grad_fused(S, a, Xt, ft, v, ls, rho, nz, kern),
            lambda: ck.syrk_grad_fused_plain(S, a, Xt, ft, v, ls, rho, nz,
                                             kern)),
        "posterior_fused": (
            lambda: ck.posterior_fused(S, a, Xt, ft, gt, gft, v, ls, rho,
                                       kern),
            lambda: ck.posterior_fused_plain(S, a, Xt, ft, gt, gft, v, ls,
                                             rho, kern)),
    }
    # B1 at each of its launch shapes (the unit's Gram is its row)
    b1 = b1_times(torch, ck, problem, kern)
    kernel_ms = {"ar1_cov_fused": dict(b1["gram"])}
    for name, (fused, plain) in runs.items():
        # plain, kernel, kernel, plain: compare within one card, in turns
        p1 = cuda_ms(torch, plain, reps=1)
        k1 = cuda_ms(torch, fused)
        k2 = cuda_ms(torch, fused)
        p2 = cuda_ms(torch, plain, reps=1)
        kernel_ms[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                           "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
    # achieved rate of the contractions in float32-equivalent flop (2 per
    # multiply-add the algorithm needs: N^3/6 for B2's K^-1 tiles, N^2 M / 2
    # for B3's V), wrapper passes included
    N, M = Xt.shape[0], gt.shape[0]
    kernel_ms["tri_gemm"] = tri
    for name, flop in (("syrk_grad_fused", N ** 3 / 3),
                       ("posterior_fused", N * N * M),
                       ("tri_gemm", N ** 3 / 3)):
        kernel_ms[name]["tflops"] = flop / kernel_ms[name]["ms"] / 1e9
    # the TF32 split passes inside B3 (Linv) and B2 (Linv^T), and B1's
    # staging of S^T = K(grid, train) as planes inside B3
    split_ms = {f"transpose={tr}": cuda_ms(
        torch, lambda tr=tr: ck.tf32_split(S, transpose=tr))
        for tr in (False, True)}
    split_ms["b1_st_planes"] = b1["st_planes"]["ms"]
    # tf32_split beside its plain version (integer operations on the
    # pattern, 2,048 rows at a time: its int64 temporaries are 8 bytes per
    # entry) and its bound: 4 N^2 bytes read, two planes written
    def split_plain():
        for r0 in range(0, N, 2048):
            ck.tf32_split_plain(S[r0:r0 + 2048])

    kernel_ms["tf32_split"] = {
        "ms": split_ms["transpose=False"],
        "plain_ms": cuda_ms(torch, split_plain, reps=1),
        "bound_ms": 12 * N * N / HBM_BPS * 1e3, "bound_by": "bytes"}
    # the same planes at the unit's shapes against the plain split, bit for
    # bit (a wrong plane fails here by name, not only as B2/B3 error)
    for tr in (False, True):
        same = planes_match(torch, ck.tf32_split(S, transpose=tr),
                            lambda r0, r1, tr=tr: ck.tf32_split_plain(
                                S[:, r0:r1] if tr else S[r0:r1], tr))
        check(f"unit {kern} tf32_split transpose={tr} {tuple(S.shape)}",
              same, "bit-identical to tf32_split_plain")
    Kst = ck.ar1_cov_fused(gt, gft, Xt, ft, v, ls, rho, None, kern)
    same = planes_match(torch, ck.ar1_cov_split(gt, gft, Xt, ft, v, ls, rho,
                                                kern),
                        lambda r0, r1: ck.tf32_split_plain(Kst[r0:r1]))
    check(f"unit {kern} B1 S^T planes {tuple(Kst.shape)}", same,
          "bit-identical to tf32_split_plain of B1's output")
    del Kst
    # the unit's B1 and B3 outputs against their plain versions in float64
    K = ck.ar1_cov_fused(Xt, ft, Xt, ft, v, ls, rho, noise, kern)
    Kr = ck.ar1_cov_fused_plain(Xt.double(), ft, Xt.double(), ft, v.double(),
                                ls.double(), rho.double(), noise.double(),
                                kern)
    b1_err = max_err(K, Kr)
    check(f"unit {kern} B1 Gram vs plain f64", allclose(K, Kr, 1e-5, 1e-5),
          f"max abs err {b1_err:.3e}, max |K| {float(Kr.abs().max()):.3e} "
          "(rtol 1e-5, atol 1e-5)")
    del K, Kr
    mu, quad = ck.posterior_fused(S, a, Xt, ft, gt, gft, v, ls, rho, kern)
    mu_r, quad_r = ck.posterior_fused_plain(
        S.double(), a.double(), Xt.double(), ft, gt.double(), gft,
        v.double(), ls.double(), rho.double(), kern)
    mu_p, quad_p = ck.posterior_fused_plain(S, a, Xt, ft, gt, gft, v, ls,
                                            rho, kern)

    def normwise(m, q):
        return max(max_err(m, mu_r) / float(mu_r.abs().max()),
                   max_err(q, quad_r) / float(quad_r.abs().max()))

    # at N=20,000 each V entry is a float32 sum of ~1e4 signed terms; the
    # plain float32 version's own error is printed beside the kernel's
    b3_err, b3_plain_err = normwise(mu, quad), normwise(mu_p, quad_p)
    check(f"unit {kern} B3 grid vs plain f64", b3_err <= 1e-4,
          f"max |err| / max |ref| {b3_err:.3e} (<= 1e-4); plain f32 "
          f"{b3_plain_err:.3e}")
    emit("times", base=kern, unit_wall_s=walls, phases_ms=phases,
         kernel_ms=kernel_ms, b1_ms=b1, split_ms=split_ms, b1_unit_err=b1_err,
         b3_unit_err=b3_err, b3_plain_f32_err=b3_plain_err)
    return kernel_ms


def field_errs(got, ref) -> list[float]:
    """max |err| / max |ref| of each non-empty field."""
    return [max_err(g, h) / float(h.double().abs().max())
            for g, h in zip(got, ref) if h.numel()]


def autodiff_checks(torch, mf, cov, dev):
    """Phase 6, checks: the autodiff NLML gradient in float32 on the card
    (B1's Function forward, closed-form backward) at the benchmark's
    problem cut to N=2,000, against the float64 plain path (all four
    fields, rhos included) and the float64 analytic gradient (the other
    three); then the Function's backward alone for an asymmetric cotangent
    at N=1,000 against float64 autograd of the plain composition. Bar:
    max |err| / max |ref| <= 2e-3 per field."""
    from bench import _theta, build_problem

    f32, f64 = torch.float32, torch.float64
    Xn, fidn, yn, _, _ = build_problem(2000, 16, seed=1)
    v, l, r, nz = _theta()
    raw = (np.log(v), np.log(l), r, np.log(nz))
    errs = {}
    for kern in BASES:
        out = {}
        for dt in (f32, f64):
            p = mf.MFGPParams(*(torch.tensor(a, dtype=dt, device=dev,
                                             requires_grad=True)
                                for a in raw))
            data = (torch.as_tensor(Xn, dtype=dt, device=dev),
                    torch.as_tensor(fidn, dtype=torch.long, device=dev),
                    torch.as_tensor(yn, dtype=dt, device=dev))
            val = mf.nlml(p, *data, kernel=kern, jitter=1e-6)
            out[dt] = torch.autograd.grad(val, list(p))
        _, g_an = mf.nlml_value_and_grad(
            mf.params_from_numpy(*raw, dev, f64),
            *(torch.as_tensor(a, device=dev) for a in (Xn.astype(np.float64),
                                                       fidn.astype(np.int64),
                                                       yn.astype(np.float64))),
            kernel=kern, jitter=1e-6)
        e_ad = field_errs(out[f32], out[f64])
        e_an = field_errs((out[f32][0], out[f32][1], out[f32][3]),
                          (g_an.log_variances, g_an.log_lengthscales,
                           g_an.log_noises))
        check(f"fit autodiff gradient {kern} N=2000",
              max(e_ad + e_an) <= 2e-3,
              f"per field (var, ls, rho, noise) vs f64 autodiff {e_ad}, "
              f"(var, ls, noise) vs f64 analytic {e_an} (<= 2e-3)")
        errs[kern] = {"vs_f64_autodiff": e_ad, "vs_f64_analytic": e_an}

        rng = np.random.default_rng(3)
        N = 1000
        X, fid = rng.random((N, 3)) * 6, rng.integers(0, 3, N)
        Ct = rng.normal(size=(N, N))
        back = {}
        for dt in (f32, f64):
            args = [torch.tensor(a, dtype=dt, device=dev, requires_grad=True)
                    for a in (v / 10, l / 4, np.array([0.9, 0.8]))]
            K = cov.ar1_cov_diff(*args, torch.as_tensor(X, dtype=dt,
                                                        device=dev),
                                 torch.as_tensor(fid, device=dev), kern)
            back[dt] = torch.autograd.grad(
                K, args, torch.as_tensor(Ct, dtype=dt, device=dev))
        e_bw = field_errs(back[f32], back[f64])
        check(f"fit Function backward {kern} N={N}", max(e_bw) <= 2e-3,
              f"per field (var, ls, rho) vs f64 autograd {e_bw} (<= 2e-3)")
        errs[kern]["function_backward"] = e_bw
    emit("fit", part="autodiff_checks", errs=errs)


class PathProbe:
    """Records what a path's fits and evaluations do, by wrapping
    the module-level functions they call: each optimiser run (NLML at its
    first evaluation, final NLML per lane, evaluations, B1 launches,
    closed-form backwards, seconds), each ``train_models`` and
    ``evaluate_models`` call, and ``run_study``'s stage times. With
    ``sync_evals`` every evaluation is timed too (CUDA-synchronised host
    clock, ``eval_seconds`` of the run's record), which serialises host and
    card and so is left off where the path's own pace is measured.
    ``restore`` puts the functions back; the package is unchanged."""

    def __init__(self, torch, ck, cov, fit_mods, trainers=None, study=None,
                 sync_evals: bool = False):
        self.torch, self.ck = torch, ck
        self.sync_evals = sync_evals
        self.saved = []
        self.fits, self.evals, self.trains = [], [], []
        self.timings = None
        self.backwards = 0
        for mod in fit_mods:
            family = mod.__name__.rsplit(".", 1)[-1]
            self._wrap(mod, "batched_lbfgs", self._lbfgs(family))
            self._wrap(mod, "scipy_lbfgsb", self._scipy(family))
        self._wrap(cov, "_ar1_cov_bwd", self._bwd)
        if trainers is not None:
            self._wrap(trainers, "evaluate_models", self._evaluate)
            self._wrap(trainers, "train_models", self._train)
        if study is not None:
            self._wrap(study, "run_study", self._study)

    def restore(self):
        for mod, name, orig in reversed(self.saved):
            setattr(mod, name, orig)

    def _wrap(self, mod, name, make):
        orig = getattr(mod, name)
        self.saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def _b1(self) -> int:
        return self.ck.LAUNCHES["ar1_cov_fused"]

    def _run(self, rec, fn):
        """``fn()`` timed (CUDA-synchronised host clock) into ``rec`` with
        the B1 launches and closed-form backwards it made."""
        b1, bw = self._b1(), self.backwards
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        rec.update(seconds=time.perf_counter() - t0, b1=self._b1() - b1,
                   backwards=self.backwards - bw)
        return out

    def _counted(self, rec, f):
        """``f`` counting its calls into ``rec`` and keeping the value of
        the first (a fit's starting NLML: lane 0 starts at the current or
        heuristic parameters)."""
        if f is None:
            return None
        rec["eval_seconds"] = []

        def g(x):
            if self.sync_evals:
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = f(x)
            if self.sync_evals:
                self.torch.cuda.synchronize()
                rec["eval_seconds"].append(time.perf_counter() - t0)
            rec["evals"] += 1
            if rec["f0"] is None:
                v = out[0] if isinstance(out, tuple) else out
                rec["f0"] = v.detach() if hasattr(v, "detach") else v
            return out
        return g

    def _lbfgs(self, family):
        def make(orig):
            def run(fun, x0, *a, value_and_grad=None, **kw):
                rec = dict(family=family, optimiser="batched_lbfgs", evals=0,
                           f0=None, on_cuda=bool(x0.is_cuda),
                           dtype=str(x0.dtype))
                x, fs, ks = self._run(rec, lambda: orig(
                    self._counted(rec, fun), x0, *a,
                    value_and_grad=self._counted(rec, value_and_grad), **kw))
                rec.update(f0=float(rec["f0"]),
                           lanes=fs.double().cpu().tolist(),
                           iterations=ks.cpu().tolist())
                self.fits.append(rec)
                return x, fs, ks
            return run
        return make

    def _scipy(self, family):
        def make(orig):
            def run(vg, x0, **kw):
                rec = dict(family=family, optimiser="scipy", evals=0, f0=None)
                xo, fo, n = self._run(rec, lambda: orig(
                    self._counted(rec, vg), x0, **kw))
                rec.update(f0=float(rec["f0"]), lanes=[fo], iterations=None)
                self.fits.append(rec)
                return xo, fo, n
            return run
        return make

    def _bwd(self, orig):
        def run(*a, **kw):
            self.backwards += 1
            return orig(*a, **kw)
        return run

    def _evaluate(self, orig):
        def run(models, *a, **kw):
            rec = {}
            metrics, grids = self._run(rec, lambda: orig(models, *a, **kw))
            rec["f64"] = metrics["wmse_f64_count"]
            self.evals.append(rec)
            return metrics, grids
        return run

    def _train(self, orig):
        def run(*a, **kw):
            rec = {}
            models = self._run(rec, lambda: orig(*a, **kw))
            rec["devices"] = sorted({str(t.device) for t in (
                models.mf.X, models.sf.X, models.sf_tp.X,
                models.nigp.X_train_)})
            rec["dtypes"] = sorted({str(models.mf.X.dtype),
                                    str(models.nigp.X_train_.dtype)})
            rec["n"] = int(models.sf.X.shape[0])
            self.trains.append(rec)
            return models
        return run

    def _study(self, orig):
        def run(*a, **kw):
            self.timings = kw.setdefault("timings", {})
            return orig(*a, **kw)
        return run


def one_fit(torch, ck, probe, model, name, kern, fit, grid):
    """Phase 6: one full-width fit through the model's own entry point
    (one optimiser run, which ``probe`` records with every evaluation
    timed), then its grid posterior; checked and printed."""
    probe.fits.clear()
    b1 = ck.LAUNCHES["ar1_cov_fused"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    best = fit(model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b1 = ck.LAUNCHES["ar1_cov_fused"] - b1
    run, = probe.fits
    # scipy runs on the autodiff NLML, the restart fits on the analytic
    # gradient; the first evaluation is at the initial params (lane 0's)
    kind = "autodiff" if run["optimiser"] == "scipy" else "analytic"
    f0, lanes, iters = run["f0"], run["lanes"], run["iterations"]
    times = run["eval_seconds"]
    label = f"fit {name} {kern}"
    check(f"{label} lanes finite", all(np.isfinite(lanes)),
          f"final NLML per lane {lanes}")
    check(f"{label} NLML", best <= f0,
          f"best {best:.6f} <= initial {f0:.6f}")
    check(f"{label} params finite",
          all(bool(torch.isfinite(p).all()) for p in model.params),
          "fitted params finite")
    check(f"{label} B1", b1 > 0, f"B1 launches in the fit: {b1}")
    check(f"{label} on the card", model.X.is_cuda,
          f"the model's data on {model.X.device}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mu, var = model.predict(grid)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    finite = bool(torch.isfinite(mu).all()) and bool(
        torch.isfinite(var).all())
    pos = float((var > 0).double().mean())
    check(f"{label} predict", finite and pos >= 0.999,
          f"grid posterior finite: {finite}, share var > 0 {pos:.6f} "
          "(>= 0.999)")
    emit("fit", part=name, base=kern, N=int(model.X.shape[0]),
         evaluations=run["evals"], eval_kind=kind, iterations=iters,
         lane_nlml=lanes, nlml_initial=f0, nlml_best=best, seconds=seconds,
         eval_seconds_sum=sum(times), eval_seconds=times,
         **{f"s_per_{kind}_eval": float(np.median(times))},
         b1_launches=b1, peak_mem_gb=peak_gb, predict_s=predict_s,
         var_pos_share=pos,
         params=[p.double().cpu().numpy().round(6).tolist()
                 for p in model.params])


def gp_unit(torch, gp, problem, params):
    """Phase 6: the single-fidelity unit at full size, rbf: value, gradient
    (B2 at F=1) and inverse-factor state, then the blocked grid posterior.
    Returns what the float64 check needs."""
    Xt, _, yt, gt, _, _ = problem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    val, grad, state = gp.nlml_value_grad_state_inv(params, Xt, yt,
                                                    kernel="rbf", jitter=1e-6)
    mu, var = gp.predict_blocked_inv(params, state, gt, kernel="rbf")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(t).all()) for t in (val, mu, var,
                                                          *grad))
    pos = float((var > 0).double().mean())
    check("fit gp unit rbf finite", finite and pos >= 0.999,
          f"value, gradient, mu, var finite: {finite}; share var > 0 "
          f"{pos:.6f} (>= 0.999)")
    info = dict(nlml=float(val), seconds=seconds, var_pos_share=pos,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return info, grad, state


def gp_unit_check(torch, ck, problem, params, grad, state, info):
    """Phase 6: the single-fidelity unit's gradient against the plain path
    evaluated in float64 on the same Linv: componentwise <= 2e-3."""
    Xt = problem[0]
    N = Xt.shape[0]
    f64 = torch.float64
    fid0 = torch.zeros(N, dtype=torch.long, device=Xt.device)
    ref = ck.syrk_grad_fused_plain(
        state.Linv.double(), state.alpha.double(), Xt.double(), fid0,
        params.variance.double().reshape(1),
        params.lengthscales.double().reshape(1, -1),
        Xt.new_zeros(0, dtype=f64), params.noise.double().reshape(1),
        kern="rbf")
    got = (grad.log_variance, grad.log_lengthscales, grad.log_noise)
    ref = (ref[0][0], ref[1][0], ref[2][0])
    comp = max(float(((g.double() - h).abs() / h.abs()).max())
               for g, h in zip(got, ref))
    g_logvar = field_errs(got[:1], ref[:1])[0]
    check("fit gp unit rbf gradient", comp <= 2e-3,
          f"max rel err vs plain f64 {comp:.3e} (rtol 2e-3); g_logvar "
          f"normwise {g_logvar:.3e}")
    emit("fit", part="gp_unit", base="rbf", N=N, M=int(problem[3].shape[0]),
         grad_componentwise_err=comp, g_logvar_normwise_err=g_logvar,
         grad=[g.double().cpu().numpy().round(6).tolist() for g in got],
         **info)


# ROADMAP C5's inputs (F=3): 300 points uniform over the simulator's
# 10 x 20 x 10 m box at lengthscales 1.0 and 0.3, and 60 points near
# (15, 15, 15), spread 0.003, at lengthscale 0.002
C5_CASES = (("box", 1.0), ("box", 0.3), ("close", 0.002))
C5_BAR = 2e-3  # per component, the gradient sums' bar (PERF.md §2)


def c5_checks(torch, ck, dev) -> dict:
    """The float32 analytic gradient at C5's inputs: ``grad_from_kinv`` (the
    restart fits' gradient) on K^-1 and B2 (``syrk_grad_fused``) on Linv,
    each against ``grad_from_kinv`` in float64 on the same float32 values
    (K^-1 = Linv^T Linv for B2), worst relative error per component of
    (g_logvar, g_logls, g_lognoise) (tests/test_torch_cuda.py's
    ``_c5_problem`` inputs)."""
    out = {}
    for kern in BASES:
        for name, ls in C5_CASES:
            X, fid, v, lsv, rho, nz, Linv, alpha = c5_problem(
                torch, ck, dev, name, ls, kern)
            L64 = Linv.double()
            r32 = [a.float() for a in (alpha, X)] + [fid] + [
                a.float() for a in (v, lsv, rho, nz)]
            r64 = [a.double() if a.is_floating_point() else a for a in r32]
            ref = ck.grad_from_kinv(L64.T @ L64, *r64, kern)

            def worst(got):
                return [float(((a.double() - b).abs() / b.abs()).max())
                        for a, b in zip(got, ref)]

            key = f"{kern} {name} ls={ls}"
            out[key] = {
                "grad_from_kinv": worst(ck.grad_from_kinv(
                    (L64.T @ L64).float(), *r32, kern)),
                "syrk_grad_fused": worst(ck.syrk_grad_fused(Linv, *r32,
                                                            kern))}
            check(f"C5 {key}", max(max(e) for e in out[key].values())
                  <= C5_BAR, f"worst relative error per component "
                  f"(g_logvar, g_logls, g_lognoise) vs float64: {out[key]}"
                  f" (<= {C5_BAR})")
    emit("fit", part="c5", nvidia_smi=nvidia_smi(), cases=out)
    return out


def fit_phase(torch, ck, mf, gp, cov, dev, problem):
    """Phase 6 (see the module docstring); returns the launches of the fit
    paths, counted from 0 over the fits and the single-fidelity unit."""
    from bench import _theta

    autodiff_checks(torch, mf, cov, dev)
    c5_checks(torch, ck, dev)
    Xt, ft, yt, gt, _, params = problem
    v, l, _, nz = _theta()
    f32 = torch.float32

    def sf_params():
        return gp.gp_params_from_numpy(np.log(v[2]), np.log(l[2]),
                                       np.log(nz[2]), dev, f32)

    restarts = dict(n_restarts=2, maxiter=3, tol=1e-3)
    fits = (
        ("mfgp_optimize_restarts", "rbf",
         lambda k: mf.MFGP(Xt, ft, yt, kernel=k, params=params, jitter=1e-6),
         lambda m: m.optimize_restarts(**restarts)),
        ("mfgp_optimize_restarts", "matern32",
         lambda k: mf.MFGP(Xt, ft, yt, kernel=k, params=params, jitter=1e-6),
         lambda m: m.optimize_restarts(**restarts)),
        ("mfgp_optimize", "rbf",
         lambda k: mf.MFGP(Xt, ft, yt, kernel=k, params=params, jitter=1e-6),
         lambda m: m.optimize(maxiter=3)),
        # from numpy arrays, which go to the classes' default device, the
        # card
        ("gp_optimize_restarts", "rbf",
         lambda k: gp.GP(Xt.cpu().numpy(), yt.cpu().numpy(), kernel=k,
                         params=sf_params(), jitter=1e-6),
         lambda m: m.optimize_restarts(**restarts)),
    )
    probe = PathProbe(torch, ck, cov, (mf, gp), sync_evals=True)
    ck.reset_launches()
    try:
        for name, kern, make, fit in fits:
            one_fit(torch, ck, probe, make(kern), name, kern, fit, gt)
    finally:
        probe.restore()
    info, grad, state = gp_unit(torch, gp, problem, sf_params())
    launches = dict(ck.LAUNCHES)
    check("fit paths launches", launches["ar1_cov_fused"] > 0
          and launches["syrk_grad_fused"] > 0,
          f"B1 and B2 launched over the fits and the GP unit: {launches}")
    gp_unit_check(torch, ck, problem, sf_params(), grad, state,
                  dict(info, launches=launches))
    return launches


# ---------------------------------------------------------------------------
# phases 7-9: the study path
# ---------------------------------------------------------------------------
STUDY_ARGS = ["--trajectories", "1", "--vmn", "0.2", "--field-seeds", "0",
              "--duration", "3600"]
STUDY_RUNS = 1  # trajectories x noise levels x field seeds of STUDY_ARGS
# the study dataset that the float64 yardstick and the profiler window
# take: trajectory 0 at the higher velocity-noise level
STUDY_PICK = "0.2_fieldMeas_0_T0_0.2"


def fit_checks(label: str, fits, b1_per_eval: int = 1) -> None:
    """Every optimiser run of ``fits``: finite lanes, the best NLML no
    higher than at the start, B1 launched at least ``b1_per_eval`` times
    per evaluation (0: the float64 path, B1 not at all)."""
    bad_lane, climbed, no_b1 = [], [], []
    for i, r in enumerate(fits):
        lanes = [f for f in r["lanes"] if np.isfinite(f) and f < 1e19]
        if len(lanes) < len(r["lanes"]):
            bad_lane.append((i, r["family"], r["lanes"]))
        if not lanes or min(lanes) > r["f0"]:
            climbed.append((i, r["family"], r["f0"], r["lanes"]))
        if b1_per_eval and r["b1"] < b1_per_eval * r["evals"]:
            no_b1.append((i, r["family"], r["b1"], r["evals"]))
        if not b1_per_eval and r["b1"]:
            no_b1.append((i, r["family"], r["b1"], r["evals"]))
    n = len(fits)
    check(f"{label} lanes finite", not bad_lane,
          f"{n} optimiser runs; runs with a non-finite lane: {bad_lane}")
    check(f"{label} NLML", not climbed,
          f"best NLML <= NLML at the start in {n - len(climbed)} of {n} "
          f"runs; others: {climbed}")
    want = (f">= {b1_per_eval} per evaluation" if b1_per_eval
            else "none (float64 takes the plain composition)")
    check(f"{label} B1 in every fit", not no_b1,
          f"B1 launches {want} in {n - len(no_b1)} of {n} runs; others "
          f"(run, family, B1, evaluations): {no_b1}")


def by_family(fits, key: str) -> dict:
    out = {}
    for r in fits:
        out[r["family"]] = out.get(r["family"], 0) + r[key]
    return out


def device_idle_share(torch, fn) -> dict:
    """``fn()`` under ``torch.profiler`` (device activity only): wall
    seconds, the summed kernel and copy time on the device, and the idle
    share ``1 - busy / wall``. Where the profiler reports no device time
    the shares are None and the phase says "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return getattr(e, name)
        return 0.0

    busy = sum(us(e) for e in rows) / 1e6
    top = sorted(rows, key=us, reverse=True)[:6]
    measured = busy > 0
    return {"wall_s": wall, "device_busy_s": busy if measured else None,
            "idle_share": 1.0 - busy / wall if measured else None,
            "device_events": int(sum(e.count for e in rows)),
            "top": [[e.key[:60], us(e) / 1e6, int(e.count)] for e in top],
            "note": None if measured else
            "torch.profiler reported no device time: not measured"}


def kalman_times(torch, dev) -> dict:
    """The filter alone at the study's length: 36,000 steps, two
    trajectories on the batch axis, float64, as CUDA graphs (the default,
    twice), and eagerly over the first tenth of the steps, with the largest
    difference between the two over those steps."""
    from mfgp_tpu_torch.data.study import scripted_trajectory
    from mfgp_tpu_torch.estimation.kalman import filter_trajectory
    from mfgp_tpu_torch.utils.configs import SimConfig

    cfg = SimConfig(seed=0, vmn=0.2)
    trajs = [scripted_trajectory(s, cfg, duration=3600.1).data
             for s in (0, 1)]
    t = np.stack([tr[:, 0] for tr in trajs])
    pos = np.stack([tr[:, 1:] for tr in trajs])
    noise = np.random.default_rng(0).standard_normal((2, t.shape[1] - 1, 6))
    model = cfg.kf_model()
    n = t.shape[1] - 1
    cut = n // 10 + 1  # the eager loop runs a tenth of the steps
    runs = (("graphs_128", None, n + 1), ("graphs_128_again", None, n + 1),
            ("eager_tenth", 0, cut))
    out, secs = {}, {}
    for name, steps, rows in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = filter_trajectory(model, t[:, :rows], pos[:, :rows],
                                      noise=noise[:, :rows - 1],
                                      graph_steps=steps)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    diff = max(max_err(out["graphs_128"][k][:, :cut - 1],
                       out["eager_tenth"][k]) for k in ("xh", "sig", "err"))
    finite = all(bool(torch.isfinite(v).all())
                 for v in out["graphs_128"].values())
    check("kalman graphs = eager", finite and diff <= 1e-9,
          f"{n} steps x 2 trajectories on {model.P0.device}: finite "
          f"{finite}; graphs against the eager loop over the first "
          f"{cut - 1} steps: max abs difference {diff:.3e} (<= 1e-9)")
    return {"steps": int(n), "batch": 2, "eager_steps": int(cut - 1),
            "seconds": secs,
            "us_per_step": {"graphs_128": secs["graphs_128_again"] / n * 1e6,
                            "eager": secs["eager_tenth"] / (cut - 1) * 1e6},
            "max_abs_diff": diff}


def study_b1_times(torch, ck, dev, N: int, M: int) -> dict:
    """B1 at the study's launch shapes: the N x N Gram with noise at F=1
    and F=3, the M x N cross-covariance and the M x M Gram of the grid
    (F=3 for the MFGP, F=1 for the other three), rbf, float32: each first
    held against the plain version (``b1_path_check``), then the first four
    timed; bytes and flop as ``b1_launches`` counts them."""
    rng = np.random.default_rng(5)
    f32 = torch.float32

    def t(a, dt=f32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    D, F = 3, 3
    X, G = t(rng.uniform(0, 10, (N, D))), t(rng.uniform(0, 10, (M, D)))
    fid, gfid = t(rng.integers(0, F, N), torch.long), t(np.full(M, F - 1),
                                                        torch.long)
    v, ls, rho = t(np.array([2.0, 1.5, 0.7])), t(rng.uniform(1, 3, (F, D))), \
        t(np.array([1.0, 1.0]))
    noise = t(rng.uniform(0.1, 0.2, N))
    per = 3 * D + 5
    z = torch.zeros(N, dtype=torch.long, device=dev)

    def pts(n):
        return (n * D + n) * 4 + n * 8

    zm = torch.zeros(M, dtype=torch.long, device=dev)
    one = (v[2:], ls[2:], rho[:0])
    for a in ((X, z, X, z, *one, noise), (X, fid, X, fid, v, ls, rho, noise),
              (G, gfid, X, fid, v, ls, rho), (G, gfid, G, gfid, v, ls, rho),
              (G, zm, X, z, *one), (G, zm, G, zm, *one)):
        b1_path_check(torch, ck, "study", *a)

    launches = (
        (f"gram_{N}_F1", lambda: ck.rbf_cov_fused(X, X, v[2], ls[2], noise),
         lambda: ck.ar1_cov_fused_plain(X, z, X, z, v[2:], ls[2:], rho[:0],
                                        noise),
         4 * N * N + pts(N), N * (N + 1) / 2 * per),
        (f"gram_{N}_F3", lambda: ck.ar1_cov_fused(X, fid, X, fid, v, ls, rho,
                                                  noise),
         lambda: ck.ar1_cov_fused_plain(X, fid, X, fid, v, ls, rho, noise),
         4 * N * N + pts(N), N * (N + 1) / 2 * F * per),
        (f"cross_{M}x{N}_F3", lambda: ck.ar1_cov_fused(G, gfid, X, fid, v,
                                                       ls, rho),
         lambda: ck.ar1_cov_fused_plain(G, gfid, X, fid, v, ls, rho),
         4 * M * N + pts(N) + pts(M), M * N * F * per),
        (f"gram_{M}_F3", lambda: ck.ar1_cov_fused(G, gfid, G, gfid, v, ls,
                                                  rho),
         lambda: ck.ar1_cov_fused_plain(G, gfid, G, gfid, v, ls, rho),
         4 * M * M + pts(M), M * (M + 1) / 2 * F * per),
    )
    return b1_times(torch, ck, None, "rbf", launches=launches, reps=50)


def study_phase(torch, ck, cov, dev) -> dict:
    """Phase 7 (see the module docstring). Returns the launches of the
    study's run, counted from 0 just before it, and what the later phases
    need of it."""
    from mfgp_tpu_torch import cli
    from mfgp_tpu_torch.data import io as tio
    from mfgp_tpu_torch.data import study, trainers
    from mfgp_tpu_torch.models import gp, nigp
    from mfgp_tpu_torch.models import mfgp as mf

    out_dir = tempfile.mkdtemp(prefix="mfgp_study_")
    probe = PathProbe(torch, ck, cov, (mf, gp, nigp), trainers, study)
    buf = io.StringIO()
    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["study", "--out", out_dir, "--fit-mode", "device"]
                     + STUDY_ARGS)
    finally:
        probe.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    summary = json.loads(buf.getvalue())

    res = os.path.join(out_dir, "GPResults")
    names = sorted(f for f in os.listdir(res) if f.startswith("MSE_"))
    parsed = {f: tio.parse_mse(os.path.join(res, f)) for f in names}
    with open(os.path.join(res, "results.csv")) as f:
        rows = f.read().splitlines()
    R = STUDY_RUNS
    check("study artifacts", len(names) == R and len(rows) == R + 1
          and all(len(p) == 8 for p in parsed.values())
          and summary["overall"]["n"] == R,
          f"{len(names)} MSE files of 8 metrics each, results.csv with "
          f"{len(rows) - 1} rows, summary n={summary['overall']['n']} "
          f"({R} runs of the reference's 90-run design: the only cut)")
    rm = [v for p in parsed.values() for k, v in p.items()
          if k.startswith("RMSE")]
    wm = [v for p in parsed.values() for k, v in p.items()
          if k.startswith("WRMSE")]
    repairs = probe.timings["wmse_f64_count"]
    check("study RMSE finite", len(rm) == 4 * R
          and bool(np.isfinite(rm).all()),
          f"{len(rm)} RMSE values, finite: {bool(np.isfinite(rm).all())}")
    check("study WRMSE finite", len(wm) == 4 * R
          and bool(np.isfinite(wm).all())
          and repairs == sum(e["f64"] for e in probe.evals),
          f"{len(wm)} WRMSE values finite after {repairs} float64 "
          f"repair(s) of {4 * R}, made on the card "
          f"(wmse_f64_count={repairs})")
    fit_checks("study", probe.fits)
    check("study fits per dataset", len(probe.fits) == 4 * R
          and len(probe.trains) == R,
          f"{len(probe.fits)} optimiser runs over {len(probe.trains)} "
          f"datasets: {by_family(probe.fits, 'evals')} evaluations")
    check("study B1 in every evaluation",
          len(probe.evals) == R and all(e["b1"] >= 12 for e in probe.evals),
          f"B1 launches per evaluate_models call "
          f"{[e['b1'] for e in probe.evals]} (>= 12: four Grams, four "
          "cross-covariances, four grid Grams)")
    devices = sorted({d for r in probe.trains for d in r["devices"]})
    dtypes = sorted({d for r in probe.trains for d in r["dtypes"]})
    check("study on the card", devices == [str(dev)] and dtypes
          == ["torch.float32"] and all(r["on_cuda"] for r in probe.fits),
          f"model tensors on {devices} in {dtypes}; every optimiser run "
          "on CUDA parameters (a wrapper counts only where it launches, so "
          "no launch was made on a CPU tensor)")
    check("study launches", launches["ar1_cov_fused"] > 0,
          f"kernel launches over the study: {launches} (its fits' analytic "
          "gradient takes Linv and B2 on the card; B3 is not on this path)")

    tm = probe.timings
    fits_s = by_family(probe.fits, "seconds")
    train_s = sum(r["seconds"] for r in probe.trains)
    eval_s = sum(e["seconds"] for e in probe.evals)
    stages = {"filter_s": tm["filter_s"],
              "field_binning_and_their_files_s": tm["pipeline_s"],
              "fits_s": fits_s,
              "train_models_other_s": train_s - sum(fits_s.values()),
              "evaluation_s": eval_s,
              "load_and_artifacts_s": tm["trainers_s"] - train_s - eval_s,
              "aggregate_s": tm["aggregate_s"]}
    emit("study", wall_s=wall, stages=stages, nvidia_smi=nvidia_smi(),
         n_per_dataset=[r["n"] for r in probe.trains], grid=2000,
         # in run order: the noise levels as given, trajectories within
         train_s_per_dataset=[r["seconds"] for r in probe.trains],
         launches=launches, wmse_f64_count=repairs,
         f64_repairs_per_dataset=[e["f64"] for e in probe.evals],
         evaluations=by_family(probe.fits, "evals"),
         b1_in_fits=by_family(probe.fits, "b1"),
         b1_per_evaluate_models=[e["b1"] for e in probe.evals],
         iterations=[[r["family"], r["iterations"]] for r in probe.fits],
         metrics=parsed, summary_overall=summary["overall"])
    pick_n = probe.trains[names.index(f"MSE_{STUDY_PICK}.txt")]["n"]
    return {"launches": launches, "out_dir": out_dir, "n": pick_n,
            "rmse_mf": parsed[f"MSE_{STUDY_PICK}.txt"]["RMSE mf"],
            "metrics": parsed[f"MSE_{STUDY_PICK}.txt"]}


def study_f64_phase(torch, ck, cov, dev, st: dict) -> None:
    """Phase 7, the yardstick: one study dataset in float64 through scipy's
    L-BFGS-B on the card (no kernel by the gate's rule), then B1's times at
    the study's shapes and the idle share over one float32 dataset."""
    from mfgp_tpu_torch.data import trainers
    from mfgp_tpu_torch.models import gp, nigp
    from mfgp_tpu_torch.models import mfgp as mf
    from mfgp_tpu_torch.utils.configs import SimConfig

    data = os.path.join(st["out_dir"], "GPDataSets",
                        f"GPData_{STUDY_PICK}.csv")
    settings = os.path.join(st["out_dir"], "FieldData", "FieldSettings0.txt")
    cfg = SimConfig(seed=0, vmn=0.2)
    probe = PathProbe(torch, ck, cov, (mf, gp, nigp), trainers)
    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        models, metrics = trainers.process_dataset(
            data, settings, None, cfg=cfg, fit_mode="scipy",
            dtype=np.float64)
    finally:
        probe.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1 = ck.LAUNCHES["ar1_cov_fused"]
    check("study_f64 on the card, plain path",
          models.mf.X.is_cuda and models.mf.X.dtype == torch.float64
          and b1 == 0,
          f"data on {models.mf.X.device} in {models.mf.X.dtype}; B1 "
          f"launches {b1} (0: float64 takes the plain composition by "
          "use_cuda_kernels' rule)")
    fit_checks("study_f64", probe.fits, b1_per_eval=0)
    ratio = st["rmse_mf"] / metrics["RMSE mf"]
    check("study MFGP RMSE vs float64", 0.5 <= ratio <= 2.0,
          f"float32 device mode {st['rmse_mf']:.4f} / float64 scipy "
          f"{metrics['RMSE mf']:.4f} = {ratio:.3f} on dataset {STUDY_PICK} "
          "(within a factor of 2: the two modes run different optimisers "
          "from different starts)")
    emit("study_f64", wall_s=wall, dataset=STUDY_PICK, n=st["n"],
         metrics=metrics, fits_s=by_family(probe.fits, "seconds"),
         evaluations=by_family(probe.fits, "evals"),
         evaluation_s=sum(e["seconds"] for e in probe.evals),
         rmse_mf_f32_over_f64=ratio)

    emit("study_b1_times", nvidia_smi=nvidia_smi(),
         times=study_b1_times(torch, ck, dev, st["n"], 2000))
    emit("kalman_times", nvidia_smi=nvidia_smi(), **kalman_times(torch, dev))
    emit("study_idle", nvidia_smi=nvidia_smi(),
         **study_idle_window(torch, trainers, data, settings, cfg))


def study_idle_window(torch, trainers, data, settings, cfg) -> dict:
    """The device's idle share over one study dataset's work at a bounded
    depth, under ``torch.profiler``: the float32 restart fits of the MFGP
    and the SFGP (2 lanes x 10 iterations each), the NIGP's native fit (1
    lane x 5 iterations) and the whole ``evaluate_models``, through the
    same methods ``train_models`` calls. (A whole dataset at the default
    depth makes millions of kernel events.)"""
    from mfgp_tpu_torch.data.io import load_gp_dataset
    from mfgp_tpu_torch.fields.wrbf import parse_field_settings

    ds = load_gp_dataset(data, t_cut=cfg.t_cut)
    field = parse_field_settings(settings)
    models = trainers.train_models(ds, optimize=False, dtype=np.float32)
    X, y = ds.X_est.astype(np.float32), ds.y.astype(np.float32)

    def window():
        models.mf.optimize_restarts(n_restarts=2, maxiter=10, tol=1e-3)
        models.sf.optimize_restarts(n_restarts=2, maxiter=10, tol=1e-3)
        models.nigp.fit_native(X, y, n_restarts=1, maxiter=5)
        trainers.evaluate_models(models, cfg.test_points(), field)

    window()  # warm: the first calls pay cuSOLVER's and cuBLAS' set-up
    out = device_idle_share(torch, window)
    out["window"] = ("MFGP and SFGP optimize_restarts (2 lanes x 10 "
                     "iterations), NIGP.fit_native (1 x 5), "
                     f"evaluate_models; float32, dataset {STUDY_PICK}, "
                     f"N={ds.n}")
    return out


def nigp_gradient_checks(torch, nigp, dev) -> dict:
    """Phase 8, checks: the float32 autodiff gradients of ``nlml`` and
    ``nlml_native`` on the card (B1 forward, closed-form backward) at the
    benchmark's problem cut to N=2,000 against the float64 plain path:
    max |err| / max |ref| <= 2e-3 per group of entries (lengthscales,
    sigma_f, sigma_y, sigma_x)."""
    from bench import _theta, build_problem

    Xn, _, yn, _, _ = build_problem(2000, 16, seed=1)
    v, l, _, nz = _theta()
    lh = np.concatenate([np.log(l[2]), [np.log(v[2]), 0.5 * np.log(nz[2])],
                         np.log(0.1 * l[2])])
    groups = (slice(0, 3), slice(3, 4), slice(4, 5), slice(5, 8))
    errs = {}
    for name in ("nlml", "nlml_native"):
        out = {}
        for dt in (torch.float32, torch.float64):
            X = torch.as_tensor(Xn, dtype=dt, device=dev)
            y = torch.as_tensor(yn, dtype=dt, device=dev)
            h = torch.tensor(lh, dtype=dt, device=dev, requires_grad=True)
            if name == "nlml":
                with torch.no_grad():
                    _, gf = nigp.posterior_mean_grads(
                        X, y, torch.exp(h[:3]), torch.exp(h[3]),
                        torch.exp(h[4]))
                val = nigp.nlml(h, X, y, gf)
            else:
                val = nigp.nlml_native(h, X, y)
            out[dt] = (float(val.detach()), torch.autograd.grad(val, h)[0])
        g32, g64 = out[torch.float32][1], out[torch.float64][1]
        e = field_errs([g32[g] for g in groups], [g64[g] for g in groups])
        rel = abs(out[torch.float32][0] - out[torch.float64][0]) / abs(
            out[torch.float64][0])
        check(f"nigp autodiff gradient {name} N=2000",
              max(e) <= 2e-3 and rel <= 1e-3,
              f"per group (ls, sigma_f, sigma_y, sigma_x) vs f64 {e} "
              f"(<= 2e-3); value rel err {rel:.3e} (<= 1e-3)")
        errs[name] = {"groups": e, "value_rel_err": rel,
                      "grad_f64": g64.cpu().numpy().round(6).tolist()}
    return errs


def nigp_eval_phases(torch, nigp, X, y) -> dict:
    """Phase 8: one evaluation's forward and backward at full size on CUDA
    events, native and alternating, at the fits' starting point (the
    second of two evaluations each)."""
    lh0 = nigp._init_log_hyp(X, y)
    with torch.no_grad():
        h = torch.as_tensor(lh0, dtype=X.dtype, device=X.device)
        _, gf = nigp.posterior_mean_grads(X, y, torch.exp(h[:3]),
                                          torch.exp(h[3]), torch.exp(h[4]))
    out = {}
    for name, fn in (("native", lambda h: nigp.nlml_native(h, X, y)),
                     ("alternating", lambda h: nigp.nlml(h, X, y, gf))):
        for _ in range(2):
            h = torch.tensor(lh0, dtype=X.dtype, device=X.device,
                             requires_grad=True)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev[0].record()
            val = fn(h)
            ev[1].record()
            torch.autograd.grad(val, h)
            ev[2].record()
            torch.cuda.synchronize()
        out[name] = {"forward_ms": ev[0].elapsed_time(ev[1]),
                     "backward_ms": ev[1].elapsed_time(ev[2]),
                     "sum_ms": ev[0].elapsed_time(ev[2]),
                     "nlml": float(val.detach()),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del val
    return out


def nigp_phase(torch, ck, cov, dev, problem) -> dict:
    """Phase 8 (see the module docstring); returns the launches of the two
    fits and the two grid posteriors, counted from 0."""
    from mfgp_tpu_torch.models import nigp

    Xt, _, yt, gt, _, _ = problem
    N, M = Xt.shape[0], gt.shape[0]
    grad_errs = nigp_gradient_checks(torch, nigp, dev)
    torch.cuda.empty_cache()
    phases = nigp_eval_phases(torch, nigp, Xt, yt)
    # B1 at this path's launch shapes (F=1) against its plain version: the
    # Gram as _AR1TrainCov and sf_train_cov ask for it (without and with
    # noise), predict's whole cross-covariance, predict_blocked's row block
    p = problem[5]
    one = (p.variances[2:], p.lengthscales[2:], p.rhos[:0])
    zn = torch.zeros(N, dtype=torch.long, device=dev)
    zm = torch.zeros(M, dtype=torch.long, device=dev)
    noise = torch.full((N,), 0.05, device=dev) + 1e-8
    b1_errs = [b1_path_check(torch, ck, "nigp", *a) for a in (
        (Xt, zn, Xt, zn, *one), (Xt, zn, Xt, zn, *one, noise),
        (gt, zm, Xt, zn, *one),
        (gt[:1024].contiguous(), zm[:1024], Xt, zn, *one))]
    torch.cuda.empty_cache()
    emit("nigp", part="eval_phases", N=N, nvidia_smi=nvidia_smi(),
         eval_ms=phases, gradient_checks=grad_errs, b1_max_abs_err=b1_errs)

    probe = PathProbe(torch, ck, cov, (nigp,))
    ck.reset_launches()
    info = {}
    try:
        for name, make, fit, b1_per_eval in (
                ("fit_native", lambda: nigp.NIGP(n_restarts=2),
                 lambda m: m.fit_native(Xt, yt, n_restarts=2, maxiter=3), 2),
                ("fit", lambda: nigp.NIGP(n_restarts=1, iters=1),
                 lambda m: m.fit(Xt, yt, maxiter_opt=3), 1)):
            probe.fits.clear()
            b1, bw = ck.LAUNCHES["ar1_cov_fused"], probe.backwards
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = fit(make())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            label = f"nigp {name}"
            fit_checks(label, probe.fits, b1_per_eval)
            evals = sum(r["evals"] for r in probe.fits)
            backwards = probe.backwards - bw
            check(f"{label} backward through B1's Function",
                  backwards == b1_per_eval * evals and evals > 0,
                  f"{backwards} closed-form backwards for {evals} "
                  f"evaluations ({b1_per_eval} per evaluation)")
            p = m.get_params()
            check(f"{label} params", bool(np.isfinite(p).all())
                  and bool((p >= 1e-6 * (1 - 1e-5)).all())
                  and bool((p <= 1e6 * (1 + 1e-5)).all())
                  and m.X_train_.is_cuda
                  and m.X_train_.dtype == torch.float32,
                  f"finite and inside [1e-6, 1e6]: {p.round(6).tolist()}; "
                  f"data on {m.X_train_.device} in {m.X_train_.dtype}")
            eval_s = sum(r["seconds"] for r in probe.fits)
            info[name] = dict(
                seconds=seconds, evaluations=evals,
                s_per_evaluation=eval_s / max(evals, 1),
                optimiser_seconds=eval_s, peak_mem_gb=peak,
                b1_launches=ck.LAUNCHES["ar1_cov_fused"] - b1,
                lanes=[r["lanes"] for r in probe.fits],
                nlml_start=[r["f0"] for r in probe.fits],
                iterations=[r["iterations"] for r in probe.fits],
                params=p.round(6).tolist())
            if name == "fit_native":
                model = m
            del m
    finally:
        probe.restore()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu_b, var_b = model.predict_blocked(gt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mu, var = model.predict(gt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    finite = all(bool(np.isfinite(a).all()) for a in (mu, var, mu_b, var_b))
    check("nigp predict", finite and bool((var >= 1e-12).all())
          and bool((var_b >= 1e-12).all()) and mu.shape == (M,),
          f"{M} grid points: finite {finite}, min var {var.min():.3e} and "
          f"{var_b.min():.3e} (floor 1e-12)")
    e_mu = float(np.abs(mu - mu_b).max() / np.abs(mu).max())
    e_var = float(np.abs(var - var_b).max() / model.sigma_f_)
    check("nigp predict = predict_blocked", e_mu <= 1e-3 and e_var <= 2e-2,
          f"max |mean diff| / max |mean| {e_mu:.3e} (<= 1e-3), max |var "
          f"diff| / sigma_f {e_var:.3e} (<= 2e-2: float32 kss - |V|^2 "
          "through a triangular solve against a product with Linv)")
    launches = dict(ck.LAUNCHES)
    check("nigp launches", launches["ar1_cov_fused"] > 0, f"{launches}")
    emit("nigp", part="fits", N=N, M=M, nvidia_smi=nvidia_smi(), fits=info,
         predict_blocked_s=t1 - t0, predict_s=t2 - t1, predict_mean_err=e_mu,
         predict_var_err=e_var, launches=launches)
    del model, mu, var, mu_b, var_b
    torch.cuda.empty_cache()
    idle = device_idle_share(torch, lambda: nigp.NIGP(
        n_restarts=1, iters=1).fit(Xt, yt, maxiter_opt=2))
    emit("nigp_idle", window="NIGP.fit, 1 outer iteration x 1 restart, "
         f"maxiter_opt=2, N={N}", nvidia_smi=nvidia_smi(), **idle)
    return launches


def recursive_phase(torch, ck, cov, dev, problem) -> dict:
    """Phase 9: the recursive MFGP on the problem's three fidelity lists
    (built from numpy arrays, which go to the card), float32; returns its
    launches, counted from 0."""
    from mfgp_tpu_torch.models import gp
    from mfgp_tpu_torch.models.mfgp_recursive import RecursiveMFGP

    Xt, ft, yt, gt, _, _ = problem
    Xn, fn, yn = (a.cpu().numpy() for a in (Xt, ft, yt))
    X_list = [Xn[fn == f] for f in range(3)]
    y_list = [yn[fn == f] for f in range(3)]
    probe = PathProbe(torch, ck, cov, (gp,))
    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        m = RecursiveMFGP.from_fidelity_lists(X_list, y_list,
                                              dtype=torch.float32)
        m.optimize(n_restarts=2, maxiter=3)
    finally:
        probe.restore()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mu, var = m.predict(gt.cpu().numpy())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ck.LAUNCHES)
    fit_checks("recursive", probe.fits)
    # B1 at a level's launch shapes (F=1, the level's fitted parameters)
    lvl = m.levels[0]
    n0 = lvl.X.shape[0]
    z0 = torch.zeros(n0, dtype=torch.long, device=dev)
    zm = torch.zeros(gt.shape[0], dtype=torch.long, device=dev)
    one = (lvl.params.variance.reshape(1),
           lvl.params.lengthscales.reshape(1, -1), lvl.X.new_zeros(0))
    noise = lvl.params.noise.expand(n0) + lvl.jitter
    b1_errs = [b1_path_check(torch, ck, "recursive", lvl.X, z0, lvl.X, z0,
                             *one, noise.contiguous()),
               b1_path_check(torch, ck, "recursive", gt, zm, lvl.X, z0, *one)]
    finite = bool(np.isfinite(mu).all()) and bool(np.isfinite(var).all())
    on_card = all(lvl.X.is_cuda and lvl.X.dtype == torch.float32
                  for lvl in m.levels)
    check("recursive predict", finite and bool((var >= 0).all())
          and on_card and len(probe.fits) == 3,
          f"{len(probe.fits)} level fits of {[len(x) for x in X_list]} "
          f"points on the card: {on_card}; grid posterior finite {finite}, "
          f"min var {var.min():.3e} (>= 0)")
    check("recursive launches", launches["ar1_cov_fused"] > 0,
          f"B1 at F=1: {launches}")
    emit("recursive", nvidia_smi=nvidia_smi(), fit_s=t1 - t0,
         predict_s=t2 - t1, levels=[len(x) for x in X_list],
         evaluations=[r["evals"] for r in probe.fits],
         lanes=[r["lanes"] for r in probe.fits],
         nlml_start=[r["f0"] for r in probe.fits], launches=launches,
         b1_max_abs_err=b1_errs, param_array=m.param_array.round(6).tolist())
    return launches


# ---------------------------------------------------------------------------
# phase 10: the batched study and B1's lane axis
# ---------------------------------------------------------------------------
def lane_problem(torch, dev, L: int, N: int, M: int, F: int, seed: int):
    """L lanes of B1 inputs at a study shape: each lane its own training
    points (N), a grid (M) shared by every lane as a broadcast view, labels
    and hyperparameters, float32 on the card."""
    rng = np.random.default_rng(seed)
    D = 3

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    X = t(rng.uniform(0, 10, (L, N, D)))
    G = t(rng.uniform(0, 10, (M, D))).expand(L, M, D)
    fid = t(rng.integers(0, F, (L, N)), torch.long)
    gfid = t(np.full((L, M), F - 1), torch.long)
    return dict(X=X, G=G, fid=fid, gfid=gfid,
                v=t(rng.uniform(0.5, 3.0, (L, F))),
                ls=t(rng.uniform(1.0, 5.0, (L, F, D))),
                rho=t(rng.uniform(0.8, 1.2, (L, F - 1))),
                noise=t(rng.uniform(0.1, 0.2, (L, N))))


def lane_shapes(p):
    """The study's seven B1 launch shapes over lanes, as (name, lane-axis
    arguments): the N x N Gram with noise at F=1 and F=3, the NIGP's N x N
    Gram without noise (F=1), the M x N cross-covariance and the M x M grid
    Gram at F=3 (the MFGP) and F=1 (the other three families)."""
    X, G, fid, gfid = p["X"], p["G"], p["fid"], p["gfid"]
    v, ls, rho, nz = p["v"], p["ls"], p["rho"], p["noise"]
    z, zg = fid.new_zeros(fid.shape), gfid.new_zeros(gfid.shape)
    one = (v[:, 2:], ls[:, 2:], rho[:, :0])
    N, M = X.shape[1], G.shape[1]
    return ((f"gram_{N}_F1", (X, z, X, z, *one, nz)),
            (f"gram_{N}_F3", (X, fid, X, fid, v, ls, rho, nz)),
            (f"nigp_gram_{N}_F1", (X, z, X, z, *one, None)),
            (f"cross_{M}x{N}_F3", (G, gfid, X, fid, v, ls, rho, None)),
            (f"gram_{M}_F3", (G, gfid, G, gfid, v, ls, rho, None)),
            (f"cross_{M}x{N}_F1", (G, zg, X, z, *one, None)),
            (f"gram_{M}_F1", (G, zg, G, zg, *one, None)))


def lane_check_sets(N: int, M: int):
    """(lane count, shape names or None for all seven) at which
    ``b1_lane_checks`` holds B1's lane axis: 1, 3 and 64 lanes at every
    shape, then the lane counts the batched study's main path
    (``BATCHED_ARGS``) gives it: every shape at the evaluation chunk, the
    fits' Grams at fit_chunk x n_restarts lanes and the NIGP's at
    fit_chunk x nigp_restarts."""
    fits, evals = BATCHED_CHUNKS
    restarts, nigp_restarts = BATCHED_RESTARTS
    return ((1, None), (3, None), (64, None), (evals, None),
            (fits * restarts, (f"gram_{N}_F1", f"gram_{N}_F3")),
            (fits * nigp_restarts, (f"nigp_gram_{N}_F1",)))


def b1_lane_checks(torch, ck, dev, N: int = 705, M: int = 2000) -> dict:
    """B1's lane axis at each of ``lane_check_sets``: every lane
    bit-identical to a single-lane launch on that lane's inputs, every
    symmetric lane (the same tensors twice) bit-identical to its full grid
    (distinct tensors of equal values), and every lane within 1e-5 x max(1,
    largest entry) of the plain version in float64. Launches are counted:
    one per lane-axis call. Returns the max abs error against float64 per
    shape and lane count."""
    worst_abs, worst_rel = {}, {}
    differ, full_differ, launches_ok = [], [], True
    for L, names in lane_check_sets(N, M):
        p = lane_problem(torch, dev, L, N, M, 3, seed=L)
        for name, (A, fa, B, fb, v, ls, rho, nz) in lane_shapes(p):
            if names is not None and name not in names:
                continue
            n0 = ck.LAUNCHES["ar1_cov_fused"]
            got = ck.ar1_cov_fused_lanes(A, fa, B, fb, v, ls, rho, nz)
            launches_ok &= ck.LAUNCHES["ar1_cov_fused"] == n0 + 1
            if A is B:
                full = ck.ar1_cov_fused_lanes(A, fa, B.clone(), fb.clone(), v,
                                              ls, rho, nz)
                if not torch.equal(got.view(torch.int32),
                                   full.view(torch.int32)):
                    full_differ.append((L, name))
                del full
            err, top = 0.0, 1.0
            for l in range(L):
                a = A[l].contiguous()
                b = a if A is B else B[l].contiguous()
                fl = fa[l].contiguous()
                fbl = fl if A is B else fb[l].contiguous()
                one = ck.ar1_cov_fused(a, fl, b, fbl, v[l], ls[l], rho[l],
                                       None if nz is None else nz[l])
                if not torch.equal(got[l].view(torch.int32),
                                   one.view(torch.int32)):
                    differ.append((L, name, l))
                ref = ck.ar1_cov_fused_plain(
                    A[l].double(), fa[l], B[l].double(), fb[l],
                    v[l].double(), ls[l].double(), rho[l].double(),
                    None if nz is None else nz[l].double())
                err = max(err, max_err(got[l], ref))
                top = max(top, float(ref.abs().max()))
                del one, ref
            key = f"{name}_L{L}"
            worst_abs[key], worst_rel[key] = err, err / top
            del got
    torch.cuda.synchronize()
    sets = [(L, "all" if names is None else list(names))
            for L, names in lane_check_sets(N, M)]
    bad = {k: e for k, e in worst_rel.items() if e > 1e-5}
    check("B1 lanes = single-lane launches", not differ,
          f"(lanes, shapes) {sets} (N={N}, M={M}): every lane bit-identical "
          f"to a single-lane launch; differing (L, shape, lane): "
          f"{differ[:8]}")
    check("B1 lanes symmetric = full grid", not full_differ,
          f"each symmetric lane bit-identical to its full grid; differing "
          f"(L, shape): {full_differ}")
    check("B1 lanes vs plain f64", not bad,
          f"max abs err / max(1, largest entry) per shape and lane count "
          f"{worst_rel} (<= 1e-5)")
    check("B1 lanes one launch per call", launches_ok,
          "each lane-axis call counts exactly one launch")
    B1_PATH_ERRS.extend(worst_abs.values())
    return worst_abs


def b1_lane_times(torch, ck, dev, L: int = 288, N: int = 705,
                  M: int = 2000) -> dict:
    """B1's lane axis at L lanes (the batched study's 36 x 8 restart
    lanes) at the fits' two Gram shapes (N x N + noise, F=1 and F=3), and
    at the evaluation's grid shapes for one evaluation chunk of lanes:
    one lane-axis launch on CUDA events beside the same work as L
    single-lane wrapper calls (the per-dataset path's way) and the plain
    version's loop, with the bound (bytes: each output written once, the
    inputs read once) and the share of it reached."""
    out = {}
    per = 3 * 3 + 5
    for lanes, names in ((L, (f"gram_{N}_F1", f"gram_{N}_F3")),
                         (BATCHED_CHUNKS[1],
                          (f"cross_{M}x{N}_F1", f"gram_{M}_F1"))):
        p = lane_problem(torch, dev, lanes, N, M, 3, seed=7)
        for name, (A, fa, B, fb, v, ls, rho, nz) in lane_shapes(p):
            if name not in names:
                continue
            Ln, n, m = lanes, A.shape[1], B.shape[1]
            F = v.shape[1]
            sym = A is B
            singles = [(A[l].contiguous(), fa[l].contiguous(),
                        B[l].contiguous(), fb[l].contiguous())
                       for l in range(Ln)]
            if sym:
                singles = [(a, f, a, f) for a, f, _, _ in singles]

            def lanes_call():
                ck.ar1_cov_fused_lanes(A, fa, B, fb, v, ls, rho, nz)

            def singles_call():
                for l, (a, f, b, fb_) in enumerate(singles):
                    ck.ar1_cov_fused(a, f, b, fb_, v[l], ls[l], rho[l],
                                     None if nz is None else nz[l])

            def plain_call():
                ck.ar1_cov_fused_lanes_plain(A, fa, B, fb, v, ls, rho, nz)

            s1 = cuda_ms(torch, singles_call, reps=1)
            k1 = cuda_ms(torch, lanes_call, reps=10)
            k2 = cuda_ms(torch, lanes_call, reps=10)
            s2 = cuda_ms(torch, singles_call, reps=1)
            pl = cuda_ms(torch, plain_call, reps=1)
            ms = min(k1, k2)
            nbytes = Ln * (4 * n * m + (n * 3 + n) * 4 + n * 8
                           + (0 if sym else (m * 3 + m) * 4 + m * 8)
                           + (4 * n if nz is not None else 0))
            evals = Ln * (n * (n + 1) / 2 if sym else n * m) * F
            t_bytes = nbytes / HBM_BPS * 1e3
            t_ops = evals * per / FP32_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            out[f"{name}_L{Ln}"] = {
                "lanes": Ln, "ms": ms, "ms_runs": [k1, k2],
                "single_lane_calls_ms": min(s1, s2),
                "single_lane_calls_runs": [s1, s2], "plain_ms": pl,
                "bytes": nbytes, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "share_of_bound": bound / ms}
            del singles
    return out


# the batched study: the reference's whole 10 x 3 x 3 design (10 trajectory
# seeds x velocity-noise levels 0.0, 0.1, 0.2 x 3 field seeds) at its own
# dataset shape, every dataset's fits in one sweep per model family
# cut to 4 of the 10 trajectory seeds (36 datasets) to leave the mission
# phase room in the call's time: the study's other axes and every
# dataset's shape are the reference's
BATCHED_ARGS = ["--trajectories", "4", "--vmn", "0.0", "0.1", "0.2",
                "--field-seeds", "0", "1", "2", "--duration", "3600",
                "--fit-chunk", "36", "--eval-chunk", "10"]
BATCHED_RUNS = 36
BATCHED_CHUNKS = (36, 10)  # fit_chunk, eval_chunk of BATCHED_ARGS
# n_restarts, nigp_restarts: process_datasets_batched's defaults, which the
# command line keeps
BATCHED_RESTARTS = (8, 2)


def batched_eval_phases(torch, ck, dev, L: int = 288, N: int = 705) -> dict:
    """One lane-batched SFGP evaluation (``mfgp.nlml_value_and_grad_lanes``
    at F=1) of L lanes at N, phase by phase on CUDA events: B1's lane axis
    (Gram + noise), the batched Cholesky, alpha (two products with Linv)
    and logdet, K^-1 as the port forms it (triangular inverse, product) and
    by ``cholesky_solve`` on the identity, the trace contractions; and the
    whole call."""
    from mfgp_tpu_torch.models import gp
    from mfgp_tpu_torch.ops import linalg as la

    p = lane_problem(torch, dev, L, N, 8, 1, seed=11)
    X, y = p["X"], torch.sin(p["X"]).sum(-1)
    v, ls, rho = p["v"], p["ls"], p["rho"]
    nz = torch.full((L, 1), 0.05, device=dev)
    fid = torch.zeros((L, N), dtype=torch.long, device=dev)
    noise = torch.gather(nz, -1, fid) + 1e-6
    out = {}
    K = ck.ar1_cov_fused_lanes(X, fid, X, fid, v, ls, rho, noise)
    out["b1_ms"] = cuda_ms(torch, lambda: ck.ar1_cov_fused_lanes(
        X, fid, X, fid, v, ls, rho, noise))
    Lc = la.chol(K)
    out["chol_ms"] = cuda_ms(torch, lambda: la.chol(K))
    Linv = la.tri_inv_lanes(Lc)
    alpha = ((Linv @ y[..., None]).mT @ Linv)[..., 0, :]
    out["alpha_logdet_ms"] = cuda_ms(torch, lambda: (
        (Linv @ y[..., None]).mT @ Linv, la.logdet_from_chol(Lc)))
    Kinv = Linv.mT @ Linv
    out["kinv_ms"] = cuda_ms(torch, lambda: (
        lambda Li: Li.mT @ Li)(la.tri_inv_lanes(Lc)))
    eye = torch.eye(N, device=dev).expand(L, N, N)
    out["kinv_cholesky_solve_ms"] = cuda_ms(
        torch, lambda: torch.cholesky_solve(eye, Lc))
    out["contractions_ms"] = cuda_ms(torch, lambda: ck.grad_from_kinv(
        Kinv, alpha, X, fid, v, ls, rho, nz))
    params = gp.GPParams(torch.log(v[:, 0]), torch.log(ls[:, 0]),
                         torch.log(nz[:, 0]))
    out["whole_ms"] = cuda_ms(torch, lambda: gp.nlml_value_and_grad_lanes(
        params, X, y, jitter=1e-6))
    out["lanes"], out["n"] = L, N
    return out


def lane_sweep_device(torch, tsb):
    """Wraps ``study_batched.batched_lbfgs`` to record each sweep's lanes,
    device and dtype; returns (records, restore)."""
    recs, orig = [], tsb.batched_lbfgs

    def run(fun, x0, *a, **kw):
        recs.append({"lanes": int(x0.shape[0]), "on_cuda": bool(x0.is_cuda),
                     "dtype": str(x0.dtype)})
        return orig(fun, x0, *a, **kw)

    tsb.batched_lbfgs = run
    return recs, lambda: setattr(tsb, "batched_lbfgs", orig)


def per_level(values, order, key):
    """Mean of per-dataset ``values`` grouped by the datasets' ``key``."""
    groups = {}
    for v, name in zip(values, order):
        groups.setdefault(name[key], []).append(v)
    return {k: float(np.mean(g)) for k, g in sorted(groups.items())}


def study_batched_phase(torch, ck, cov, dev, st: dict) -> dict:
    """Phase 10: B1's lane axis against single-lane launches and its
    float64 plain version, then the batched study through
    ``cli.main(["study", "--fit-mode", "device-batched", ...])`` over 36
    datasets of the reference's design (launch counters from 0), checked and
    measured; then the batched path with ``ftol=0`` on the per-dataset
    study's dataset against that path's RMSEs. Returns the launches of the
    batched study's run."""
    from mfgp_tpu_torch import cli
    from mfgp_tpu_torch.data import io as tio
    from mfgp_tpu_torch.data import study
    from mfgp_tpu_torch.data import study_batched as tsb
    from mfgp_tpu_torch.data.trainers import F64_KEY
    from mfgp_tpu_torch.utils.configs import SimConfig

    lane_errs = b1_lane_checks(torch, ck, dev)
    lane_times = b1_lane_times(torch, ck, dev)
    emit("b1_lanes", nvidia_smi=nvidia_smi(), max_abs_err=lane_errs,
         times=lane_times)
    emit("batched_eval_phases", nvidia_smi=nvidia_smi(),
         **batched_eval_phases(torch, ck, dev))
    torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="mfgp_batched_")
    probe = PathProbe(torch, ck, cov, (), study=study)
    recs, restore = lane_sweep_device(torch, tsb)
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["study", "--out", out_dir, "--fit-mode",
                      "device-batched"] + BATCHED_ARGS)
    finally:
        probe.restore()
        restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    summary = json.loads(buf.getvalue())
    tm = probe.timings
    stats = tm["batched"]
    try:
        res = os.path.join(out_dir, "GPResults")
        names = sorted(f for f in os.listdir(res) if f.startswith("MSE_"))
        parsed = {f: tio.parse_mse(os.path.join(res, f)) for f in names}
        hyps = [f for f in os.listdir(res) if f.endswith("GP.txt")
                or f.endswith("GPTP.txt")]
        for f in hyps:
            tio.load_hyp_vector(os.path.join(res, f))
        gpres = [f for f in os.listdir(res) if f.startswith("GPRes_")]
        for f in gpres:
            assert tio.load_table(os.path.join(res, f)).data.shape == (2000,
                                                                       8)
        with open(os.path.join(res, "results.csv")) as f:
            rows = f.read().splitlines()
    except Exception as e:  # a malformed artifact fails the checks below
        names, parsed, hyps, gpres, rows = [], {}, [], [], []
        check("study_batched artifacts parse", False, repr(e))
    # the datasets in run_study's order (field seed, noise level,
    # trajectory), which the per-lane statistics follow
    data_dir = os.path.join(out_dir, "GPDataSets")
    staged = [f"GPData_0.2_fieldMeas_{fs}_T{t}_{v:g}.csv"
              for fs in (0, 1, 2) for v in (0.0, 0.1, 0.2)
              for t in range(int(BATCHED_ARGS[1]))]
    order = [tio.parse_mse_filename(n.replace("GPData", "MSE")
                                    .replace(".csv", ".txt")) for n in staged]
    pick = os.path.join(data_dir, f"GPData_{STUDY_PICK}.csv")
    R = BATCHED_RUNS
    check("study_batched artifacts", len(names) == R and len(rows) == R + 1
          and len(hyps) == 4 * R and len(gpres) == R
          and all(len(p) == 8 for p in parsed.values())
          and summary["overall"]["n"] == R,
          f"{len(names)} MSE files of 8 metrics, {len(hyps)} hyperparameter "
          f"files, {len(gpres)} GPRes grids (2,000 x 8), results.csv with "
          f"{len(rows) - 1} rows, summary n={summary['overall']['n']} "
          f"({R} datasets of the reference's 90-dataset design)")
    rm = [v for p in parsed.values() for k, v in p.items()
          if k.startswith("RMSE")]
    wm = [v for p in parsed.values() for k, v in p.items()
          if k.startswith("WRMSE")]
    repairs = {k: stats[k]["repairs"] for k in tsb.FAMILIES}
    check("study_batched RMSE finite", len(rm) == 4 * R
          and bool(np.isfinite(rm).all()), f"{len(rm)} RMSE values")
    check("study_batched WRMSE finite", len(wm) == 4 * R
          and bool(np.isfinite(wm).all())
          and tm[F64_KEY] == sum(repairs.values()),
          f"{len(wm)} WRMSE values finite after {tm[F64_KEY]} float64 "
          f"repair(s) on the card, per family {repairs}")
    climbed = {}
    for k in tsb.FAMILIES:
        for b, (fs, f0) in enumerate(zip(stats[k]["f"], stats[k]["f0"])):
            good = [f for f in fs if np.isfinite(f) and f < 1e19]
            if not good or min(good) > f0[0]:
                climbed.setdefault(k, []).append(b)
    check("study_batched NLML", not climbed,
          f"each dataset's best NLML <= its row-0 start in every family; "
          f"others (family: datasets): {climbed}")
    check("study_batched on the card", recs and all(
        r["on_cuda"] and r["dtype"] == "torch.float32" for r in recs),
        f"sweeps {[(r['lanes'], r['on_cuda'], r['dtype']) for r in recs]}")
    fit_chunk, eval_chunk = BATCHED_CHUNKS
    rounds = {k: sum(stats[k]["rounds"][c0] for c0 in range(0, R, fit_chunk))
              for k in tsb.FAMILIES}
    lane_evals = {k: int(np.sum(stats[k]["evals"])) for k in tsb.FAMILIES}
    n_eval = -(-R // eval_chunk)
    want = (rounds["mf"] + rounds["sf"] + rounds["sfTP"] + 2 * rounds["nisf"]
            + n_eval * (3 + 3 + 3 + 4))
    check("study_batched B1 by rounds", launches["ar1_cov_fused"] == want,
          f"B1 launches {launches['ar1_cov_fused']} = rounds (one per "
          f"round, two per NIGP round: {rounds}) + 13 per evaluation chunk "
          f"x {n_eval} = {want}; the lanes' evaluations were {lane_evals}")

    # the batched path with ftol=0 on the per-dataset study's dataset
    t1 = time.perf_counter()
    one = tsb.process_datasets_batched(
        [pick], os.path.join(out_dir, "FieldData", "FieldSettings0.txt"),
        cfg=SimConfig(seed=0, vmn=0.2), ftol=0.0, device=dev)
    one_s = time.perf_counter() - t1
    got = next(iter(one.values()))
    ref = st["metrics"]
    ratios = {k: got[k] / ref[k] for k in ("RMSE mf", "RMSE sf",
                                           "RMSE sfTP")}
    check("study_batched ftol=0 = per-dataset device path",
          all(abs(r - 1.0) <= 0.05 for r in ratios.values()),
          f"RMSE batched / per-dataset on {STUDY_PICK}: {ratios} (rtol "
          "0.05)")

    window = study_batched_idle(torch, tsb, data_dir, out_dir, staged[:8])
    fam = {k: {"fit_s": stats[k]["fit_s"], "eval_s": stats[k]["eval_s"],
               "rounds": rounds[k], "lane_evaluations": lane_evals[k],
               "evals_per_lane_mean": float(np.mean(stats[k]["evals"])),
               "evals_per_lane_max": int(np.max(stats[k]["evals"])),
               "iterations_per_lane_mean": float(np.mean(stats[k]["k"])),
               "lanes_at_maxiter": int(np.sum(np.asarray(stats[k]["k"])
                                              >= 200)),
               "evals_per_lane_by_vmn": per_level(
                   np.mean(stats[k]["evals"], axis=1), order,
                   "velVariance"),
               "repairs": repairs[k]} for k in tsb.FAMILIES}
    emit("study_batched", wall_s=wall, datasets=R, nvidia_smi=nvidia_smi(),
         chunks={"fit": fit_chunk, "eval": eval_chunk},
         stages={"filter_s": tm["filter_s"],
                 "field_binning_and_their_files_s": tm["pipeline_s"],
                 "batched_fits_and_evaluations_s": tm["trainers_s"],
                 "aggregate_s": tm["aggregate_s"]},
         families=fam, launches=launches, peak_memory_gb=peak,
         wmse_f64_count=tm[F64_KEY],
         ftol0_vs_per_dataset={"ratios": ratios, "seconds": one_s,
                               "batched": got, "per_dataset": ref},
         idle=window, summary_overall=summary["overall"])
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def study_batched_idle(torch, tsb, data_dir, out_dir, names) -> dict:
    """The device's idle share over a bounded window of the batched path:
    ``process_datasets_batched`` on 8 of the study's datasets with every
    fit cut to 10 iterations, under ``torch.profiler``."""
    paths = [os.path.join(data_dir, n) for n in names]
    settings = [os.path.join(out_dir, "FieldData",
                             f"FieldSettings{n.split('_')[3]}.txt")
                for n in names]

    def window():
        tsb.process_datasets_batched(paths, settings, maxiter=10)

    window()
    out = device_idle_share(torch, window)
    out["window"] = (f"process_datasets_batched on {len(names)} datasets, "
                     "maxiter=10, float32")
    return out


# ---------------------------------------------------------------------------
# phase 11: the planner's scoring path
# ---------------------------------------------------------------------------
PLANNER_COSTS = ("ergodic", "fourier", "sf_gain", "mf_gain", "sf_logdet",
                 "mf_logdet")
# B1 launches per scoring call by design: one lane-axis launch per
# covariance block of the batch (a single path is a batch of one lane)
PLANNER_B1 = {"ergodic": 0, "fourier": 0, "sf_gain": 2, "mf_gain": 4,
              "sf_logdet": 3, "mf_logdet": 3}
PLANNER_ITERS = 40  # the simulator's plan_iters (sim/explore.py:89)
PLANNER_B = 150.0  # the planner benchmark's budget (bench.py:208-213)
# the simulator's first tranche, min(B / BD, B) of SimConfig()
# (sim/explore.py:343-345, 384-385): what its host replan is given
PLANNER_TRANCHE = 15.0
PLANNER_SEED = 0
# paths drawn from a replan's graph (its nodes' path sets) and scored as
# one batch: float32 against float64, B1's lanes checked and timed there
PLANNER_CANDIDATES = 512
# float32 against float64 on the candidate set: the max abs err over the
# scores finite in float64 over the largest |score|
PLANNER_RTOL = {"ergodic": 1e-4, "fourier": 1e-4, "sf_gain": 1e-2,
                "mf_gain": 1e-2, "sf_logdet": 1e-2, "mf_logdet": 1e-2}


_PLANNER_SETUP: dict = {}


def planner_setup(torch, dev) -> dict:
    """The study's dataset (trajectory 0, vmn 0.2, field seed 0: N of about
    705) through the port's filter and pipeline, the 3-fidelity MFGP and
    the GP on it in float32 on the card, each with one short
    ``optimize_restarts`` (2 lanes x 20 iterations), their float64 copies
    on the card (the same hyperparameters), and the simulator's grids.
    Built once per device: phases 11 and 13 share it (nothing changes
    it)."""
    if dev not in _PLANNER_SETUP:
        _PLANNER_SETUP[dev] = _planner_setup(torch, dev)
    return _PLANNER_SETUP[dev]


def _planner_setup(torch, dev) -> dict:
    from mfgp_tpu_torch.data.io import load_gp_dataset
    from mfgp_tpu_torch.data.pipeline import (generate_estimates_batch,
                                              run_pipeline)
    from mfgp_tpu_torch.data.study import scripted_trajectory
    from mfgp_tpu_torch.fields.wrbf import random_field
    from mfgp_tpu_torch.metrics.eid import eid_grid
    from mfgp_tpu_torch.models.gp import GP
    from mfgp_tpu_torch.models.mfgp import MFGP
    from mfgp_tpu_torch.utils.configs import SimConfig

    cfg = SimConfig(seed=0, vmn=0.2)
    field = random_field(np.random.default_rng(1000), cfg.WS, cfg.max_depth,
                         device=dev)
    traj = scripted_trajectory(0, SimConfig(seed=0, vmn=0.0),
                               duration=3600.0)
    est = generate_estimates_batch([traj], cfg, seeds=[0], device=dev)[0]
    out = tempfile.mkdtemp(prefix="mfgp_planner_")
    try:
        run_pipeline(traj, cfg, out_dir=out, traj_name="T0_0.2", field=field,
                     est=est, field_rng=np.random.default_rng(0))
        ds = load_gp_dataset(os.path.join(out, "GPDataSets",
                                          f"GPData_{STUDY_PICK}.csv"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    f32 = np.float32
    Xs, ys = ds.fidelity_lists()
    mf = MFGP.from_fidelity_lists([x.astype(f32) for x in Xs],
                                  [y.astype(f32) for y in ys], device=dev,
                                  jitter=1e-6)
    gp = GP(ds.X_est.astype(f32), ds.y.astype(f32), jitter=1e-6, device=dev)
    t0 = time.perf_counter()
    mf.optimize_restarts(n_restarts=2, maxiter=20, tol=1e-3)
    gp.optimize_restarts(n_restarts=2, maxiter=20, tol=1e-3)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    mf64 = MFGP(mf.X.double(), mf.fid, mf.y.double(), n_fidelities=3,
                jitter=1e-6, device=dev)
    mf64.set_param_array(mf.param_array)
    gp64 = GP(gp.X.double(), gp.y.double(), jitter=1e-6, device=dev)
    gp64.set_param_array(gp.param_array)
    sim = SimConfig()
    WS = [list(b) for b in sim.WS]
    return {"cfg": sim, "field": field, "n": ds.n, "fit_s": fit_s,
            "models": {torch.float32: (mf, gp), torch.float64: (mf64, gp64)},
            "param_arrays": {"mf": mf.param_array.tolist(),
                             "gp": gp.param_array.tolist()},
            # the simulator's grids (sim/explore.py:133-142)
            "grid": eid_grid(WS, sim.max_depth),
            "ig_grid": eid_grid(WS, sim.max_depth, nums=(10, 6, 5)),
            "fid_levels": sim.agent().fid_levels}


def planner_eid(name: str, mf, gp, grid):
    """The simulator's EID on the 2,000-point grid (sim/explore.py:185-197):
    the MF model's for the ergodic and MF costs, the GP's for the SF
    costs."""
    from mfgp_tpu_torch.metrics.eid import expected_information_density

    model = gp if name.startswith("sf") else mf
    mu, var = model.predict(grid)
    pa = model.param_array
    prior = float(pa[[0, 4, 8, -1]].sum() if model is mf
                  else pa[0] + pa[-1])
    return expected_information_density(mu, var, prior)


def planner_cost(name: str, setup: dict, dtype, eid, dev):
    """One of the six costs as the simulator builds it
    (sim/explore.py:199-215) on the models of ``dtype``: the ergodic costs
    on the EID grid in that dtype, the log-det costs on the 300-point IG
    grid."""
    from mfgp_tpu_torch.planning import scoring as sc

    mf, gp = setup["models"][dtype]
    grid, ig, fl = setup["grid"], setup["ig_grid"], setup["fid_levels"]
    erg = dict(device=dev, dtype=dtype)
    bounds = np.asarray([[0.0, 10.0], [0.0, 20.0], [0.0, 10.0]])
    return {"ergodic": lambda: sc.ErgodicCost(eid=eid, grid=grid, **erg),
            "fourier": lambda: sc.FourierErgodicCost(
                eid=eid, grid=grid, bounds=bounds, **erg),
            "sf_gain": lambda: sc.SFInfoGainCost(gp),
            "mf_gain": lambda: sc.MFInfoGainCost(mf, fl),
            "sf_logdet": lambda: sc.BatchLogDetCost(gp, ig),
            "mf_logdet": lambda: sc.MFBatchLogDetCost(mf, ig, fl)}[name]()


class ScoreProbe:
    """A cost as the planner sees it, recording each scoring call: batch
    or single path, lanes, padded length, B1 launches and seconds (the
    call returns host numpy, so its wall includes the device's work). It
    also keeps the arguments of the first launch of B1's lane axis of each
    kind (call kind, place in the call, shapes, symmetric, noise), so that
    the replan's own launches can be held to their plain version after
    it."""

    def __init__(self, ck, cost):
        self.ck, self.cost, self.calls, self.launches = ck, cost, [], {}

    def _run(self, kind, fn, paths):
        from mfgp_tpu_torch.planning.scoring import _bucket

        ck, real, seen = self.ck, self.ck.ar1_cov_fused_lanes, []

        def record(*args, **kw):
            seen.append((args, kw))
            return real(*args, **kw)

        n0 = ck.LAUNCHES["ar1_cov_fused"]
        ck.ar1_cov_fused_lanes = record
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            ck.ar1_cov_fused_lanes = real
        self.calls.append({
            "kind": kind, "lanes": len(paths),
            "T": _bucket(max(p.shape[0] for p in paths)),
            "b1": ck.LAUNCHES["ar1_cov_fused"] - n0,
            "seconds": time.perf_counter() - t0})
        for i, (args, kw) in enumerate(seen):
            key = (kind, i, lane_launch_shape(ck, args, kw))
            self.launches.setdefault(key, (args, kw))
        return out

    def batch(self, paths):
        return self._run("batch", lambda: self.cost.batch(paths), paths)

    def __call__(self, points):
        return self._run("call", lambda: self.cost(points), [points])


def planner_replan(torch, ck, name: str, setup: dict, dev,
                   seed: int = PLANNER_SEED, B: float = PLANNER_B):
    """One replan as the simulator makes it (sim/explore.py:384-416): the
    EID, the cost, then ``RIGPlanner.plan`` at the simulator's settings
    but the budget ``B`` (by default the planner benchmark's; the
    simulator's first tranche is ``PLANNER_TRANCHE``) from its start
    point, the WRBF field as the edges' environment; float32 on the card.
    Returns (planner, best path, probe, eid, seconds by stage)."""
    from mfgp_tpu_torch.planning.rig import RIGPlanner

    cfg, field = setup["cfg"], setup["field"]
    mf, gp = setup["models"][torch.float32]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eid = planner_eid(name, mf, gp, setup["grid"])
    probe = ScoreProbe(ck, planner_cost(name, setup, torch.float32, eid,
                                        dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    planner = RIGPlanner(
        cfg=cfg.agent(), delta=cfg.step_size, B=B,
        WS=np.asarray(cfg.WS, float), R=cfg.near_rad, Rd=cfg.Rd,
        same_node_distance=cfg.same_node_distance, budget_cutoff=0.9,
        max_iter=PLANNER_ITERS, seed=seed, cost=probe,
        env=lambda pts: field.numpy(pts))
    x0 = np.array([[0.05 * (cfg.WS[0][1] - cfg.WS[0][0])],
                   [0.05 * (cfg.WS[1][1] - cfg.WS[1][0])]])
    best = planner.plan(x0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return planner, best, probe, eid, {"eid_and_cost_s": t1 - t0,
                                       "plan_s": t2 - t1,
                                       "replan_s": t2 - t0}


def planner_candidates(planner, count: int = PLANNER_CANDIDATES):
    """``count`` paths of a replan's graph (its nodes' path sets: the
    candidates the planner's DP extends), drawn with a fixed seed, as the
    planner's scoring rows; and how many the graph holds."""
    paths = [p for i in sorted(planner.V) for p in planner.V[i].path_list]
    pick = np.random.default_rng(1).choice(len(paths),
                                           min(count, len(paths)),
                                           replace=False)
    return [planner._path_points(paths[i]) for i in sorted(pick)], len(paths)


def planner_lane_launches(ck, cost, paths) -> list:
    """``cost.batch(paths)`` with the arguments of every launch of B1's
    lane axis recorded, in order."""
    probe = ScoreProbe(ck, cost)
    probe.batch(paths)
    return list(probe.launches.values())


LANE_ARGS = ("X1", "fid1", "X2", "fid2", "variances", "lengthscales",
             "rhos", "noise_diag", "kern")


def lane_launch_shape(ck, args, kw) -> str:
    """A launch of B1's lane axis as "(L, N, M) F=.. [sym] [+noise]"."""
    a = dict(zip(LANE_ARGS, args), **kw)
    A, B = a["X1"], a["X2"]
    sym = ck.same_points(A, a["fid1"], B, a["fid2"])
    return (f"({A.shape[0]}, {A.shape[1]}, {B.shape[1]}) "
            f"F={a['variances'].shape[1]}" + (" sym" if sym else "")
            + (" +noise" if a.get("noise_diag") is not None else ""))


def lane_input_bytes(t) -> int:
    """Bytes of a lane-axis input read once: a broadcast view (lane stride
    0, one grid or training set for every lane) once in all, a per-lane
    input once per lane."""
    per_lane = t[0].numel() * t.element_size()
    return per_lane * (1 if t.stride(0) == 0 else t.shape[0])


def b1_exact(torch, X1, f1, X2, f2, v, ls, rho, noise, kern: str):
    """B1's function in float64 with each squared distance summed from the
    coordinates' differences. The plain composition (``ar1_cov_fused_plain``,
    the JAX package's ``sqdist``) expands it into norms, which cancel at
    far coordinates even in float64: at the mission arena's padding rows
    (coordinate 1e6) and a lengthscale of 0.22, a zero distance came out
    0.0078 (0.4 % of the covariance) where B1's was exact."""
    from mfgp_tpu_torch.ops import kernels as _k

    X1, X2, v, ls, rho = (t.double() for t in (X1, X2, v, ls, rho))
    W = _k.ar1_fidelity_weights(rho, v.shape[0])
    out = 0.0
    for m in range(v.shape[0]):
        r2 = (((X1[:, None, :] - X2[None, :, :]) / ls[m]) ** 2).sum(-1)
        if kern == "rbf":
            base = torch.exp(-0.5 * r2)
        else:
            r = torch.sqrt(r2 + 1e-36)
            base = (1.0 + _k._SQRT3 * r) * torch.exp(-_k._SQRT3 * r)
        out = out + (W[m][f1][:, None] * W[m][f2][None, :]) * (v[m] * base)
    if noise is not None:
        out = out + torch.diag(noise.double())
    return out


def planner_lane_check(torch, ck, key: str, args, kw) -> dict:
    """One recorded lane-axis launch held as ``b1_lane_checks`` holds the
    study's: every lane bit-identical to a single-lane launch on its inputs
    (with the symmetric half grid where the lane launch took it), a
    symmetric launch bit-identical to its full grid, every lane within
    1e-5 x max(1, largest entry) of B1's function in float64
    (``b1_exact``). Then timed
    on CUDA events (the wrapper's call, and the kernel alone on inputs
    prepped once) beside the plain version, with its bound (bytes: the
    output written once, each input read once, a broadcast input once for
    all lanes)."""
    a = dict(zip(LANE_ARGS, args), **kw)
    A, fa, B, fb = a["X1"], a["fid1"], a["X2"], a["fid2"]
    v, ls, rho = a["variances"], a["lengthscales"], a["rhos"]
    nz, kern = a.get("noise_diag"), a.get("kern", "rbf")
    L, n, D = A.shape
    m, F = B.shape[1], v.shape[1]
    sym = ck.same_points(A, fa, B, fb)
    got = ck.ar1_cov_fused_lanes(A, fa, B, fb, v, ls, rho, nz, kern)
    full_same = None
    if sym:
        full = ck.ar1_cov_fused_lanes(A, fa, B.clone(), fb.clone(), v, ls,
                                      rho, nz, kern)
        full_same = torch.equal(got.view(torch.int32),
                                full.view(torch.int32))
        del full
    differ, err, top = [], 0.0, 1.0
    for l in range(L):
        x, f = A[l].contiguous(), fa[l].contiguous()
        if sym:
            y, g = x, f
        else:
            y = x if B is A else B[l].contiguous()
            g = fb[l].contiguous()
        one = ck.ar1_cov_fused(x, f, y, g, v[l], ls[l], rho[l],
                               None if nz is None else nz[l], kern)
        if not torch.equal(got[l].view(torch.int32), one.view(torch.int32)):
            differ.append(l)
        ref = b1_exact(torch, A[l], fa[l], B[l], fb[l], v[l], ls[l], rho[l],
                       None if nz is None else nz[l], kern)
        err = max(err, max_err(got[l], ref))
        top = max(top, float(ref.abs().max()))
        del one, ref
    shape = lane_launch_shape(ck, args, kw)
    check(f"B1 planner lanes {key} {shape}",
          not differ and full_same is not False and err <= 1e-5 * top,
          f"lanes differing from single-lane launches: {differ[:8]}; "
          f"symmetric = full grid: {full_same}; max abs err vs f64 "
          f"{err:.3e} (<= 1e-5 x {top:.4g})")
    B1_PATH_ERRS.append(err)

    def lanes_call():
        ck.ar1_cov_fused_lanes(A, fa, B, fb, v, ls, rho, nz, kern)

    def plain_call():
        ck.ar1_cov_fused_lanes_plain(A, fa, B, fb, v, ls, rho, nz, kern)

    # the kernel alone, on inputs prepped once (the wrapper's call adds
    # _prep's small launches and the output's allocation)
    prepped = ck._prep_pair(A, fa, B, fb, v, ls, rho)
    out = torch.empty((L, n, m), dtype=torch.float32, device=A.device)

    def kernel_call():
        ck._launch_ar1_cov(*prepped, nz, out, ck._KERN_IDS[kern])

    k1 = cuda_ms(torch, lanes_call, reps=10)
    k2 = cuda_ms(torch, lanes_call, reps=10)
    kernel_ms = min(cuda_ms(torch, kernel_call, reps=10) for _ in range(2))
    pl = cuda_ms(torch, plain_call, reps=1)
    ms = min(k1, k2)
    sides = (A, fa) if sym else (A, fa, B, fb)
    nbytes = 4 * L * n * m + sum(lane_input_bytes(t) for t in (
        *sides, v, ls, rho, *(() if nz is None else (nz,))))
    evals = L * (n * (n + 1) / 2 if sym else n * m) * F
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = evals * (3 * D + 5) / FP32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    return {"shape": shape, "max_abs_err": err, "ms": ms, "ms_runs": [k1, k2],
            "kernel_ms": kernel_ms, "plain_ms": pl, "bytes": nbytes,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / ms,
            "kernel_share_of_bound": bound / kernel_ms}


def planner_grid_checks(torch, ck, setup, dev) -> None:
    """The log-det costs' candidate-free blocks through B1's single-lane
    wrapper: K(IG grid, train) and K(IG grid, IG grid), F=3 with the grid
    at the highest fidelity (the MFGP) and F=1 (the GP), against float64
    (``b1_path_check``)."""
    from mfgp_tpu_torch.utils.device import points_like

    mf, gp = setup["models"][torch.float32]
    G = points_like(setup["ig_grid"], mf.X)
    p, q = mf.params, gp.params
    gfid = torch.full((G.shape[0],), 2, dtype=torch.long, device=dev)
    z = torch.zeros(gp.X.shape[0], dtype=torch.long, device=dev)
    zg = torch.zeros(G.shape[0], dtype=torch.long, device=dev)
    one = (q.variance.reshape(1), q.lengthscales.reshape(1, -1),
           q.variance.new_zeros(0))
    for a in ((G, gfid, mf.X, mf.fid, p.variances, p.lengthscales, p.rhos),
              (G, gfid, G, gfid, p.variances, p.lengthscales, p.rhos),
              (G, zg, gp.X, z, *one), (G, zg, G, zg, *one)):
        b1_path_check(torch, ck, "planner IG grid", *a)


def planner_candidate_checks(torch, ck, name, cost32, eid, setup, cands,
                             dev) -> dict:
    """One cost on the candidate set: float32 on the card against the same
    cost on the models' float64 copies on the card (its B1 launches the
    design's), the float32 batch timed, B1's lane launches checked and
    timed (``planner_lane_check``)."""
    cost64 = planner_cost(name, setup, torch.float64, eid.double(), dev)
    n0 = ck.LAUNCHES["ar1_cov_fused"]
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        s32 = cost32.batch(cands)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    b1 = (ck.LAUNCHES["ar1_cov_fused"] - n0) / 2
    t0 = time.perf_counter()
    s64 = cost64.batch(cands)
    wall64 = time.perf_counter() - t0
    ok64 = np.isfinite(s64)
    both = ok64 & np.isfinite(s32)
    top = float(np.abs(s64[ok64]).max()) if ok64.any() else 0.0
    err = float(np.abs(s32[both] - s64[both]).max()) if both.any() else 0.0
    nonfinite32 = int((~np.isfinite(s32) & ok64).sum())
    rtol = PLANNER_RTOL[name]
    check(f"planner {name} f32 vs f64 on the card",
          ok64.all() and err <= rtol * top and b1 == PLANNER_B1[name],
          f"{len(cands)} candidates: max abs err {err:.3e} (<= {rtol:g} x "
          f"{top:.4g}, the largest |score|) over {int(both.sum())} scores "
          f"finite in both; non-finite: {nonfinite32} in float32, "
          f"{int((~ok64).sum())} in float64; B1 launches per batch {b1:g} "
          f"(design {PLANNER_B1[name]})")
    lanes = {}
    for i, (args, kw) in enumerate(planner_lane_launches(ck, cost32, cands)):
        lanes[f"{name}_{i}"] = planner_lane_check(torch, ck,
                                                  f"{name}_{i}", args, kw)
    return {"lanes": len(cands),
            "T": int(max(p.shape[0] for p in cands)),
            "batch_s_runs": walls, "batch_f64_s": wall64,
            "peak_gb": peak, "max_abs_err": err, "largest_score": top,
            "nonfinite_f32": nonfinite32,
            "nonfinite_f64": int((~ok64).sum()), "b1_launches": lanes}


def replan_lane_checks(torch, ck, label: str, probe, per_call: int,
                       times: dict) -> None:
    """The lane-axis launches a replan's scoring calls made, the first of
    each kind (``ScoreProbe.launches``), through ``planner_lane_check``;
    their times go into ``times``. A replan that scored paths must have
    left at least ``per_call`` kinds."""
    for (kind, i, shape), (args, kw) in probe.launches.items():
        key = f"{label}_{kind}{i}"
        times[f"{key} {shape}"] = planner_lane_check(torch, ck, key, args, kw)
    check(f"planner {label} launches checked",
          len(probe.launches) >= (per_call if probe.calls else 0),
          f"{len(probe.launches)} launch kinds of the replan held to "
          f"single-lane launches and float64: "
          f"{sorted(k[2] for k in probe.launches)}")
    probe.launches.clear()


def planner_phase(torch, ck, cov, dev) -> dict:
    """Phase 11 (see the module docstring). Returns the launches of the six
    replans, counted from 0 just before the first."""
    from mfgp_tpu_torch import cli

    setup = planner_setup(torch, dev)
    mf, gp = setup["models"][torch.float32]
    check("planner models on the card", all(
        m.X.is_cuda and m.X.dtype == torch.float32 for m in (mf, gp)),
        f"MFGP and GP at N={setup['n']} on {mf.X.device} in {mf.X.dtype}; "
        f"short fits {setup['fit_s']:.1f} s; param_arrays "
        f"{setup['param_arrays']}")

    # the main path: one replan per cost, the launch counters from 0
    runs = {}
    ck.reset_launches()
    for name in PLANNER_COSTS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = planner_replan(torch, ck, name, setup, dev)
        runs[name] = out + (torch.cuda.max_memory_allocated() / 1e9,)
    launches = dict(ck.LAUNCHES)
    scoring_b1 = sum(c["b1"] for r in runs.values() for c in r[2].calls)
    check("planner launches", launches["ar1_cov_fused"] > 0
          and scoring_b1 == sum(PLANNER_B1[n] * len(r[2].calls)
                                for n, r in runs.items()),
          f"kernel launches over the six replans: {launches}; B1 in scoring "
          f"calls {scoring_b1} (the design's count), the rest the EIDs' "
          "cross-covariances and the log-det costs' grid blocks (B2 and B3 "
          "are not on this path)")

    # the replans' own lane launches, one of each kind per cost, against
    # single-lane launches and float64
    lane_times = {}
    for name, r in runs.items():
        replan_lane_checks(torch, ck, f"{name}_replan", r[2], PLANNER_B1[name],
                           lane_times)

    # the simulator's own budget: one replan per cost at its first tranche
    tranche = {}
    for name in PLANNER_COSTS:
        planner, best, probe, _, secs = planner_replan(
            torch, ck, name, setup, dev, B=PLANNER_TRANCHE)
        b1 = sorted({c["b1"] for c in probe.calls})
        replan_lane_checks(torch, ck, f"{name}_tranche", probe,
                           PLANNER_B1[name], lane_times)
        check(f"planner {name} replan at B={PLANNER_TRANCHE:g}",
              best.segments is not None and bool(np.isfinite(best.info))
              and (not probe.calls or b1 == [PLANNER_B1[name]]),
              f"best path of {len(best.segments or ())} segments, info "
              f"{best.info:.6g}; B1 launches per call {b1} (design "
              f"{PLANNER_B1[name]}); stats {planner.stats}")
        tranche[name] = {
            **secs, "stats": planner.stats, "nodes": len(planner.V),
            "scoring_calls": len(probe.calls),
            "calls": [[c["kind"], c["lanes"], c["T"], c["b1"]]
                      for c in probe.calls]}
    emit("planner_tranche", B=PLANNER_TRANCHE, nvidia_smi=nvidia_smi(),
         replans=tranche)

    planner_grid_checks(torch, ck, setup, dev)
    cands, n_graph = planner_candidates(runs["ergodic"][0])
    for name, (planner, best, probe, eid, secs, peak) in runs.items():
        calls = probe.calls
        b1 = sorted({c["b1"] for c in calls})
        check(f"planner {name} replan", best.segments is not None
              and bool(np.isfinite(best.info)),
              f"best path of {len(best.segments or ())} segments, info "
              f"{best.info:.6g}, budget {best.budget:.4g} of {PLANNER_B}; "
              f"stats {planner.stats}")
        check(f"planner {name} B1 per scoring call",
              not calls or b1 == [PLANNER_B1[name]],
              f"B1 launches per call {b1} over {len(calls)} calls "
              f"(design {PLANNER_B1[name]}: one lane-axis launch per "
              "covariance block, not one per candidate)")
        cand = planner_candidate_checks(torch, ck, name, probe.cost, eid,
                                        setup, cands, dev)
        lane_times.update(cand.pop("b1_launches"))
        idle = device_idle_share(
            torch, lambda: planner_replan(torch, ck, name, setup, dev))
        emit("planner", cost=name, nvidia_smi=nvidia_smi(), **secs,
             stats=planner.stats, nodes=len(planner.V),
             best_info=float(best.info), best_budget=float(best.budget),
             scoring_calls=len(calls),
             batch_s=sum(c["seconds"] for c in calls if c["kind"] == "batch"),
             call_s=sum(c["seconds"] for c in calls if c["kind"] == "call"),
             calls=[[c["kind"], c["lanes"], c["T"], c["b1"]] for c in calls],
             b1_per_call=b1, peak_gb=peak, candidates=cand,
             graph_paths=n_graph, idle=idle)
    emit("planner_b1_lanes", nvidia_smi=nvidia_smi(), times=lane_times)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["infogain-test"])
    ig = json.loads(buf.getvalue())
    check("planner infogain-test on the card", ig["rel_err"] < 1e-10,
          f"{ig} (rel_err < 1e-10)")
    emit("planner_infogain", device=str(dev), **ig)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the closed loop (cli explore)
# ---------------------------------------------------------------------------
# the CLI's defaults, the simulator's own budget and cadence
# (reference/exploreSimSettings.py:199, mfgp_tpu/cli.py:452-459)
EXPLORE_B, EXPLORE_BD, EXPLORE_ITERS = 150.0, 10, 40
EXPLORE_ARGS = ["--budget", "150", "--bd", "10", "--plan-iters", "40",
                "--seed", "0"]
# (label, variant flags, the cost its replans score with)
EXPLORE_RUNS = (
    ("MFEGP", ["--variant", "MFEGP"], "ergodic"),
    ("SFEGP", ["--variant", "SFEGP"], "ergodic"),
    ("MFGP", ["--variant", "MFGP"], "mf_gain"),
    ("SFGP", ["--variant", "SFGP"], "sf_gain"),
    ("MFGP-batch", ["--variant", "MFGP", "--info-cost", "batch"],
     "mf_logdet"),
    ("SFEGP-fourier", ["--variant", "SFEGP", "--ergodic-metric", "fourier"],
     "fourier"),
)
# the main-path run traced whole by torch.profiler (its times carry the
# profiler's cost; the other five runs are not traced)
EXPLORE_PROFILED = "SFEGP-fourier"
EXPLORE_RMSE_BAR = 3.0  # the JAX test's bar (tests/test_sim_cli.py:34-37)
EXPLORE_RESUME_AFTER = 2
# the one cut: dynamic flight's depth (the CLI has no max_replans flag)
EXPLORE_DYNAMIC_REPLANS = 3
EXPLORE_OBSERVER_CALLS = 2000


class ExploreProbe:
    """Records closed-loop runs as the CLI drives them, by wrapping
    ``ExplorationSim``'s stages, ``RIGPlanner.plan``, the models'
    ``optimize`` and the scipy driver at class or module level: per replan
    the seconds of each stage (EID, plan, flight, fit) on a
    CUDA-synchronised host clock with B1's launches in each, every cost in
    a ``ScoreProbe``, the evaluations of each fit, the exceptions a fit
    raised and ``_fit`` swallowed, and each run's sim, result and wall.
    ``restore`` puts everything back; the package is unchanged."""

    STAGES = ("eid", "plan", "fly", "fit")

    def __init__(self, torch, ck, explore_mod, rig_mod, model_mods):
        self.torch, self.ck = torch, ck
        self.numerical = explore_mod.NUMERICAL_FAILURES
        self.saved, self.runs, self.cur = [], [], None
        self._raised = []
        Sim = explore_mod.ExplorationSim
        self._wrap(Sim, "run", self._run)
        for name, stage in (("_eid", "eid"), ("_fly", "fly"),
                            ("_fly_dynamic", "fly"), ("_fit", "fit")):
            self._wrap(Sim, name, self._stage(stage))
        self._wrap(Sim, "_fit", self._swallowed)
        self._wrap(Sim, "_make_cost", self._cost)
        self._wrap(rig_mod.RIGPlanner, "plan", self._stage("plan"))
        for mod in model_mods:
            self._wrap(mod, "scipy_lbfgsb", self._scipy)
            cls = getattr(mod, "MFGP", None) or mod.GP
            self._wrap(cls, "optimize", self._optimize)

    def restore(self):
        for obj, name, orig in reversed(self.saved):
            setattr(obj, name, orig)

    def _wrap(self, obj, name, make):
        orig = getattr(obj, name)
        self.saved.append((obj, name, orig))
        setattr(obj, name, make(orig))

    def _b1(self) -> int:
        return self.ck.LAUNCHES["ar1_cov_fused"]

    def _run(self, orig):
        def run(sim, *a, **kw):
            outer, self.cur = self.cur, {
                "sim": sim, "probes": [], "evals": [], "swallowed": [],
                **{s: [] for s in self.STAGES}}
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = orig(sim, *a, **kw)
                self.torch.cuda.synchronize()
                self.cur.update(result=res, wall_s=time.perf_counter() - t0)
                self.runs.append(self.cur)
            finally:
                self.cur = outer
            return res
        return run

    def _stage(self, stage):
        def make(orig):
            def run(obj, *a, **kw):
                self.torch.cuda.synchronize()
                b1, t0 = self._b1(), time.perf_counter()
                out = orig(obj, *a, **kw)
                self.torch.cuda.synchronize()
                self.cur[stage].append((time.perf_counter() - t0,
                                        self._b1() - b1))
                return out
            return run
        return make

    def _cost(self, orig):
        def run(sim, model, eid):
            probe = ScoreProbe(self.ck, orig(sim, model, eid))
            self.cur["probes"].append(probe)
            return probe
        return run

    def _scipy(self, orig):
        def run(*a, **kw):
            x, f, n = orig(*a, **kw)
            self.cur["evals"].append(n)
            return x, f, n
        return run

    def _optimize(self, orig):
        def run(model, *a, **kw):
            try:
                return orig(model, *a, **kw)
            except BaseException as e:
                self._raised.append(e)
                raise
        return run

    def _swallowed(self, orig):
        """``_fit``: what its models' ``optimize`` raised while it returned
        normally was swallowed; each is recorded with whether it is one of
        the sim's numerical failures."""
        def run(sim, model):
            self._raised = []
            out = orig(sim, model)
            self.cur["swallowed"].extend(
                (type(e).__name__, isinstance(e, self.numerical))
                for e in self._raised)
            return out
        return run


def explore_stage_table(rec) -> dict:
    """Seconds and B1 launches per stage of each replan of a run (the
    model update's seconds are the sim's own ``fit_seconds``, which cover
    the model's construction; a replan that took ``extend`` has no fit)."""
    res = rec["result"]
    return {"eid_s": [s for s, _ in rec["eid"]],
            "plan_s": [s for s, _ in rec["plan"]],
            "fly_s": [s for s, _ in rec["fly"]],
            "update_s": [r.fit_seconds for r in res.replans],
            "fit_s": [s for s, _ in rec["fit"]],
            "b1_eid": [n for _, n in rec["eid"]],
            "b1_fit": [n for _, n in rec["fit"]],
            "evaluations_per_fit": rec["evals"],
            "fit_modes": [r.fit_mode for r in res.replans],
            "n_train": int(res.gp_data.data.shape[0]),
            "path_points": [int(r.path_points.shape[0])
                            for r in res.replans]}


def explore_run_checks(torch, label: str, rec, cost: str, out: str,
                       doc: dict) -> None:
    """The holds on one main-path run (see the module docstring)."""
    res = rec["result"]
    n = len(res.replans)
    levels = set(np.unique(res.gp_data.col("fidLev")).astype(int).tolist())
    check(f"explore {label} run",
          n >= 1 and res.budget_used <= EXPLORE_B + 1e-9
          and levels and levels <= {1, 2, 3}
          and res.estimates.shape[1] == 13
          and doc["replans"] == n and doc["budget_used"] == res.budget_used,
          f"{n} replans, budget used {res.budget_used:.6g} (<= "
          f"{EXPLORE_B:g}), fidelity levels {sorted(levels)}, telemetry "
          f"{res.estimates.shape}, {res.gp_data.data.shape[0]} rows; the "
          f"CLI's JSON {doc}")
    m = res.model
    check(f"explore {label} models on the card in float32",
          m.X.is_cuda and m.X.dtype == torch.float32
          and rec["sim"].dtype == torch.float32,
          f"final model {type(m).__name__} N={m.X.shape[0]} on {m.X.device} "
          f"in {m.X.dtype}")
    b1_eid = [k for _, k in rec["eid"]]
    b1_fit = [k for _, k in rec["fit"]]
    check(f"explore {label} B1 in every refit and EID",
          len(b1_eid) >= n and min(b1_eid) >= 1 and b1_fit
          and min(b1_fit) >= 1,
          f"B1 launches per EID {b1_eid}, per refit {b1_fit} (every "
          "replan's EID and refit through the kernel)")
    calls = [c for p in rec["probes"] for c in p.calls]
    per_call = sorted({c["b1"] for c in calls})
    check(f"explore {label} B1 per scoring call",
          not calls or per_call == [PLANNER_B1[cost]],
          f"{len(calls)} scoring calls over {len(rec['probes'])} replans, "
          f"B1 launches per call {per_call} (design {PLANNER_B1[cost]}: "
          "one lane-axis launch per covariance block)")
    swallowed = rec["swallowed"]
    check(f"explore {label} no fit failure swallowed but numerical ones",
          all(num for _, num in swallowed),
          f"{len(swallowed)} fit exceptions swallowed: {swallowed}")
    files = set(os.listdir(out))
    eid_sums = []
    for k in range(n):
        eid = np.loadtxt(os.path.join(out, f"EID{k}.csv"), delimiter=",")
        eid_sums.append(float(eid[:, 3].sum()))
    with open(os.path.join(out, "replans.csv")) as f:
        rows = f.read().splitlines()
    check(f"explore {label} artifacts",
          all(f"plannedTraj{k}.csv" in files for k in range(n))
          and all(abs(s - 1.0) <= 1e-5 for s in eid_sums)
          and len(rows) == 1 + n and rows[0].startswith("planNum,"),
          f"plannedTraj/EID for {n} replans, EID densities summing to "
          f"{min(eid_sums):.7f}..{max(eid_sums):.7f} (1 within 1e-5), "
          f"replans.csv {len(rows) - 1} rows")
    check(f"explore {label} RMSE", res.rmse is not None
          and bool(np.isfinite(res.rmse)) and res.rmse < EXPLORE_RMSE_BAR,
          f"final RMSE {res.rmse} (finite, < {EXPLORE_RMSE_BAR})")


def explore_filter_times(torch, kf_model, path) -> dict:
    """The filter on one flown path (as ``_fly`` gives it): eagerly (what
    the sim runs) and as one CUDA graph of the whole path (the default
    ``graph_steps`` of 128 covers it: one capture per call), twice each,
    seconds on a synchronised host clock."""
    from mfgp_tpu_torch.estimation.kalman import filter_trajectory

    t, xyz = path[:, 3], path[:, :3]
    keep = np.concatenate([[True], np.diff(t) > 0])
    t, xyz = t[keep], xyz[keep]
    noise = np.random.default_rng(0).standard_normal((t.shape[0] - 1, 6))
    secs = {"eager": [], "graph_128": []}
    outs = {}
    for name, steps in (("eager", 0), ("graph_128", None), ("graph_128", None),
                        ("eager", 0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = filter_trajectory(kf_model, t, xyz, noise=noise,
                                       graph_steps=steps)
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    diff = max(max_err(outs["eager"][k], outs["graph_128"][k])
               for k in ("xh", "sig", "err"))
    return {"steps": int(t.shape[0] - 1), "seconds": secs,
            "max_abs_diff": diff}


def explore_observer_times(torch, dev) -> dict:
    """The runtime's observer step on the card, eager and as its CUDA
    graph, ``EXPLORE_OBSERVER_CALLS`` calls each on the same changing
    inputs (each call copies in, runs, copies out and synchronises, as a
    tick does): microseconds per call, and the largest difference between
    the two."""
    from mfgp_tpu_torch.estimation.observers import GliderParams
    from mfgp_tpu_torch.hw.runtime import ObserverStep

    rng = np.random.default_rng(3)
    params = GliderParams(lp=0.61, bc=0.55)
    args = [(*rng.uniform(-0.5, 0.5, 3), rng.normal(0, 0.05, 3),
             rng.normal(0, 0.1, 3), *rng.uniform(0, 10, 2),
             rng.uniform(0, 1), rng.uniform(-0.5, 0.5))
            for _ in range(EXPLORE_OBSERVER_CALLS)]
    out, us = {}, {}
    for name, graph in (("graph", True), ("eager", False)):
        step = ObserverStep(params, dev, graph=graph)
        step(*args[0])  # the graph's capture, the eager path's warm-up
        t0 = time.perf_counter()
        out[name] = [step(*a) for a in args]
        us[name] = (time.perf_counter() - t0) / len(args) * 1e6
    diff = max(float(np.abs(x - y).max()) for a, b in zip(out["graph"],
                                                            out["eager"])
               for x, y in zip(a, b))
    check("explore observer graph = eager", diff <= 1e-12,
          f"{len(args)} observer steps on the card: graph against eager max "
          f"abs difference {diff:.3e} (<= 1e-12)")
    return {"us_per_call": us, "calls": len(args), "max_abs_diff": diff}


def explore_phase(torch, ck, cov, dev) -> dict:
    """Phase 12 (see the module docstring). Returns the launches of the
    six main-path runs, counted from 0 just before the first."""
    from mfgp_tpu_torch import cli
    from mfgp_tpu_torch.models import gp as gp_mod
    from mfgp_tpu_torch.models import mfgp as mfgp_mod
    from mfgp_tpu_torch.planning import rig as rig_mod
    from mfgp_tpu_torch.sim import explore as ex
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    probe = ExploreProbe(torch, ck, ex, rig_mod, (gp_mod, mfgp_mod))
    base = tempfile.mkdtemp(prefix="mfgp_explore_")
    mfegp = dict(multi_fidelity=True, ergodic=True, B=EXPLORE_B,
                 BD=EXPLORE_BD)
    iters = EXPLORE_ITERS
    try:
        # the main path: six CLI runs, the launch counters from 0
        runs, idle_run = {}, None
        ck.reset_launches()
        for label, flags, cost in EXPLORE_RUNS:
            out = os.path.join(base, label)
            argv = ["explore", *flags, *EXPLORE_ARGS, "--out", out]
            buf = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stdout(buf):
                if label == EXPLORE_PROFILED:
                    idle_run = device_idle_share(torch,
                                                 lambda: cli.main(argv))
                else:
                    cli.main(argv)
            rec = probe.runs[-1]
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            runs[label] = (rec, cost, out,
                           json.loads(buf.getvalue().strip().splitlines()[-1]))
        launches = dict(ck.LAUNCHES)
        check("explore launches", launches["ar1_cov_fused"] > 0,
              f"kernel launches over the six runs: {launches} (B2 and B3 "
              "are not on this path: predict is not predict_fused, and the "
              "fits are scipy on the autodiff NLML)")
        lane_times = {}
        for label, (rec, cost, out, doc) in runs.items():
            explore_run_checks(torch, label, rec, cost, out, doc)
            first = next((p for p in rec["probes"] if p.calls), None)
            if first is not None:
                replan_lane_checks(torch, ck, f"explore_{label}", first,
                                   PLANNER_B1[cost], lane_times)
            res = rec["result"]
            emit("explore", run=label, nvidia_smi=nvidia_smi(),
                 wall_s=rec["wall_s"], replans=len(res.replans),
                 budget_used=res.budget_used, rmse=res.rmse,
                 peak_gb=rec["peak_gb"], stages=explore_stage_table(rec),
                 scoring_calls=sum(len(p.calls) for p in rec["probes"]),
                 scoring_s=sum(c["seconds"] for p in rec["probes"]
                               for c in p.calls),
                 profiled=label == EXPLORE_PROFILED,
                 idle=idle_run if label == EXPLORE_PROFILED else None)
        emit("explore_b1_lanes", nvidia_smi=nvidia_smi(), times=lane_times)
        mf_rec = runs["MFEGP"][0]
        n_mf = int(mf_rec["result"].model.X.shape[0])
        emit("explore_b1", nvidia_smi=nvidia_smi(), N=n_mf,
             times=study_b1_times(torch, ck, dev, n_mf, 2000))

        # the flight's filter: eager (what _fly runs) against one graph
        flight = explore_filter_times(
            torch, mf_rec["sim"].kf_model,
            mf_rec["result"].replans[-1].path_points)
        fly_s = [s for s, _ in mf_rec["fly"]]
        check("explore filter graph = eager", flight["max_abs_diff"] <= 1e-9,
              f"one flight of {flight['steps']} steps: eager "
              f"{flight['seconds']['eager']} s, one graph "
              f"{flight['seconds']['graph_128']} s; max abs difference "
              f"{flight['max_abs_diff']:.3e} (<= 1e-9)")
        emit("explore_fly", nvidia_smi=nvidia_smi(), filter=flight,
             fly_s_per_replan=fly_s)

        # the yardstick: MFEGP in float64 on the card (the plain
        # composition by the gate's rule: no kernel)
        y64 = ex.ExplorationSim(ExperimentConfig(**mfegp), seed=0,
                                plan_iters=iters, dtype=torch.float64).run()
        r32 = mf_rec["result"].rmse
        check("explore float32 RMSE within 2x of float64",
              y64.rmse is not None and r32 <= 2.0 * y64.rmse,
              f"MFEGP RMSE float32 {r32:.6g}, float64 {y64.rmse} on the "
              f"card ({len(y64.replans)} replans, budget "
              f"{y64.budget_used:.6g})")
        emit("explore_f64", nvidia_smi=nvidia_smi(), rmse_f64=y64.rmse,
             rmse_f32=r32, wall_s=probe.runs[-1]["wall_s"],
             stages=explore_stage_table(probe.runs[-1]))

        # frozen hyperparameters: the online extension, float64
        sim = ex.ExplorationSim(ExperimentConfig(
            multi_fidelity=True, ergodic=False, B=EXPLORE_B, BD=EXPLORE_BD,
            update_hyps=False), seed=0, plan_iters=iters, dtype=torch.float64)
        fz = sim.run()
        rows = fz.gp_data.data
        fresh = sim._make_model(rows[:, 4:7], rows[:, 8].astype(int),
                                rows[:, 7])
        fresh.set_param_array(fz.model.param_array)
        tp = sim.cfg.test_points()
        (mu_o, var_o), (mu_f, var_f) = fz.model.predict(tp), fresh.predict(tp)
        modes = [r.fit_mode for r in fz.replans]
        check("explore frozen hyperparameters extend",
              modes[:1] == ["refit"] and len(modes) > 1
              and set(modes[1:]) == {"extend"}
              and allclose(mu_o, mu_f, 1e-6, 1e-8)
              and allclose(var_o, var_f, 1e-6, 1e-8),
              f"fit modes {modes}; extended against reconditioned posterior "
              f"on {len(tp)} points: mean {max_err(mu_o, mu_f):.3e}, var "
              f"{max_err(var_o, var_f):.3e} (rtol 1e-6, atol 1e-8)")
        emit("explore_frozen", nvidia_smi=nvidia_smi(),
             wall_s=probe.runs[-1]["wall_s"], fit_modes=modes,
             update_s=[r.fit_seconds for r in fz.replans], rmse=fz.rmse)

        # resume after replan 2 (float32, the main path's MFEGP the
        # uninterrupted run); replan 2 alone under the profiler
        ck_path = os.path.join(base, "resume", "ck")
        os.makedirs(os.path.dirname(ck_path))
        ex.ExplorationSim(ExperimentConfig(**mfegp), seed=0,
                          plan_iters=iters).run(
            max_replans=EXPLORE_RESUME_AFTER, checkpoint_path=ck_path)
        idle_replan = device_idle_share(torch, lambda: ex.ExplorationSim(
            ExperimentConfig(**mfegp), seed=0, plan_iters=iters).run(
            max_replans=EXPLORE_RESUME_AFTER + 1, resume_from=ck_path))
        one = probe.runs[-1]
        rest = ex.ExplorationSim(ExperimentConfig(**mfegp), seed=0,
                                 plan_iters=iters).run(resume_from=ck_path)
        full = mf_rec["result"]
        tail = full.replans[EXPLORE_RESUME_AFTER:]
        same = (len(rest.replans) == len(tail) and all(
            (a.plan_num, a.nodes, a.edges) == (b.plan_num, b.nodes, b.edges)
            and a.path_points.shape == b.path_points.shape
            and np.allclose(a.path_points, b.path_points, 1e-6, 1e-6)
            for a, b in zip(rest.replans, tail)))
        rows_ok = (rest.gp_data.data.shape == full.gp_data.data.shape
                   and np.allclose(rest.gp_data.data, full.gp_data.data,
                                   1e-6, 1e-6))
        check("explore resume after replan 2",
              same and rows_ok
              and abs(rest.budget_used - full.budget_used) <= 1e-6,
              f"resumed replans {[r.plan_num for r in rest.replans]} against "
              f"{[r.plan_num for r in tail]}: same graphs and paths {same}; "
              f"rows {rest.gp_data.data.shape} vs {full.gp_data.data.shape} "
              f"within 1e-6 {rows_ok}; budget {rest.budget_used:.9g} vs "
              f"{full.budget_used:.9g}")
        emit("explore_resume", nvidia_smi=nvidia_smi(),
             idle_one_replan=idle_replan,
             one_replan=explore_stage_table(one), rmse=rest.rmse)

        # dynamic flight through the runtime, cut to EXPLORE_DYNAMIC_REPLANS
        dyn_out = os.path.join(base, "dynamic")
        dyn = ex.ExplorationSim(ExperimentConfig(**mfegp), seed=0,
                                plan_iters=iters, flight="dynamic",
                                out_dir=dyn_out).run(
            max_replans=EXPLORE_DYNAMIC_REPLANS)
        drec = probe.runs[-1]
        files = set(os.listdir(dyn_out))
        ticks = [np.loadtxt(os.path.join(dyn_out, f"estimates{k}.csv"),
                            delimiter=",", skiprows=1, ndmin=2).shape[0]
                 for k in range(len(dyn.replans))
                 if f"estimates{k}.csv" in files]
        check("explore dynamic flight",
              len(dyn.replans) >= 1 and all(
                  r.tracking_rmse > 0.01 and r.flown_budget > 0
                  for r in dyn.replans)
              and all(f"{n}{k}.csv" in files for k in range(len(dyn.replans))
                      for n in ("estimates", "control")),
              f"{len(dyn.replans)} replans: tracking RMSE "
              f"{[r.tracking_rmse for r in dyn.replans]} (> 0.01), flown "
              f"budget {[r.flown_budget for r in dyn.replans]} (> 0), "
              f"ticks {ticks}, estimates/control files written")
        dst = explore_stage_table(drec)
        replan_s = [sum(v) for v in zip(dst["eid_s"], dst["plan_s"],
                                        dst["fly_s"], dst["update_s"])]
        emit("explore_dynamic", nvidia_smi=nvidia_smi(),
             replans=len(dyn.replans), ticks=ticks,
             us_per_tick=[s / t * 1e6 for s, t in zip(dst["fly_s"], ticks)],
             runtime_share=[f / r for f, r in zip(dst["fly_s"], replan_s)],
             stages=dst, rmse=dyn.rmse, observer=explore_observer_times(
                 torch, dev))
    finally:
        probe.restore()
        shutil.rmtree(base, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the device planner
# ---------------------------------------------------------------------------
# bench.py's planner unit (run_planner_tpu, bench.py:185-253): ergodic, the
# 2,000-point grid, a random EID (seed 0), B=150, 200 iterations from
# (1, 1); then 8 lanes of plan_batch; min of 3 after a warm-up each
DP_ITERS, DP_LANES, DP_B, DP_REPS = 200, 8, 150.0, 3
# the eager loop is the replayed one's comparison point and takes 7-10 s
# a plan: after the warm-up, one solo plan and one 8-lane batch
DP_EAGER_REPS = (1, 1)
DP_PROFILE_ITERS = 10  # a plan this long is traced by torch.profiler
DP_X0 = np.array([1.0, 1.0])
# each cost: the simulator's plan_iters and first tranche, from the planner
# phase's start point
DP_COST_ITERS, DP_TRANCHE = PLANNER_ITERS, PLANNER_TRANCHE
# float32 covariance tiles (float64 algebra for the model costs) against
# float64 throughout, and against the host cost in float64 on the same
# path; the ergodic cost's host score differs by the junction samples the
# additive statistics count twice (tests/test_rig_device.py:51-66: 5e-3)
DP_RTOL, DP_ERGODIC_HOST_RTOL = 1e-4, 5e-3
# the closed loop through the CLI at its defaults (EXPLORE_ARGS) with the
# device planner: the four variants, then MFEGP with an 8-plan ensemble
DP_RUNS = (
    ("MFEGP", ["--variant", "MFEGP"], "ergodic", 1),
    ("SFEGP", ["--variant", "SFEGP"], "ergodic", 1),
    ("MFGP", ["--variant", "MFGP"], "mf_gain", 1),
    ("SFGP", ["--variant", "SFGP"], "sf_gain", 1),
    ("MFEGP-ens8", ["--variant", "MFEGP", "--plan-ensemble", "8"],
     "ergodic", 8),
)
# traced by torch.profiler: one replan of the simulator's tranche (a whole
# run is ~1.3 million kernel events, ~3 minutes of the profiler's work)
DP_PROFILED = ("SFGP", ["--variant", "SFGP", "--budget", "15", "--bd", "1",
                        "--plan-iters", "40", "--seed", "0"])


def dp_rig(dtype, graph: bool, **kw):
    """A DeviceRIG at the simulator's settings (sim/explore.py's device
    branch): SimConfig(), budget_cutoff 0.9, DeviceRIG's defaults."""
    from mfgp_tpu_torch.planning.rig_device import DeviceRIG
    from mfgp_tpu_torch.utils.configs import SimConfig

    sim = SimConfig()
    return DeviceRIG(sim.agent(), delta=sim.step_size,
                     WS=np.asarray(sim.WS, float), R=sim.near_rad,
                     Rd=sim.Rd, same_node_distance=sim.same_node_distance,
                     budget_cutoff=0.9, dtype=dtype, graph=graph, **kw)


def same_plan(a, b) -> bool:
    """Two plans bit for bit: graph, best path, score, budget, trace."""
    return (a.n_nodes == b.n_nodes and a.info == b.info
            and a.budget == b.budget and a.chain == b.chain
            and np.array_equal(a.points, b.points)
            and np.array_equal(a.node_states, b.node_states)
            and np.array_equal(a.trace, b.trace))


def wall(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def dp_unit(torch, dev) -> dict:
    """(a) bench.py's planner unit, eager and replayed; (c) the two equal
    bit for bit. Replayed: min of DP_REPS after a warm-up each; eager:
    DP_EAGER_REPS after one warm-up."""
    from mfgp_tpu_torch.metrics.eid import eid_grid
    from mfgp_tpu_torch.utils.configs import SimConfig

    sim = SimConfig()
    grid = eid_grid([list(b) for b in sim.WS], sim.max_depth)
    eid = np.random.default_rng(0).random(grid.shape[0])
    eid = eid / eid.sum()
    x0s = np.tile(DP_X0, (DP_LANES, 1))
    out, plans = {}, {}
    for mode, graph in (("eager", False), ("replayed", True)):
        rig = dp_rig(torch.float32, graph, B=DP_B, max_iter=DP_ITERS,
                     grid=grid, eid=eid, cost="ergodic")
        reps = DP_EAGER_REPS if mode == "eager" else (DP_REPS, DP_REPS)
        torch.cuda.reset_peak_memory_stats()
        rig.plan(DP_X0, seed=0)
        solo = [wall(torch, lambda: rig.plan(DP_X0, seed=0))
                for _ in range(reps[0])]
        if graph:  # the eager batch shares the solo plan's warm-up
            rig.plan_batch(x0s, seeds=list(range(DP_LANES)))
        batch = [wall(torch, lambda: rig.plan_batch(
            x0s, seeds=list(range(DP_LANES)))) for _ in range(reps[1])]
        plans[mode] = (solo[-1][1], batch[-1][1])
        s, b = min(t for t, _ in solo), min(t for t, _ in batch)
        out[mode] = {"plan_seconds": s, "plan_seconds_runs":
                     [t for t, _ in solo], "plan_batch_seconds": b,
                     "plan_batch_seconds_runs": [t for t, _ in batch],
                     "lanes": DP_LANES, "lane_overhead_x": b / s,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "stats": dict(rig.stats)}
        # one plan of DP_PROFILE_ITERS iterations under the profiler: the
        # device's busy share and kernels per iteration
        short = dp_rig(torch.float32, graph, B=DP_B,
                       max_iter=DP_PROFILE_ITERS, grid=grid, eid=eid,
                       cost="ergodic")
        short.plan(DP_X0, seed=0)
        out[mode]["profile"] = device_idle_share(
            torch, lambda: short.plan(DP_X0, seed=0))
        out[mode]["profile"]["iterations"] = DP_PROFILE_ITERS
    (se, be), (sr, br) = plans["eager"], plans["replayed"]
    lanes_same = [same_plan(a, b) for a, b in zip(be, br)]
    check("device planner unit: replayed = eager bit for bit",
          same_plan(se, sr) and all(lanes_same),
          f"solo plan (200 iterations): {se.n_nodes} nodes, best "
          f"{se.info}; the 8 lanes bit-identical: {lanes_same}")
    check("device planner unit ran", se.n_nodes > 1
          and se.n_feasible_edges > 0 and all(
              r.n_nodes > 1 for r in be),
          f"solo {se.n_nodes} nodes, {se.n_feasible_edges} feasible edges; "
          f"lanes' nodes {[r.n_nodes for r in be]}, best scores "
          f"{[r.info for r in be]}")
    out["solo"] = {"n_nodes": se.n_nodes, "info": se.info,
                   "budget": se.budget, "feasible_edges":
                   se.n_feasible_edges}
    out["lanes"] = [{"n_nodes": r.n_nodes, "info": r.info,
                     "budget": r.budget} for r in be]
    return out


def dp_points5(res, cfg, S: int) -> np.ndarray:
    """(x, y, z, t, accrued variance) of a plan's edge samples rebuilt on
    the host from its primitive chain (the multi-fidelity costs' labels
    come from the accrued variance)."""
    from mfgp_tpu_torch.planning import primitives as prim
    from mfgp_tpu_torch.planning.primitives_device import padded_to_prims

    rows = []
    for padded, src, dst in res.edges:
        t, _, _, wpts, _ = prim.evaluate_trajectory(padded_to_prims(padded),
                                                    cfg)
        b = np.arctan2(dst[1] - src[1], dst[0] - src[0])
        ts = np.linspace(0.0, t, S)
        d, z, v = (np.interp(ts, wpts[:, 2], wpts[:, i]) for i in (0, 1, 3))
        rows.append(np.column_stack([src[0] + d * np.cos(b),
                                     src[1] + d * np.sin(b), z, ts, v]))
    return np.concatenate(rows)


def dp_host_score(torch, name, setup, eid64, res, S, dev) -> float:
    """The host cost of ``name`` in float64 on the card (the models'
    float64 copies) on the plan's extracted path (NaN without one)."""
    if not res.edges:
        return float("nan")
    pts = dp_points5(res, setup["cfg"].agent(), S)
    cost = planner_cost(name, setup, torch.float64, eid64, dev)
    if name in ("ergodic", "fourier"):
        return float(cost(res.points))
    if name == "sf_gain":
        return float(cost(np.column_stack([pts[:, :3],
                                           np.zeros(len(pts))])))
    if name == "sf_logdet":
        return float(cost(pts[:, :3]))
    return float(cost(pts))


def dp_record_lanes(ck, fn) -> tuple:
    """``fn()`` with the arguments of the first launch of B1's lane axis of
    each shape recorded; returns (fn's result, {shape: (args, kw)})."""
    real, seen = ck.ar1_cov_fused_lanes, {}

    def record(*args, **kw):
        seen.setdefault(lane_launch_shape(ck, args, kw), (args, kw))
        return real(*args, **kw)

    ck.ar1_cov_fused_lanes = record
    try:
        return fn(), seen
    finally:
        ck.ar1_cov_fused_lanes = real


def dp_costs(torch, ck, dev) -> dict:
    """(b) one plan per cost at the simulator's settings (max_iter 40, the
    first tranche B=15) in float32, replayed, against float64 eager on the
    card with the same draws and against the host cost re-scoring its path
    in float64; (c) the float32 eager loop under
    ``torch.cuda.set_sync_debug_mode("error")`` bit for bit the replayed
    one. Returns per cost its numbers and the recorded lane launches."""
    from mfgp_tpu_torch.planning.rig_device import (prepare_mf_gain_state,
                                                    prepare_sf_gain_state)

    setup = planner_setup(torch, dev)
    cfg = setup["cfg"]
    x0 = np.array([0.05 * (cfg.WS[0][1] - cfg.WS[0][0]),
                   0.05 * (cfg.WS[1][1] - cfg.WS[1][0])])
    out, lanes = {"n_train": setup["n"], "fit_s": setup["fit_s"]}, {}
    for name in PLANNER_COSTS:
        mf, gp = setup["models"][torch.float32]
        mf64, gp64 = setup["models"][torch.float64]
        eid = planner_eid(name, mf, gp, setup["grid"])
        eid64 = eid.double()
        grid = setup["ig_grid"] if name.endswith("logdet") else setup["grid"]
        n = int(setup["n"])
        nmax = 1 << max(9, (4 * n - 1).bit_length())  # the sim's pad
        if name.startswith("mf"):
            gp32 = prepare_mf_gain_state(mf, setup["fid_levels"], nmax)
            g64 = prepare_mf_gain_state(mf64, setup["fid_levels"], nmax)
        elif name.startswith("sf"):
            gp32 = prepare_sf_gain_state(gp, nmax)
            g64 = prepare_sf_gain_state(gp64, nmax)
        else:
            gp32 = g64 = None
        kw = dict(B=DP_B, max_iter=DP_COST_ITERS, grid=grid, cost=name)
        r32 = dp_rig(torch.float32, True, **kw)
        e32 = dp_rig(torch.float32, False, **kw)
        r64 = dp_rig(torch.float64, False, **kw)
        draws = r64.draws(torch.Generator().manual_seed(PLANNER_SEED))
        args = dict(B=DP_TRANCHE, eid=eid, gp=gp32, draws=draws)
        torch.cuda.reset_peak_memory_stats()
        first, p32 = wall(torch, lambda: r32.plan(x0, **args))
        second, _ = wall(torch, lambda: r32.plan(x0, **args))
        peak = torch.cuda.max_memory_allocated() / 1e9
        stats = dict(r32.stats)
        # the eager float32 loop with no host synchronisation allowed
        a = e32._args(x0, DP_TRANCHE, eid, gp32)
        d = e32._lane_draws(draws, 0, 1)
        torch.cuda.synchronize()
        sync_err = None
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, seen = dp_record_lanes(ck, lambda: e32._run(*a, d))
        except RuntimeError as e:
            sync_err, st, seen = str(e)[:300], None, {}
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        pe = e32._extract(e32._to_host(st), 0) if st is not None else None
        check(f"device planner {name}: eager loop without host sync",
              sync_err is None, f"set_sync_debug_mode('error') over the "
              f"eager loop of {DP_COST_ITERS} iterations: {sync_err}")
        check(f"device planner {name}: replayed = eager bit for bit",
              pe is not None and same_plan(pe, p32),
              f"{p32.n_nodes} nodes, best {p32.info}, chain {p32.chain}")
        f64_s, p64 = wall(torch, lambda: r64.plan(
            x0, B=DP_TRANCHE, eid=eid64, gp=g64, draws=draws))
        same_nodes = (p32.n_nodes == p64.n_nodes and np.allclose(
            p32.node_states, p64.node_states, atol=1e-4))
        same_path = p32.chain == p64.chain
        rel = (abs(p32.info - p64.info) / max(abs(p64.info), 1e-30)
               if np.isfinite(p64.info) else None)
        rtol = DP_RTOL
        check(f"device planner {name}: float32 vs float64 on the card",
              np.isfinite(p32.info) and np.isfinite(p64.info)
              and ((same_nodes and same_path and rel <= rtol)
                   or not (same_nodes and same_path)),
              f"nodes {p32.n_nodes} / {p64.n_nodes} (same within 1e-4: "
              f"{same_nodes}), best chain equal: {same_path}, score "
              f"{p32.info} / {p64.info} (rel {rel}, <= {rtol:g} when the "
              "same path is chosen)" + ("" if same_nodes and same_path else
                                        "; float32 flipped a beam "
                                        "selection: the plans part"))
        host = dp_host_score(torch, name, setup, eid64, p32, r32.S, dev)
        hrel = abs(p32.info - host) / max(abs(host), 1e-30)
        hbar = DP_ERGODIC_HOST_RTOL if name == "ergodic" else rtol
        check(f"device planner {name}: score = host cost in float64",
              bool(hrel <= hbar), f"device {p32.info}, host {host} on the "
              f"extracted path of {p32.points.shape[0]} points (rel "
              f"{hrel:.3e} <= {hbar:g})")
        lanes.update({(name, k): v for k, v in seen.items()})
        out[name] = {"plan_s_first": first, "plan_s": second,
                     "eager_s": eager_s, "f64_eager_s": f64_s,
                     "n_pad": nmax if gp32 is not None else None,
                     "nodes": [p32.n_nodes, p64.n_nodes],
                     "same_nodes": same_nodes, "same_path": same_path,
                     "score_f32": p32.info, "score_f64": p64.info,
                     "rel": rel, "host_score_f64": host, "host_rel": hrel,
                     "path_points": int(p32.points.shape[0]),
                     "feasible_edges": p32.n_feasible_edges,
                     "peak_gb": peak, "stats": stats}
        if name == "mf_gain":
            out[name]["profile_one_plan"] = device_idle_share(
                torch, lambda: r32.plan(x0, **args))
        emit("device_planner_cost", cost=name, nvidia_smi=nvidia_smi(),
             **out[name])
    return {"costs": out, "lanes": lanes, "setup": setup}


def dp_b1(torch, ck, dev, lanes: dict, setup: dict) -> dict:
    """(e) B1 at the device planner's launch shapes: the first lane-axis
    launch of each shape the float32 eager plans made, held and timed by
    ``planner_lane_check``; the padded training rows (at 1e6) exactly 0 in
    float32; and the log-det costs' grid blocks (the padded training set
    against the IG grid, and the grid's Gram) against float64."""
    from mfgp_tpu_torch.planning.rig_device import (prepare_mf_gain_state,
                                                    prepare_sf_gain_state)
    from mfgp_tpu_torch.utils.device import points_like

    times, zeros = {}, {}
    n = int(setup["n"])
    done = set()
    for (name, shape), (args, kw) in lanes.items():
        a = dict(zip(LANE_ARGS, args), **kw)
        X1, X2 = a["X1"], a["X2"]
        for side, X in (("rows", X1), ("cols", X2)):
            if X.shape[1] > n and bool((X[0, n:] == 1e6).all()):
                got = ck.ar1_cov_fused_lanes(*args, **kw)
                pad = got[:, n:, :] if side == "rows" else got[:, :, n:]
                zeros[f"{name} {shape}"] = int((pad != 0).sum())
        key = f"{'mf' if name.startswith('mf') else 'sf'} {shape}"
        if key in done:
            continue
        done.add(key)
        times[f"{name} {shape}"] = planner_lane_check(
            torch, ck, f"device_planner_{name}", args, kw)
    check("device planner B1: padded rows exactly 0 in float32",
          zeros and not any(zeros.values()),
          f"nonzero entries at the padded training rows: {zeros}")
    mf, gp = setup["models"][torch.float32]
    nmax = 1 << max(9, (4 * n - 1).bit_length())
    G = points_like(setup["ig_grid"], mf.X)
    Xm, fm, _, vm, lm, rm = prepare_mf_gain_state(
        mf, setup["fid_levels"], nmax)[:6]
    Xs, _, vs, ls_, _ = prepare_sf_gain_state(gp, nmax)
    gf = torch.full((G.shape[0],), 2, dtype=torch.long, device=dev)
    z = torch.zeros(nmax, dtype=torch.long, device=dev)
    zg = torch.zeros(G.shape[0], dtype=torch.long, device=dev)
    one = (vs.reshape(1), ls_.reshape(1, -1), vs.new_zeros(0))
    for a in ((Xm, fm, G, gf, vm, lm, rm), (G, gf, G, gf, vm, lm, rm),
              (Xs, z, G, zg, *one), (G, zg, G, zg, *one)):
        b1_path_check(torch, ck, "device planner grid block", *a)
    return times


class DevicePlanProbe(ExploreProbe):
    """ExploreProbe with the device planner's plan as the "plan" stage, and
    every loop's own B1 count: a captured launch counts once in
    ``LAUNCHES`` but runs once per replay, so ``extra`` adds the replays'
    launches the counter did not see."""

    def __init__(self, torch, ck, explore_mod, rig_mod, model_mods,
                 device_rig_mod):
        super().__init__(torch, ck, explore_mod, rig_mod, model_mods)
        self.extra, self.plans = 0, []
        self._wrap(device_rig_mod.DeviceRIGAdapter, "plan",
                   self._stage("plan"))
        self._wrap(device_rig_mod.DeviceRIG, "_run", self._loop)

    def _loop(self, orig):
        def run(rig, *a, **kw):
            n0 = self.ck.LAUNCHES["ar1_cov_fused"]
            st = orig(rig, *a, **kw)
            s = dict(rig.stats, cost=rig.cost, lanes=int(a[0].shape[0]))
            # the loop's launches that the counter did not see: replays
            self.extra += s["b1_launches"] - (
                self.ck.LAUNCHES["ar1_cov_fused"] - n0)
            self.plans.append(s)
            if self.cur is not None:
                self.cur.setdefault("loops", []).append(s)
            return st
        return run


def device_planner_phase(torch, ck, cov, dev) -> dict:
    """Phase 13 (see the module docstring). Returns the launches of the
    closed-loop runs (d), counted from 0 just before the first, B1's with
    every replay of a captured launch."""
    from mfgp_tpu_torch import cli
    from mfgp_tpu_torch.models import gp as gp_mod
    from mfgp_tpu_torch.models import mfgp as mfgp_mod
    from mfgp_tpu_torch.planning import rig as rig_mod
    from mfgp_tpu_torch.planning import rig_device as rd_mod
    from mfgp_tpu_torch.sim import explore as ex

    parts = {}
    t0 = time.perf_counter()
    unit = dp_unit(torch, dev)
    emit("device_planner_unit", nvidia_smi=nvidia_smi(), **unit)
    parts["a_unit"] = time.perf_counter() - t0
    costs = dp_costs(torch, ck, dev)
    parts["b_costs"] = time.perf_counter() - t0 - sum(parts.values())
    b1 = dp_b1(torch, ck, dev, costs["lanes"], costs["setup"])
    emit("device_planner_b1", nvidia_smi=nvidia_smi(), times=b1)
    parts["e_b1"] = time.perf_counter() - t0 - sum(parts.values())
    del costs
    torch.cuda.empty_cache()

    probe = DevicePlanProbe(torch, ck, ex, rig_mod, (gp_mod, mfgp_mod),
                            rd_mod)
    base = tempfile.mkdtemp(prefix="mfgp_device_planner_")
    try:
        runs = {}
        ck.reset_launches()
        probe.extra = 0
        for label, flags, cost, ens in DP_RUNS:
            out = os.path.join(base, label)
            argv = ["explore", *flags, "--planner", "device", *EXPLORE_ARGS,
                    "--out", out]
            buf = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            rec = probe.runs[-1]
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            runs[label] = (rec, cost, ens, out, json.loads(
                buf.getvalue().strip().splitlines()[-1]))
        launches = dict(ck.LAUNCHES)
        counted, replayed = launches["ar1_cov_fused"], probe.extra
        launches["ar1_cov_fused"] += replayed
        parts["d_runs"] = time.perf_counter() - t0 - sum(parts.values())
        # one replan under the profiler (not counted in the launches above)
        label, flags = DP_PROFILED
        with contextlib.redirect_stdout(io.StringIO()):
            idle = device_idle_share(torch, lambda: cli.main(
                ["explore", *flags, "--planner", "device", "--out",
                 os.path.join(base, "profiled")]))
        emit("device_planner_idle", run=f"{label}, one replan",
             nvidia_smi=nvidia_smi(), idle=idle,
             stages=explore_stage_table(probe.runs[-1]))
        parts["d_profiled_replan"] = (time.perf_counter() - t0
                                      - sum(parts.values()))
        for label, (rec, cost, ens, out, doc) in runs.items():
            explore_run_checks(torch, f"device {label}", rec, cost, out,
                               doc)
            res, loops = rec["result"], rec.get("loops", [])
            rig = rec["sim"]._device_planner
            check(f"device planner closed loop {label}",
                  rig is not None and rig._planner.cost == cost
                  and rig._n_plans == ens and len(loops) == len(rec["plan"])
                  and len(res.replans) >= len(loops) - 1
                  and all(s["lanes"] == ens and s["replays"] > 0
                          for s in loops)
                  and (cost == "ergodic" or all(s["b1_launches"] > 0
                                                for s in loops)),
                  f"{len(res.replans)} replans, {len(loops)} device loops "
                  f"(one per plan; a plan that finds no path ends the run) "
                  f"({[(s['lanes'], s['replays'], s['b1_launches'])
                        for s in loops][:3]}...: lanes, replays, B1 "
                  f"launches), cost "
                  f"{rig._planner.cost if rig else None}")
            emit("device_planner_explore", run=label,
                 nvidia_smi=nvidia_smi(), wall_s=rec["wall_s"],
                 replans=len(res.replans), budget_used=res.budget_used,
                 rmse=res.rmse, peak_gb=rec["peak_gb"],
                 stages=explore_stage_table(rec),
                 b1_per_plan=[s["b1_launches"] for s in loops])
        check("device planner launches", launches["ar1_cov_fused"] > 0,
              f"kernel launches over the {len(DP_RUNS)} runs: {launches} "
              f"(B1: {counted} counted, of them captured once and replayed: "
              f"+{replayed})")
        parts["d_checks"] = time.perf_counter() - t0 - sum(parts.values())
        emit("device_planner_seconds", **parts)
    finally:
        probe.restore()
        shutil.rmtree(base, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# 14. the mission (sim/mission_device.py, hw/runtime_device.py)
# ---------------------------------------------------------------------------
# the command line at its defaults (MFEGP, --budget 80 --bd 4 --plan-iters
# 40 --e-max 16, kinematic flight), then the refits, dynamic flight, the
# ensemble and the campaign
MISSION_RUNS = (
    ("a_kinematic", ["mission"]),
    ("b_refit", ["mission", "--variant", "MFGP", "--update-hyps",
                 "--fit-restarts", "4", "--budget", "40", "--bd", "2"]),
    ("c_dynamic", ["mission", "--variant", "SFEGP", "--flight", "dynamic"]),
    ("c_dynamic_stride4", ["mission", "--variant", "SFEGP", "--flight",
                           "dynamic", "--glide-stride", "4"]),
    ("d_ensemble8", ["mission", "--ensemble", "8"]),
    ("e_campaign", ["campaign"]),
)
# the command line's mission defaults, for the yardsticks of (a) and (d)
# (ExperimentConfig refits by default; the command line only with
# --update-hyps)
MISSION_EXP = dict(multi_fidelity=True, ergodic=True, B=80.0, BD=4,
                   update_hyps=False)
# traced by torch.profiler: a warm mission of one of the defaults' 20-unit
# tranches with 10 planner iterations (one such replan at the defaults' 40
# is ~1 million device events, ~100 s of the profiler's work)
MISSION_PROFILED = dict(multi_fidelity=True, ergodic=True, B=20.0, BD=1,
                        update_hyps=False)
MISSION_PROFILED_ITERS = 10
MISSION_RMSE_RATIO = 2.0  # float32 within 2x of float64 (PR 8's bar)
MISSION_ENSEMBLE_RTOL = 1e-6  # member 0 vs the solo run, float64
MISSION_EAGER_TICKS = 200  # eager ticks timed (the eager loop is slow)
MISSION_STRIDE_TICKS = 1024  # ticks of the glide-stride comparison


class MissionProbe:
    """Records missions as the CLI drives them, by wrapping
    ``DeviceMission``'s replan body and stages, ``DeviceRIG._run``,
    ``DeviceRuntime._fly`` and B1's lane-axis wrapper at class or module
    level: per replan the seconds of each stage on a CUDA-synchronised host
    clock and B1's launches (a launch captured in the planner's graph
    counts once in ``LAUNCHES`` and runs once per replay: ``extra`` adds
    the replays), the planner's stats, the runtime's flight stats and the
    first flight's inputs, each run's mission, result and wall, and the
    first lane-axis B1 launch of each shape. ``restore`` puts everything
    back; the package is unchanged."""

    STAGES = (("_eid_stage", "eid"), ("_plan_stage", "plan"),
              ("_flight_stage", "flight"), ("_extend_arena", "extend"),
              ("_refit_stage", "refit"))

    def __init__(self, torch, ck, md, rd, rtd):
        self.torch, self.ck = torch, ck
        self.saved, self.runs, self.cur, self.rep = [], [], None, None
        self.extra, self.flights, self.lanes, self.first_flight = 0, [], {}, None
        self.record_lanes = True
        M = md.DeviceMission
        self._wrap(M, "run", self._run("run"))
        self._wrap(M, "run_ensemble", self._run("run_ensemble"))
        self._wrap(M, "_body", self._body)
        for name, stage in self.STAGES:
            self._wrap(M, name, self._stage(stage))
        self._wrap(rd.DeviceRIG, "_run", self._plan)
        self._wrap(rtd.DeviceRuntime, "_fly", self._fly)
        self._wrap(ck, "ar1_cov_fused_lanes", self._lanes)

    def restore(self):
        for obj, name, orig in reversed(self.saved):
            setattr(obj, name, orig)

    def _wrap(self, obj, name, make):
        orig = getattr(obj, name)
        self.saved.append((obj, name, orig))
        setattr(obj, name, make(orig))

    def _b1(self) -> int:
        return self.ck.LAUNCHES["ar1_cov_fused"] + self.extra

    def _sync_clock(self):
        self.torch.cuda.synchronize()
        return time.perf_counter()

    def _run(self, kind):
        def make(orig):
            def run(mission, *a, **kw):
                outer, self.cur = self.cur, {"mission": mission, "kind": kind,
                                             "replans": []}
                t0 = self._sync_clock()
                try:
                    res = orig(mission, *a, **kw)
                    self.cur.update(result=res,
                                    wall_s=self._sync_clock() - t0,
                                    refits=list(mission.refits))
                    self.runs.append(self.cur)
                finally:
                    self.cur = outer
                return res
            return run
        return make

    def _body(self, orig):
        def run(mission, r, *a, **kw):
            self.rep = {"replan": r}
            b1, t0 = self._b1(), self._sync_clock()
            out = orig(mission, r, *a, **kw)
            self.rep.update(seconds=self._sync_clock() - t0,
                            b1=self._b1() - b1)
            if self.cur is not None:
                self.cur["replans"].append(self.rep)
            return out
        return run

    def _stage(self, stage):
        def make(orig):
            def run(obj, *a, **kw):
                t0 = self._sync_clock()
                out = orig(obj, *a, **kw)
                if self.rep is not None:
                    self.rep[stage] = self._sync_clock() - t0
                return out
            return run
        return make

    def _plan(self, orig):
        def run(rig, *a, **kw):
            n0 = self.ck.LAUNCHES["ar1_cov_fused"]
            st = orig(rig, *a, **kw)
            s = dict(rig.stats, lanes=int(a[0].shape[0]))
            self.extra += s["b1_launches"] - (
                self.ck.LAUNCHES["ar1_cov_fused"] - n0)
            if self.rep is not None:
                self.rep["planner"] = s
            return st
        return run

    def _fly(self, orig):
        def run(rt, plan, carry, noise, t_cap):
            if self.first_flight is None:
                self.first_flight = (rt, plan, {k: v.clone() for k, v in
                                                carry.items()},
                                     noise.clone(), t_cap)
            out = orig(rt, plan, carry, noise, t_cap)
            if self.rep is not None:
                self.rep["fly"] = dict(rt.last_fly, stride=rt.glide_stride)
            return out
        return run

    def _lanes(self, orig):
        def run(*args, **kw):
            if self.record_lanes:
                key = lane_launch_shape(self.ck, args, kw)
                self.lanes.setdefault(key, (args, kw))
            return orig(*args, **kw)
        return run


def mission_stage_table(rec) -> list:
    """Per replan: its seconds by stage, B1's launches (replays counted)
    and the planner's replays and capture seconds."""
    out = []
    for r in rec["replans"]:
        p = r.get("planner", {})
        out.append({k: r.get(k) for k in ("replan", "seconds", "eid", "plan",
                                           "flight", "extend", "refit",
                                           "b1")}
                   | {"plan_replays": p.get("replays"),
                      "plan_capture_s": p.get("capture_s"),
                      "plan_b1_captured": p.get("b1_captured"),
                      "fly": r.get("fly")})
    return out


def mission_cli(torch, cli, argv) -> tuple:
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    return (json.loads(buf.getvalue().strip().splitlines()[-1]),
            time.perf_counter() - t0)


def mission_tick_times(torch, rtd, flight) -> dict:
    """One recorded flight (the first of the dynamic run: its plan, carry
    and noise) flown again by fresh runtimes over its first
    ``MISSION_STRIDE_TICKS`` ticks: eager on its first
    ``MISSION_EAGER_TICKS``; replayed, and with ``glide_stride`` 4; and a
    50 s prefix of it with the early stop against the same running all
    the ticks. Seconds on a CUDA-synchronised host clock, each timed
    flight after one that captured its graphs."""
    rt0, plan, carry, noise, t_cap = flight
    cap = min(t_cap, MISSION_STRIDE_TICKS)
    n_live = int(min(int((torch.ceil(plan.t_end / rt0.cfg.dt) + 1).max()),
                     cap))
    prefix = plan._replace(t_end=torch.clamp_max(plan.t_end, 50.0))

    def runtime(**kw):
        return rtd.DeviceRuntime(rt0.agent, rt0.cfg, field=rt0.field,
                                 max_depth=rt0.max_depth, dtype=rt0.dtype,
                                 w_cap=rt0.w_cap, l_cap=rt0.l_cap,
                                 device=rt0.device, **kw)

    def fly(rt, p=plan, reps=2):
        for _ in range(reps):
            s, _ = wall(torch, lambda: rt.fly(p, carry, noise, cap))
        return s, dict(rt.last_fly)

    cap_e = min(cap, MISSION_EAGER_TICKS)
    s_e, _ = wall(torch, lambda: runtime(graph=False, early_stop=False).fly(
        plan, carry, noise, cap_e))
    rt = runtime(early_stop=False)
    s_r, st_r = fly(rt)
    s_all, _ = fly(rt, prefix, reps=1)
    rt.early_stop = True
    s_stop, st_stop = fly(rt, prefix, reps=1)
    s4, st4 = fly(runtime(early_stop=False, glide_stride=4))
    return {"ticks": cap, "live_ticks": n_live,
            "eager_us_per_tick": s_e / cap_e * 1e6, "eager_ticks": cap_e,
            "replayed_us_per_tick": s_r / cap * 1e6, "replayed_s": s_r,
            "replayed_stats": st_r,
            "prefix_all_ticks_s": s_all, "prefix_early_stop_s": s_stop,
            "prefix_early_stop_stats": st_stop,
            "stride4_s": s4, "stride4_stats": st4,
            "stride4_us_per_fine_tick": s4 / cap * 1e6}


def mission_phase(torch, ck, cov, dev) -> dict:
    """Phase 14 (see the module docstring). Returns the launches of the
    command-line runs (a)-(e), counted from 0 just before the first, B1's
    with every replay of a launch captured in the planner's graph."""
    from mfgp_tpu_torch import cli
    from mfgp_tpu_torch.hw import runtime_device as rtd
    from mfgp_tpu_torch.planning import rig_device as rd
    from mfgp_tpu_torch.sim import mission_device as md
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    parts, t_phase = {}, time.perf_counter()

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    probe = MissionProbe(torch, ck, md, rd, rtd)
    try:
        outs = {}
        ck.reset_launches()
        probe.extra = 0
        torch.cuda.reset_peak_memory_stats()
        for label, argv in MISSION_RUNS:
            n0 = len(probe.runs)
            doc, secs = mission_cli(torch, cli, argv)
            outs[label] = (doc, secs, probe.runs[n0:])
            if label == "a_kinematic":
                peak_a = torch.cuda.max_memory_allocated() / 1e9
            part(label)
        launches = dict(ck.LAUNCHES)
        counted = launches["ar1_cov_fused"]
        launches["ar1_cov_fused"] += probe.extra
        probe.record_lanes = False
        smi = nvidia_smi()

        # (a) kinematic at the defaults: float32, then float64 on the same
        # seed, and one flight's filter eager against a graph
        doc, secs, recs = outs["a_kinematic"]
        cold = recs[0]
        exp = ExperimentConfig(**MISSION_EXP)
        m64 = md.DeviceMission(exp, seed=0, dtype=torch.float64, device=dev)
        s64, r64 = wall(torch, m64.run)
        res32 = cold["result"]
        filt = explore_filter_times(torch, cold["mission"].kf_model,
                                    res32.flown[0][res32.flown_mask[0]])
        mw = md.DeviceMission(ExperimentConfig(**MISSION_PROFILED), seed=1,
                              plan_iters=MISSION_PROFILED_ITERS, device=dev)
        mw.run()
        idle = device_idle_share(torch, mw.run)
        part("a_yardsticks")
        MISSION_RMSE0["rmse"] = doc["rmse"]
        check("mission (a) kinematic",
              doc["replans"] >= 1 and np.isfinite(doc["rmse"])
              and doc["rmse"] <= MISSION_RMSE_RATIO * r64.rmse
              and all(r["b1"] > 0 for r in cold["replans"]),
              f"{doc['replans']} replans, n_data {doc['n_data']}, RMSE "
              f"float32 {doc['rmse']:.6g} vs float64 {r64.rmse:.6g} "
              f"(<= {MISSION_RMSE_RATIO}x), B1 per replan "
              f"{[r['b1'] for r in cold['replans']]} (> 0 each)")
        emit("mission_kinematic", nvidia_smi=smi, cli=doc, cli_s=secs,
             rmse_f32=doc["rmse"], rmse_f64=r64.rmse, seconds_f64=s64,
             replans_f64=r64.n_replans, ratio_to_f64=doc["rmse"] / r64.rmse,
             finite_test_mu=bool(np.isfinite(res32.test_mu).all()),
             filter=filt, peak_gb=peak_a, idle=idle,
             idle_run=dict(MISSION_PROFILED,
                           plan_iters=MISSION_PROFILED_ITERS),
             stages=mission_stage_table(cold),
             stages_warm=mission_stage_table(recs[1]))

        # (b) refits with 4 restarts
        doc, secs, recs = outs["b_refit"]
        fits = recs[0]["refits"]
        ok = (len(fits) >= 1 and all(
            np.all(np.isfinite(f["f"])) and np.all(np.asarray(f["f"])
                                                   <= np.asarray(f["f_start"]))
            for f in fits) and all(r["b1"] > 0 for r in recs[0]["replans"]))
        check("mission (b) refits", ok,
              f"{len(fits)} refits: NLML start->end "
              f"{[(f['f_start'][0], f['f'][0]) for f in fits]} (finite, "
              f"never above the warm start), B1 per replan "
              f"{[r['b1'] for r in recs[0]['replans']]}")
        emit("mission_refit", nvidia_smi=smi, cli=doc, cli_s=secs,
             refits=fits, stages=mission_stage_table(recs[0]))

        # (c) dynamic flight
        check("mission (c) a flight", probe.first_flight is not None,
              "the dynamic runs flew a plan")
        ticks = (mission_tick_times(torch, rtd, probe.first_flight)
                 if probe.first_flight is not None else None)
        part("c_tick_times")
        for label in ("c_dynamic", "c_dynamic_stride4"):
            doc, secs, recs = outs[label]
            res = recs[0]["result"]
            check(f"mission (c) {label}",
                  res.n_replans >= 1 and not res.meas_overflow
                  and all(r["tracking_rmse"] > 0.01 and r["flown_budget"] > 0
                          for r in res.replans),
                  f"{res.n_replans} replans, tracking RMSE "
                  f"{[r['tracking_rmse'] for r in res.replans]}, flown "
                  f"budget {[r['flown_budget'] for r in res.replans]}, "
                  f"meas_overflow {res.meas_overflow}")
            emit("mission_dynamic", run=label, nvidia_smi=smi, cli=doc,
                 cli_s=secs, stages=mission_stage_table(recs[0]),
                 **({"ticks": ticks} if label == "c_dynamic" else {}))

        # (d) the ensemble, and member 0 against the solo run in float64
        doc, secs, recs = outs["d_ensemble8"]
        ens64 = md.DeviceMission(exp, seed=0, dtype=torch.float64,
                                 device=dev)
        s_e64, e64 = wall(torch, lambda: ens64.run_ensemble(8))
        e0 = e64[0]
        # warm against warm: the command line's ensemble run captures the
        # 8-lane graphs, so one float32 mission times its second solo run
        # against its second 8-member ensemble
        mw8 = md.DeviceMission(exp, seed=0, device=dev)
        mw8.run()
        s_solo_w, _ = wall(torch, mw8.run)
        mw8.run_ensemble(8)
        s_ens_w, _ = wall(torch, lambda: mw8.run_ensemble(8))
        same = (e0.n_replans == r64.n_replans
                and np.array_equal(e0.flown_mask, r64.flown_mask)
                and np.allclose(e0.flown, r64.flown, rtol=1e-9, atol=1e-9))
        check("mission (d) ensemble member 0 = solo (float64)",
              same and abs(e0.rmse - r64.rmse)
              <= MISSION_ENSEMBLE_RTOL * abs(r64.rmse),
              f"replans {e0.n_replans} vs {r64.n_replans}, chains equal "
              f"{same}, RMSE {e0.rmse:.12g} vs {r64.rmse:.12g}")
        emit("mission_ensemble", nvidia_smi=smi, cli=doc, cli_s=secs,
             cli_ensemble_over_warm_solo=doc["ensemble_seconds"]
             / doc["launch_seconds_warm"],
             warm_ensemble8_s=s_ens_w, warm_solo_s=s_solo_w,
             warm_ensemble_over_warm_solo=s_ens_w / s_solo_w,
             f64_ensemble8_s=s_e64,
             stages=mission_stage_table(
                 [r for r in recs if r["kind"] == "run_ensemble"][0]))
        part("d_f64")

        # (e) the campaign
        doc, secs, recs = outs["e_campaign"]
        check("mission (e) campaign",
              doc["runs"] == 20 and all(
                  np.isfinite(doc[v]["rmse"]).all()
                  for v in ("MFEGP", "MFGP", "SFEGP", "SFGP")),
              f"{doc['runs']} runs, RMSE means "
              f"{[doc[v]['rmse_mean'] for v in ('MFEGP', 'MFGP', 'SFEGP', 'SFGP')]}")
        emit("mission_campaign", nvidia_smi=smi, cli=doc, cli_s=secs)

        # (f) B1 at the mission's launch shapes
        b1 = {k: planner_lane_check(torch, ck, "mission " + k, a, kw)
              for k, (a, kw) in list(probe.lanes.items())[:12]}
        emit("mission_b1", nvidia_smi=smi, times=b1)
        part("f_b1")
        check("mission launches", launches["ar1_cov_fused"] > 0,
              f"kernel launches over the {len(MISSION_RUNS)} runs: "
              f"{launches} (B1: {counted} counted, of them captured once "
              f"and replayed: +{probe.extra})")
        emit("mission_seconds", **parts)
    finally:
        probe.restore()
    return launches


# ---------------------------------------------------------------------------
# 15. serving (serve.py): the model, planner and mission services
# ---------------------------------------------------------------------------
SERVE_CLIENTS = 8  # concurrent /predict and /plan clients
SERVE_BATCH_WAIT = 0.05  # the batcher's window: the clients' posts land
SERVE_EXTEND = 64  # points pushed through /extend
# float32 served results against direct calls: max abs error over the
# largest |value| (the same computation, batched differently)
SERVE_RTOL = 1e-5
# /extend (a bordered Cholesky block, float32 at N=20,000) against a model
# conditioned from scratch in float64 on the same N+64 points, max abs
# error over the largest |value|. Float32 conditioning at N=20,000 puts a
# float32 model conditioned from scratch 9.0e-4 (mean) and 6.8e-3 (var)
# off float64 on the H100, so the extension is held to at most 1.5x that
# model's error, and under an absolute bar about 3x the readings.
SERVE_EXTEND_RATIO = 1.5
SERVE_EXTEND_F64 = {"mean": 3e-3, "var": 2e-2}
SERVE_PLAN_ITERS = 40  # the simulator's plan_iters (sim/explore.py:89)
SERVE_PLAN_B = 15.0  # the simulator's first tranche (sim/explore.py:343)
SERVE_PATH_TOL = 1e-4  # coalesced lane vs solo plan (tests/test_serve.py)
# the command line's mission defaults (MFEGP, --budget 80 --bd 4
# --plan-iters 40 --e-max 16), as a mission server's POST body
SERVE_MISSION = {"variant": "MFEGP", "budget": 80.0, "bd": 4,
                 "plan_iters": 40, "e_max": 16}
SERVE_TIMEOUT_S = 300.0  # every wait of the phase is bounded
MISSION_RMSE0: dict = {}  # phase 14's seed-0 command-line RMSE


class CaptureCount:
    """Counts CUDA graph captures (``torch.cuda.CUDAGraph.capture_begin``,
    which ``torch.cuda.graph`` calls) while installed; ``restore`` puts
    the method back."""

    def __init__(self, torch):
        self.cls, self.n = torch.cuda.CUDAGraph, 0
        self.orig = self.cls.capture_begin
        count = self

        def capture_begin(graph, *a, **kw):
            count.n += 1
            return count.orig(graph, *a, **kw)

        self.cls.capture_begin = capture_begin

    def restore(self):
        self.cls.capture_begin = self.orig


class Served:
    """A service behind ``serve.make_http_server`` on port 0 in a daemon
    thread; ``post``/``get`` carry timeouts, ``stop`` shuts it down."""

    def __init__(self, serve, service):
        import threading

        self.srv = serve.make_http_server(service, port=0)
        self.addr = self.srv.server_address
        self.url = "http://%s:%d" % self.addr
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.stopped = False

    def call(self, method, path, body=None):
        import http.client

        conn = http.client.HTTPConnection(*self.addr,
                                          timeout=SERVE_TIMEOUT_S)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body))
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def stop(self):
        if not self.stopped:
            self.stopped = True
            self.srv.shutdown()
            self.srv.server_close()
            self.thread.join(timeout=SERVE_TIMEOUT_S)


class ServedLaunches:
    """The launches of served calls only. ``window(route)`` adds the
    counters' increase over a block of served calls. A launch captured in
    the planner's graph counts once in ``LAUNCHES`` and runs once per
    replay, so the wrapped ``DeviceRIG._run`` adds the plan's
    ``stats["b1_launches"]`` less the counter's increase during it, as
    ``DevicePlanProbe`` does, while a window is open. References, kernel
    checks and timings run outside every window. ``restore`` unwraps."""

    def __init__(self, ck, rd):
        self.ck, self.cls, self.orig = ck, rd.DeviceRIG, rd.DeviceRIG._run
        self.counts = dict.fromkeys(ck.LAUNCHES, 0)
        self.b1_by_route, self.open, self.replayed = {}, False, 0
        count = self

        def run(rig, *a, **kw):
            n0 = ck.LAUNCHES["ar1_cov_fused"]
            st = count.orig(rig, *a, **kw)
            if count.open:
                count.replayed += rig.stats["b1_launches"] - (
                    ck.LAUNCHES["ar1_cov_fused"] - n0)
            return st

        self.cls._run = run

    @contextlib.contextmanager
    def window(self, route):
        before, r0 = dict(self.ck.LAUNCHES), self.replayed
        self.open = True
        try:
            yield
        finally:
            self.open = False
            for k, n in self.ck.LAUNCHES.items():
                self.counts[k] += n - before[k]
            b1 = (self.ck.LAUNCHES["ar1_cov_fused"] - before["ar1_cov_fused"]
                  + self.replayed - r0)
            self.counts["ar1_cov_fused"] += self.replayed - r0
            self.b1_by_route[route] = self.b1_by_route.get(route, 0) + b1

    def restore(self):
        self.cls._run = self.orig


def concurrently(fns) -> list:
    """Run each ``fn`` in its own thread, released together by a barrier;
    returns [(result or exception, seconds)], each thread joined with a
    timeout."""
    import threading

    out = [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def run(i):
        barrier.wait(timeout=SERVE_TIMEOUT_S)
        t0 = time.perf_counter()
        try:
            r = fns[i]()
        except Exception as e:  # noqa: BLE001 (reported by the caller)
            r = e
        out[i] = (r, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT_S)
    return [o if o is not None else (TimeoutError("no answer"), None)
            for o in out]


def rel_err(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


def serve_model_part(torch, ck, dev, serve, problem, served) -> dict:
    """(a): the unit's MFGP saved with the port's checkpoint and served;
    8 concurrent /predict clients over the grid, /eid, /extend (against
    float32 and float64 models conditioned from scratch)."""
    from mfgp_tpu_torch.models.mfgp import MFGPParams
    from mfgp_tpu_torch.models.mfgp import MFGP
    from mfgp_tpu_torch.utils import checkpoint as ckpt

    X, fid, y, grid, _, params = problem
    model = MFGP(X, fid, y, n_fidelities=3, params=params, jitter=1e-6)
    d = tempfile.mkdtemp(prefix="mfgp_serve_")
    try:
        ck0 = ckpt.ExplorationCheckpoint(
            plan_num=0, t_now=0.0, planned_budget=0.0, x0=np.zeros((2, 1)),
            model=ckpt.capture_model(model), data_rows=np.zeros((0, 9)),
            rng_state=np.random.default_rng(0).bit_generator.state)
        ckpt.save_checkpoint(os.path.join(d, "unit"), ck0)
        del model
        t0 = time.perf_counter()
        with served.window("load"):
            ms = serve.ModelServer.from_checkpoint(
                os.path.join(d, "unit"), device=dev,
                batch_wait=SERVE_BATCH_WAIT)
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    m = ms.model
    out = {"n": int(m.X.shape[0]), "dtype": str(m.X.dtype),
           "device": str(m.X.device), "load_and_condition_s": load_s}
    check("serve (a) checkpoint restored float32 on the card",
          m.X.dtype == torch.float32 and m.X.is_cuda,
          f"{out['dtype']} on {out['device']}")
    gnp = grid.cpu().numpy().astype(np.float64)
    s, (mu_ref, var_ref) = wall(torch, lambda: m.predict(grid))
    mu_ref, var_ref = (mu_ref.cpu().numpy(), var_ref.cpu().numpy())
    out["direct_predict_s"] = s
    h = Served(serve, ms)
    try:
        parts = np.array_split(np.arange(gnp.shape[0]), SERVE_CLIENTS)
        l0, b0 = ms.batcher.launches, ck.LAUNCHES["ar1_cov_fused"]
        r0 = ms.batcher.batched_requests
        t0 = time.perf_counter()
        with served.window("predict"):
            res = concurrently([
                (lambda p=p: h.call("POST", "/predict",
                                    {"points": gnp[p].tolist()}))
                for p in parts])
        total = time.perf_counter() - t0
        ok = all(not isinstance(r, Exception) and r[0] == 200
                 for r, _ in res)
        launches = ms.batcher.launches - l0
        mu = np.concatenate([r[1]["mean"] for r, _ in res]) if ok else None
        var = np.concatenate([r[1]["var"] for r, _ in res]) if ok else None
        e_mu = rel_err(mu, mu_ref) if ok else None
        e_var = rel_err(var, var_ref) if ok else None
        out["predict"] = {
            "clients": SERVE_CLIENTS, "points": int(gnp.shape[0]),
            "launches": launches,
            "requests_per_launch": (ms.batcher.batched_requests - r0)
            / max(launches, 1),
            "max_requests_per_launch": ms.batcher.max_requests_per_launch,
            "request_s": [t for _, t in res], "total_s": total,
            "grid_points_per_s": gnp.shape[0] / total,
            "b1_launches": ck.LAUNCHES["ar1_cov_fused"] - b0,
            "rel_err_mean": e_mu, "rel_err_var": e_var}
        check("serve (a) 8 concurrent /predict",
              ok and out["predict"]["requests_per_launch"] > 1
              and e_mu <= SERVE_RTOL and e_var <= SERVE_RTOL
              and out["predict"]["b1_launches"] > 0,
              f"{launches} launches, {out['predict']['requests_per_launch']:.3g}"
              f" requests per launch (> 1), vs direct predict: mean "
              f"{e_mu}, var {e_var} (<= {SERVE_RTOL} of max |value|), B1 "
              f"{out['predict']['b1_launches']} (> 0), {total:.4g} s")
        with served.window("eid"):
            code, eid = h.call("POST", "/eid", {"points": gnp.tolist()})
        esum = float(np.sum(eid["eid"])) if code == 200 else None
        check("serve (a) /eid sums to 1", code == 200
              and abs(esum - 1.0) <= 1e-6, f"HTTP {code}, sum {esum}")
        # /extend: 64 more points, then the grid against models
        # conditioned from scratch on the same N + 64 points: float32 (the
        # same arithmetic as the served one) and the float64 witness
        g = np.random.default_rng(15)
        lo, hi = (X.amin(0).cpu().numpy(), X.amax(0).cpu().numpy())
        Xn = lo + (hi - lo) * g.random((SERVE_EXTEND, 3))
        fn = g.integers(0, 3, SERVE_EXTEND)
        yn = 10.0 * g.standard_normal(SERVE_EXTEND)
        with served.window("extend"):
            s, (code, ext) = wall(torch, lambda: h.call("POST", "/extend", {
                "points": Xn.tolist(), "y": yn.tolist(),
                "fid": fn.tolist()}))
        with served.window("predict"):
            code2, got = h.call("POST", "/predict", {"points": gnp.tolist()})
        f32 = dict(dtype=torch.float32, device=dev)
        ref = {}
        for dt in (torch.float32, torch.float64):
            pd = (params if dt == torch.float32 else
                  MFGPParams.from_vector(params.to_vector().to(dt), 3, 3))
            fresh = MFGP(torch.cat([X, torch.as_tensor(Xn, **f32)]).to(dt),
                         torch.cat([fid, torch.as_tensor(fn, device=dev)]),
                         torch.cat([y, torch.as_tensor(yn, **f32)]).to(dt),
                         n_fidelities=3, params=pd, jitter=1e-6)
            ref[dt] = [t.cpu().numpy() for t in fresh.predict(grid.to(dt))]
            del fresh
            torch.cuda.empty_cache()
        ok = code == code2 == 200
        got = [np.asarray(got["mean"]), np.asarray(got["var"])] if ok else None
        errs = {}
        for name, a, b in (("served_vs_f32", got, ref[torch.float32]),
                           ("served_vs_f64", got, ref[torch.float64]),
                           ("f32_vs_f64", ref[torch.float32],
                            ref[torch.float64])):
            errs[name] = ({"mean": rel_err(a[0], b[0]),
                           "var": rel_err(a[1], b[1])} if a is not None
                          else None)
        out["extend"] = {"points": SERVE_EXTEND, "seconds": s,
                         "n": ext.get("n"), "rel_err": errs,
                         "tol": SERVE_EXTEND_F64,
                         "tol_ratio": SERVE_EXTEND_RATIO}
        within = ok and all(
            errs["served_vs_f64"][k] <= SERVE_EXTEND_F64[k]
            and errs["served_vs_f64"][k]
            <= SERVE_EXTEND_RATIO * errs["f32_vs_f64"][k]
            for k in SERVE_EXTEND_F64)
        check("serve (a) /extend = conditioned from scratch in float64",
              within and ext["n"] == X.shape[0] + SERVE_EXTEND,
              f"n {ext.get('n')}; max abs error over max |value| (mean, "
              f"var): served vs float64 {errs['served_vs_f64']} (<= "
              f"{SERVE_EXTEND_F64} and <= {SERVE_EXTEND_RATIO}x float32 "
              f"from scratch vs float64 {errs['f32_vs_f64']}); served vs "
              f"float32 from scratch {errs['served_vs_f32']}")
        out["health"] = h.call("GET", "/health")[1]
    finally:
        h.stop()
        ms.close()
    # B1 at the served shapes: a predict block (1,024 grid rows against
    # the 20,000 training points) and /extend's cross-covariance
    p = params
    v, ls, rho = p.variances, p.lengthscales, p.rhos
    Xb = grid[:1024]
    fb = torch.full((Xb.shape[0],), 2, dtype=torch.long, device=dev)
    Xe = torch.as_tensor(Xn, **f32)
    fe = torch.as_tensor(fn, device=dev)
    b1_path_check(torch, ck, "serve predict block", Xb, fb, X, fid, v, ls,
                  rho)
    b1_path_check(torch, ck, "serve extend", X, fid, Xe, fe, v, ls, rho)
    N, D, per = X.shape[0], 3, 3 * 3 + 5

    def shape(name, A, fa, B, fb_):
        n1, n2 = A.shape[0], B.shape[0]
        return (name, lambda: ck.ar1_cov_fused(A, fa, B, fb_, v, ls, rho),
                lambda: ck.ar1_cov_fused_plain(A, fa, B, fb_, v, ls, rho),
                4 * n1 * n2 + (n1 + n2) * (D * 4 + 8), n1 * n2 * 3 * per)

    out["b1"] = b1_times(torch, ck, None, "rbf", launches=(
        shape("predict_block", Xb, fb, X, fid),
        shape("extend_cross", X, fid, Xe, fe)))
    return out


def serve_planner_part(torch, ck, dev, serve, setup, served) -> dict:
    """(b): the study-size MFGP behind PlannerService (ergodic, mf_gain):
    the first plan captured while clients hammer /predict, 8 concurrent
    /plan requests against their solo plans, /refit, a /plan after it."""
    import threading

    from mfgp_tpu_torch.models.mfgp import MFGP

    mf = setup["models"][torch.float32][0]

    def model():
        m = MFGP(mf.X.clone(), mf.fid.clone(), mf.y.clone(), n_fidelities=3,
                 jitter=1e-6)
        m.set_param_array(mf.param_array)
        return m

    grid = setup["grid"]
    out = {"n": int(mf.X.shape[0])}
    for cost in ("mf_gain", "ergodic"):
        rec = out[cost] = {}
        cap = CaptureCount(torch)
        with served.window("load"):
            ms = serve.ModelServer(model(), batch_wait=SERVE_BATCH_WAIT)
        hm = Served(serve, ms)
        svc = None
        try:
            load = cost == "mf_gain"  # the capture-under-load check
            if load:
                q = grid[::10]
                mu_q, var_q = ms._predict_device(q)
                stop, answers = threading.Event(), []

                def hammer():
                    while not stop.is_set():
                        t0 = time.perf_counter()
                        code, r = hm.call("POST", "/predict",
                                          {"points": q.tolist()})
                        answers.append((t0, time.perf_counter(), code, r))

                hammers = [threading.Thread(target=hammer, daemon=True)
                           for _ in range(4)]
            # the plan captured under load against a service built
            # without it: the same plan
            body = {"start": [3.0, 5.0], "budget": SERVE_PLAN_B, "seed": 7}
            with served.window("plan_warm"):
                if load:
                    for t in hammers:
                        t.start()
                    end = time.perf_counter() + SERVE_TIMEOUT_S
                    while len(answers) < 4 and time.perf_counter() < end:
                        time.sleep(0.005)
                t0 = time.perf_counter()
                svc = serve.PlannerService(ms, cost=cost,
                                           plan_iters=SERVE_PLAN_ITERS,
                                           warm=True)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if load:
                    stop.set()
                    for t in hammers:
                        t.join(timeout=SERVE_TIMEOUT_S)
                    loaded = svc.handle("/plan", body)
            rec["warm_start_s"] = t1 - t0
            rec["captures_warm"] = cap.n
            if load:
                during = [a for a in answers if a[0] < t1 and a[1] > t0]
                bad = [a for a in answers if a[2] != 200]
                errs = [max(rel_err(a[3]["mean"], mu_q),
                            rel_err(a[3]["var"], var_q))
                        for a in answers if a[2] == 200]
                quiet = serve.PlannerService(
                    serve.ModelServer(model()), cost=cost,
                    plan_iters=SERVE_PLAN_ITERS, warm=True)
                try:
                    ref = quiet.handle("/plan", body)
                finally:
                    quiet.close()
                rec["under_load"] = {
                    "requests": len(answers), "during_capture": len(during),
                    "failed": len(bad),
                    "max_rel_err": max(errs, default=None)}
                check("serve (b) capture under load",
                      rec["captures_warm"] >= 1 and len(during) >= 1
                      and not bad
                      and max(errs, default=np.inf) <= SERVE_RTOL
                      and loaded["path"] == ref["path"]
                      and loaded["info"] == ref["info"],
                      f"{rec['captures_warm']} captures while {len(during)} "
                      f"of {len(answers)} /predict requests ran, {len(bad)} "
                      f"failed, worst rel err {max(errs, default=None)} (<= "
                      f"{SERVE_RTOL}); the plan equals an unloaded service's "
                      f"{loaded['path'] == ref['path']}")
            hm.stop()
            hp = Served(serve, svc)
            q = svc.plan_queue
            launch_s, launch = [], q.launch_fn

            def timed_launch(batch):
                t = time.perf_counter()
                try:
                    return launch(batch)
                finally:
                    launch_s.append(time.perf_counter() - t)

            q.launch_fn, window = timed_launch, q.max_wait
            try:
                q.max_wait = 1.0  # the clients land in one window
                reqs = [{"start": [1.0 + i, 2.0 + 2 * i],
                         "budget": SERVE_PLAN_B, "seed": i}
                        for i in range(SERVE_CLIENTS)]
                q0, c0 = svc.plan_queue.launches, cap.n
                t0 = time.perf_counter()
                with served.window("plan"):
                    res = concurrently([
                        (lambda b=b: hp.call("POST", "/plan", b))
                        for b in reqs])
                coalesced = time.perf_counter() - t0
                launches = svc.plan_queue.launches - q0
                stats = dict(svc.planner.stats)
                caps = cap.n - c0
                q.max_wait = window
                n_launch = len(launch_s)
                solo, solo_s = [], []
                for b in reqs:
                    with served.window("plan"):
                        s, r = wall(torch, lambda b=b: hp.call(
                            "POST", "/plan", b))
                    solo.append(r[1])
                    solo_s.append(s)
                ok = all(not isinstance(r, Exception) and r[0] == 200
                         for r, _ in res)
                same = exact = 0
                for (r, _), s in zip(res, solo):
                    if isinstance(r, Exception):
                        continue
                    a, b = np.asarray(r[1]["path"]), np.asarray(s["path"])
                    exact += r[1]["path"] == s["path"]
                    same += (r[1]["n_nodes"] == s["n_nodes"]
                             and a.shape == b.shape
                             and np.allclose(a, b, rtol=SERVE_PATH_TOL,
                                             atol=SERVE_PATH_TOL))
                rec["coalesced"] = {
                    "launches": launches, "planner_stats": stats,
                    "launch_s": launch_s[n_launch - 1],
                    "solo_launch_s": launch_s[n_launch:],
                    "window_s": 1.0, "solo_window_s": window,
                    "max_requests_per_launch":
                        svc.plan_queue.max_requests_per_launch,
                    "captures": caps, "seconds": coalesced,
                    "solo_seconds": solo_s, "solo_total_s": sum(solo_s),
                    "equal_to_solo": same, "bit_equal_to_solo": exact,
                    "info": [s["info"] for s in solo],
                    "captures_solo": cap.n - c0 - caps}
                check(f"serve (b) {cost}: 8 /plan in one launch",
                      ok and launches == 1 and same == SERVE_CLIENTS
                      and svc.plan_queue.max_requests_per_launch
                      == SERVE_CLIENTS
                      and rec["coalesced"]["captures_solo"] == 0,
                      f"{launches} plan_batch launch(es), {caps} capture(s);"
                      f" lanes equal to their solo plans: {same} of "
                      f"{SERVE_CLIENTS} (within {SERVE_PATH_TOL}; bit for "
                      f"bit {exact}); the 8-lane launch "
                      f"{launch_s[n_launch - 1]:.4g} s against "
                      f"{sum(launch_s[n_launch:]):.4g} s for the 8 solo "
                      f"launches; solo captures "
                      f"{rec['coalesced']['captures_solo']}")
                with served.window("refit"):
                    s, (code, ref) = wall(torch, lambda: hp.call(
                        "POST", "/refit", {"restarts": 4, "maxiter": 20}))
                cleared = not svc._eid_cache and svc._gain_cache is None
                with served.window("plan"):
                    code2, after = hp.call("POST", "/plan", reqs[0])
                rec["refit"] = {"seconds": s, "nlml": ref.get("nlml"),
                                "prior_sig": ref.get("prior_sig"),
                                "plan_after": after.get("info")}
                check(f"serve (b) {cost}: /refit then /plan",
                      code == code2 == 200 and cleared
                      and np.isfinite(ref["nlml"])
                      and np.isfinite(after["info"]),
                      f"NLML {ref.get('nlml')}, caches cleared {cleared}, "
                      f"plan info after {after.get('info')}")
            finally:
                hp.stop()
        finally:
            if svc is not None:
                svc.close()
            else:
                ms.close()
            hm.stop()
            cap.restore()
    return out


def serve_mission_part(torch, dev, serve, cli, served) -> dict:
    """(c): MissionService; the command line's default mission at seeds 0
    and 1 (the second warm, capturing nothing), seed 0 against a direct
    run, then ``cli mission --submit URL``."""
    from mfgp_tpu_torch.sim import mission_device as md
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    cap = CaptureCount(torch)
    svc = serve.MissionService(device=dev)
    h = Served(serve, svc)
    out = {"jobs": []}
    try:
        def run_job(seed):
            c0 = cap.n
            t0 = time.perf_counter()
            _, sub = h.call("POST", "/mission", dict(SERVE_MISSION,
                                                     seed=seed))
            while time.perf_counter() - t0 < SERVE_TIMEOUT_S:
                _, job = h.call("GET", f"/mission/{sub['job']}")
                if job["state"] in ("done", "error"):
                    break
                time.sleep(0.01)
            job.update(time_to_result_s=time.perf_counter() - t0,
                       captures=cap.n - c0)
            out["jobs"].append(job)
            return job

        with served.window("mission"):
            j0, j1 = run_job(0), run_job(1)
        m = md.DeviceMission(ExperimentConfig(**MISSION_EXP), seed=0,
                             device=dev)
        direct = m.run()
        del m
        ref = MISSION_RMSE0.get("rmse")
        done = j0["state"] == j1["state"] == "done"
        r0 = j0["result"]["rmse"] if done else None
        check("serve (c) missions: the second warm, capturing nothing",
              done and not j0["warm"] and j1["warm"]
              and j0["captures"] > 0 and j1["captures"] == 0,
              f"states {j0['state']}/{j1['state']}, warm "
              f"{j0.get('warm')}/{j1.get('warm')}, captures "
              f"{j0['captures']}/{j1['captures']}, time to result "
              f"{j0['time_to_result_s']:.4g} / {j1['time_to_result_s']:.4g}"
              f" s")
        def same_rmse(a, b):
            return b is None or abs(a - b) <= SERVE_RTOL * abs(b)

        check("serve (c) seed 0 = the direct mission",
              done and same_rmse(r0, direct.rmse) and same_rmse(r0, ref),
              f"RMSE served {r0}, direct {direct.rmse}, phase 14's "
              f"command line {ref} (within {SERVE_RTOL} relative)")
        buf = io.StringIO()
        c0 = cap.n
        with served.window("mission"), contextlib.redirect_stdout(buf):
            cli.main(["mission", "--submit", h.url])
        job = json.loads(buf.getvalue().strip().splitlines()[-1])
        job["captures"] = cap.n - c0
        out["cli_submit"] = job
        check("serve (c) cli mission --submit",
              job["state"] == "done" and job["warm"]
              and same_rmse(job["result"]["rmse"], r0)
              and job["captures"] == 0,
              f"{job['state']}, warm {job.get('warm')}, RMSE "
              f"{job.get('result', {}).get('rmse')}, "
              f"{job.get('client_seconds')} s, captures {job['captures']}")
        out["direct_rmse"] = direct.rmse
    finally:
        h.stop()
        svc.close()
        cap.restore()
    return out


def serve_phase(torch, ck, cov, dev) -> dict:
    """Phase 15 (see the module docstring). Returns the launches of the
    served calls of (a)-(c) alone (``ServedLaunches``), B1's with every
    replay of a captured planner launch."""
    from mfgp_tpu_torch import cli, serve
    from mfgp_tpu_torch.models import mfgp as mf
    from mfgp_tpu_torch.planning import rig_device as rd

    parts, t_phase = {}, time.perf_counter()

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    problem = make_problem(torch, mf, dev)
    setup = planner_setup(torch, dev)
    part("setup")
    smi = nvidia_smi()
    served = ServedLaunches(ck, rd)
    try:
        a = serve_model_part(torch, ck, dev, serve, problem, served)
        part("a_model")
        del problem
        torch.cuda.empty_cache()
        b = serve_planner_part(torch, ck, dev, serve, setup, served)
        part("b_planner")
        c = serve_mission_part(torch, dev, serve, cli, served)
        part("c_mission")
    finally:
        served.restore()
    launches = served.counts
    check("serve launches", launches["ar1_cov_fused"] > 0
          and all(n > 0 for n in served.b1_by_route.values()),
          f"{launches}; B1 by route {served.b1_by_route} (planner "
          f"replays included: {served.replayed})")
    emit("serve_model", nvidia_smi=smi, **a)
    emit("serve_planner", nvidia_smi=smi, **b)
    emit("serve_mission", nvidia_smi=smi, **c)
    emit("serve_launches", launches=launches, b1_by_route=served.b1_by_route,
         b1_replayed=served.replayed)
    emit("serve_seconds", **parts)
    return launches


# ---------------------------------------------------------------------------
# 16. parallel
# ---------------------------------------------------------------------------
# the unit's panel width: 20,000 / (2 x 256) is not whole, and padding
# changes the log-determinant (the JAX package refuses it); 250 serves mp 1,
# 2 and 4
PAR_BLOCK = 250
PAR_F64_N, PAR_F64_M = 4000, 1000  # the float64 check: N and grid rows
PAR_WMSE_M = 2000  # the study's full posterior covariance
PAR_TRI_COLS = 2000  # right-hand-side columns of the N=20,000 tri-solves
PAR_FIT_RESTARTS, PAR_FIT_STEPS = 8, 200
PAR_LANES = 8  # plan_ensemble lanes and run_ensemble members
# the sharded gradient's contraction at ROADMAP C5's inputs: 300 points on
# the unit's 60 x 110 x 4.5 m box at the unit's lengthscales and at 0.3 of
# them, and C5's 60 close points at 0.002
PAR_C5_CASES = (("unit box", (12.0, 20.0, 1.5)),
                ("unit box", (3.6, 6.0, 0.45)),
                ("close", (0.002, 0.002, 0.002)))
PAR_VALUE_REL, PAR_VALUE_F64_REL = 1e-4, 1e-3  # PERF.md §2's NLML bars
PAR_MEAN_REL = 1e-5  # of the largest entry: the cross-covariance's bar
PAR_F64_REL = 1e-10  # float64, every function against one device
# float32 outputs of a different order of operations (the posteriors, whose
# sums over a 5,286-row shard round otherwise than over the whole grid's
# 10,571 rows, the WMSE, the factor and the solves): no further from
# float64 (beyond PAR_MEAN_REL of the largest entry), or no larger a
# residual, than the one-device float32 result times this
PAR_F32_RATIO = 2.0
PAR_RTOL_MEMBERS = 1e-6  # run_ensemble member RMSE vs one device
PAR_RANK_DEVICE = ("cuda", 0)  # every rank's device: the one card


def c5_problem(torch, ck, dev, case: str, ls, kern: str = "rbf"):
    """ROADMAP C5's inputs (seed 1): points, labels, the parameters in
    float64, the float32 inverse factor of their float64 Gram and alpha
    (float64, from K^-1 = Linv^T Linv of that float32 factor), base
    ``kern``. ``case``:
    "box" (300 points on 10 x 20 x 10 m), "unit box" (300 on the unit's 60
    x 110 x 4.5 m) or "close" (60 points near 15, spread 0.003)."""
    g = np.random.default_rng(1)
    X = (g.uniform(0, 1, (300, 3)) * [10, 20, 10] if case == "box"
         else g.uniform(0, 1, (300, 3)) * [60.0, 110.0, 4.5]
         if case == "unit box" else 15 + g.normal(0, 0.003, (60, 3)))
    N = X.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    fid = torch.as_tensor(g.integers(0, 3, N), device=dev)
    X, v, lsv, rho, nz = (torch.as_tensor(a, **f64) for a in (
        X, [1.3, 0.8, 2.1], np.broadcast_to(np.asarray(ls, float), (3, 3)),
        [0.9, 1.1], [0.05, 0.03, 0.02]))
    K = ck.ar1_cov_fused_plain(X, fid, X, fid, v, lsv, rho, nz[fid] + 1e-6,
                               kern)
    Linv = torch.linalg.inv(torch.linalg.cholesky(K)).float().contiguous()
    L64 = Linv.double()
    alpha = (L64.T @ L64) @ torch.as_tensor(
        np.sin(X.cpu().numpy()).sum(1) + 0.1 * g.normal(size=N), **f64)
    return X, fid, v, lsv, rho, nz, Linv, alpha


def par_c5(torch, ck, dev, mesh) -> dict:
    """Both sharded gradients' contraction (``parallel.sharded.
    _sharded_grad``) in float32 on this rank's K^-1 columns at
    ``PAR_C5_CASES``, against ``grad_from_kinv`` in float64 on the same
    float32 values: worst relative error per component."""
    from mfgp_tpu_torch.models.mfgp import MFGPParams
    from mfgp_tpu_torch.parallel.mesh import MP_AXIS, axis_size
    from mfgp_tpu_torch.parallel.sharded import _sharded_grad

    out = {}
    for case, ls in PAR_C5_CASES:
        X, fid, v, lsv, rho, nz, Linv, alpha = c5_problem(torch, ck, dev,
                                                          case, ls)
        L64 = Linv.double()
        Kinv = L64.T @ L64
        r32 = [a.float() for a in (alpha, X, v, lsv, rho, nz)]
        r64 = [a.double() for a in r32]
        ref = ck.grad_from_kinv(Kinv, r64[0], r64[1], fid, *r64[2:], "rbf")
        nc = X.shape[0] // axis_size(mesh, MP_AXIS)
        c0 = mesh.get_local_rank(MP_AXIS) * nc
        cols = torch.arange(c0, c0 + nc, device=dev)
        p = MFGPParams(torch.log(r32[2]), torch.log(r32[3]), r32[4],
                       torch.log(r32[5]))
        g = _sharded_grad(mesh, Kinv.float()[:, cols].contiguous(), r32[0],
                          r32[1], fid, cols, p)
        got = (g.log_variances, g.log_lengthscales, g.log_noises)
        out[f"{case} ls={ls[0]}"] = [
            float(((a.double() - b).abs() / b.abs()).max())
            for a, b in zip(got, ref)]
    return out


def par_rel(a, b) -> float:
    """max |a - b| / max |b| (normwise relative)."""
    return max_err(a, b) / max(float(b.abs().max()), 1e-300)


def par_residual(torch, A, X, B, transpose: bool = False,
                 step: int = 2048) -> float:
    """max |A X - B| / (max |A| max |X| n) in float64, ``step`` rows at a
    time (``A^T X - B`` with ``transpose``): the backward error of a
    factor (X = A^T, B the matrix) or of a solve."""
    At = A.T if transpose else A
    Xd = X.double()
    err = 0.0
    for r0 in range(0, At.shape[0], step):
        r = At[r0:r0 + step].double() @ Xd - B[r0:r0 + step].double()
        err = max(err, float(r.abs().max()))
        del r
    del Xd
    return err / (float(A.abs().max()) * float(X.abs().max()) * A.shape[0])


def par_f64_refs(torch, mf, gp, problem) -> dict:
    """Float64 on the card (the plain path) of what the float32 checks
    hold against: the NLML, the MF and GP posteriors on the grid and the
    WMSE, on float64 copies of the unit's inputs."""
    from mfgp_tpu_torch.ops import linalg as la

    X, y, grid = (t.double() for t in (problem[0], problem[2], problem[3]))
    fid, gfid = problem[1], problem[4]
    p = mf.MFGPParams(*(t.double() for t in problem[5]))
    v, g = mf.nlml_value_and_grad(p, X, fid, y, jitter=1e-6)
    st = mf.condition(p, X, fid, y, jitter=1e-6)
    mu, var = mf.predict(p, st, grid, gfid)
    _, Sig = mf.predict(p, st, grid[:PAR_WMSE_M], gfid[:PAR_WMSE_M],
                        full_cov=True)
    err = par_wmse_err(torch, X.device, torch.float64)
    w = la.weighted_mse(err, Sig)
    gpp = par_gp_params(torch, gp, X.device, torch.float64)
    gst = gp.condition(gpp, X, y, jitter=1e-6)
    gmu, gvar = gp.predict(gpp, gst, grid)
    del st, Sig, gst
    return {"nlml": float(v), "grad": [a.cpu() for a in g],
            "mu": mu.cpu(), "var": var.cpu(), "gp_mu": gmu.cpu(),
            "gp_var": gvar.cpu(), "wmse": float(w)}


def par_gp_params(torch, gp, dev, dtype):
    """The GP of the parallel checks: the unit's fidelity-0 variance and
    lengthscales, noise 0.1 (bench._theta)."""
    from bench import _theta

    v, ls, _, _ = _theta()
    return gp.gp_params_from_numpy(np.log(v[0]), np.log(ls[0]), np.log(0.1),
                                   dev, dtype)


def par_wmse_err(torch, dev, dtype):
    """The WMSE's error vector (seeded, PAR_WMSE_M long)."""
    return torch.as_tensor(np.random.default_rng(7).normal(size=PAR_WMSE_M),
                           dtype=dtype, device=dev)


def par_run(torch, ck, pm, out: dict, name: str, fn):
    """``fn()`` timed (synchronised wall), with its kernel launches and its
    collectives (count and bytes) recorded under ``name``."""
    c0, l0 = dict(pm.COLLECTIVES), dict(ck.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    out["seconds"][name] = time.perf_counter() - t0
    out["launches"][name] = {k: ck.LAUNCHES[k] - l0[k] for k in l0}
    out["collectives"][name] = {k: pm.COLLECTIVES[k] - c0[k] for k in c0
                                if pm.COLLECTIVES[k] != c0[k]}
    return r


def par_unit(torch, ck, mesh, problem, f64, lead: bool) -> dict:
    """Every ``make_sharded_*`` function and the fully sharded NLML (both
    layouts) on ``mesh`` at the unit's width (float32), each timed with its
    B1 launches and collectives; on the ``lead`` rank the one-device
    functions on the same inputs and the errors against them and float64
    (``f64``)."""
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.models import gp, mfgp as mf
    from mfgp_tpu_torch.ops import covariance as cov
    from mfgp_tpu_torch.ops import linalg as la
    from mfgp_tpu_torch.parallel import mesh as pm

    X, fid, y, grid, gfid, p = problem
    N, dev = X.shape[0], X.device
    f64 = {k: [t.to(dev) for t in v] if isinstance(v, list)
           else v.to(dev) if isinstance(v, torch.Tensor) else v
           for k, v in f64.items()}
    out = {"seconds": {}, "launches": {}, "collectives": {}}

    def run(name, fn):
        return par_run(torch, ck, pm, out, name, fn)

    st = mf.condition(p, X, fid, y, jitter=1e-6)
    mu, var = run("mfgp_predict", lambda: par.make_sharded_mfgp_predict(
        mesh)(p, st, grid, gfid))
    gpp = par_gp_params(torch, gp, dev, torch.float32)
    gst = gp.condition(gpp, X, y, jitter=1e-6)
    gmu, gvar = run("gp_predict", lambda: par.make_sharded_gp_predict(mesh)(
        gpp, gst, grid))
    Kx = run("cross_cov", lambda: par.make_sharded_ar1_cross_cov(mesh)(
        grid, gfid, X, fid, p))
    vg = {"nlml": run("nlml", lambda: par.make_sharded_nlml_value_and_grad(
        mesh, jitter=1e-6)(p, X, fid, y))}
    for layout in ("block", "cyclic"):
        vg[f"fully_{layout}"] = run(
            f"fully_{layout}",
            lambda: par.make_fully_sharded_nlml_value_and_grad(
                mesh, N, block=PAR_BLOCK, jitter=1e-6, layout=layout)(
                    p, X, fid, y))
    _, Sig = mf.predict(p, st, grid[:PAR_WMSE_M], gfid[:PAR_WMSE_M],
                        full_cov=True)
    err = par_wmse_err(torch, dev, torch.float32)
    w = run("wmse", lambda: par.make_sharded_weighted_mse(mesh)(err, Sig))
    K = cov.mf_train_cov(p.variances, p.lengthscales, p.rhos, p.noises, X,
                         fid, 1e-6, "rbf")
    Ls = run("cholesky", lambda: par.make_sharded_cholesky(
        mesh, N, block=PAR_BLOCK)(K))
    L1 = la.chol(K)
    B = torch.as_tensor(np.random.default_rng(8).normal(
        size=(N, PAR_TRI_COLS)), dtype=torch.float32, device=dev)
    lower, upper = par.make_sharded_tri_solves(mesh, N, PAR_TRI_COLS,
                                               block=PAR_BLOCK)
    X1 = run("tri_lower", lambda: lower(L1, B))
    X2 = run("tri_upper", lambda: upper(L1, X1))
    if not lead:
        return out
    e = {}
    mu1, var1 = mf.predict(p, st, grid, gfid)
    gmu1, gvar1 = gp.predict(gpp, gst, grid)
    for name, got, one, ref in (
            ("mfgp_predict", (mu, var), (mu1, var1), ("mu", "var")),
            ("gp_predict", (gmu, gvar), (gmu1, gvar1), ("gp_mu", "gp_var"))):
        e[name] = {}
        for part, a, b, r in zip(("mean", "var"), got, one, ref):
            e[name].update({
                f"{part}_rel": par_rel(a, b),
                f"{part}_f64": max_err(a, f64[r]),
                f"{part}_f64_one": max_err(b, f64[r]),
                f"{part}_f64_top": float(f64[r].abs().max())})
    del mu1, var1, gmu1, gvar1
    e["cross_cov"] = {"rel": par_rel(Kx, cov.mf_cross_cov(
        p.variances, p.lengthscales, p.rhos, grid, gfid, X, fid, "rbf"))}
    del Kx
    v1, g1 = mf.nlml_value_and_grad(p, X, fid, y, jitter=1e-6)
    for name, (v, g) in vg.items():
        e[name] = {
            "value": float(v), "value_one": float(v1),
            "value_rel": abs(float(v) - float(v1)) / abs(float(v1)),
            "value_f64_rel": abs(float(v) - f64["nlml"]) / abs(f64["nlml"]),
            "grad_rel_one": [float(((a - b).abs() / b.abs()).max())
                             for a, b in zip(g, g1) if b.abs().max() > 0],
            "grad_rel_f64": [float(((a.double() - b).abs() / b.abs()).max())
                             for a, b in zip(g, f64["grad"])
                             if b.abs().max() > 0]}
    e["nlml_one"] = {"value_f64_rel": abs(float(v1) - f64["nlml"])
                     / abs(f64["nlml"]),
                     "grad_rel_f64": [float(((a.double() - b).abs()
                                             / b.abs()).max())
                                      for a, b in zip(g1, f64["grad"])
                                      if b.abs().max() > 0]}
    w1 = float(la.weighted_mse(err, Sig))
    e["wmse"] = {"value": float(w), "value_one": w1,
                 "f64_rel": abs(float(w) - f64["wmse"]) / f64["wmse"],
                 "f64_rel_one": abs(w1 - f64["wmse"]) / f64["wmse"]}
    e["cholesky"] = {"rel_one": par_rel(Ls, L1),
                     "backward": par_residual(torch, Ls, Ls.T, K),
                     "backward_one": par_residual(torch, L1, L1.T, K)}
    del Ls, K
    Y1 = torch.linalg.solve_triangular(L1, B, upper=False)
    Y2 = torch.linalg.solve_triangular(L1.T, X1, upper=True)
    e["tri_lower"] = {"rel_one": par_rel(X1, Y1),
                      "residual": par_residual(torch, L1, X1, B),
                      "residual_one": par_residual(torch, L1, Y1, B)}
    e["tri_upper"] = {"rel_one": par_rel(X2, Y2),
                      "residual": par_residual(torch, L1, X2, X1, True),
                      "residual_one": par_residual(torch, L1, Y2, X1, True)}
    out["errors"] = e
    return out


def par_f64(torch, ck, mesh, dev, lead: bool) -> dict:
    """Every sharded function in float64 at N=PAR_F64_N on the card (the
    plain path), against the one-device functions on the lead rank:
    normwise relative errors."""
    from bench import _theta, build_problem
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.models import gp, mfgp as mf
    from mfgp_tpu_torch.ops import covariance as cov
    from mfgp_tpu_torch.ops import linalg as la

    Xn, fn_, yn, gn, gfn = build_problem(PAR_F64_N, PAR_F64_M)
    f64 = dict(dtype=torch.float64, device=dev)
    X, y, grid = (torch.as_tensor(a, **f64) for a in (Xn, yn, gn))
    fid, gfid = (torch.as_tensor(a, dtype=torch.long, device=dev)
                 for a in (fn_, gfn))
    v, ls, r, nz = _theta()
    p = mf.params_from_numpy(np.log(v), np.log(ls), r, np.log(nz), dev,
                             torch.float64)
    N, M = PAR_F64_N, PAR_F64_M
    st = mf.condition(p, X, fid, y, jitter=1e-6)
    gpp = par_gp_params(torch, gp, dev, torch.float64)
    gst = gp.condition(gpp, X, y, jitter=1e-6)
    _, Sig = mf.predict(p, st, grid, gfid, full_cov=True)
    err = torch.as_tensor(np.random.default_rng(7).normal(size=M), **f64)
    K = cov.mf_train_cov(p.variances, p.lengthscales, p.rhos, p.noises, X,
                         fid, 1e-6, "rbf")
    L1 = la.chol(K)
    B = torch.as_tensor(np.random.default_rng(8).normal(size=(N, M)), **f64)
    lower, upper = par.make_sharded_tri_solves(mesh, N, M, block=PAR_BLOCK)
    Y1 = lower(L1, B)
    got = {
        "mfgp_predict": par.make_sharded_mfgp_predict(mesh)(p, st, grid,
                                                            gfid),
        "gp_predict": par.make_sharded_gp_predict(mesh)(gpp, gst, grid),
        "cross_cov": par.make_sharded_ar1_cross_cov(mesh)(grid, gfid, X,
                                                          fid, p),
        "wmse": par.make_sharded_weighted_mse(mesh)(err, Sig),
        "nlml": par.make_sharded_nlml_value_and_grad(mesh, jitter=1e-6)(
            p, X, fid, y),
        **{f"fully_{lay}": par.make_fully_sharded_nlml_value_and_grad(
            mesh, N, block=PAR_BLOCK, jitter=1e-6, layout=lay)(
                p, X, fid, y) for lay in ("block", "cyclic")},
        **{f"cholesky_{lay}": par.make_sharded_cholesky(
            mesh, N, block=PAR_BLOCK, layout=lay)(K)
           for lay in ("block", "cyclic")},
        "tri_lower": Y1, "tri_upper": upper(L1, Y1)}
    if not lead:
        return {}
    vg1 = mf.nlml_value_and_grad(p, X, fid, y, jitter=1e-6)
    one = {
        "mfgp_predict": mf.predict(p, st, grid, gfid),
        "gp_predict": gp.predict(gpp, gst, grid),
        "cross_cov": cov.mf_cross_cov(p.variances, p.lengthscales, p.rhos,
                                      grid, gfid, X, fid, "rbf"),
        "wmse": la.weighted_mse(err, Sig), "nlml": vg1,
        "fully_block": vg1, "fully_cyclic": vg1,
        "cholesky_block": L1, "cholesky_cyclic": L1,
        "tri_lower": torch.linalg.solve_triangular(L1, B, upper=False),
        "tri_upper": torch.linalg.solve_triangular(L1.T, Y1, upper=True)}

    def flat(o):
        if isinstance(o, torch.Tensor):
            return [o.reshape(-1)]
        return [t for a in o for t in flat(a) if t.numel()]

    return {k: max(par_rel(a, b) for a, b in zip(flat(got[k]), flat(one[k])))
            for k in got}


def par_ensemble_inputs(torch, dev) -> dict:
    """The study-size MFGP of the planner phase (N of about 705) for
    ``fit_sharded``, and the simulator's mf_gain plan: its gain state, EID,
    grid and start point (all on the CPU, for the ranks to load)."""
    from mfgp_tpu_torch.planning.rig_device import prepare_mf_gain_state

    setup = planner_setup(torch, dev)
    mf, gp = setup["models"][torch.float32]
    cfg = setup["cfg"]
    n = int(setup["n"])
    nmax = 1 << max(9, (4 * n - 1).bit_length())  # the simulator's pad
    return {"X": mf.X.cpu(), "fid": mf.fid.cpu(), "y": mf.y.cpu(),
            "grid": np.asarray(setup["grid"]),
            "eid": planner_eid("mf_gain", mf, gp, setup["grid"]).cpu(),
            "gain": tuple(t.cpu() for t in prepare_mf_gain_state(
                mf, setup["fid_levels"], nmax)),
            "x0": np.array([0.05 * (cfg.WS[0][1] - cfg.WS[0][0]),
                            0.05 * (cfg.WS[1][1] - cfg.WS[1][0])])}


def par_plan(torch, inp: dict, dev, mesh=None):
    """``plan_ensemble`` of PAR_LANES lanes (mf_gain, the simulator's
    settings, float32, graph replay) with or without ``mesh``: (the
    winner's info, budget and chain, the winning lane, every lane's host
    state)."""
    rig = dp_rig(torch.float32, True, B=DP_B, max_iter=DP_COST_ITERS,
                 grid=inp["grid"], cost="mf_gain")
    seen = {}
    extract = rig._extract

    def keep(st, i):  # every lane's host state, beside the winner
        seen["st"], seen["i"] = st, i
        return extract(st, i)

    rig._extract = keep
    res = rig.plan_ensemble(
        inp["x0"], seed=PLANNER_SEED, n_plans=PAR_LANES, B=DP_TRANCHE,
        eid=inp["eid"].to(dev), gp=tuple(t.to(dev) for t in inp["gain"]),
        mesh=mesh)
    return (res.info, res.budget, res.chain), seen["i"], seen["st"]


def par_members(torch, dev, mesh=None) -> list:
    """PAR_LANES members of the command line's default mission (float32)
    with or without ``mesh``: per member (replans, flown mask, flown
    points, RMSE)."""
    from mfgp_tpu_torch.sim import mission_device as md
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    m = md.DeviceMission(ExperimentConfig(**MISSION_EXP), seed=0, device=dev)
    return [(r.n_replans, r.flown_mask, r.flown, r.rmse)
            for r in m.run_ensemble(PAR_LANES, mesh=mesh)]


def par_ensembles(torch, dev, mesh, inp: dict) -> dict:
    """(c) on a (dp=2, mp=2) mesh: ``fit_sharded`` of the study-size MFGP
    (PAR_FIT_RESTARTS restarts, PAR_FIT_STEPS steps) with its restarts'
    starting NLML, then the sharded plan ensemble and mission ensemble."""
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.parallel.train import _nlml_lanes

    X, fid, y = inp["X"].to(dev), inp["fid"].to(dev), inp["y"].to(dev)
    out = {"seconds": {}}
    t0 = time.perf_counter()
    best, losses, mu, var = par.fit_sharded(
        mesh, X, fid, y, inp["grid"], n_restarts=PAR_FIT_RESTARTS,
        steps=PAR_FIT_STEPS, seed=0, device=dev)
    torch.cuda.synchronize()
    out["seconds"]["fit_sharded"] = time.perf_counter() - t0
    with torch.no_grad():
        start = _nlml_lanes(par.init_restarts(
            torch.Generator().manual_seed(0), PAR_FIT_RESTARTS, 3,
            X.shape[1], device=dev), X, fid, y, "rbf", 1e-6)
    out["fit"] = {"losses": losses.cpu().numpy(),
                  "start": start.cpu().numpy(),
                  "mu_finite": bool(torch.isfinite(mu).all()),
                  "var_min": float(var.min()), "M": int(var.shape[0]),
                  "best": [t.cpu().numpy() for t in best]}
    t0 = time.perf_counter()
    out["plan"] = par_plan(torch, inp, dev, mesh)
    out["seconds"]["plan_ensemble"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["members"] = par_members(torch, dev, mesh)
    out["seconds"]["run_ensemble"] = time.perf_counter() - t0
    return out


def par_rank(rank: int, world: int, kind: str, tmp: str) -> None:
    """One gloo rank of (b) (``kind`` "unit": mesh (1, 2)) or (c)
    ("ensembles": mesh (2, 2)), every rank on the one card; writes its
    results to ``tmp``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dev = torch.device(*PAR_RANK_DEVICE)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, f"store_{kind}"),
                                     world),
        rank=rank, world_size=world, timeout=timedelta(seconds=300))
    try:
        from mfgp_tpu_torch import parallel as par
        from mfgp_tpu_torch.models import mfgp as mf
        from mfgp_tpu_torch.ops import build
        from mfgp_tpu_torch.ops import cuda_kernels as ck
        from mfgp_tpu_torch.parallel import mesh as pm

        build.load_library()
        t0 = time.perf_counter()
        if kind == "unit":
            mesh = par.make_mesh(2, mp=2, device=dev)
            f64 = torch.load(os.path.join(tmp, "f64.pt"))
            out = par_unit(torch, ck, mesh, make_problem(torch, mf, dev), f64,
                           rank == 0)
            out["c5"] = par_c5(torch, ck, dev, mesh)
            out["f64"] = par_f64(torch, ck, mesh, dev, rank == 0)
        else:
            mesh = par.make_mesh(4, mp=2, device=dev)
            out = par_ensembles(torch, dev, mesh, torch.load(
                os.path.join(tmp, "ensembles.pt"), weights_only=False))
        out.update(rank=rank, mesh=tuple(mesh.shape),
                   coordinate=mesh.get_coordinate(),
                   backend=dist.get_backend(), seconds_total=(
                       time.perf_counter() - t0),
                   all_collectives=dict(pm.COLLECTIVES),
                   b1_total=ck.LAUNCHES["ar1_cov_fused"],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   jax_imported="jax" in sys.modules)
        torch.save(out, os.path.join(tmp, f"{kind}{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def par_spawn(torch, world: int, kind: str, tmp: str):
    """``world`` gloo ranks of ``par_rank`` on the card (a rank that
    raises fails here); (every rank's results, wall seconds)."""
    import torch.multiprocessing as tmp_mp

    t0 = time.perf_counter()
    tmp_mp.start_processes(par_rank, args=(world, kind, tmp), nprocs=world,
                           join=True, start_method="spawn")
    return ([torch.load(os.path.join(tmp, f"{kind}{r}.pt"),
                        weights_only=False) for r in range(world)],
            time.perf_counter() - t0)


def par_b1_shapes(torch, ck, problem) -> dict:
    """B1 at the sharded paths' launch shapes (mp=2): a grid shard of the
    predict and the cross-covariance (5,286 x 20,000, F=3), the fully
    sharded K columns (20,000 x 10,000, F=3) and the gradient's kernel
    columns (20,000 x 10,000, F=1): held against float64
    (``b1_path_check``) and timed (wrapper and kernel alone, plain
    version, bound)."""
    X, fid, _, grid, gfid, p = problem
    N, D = X.shape
    v, ls, rho = p.variances, p.lengthscales, p.rhos
    half = (grid.shape[0] + 1) // 2
    g2, gf2 = grid[:half].contiguous(), gfid[:half].contiguous()
    Xc, fc = X[:N // 2].contiguous(), fid[:N // 2].contiguous()
    z = torch.zeros(N, dtype=torch.long, device=X.device)
    shapes = (("predict_shard", g2, gf2, X, fid, v, ls, rho),
              ("k_columns", X, fid, Xc, fc, v, ls, rho),
              ("kernel_columns", X, z, Xc, z[:N // 2], v[:1] * 0 + 1.0,
               ls[:1], rho[:0]))
    out = {}
    for name, A, fa, B, fb, vv, ll, rr in shapes:
        b1_path_check(torch, ck, f"parallel {name}", A, fa, B, fb, vv, ll,
                      rr)
        F = vv.shape[0]
        n, m = A.shape[0], B.shape[0]
        prepped = ck._prep_pair(A, fa, B, fb, vv, ll, rr)
        buf = torch.empty((n, m), dtype=torch.float32, device=A.device)

        def wrapper():
            if F == 1:
                return ck.rbf_cov_fused(A, B, vv[0], ll[0])
            return ck.ar1_cov_fused(A, fa, B, fb, vv, ll, rr)

        def kernel():
            ck._launch_ar1_cov(*prepped, None, buf, ck._KERN_IDS["rbf"])

        def plain():
            return ck.ar1_cov_fused_plain(A, fa, B, fb, vv, ll, rr)

        ms = min(cuda_ms(torch, wrapper, reps=10) for _ in range(2))
        kms = min(cuda_ms(torch, kernel, reps=10) for _ in range(2))
        pms = cuda_ms(torch, plain, reps=1)
        nbytes = 4 * n * m + (n + m) * (D * 4 + 8) + 4 * F * (D + 2)
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = n * m * F * (3 * D + 5) / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        out[name] = {"shape": f"({n}, {m}) F={F}", "ms": ms, "kernel_ms": kms,
                     "plain_ms": pms, "bytes": nbytes, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "share_of_bound": bound / ms,
                     "kernel_share_of_bound": bound / kms}
        del buf, prepped
    return out


def par_unit_checks(label: str, r: dict) -> None:
    """The float32 checks of ``par_unit``'s errors, and B1 on every path
    that assembles a covariance."""
    e = r["errors"]
    for name in ("nlml", "fully_block", "fully_cyclic"):
        check(f"parallel {label} {name} value",
              e[name]["value_rel"] <= PAR_VALUE_REL
              and e[name]["value_f64_rel"] <= PAR_VALUE_F64_REL,
              f"{e[name]['value']:.8g} vs one device "
              f"{e[name]['value_one']:.8g}: {e[name]['value_rel']:.3e} (<= "
              f"{PAR_VALUE_REL}); vs float64 {e[name]['value_f64_rel']:.3e} "
              f"(<= {PAR_VALUE_F64_REL})")
    for name in ("mfgp_predict", "gp_predict"):
        x = e[name]
        check(f"parallel {label} {name}", all(
            x[f"{k}_f64"] <= PAR_F32_RATIO * x[f"{k}_f64_one"]
            + PAR_MEAN_REL * x[f"{k}_f64_top"] for k in ("mean", "var")),
            "; ".join(
                f"{k} {x[f'{k}_rel']:.3e} of max |{k}| from one device, vs "
                f"float64 {x[f'{k}_f64']:.3e} against the one device's "
                f"{x[f'{k}_f64_one']:.3e} (<= {PAR_F32_RATIO}x + "
                f"{PAR_MEAN_REL} x {x[f'{k}_f64_top']:.4g})"
                for k in ("mean", "var")))
    check(f"parallel {label} cross_cov", e["cross_cov"]["rel"]
          <= PAR_MEAN_REL, f"{e['cross_cov']['rel']:.3e} of the largest "
          f"entry vs one device (<= {PAR_MEAN_REL})")
    w = e["wmse"]
    check(f"parallel {label} wmse", w["f64_rel"] <= PAR_F32_RATIO
          * w["f64_rel_one"] + 1e-6, f"{w['value']:.8g} (one device "
          f"{w['value_one']:.8g}): vs float64 {w['f64_rel']:.3e} against "
          f"the one device's {w['f64_rel_one']:.3e}")
    c = e["cholesky"]
    check(f"parallel {label} cholesky", c["backward"] <= PAR_F32_RATIO
          * c["backward_one"], f"backward error {c['backward']:.3e} "
          f"against cuSOLVER's {c['backward_one']:.3e}; factors "
          f"{c['rel_one']:.3e} apart")
    for name in ("tri_lower", "tri_upper"):
        t = e[name]
        check(f"parallel {label} {name}", t["residual"] <= PAR_F32_RATIO
              * t["residual_one"], f"residual {t['residual']:.3e} against "
              f"the one-device solve's {t['residual_one']:.3e}; "
              f"{t['rel_one']:.3e} apart")
    paths = ("mfgp_predict", "gp_predict", "cross_cov", "nlml",
             "fully_block", "fully_cyclic")
    b1 = {k: r["launches"][k]["ar1_cov_fused"] for k in paths}
    check(f"parallel {label} B1 on every sharded path",
          all(n > 0 for n in b1.values()), f"B1 launches per call: {b1}")


def par_rank_checks(label: str, r: dict) -> None:
    """C5 and float64 checks of one rank's results."""
    c5 = r["c5"]
    check(f"parallel {label} C5 contraction", max(max(v) for v in
                                                  c5.values()) <= C5_BAR,
          f"worst relative error per component (g_logvar, g_logls, "
          f"g_lognoise) vs float64: {c5} (<= {C5_BAR})")
    if r["f64"]:
        check(f"parallel {label} float64 N={PAR_F64_N}",
              max(r["f64"].values()) <= PAR_F64_REL,
              f"normwise vs one device: {r['f64']} (<= {PAR_F64_REL})")
    check(f"parallel {label} rank {r['rank']} imports no jax",
          not r["jax_imported"], f"jax in sys.modules: {r['jax_imported']}")


def parallel_phase(torch, ck, cov, dev) -> dict:
    """Phase 16 (see the module docstring). Returns B1's launches over the
    sharded calls of this process and of every rank."""
    import torch.distributed as dist

    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.models import gp, mfgp as mf
    from mfgp_tpu_torch.parallel import mesh as pm

    parts, t_phase = {}, time.perf_counter()

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    smi = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="mfgp_parallel_")
    launches = {k: 0 for k in ck.LAUNCHES}

    def count(r):  # the sharded calls' launches of one process
        for per_call in r["launches"].values():
            for k, n in per_call.items():
                launches[k] += n

    try:
        problem = make_problem(torch, mf, dev)
        f64 = par_f64_refs(torch, mf, gp, problem)
        torch.save(f64, os.path.join(tmp, "f64.pt"))
        torch.cuda.empty_cache()
        part("f64_refs")
        b1 = par_b1_shapes(torch, ck, problem)
        part("b1_shapes")

        # (a) NCCL at world size 1 in this process, mesh (1, 1)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store_nccl"), 1),
            rank=0, world_size=1)
        try:
            mesh = par.make_mesh(device=dev)
            pm.reset_collectives()
            torch.cuda.reset_peak_memory_stats()
            a = par_unit(torch, ck, mesh, problem, f64, True)
            a.update(c5=par_c5(torch, ck, dev, mesh), rank=0,
                     f64=par_f64(torch, ck, mesh, dev, True),
                     mesh=tuple(mesh.shape), backend=dist.get_backend(),
                     all_collectives=dict(pm.COLLECTIVES),
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     jax_imported="jax" in sys.modules)
        finally:
            dist.destroy_process_group()
        count(a)
        del problem
        torch.cuda.empty_cache()
        part("a_nccl")
        par_unit_checks("(a) nccl (1, 1)", a)
        par_rank_checks("(a) nccl (1, 1)", a)
        check("parallel (a) nccl stages nothing",
              a["all_collectives"]["host_staged"] == 0,
              f"{a['all_collectives']}")

        # (b) gloo, 2 ranks on the card, mesh (1, 2)
        b, b_s = par_spawn(torch, 2, "unit", tmp)
        part("b_gloo2")
        par_unit_checks("(b) gloo (1, 2)", b[0])
        for r in b:
            par_rank_checks("(b) gloo (1, 2)", r)
            count(r)

        # (c) gloo, 4 ranks, mesh (2, 2): the one-device references first
        inp = par_ensemble_inputs(torch, dev)
        torch.save(inp, os.path.join(tmp, "ensembles.pt"))
        t0 = time.perf_counter()
        plan1 = par_plan(torch, inp, dev)
        members1 = par_members(torch, dev)
        one_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        part("c_one_device")
        c, c_s = par_spawn(torch, 4, "ensembles", tmp)
        part("c_gloo4")
        for r in c:
            f = r["fit"]
            bi = int(np.argmin(np.where(np.isfinite(f["losses"]),
                                        f["losses"], np.inf)))
            check(f"parallel (c) fit_sharded rank {r['rank']}",
                  np.isfinite(f["losses"]).all() and f["mu_finite"]
                  and f["losses"][bi] <= f["start"][bi]
                  and f["var_min"] > 0,
                  f"{PAR_FIT_RESTARTS} restarts x {PAR_FIT_STEPS} steps, N="
                  f"{inp['X'].shape[0]}: losses {np.round(f['losses'], 3)}, "
                  f"best #{bi} from {f['start'][bi]:.4f}; grid of {f['M']}: "
                  f"var min {f['var_min']:.4g}")
            win, i, st = r["plan"]
            same = i == plan1[1] and win == plan1[0] and all(
                np.array_equal(st[k], plan1[2][k]) for k in plan1[2])
            check(f"parallel (c) plan_ensemble rank {r['rank']}", same,
                  f"{PAR_LANES} lanes over dp=2 = one device lane by lane "
                  f"bit for bit: {same}; winner lane {i} "
                  f"(one device {plan1[1]}), info {win[0]:.6g}")
            ok = len(r["members"]) == PAR_LANES
            worst = 0.0
            for (n, mask, fl, rm), (n1, mask1, fl1, rm1) in zip(
                    r["members"], members1):
                ok &= n == n1 and np.array_equal(mask, mask1)
                worst = max(worst, abs(rm - rm1) / abs(rm1))
            bits = all(np.array_equal(a[2], b_[2])
                       for a, b_ in zip(r["members"], members1))
            check(f"parallel (c) run_ensemble rank {r['rank']}",
                  ok and worst <= PAR_RTOL_MEMBERS,
                  f"{PAR_LANES} members over dp=2: replans and masks equal "
                  f"{ok}, flown points bit for bit {bits}, worst RMSE "
                  f"{worst:.3e} (<= {PAR_RTOL_MEMBERS})")
            check(f"parallel (c) rank {r['rank']} imports no jax and runs "
                  "B1", not r["jax_imported"] and r["b1_total"] > 0,
                  f"jax imported {r['jax_imported']}, B1 launches "
                  f"{r['b1_total']} (fit, plans, members)")
            launches["ar1_cov_fused"] += r["b1_total"]
        check("parallel gloo staged nothing through the host",
              all(r["all_collectives"]["host_staged"] == 0 for r in b + c),
              f"gloo's CUDA collectives here: {sorted(pm.GLOO_CUDA_OPS)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    note = ("ranks sharing one card measure correctness, not scaling: no "
            "multi-GPU number is taken here")
    emit("parallel_b1", nvidia_smi=smi, shapes=b1)
    for label, rs in (("a_nccl", [a]), ("b_gloo2", b)):
        emit("parallel_unit", run=label, nvidia_smi=smi, note=note,
             ranks=[{k: r.get(k) for k in (
                 "rank", "mesh", "backend", "seconds", "launches",
                 "collectives", "all_collectives", "peak_gb", "errors",
                 "c5", "f64")} for r in rs])
    emit("parallel_ensembles", nvidia_smi=smi, note=note,
         one_device_s=one_s, spawn_and_run_s=c_s,
         ranks=[{k: r.get(k) for k in ("rank", "mesh", "seconds",
                                       "all_collectives", "b1_total",
                                       "peak_gb", "seconds_total")}
                | {"fit_losses": r["fit"]["losses"].tolist()} for r in c])
    emit("parallel_seconds", b_spawn_and_run_s=b_s, **parts)
    return launches


TRI_INV_SIZES = (705, 1250, 3001, 5000, 20000)


def event_ms(torch, fn):
    """Milliseconds of one call of ``fn`` on CUDA events (no warm-up),
    and what it returned."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def tri_inv_linv(torch, la, L, N: int) -> dict:
    """Phase 17 at one N: both routes of Linv timed (a warm-up each, then
    eight calls each in turns, the order reversed every other round) and
    held against the float64 inverse of L."""
    from mfgp_tpu_torch.utils import profiling

    f64 = torch.float64
    L64 = L.double()
    eye = torch.eye(N, dtype=f64, device=L.device)
    ref = torch.linalg.solve_triangular(L64, eye, upper=False)
    routes = {"tc": lambda: la.tri_inv_recursive(L),
              "strips": lambda: la._tri_inv_strips(L, 1024)}
    ms = {name: [] for name in routes}
    for fn in routes.values():
        fn()
    for k in range(8):
        for name in (("tc", "strips") if k % 2 else ("strips", "tc")):
            ms[name].append(event_ms(torch, routes[name])[0])
    out = {}
    for name, fn in routes.items():
        profiling.enable()
        profiling.reset()
        try:
            Linv = fn()
            snap = profiling.snapshot()
        finally:
            profiling.enable(False)
            profiling.reset()
        x = Linv.double()
        out[name] = {
            "ms": float(np.median(ms[name])), "ms_runs": ms[name],
            "err": float((x - ref).abs().max() / ref.abs().max()),
            "resid": float((L64 @ x - eye).abs().max()),
            "row_major": bool(Linv.is_contiguous()),
            "upper_zero": bool((torch.triu(Linv, 1) == 0).all()),
            "spans": snap["spans"].get("linalg.tri_inv", {}).get("calls", 0),
            "tc_count": snap["counters"].get("linalg.tri_inv_tc", 0)}
        del Linv, x
    tc, st = out["tc"], out["strips"]
    check(f"tri_inv N={N} vs float64",
          tc["err"] <= 2 * st["err"] + 2.0 ** -22
          and tc["resid"] <= 2 * st["resid"] + 2.0 ** -22,
          f"normwise err {tc['err']:.3e}, max |L Linv - I| {tc['resid']:.3e} "
          f"(<= twice the strips' {st['err']:.3e}, {st['resid']:.3e}, "
          "+ 2^-22)")
    check(f"tri_inv N={N} route",
          tc["row_major"] and tc["upper_zero"] and tc["spans"] == 1
          and tc["tc_count"] == int(N > 1024) and st["tc_count"] == 0,
          f"row-major {tc['row_major']}, zero above the diagonal "
          f"{tc['upper_zero']}, linalg.tri_inv spans {tc['spans']}, "
          f"linalg.tri_inv_tc {tc['tc_count']} (strips {st['tc_count']})")
    return out


def tri_inv_profile(torch, la, L) -> dict:
    """One tensor-core Linv of L (after a warm-up) under ``torch.profiler``:
    device ms per kernel name, and each ``tri_gemm`` launch's ms in launch
    order (per level, from the bottom)."""
    from torch.profiler import ProfilerActivity, profile

    la.tri_inv_recursive(L)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        la.tri_inv_recursive(L)
        torch.cuda.synchronize()
    by_name, launches = {}, []
    for e in prof.events():
        t = getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
        if not t or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + t / 1e3
        if "tri_gemm_kernel" in e.name:
            launches.append(t / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    return {"total_ms": sum(by_name.values()), "kernels_ms": top,
            "tri_gemm_ms": launches, "tri_gemm_sum_ms": sum(launches),
            "note": None if by_name else
            "torch.profiler reported no device time: not measured"}


def b2_after_linv(torch, ck, la, cov, problem) -> dict:
    """B2 on the unit's Linv made by either route (B2's data), each time
    just after another Linv by either route and alpha's products, as an
    evaluation runs them (what ran before B2: the caching allocator's
    state and the card's clock after it), with and without
    ``torch.cuda.empty_cache()`` between the two: the eight cases in turns,
    four rounds after an untimed one (the order reversed every other), one
    CUDA-event time each."""
    Xt, ft, yt, _, _, p = problem
    v, ls, rho, nz = p.variances, p.lengthscales, p.rhos, p.noises
    L = la.chol(cov.mf_train_cov(v, ls, rho, nz, Xt, ft, 1e-6, "rbf"))
    routes = {"strips": lambda: la._tri_inv_strips(L, 1024),
              "tc": lambda: la.tri_inv_recursive(L)}

    def linv_alpha(route):
        Linv = routes[route]()
        z = la.tri_lower_matmul(Linv, yt[:, None])
        return Linv, la.tri_lower_matmul_right(z.reshape(1, -1),
                                               Linv).reshape(-1)

    data = {r: linv_alpha(r) for r in routes}
    cases = [(d, b, e) for e in (False, True) for b in routes for d in routes]

    def key(d, b, e):
        return f"data={d},after={b}" + (",empty_cache" if e else "")

    ms = {key(*c): [] for c in cases}
    for k in range(5):  # the first round warms every path up, untimed
        for d, b, e in (cases if k % 2 else cases[::-1]):
            linv_alpha(b)
            if e:
                torch.cuda.empty_cache()
            t, _ = event_ms(torch, lambda: ck.syrk_grad_fused(
                *data[d], Xt, ft, v, ls, rho, nz, "rbf"))
            if k:
                ms[key(d, b, e)].append(t)
    return {"ms_runs": ms,
            "median_ms": {c: float(np.median(t)) for c, t in ms.items()}}


def tri_inv_phase(torch, ck, cov, dev, problem) -> dict:
    """Phase 17 (see the module docstring); returns its launches, counted
    from 0."""
    from bench import _theta, build_problem
    from mfgp_tpu_torch.ops import linalg as la

    v, ls, rho, nz = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in _theta())
    ck.reset_launches()
    for N in TRI_INV_SIZES:
        X, fid, _, _, _ = build_problem(N, 1, seed=0)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        fid = torch.as_tensor(fid, dtype=torch.long, device=dev)
        L = la.chol(cov.mf_train_cov(v, ls, rho, nz, X, fid, 1e-6, "rbf"))
        emit("tri_inv", part="linv", N=N, **tri_inv_linv(torch, la, L, N))
        if N == TRI_INV_SIZES[-1]:
            emit("tri_inv", part="profile", N=N,
                 **tri_inv_profile(torch, la, L))
        del L
        torch.cuda.empty_cache()
    emit("tri_inv", part="b2_after_linv", nvidia_smi=nvidia_smi(),
         **b2_after_linv(torch, ck, la, cov, problem))
    return dict(ck.LAUNCHES)


NEW_PHASES = ("study", "study_f64", "study_batched", "nigp", "recursive",
              "planner", "explore", "device_planner", "mission", "serve",
              "parallel", "tri_inv")


def study_path_phases(torch, ck, cov, dev, problem, only=NEW_PHASES) -> dict:
    """Phases 7 to 17 in turn (the batched study, 10, after the study's
    phases, whose dataset it compares with); returns each path's launches
    by phase."""
    launches = {}
    st = None
    try:
        if {"study", "study_f64", "study_batched"} & set(only):
            st = study_phase(torch, ck, cov, dev)
            launches["study"] = st["launches"]
        if "study_f64" in only:
            study_f64_phase(torch, ck, cov, dev, st)
        if "study_batched" in only:
            torch.cuda.empty_cache()
            launches["study_batched"] = study_batched_phase(torch, ck, cov,
                                                            dev, st)
    finally:
        if st is not None:
            shutil.rmtree(st["out_dir"], ignore_errors=True)
    torch.cuda.empty_cache()
    if "nigp" in only:
        launches["nigp"] = nigp_phase(torch, ck, cov, dev, problem)
    if "recursive" in only:
        launches["recursive"] = recursive_phase(torch, ck, cov, dev, problem)
    torch.cuda.empty_cache()
    if "planner" in only:
        launches["planner"] = planner_phase(torch, ck, cov, dev)
    torch.cuda.empty_cache()
    if "explore" in only:
        launches["explore"] = explore_phase(torch, ck, cov, dev)
    torch.cuda.empty_cache()
    if "device_planner" in only:
        launches["device_planner"] = device_planner_phase(torch, ck, cov,
                                                          dev)
    torch.cuda.empty_cache()
    if "mission" in only:
        launches["mission"] = mission_phase(torch, ck, cov, dev)
    torch.cuda.empty_cache()
    if "serve" in only:
        launches["serve"] = serve_phase(torch, ck, cov, dev)
    torch.cuda.empty_cache()
    if "parallel" in only:
        launches["parallel"] = parallel_phase(torch, ck, cov, dev)
    torch.cuda.empty_cache()
    if "tri_inv" in only:
        launches["tri_inv"] = tri_inv_phase(torch, ck, cov, dev, problem)
    return launches


def only_phases(names) -> int:
    """``--only``: the build and the named phases of 7 to 17; no result
    line."""
    import torch

    unknown = [n for n in names if n not in NEW_PHASES]
    if unknown or not torch.cuda.is_available():
        print(f"chip_smoke: --only takes {NEW_PHASES} and needs a CUDA "
              f"device (unknown: {unknown})", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mfgp_tpu_torch.models import mfgp as mf
    from mfgp_tpu_torch.ops import build
    from mfgp_tpu_torch.ops import covariance as cov
    from mfgp_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    build.build()
    build.load_library()
    problem = (make_problem(torch, mf, dev)
               if {"nigp", "recursive", "tri_inv"} & set(names) else None)
    emit("only", launches=study_path_phases(torch, ck, cov, dev, problem,
                                            names))
    for f in FAILURES:
        print(f"  FAILED {f}", file=sys.stderr)
    return 1 if FAILURES else 0


def main(argv) -> int:
    if argv[:1] == ["--b1-times"] and len(argv) == 2:
        return b1_times_only(argv[1])
    if argv[:1] == ["--only"] and len(argv) == 2:
        return only_phases(argv[1].split(","))
    if argv:
        print("usage: chip_smoke.py [--b1-times ROOT | --only PHASE,...]",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bench import BASELINE_CPU_NLML, BASELINE_CPU_NLML_MATERN32
    from mfgp_tpu_torch.models import gp
    from mfgp_tpu_torch.models import mfgp as mf
    from mfgp_tpu_torch.ops import build
    from mfgp_tpu_torch.ops import covariance as cov
    from mfgp_tpu_torch.ops import cuda_kernels as ck
    from mfgp_tpu_torch.ops import linalg as la

    # the port's precision policy (set by mfgp_tpu_torch.ops), stated here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib_path),
         ptxas=[ln.strip() for ln in log
                if "registers" in ln or "spill" in ln or "Compiling" in ln],
         b1_ptxas=ptxas_report(log, "ar1_cov_kernel"))

    errs = kernel_checks(torch, ck, mf, dev)
    errs["ar1_cov_fused"] = max(errs["ar1_cov_fused"],
                                b1_checks(torch, ck, dev))

    problem = make_problem(torch, mf, dev)
    refs = {"rbf": BASELINE_CPU_NLML, "matern32": BASELINE_CPU_NLML_MATERN32}

    # the main path: both units, launch counters from 0
    ck.reset_launches()
    states = {kern: run_unit(torch, ck, mf, problem, kern, refs[kern])
              for kern in BASES}
    main_launches = dict(ck.LAUNCHES)
    check("main path launches", all(n > 0 for n in main_launches.values()),
          f"{main_launches}")

    times = {kern: unit_times(torch, ck, mf, la, cov, problem, kern,
                              states[kern]) for kern in BASES}
    del states
    fit_launches = fit_phase(torch, ck, mf, gp, cov, dev, problem)
    torch.cuda.empty_cache()
    path_launches = study_path_phases(torch, ck, cov, dev, problem)
    if "jax" in sys.modules:
        FAILURES.append("jax was imported")
    errs["ar1_cov_fused"] = max(errs["ar1_cov_fused"], *B1_PATH_ERRS)

    # bounds at the unit's shapes (rbf): B1 from its Gram's bytes and flop
    # (b1_launches); B2's N^3/3 and B3's N^2 M float32-equivalent flop at
    # the 3xTF32 rate (each reads its N x N float32 operand in far less)
    N, M = problem[0].shape[0], problem[3].shape[0]
    bounds = {"ar1_cov_fused": (times["rbf"]["ar1_cov_fused"]["bound_ms"],
                                times["rbf"]["ar1_cov_fused"]["bound_by"]),
              "syrk_grad_fused": (N ** 3 / 3 / TF32X3_FLOPS * 1e3,
                                  "operations"),
              "posterior_fused": (N * N * M / TF32X3_FLOPS * 1e3,
                                  "operations"),
              "tf32_split": (times["rbf"]["tf32_split"]["bound_ms"],
                             times["rbf"]["tf32_split"]["bound_by"]),
              "tri_gemm": (N ** 3 / 3 / TF32X3_FLOPS * 1e3, "operations")}
    print(nvidia_smi(), flush=True)
    # no single PyTorch call computes any of these functions, so no library
    # time (library_ms null); "launches" is the unit's count, the other
    # counts are those of each later path, each from 0
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name],
         "fit_launches": fit_launches[name],
         **{f"{phase}_launches": n[name]
            for phase, n in path_launches.items()},
         "max_abs_err": errs[name],
         "ms": times["rbf"][name]["ms"],
         "plain_ms": times["rbf"][name]["plain_ms"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, src, rep in KERNELS]}), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:",
              file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
