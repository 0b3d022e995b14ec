"""Command-line entry points of the port (counterpart of
``mfgp_tpu/cli.py``, the commands of the model-comparison study):

  python -m mfgp_tpu_torch.cli sfgp     <GPData.csv> [--field-settings F]
  python -m mfgp_tpu_torch.cli nigp     <GPData.csv> [--iters N]
  python -m mfgp_tpu_torch.cli mfgp     <GPData.csv> [--field-settings F]
  python -m mfgp_tpu_torch.cli pipeline <traj.csv> --out D [--seed S] [--vmn V]
  python -m mfgp_tpu_torch.cli trainers --data-dir D --field-dir F --out O
  python -m mfgp_tpu_torch.cli aggregate 'GPResults/MSE_*.txt' --out results.csv
  python -m mfgp_tpu_torch.cli study    --out D [--fit-mode device] ...
  python -m mfgp_tpu_torch.cli explore  [--variant MFEGP|SFGP|...] --out D
  python -m mfgp_tpu_torch.cli mission  [--variant MFEGP] [--flight dynamic]
                                        [--submit URL]
  python -m mfgp_tpu_torch.cli mission-server [--port 8080]
  python -m mfgp_tpu_torch.cli campaign [--variants MFEGP,MFGP,SFEGP,SFGP]
                                        [--plot out.png]
  python -m mfgp_tpu_torch.cli serve    ck.npz | name=ck.npz ... [--plan-cost C]
  python -m mfgp_tpu_torch.cli plot     data.csv --out fig.png [--gpres]
  python -m mfgp_tpu_torch.cli infogain-test      # info-gain identity check

Every command runs on the card and raises where there is no CUDA device,
unless ``--cpu`` (before the command) asks for the CPU. Each prints one
JSON document with the JAX package's keys on standard output; the trainers
and the study also report, on standard error, how many WMSE metrics were
redone in float64 (on the same device). ``explore``, ``mission`` and
``campaign`` run their models' covariance tiles in float32 on the card and
everything in float64 with ``--cpu``, what the JAX package computes on the
TPU and on the CPU. ``serve`` and ``mission-server`` run until interrupted;
``serve`` serves a checkpoint's model in float32 on the card (as saved with
``--cpu``). ``mission --submit URL`` runs nothing locally: it posts the
mission to a mission server and prints the finished job.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _device(args):
    """The card, unless ``--cpu`` was given; raises without a CUDA device."""
    from mfgp_tpu_torch.utils.device import resolve

    return resolve("cpu" if args.cpu else "cuda")


def _fit_dtype(fit_mode: str):
    """float32 for the device modes, float64 for scipy's."""
    return np.float32 if fit_mode.startswith("device") else np.float64


def _grid_rmse(mu, field_settings, tp, device) -> float:
    from mfgp_tpu_torch.fields.wrbf import parse_field_settings

    f = parse_field_settings(field_settings, device=device)
    err = mu.detach().cpu().numpy() - f.numpy(tp)
    return float(np.sqrt(np.mean(err ** 2)))


def cmd_sfgp(args):
    """BASELINE config 1: SFGP fit + posterior grid on one dataset."""
    device = _device(args)
    from mfgp_tpu_torch.data.io import load_gp_dataset
    from mfgp_tpu_torch.models.gp import GP
    from mfgp_tpu_torch.utils.configs import SimConfig

    ds = load_gp_dataset(args.dataset)
    gp = GP(ds.X_est, ds.y, kernel=args.kernel, jitter=1e-6, device=device)
    gp.optimize()
    tp = SimConfig().test_points()
    mu, var = gp.predict(tp)
    out = {"model": "sfgp", "n": ds.n,
           "nlml": -float(gp.log_likelihood()),
           "param_array": gp.param_array.tolist()}
    if args.field_settings:
        out["rmse"] = _grid_rmse(mu, args.field_settings, tp, device)
    print(json.dumps(out))


def cmd_nigp(args):
    """BASELINE config 2: NIGP with KF localization input noise."""
    device = _device(args)
    from mfgp_tpu_torch.data.io import load_gp_dataset
    from mfgp_tpu_torch.models.nigp import NIGP

    ds = load_gp_dataset(args.dataset)
    m = NIGP(n_restarts=2, iters=args.iters, device=device)
    m.fit(ds.X_est, ds.y)
    mu, var = m.predict(ds.X_est[:10])
    print(json.dumps({"model": "nigp", "n": ds.n,
                      "params": m.get_params().tolist(),
                      "mu_head": np.asarray(mu)[:3].tolist()}))


def cmd_mfgp(args):
    """BASELINE config 3: AR1 MFGP on fidelity-binned data."""
    device = _device(args)
    from mfgp_tpu_torch.data.io import load_gp_dataset
    from mfgp_tpu_torch.models.mfgp import MFGP
    from mfgp_tpu_torch.utils.configs import SimConfig

    ds = load_gp_dataset(args.dataset)
    Xs, ys = ds.fidelity_lists()
    m = MFGP.from_fidelity_lists(Xs, ys, device=device, kernel=args.kernel,
                                 jitter=1e-6)
    m.optimize(fix_rhos=True)
    tp = SimConfig().test_points()
    mu, var = m.predict(tp)
    out = {"model": "mfgp", "n": ds.n,
           "nlml": -float(m.log_likelihood()),
           "param_array": m.param_array.tolist()}
    if args.field_settings:
        out["rmse"] = _grid_rmse(mu, args.field_settings, tp, device)
    print(json.dumps(out))


def cmd_pipeline(args):
    """Stages 1-3: trajectory -> estimates -> measurements -> GP dataset."""
    device = _device(args)
    from mfgp_tpu_torch.data.io import load_table
    from mfgp_tpu_torch.data.pipeline import run_pipeline
    from mfgp_tpu_torch.utils.configs import SimConfig

    cfg = SimConfig(seed=args.seed, vmn=args.vmn)
    traj = load_table(args.trajectory)
    est, meas, gpd, _ = run_pipeline(traj, cfg, out_dir=args.out,
                                     device=device)
    print(json.dumps({"estimates": est.data.shape[0],
                      "gp_rows": gpd.data.shape[0], "out": args.out}))


def _report_f64(count: int) -> None:
    print(f"wmse_f64_count: {count} WMSE metric(s) redone in float64",
          file=sys.stderr, flush=True)


def cmd_trainers(args):
    """GPTrainers sweep over a GPDataSets directory."""
    device = _device(args)
    from mfgp_tpu_torch.data.trainers import F64_KEY, process_directory

    res = process_directory(args.data_dir, args.field_dir, args.out,
                            kernel=args.kernel, resume=not args.no_resume,
                            fit_mode=args.fit_mode, verbose=False,
                            dtype=_fit_dtype(args.fit_mode), device=device)
    _report_f64(sum(m.pop(F64_KEY) for m in res.values()))
    print(json.dumps(res, indent=1))


def cmd_aggregate(args):
    from mfgp_tpu_torch.data.aggregate import collect_results, summary

    rows = collect_results(args.pattern, args.out)
    print(json.dumps(summary(rows), indent=1))


def cmd_study(args):
    """Full study sweep: trajectories -> pipeline -> 4-model training ->
    aggregation (the reference's entire manual workflow as one command)."""
    device = _device(args)
    from mfgp_tpu_torch.data.study import run_study
    from mfgp_tpu_torch.data.trainers import F64_KEY

    timings = {}
    rep = run_study(
        args.out,
        traj_seeds=tuple(range(args.trajectories)),
        vmn_levels=tuple(args.vmn),
        field_seeds=tuple(args.field_seeds),
        closed_loop=args.closed_loop,
        duration=args.duration,
        fit_mode=args.fit_mode,
        dtype=_fit_dtype(args.fit_mode), device=device, timings=timings,
        fit_chunk=args.fit_chunk, eval_chunk=args.eval_chunk, ftol=args.ftol)
    _report_f64(timings[F64_KEY])
    print(json.dumps(rep, indent=1))


def cmd_explore(args):
    """BASELINE config 5: full closed-loop adaptive exploration."""
    device = _device(args)
    from mfgp_tpu_torch.sim import ExplorationSim
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    variant = args.variant.upper()
    exp = ExperimentConfig(multi_fidelity=variant.startswith("MF"),
                           ergodic=variant in ("MFEGP", "SFEGP"),
                           ergodic_metric=args.ergodic_metric,
                           info_cost=args.info_cost,
                           B=args.budget, BD=args.bd)
    sim = ExplorationSim(exp, seed=args.seed, out_dir=args.out,
                         plan_iters=args.plan_iters, flight=args.flight,
                         planner_backend=args.planner,
                         plan_ensemble=args.plan_ensemble, device=device)
    if variant == "MANUAL":
        if args.waypoints:
            wp = np.loadtxt(args.waypoints, delimiter=",", ndmin=2)[:, :3]
        elif args.trajectory_name:
            from mfgp_tpu_torch.hw.trajectories import (reference_trajectory,
                                                        scale_to_workspace)

            t = np.linspace(0, 540, 40)
            curve = reference_trajectory(args.trajectory_name, t)
            wp = scale_to_workspace(curve, exp.sim.WS, exp.sim.max_depth)
        else:  # default lawnmower-ish demo chain
            wp = np.array([[1, 1, 0], [8, 4, 3], [3, 15, 5], [8, 18, 0]],
                          float)
        res = sim.run_manual(wp)
        name = "Manual"
    else:
        res = sim.run(checkpoint_path=args.checkpoint,
                      resume_from=args.resume_from)
        name = exp.variant
    out = {
        "variant": name, "replans": len(res.replans),
        "n_data": int(res.gp_data.data.shape[0]),
        "budget_used": res.budget_used, "rmse": res.rmse,
    }
    if args.flight == "dynamic" and res.replans:
        out["tracking_rmse"] = [r.tracking_rmse for r in res.replans]
        out["flown_budget"] = sum(r.flown_budget or 0.0 for r in res.replans)
    print(json.dumps(out))


def _mission(args, exp, seed: int, device):
    from mfgp_tpu_torch.sim.mission_device import DeviceMission

    return DeviceMission(exp, seed=seed, flight=args.flight,
                         plan_iters=args.plan_iters, e_max=args.e_max,
                         fit_restarts=args.fit_restarts,
                         glide_stride=args.glide_stride, device=device)


def cmd_mission(args):
    """The whole exploration experiment as one device program
    (sim.mission_device.DeviceMission): a cold run, then a second seed on
    the built planner and runtime (the JAX package's warm run)."""
    import time

    if args.submit:
        return _submit_mission(args)
    device = _device(args)
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    variant = args.variant.upper()
    exp = ExperimentConfig(multi_fidelity=variant.startswith("MF"),
                           ergodic=variant in ("MFEGP", "SFEGP"),
                           ergodic_metric=args.ergodic_metric,
                           info_cost=args.info_cost,
                           update_hyps=args.update_hyps,
                           B=args.budget, BD=args.bd)
    mission = _mission(args, exp, args.seed, device)
    t0 = time.perf_counter()
    res = mission.run(mode=args.mode)
    cold = time.perf_counter() - t0
    # warm: a new seed on the same mission (its planner's and runtime's
    # captured graphs and built state kept)
    t0 = time.perf_counter()
    mission.seed = args.seed + 1
    res2 = mission.run(mode=args.mode)
    warm = time.perf_counter() - t0
    mission.seed = args.seed
    out = {
        "variant": variant, "replans": res.n_replans,
        "n_data": int(res.gp_data.data.shape[0]),
        "budget_used": res.budget_used, "rmse": res.rmse,
        "replans2": res2.n_replans, "rmse2": res2.rmse,
        "launch_seconds_cold": round(cold, 3),
        "launch_seconds_warm": round(warm, 3),
    }
    if args.flight == "dynamic" and res.replans:
        out["tracking_rmse"] = [round(r["tracking_rmse"], 4)
                                for r in res.replans]
        out["flown_budget"] = round(
            sum(r["flown_budget"] for r in res.replans), 3)
    if args.ensemble > 1:
        t0 = time.perf_counter()
        ens = mission.run_ensemble(args.ensemble, mode=args.mode,
                                   seed_chunk=args.seed_chunk)
        out["ensemble_seconds"] = round(time.perf_counter() - t0, 3)
        out["ensemble_rmse"] = [round(e.rmse, 4) for e in ens]
        out["ensemble_replans"] = [e.n_replans for e in ens]
    if args.out:
        mission.save_artifacts(res, args.out)
        out["artifacts"] = args.out
    print(json.dumps(out))


SUBMIT_TIMEOUT_S = 3600.0  # a submitted mission's longest wait


def _submit_mission(args):
    """POST the mission spec to a mission server and poll the job to its
    end (``SUBMIT_TIMEOUT_S`` at most): the time to a result excludes the
    building and capturing that the server's warm mission already did
    (see serve.MissionService)."""
    import time
    import urllib.request

    spec = {"variant": args.variant, "seed": args.seed,
            "budget": args.budget, "bd": args.bd,
            "plan_iters": args.plan_iters, "e_max": args.e_max,
            "update_hyps": args.update_hyps, "flight": args.flight,
            "ergodic_metric": args.ergodic_metric,
            "info_cost": args.info_cost,
            "fit_restarts": args.fit_restarts,
            "glide_stride": args.glide_stride}
    url = args.submit.rstrip("/")
    t0 = time.perf_counter()

    def call(req):
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    sub = call(urllib.request.Request(
        url + "/mission", json.dumps(spec).encode(),
        {"Content-Type": "application/json"}))
    while True:
        job = call(f"{url}/mission/{sub['job']}")
        if job["state"] in ("done", "error"):
            break
        if time.perf_counter() - t0 > SUBMIT_TIMEOUT_S:
            raise TimeoutError(f"mission job {sub['job']} not done after "
                               f"{SUBMIT_TIMEOUT_S} s: {job}")
        time.sleep(0.5)
    job["client_seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(job))


def cmd_mission_server(args):
    """Long-lived mission-submission server (serve.MissionService)."""
    device = _device(args)
    from mfgp_tpu_torch.serve import serve_missions

    serve_missions(host=args.host, port=args.port, device=device)


def cmd_campaign(args):
    """The reference's 4-driver experiment campaign (SURVEY C25) x repeat
    seeds, one mission ensemble per variant."""
    import time

    device = _device(args)
    from mfgp_tpu_torch.sim.mission_device import run_campaign

    t0 = time.perf_counter()
    camp = run_campaign(
        variants=[v.strip() for v in args.variants.split(",")],
        n_seeds=args.seeds, seed=args.seed,
        exp_kw=dict(B=args.budget, BD=args.bd,
                    update_hyps=args.update_hyps),
        mode=args.mode, seed_chunk=args.seed_chunk,
        plan_iters=args.plan_iters, e_max=args.e_max, device=device)
    out = {"campaign_seconds": round(time.perf_counter() - t0, 3),
           "runs": sum(len(c["rmse"]) for c in camp.values())}
    if args.plot:
        from mfgp_tpu_torch.viz import plot_campaign

        out["plot"] = plot_campaign(camp, args.plot)
    for v, c in camp.items():
        out[v] = {"rmse_mean": round(float(np.mean(c["rmse"])), 4),
                  "rmse": [round(r, 4) for r in c["rmse"]],
                  "replans": c["replans"],
                  "budget_used": [round(b, 2) for b in c["budget_used"]],
                  "seconds": round(c["seconds"], 3)}
    print(json.dumps(out))


def cmd_infogain_test(args):
    """BASELINE config 4 sanity: the mutual-information identity
    (reference/informationGainTest.py) as a quick numerical check, in
    float64 on the chosen device."""
    device = _device(args)
    import torch

    from mfgp_tpu_torch.metrics import info_gain as ig
    from mfgp_tpu_torch.ops import kernels as k

    rng = np.random.default_rng(args.seed)
    X = torch.as_tensor(rng.uniform(0, 5, (30, 1)), device=device)
    K = k.rbf(X, X, 2.0, [0.8])
    sig_n = 0.1
    exact = float(ig.exact_mutual_information(K, sig_n))
    # sequential factorization: |K + s I| = prod_k v_k with v_k the noisy
    # conditional variances -> MI = 0.5 sum log(v_k / s)
    L = torch.linalg.cholesky(K + sig_n * torch.eye(K.shape[0],
                                                    dtype=K.dtype,
                                                    device=device))
    seq = float(0.5 * torch.sum(torch.log(torch.diagonal(L) ** 2 / sig_n)))
    # the reference's scorer accumulates log(1 + v_k/s) instead (documented
    # overshoot, metrics/info_gain.py) — reported for comparison
    ref_style = float(ig.sequential_gain_from_cov(
        K, sig_n, first_self_conditioned=False, factor=0.5))
    print(json.dumps({"exact": exact, "sequential": seq,
                      "rel_err": abs(exact - seq) / abs(exact),
                      "reference_style_score": ref_style}))


def cmd_serve(args):
    """Serve trained model checkpoint(s) over HTTP (posterior + EID).

    One positional checkpoint serves single-model; repeat ``name=path``
    pairs route multiple models (/models/<name>/predict)."""
    device = _device(args)
    from mfgp_tpu_torch.serve import serve_checkpoint, serve_checkpoints

    def is_pair(c):
        # name=path where the name is a bare identifier: a lone path that
        # merely contains '=' (e.g. /data/run=3/ck.npz) is not a pair
        name, sep, _ = c.partition("=")
        return bool(sep) and name.isidentifier()

    if all(is_pair(c) for c in args.checkpoint):
        if args.plan_cost:
            raise SystemExit("--plan-cost serves ONE model (no name=path "
                             "routing)")
        paths = dict(c.split("=", 1) for c in args.checkpoint)
        serve_checkpoints(paths, host=args.host, port=args.port,
                          device=device)
    else:
        if len(args.checkpoint) != 1:
            raise SystemExit("either ONE checkpoint or name=path pairs")
        serve_checkpoint(args.checkpoint[0], host=args.host, port=args.port,
                         plan_cost=args.plan_cost,
                         plan_iters=args.plan_iters, device=device)


def cmd_plot(args):
    """Headless CSV/GPRes plotting (the reference dataPlotter capability);
    host only, no device."""
    from mfgp_tpu_torch.viz import plot_csv, plot_gpres

    if args.gpres:
        out = plot_gpres(args.csv, args.out)
    else:
        def conv(c):
            return int(c) if c.isdigit() else c

        out = plot_csv(args.csv, args.out, x=conv(args.x),
                       y=[conv(c) for c in args.y], kind=args.kind)
    print(json.dumps({"figure": out}))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="mfgp_tpu_torch",
        description="MFGP exploration study on one NVIDIA GPU (PyTorch/CUDA)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device; without "
                         "one the commands raise)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sfgp"); p.set_defaults(fn=cmd_sfgp)
    p.add_argument("dataset"); p.add_argument("--field-settings")
    p.add_argument("--kernel", default="rbf")

    p = sub.add_parser("nigp"); p.set_defaults(fn=cmd_nigp)
    p.add_argument("dataset"); p.add_argument("--iters", type=int, default=10)

    p = sub.add_parser("mfgp"); p.set_defaults(fn=cmd_mfgp)
    p.add_argument("dataset"); p.add_argument("--field-settings")
    p.add_argument("--kernel", default="rbf")

    p = sub.add_parser("pipeline"); p.set_defaults(fn=cmd_pipeline)
    p.add_argument("trajectory"); p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vmn", type=float, default=0.2)

    p = sub.add_parser("trainers"); p.set_defaults(fn=cmd_trainers)
    p.add_argument("--fit-mode", default="scipy",
                   choices=["scipy", "device", "device-batched"])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--field-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--kernel", default="rbf")
    p.add_argument("--no-resume", action="store_true")

    p = sub.add_parser("explore"); p.set_defaults(fn=cmd_explore)
    p.add_argument("--variant", default="MFEGP",
                   type=lambda s: s.upper(),
                   choices=["MFEGP", "MFGP", "SFEGP", "SFGP", "MANUAL"])
    p.add_argument("--out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget", type=float, default=150.0)
    p.add_argument("--bd", type=int, default=10)
    p.add_argument("--plan-iters", type=int, default=40)
    p.add_argument("--checkpoint", help="write a checkpoint after each replan")
    p.add_argument("--resume-from", help="resume from a checkpoint file")
    p.add_argument("--planner", default="host", choices=["host", "device"],
                   help="device = the whole RIG loop on the device "
                        "(planning/rig_device.py), every eligible extension "
                        "scored")
    p.add_argument("--plan-ensemble", type=int, default=1,
                   help="device planner: instances per replan, run as lanes "
                        "of one loop; the best plan wins")
    p.add_argument("--ergodic-metric", default="kl",
                   choices=["kl", "fourier"],
                   help="ergodic variants: trajectory-distribution KL "
                        "(reference) or Fourier/Sobolev spectral cost")
    p.add_argument("--info-cost", default="sequential",
                   choices=["sequential", "batch"],
                   help="info-gain variants: sequential entropy or the "
                        "grid log-det the reference's physical drivers use")
    p.add_argument("--waypoints", help="CSV of x,y,z rows (MANUAL variant)")
    p.add_argument("--trajectory-name",
                   help="named reference curve for MANUAL (circle, fig8, ...)")
    p.add_argument("--flight", default="kinematic",
                   choices=["kinematic", "dynamic"],
                   help="dynamic = fly plans through the full "
                        "sense->estimate->control runtime (hw/runtime.py)")

    p = sub.add_parser("mission", help="the whole experiment as one "
                       "device program")
    p.set_defaults(fn=cmd_mission)
    p.add_argument("--variant", default="MFEGP", type=lambda s: s.upper(),
                   choices=["MFEGP", "MFGP", "SFEGP", "SFGP"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget", type=float, default=80.0)
    p.add_argument("--bd", type=int, default=4)
    p.add_argument("--plan-iters", type=int, default=40)
    p.add_argument("--e-max", type=int, default=16,
                   help="best-path edge capacity per replan")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "one", "stepped"],
                   help="one = every replan from carried device state; "
                        "stepped = spans of replans with a synchronisation "
                        "between them; auto = one (CUDA has no per-launch "
                        "ceiling)")
    p.add_argument("--seed-chunk", type=int, default=None,
                   help="with --ensemble: members per pass (default all)")
    p.add_argument("--ergodic-metric", default="kl",
                   choices=["kl", "fourier"])
    p.add_argument("--info-cost", default="sequential",
                   choices=["sequential", "batch"])
    p.add_argument("--update-hyps", action="store_true",
                   help="per-replan L-BFGS hyperparameter refits instead of "
                        "frozen hyperparameters")
    p.add_argument("--flight", default="kinematic",
                   choices=["kinematic", "dynamic"],
                   help="dynamic = fly each plan through the device "
                        "runtime (hw/runtime_device.py)")
    p.add_argument("--ensemble", type=int, default=1,
                   help="also run K complete missions (seeds seed..seed+"
                        "K-1) as lanes of one program")
    p.add_argument("--fit-restarts", type=int, default=1,
                   help="with --update-hyps: restart-batched refits (warm "
                        "start + K-1 perturbed log-space starts, best "
                        "finite NLML kept)")
    p.add_argument("--glide-stride", type=int, default=1,
                   help="with --flight dynamic: steady GLIDE windows "
                        "advance with one coarse tick of K*dt")
    p.add_argument("--out", default=None,
                   help="write the reference's per-replan artifact set "
                        "(plannedTraj{n}.csv, EID{n}.csv, hyps.csv, "
                        "GPData.csv, replans.csv) to this directory")
    p.add_argument("--submit", default=None, metavar="URL",
                   help="submit to a long-lived mission server "
                        "(cli mission-server) instead of running locally: "
                        "a repeated configuration reuses its built, "
                        "captured mission")

    p = sub.add_parser(
        "mission-server",
        help="long-lived mission-submission server (serve.MissionService):"
             " keeps each configuration's built mission and captured "
             "graphs across POST /mission submissions")
    p.set_defaults(fn=cmd_mission_server)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)

    p = sub.add_parser("campaign", help="the reference's 4-driver campaign "
                       "x seeds, one mission ensemble per variant")
    p.set_defaults(fn=cmd_campaign)
    p.add_argument("--variants", default="MFEGP,MFGP,SFEGP,SFGP")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget", type=float, default=20.0)
    p.add_argument("--bd", type=int, default=2)
    p.add_argument("--plan-iters", type=int, default=40)
    p.add_argument("--e-max", type=int, default=16)
    p.add_argument("--update-hyps", action="store_true")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "one", "stepped"])
    p.add_argument("--seed-chunk", type=int, default=None)
    p.add_argument("--plot", default=None,
                   help="also render the per-variant RMSE figure to "
                        "this PNG")

    p = sub.add_parser("aggregate"); p.set_defaults(fn=cmd_aggregate)
    p.add_argument("pattern"); p.add_argument("--out")

    p = sub.add_parser("infogain-test"); p.set_defaults(fn=cmd_infogain_test)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("study"); p.set_defaults(fn=cmd_study)
    p.add_argument("--out", required=True)
    p.add_argument("--trajectories", type=int, default=2)
    p.add_argument("--vmn", type=float, nargs="+", default=[0.0, 0.1, 0.2])
    p.add_argument("--field-seeds", type=int, nargs="+", default=[0])
    p.add_argument("--closed-loop", action="store_true",
                   help="generate trajectories with the closed-loop sim")
    p.add_argument("--duration", type=float, default=1200.0)
    p.add_argument("--fit-mode", default="scipy",
                   choices=["scipy", "device", "device-batched"],
                   help="scipy = L-BFGS-B on the autodiff NLML (float64); "
                        "device = restart-batched fits (float32, through "
                        "the CUDA kernels on the card); device-batched = "
                        "the whole matrix at once, every dataset a lane of "
                        "one batch per model family (float32)")
    p.add_argument("--fit-chunk", type=int, default=8,
                   help="device-batched only: datasets per call of a "
                        "model family's fit sweep")
    p.add_argument("--eval-chunk", type=int, default=8,
                   help="device-batched only: datasets per call of its "
                        "evaluation")
    p.add_argument("--ftol", type=float, default=1e-6,
                   help="device-batched only: relative-f stagnation stop "
                        "of the restart-batched L-BFGS lanes")

    p = sub.add_parser("serve"); p.set_defaults(fn=cmd_serve)
    p.add_argument("checkpoint", nargs="+",
                   help="one checkpoint path, or name=path pairs for "
                        "multi-model routing")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--plan-cost", default=None,
                   choices=("ergodic", "fourier", "sf_gain", "mf_gain",
                            "sf_logdet", "mf_logdet"),
                   help="enable POST /plan (replan-as-a-service on the "
                        "device planner) with this scoring family")
    p.add_argument("--plan-iters", type=int, default=100,
                   help="device-planner iterations per /plan request")

    p = sub.add_parser("plot"); p.set_defaults(fn=cmd_plot)
    p.add_argument("csv"); p.add_argument("--out", required=True)
    p.add_argument("--x", default="0")
    p.add_argument("--y", nargs="+", default=["1"])
    p.add_argument("--kind", default="line", choices=["line", "scatter"])
    p.add_argument("--gpres", action="store_true",
                   help="treat input as a GPRes artifact (scatter vs truth)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
