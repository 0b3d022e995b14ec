"""Generator ``fit_eval_sharded``: one closed-loop caller making the
evaluation of a memory-scaled fit, fully sharded over the configuration's
``mp`` ranks, one per GPU of the node: the program's
``parallel.make_fully_sharded_nlml_value_and_grad`` at its default panel
width and layout.

The run's process is rank 0, on the run's device. Set-up builds the
program's kernel library once, then starts ranks 1.. as processes of their
own (``fit_eval_sharded_rank.py``); every rank joins through the program's
launcher (``parallel.init_ranks``, here with the environment ``torchrun``
would set) and builds the same data from the seed (``common/tiles``).
Each step, rank 0 tells the others which step to take, or to stop, by one
small broadcast of its own, outside the program's collectives, spans and
counters; every rank then evaluates at the step's log-hyperparameters,
drawn from the seed alike on every rank, and rank 0 reads the value and
the gradient back, as the optimizer reads them. The trace and the spans
are rank 0's; the other ranks run the same sweeps untraced.

A rank that fails stops the others within the group's timeout
(``timeout_s``: a collective that waits longer tears its process down);
rank 0 stops its ranks in ``release`` and kills them at exit, and a rank
whose parent is gone exits.

Traffic parameters: ``param_spread``, ``max_steps``, ``warm_steps``,
``check_steps`` (steps the reference recomputes, ``reference/gp_inplace``),
``trace_seconds``, ``control`` (``program_tf32``: the switch reaches every
rank), ``control_seconds``, ``timeout_s``.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from benchmark.common import ar1, gen, tiles
from benchmark.common.harness import closed_loop, log
from benchmark.common.trace import span
from benchmark.reference import gp as ref
from benchmark.reference import gp_inplace

RANK_MAIN = Path(__file__).resolve().parent / "fit_eval_sharded_rank.py"
STOP, WARM, STEP = 0, 1, 2
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()


def prepare(torch, device, config: dict, traffic: dict, seed: int) -> dict:
    """Every rank's state: the data on its device, every step's
    log-hyperparameter row, the configuration's row, and the program's
    evaluation over the mesh of the joined group."""
    from mfgp_tpu_torch import parallel as par
    from mfgp_tpu_torch.models import mfgp as mf

    X, fid, y = tiles.build_tiles(config, seed)
    rows = gen.step_params(seed, traffic["max_steps"], config["theta"],
                           traffic["param_spread"])
    f32 = dict(dtype=torch.float32, device=device)
    mesh = par.make_mesh(mp=config["mp"], device=device.type)
    return dict(
        mf=mf, device=device, rows=rows,
        X=torch.as_tensor(X, **f32), y=torch.as_tensor(y, **f32),
        fid=torch.as_tensor(fid, dtype=torch.long, device=device),
        rows_dev=torch.as_tensor(rows, **f32),
        base=torch.as_tensor(gen.log_theta(config["theta"]), **f32),
        rhos=torch.as_tensor(config["theta"]["rhos"], **f32),
        vg=par.make_fully_sharded_nlml_value_and_grad(
            mesh, config["N"], jitter=config["jitter"]))


def _command(torch, st, cmd: int = STOP, i: int = 0):
    """Rank 0's command to every rank: (cmd, step) from rank 0."""
    import torch.distributed as dist

    msg = torch.tensor([cmd, i], dtype=torch.long, device=st["device"])
    dist.broadcast(msg, src=0)
    return msg


def _run(config, st, cmd: int, i: int):
    """The program's evaluation at the command's row: (value, gradient)."""
    row = st["base"] if cmd == WARM else st["rows_dev"][i]
    lv, ll, ln = ar1.split(row, config["F"], config["D"])
    return st["vg"](st["mf"].MFGPParams(lv, ll, st["rhos"], ln), st["X"],
                    st["fid"], st["y"])


def _evaluate(ctx, st, cmd: int, i: int = 0) -> np.ndarray:
    """One step of rank 0; [value, gradient (log variances, log
    lengthscales, log noises)] on the host."""
    torch = ctx.torch
    with span(torch, "command"):
        _command(torch, st, cmd, i)
    with span(torch, "nlml_value_and_grad"):
        v, g = _run(ctx.config, st, cmd, i)
    with span(torch, "readback"):
        return torch.cat([v.reshape(1), g.log_variances,
                          g.log_lengthscales.reshape(-1),
                          g.log_noises]).double().cpu().numpy()


def setup(ctx) -> dict:
    """Start ranks 1.. and join them as rank 0, then warm every rank."""
    # the program's launcher first: without it, fail before any rank starts
    from mfgp_tpu_torch.parallel import init_ranks

    torch, c, t = ctx.torch, ctx.config, ctx.traffic
    cuda = ctx.device.type == "cuda"
    if cuda:
        from mfgp_tpu_torch.ops import build

        build.build()  # once, before the ranks start
    world = c["mp"] * c["dp"]
    launch = dict(RANK="0", WORLD_SIZE=str(world), LOCAL_RANK="0",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in _LAUNCH_ENV}
    os.environ.update(launch)
    args = dict(config=c, traffic=t, seed=ctx.seed,
                backend="nccl" if cuda else "gloo",
                tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    procs = [subprocess.Popen(
        [sys.executable, str(RANK_MAIN), json.dumps(args)], stdout=2,
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(1, world)]
    atexit.register(_kill, procs)
    st = dict(procs=procs, saved_env=saved)
    try:
        device = init_ranks(args["backend"], t["timeout_s"])
        st.update(prepare(torch, device, c, t, ctx.seed))
        for _ in range(t["warm_steps"]):
            _evaluate(ctx, st, WARM)
    except BaseException:
        _kill(procs)
        raise
    return st


def follow(args: dict) -> None:
    """Ranks 1..: join, build the data, and evaluate as rank 0 commands
    until it says stop (``fit_eval_sharded_rank.py``)."""
    import torch
    import torch.distributed as dist

    from mfgp_tpu_torch.parallel import init_ranks

    torch.backends.cuda.matmul.allow_tf32 = args["tf32"]
    device = init_ranks(args["backend"], args["traffic"]["timeout_s"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    st = prepare(torch, device, args["config"], args["traffic"],
                 args["seed"])
    n = 0
    while True:
        cmd, i = _command(torch, st).tolist()
        if cmd == STOP:
            break
        _run(args["config"], st, cmd, i)
        n += 1
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"rank {dist.get_rank()}: {n} evaluations, peak {peak} bytes "
        f"on {device}")
    dist.destroy_process_group()


def window(ctx, st, seconds: float) -> dict:
    outs, t0, t_end = closed_loop(
        ctx.torch, lambda i: _evaluate(ctx, st, STEP, i), seconds,
        ctx.traffic["check_steps"], ctx.traffic["max_steps"])
    st["outs"] = outs
    n = len(outs)
    return dict(t0=t0, metrics={"eval_s": (t_end - t0) / n},
                counters=dict(evals=n, window_s=t_end - t0,
                              ranks=len(st["procs"]) + 1),
                attempted=n, failed=0)


def release(ctx, st) -> None:
    """Stop the ranks (a last command; rank 0 leaves the group before it
    waits for them, since a rank's ``destroy_process_group`` waits for rank
    0's; a rank still there after the group's timeout is killed) and free
    rank 0's device state."""
    import torch.distributed as dist

    procs = st["procs"]
    try:
        if dist.is_initialized():
            _command(ctx.torch, st, STOP)
            dist.destroy_process_group()
        for r, p in enumerate(procs, 1):
            try:
                code = p.wait(timeout=ctx.traffic["timeout_s"])
            except subprocess.TimeoutExpired:
                code = "killed"
            if code != 0:
                log(f"rank {r} exit: {code}")
    finally:
        _kill(procs)
        atexit.unregister(_kill)
        for k, v in st["saved_env"].items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k in ("X", "y", "fid", "rows_dev", "base", "rhos", "vg"):
            st.pop(k, None)
        if ctx.device.type == "cuda":
            ctx.torch.cuda.empty_cache()


def check(ctx, st) -> dict:
    """The largest errors over the checked steps (drawn from the seed)
    against the float64 reference holding K once (``reference/gp_inplace``)
    on the run's data and each step's hyperparameters, on the run's device:
    ``nlml_rel`` |v - v_ref| / |v_ref| and ``grad_rel`` max |g - g_ref| /
    max |g_ref|."""
    torch, c = ctx.torch, ctx.config
    X, fid, y = (torch.as_tensor(a, device=ctx.device)
                 for a in tiles.build_tiles(c, ctx.seed))
    nlml_rel = grad_rel = 0.0
    for i in gen.sample(ctx.seed, len(st["outs"]),
                        ctx.traffic["check_steps"]):
        r = gp_inplace.nlml_grad(X, fid, y, ar1.theta_of(st["rows"][i], c),
                                 c["kernel"], c["jitter"])
        out = st["outs"][i]
        v_ref = float(r["value"])
        g_ref = ref.grad_vector(r).cpu().numpy()
        del r
        # np.maximum, not max: a NaN reading stays NaN and fails
        nlml_rel = float(np.maximum(nlml_rel,
                                    abs(out[0] - v_ref) / abs(v_ref)))
        grad_rel = float(np.maximum(
            grad_rel, np.max(np.abs(out[1:] - g_ref)) / np.max(np.abs(g_ref))))
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(nlml_rel=nlml_rel, grad_rel=grad_rel)
