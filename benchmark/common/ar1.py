"""The AR1 configuration's data and hyperparameters on the device, shared by
the generators of that configuration. The inputs come from the frozen
``build_problem`` with the run's seed and go to the device once; the
program and the reference get the same arrays. Each step's
log-hyperparameters are the configuration's plus ``param_spread`` times
standard normal draws from the seed."""

from __future__ import annotations

import numpy as np

from benchmark.common import gen
from benchmark.common.problem import build_problem


def make_problem(ctx) -> dict:
    """X, fid, y, grid, grid_fid as float32 / int64 tensors on the device:
    the program's inputs, and the reference's (the same values)."""
    c = ctx.config
    X, fid, y, grid, gfid = build_problem(c["N"], c["M"], c["D"],
                                          seed=ctx.seed)
    torch, dev = ctx.torch, ctx.device
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(
        X=torch.as_tensor(X, **f32), y=torch.as_tensor(y, **f32),
        fid=torch.as_tensor(fid, dtype=torch.long, device=dev),
        grid=torch.as_tensor(grid, **f32),
        grid_fid=torch.as_tensor(gfid, dtype=torch.long, device=dev))


def split(row, F: int, D: int):
    """A log-parameter row -> (log variances, log lengthscales (F, D), log
    noises)."""
    return row[:F], row[F:F + F * D].reshape(F, D), row[F + F * D:]


def theta_of(row: np.ndarray, config: dict) -> dict:
    """The reference's hyperparameters of a log-parameter row (rhos fixed
    at the configuration's)."""
    F, D = config["F"], config["D"]
    lv, ll, ln = split(np.asarray(row, float), F, D)
    return dict(variances=np.exp(lv), lengthscales=np.exp(ll),
                rhos=np.asarray(config["theta"]["rhos"], float),
                noises=np.exp(ln))


def step_rows(ctx, n: int) -> np.ndarray:
    return gen.step_params(ctx.seed, n, ctx.config["theta"],
                           ctx.traffic["param_spread"])



def setup(ctx, step) -> dict:
    """The state of a generator that steps at fresh hyperparameters: the
    problem, every step's log-hyperparameter row (host, and device for the
    program), the fixed rhos; then ``warm_steps`` calls of ``step(st,
    row)`` at the configuration's hyperparameters."""
    from mfgp_tpu_torch.models import mfgp as mf

    torch, c = ctx.torch, ctx.config
    f32 = dict(dtype=torch.float32, device=ctx.device)
    rows = step_rows(ctx, ctx.traffic["max_steps"])
    st = dict(mf=mf, pb=make_problem(ctx), rows=rows,
              rows_dev=torch.as_tensor(rows, **f32),
              rhos=torch.as_tensor(c["theta"]["rhos"], **f32))
    base = torch.as_tensor(gen.log_theta(c["theta"]), **f32)
    for _ in range(ctx.traffic["warm_steps"]):
        step(ctx, st, base)
    return st


def params(ctx, st, row):
    """The program's ``MFGPParams`` of a device row."""
    lv, ll, ln = split(row, ctx.config["F"], ctx.config["D"])
    return st["mf"].MFGPParams(lv, ll, st["rhos"], ln)


def release(ctx, st) -> None:
    for k in ("pb", "rows_dev", "rhos"):
        st.pop(k, None)
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()
