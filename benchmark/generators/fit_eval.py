"""Generator ``fit_eval``: one closed-loop caller making the evaluation of a
restart fit. Each step is one ``models.mfgp.nlml_value_and_grad`` (the
program's ``inv_mode=None`` path: K^-1 by blocked triangular solves, the
gradient from K^-1) at log-hyperparameters drawn for that step from the
seed (``common/ar1``), and one readback of the value and the gradient, as
the optimizer reads them.

Traffic parameters: ``param_spread``, ``max_steps``, ``warm_steps``,
``check_steps`` (steps the reference recomputes), ``trace_seconds``,
``control`` (``reference_tf32``: the control's steps are the plain
reference with TF32 operands, ``reference/gp.nlml_grad_tf32``, in the
program's place).
"""

from __future__ import annotations

import numpy as np

from benchmark.common import ar1, gen
from benchmark.common.harness import closed_loop
from benchmark.common.trace import span
from benchmark.reference import gp as ref


def _evaluate(ctx, st, row) -> np.ndarray:
    """One evaluation; [value, gradient (log variances, log lengthscales,
    log noises)] on the host."""
    torch, pb = ctx.torch, st["pb"]
    if ctx.control == "reference_tf32":
        c = ctx.config
        r = ref.nlml_grad_tf32(pb["X"], pb["fid"], pb["y"],
                               ar1.theta_of(row.cpu().numpy(), c),
                               c["kernel"], c["jitter"])
        return torch.cat([r["value"].reshape(1), ref.grad_vector(r)]
                         ).double().cpu().numpy()
    with span(torch, "nlml_value_and_grad"):
        v, g = st["mf"].nlml_value_and_grad(
            ar1.params(ctx, st, row), pb["X"], pb["fid"], pb["y"],
            kernel=ctx.config["kernel"], jitter=ctx.config["jitter"])
    with span(torch, "readback"):
        return torch.cat([v.reshape(1), g.log_variances,
                          g.log_lengthscales.reshape(-1),
                          g.log_noises]).double().cpu().numpy()


def setup(ctx) -> dict:
    return ar1.setup(ctx, _evaluate)


def window(ctx, st, seconds: float) -> dict:
    outs, t0, t_end = closed_loop(
        ctx.torch, lambda i: _evaluate(ctx, st, st["rows_dev"][i]), seconds,
        ctx.traffic["check_steps"], ctx.traffic["max_steps"])
    st["outs"] = outs
    n = len(outs)
    return dict(t0=t0, metrics={"eval_s": (t_end - t0) / n},
                counters=dict(evals=n, window_s=t_end - t0),
                attempted=n, failed=0)


release = ar1.release


def check(ctx, st) -> dict:
    """The largest errors over the checked steps (drawn from the seed)
    against the float64 reference on the run's data and each step's
    hyperparameters: ``nlml_rel`` |v - v_ref| / |v_ref| and ``grad_rel``
    max |g - g_ref| / max |g_ref|."""
    c = ctx.config
    pb = ar1.make_problem(ctx)
    nlml_rel = grad_rel = 0.0
    for i in gen.sample(ctx.seed, len(st["outs"]),
                        ctx.traffic["check_steps"]):
        r = ref.nlml_grad(pb["X"], pb["fid"], pb["y"],
                          ar1.theta_of(st["rows"][i], c), c["kernel"],
                          c["jitter"])
        out = st["outs"][i]
        v_ref = float(r["value"])
        g_ref = ref.grad_vector(r).cpu().numpy()
        # np.maximum, not max: a NaN reading stays NaN and fails
        nlml_rel = float(np.maximum(nlml_rel,
                                    abs(out[0] - v_ref) / abs(v_ref)))
        grad_rel = float(np.maximum(
            grad_rel, np.max(np.abs(out[1:] - g_ref)) / np.max(np.abs(g_ref))))
        del r
    return dict(nlml_rel=nlml_rel, grad_rel=grad_rel)
