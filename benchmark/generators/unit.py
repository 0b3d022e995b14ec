"""Generator ``unit``: one closed-loop caller making the repository's unit.
Each step is ``models.mfgp.nlml_value_grad_state_inv`` (the NLML, the
gradient through B2 and the state, from the inverse factor Linv) and then
``models.mfgp.predict_fused`` over the grid (B3), at log-hyperparameters
drawn for that step from the seed (``common/ar1``), and one readback of
the value and the gradient after both are enqueued.

Traffic parameters: ``param_spread``, ``max_steps``, ``warm_steps``,
``check_steps``, ``trace_seconds`` (as ``fit_eval``).
"""

from __future__ import annotations

import numpy as np

from benchmark.common import ar1, gen
from benchmark.common.harness import closed_loop
from benchmark.common.trace import span
from benchmark.reference import gp as ref


def _unit(ctx, st, row):
    """One unit: ([value, gradient] on the host, mean and variance on the
    device)."""
    torch, mf, pb = ctx.torch, st["mf"], st["pb"]
    p = ar1.params(ctx, st, row)
    kern = ctx.config["kernel"]
    with span(torch, "nlml_value_grad_state_inv"):
        v, g, state = mf.nlml_value_grad_state_inv(
            p, pb["X"], pb["fid"], pb["y"], kernel=kern,
            jitter=ctx.config["jitter"])
    with span(torch, "predict_fused"):
        mu, var = mf.predict_fused(p, state, pb["grid"], pb["grid_fid"],
                                   kernel=kern)
    del state
    with span(torch, "readback"):
        host = torch.cat([v.reshape(1), g.log_variances,
                          g.log_lengthscales.reshape(-1),
                          g.log_noises]).double().cpu().numpy()
    return host, mu, var


def setup(ctx) -> dict:
    return ar1.setup(ctx, _unit)


def window(ctx, st, seconds: float) -> dict:
    outs, t0, t_end = closed_loop(
        ctx.torch, lambda i: _unit(ctx, st, st["rows_dev"][i]), seconds,
        ctx.traffic["check_steps"], ctx.traffic["max_steps"])
    n = len(outs)
    # only the checked steps' device outputs are kept
    keep = set(gen.sample(ctx.seed, n, ctx.traffic["check_steps"]))
    st["outs"] = [o if i in keep else (o[0], None, None)
                  for i, o in enumerate(outs)]
    return dict(t0=t0, metrics={"unit_s": (t_end - t0) / n},
                counters=dict(units=n, window_s=t_end - t0),
                attempted=n, failed=0)


release = ar1.release


def check(ctx, st) -> dict:
    """The largest errors over the checked steps (drawn from the seed)
    against the float64 reference on the run's data and each step's
    hyperparameters: ``nlml_rel`` |v - v_ref| / |v_ref|; ``grad_rel``,
    ``mean_rel`` and ``var_rel`` max |x - x_ref| / max |x_ref|."""
    c = ctx.config
    pb = ar1.make_problem(ctx)
    X, fid = pb["X"], pb["fid"]
    err = dict(nlml_rel=0.0, grad_rel=0.0, mean_rel=0.0, var_rel=0.0)
    for i in gen.sample(ctx.seed, len(st["outs"]),
                        ctx.traffic["check_steps"]):
        th = ar1.theta_of(st["rows"][i], c)
        r = ref.nlml_grad(X, fid, pb["y"], th, c["kernel"], c["jitter"],
                          keep_L=True)
        mu_ref, var_ref = ref.predict(r["L"], r["alpha"], X, fid, th,
                                      c["kernel"], pb["grid"],
                                      pb["grid_fid"])
        host, mu, var = st["outs"][i]
        v_ref = float(r["value"])
        g_ref = ref.grad_vector(r).cpu().numpy()
        new = dict(
            nlml_rel=abs(host[0] - v_ref) / abs(v_ref),
            grad_rel=float(np.max(np.abs(host[1:] - g_ref))
                           / np.max(np.abs(g_ref))),
            mean_rel=ref.rel_err(mu, mu_ref),
            var_rel=ref.rel_err(var, var_ref))
        # np.maximum, not max: a NaN reading stays NaN and fails
        err = {k: float(np.maximum(err[k], new[k])) for k in err}
        del r
    return err
