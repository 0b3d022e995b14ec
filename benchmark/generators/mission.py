"""Generator ``mission``: whole missions back to back on one built
``sim.mission_device.DeviceMission``, as the ``mission`` command's warm
run and ``serve.MissionService`` reuse a built mission: each mission sets
the mission's seed and calls ``run()``, which returns after its one
readback. Mission k's seed is ``common/gen.mission_seed(--seed, k)``.

Set-up builds the mission at the configuration's settings and runs
``warm_missions`` missions (their seeds from another stream), which build
and capture the planner's iteration and the filter's chunks.

Traffic parameters: ``warm_missions``, ``max_missions``, ``check_missions``
(missions the reference recomputes, drawn from the seed), ``trace_seconds``,
``control_seconds``.
"""

from __future__ import annotations

import numpy as np

from benchmark.common import gen
from benchmark.common.harness import closed_loop
from benchmark.common.trace import span
from benchmark.reference import mission as ref

WARM_KEY = 1 << 40  # warm-up missions draw their seeds from here on


def _experiment(c: dict):
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    v = c["variant"]
    exp = ExperimentConfig(multi_fidelity=v.startswith("MF"),
                           ergodic=v in ("MFEGP", "SFEGP"),
                           ergodic_metric=c["ergodic_metric"],
                           info_cost=c["info_cost"],
                           update_hyps=c["update_hyps"], B=c["B"],
                           BD=c["BD"])
    ws = c["workspace"]
    got = dict(WS=[list(b) for b in exp.sim.WS], max_depth=exp.sim.max_depth,
               meas_noise=exp.sim.meas_noise)
    if got != ws:
        raise ValueError(f"the program's workspace {got} is not the "
                         f"configuration's {ws}")
    if not np.allclose(exp.sim.fidlevels, ref.fid_levels(c), rtol=1e-12):
        raise ValueError(f"the program's fidelity bins {exp.sim.fidlevels} "
                         f"are not the configuration's {ref.fid_levels(c)}")
    return exp


def setup(ctx) -> dict:
    from mfgp_tpu_torch.sim.mission_device import DeviceMission

    c = ctx.config
    mission = DeviceMission(_experiment(c), seed=0, flight=c["flight"],
                            plan_iters=c["plan_iters"], e_max=c["e_max"],
                            device=ctx.device)
    for k in range(ctx.traffic["warm_missions"]):
        mission.seed = gen.mission_seed(ctx.seed, WARM_KEY + k)
        mission.run()
    return dict(mission=mission)


def _record(res) -> dict:
    """A mission's host answers, as the reference reads them."""
    info = np.full(res.flown.shape[0], np.nan)
    for r in res.replans:
        info[r["plan_num"]] = r["info"]
    return dict(rows=res.gp_data.data, flown=res.flown, info=info,
                flown_mask=res.flown_mask,
                eids=res.eids, test_mu=res.test_mu, test_var=res.test_var,
                rmse=res.rmse, budget_used=res.budget_used, theta=res.theta,
                n_replans=res.n_replans)


def window(ctx, st, seconds: float) -> dict:
    m = st["mission"]

    def one(k):
        m.seed = gen.mission_seed(ctx.seed, k)
        with span(ctx.torch, "mission"):
            return _record(m.run())

    outs, t0, t_end = closed_loop(ctx.torch, one, seconds, 1,
                                  ctx.traffic["max_missions"])
    st["outs"] = outs
    n = len(outs)
    return dict(t0=t0, metrics={"mission_s": (t_end - t0) / n},
                counters=dict(missions=n, window_s=t_end - t0,
                              replans=sum(o["n_replans"] for o in outs)),
                attempted=n, failed=0)


def release(ctx, st) -> None:
    st.pop("mission", None)
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def check(ctx, st) -> dict:
    """The largest of each of ``reference/mission.check``'s numbers over
    the checked missions."""
    outs = st["outs"]
    worst: dict = {}
    for i in gen.sample(ctx.seed, len(outs), ctx.traffic["check_missions"]):
        for k, v in ref.check(ctx.config, outs[i], ctx.device).items():
            # np.maximum, not max: a NaN reading stays NaN and fails
            worst[k] = float(np.maximum(worst.get(k, 0.0), v))
    return worst
