"""``eval_mfu``: an evaluation's N^3 operations over its wall time in the
traced window, as a share of the 3xTF32 peak (``common/counts``)."""

from benchmark.common import counts, readers


def read(run):
    t = readers.per(run, "evals", run.counters.get("window_s", 0.0))
    return counts.mfu_pct(counts.eval_ops(run.config["N"]), t) if t else None
