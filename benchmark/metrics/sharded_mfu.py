"""``sharded_mfu``: a fully sharded evaluation's N^3 operations
(``counts.eval_ops``, the yardstick of ``eval_mfu``) over its wall time in
the traced window, as a share of the 3xTF32 peak of all the cell's ranks
(``counts``: 495/3 TFLOP/s a card)."""

from benchmark.common import counts, readers


def read(run):
    t = readers.per(run, "evals", run.counters.get("window_s", 0.0))
    ranks = run.counters.get("ranks")
    if not t or not ranks:
        return None
    return counts.mfu_pct(counts.eval_ops(run.config["N"]), t) / ranks
