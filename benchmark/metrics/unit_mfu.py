"""``unit_mfu``: a unit's N^3 + N^2 M operations over its wall time in the
traced window, as a share of the 3xTF32 peak (``common/counts``)."""

from benchmark.common import counts, readers


def read(run):
    c = run.config
    t = readers.per(run, "units", run.counters.get("window_s", 0.0))
    return counts.mfu_pct(counts.unit_ops(c["N"], c["M"]), t) if t else None
