"""``kernels_per_mission``: device kernel events in the traced window per
mission; a kernel replayed from a CUDA graph counts once per replay, as
CUPTI reports it."""

from benchmark.common import readers


def read(run):
    n = run.counters.get("missions")
    if not run.summary or not n:
        return None
    k = readers.kernel_events(run.summary)
    return k / n if k else None
