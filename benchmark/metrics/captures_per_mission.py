"""``captures_per_mission``: the program's counter ``graph.captures`` (one
per CUDA graph captured by the planner, the runtime or the filter) per
``mission.run`` in the traced window; 0 where no graph was captured."""

from benchmark.common import spans


def read(run):
    return spans.counted_per("graph.captures", per="mission.run")
