"""``plan_ms.mission``: device milliseconds of the program's span
``mission.plan`` (the device planner's loop, chain and points) per
``mission.run`` in the traced window (``sim/mission_device``)."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("mission.plan", per="mission.run")
