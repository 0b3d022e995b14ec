"""``replans_per_mission``: ``MissionResult.n_replans`` averaged over the
window's missions (a count of work, not a speed)."""


def read(run):
    n = run.counters.get("missions")
    return run.counters["replans"] / n if n else None
