"""``requests_per_launch``: requests served per predict launch of the
serving queue over the window (``/health``'s ``batched_requests`` and
``launches``, differenced across the window)."""


def read(run):
    n = run.counters.get("launches")
    return run.counters["batched_requests"] / n if n else None
