"""The program's own recorder (``mfgp_tpu_torch.utils.profiling``), read in
the run's process after the traced window. The recorder records only while
a profiler runs, so it holds the traced window alone, never set-up's warm
calls. Each function returns None where the program has no recorder, or
the recorder holds nothing for it."""

from __future__ import annotations


def snapshot() -> dict | None:
    try:
        from mfgp_tpu_torch.utils import profiling

        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


def _span(snap, name: str):
    s = (snap or {}).get("spans", {}).get(name)
    return s if s and s["calls"] else None


def device_ms(name: str, per: str | None = None):
    """Device milliseconds of span ``name`` per call of span ``per``
    (``name`` itself by default); None without device time."""
    snap = snapshot()
    s, p = _span(snap, name), _span(snap, per or name)
    if s is None or p is None or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / p["calls"]


def host_ms(names, per: str):
    """Host milliseconds of the spans ``names`` summed, per call of span
    ``per``."""
    snap = snapshot()
    got = [_span(snap, n) for n in names]
    p = _span(snap, per)
    if p is None or any(s is None for s in got):
        return None
    return 1e3 * sum(s["host_s"] for s in got) / p["calls"]


def observed_ms(name: str):
    """Mean milliseconds of the observation ``name``."""
    snap = snapshot()
    o = (snap or {}).get("observations", {}).get(name)
    return 1e3 * o["sum_s"] / o["n"] if o and o["n"] else None


def counted_per(counter: str, per: str):
    """The counter ``counter`` per call of span ``per`` (0 where the span
    was recorded and the counter never was)."""
    snap = snapshot()
    p = _span(snap, per)
    if p is None:
        return None
    return snap.get("counters", {}).get(counter, 0) / p["calls"]
