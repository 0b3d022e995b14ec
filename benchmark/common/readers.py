"""Arithmetic the per-layer readers share. A reader returns None where its
run has nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations


def idle_pct(run):
    """The device's idle share of the traced window, percent."""
    s = run.summary
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def per(run, count_key: str, seconds: float):
    """``seconds`` per unit of the counter ``count_key``."""
    n = run.counters.get(count_key)
    if not n:
        return None
    return seconds / n


def kernel_events(summary) -> int:
    """Device kernel events (copies and fills left out)."""
    return sum(c for name, (_, c) in summary["by_name"].items()
               if not name.startswith(("Memcpy", "Memset")))
