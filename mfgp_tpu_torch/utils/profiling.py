"""Tracing and profiling (counterpart of ``mfgp_tpu/utils/profiling.py``).

The reference's observability is ad-hoc ``time.time()`` deltas printed
around planning (reference/GraceRIGV3.py:1548-1550,
reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
438-441) plus a wall-clock planner stopwatch. Here:

* :class:`PhaseTimer` — structured named-phase wall-clock accumulation with
  JSON/CSV export, usable as a context manager per phase;
* :func:`device_trace` — a ``torch.profiler`` scope that writes a Chrome
  trace (CPU activity, and the card's kernels where there is one);
* :func:`timed` — decorator recording per-call durations into a timer.

``PhaseTimer`` and ``timed`` are plain Python, copied from the JAX package.
A host clock around asynchronous CUDA work measures its enqueue: time a
phase that ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from functools import wraps
from typing import Dict, List


@dataclass
class PhaseTimer:
    """Accumulate wall-clock by phase name.

    >>> t = PhaseTimer()
    >>> with t("plan"):
    ...     ...
    >>> t.summary()["plan"]["total_s"]
    """

    totals: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    history: List[tuple] = field(default_factory=list)
    keep_history: bool = False

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[phase] += dt
            self.counts[phase] += 1
            if self.keep_history:
                self.history.append((phase, t0, dt))

    def summary(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)

    def dump_csv(self, path: str):
        with open(path, "w") as f:
            f.write("phase,total_s,calls,mean_s\n")
            for k, v in self.summary().items():
                f.write(f"{k},{v['total_s']},{v['calls']},{v['mean_s']}\n")

    def report(self) -> str:
        lines = [f"{k:24s} {v['total_s']:9.3f}s  x{v['calls']:<5d} "
                 f"({v['mean_s'] * 1e3:8.2f} ms/call)"
                 for k, v in self.summary().items()]
        return "\n".join(lines)


def timed(timer: PhaseTimer, phase: str | None = None):
    """Decorator: record each call's duration under ``phase`` (defaults to
    the function name)."""

    def deco(fn):
        name = phase or fn.__name__

        @wraps(fn)
        def wrapper(*a, **kw):
            with timer(name):
                return fn(*a, **kw)

        return wrapper

    return deco


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` scope: records CPU activity and, where torch has
    a CUDA device, the card's kernels, and writes a Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto). Where the
    profiler cannot start or write, it warns and the block runs untraced,
    as the JAX package's scope does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    if torch.autograd._profiler_enabled():
        # a second profiler inside a running one crashes the process
        warnings.warn("device_trace: the profiler did not start (another "
                      "one is running)")
    else:
        prof = profile(activities=activities)
        try:
            prof.__enter__()
        except RuntimeError as e:  # no profiler backend
            warnings.warn(f"device_trace: the profiler did not start ({e})")
            prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
            except (RuntimeError, OSError) as e:
                warnings.warn(f"device_trace: no trace written ({e})")
