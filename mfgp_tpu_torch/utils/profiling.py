"""Tracing and profiling (counterpart of ``mfgp_tpu/utils/profiling.py``).

The reference's observability is ad-hoc ``time.time()`` deltas printed
around planning (reference/GraceRIGV3.py:1548-1550,
reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
438-441) plus a wall-clock planner stopwatch. Here one process-wide
recorder, :data:`RECORDER` (a :class:`PhaseTimer`), takes what the port's
layers report where their work happens:

* :func:`span` — a named stretch of host time (start, end, thread, the
  enclosing span, a request id where the caller has one) and, with
  ``device=True`` on the card, the device time between two CUDA events on
  the current stream;
* :func:`count` — a counter (``graph.captures``);
* :func:`observe` — a duration measured by its own code
  (``serve.queue_wait``);
* :func:`snapshot` — per span name its calls, host, self and device
  seconds, with the counters and observations; :func:`reset` clears it;
* :func:`device_trace` — a ``torch.profiler`` scope that writes a Chrome
  trace (``trace.json``) and the recorder's snapshot (``spans.json``).

The recorder is on while a ``torch.profiler`` runs anywhere in the process,
or after :func:`enable` until ``enable(False)``. Off, :func:`span` returns
one shared no-op context and :func:`count`/:func:`observe` return at once:
no clock read, no lock, no allocation. On, a span's start and end are read
on the profiler's host clock (Unix nanoseconds), and on a thread that the
profiler records the span is also a ``record_function`` range, so it names
the host side of the device trace. A span never reads a tensor on the host
and never synchronises: its CUDA events are resolved by :func:`snapshot`.
No span goes inside a captured CUDA graph's body; one entered while its
stream captures takes no events.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from collections import defaultdict

import torch
from torch.autograd import profiler as _ap

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
CAPACITY = 1 << 17  # span records kept; later ones are counted as dropped

_NOOP = contextlib.nullcontext()
_enabled = False

if hasattr(_ap, "_is_profiler_enabled"):
    def _profiler_running() -> bool:
        """True while any torch profiler runs in the process (the flag is
        process-wide; ``_profiler_enabled()`` holds only on the threads
        the profiler records)."""
        return _ap._is_profiler_enabled
else:  # older torch: the calling thread's view
    _profiler_running = torch.autograd._profiler_enabled


class _Span:
    """One open span of a recorder (see :meth:`PhaseTimer.span`)."""

    __slots__ = ("rec", "name", "device", "rid", "rf", "id", "parent", "t0",
                 "ev0")

    def __init__(self, rec: "PhaseTimer", name: str, device: bool, rid):
        self.rec, self.name, self.device, self.rid = rec, name, device, rid
        self.rf = self.ev0 = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():  # this thread is profiled
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.t0 = time.time_ns()
        if self.device and not torch.cuda.is_current_stream_capturing():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        # the clock is read after the range's exit, as after its entry:
        # record_function runs less of its own Python after either
        # timestamp than before it, so little comes between the two clocks
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        self.rec._stack().pop()
        self.rec._add((self.name, self.t0, t1, threading.get_ident(),
                       self.id, self.parent, self.rid, self.ev0, ev1))
        return False


class PhaseTimer:
    """A thread-safe recorder of spans, counters and observations, kept in
    memory (at most ``capacity`` span records; ``dropped`` counts the
    rest). Every call records: :func:`span` and the other module functions
    record into :data:`RECORDER` only while it is on.

    >>> t = PhaseTimer()
    >>> with t.span("plan"):
    ...     ...
    >>> t.snapshot()["spans"]["plan"]["calls"]
    1
    """

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._records: list = []
        self._counters: dict = defaultdict(int)
        self._obs: dict = {}
        self.dropped = 0

    def _stack(self) -> list:
        """This thread's open span ids, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _add(self, rec: tuple) -> None:
        with self._lock:
            if len(self._records) < self.capacity:
                self._records.append(rec)
            else:
                self.dropped += 1

    def span(self, name: str, device: bool = False, rid=None) -> _Span:
        """Context manager recording one span ``name``; ``device`` adds a
        CUDA event pair on the current stream (pass it only for work on
        the card); ``rid`` ties the spans of one request together."""
        return _Span(self, name, device, rid)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            o = self._obs.get(name)
            if o is None:
                o = self._obs[name] = dict(n=0, sum_s=0.0)
            o["n"] += 1
            o["sum_s"] += seconds

    def records(self) -> list[dict]:
        """The span records in order of their end: name, start and end
        (Unix ns, the profiler's host clock), thread, id, parent id and
        request id."""
        with self._lock:
            recs = list(self._records)
        keys = ("name", "start_ns", "end_ns", "thread", "id", "parent",
                "rid")
        return [dict(zip(keys, r[:7])) for r in recs]

    def snapshot(self) -> dict:
        """``spans``: {name: {calls, host_s, self_s, device_s}}, self being
        host less the part that child spans cover and ``device_s`` None
        where no event pair was recorded; ``counters``; ``observations``:
        {name: {n, sum_s}}; ``dropped``. Waits for the spans'
        CUDA events."""
        with self._lock:
            recs = list(self._records)
            out = dict(counters=dict(self._counters),
                       observations={k: dict(v) for k, v in
                                     self._obs.items()},
                       dropped=self.dropped)
        child = defaultdict(int)
        for r in recs:
            if r[5] is not None:
                child[r[5]] += r[2] - r[1]
        spans: dict = {}
        for name, t0, t1, _, sid, _, _, ev0, ev1 in recs:
            s = spans.get(name)
            if s is None:
                s = spans[name] = dict(calls=0, host_s=0.0, self_s=0.0,
                                       device_s=None)
            s["calls"] += 1
            s["host_s"] += (t1 - t0) * 1e-9
            s["self_s"] += (t1 - t0 - child[sid]) * 1e-9
            if ev0 is not None:
                ev1.synchronize()
                s["device_s"] = ((s["device_s"] or 0.0)
                                 + ev0.elapsed_time(ev1) * 1e-3)
        out["spans"] = spans
        return out

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._counters.clear()
            self._obs.clear()
            self.dropped = 0

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)


RECORDER = PhaseTimer()

# A process's first ``record_function`` finishes its lazy set-up (torch
# 2.13 imports a module there) after its range has opened, and a garbage
# collection during that import can hold it for tens of ms: one range
# here, with no profiler running, keeps that set-up out of the first
# traced span, whose start would otherwise lag its range's.
with torch.profiler.record_function("mfgp_tpu_torch.profiling"):
    pass


def enable(on: bool = True) -> None:
    """The operator's switch: record without a profiler (until
    ``enable(False)``)."""
    global _enabled
    _enabled = bool(on)


def active() -> bool:
    """Whether the recorder records: a torch profiler runs in the process,
    or :func:`enable` is on."""
    return _enabled or _profiler_running()


def span(name: str, device: bool = False, rid=None):
    """A span of :data:`RECORDER` while it is on (see
    :meth:`PhaseTimer.span`), else one shared no-op context."""
    if not (_enabled or _profiler_running()):
        return _NOOP
    return _Span(RECORDER, name, device, rid)


def count(name: str, n: int = 1) -> None:
    if _enabled or _profiler_running():
        RECORDER.count(name, n)


def observe(name: str, seconds: float) -> None:
    if _enabled or _profiler_running():
        RECORDER.observe(name, seconds)


def snapshot() -> dict:
    return RECORDER.snapshot()


def reset() -> None:
    RECORDER.reset()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` scope: records CPU activity and, where torch has
    a CUDA device, the card's kernels, and writes a Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto) and the recorder's
    snapshot of the block to ``log_dir/spans.json`` (the recorder is reset
    at entry). Where the profiler cannot start or write, it warns and the
    block runs untraced, as the JAX package's scope does."""
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
        else:
            reset()
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
                RECORDER.dump_json(os.path.join(log_dir, SPANS_FILE))
            except (RuntimeError, OSError) as e:
                warnings.warn(f"device_trace: no trace written ({e})")
