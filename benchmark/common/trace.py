"""The traced run: ``torch.profiler`` over one window, reduced in memory to
what the per-layer readers and the result's ``breakdown`` need.

The window is the harness's ``bench.window`` span. Device time is the union
of every device activity (kernels, copies, fills) inside it; a kernel run
from a replayed CUDA graph is one event per kernel, as CUPTI reports it.
An idle gap is a stretch of the window in which no device activity ran; it
is named after what the host was doing at its middle: the innermost host
event (a harness span ``bench.*`` or an operator) that covers that instant,
on any thread.

The profiler's own event objects are read through ``kineto_results``
(start, end, name, device), which is far cheaper than building
``FunctionEvent`` trees for the hundreds of thousands of kernels a mission
launches.
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict

WINDOW = "bench.window"
TOP = 10


def span(torch, name: str):
    """A harness span ``bench.<name>`` around a call into a layer; it shows
    in the traced run's host events and costs a few microseconds
    otherwise."""
    return torch.profiler.record_function(f"bench.{name}")


class Trace:
    """Profile the block it wraps as one traced window. After the block,
    ``summary`` holds the reduction (see ``summarize``)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.summary = None
        self._stack = None

    def __enter__(self):
        tp = self.torch.profiler
        acts = [tp.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(tp.ProfilerActivity.CUDA)
            self.torch.cuda.synchronize(self.device)
        self._prof = tp.profile(activities=acts)
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._prof)
        self._stack.enter_context(span(self.torch, "window"))
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self._stack.close()
        if exc[0] is None:
            self.summary = summarize(
                self._prof.profiler.kineto_results.events())
        return False


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host):
    """Name each gap (start, end) after the innermost host event covering
    its middle: a sweep over the host events in order of start."""
    host = sorted(host)  # (start, end, name)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    active: list = []  # heap of (-start, end, name)
    labels = [None] * len(gaps)
    j = 0
    for i in order:
        mid = 0.5 * (gaps[i][0] + gaps[i][1])
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        # the innermost still-open event: latest start whose end is past
        while active and active[0][1] < mid:
            heapq.heappop(active)
        labels[i] = active[0][2] if active else "(no host event)"
    return labels


def summarize(events) -> dict:
    """Reduce profiler events to: ``window_s`` (the traced window),
    ``busy_s`` (union of device activity inside it), ``n_device_events``,
    ``by_name`` ({name: [seconds, count]} of device activity),
    ``device_ops`` and ``idle_gaps`` (the ten largest, [name, seconds])."""
    w0 = w1 = None
    host, dev = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if e.device_type().name != "CPU" and (
                e.is_user_annotation() or e.name().startswith("bench.")):
            continue  # a host span's shadow on the device's timeline
        if e.device_type().name == "CPU":
            name = e.name()
            if name == WINDOW:
                w0, w1 = s, t
            else:
                host.append((s, t, name))
        else:
            dev.append((s, t, e.name()))
    if w0 is None:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    by_name = defaultdict(lambda: [0.0, 0])
    clipped = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        clipped.append((s, t))
        by_name[name][0] += (t - s) * 1e-9
        by_name[name][1] += 1
    merged = _union(clipped)
    busy = sum(t - s for s, t in merged) * 1e-9
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gap_by = defaultdict(float)
    for (s, t), label in zip(gaps, _label_gaps(gaps, host)):
        gap_by[label] += (t - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return dict(
        window_s=(w1 - w0) * 1e-9, busy_s=busy,
        n_device_events=sum(c for _, c in by_name.values()),
        by_name={k: list(v) for k, v in by_name.items()},
        device_ops=[[k[:160], v[0]] for k, v in ops],
        idle_gaps=[[k[:160], v] for k, v in sorted(
            gap_by.items(), key=lambda kv: -kv[1])[:TOP]])


def device_seconds(summary: dict, *needles: str, exclude=()) -> tuple:
    """(seconds, count) of the device activity whose name holds any of
    ``needles`` (case-insensitive) and none of ``exclude``."""
    s, n = 0.0, 0
    for name, (sec, cnt) in summary["by_name"].items():
        low = name.lower()
        if any(x in low for x in needles) and not any(
                x in low for x in exclude):
            s += sec
            n += cnt
    return s, n
