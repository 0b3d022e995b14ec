"""One run of one cell: resolve the cell's files by name, set up, run the
window, read the metrics, check the outputs against the reference, and
build the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name under ``benchmark/``:

* ``BENCHMARK.json``'s ``configs`` entry names its file (the sizes);
* ``traffic/<traffic>.json`` holds a mix's parameters, the check's limits
  and the ``generator`` that makes it (``generators/<generator>.py``);
* ``metrics/<metric>.py`` reads one per-layer metric (``read(run)``); a
  metric named ``<stem>.<part>`` without a file of its own is read by
  ``metrics/<stem>.py`` (``idle.py`` reads every ``idle.<cell kind>``).

A generator module has these functions:

* ``setup(ctx) -> state``: build the program's objects, make the data,
  warm every shape the window uses;
* ``window(ctx, state, seconds) -> dict``: the measured window, returning
  ``t0`` (its start, ``time.perf_counter``), ``metrics`` (end-to-end
  values by name), ``counters`` (what readers read), ``attempted`` and
  ``failed``;
* ``release(ctx, state)``: free the program's device state;
* ``check(ctx, state) -> dict``: the numbers compared with the plain
  reference, by the names of the traffic file's ``limits``.

The control (``run_control``) is a run of the cell one precision below
the configuration's float32 with TF32 off, over a short window, as the
traffic file's ``control`` names it: ``program_tf32`` (the default) runs
the program with its float32 products in TF32 (PyTorch's ``allow_tf32``
switch); ``reference_tf32`` puts the plain reference, its products' operands
rounded to TF32, in the program's place (the generator's steps read
``ctx.control``). Its readings are the limits' upper ones. No benchmark run
makes it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from benchmark.common import guard
from benchmark.common.trace import Trace

BENCH_DIR = "benchmark"


@dataclass
class Ctx:
    """What a generator reads: torch, the device, the cell's configuration and
    traffic, and the run's seed."""
    torch: object
    device: object
    config: dict
    traffic: dict
    seed: int
    control: str = ""


@dataclass
class Run:
    """What a per-layer reader reads: the window's counters and, in a
    traced run, the trace's summary."""
    config: dict
    counters: dict
    summary: dict | None = None


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file: cells' pieces are found by path."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r}")


def resolve(root: Path, bench: dict, cell_name: str) -> dict:
    """The cell and everything it names: config, traffic, generator module,
    end-to-end and per-layer metric entries and their readers."""
    root = Path(root)
    cell = find(bench["workloads"], cell_name, "workload")
    cfg_entry = find(bench["configs"], cell["config"], "config")
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(root / BENCH_DIR / "traffic"
                        / f"{cell['traffic']}.json")
    name = traffic["generator"]
    generator = load_module(root / BENCH_DIR / "generators" / f"{name}.py",
                            f"bench_generator_{name}")
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell_name in m.get("workloads", [cell_name])
             and m["moves"] in names]
    readers = {m["name"]: load_module(
        reader_path(root, m["name"]),
        "bench_metric_" + m["name"].replace(".", "_"))
        for m in layer}
    return dict(cell=cell, config=config, traffic=traffic,
                generator=generator, e2e=e2e, layer=layer, readers=readers)


def reader_path(root: Path, metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else
    that of its stem before the first dot."""
    d = Path(root) / BENCH_DIR / "metrics"
    own = d / f"{metric}.py"
    return own if own.is_file() else d / f"{metric.split('.')[0]}.py"


def closed_loop(torch, step, seconds: float, min_steps: int,
                max_steps: int) -> tuple:
    """One caller's closed loop: ``step(i)`` for i = 0, 1, ... until
    ``seconds`` have passed and at least ``min_steps`` steps are done.
    Returns (the steps' outputs, the window's start, the last step's end);
    a step started inside the window is waited for."""
    outs = []
    t0 = time.perf_counter()
    t_end = t0
    while len(outs) < max(min_steps, 1) or t_end - t0 < seconds:
        if len(outs) >= max_steps:
            raise RuntimeError(f"more than max_steps={max_steps} steps in "
                               "the window")
        with torch.profiler.record_function("bench.step"):
            outs.append(step(len(outs)))
        t_end = time.perf_counter()
    return outs, t0, t_end


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at most its limit, and every limit has its number."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v if v is None or math.isfinite(v)
                        else str(v), "limit": limit}
    return ok, checks


def device_info(torch, device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(d)
                    for d in range(chips)))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def run_cell(root, bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float | None = None,
             config: dict | None = None, traffic: dict | None = None,
             control: str = "") -> dict:
    """One run; returns the result object (the last line of a run).
    ``config``/``traffic`` replace the cell's files (the CPU tests run a
    cell at a small size this way); ``control`` is set by
    ``run_control``."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    r = resolve(root, bench, cell_name)
    ctx = Ctx(torch=torch, device=device, config=config or r["config"],
              traffic=traffic or r["traffic"], seed=int(seed),
              control=control)
    drv = r["generator"]
    st = drv.setup(ctx)
    summary = None
    if trace:
        secs = min(float(seconds), float(ctx.traffic.get("trace_seconds",
                                                         seconds)))
        with Trace(torch, device) as tr:
            out = drv.window(ctx, st, secs)
        summary = tr.summary
    else:
        out = drv.window(ctx, st, float(seconds))
    dev = device_info(torch, device, int(r["cell"]["chips"]))
    drv.release(ctx, st)
    values = drv.check(ctx, st)
    correct, checks = judge(values, ctx.traffic["limits"])
    correct = correct and out["failed"] == 0
    metrics = {}
    if trace:
        run = Run(ctx.config, out["counters"], summary)
        for m in r["layer"]:
            v = r["readers"][m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    else:
        for m in r["e2e"]:
            if m["name"] == "setup_s":
                v = out["t0"] - t_start
            else:
                v = out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    res = {"correct": bool(correct), "attempted": int(out["attempted"]),
           "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace:
        res["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    res["checks"] = checks
    return res


def run_control(root, bench: dict, cell_name: str, seed: int, device,
                **kw) -> dict:
    """The control's run of a cell (the traffic's ``control``, see above)
    over the traffic's ``control_seconds``; ``kw`` as ``run_cell``'s."""
    import torch

    import mfgp_tpu_torch.ops  # noqa: F401  (its import switches TF32 off)

    r = resolve(root, bench, cell_name)
    traffic = kw.get("traffic") or r["traffic"]
    kind = traffic.get("control", "program_tf32")
    seconds = float(traffic.get("control_seconds", 0.0))
    if kind == "reference_tf32":
        res = run_cell(root, bench, cell_name, seed, seconds, False, device,
                       control=kind, **kw)
    elif kind == "program_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            res = run_cell(root, bench, cell_name, seed, seconds, False,
                           device, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    else:
        raise ValueError(f"unknown control {kind!r}")
    res["control"] = kind
    return res


def imports_ok() -> bool:
    """The import guard over this process's modules; names what it found
    on standard error."""
    bad = guard.forbidden(list(sys.modules))
    if bad:
        log("forbidden modules loaded: " + ", ".join(bad))
    return not bad
