"""The multi-process sweep (counterpart of
``mfgp_tpu/parallel/sweep.py``).

The reference's 88-run study is a serial loop over dataset files
(reference/GPTrainers.py:26). The runs are independent, so the natural
multi-host axis is the task list, not the model: each process takes a
deterministic shard of the tasks and runs them on its own device; nothing
is communicated beyond the artifacts on the shared filesystem. Resuming
comes from the harness's output-existence skip, so a preempted process
just rejoins.

Where no process group is initialised the sweep is the serial loop
(optionally split across local worker subprocesses for CPU-bound stages).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Callable, Sequence

from mfgp_tpu_torch.utils.device import CUDA


def _topology() -> tuple:
    """(rank, world size) of the initialised ``torch.distributed`` group,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard(tasks: Sequence, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """Deterministic round-robin shard of ``tasks`` for this process: the
    ``torch.distributed`` rank and world size when a process group is
    initialised, the whole list otherwise."""
    if process_index is None or process_count is None:
        process_index, process_count = _topology()
    return [t for i, t in enumerate(tasks)
            if i % process_count == process_index]


def run_sweep(tasks: Sequence, worker: Callable, *,
              process_index: int | None = None,
              process_count: int | None = None,
              on_error: str = "continue") -> dict:
    """Run this process's shard of ``tasks`` through ``worker(task)``.

    Returns {task: result} for completed tasks; failures are recorded as
    the exception (on_error="continue") or re-raised (on_error="raise").
    """
    results = {}
    for t in process_shard(tasks, process_index, process_count):
        try:
            results[t] = worker(t)
        except Exception as e:  # noqa: BLE001 (sweep isolation by design)
            if on_error == "raise":
                raise
            results[t] = e
    return results


def trainer_sweep(gpdata_dir: str, field_dir: str, out_dir: str,
                  cfg=None, kernel: str = "rbf", resume: bool = True,
                  optimize: bool = True,
                  process_index: int | None = None,
                  process_count: int | None = None, device=CUDA) -> dict:
    """The GPTrainers sweep, sharded over processes
    (reference/GPTrainers.py:26-170).

    Every process handles its shard of ``GPData_*.csv``; the
    output-existence resume makes re-runs and joins idempotent. Task
    resolution is the serial sweep's (``data.trainers.dataset_task``); the
    fits run on ``device``, the card unless the caller asks for the CPU."""
    from mfgp_tpu_torch.data.trainers import dataset_task, process_dataset

    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(gpdata_dir) if f.endswith(".csv"))

    def worker(fname):
        done, gpdata_path, settings = dataset_task(
            fname, gpdata_dir, field_dir, out_dir, resume)
        if done:
            return "skipped"
        _, metrics = process_dataset(gpdata_path, settings, out_dir, cfg,
                                     kernel=kernel, optimize=optimize,
                                     device=device)
        return metrics

    return run_sweep(files, worker, process_index=process_index,
                     process_count=process_count)


def spawn_local_workers(script_args: Sequence[str], n_workers: int) -> int:
    """Split a sweep across local subprocesses by passing their index and
    count through the environment (MFGP_SWEEP_INDEX / MFGP_SWEEP_COUNT).
    Returns the number of failures."""
    procs = []
    for i in range(n_workers):
        env = dict(os.environ,
                   MFGP_SWEEP_INDEX=str(i), MFGP_SWEEP_COUNT=str(n_workers))
        procs.append(subprocess.Popen([sys.executable, *script_args],
                                      env=env))
    return sum(p.wait() != 0 for p in procs)


def env_shard() -> tuple:
    """(index, count) from the spawn_local_workers environment, or the
    ``torch.distributed`` topology, or (0, 1)."""
    if "MFGP_SWEEP_INDEX" in os.environ:
        return (int(os.environ["MFGP_SWEEP_INDEX"]),
                int(os.environ["MFGP_SWEEP_COUNT"]))
    return _topology()
