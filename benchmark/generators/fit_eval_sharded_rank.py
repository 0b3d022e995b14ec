"""Rank r > 0 of the ``fit_eval_sharded`` generator, started by rank 0 (the
run's process) with the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and one argument, the
JSON of the run's configuration, traffic, seed, backend and TF32 switch:

    python3 benchmark/generators/fit_eval_sharded_rank.py '<json>'

It evaluates as rank 0 commands (``fit_eval_sharded.follow``) and exits
when rank 0 says stop, or when rank 0's process is gone.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _exit_without(ppid: int) -> None:
    """Exit the process once its parent (rank 0) is gone."""
    while os.getppid() == ppid:
        time.sleep(1.0)
    os._exit(3)


def main() -> None:
    args = json.loads(sys.argv[1])
    threading.Thread(target=_exit_without, args=(os.getppid(),),
                     daemon=True).start()
    sys.path.insert(0, str(HERE.parents[1]))
    from benchmark.common.harness import load_module

    load_module(HERE / "fit_eval_sharded.py",
                "bench_generator_fit_eval_sharded").follow(args)


if __name__ == "__main__":
    main()
