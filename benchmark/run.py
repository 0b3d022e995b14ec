"""Benchmark of ``mfgp_tpu_torch`` (the PyTorch/CUDA port) on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit (also the last lines of standard error).

``--control 1`` prints instead the readings of the cell's control, one
precision below the configuration's float32 with TF32 off, as the cell's
traffic file names it (``harness.run_control``): the program with its
float32 products in TF32, or the plain reference with TF32 operands in the
program's place. The limits' upper readings were taken so.

The run exits non-zero, and prints no result, without as many CUDA
devices as the cell asks for, or when a module of JAX or of the JAX
package is loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (from
    ``/proc``; this call's time where that is not readable)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # caches at fixed paths inside the checkout (the port's own kernel
    # build already lives at mfgp_tpu_torch/ops/.kernel_build)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    from benchmark.common import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.find(bench["workloads"], args.workload, "workload")
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    if args.control:
        res = harness.run_control(ROOT, bench, args.workload, args.seed,
                                  device)
    else:
        res = harness.run_cell(ROOT, bench, args.workload, args.seed,
                               args.seconds, bool(args.trace), device,
                               t_start=T_START)
    if not harness.imports_ok():
        return 3
    for name, c in res["checks"].items():
        harness.log(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
