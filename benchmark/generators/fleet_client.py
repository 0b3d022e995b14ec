"""The fleet's clients, in a process of their own (as gliders are not in
the server's process): ``clients`` threads posting ``/predict``
(``common/gen.fleet_request``) to the server at ``--port`` in lockstep
rounds: in each round every client sends its request at once, and the
next round starts when every reply of this one is parsed.

Started by ``generators/fleet.py`` in set-up, it imports only numpy and the
generators (the grid is the run's problem's, made again from the seed),
prints ``ready`` and waits for a line ``go <seconds>`` on its
standard input. Then it starts rounds until ``seconds`` have passed and
waits for the last round's replies, and the process writes one ``.npz``
to its standard output: per request the client, its round, its size (0
for the grid), its latency (NaN where it failed), and the replies' means
and variances end to end (``offsets`` delimit them).
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from benchmark.common import gen  # noqa: E402
from benchmark.common.problem import build_problem  # noqa: E402

HOST = "127.0.0.1"


def body(points) -> bytes:
    return json.dumps({"points": np.asarray(points).tolist(),
                       "include_noise": True}).encode()


def post(port: int, data: bytes, timeout: float) -> dict:
    conn = http.client.HTTPConnection(HOST, port, timeout=timeout)
    try:
        conn.request("POST", "/predict", data,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {raw[:200]!r}")
        return json.loads(raw)
    finally:
        conn.close()


def client(a, mix, k: int, grid_body: bytes, rounds: dict, rec: list):
    """Client ``k``: one request per round, between the round's start and
    end barriers, until the round number is None."""
    while True:
        rounds["start"].wait()
        i = rounds["i"]
        if i is None:
            return
        pts = gen.fleet_request(a.seed, mix, k, i, a.config["box"])
        data = grid_body if pts is None else body(pts)
        n = 0 if pts is None else pts.shape[0]
        t = time.perf_counter()
        try:
            out = post(a.port, data, mix["timeout_s"])
            lat = time.perf_counter() - t
            rec.append((k, i, n, lat, np.asarray(out["mean"], float),
                        np.asarray(out["var"], float)))
        except (OSError, ValueError, KeyError, RuntimeError,
                http.client.HTTPException):
            rec.append((k, i, n, float("nan"), np.zeros(0), np.zeros(0)))
        rounds["end"].wait()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--mix", type=json.loads, required=True)
    p.add_argument("--config", type=json.loads, required=True)
    a = p.parse_args()
    mix, c = a.mix, a.config
    # the grid the model serves: the run's problem's, made again here
    grid_body = body(build_problem(c["N"], c["M"], c["D"], seed=a.seed)[3])
    print("ready", flush=True)
    cmd = sys.stdin.readline().split()
    seconds = float(cmd[1])
    n = mix["clients"]
    recs = [[] for _ in range(n)]
    rounds = dict(i=0, start=threading.Barrier(n + 1),
                  end=threading.Barrier(n + 1))
    threads = [threading.Thread(target=client,
                                args=(a, mix, k, grid_body, rounds, recs[k]))
               for k in range(n)]
    for th in threads:
        th.start()
    t_stop = time.perf_counter() + seconds
    i = 0
    while i == 0 or time.perf_counter() < t_stop:
        rounds["i"] = i
        rounds["start"].wait()
        rounds["end"].wait()
        i += 1
    rounds["i"] = None
    rounds["start"].wait()
    for th in threads:
        th.join()
    flat = [r for rs in recs for r in rs]
    sizes = [len(r[4]) for r in flat]
    buf = io.BytesIO()
    np.savez(buf, client=np.array([r[0] for r in flat]),
             index=np.array([r[1] for r in flat]),
             n=np.array([r[2] for r in flat]),
             latency=np.array([r[3] for r in flat], float),
             offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
             mean=np.concatenate([r[4] for r in flat] or [np.zeros(0)]),
             var=np.concatenate([r[5] for r in flat] or [np.zeros(0)]))
    sys.stdout.buffer.write(buf.getvalue())
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
