"""Generator ``fleet``: a fleet of clients posting ``/predict`` over HTTP
to ``serve.make_http_server(serve.ModelServer(MFGP))``, served from this
process on 127.0.0.1 at an ephemeral port; the clients run in a process of
their own (``fleet_client.py``), started in set-up. The model is the
configuration's AR1 MFGP, conditioned once in set-up.

The clients post in lockstep rounds, as gliders that replan together: in
each round every client sends one request at once and waits for its
reply, and the next round starts when every reply is parsed (no think
time). Each round holds ``grid_per_round`` requests for the whole grid and
one each of the sizes ``common/gen.fleet_sizes`` takes from the log-uniform
law on [``min_points``, ``max_points``], points uniform in the box, all
with ``include_noise``; which client asks what, and the points, come from
the seed. A request's latency runs from its send to its parsed reply; one
that fails counts as missing (``stats.latency_p95``).

Traffic parameters: ``clients``, ``grid_per_round``, ``min_points``,
``max_points``, ``check_requests`` (small requests the reference
recomputes; every grid reply is checked), ``timeout_s`` (a request's
longest wait), ``trace_seconds``, ``control_seconds``.
"""

from __future__ import annotations

import http.client
import io
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from benchmark.common import ar1, gen, stats
from benchmark.common.harness import load_module
from benchmark.common.trace import span
from benchmark.reference import gp as ref

HOST = "127.0.0.1"
CLIENT = Path(__file__).resolve().parent / "fleet_client.py"


def _health(port: int) -> dict:
    conn = http.client.HTTPConnection(HOST, port, timeout=30)
    try:
        conn.request("GET", "/health")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def setup(ctx) -> dict:
    from mfgp_tpu_torch import serve
    from mfgp_tpu_torch.models import mfgp as mf

    torch, c = ctx.torch, ctx.config
    pb = ar1.make_problem(ctx)
    lv, ll, ln = ar1.split(gen.log_theta(c["theta"]), c["F"], c["D"])
    f32 = dict(dtype=torch.float32, device=ctx.device)
    params = mf.MFGPParams(torch.as_tensor(lv, **f32),
                           torch.as_tensor(ll, **f32),
                           torch.as_tensor(c["theta"]["rhos"], **f32),
                           torch.as_tensor(ln, **f32))
    model = mf.MFGP(pb["X"], pb["fid"], pb["y"], n_fidelities=c["F"],
                    kernel=c["kernel"], params=params, jitter=c["jitter"],
                    device=ctx.device)
    server = serve.ModelServer(model)  # conditions the model (a predict)
    httpd = serve.make_http_server(server, HOST, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    grid = pb["grid"].cpu().numpy()
    st = dict(server=server, httpd=httpd, thread=thread,
              port=httpd.server_address[1], grid=grid)
    # warm the served path: a grid request and a small one
    client = load_module(CLIENT, "bench_fleet_client")
    t = ctx.traffic["timeout_s"]
    client.post(st["port"], client.body(grid), t)
    client.post(st["port"], client.body(grid[:ctx.traffic["min_points"]]), t)
    keys = ("N", "M", "D", "box")
    st["proc"] = subprocess.Popen(
        [sys.executable, str(CLIENT), "--port", str(st["port"]),
         "--seed", str(ctx.seed), "--mix", json.dumps(ctx.traffic),
         "--config", json.dumps({k: ctx.config[k] for k in keys})],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    if st["proc"].stdout.readline().strip() != b"ready":
        st["proc"].kill()
        raise RuntimeError("the fleet's client process did not start")
    return st


def window(ctx, st, seconds: float) -> dict:
    mix, proc = ctx.traffic, st["proc"]
    h0 = _health(st["port"])
    t0 = time.perf_counter()
    with span(ctx.torch, "clients"):
        try:
            out, _ = proc.communicate(f"go {seconds}\n".encode(),
                                      timeout=seconds + 2 * mix["timeout_s"])
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
    t_end = time.perf_counter()
    if proc.returncode != 0:
        raise RuntimeError(f"the fleet's clients exited {proc.returncode}")
    h1 = _health(st["port"])
    rec = dict(np.load(io.BytesIO(out)))
    lat = rec["latency"]
    failed = int(np.sum(np.isnan(lat)))
    st["rec"] = rec
    return dict(
        t0=t0,
        metrics={"predict_p95_s": stats.latency_p95(
            lat[~np.isnan(lat)].tolist(), failed)},
        counters=dict(requests=len(lat), window_s=t_end - t0,
                      launches=h1["launches"] - h0["launches"],
                      batched_requests=(h1["batched_requests"]
                                        - h0["batched_requests"])),
        attempted=len(lat), failed=failed)


def release(ctx, st) -> None:
    if st["proc"].poll() is None:
        st["proc"].kill()
    st["proc"].wait()
    st["httpd"].shutdown()
    st["httpd"].server_close()
    st["thread"].join(timeout=30)
    st["server"].close()
    del st["server"]
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def check(ctx, st) -> dict:
    """Served against the float64 reference conditioned anew on the same
    data and hyperparameters: ``mean_rel`` and ``var_rel``, the largest
    over the checked replies of max |x - x_ref| / max |x_ref| of the
    reply. Every grid reply is checked, and ``check_requests`` small ones
    drawn from the seed."""
    torch, c = ctx.torch, ctx.config
    pb = ar1.make_problem(ctx)
    X, fid = pb["X"], pb["fid"]
    th = ar1.theta_of(gen.log_theta(c["theta"]), c)
    L, alpha, _ = ref.factor(X, fid, pb["y"], th, c["kernel"], c["jitter"])
    top = c["F"] - 1

    def reference(points):
        P = torch.as_tensor(points, device=ctx.device)
        fs = torch.full((P.shape[0],), top, dtype=torch.long,
                        device=ctx.device)
        mu, var = ref.predict(L, alpha, X, fid, th, c["kernel"], P, fs)
        return mu.cpu().numpy(), var.cpu().numpy()

    rec = st["rec"]
    off = rec["offsets"]
    done = [j for j in range(len(rec["latency"]))
            if not np.isnan(rec["latency"][j])]
    grid = [j for j in done if rec["n"][j] == 0]
    small = [j for j in done if rec["n"][j] > 0]
    picked = [small[i] for i in gen.sample(ctx.seed, len(small),
                                           ctx.traffic["check_requests"])]
    box = ctx.config["box"]
    refs = {}
    if grid:
        g_ref = reference(st["grid"])
        refs.update({j: g_ref for j in grid})
    if picked:
        # one reference call over every picked request's points, made
        # again from the seed
        pts = [gen.fleet_request(ctx.seed, ctx.traffic, int(rec["client"][j]),
                                 int(rec["index"][j]), box) for j in picked]
        mu, var = reference(np.concatenate(pts))
        o = np.concatenate([[0], np.cumsum([p.shape[0] for p in pts])])
        refs.update({j: (mu[o[i]:o[i + 1]], var[o[i]:o[i + 1]])
                     for i, j in enumerate(picked)})
    err = dict(mean_rel=0.0, var_rel=0.0)
    for j, (mu_ref, var_ref) in refs.items():
        got = {"mean_rel": (rec["mean"][off[j]:off[j + 1]], mu_ref),
               "var_rel": (rec["var"][off[j]:off[j + 1]], var_ref)}
        for k, (a, b) in got.items():
            e = (np.max(np.abs(a - b)) / np.max(np.abs(b))
                 if a.shape == b.shape else np.inf)
            # np.maximum, not max: a NaN reading stays NaN and fails
            err[k] = float(np.maximum(err[k], e))
    return err
