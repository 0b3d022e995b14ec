"""Parity of the port's serving (``mfgp_tpu_torch.serve``) with
``mfgp_tpu.serve`` on the CPU, and the port's planner and mission services.

The model routes (/predict, full_cov, /eid, /extend for the GP and for the
MFGP with ``fid``, /refit) and the router take the same numpy data in both
packages, float64, and agree to rtol 1e-8; the /refit NLML to 1e-6
relative, from one restart (row 0 is the current parameters in both
packages, so no random draws enter). Checkpoints written by the JAX package
serve in the port. The planner and mission services are held on the port
only (JAX's planner and mission compiles are what keep ``test_serve.py``
out of the quick tier): /plan is deterministic per seed, coalesced lanes
equal solo plans, a warm mission job equals a direct ``DeviceMission.run``
in float64. Every wait is bounded: HTTP calls carry timeouts, servers bind
port 0 and shut down in ``finally``, threads are daemons joined with a
timeout.
"""

import http.client
import io
import json
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mfgp_tpu import serve as jserve
from mfgp_tpu.models.gp import GP as JGP
from mfgp_tpu.models.mfgp import MFGP as JMFGP
from mfgp_tpu.utils import checkpoint as jckpt
from mfgp_tpu_torch import cli, serve
from mfgp_tpu_torch.models.gp import GP
from mfgp_tpu_torch.models.mfgp import MFGP

RTOL = 1e-8
CPU = "cpu"
JOIN_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread per test worker (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gp_data(seed=0, n=30):
    g = np.random.default_rng(seed)
    X = np.column_stack([g.uniform(0, 10, n), g.uniform(0, 20, n),
                         g.uniform(0, 10, n)])
    return g, X, np.sin(X[:, 0]) + 0.1 * g.standard_normal(n)


def mf_lists(seed=1):
    g = np.random.default_rng(seed)
    Xl = [g.uniform(0, 5, (n, 3)) for n in (12, 8, 6)]
    return g, Xl, [np.sin(x[:, 0]) + 0.05 * x[:, 1]
                   + 0.1 * g.standard_normal(x.shape[0]) for x in Xl]


def pair(kind):
    """(JAX server, port server) of the same float64 model."""
    if kind == "gp":
        _, X, y = gp_data()
        return (jserve.ModelServer(JGP(X, y, jitter=1e-8)),
                serve.ModelServer(GP(X, y, jitter=1e-8, device=CPU)))
    _, Xl, yl = mf_lists()
    return (jserve.ModelServer(JMFGP.from_fidelity_lists(Xl, yl,
                                                         jitter=1e-8)),
            serve.ModelServer(MFGP.from_fidelity_lists(Xl, yl, jitter=1e-8,
                                                       device=CPU)))


@pytest.fixture(scope="module", params=["gp", "mfgp"])
def servers(request):
    j, t = pair(request.param)
    yield request.param, j, t
    j.close()
    t.close()


def same(port: dict, ref: dict, rtol=RTOL):
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(np.asarray(port[k], float),
                                   np.asarray(ref[k], float), rtol=rtol,
                                   atol=1e-12)


QUERIES = {
    "predict": ("/predict", {}),
    "predict_noiseless": ("/predict", {"include_noise": False}),
    "full_cov": ("/predict", {"full_cov": True}),
    "full_cov_noiseless": ("/predict", {"full_cov": True,
                                        "include_noise": False}),
    "eid": ("/eid", {}),
    "eid_alpha": ("/eid", {"alpha": 0.3}),
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_routes_match_jax(servers, query):
    _, j, t = servers
    route, extra = QUERIES[query]
    pts = np.random.default_rng(3).uniform(0, 5, (7, 3)).tolist()
    same(t.handle(route, {"points": pts, **extra}),
         j.handle(route, {"points": pts, **extra}))


def test_health_matches_jax(servers):
    kind, j, t = servers
    a, b = t.handle("/health", {}), j.handle("/health", {})
    assert (a["status"], a["n"]) == (b["status"], b["n"])
    assert a["model"] == b["model"] == ("GP" if kind == "gp" else "MFGP")
    assert t.prior_sig == pytest.approx(j.prior_sig, rel=RTOL)


@pytest.mark.parametrize("kind", ["gp", "mfgp"])
def test_extend_matches_jax(kind):
    """/extend (bordered Cholesky) on both packages, then every query
    route on the grown model; the MFGP needs per-point fid."""
    j, t = pair(kind)
    try:
        q = [[2.0, 3.0, 1.0], [4.0, 1.0, 2.5]]
        body = {"points": q, "y": [0.3, -0.2]}
        if kind == "mfgp":
            for s in (j, t):
                with pytest.raises(ValueError, match="fid"):
                    s.handle("/extend", body)
            body["fid"] = [2, 0]
        assert t.handle("/extend", body) == j.handle("/extend", body)
        pts = np.random.default_rng(4).uniform(0, 5, (6, 3)).tolist()
        for route, extra in QUERIES.values():
            same(t.handle(route, {"points": pts, **extra}),
                 j.handle(route, {"points": pts, **extra}))
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("kind", ["gp", "mfgp"])
def test_refit_matches_jax(kind):
    """/refit from one restart: the same L-BFGS lane in both packages; the
    NLML to 1e-6 relative, the refreshed prior variance likewise."""
    j, t = pair(kind)
    try:
        body = {"restarts": 1, "maxiter": 30}
        a, b = t.handle("/refit", body), j.handle("/refit", body)
        assert a["n"] == b["n"]
        assert a["nlml"] == pytest.approx(b["nlml"], rel=1e-6)
        assert a["prior_sig"] == pytest.approx(b["prior_sig"], rel=1e-6)
        assert np.isfinite(a["nlml"]) and a["prior_sig"] == t.prior_sig
    finally:
        j.close()
        t.close()


def test_router_matches_jax():
    g, X, y = gp_data(2, 20)
    routers = []
    for pkg, M, kw in ((jserve, JGP, {}), (serve, GP, {"device": CPU})):
        routers.append(pkg.ModelRouter({
            "sin": pkg.ModelServer(M(X, np.sin(X[:, 0]), jitter=1e-8, **kw)),
            "cos": pkg.ModelServer(M(X, np.cos(X[:, 1]), jitter=1e-8,
                                     **kw))}))
    j, t = routers
    try:
        assert t.handle("/models", {}) == j.handle("/models", {}) == {
            "models": ["cos", "sin"], "default": "sin"}
        p = {"points": X[:3].tolist()}
        for route in ("/models/sin/predict", "/models/cos/eid", "/predict"):
            same(t.handle(route, p), j.handle(route, p))
        for bad in ("/models/nope/predict", "/models/sin"):
            with pytest.raises(KeyError):
                t.handle(bad, p)
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("kind", ["gp", "mfgp", "nigp"])
def test_checkpoint_serves_like_jax(tmp_path, kind):
    """A checkpoint the JAX package wrote serves in the port (as saved on
    the CPU: float64) with JAX's predictions; the NIGP, whose predict
    spells full_cov return_cov, too. Mutation routes the NIGP lacks are
    client errors."""
    g, X, y = gp_data(5, 24)
    pa = {"gp": np.array([1.2, 2.0, 3.0, 2.5, 0.05]),
          "nigp": np.array([0.1, 0.2, 0.1, 1.1, 0.2, 2.0, 3.0, 2.5])}
    if kind == "mfgp":
        _, Xl, yl = mf_lists(5)
        m = JMFGP.from_fidelity_lists(Xl, yl, jitter=1e-6)
        model = jckpt.capture_model(m)
    else:
        model = jckpt.ModelCheckpoint(kind, "rbf", pa[kind], X, y)
    ck = jckpt.ExplorationCheckpoint(
        plan_num=0, t_now=0.0, planned_budget=0.0, x0=np.zeros((2, 1)),
        model=model, data_rows=np.zeros((0, 9)),
        rng_state=np.random.default_rng(0).bit_generator.state,
        jax_key_data=np.zeros(2, np.uint32))
    path = str(tmp_path / "m")
    jckpt.save_checkpoint(path, ck)
    j = jserve.ModelServer.from_checkpoint(path)
    t = serve.ModelServer.from_checkpoint(path, device=CPU)
    try:
        assert (t.model.X if kind != "nigp"
                else t.model.X_train_).dtype == torch.float64
        pts = g.uniform(0, 5, (4, 3)).tolist()
        for route, extra in (("/predict", {}), ("/eid", {}),
                             ("/predict", {"full_cov": True})):
            same(t.handle(route, {"points": pts, **extra}),
                 j.handle(route, {"points": pts, **extra}))
        if kind == "nigp":
            with pytest.raises(ValueError, match="refit"):
                t.handle("/refit", {})
            with pytest.raises(ValueError, match="conditioning"):
                t.handle("/extend", {"points": pts[:1], "y": [0.0]})
    finally:
        j.close()
        t.close()


# ---------------------------------------------------------------------------
# HTTP and the batching queue
# ---------------------------------------------------------------------------
class Http:
    """A served service on port 0 in a daemon thread; ``stop`` shuts it
    down and joins it."""

    def __init__(self, service):
        self.srv = serve.make_http_server(service, port=0)
        self.addr = self.srv.server_address
        self.url = "http://%s:%d" % self.addr
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def req(self, method, path, body=None, raw=None):
        conn = http.client.HTTPConnection(*self.addr, timeout=60)
        try:
            conn.request(method, path, body=raw if raw is not None else (
                json.dumps(body) if body is not None else None))
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=JOIN_S)
        assert not self.thread.is_alive()


def test_http_round_trip_and_error_codes():
    _, X, y = gp_data()
    ms = serve.ModelServer(GP(X, y, jitter=1e-8, device=CPU))
    h = Http(ms)
    try:
        code, out = h.req("GET", "/health")
        assert code == 200 and out["status"] == "ok" and out["n"] == 30
        pts = X[:5].tolist()
        code, out = h.req("POST", "/predict", {"points": pts})
        assert code == 200
        same(out, ms.handle("/predict", {"points": pts}))
        assert h.req("POST", "/predict", {"points": []})[0] == 400
        assert h.req("POST", "/extend", {"points": pts, "y": [1.0]})[0] \
            == 400
        assert h.req("POST", "/predict", raw="{not json")[0] == 400
        assert h.req("POST", "/nope", {"points": pts})[0] == 404
        assert h.req("GET", "/nope")[0] == 404
    finally:
        h.stop()
        ms.close()


def test_a_fleet_connects_at_once():
    """32 clients connecting at the same instant are all answered without
    a retried connection: with socketserver's listen backlog of 5 the
    kernel drops the connections beyond it, and their clients retry a
    second later, after any batching window (an 8-client /plan was split
    into two launches so)."""

    class Health:
        def handle(self, path, payload):
            return {"status": "ok"}

    h = Http(Health())
    n = 32
    barrier = threading.Barrier(n)
    seconds = [None] * n

    def client(i):
        barrier.wait(timeout=JOIN_S)
        t0 = time.perf_counter()
        assert h.req("GET", "/health")[0] == 200
        seconds[i] = time.perf_counter() - t0

    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
    finally:
        h.stop()
    assert None not in seconds and max(seconds) < 0.9, seconds


def test_concurrent_predicts_coalesce_into_one_launch():
    """Six concurrent predict calls coalesce into at most two predict
    calls, and every caller gets its slice, equal to a solo call."""
    g, X, y = gp_data(6, 25)
    srv = serve.ModelServer(GP(X, y, jitter=1e-8, device=CPU),
                            batch_wait=0.25)
    try:
        launches0 = srv.batcher.launches
        n = 6
        barrier = threading.Barrier(n)
        results = [None] * n
        pts = [g.uniform(0, 10, (2 + i, 3)) for i in range(n)]

        def client(i):
            barrier.wait(timeout=JOIN_S)
            results[i] = srv._predict(pts[i])

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        assert srv.batcher.max_requests_per_launch >= 4
        assert srv.batcher.launches - launches0 <= 2
        for i in range(n):
            mu, var = results[i]
            assert mu.shape == (2 + i,)
            mu_solo, var_solo = srv._predict_device(pts[i])
            np.testing.assert_allclose(mu, mu_solo, rtol=1e-12)
            np.testing.assert_allclose(var, var_solo, rtol=1e-12)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the planner service (port only)
# ---------------------------------------------------------------------------
def planner_service(cost="ergodic", n=25, iters=10, **kw):
    _, X, y = gp_data(7, n)
    if cost.startswith("mf"):
        _, Xl, yl = mf_lists(7)
        Xl = [x * [2, 4, 2] for x in Xl]  # over the workspace
        model = MFGP.from_fidelity_lists(Xl, yl, jitter=1e-8, device=CPU)
    else:
        model = GP(X, y, jitter=1e-8, device=CPU)
    return serve.PlannerService(serve.ModelServer(model), cost=cost,
                                plan_iters=iters, **kw)


def test_plan_route_deterministic_per_seed():
    svc = planner_service()
    h = Http(svc)
    try:
        body = {"start": [1.0, 1.0, 4.0], "budget": 20.0, "seed": 3}
        code, out = h.req("POST", "/plan", body)
        assert code == 200
        path = np.asarray(out["path"])
        assert path.ndim == 2 and path.shape[1] == 4
        assert 0.0 < out["budget"] <= 20.0 and out["n_nodes"] > 1
        assert np.isfinite(out["info"]) and out["plan_seconds"] > 0
        assert h.req("POST", "/plan", body)[1]["path"] == out["path"]
        assert h.req("GET", "/health")[1]["status"] == "ok"
        assert h.req("POST", "/plan", {"start": [1.0]})[0] == 400
    finally:
        h.stop()
        svc.close()


def test_concurrent_plans_equal_solo_plans():
    """Five concurrent /plan requests become lanes of one plan_batch loop
    (padded to eight), and each lane's plan is its solo plan: the same
    nodes and path."""
    svc = planner_service(iters=8)
    svc.plan_queue.max_wait = 0.25  # the threads must land in one window
    try:
        n = 5
        barrier = threading.Barrier(n)
        results = [None] * n
        reqs = [{"start": [1.0 + i, 2.0], "budget": 20.0, "seed": i}
                for i in range(n)]

        def client(i):
            barrier.wait(timeout=JOIN_S)
            results[i] = svc.handle("/plan", reqs[i])

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        q = svc.plan_queue
        assert (q.launches, q.batched_requests) == (1, n)
        assert q.max_requests_per_launch == n
        for i in range(n):
            solo = svc.handle("/plan", reqs[i])
            assert results[i]["n_nodes"] == solo["n_nodes"]
            assert results[i]["path"] == solo["path"]
            assert results[i]["info"] == solo["info"]
    finally:
        svc.close()


def test_plan_cost_model_mismatch():
    from mfgp_tpu_torch.models.nigp import nigp_from_numpy

    _, X, y = gp_data(8, 15)
    srv = serve.ModelServer(GP(X, y, jitter=1e-8, device=CPU))
    with pytest.raises(ValueError, match="does not match"):
        serve.PlannerService(srv, cost="mf_gain")
    srv.close()
    srv2 = serve.ModelServer(nigp_from_numpy(
        (np.ones(3), 1.0, 0.1, 0.1 * np.ones(3)), X, y, device=CPU))
    with pytest.raises(ValueError, match="conditioned"):
        serve.PlannerService(srv2, cost="sf_gain")
    srv2.close()


def test_extend_and_refit_invalidate_the_plan_caches():
    """/extend and /refit drop the cached EID (and gain state); the next
    /plan scores the changed posterior on the planner warmed at start."""
    svc = planner_service(iters=8, warm=True)
    try:
        body = {"start": [3.0, 5.0], "budget": 15.0, "seed": 0}
        out1 = svc.handle("/plan", body)
        assert svc._eid_cache and np.isfinite(out1["info"])
        eid1 = next(iter(svc._eid_cache.values())).copy()
        svc.handle("/extend", {"points": [[5.0, 10.0, 5.0]], "y": [2.0]})
        assert not svc._eid_cache and svc._gain_cache is None
        out2 = svc.handle("/plan", body)
        assert not np.allclose(eid1, next(iter(svc._eid_cache.values())))
        assert out2["info"] != out1["info"] and np.isfinite(out2["info"])
        svc.handle("/refit", {"restarts": 1, "maxiter": 3})
        assert not svc._eid_cache and svc._gain_cache is None
        assert np.isfinite(svc.handle("/plan", body)["info"])
    finally:
        svc.close()


def test_gain_plan_on_the_served_mfgp():
    """mf_gain /plan conditions the information gain on the served MFGP's
    training set (prepare_mf_gain_state), cached until a mutation."""
    svc = planner_service("mf_gain", iters=6)
    try:
        out = svc.handle("/plan", {"start": [3.0, 5.0], "budget": 15.0,
                                   "seed": 0})
        assert np.isfinite(out["info"]) and len(out["path"]) > 0
        assert svc._gain_cache is not None and not svc._eid_cache
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# the mission service (port only) and the command line
# ---------------------------------------------------------------------------
MISSION = {"variant": "SFEGP", "budget": 12.0, "bd": 1, "plan_iters": 6,
           "e_max": 6, "max_nodes": 16, "samples_per_edge": 6}


def wait_job(svc, i, timeout=JOIN_S):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        st = svc.handle(f"/mission/{i}", {})
        if st["state"] in ("done", "error"):
            return st
        time.sleep(0.05)
    raise TimeoutError(i)


def test_mission_service_warm_job_equals_direct_run():
    """The second submission of a configuration reuses the first's built
    mission (warm) and equals a direct float64 DeviceMission.run of its
    seed; so does the first. Unknown variants and jobs are client errors;
    ``mission --submit URL`` runs against the served process."""
    from mfgp_tpu_torch.sim.mission_device import DeviceMission
    from mfgp_tpu_torch.utils.configs import ExperimentConfig

    svc = serve.MissionService(device=CPU)
    h = Http(svc)
    try:
        j0 = svc.handle("/mission", dict(MISSION, seed=1))
        j1 = svc.handle("/mission", dict(MISSION, seed=2))
        assert j0["warm"] is False and j0["state"] == "queued"
        r0, r1 = wait_job(svc, j0["job"]), wait_job(svc, j1["job"])
        assert r0["state"] == r1["state"] == "done", (r0, r1)
        assert (r0["warm"], r1["warm"]) == (False, True)
        for seed, r in ((1, r0), (2, r1)):
            m = DeviceMission(ExperimentConfig(
                multi_fidelity=False, ergodic=True, update_hyps=False,
                B=12.0, BD=1), seed=seed, plan_iters=6, e_max=6,
                max_nodes=16, samples_per_edge=6, device=CPU)
            d = m.run()
            assert r["result"] == {"rmse": d.rmse, "replans": d.n_replans,
                                   "budget_used": d.budget_used,
                                   "n_data": int(d.gp_data.data.shape[0])}
            assert r["result"]["replans"] >= 1
        assert h.req("GET", "/missions")[1]["jobs"][1]["warm"] is True
        assert h.req("POST", "/mission", {"variant": "NOPE"})[0] == 400
        assert h.req("GET", "/mission/99")[0] == 404
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["mission", "--submit", h.url, "--variant", "SFGP",
                      "--seed", "1", "--budget", "8", "--bd", "1",
                      "--plan-iters", "4", "--e-max", "4"])
        job = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert job["state"] == "done" and job["warm"] is False, job
        assert np.isfinite(job["result"]["rmse"]) and job["client_seconds"] > 0
    finally:
        h.stop()
        svc.close()


def test_cli_serve_and_plot_parse():
    ap = cli.build_parser()
    a = ap.parse_args(["--cpu", "serve", "a=x.npz", "b=y.npz", "--port",
                       "0"])
    assert a.fn is cli.cmd_serve and a.checkpoint == ["a=x.npz", "b=y.npz"]
    a = ap.parse_args(["serve", "ck.npz", "--plan-cost", "mf_gain",
                       "--plan-iters", "20"])
    assert (a.plan_cost, a.plan_iters) == ("mf_gain", 20)
    a = ap.parse_args(["plot", "d.csv", "--out", "f.png", "--y", "1", "v"])
    assert a.fn is cli.cmd_plot and a.y == ["1", "v"]
    a = ap.parse_args(["mission-server", "--port", "0"])
    assert a.fn is cli.cmd_mission_server
    sub = next(x for x in ap._actions if x.dest == "cmd")
    assert len(sub.choices) == 14
    with pytest.raises(SystemExit):
        cli.main(["--cpu", "serve", "a=x.npz", "--plan-cost", "sf_gain"])
