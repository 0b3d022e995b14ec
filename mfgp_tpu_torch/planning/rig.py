"""RIG — rapidly-exploring information gathering graph planner.

SURVEY C9 (reference/GraceRIGV3.py:737-1362): an RRT-style random graph of
motion-primitive edges under an energy budget, with a per-node path-set
dynamic program and a global best-path tracker.

Architecture split (TPU-first): the graph bookkeeping — sampling, nearest /
near queries, node merging, the path-set DP — is cheap scalar work and
stays host-side with an explicit seeded ``np.random.Generator``. Every
expensive decision, the information/ergodic score of a candidate path,
is deferred: within one ``update_path_list`` call all extensions that
survive the budget filters are scored in a single batched device launch
through a ``planning.scoring`` cost object. The reference instead refits a
GPy model per candidate inside the DP loop
(reference/GraceRIGV3.py:1158).

Semantics retained from the reference (documented quirks included):

* ``nearest``: picks the node whose distance to the sample is closest to
  ``Rd`` — the reference minimises ``(Rd - d)^2``
  (reference/GraceRIGV3.py:801), an expansion ring, not a classic nearest.
* Node merging within ``same_node_distance``; closed set ``Vc`` exists but
  nodes are never actually closed (the reference ``pass``es,
  reference/GraceRIGV3.py:1267-1270).
* Path scores below the budget-cutoff fraction of B get the sentinel
  -10000 instead of a device call (reference/GraceRIGV3.py:1157-1170).
* Self-edges (node-to-itself) restrict leg choice to surfacing primitives
  (reference/GraceRIGV3.py:306-308).
"""

from __future__ import annotations

import json
import math
import time as _time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

from mfgp_tpu_torch.planning import primitives as prim


class Edge(NamedTuple):
    """One candidate motion-primitive trajectory between two nodes.

    Mirrors the reference's edge tuple schema
    ``(idx1, idx2, info, budget, time, uncertainty, prims)``
    (reference/GraceRIGV3.py:330).
    """

    idx1: int
    idx2: int
    info: float  # environment line-integral score from the edge planner
    budget: float
    time: float
    uncertainty: float
    prims: tuple


class PathSegment(NamedTuple):
    """One step of a path: edge reference + cumulative totals.

    Mirrors the reference's path-entry schema
    ``(start, end, edge_idx, time, budget, info)``
    (reference/GraceRIGV3.py:1102).
    """

    sn: int
    en: int
    edge_idx: int
    time: float
    budget: float
    info: float


@dataclass
class Node:
    idx: int
    state: np.ndarray  # (d, 1) planar planning state
    path_list: list = field(default_factory=list)
    min_path_cost: float = -np.inf
    info: float = -np.inf


class BestPath(NamedTuple):
    budget: float
    info: float
    node_idx: Optional[int]
    segments: Optional[tuple]


_UNSCORED = -10000.0


@dataclass
class RIGPlanner:
    """Budgeted information-gathering graph planner.

    cfg: agent/motion config; cost: a ``planning.scoring`` cost object (its
    ``batch`` method is the device hot path); env: optional scalar field
    whose line integral seeds each edge's ``info`` (the reference sums the
    field over the edge trajectory, reference/GraceRIGV3.py:322-325).
    """

    cfg: prim.AgentConfig
    delta: float  # steer step size
    B: float  # energy budget
    WS: np.ndarray  # (d, 2) workspace bounds
    R: float  # near radius
    Rd: float = 0.0  # expansion-ring radius for nearest queries
    same_node_distance: float = 0.0
    budget_cutoff: float = 0.9
    max_iter: int = 20
    wallclock_limit: Optional[float] = None  # seconds; like agent.stopWatch
    seed: int = 0
    cost: Optional[object] = None
    env: Optional[Callable] = None
    dense_scoring: bool = False  # resample paths at meas_rate before scoring
    batch_scoring: bool = True
    allow_self_loops: bool = False

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.WS = np.asarray(self.WS, float)
        self.V: dict[int, Node] = {}
        self.E: dict[tuple, list[Edge]] = {}
        self.Vc: set[int] = set()
        self.best_path = BestPath(0.0, -np.inf, None, None)
        self.cur_iter = 0
        self._t_start = None
        self.root_idx = 0
        self.stats = {"scored_paths": 0, "score_batches": 0, "edges": 0}

    # -- geometry helpers ---------------------------------------------------
    def sample(self):
        lo, hi = self.WS[:, 0], self.WS[:, 1]
        return (lo + (hi - lo) * self.rng.random(lo.shape))[:, None]

    def steer(self, x1, x2):
        d = float(np.linalg.norm(x2 - x1))
        if d == 0:
            return x1.copy()
        return x1 + min(d, self.delta) * (x2 - x1) / d

    def in_workspace(self, x):
        return bool(((x[:, 0] - self.WS[:, 0]) >= 0).all()
                    and ((self.WS[:, 1] - x[:, 0]) >= 0).all())

    def nearest(self, xsamp, idxs):
        """Expansion-ring nearest: node with distance closest to Rd."""
        idxs = list(idxs)
        d = [(self.Rd - np.linalg.norm(self.V[i].state - xsamp)) ** 2
             for i in idxs]
        return self.V[idxs[int(np.argmin(d))]]

    def near(self, x, idxs):
        """Nodes within R of x, plus the single closest node within
        max(same_node_distance, R)."""
        nlist, min_idx = [], -1
        min_d = max(self.same_node_distance, self.R)
        for i in idxs:
            d = float(np.linalg.norm(self.V[i].state - x))
            if d <= self.R:
                nlist.append(self.V[i])
            if d <= min_d:
                min_idx, min_d = i, d
        return min_idx, nlist

    # -- edge planning ------------------------------------------------------
    def edge_planner(self, n1: Node, n2: Node):
        """Generate up to traj_count feasible candidate edges
        (reference/GraceRIGV3.py:296-335)."""
        cfg = self.cfg
        probs = list(cfg.leg_probs)
        if n1.idx == n2.idx:  # self edge: surfacing-only primitives
            probs = [1.0 * cfg.surface_by_spiral, 0.0, 0.0,
                     1.0 * (not cfg.surface_by_spiral)]
        legs = [prim.Leg.SPIRAL, prim.Leg.GLIDE, prim.Leg.SWIM,
                prim.Leg.FLATDIVE]
        distance = float(np.linalg.norm(n1.state[:2] - n2.state[:2]))
        edges = []
        for _ in range(cfg.traj_count):
            choices = self.rng.choice(4, cfg.num_legs, p=probs)
            tt, prims = prim.generate_trajectory(
                self.rng, [legs[c] for c in choices], distance, cfg)
            tt2, _, tuw, wpnts, bu = prim.evaluate_trajectory(prims, cfg)
            info = -np.inf
            if self.env is not None:
                pts = prim.edge_points_to_traj_points(
                    n1.state, n2.state, wpnts, cfg.meas_rate)
                info = float(np.sum(self.env(pts[:, :3])))
            if tuw <= cfg.underwater_time_limit:
                edges.append(Edge(n1.idx, n2.idx, info, bu, tt2, 0.0,
                                  tuple(prims)))
        return edges

    # -- scoring ------------------------------------------------------------
    def _path_points(self, segments):
        node_states = {i: self.V[i].state for i in self.V}
        edge_refs = [(s.sn, s.en, self.E[(s.sn, s.en)][s.edge_idx].prims)
                     for s in segments]
        return prim.path_to_traj_points(node_states, edge_refs, self.cfg,
                                        dense=self.dense_scoring)

    def _score_paths(self, candidate_paths):
        """Score a batch of candidate segment-lists in one device launch."""
        if self.cost is None or not candidate_paths:
            return [_UNSCORED] * len(candidate_paths)
        pts = [self._path_points(p) for p in candidate_paths]
        self.stats["scored_paths"] += len(pts)
        if self.batch_scoring and len(pts) > 1:
            self.stats["score_batches"] += 1
            return list(self.cost.batch(pts))
        return [self.cost(p) for p in pts]

    # -- path-set dynamic program ------------------------------------------
    def update_path_list(self, n_prev: Node, n_new: Node,
                         new_edges: Sequence[Edge]):
        edge_id = (n_prev.idx, n_new.idx)
        was_known = n_new.idx in self.V
        n_edges_before = len(self.E.get(edge_id, ()))
        pending = []  # (base_path or None, segment-prototype)

        if not n_new.path_list and edge_id[0] == self.root_idx:
            # bootstrap: single-segment paths from the root
            for edge in new_edges:
                if edge.budget > self.B:
                    continue
                self.E.setdefault(edge_id, []).append(edge)
                edge_idx = len(self.E[edge_id]) - 1
                seg = PathSegment(*edge_id, edge_idx, edge.time, edge.budget,
                                  _UNSCORED)
                self.V[n_new.idx] = n_new
                pending.append(([], seg, len(self.V) > 1))
        else:
            combo = (n_new.path_list if n_new is n_prev
                     else n_new.path_list + n_prev.path_list)
            carried = [p for p in combo
                       if p[-1].en != edge_id[0]
                       and p[0].sn == self.root_idx]
            extendable = [p for p in combo if p[-1].en == edge_id[0]]
            stored_edges = []
            for edge in new_edges:
                self.E.setdefault(edge_id, []).append(edge)
                stored_edges.append((len(self.E[edge_id]) - 1, edge))
            for p in extendable:
                for edge_idx, edge in stored_edges:
                    path_time = p[-1].time + edge.time
                    path_budget = (edge.budget if p[-1].budget < 0
                                   else p[-1].budget + edge.budget)
                    if (path_budget < n_new.min_path_cost
                            or math.isinf(n_new.min_path_cost)):
                        n_new.min_path_cost = path_budget
                    if path_budget >= self.B:
                        continue
                    self.V.setdefault(n_new.idx, n_new)
                    seg = PathSegment(*edge_id, edge_idx, path_time,
                                      path_budget, _UNSCORED)
                    score_it = (len(self.V) > 1
                                and path_budget > self.budget_cutoff * self.B)
                    pending.append((p, seg, score_it))
            n_new.path_list = carried

        # one batched device call for everything that needs a real score
        to_score = [(i, base + [seg]) for i, (base, seg, s)
                    in enumerate(pending) if s]
        scores = self._score_paths([p for _, p in to_score])
        score_map = {i: s for (i, _), s in zip(to_score, scores)}

        best = self.best_path
        for i, (base, seg, _) in enumerate(pending):
            info = float(score_map.get(i, _UNSCORED))
            seg = seg._replace(info=info)
            new_path = base + [seg]
            n_new.path_list.append(new_path)
            if info > best.info or (info == best.info
                                    and best.budget > seg.budget):
                n_new.info = info
                best = BestPath(seg.budget, info, n_new.idx, tuple(new_path))
        self.best_path = best

        # roll back if a brand-new node was not admitted (every extension
        # exceeded the budget): keeping its edges/V entry would let plan()
        # recycle the index for a *different* state while stale edges
        # synthesized for the old endpoint survive under the same (i, j)
        # key, corrupting persistence and traversals
        if not was_known and not n_new.path_list:
            self.V.pop(n_new.idx, None)
            if edge_id in self.E:
                del self.E[edge_id][n_edges_before:]
                if not self.E[edge_id]:
                    del self.E[edge_id]

    # -- main loop ----------------------------------------------------------
    def _terminal(self):
        self.cur_iter += 1
        if self.wallclock_limit is not None:
            return _time.time() - self._t_start < self.wallclock_limit
        return self.cur_iter < self.max_iter

    def plan(self, xstart):
        """Grow the graph from ``xstart`` until the iteration/wall-clock
        budget is exhausted (reference/GraceRIGV3.py:1191-1362).

        The wall-clock stopwatch anchors HERE, at plan entry — like the
        reference's ``agent.stopWatch`` which records its start time when
        planning begins (reference/GraceRIGV3.py:51-56) — so graph/root
        setup counts against the replan budget
        (reference/PhysicalExperimentCode/exploreExpSettings.py:214-215).
        """
        self._t_start = _time.time()
        root = Node(self.root_idx, np.asarray(xstart, float).reshape(-1, 1))
        self.V = {root.idx: root}
        Vidx = {root.idx}
        while self._terminal():
            xsamp = self.sample()
            n_nearest = self.nearest(xsamp, Vidx - self.Vc)
            xfeas = self.steer(n_nearest.state, xsamp)
            t_near_idx, n_near_list = self.near(xfeas, Vidx - self.Vc)
            if t_near_idx > -1:
                if (np.linalg.norm(self.V[t_near_idx].state - xfeas)
                        < self.same_node_distance):
                    xfeas = self.V[t_near_idx].state
            if not self.in_workspace(xfeas):
                continue
            # create or merge the new node
            if (np.linalg.norm(n_nearest.state - xfeas)
                    < self.same_node_distance):
                n_new = n_nearest
            elif (t_near_idx > -1
                  and np.linalg.norm(self.V[t_near_idx].state - xfeas)
                  < self.same_node_distance):
                n_new = self.V[t_near_idx]
            else:
                n_new = Node(max(Vidx) + 1, xfeas)
            new_edges = self.edge_planner(n_nearest, n_new)
            self.stats["edges"] += len(new_edges)
            if new_edges:
                self.update_path_list(n_nearest, n_new, new_edges)
                if n_new.path_list:
                    self.V[n_new.idx] = n_new
                    Vidx.add(n_new.idx)
            # try extending the near neighborhood toward the new point
            for n_near in n_near_list:
                if n_near.idx == n_new.idx and not self.allow_self_loops:
                    continue
                xnew = self.steer(n_near.state, xfeas)
                if not self.in_workspace(xnew):
                    continue
                if np.linalg.norm(xfeas - xnew) < self.same_node_distance:
                    n_new2 = n_new
                else:
                    n_new2 = Node(max(Vidx) + 1, xnew)
                new_edges = self.edge_planner(n_near, n_new2)
                self.stats["edges"] += len(new_edges)
                if new_edges:
                    self.update_path_list(n_near, n_new2, new_edges)
                    if n_new2.path_list:
                        self.V[n_new2.idx] = n_new2
                        Vidx.add(n_new2.idx)
        return self.best_path

    # -- results ------------------------------------------------------------
    def best_path_points(self, dense: bool = True):
        if self.best_path.segments is None:
            return None
        node_states = {i: self.V[i].state for i in self.V}
        edge_refs = [(s.sn, s.en, self.E[(s.sn, s.en)][s.edge_idx].prims)
                     for s in self.best_path.segments]
        return prim.path_to_traj_points(node_states, edge_refs, self.cfg,
                                        dense=dense)

    # -- persistence (checkpoint/resume of the graph, SURVEY §5) -----------
    def node_loc_dict(self, save=False, fname="graphNodes.txt"):
        d = {i: self.V[i].state.tolist() for i in self.V}
        if save:
            with open(fname, "w") as f:
                json.dump(d, f)
        return d

    def edge_dict(self, save=False, fname="graphEdges.txt"):
        # leg types stored alongside params for exact reconstruction
        d = {str(k): [
            [e.idx1, e.idx2, e.info, e.budget, e.time, e.uncertainty,
             [[int(p[0])] + [float(x) for x in p[1:]] for p in e.prims]]
            for e in v] for k, v in self.E.items()}
        if save:
            with open(fname, "w") as f:
                json.dump(d, f)
        return d

    def load_graph(self, edge_file, node_file):
        """Rebuild V/E from saved JSON artifacts
        (reference/GraceRIGV3.py:895-906)."""
        with open(edge_file) as f:
            edges = json.load(f)
        with open(node_file) as f:
            nodes = json.load(f)
        for k, state in nodes.items():
            self.V[int(k)] = Node(int(k), np.asarray(state, float))
        for k, elist in edges.items():
            i, j = (int(v) for v in k.strip("()").split(","))
            self.E[(i, j)] = [
                Edge(e[0], e[1], e[2], e[3], e[4], e[5],
                     tuple(tuple([prim.Leg(int(p[0]))] + p[1:]) for p in e[6]))
                for e in elist]

    def graph_summary(self):
        return {"nodes": len(self.V), "edges": sum(len(v) for v in
                                                   self.E.values()),
                "best_info": self.best_path.info,
                "best_budget": self.best_path.budget, **self.stats}

    # -- traversals (reference/GraceRIGV3.py:1367-1453) ---------------------
    def _adjacency(self):
        adj: dict[int, set] = {i: set() for i in self.V}
        for (i, j) in self.E:
            if i in adj and i != j:
                adj[i].add(j)
        return adj

    def dfs(self, start: Optional[int] = None):
        """Depth-first node order from ``start`` (default: root)."""
        adj = self._adjacency()
        stack = [self.root_idx if start is None else start]
        seen, order = set(), []
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            order.append(n)
            stack.extend(sorted(adj.get(n, ()), reverse=True))
        return order

    def bfs(self, start: Optional[int] = None):
        """Breadth-first node order from ``start`` (default: root)."""
        from collections import deque

        adj = self._adjacency()
        q = deque([self.root_idx if start is None else start])
        seen, order = set(q), []
        while q:
            n = q.popleft()
            order.append(n)
            for m in sorted(adj.get(n, ())):
                if m not in seen:
                    seen.add(m)
                    q.append(m)
        return order

    def search(self, idx: int) -> bool:
        """Is node ``idx`` reachable from the root?"""
        return idx in self.dfs()

    def childless_nodes(self):
        """Leaf nodes: no outgoing edges (reference ``childlessNodes``)."""
        adj = self._adjacency()
        return sorted(i for i, kids in adj.items() if not kids)
