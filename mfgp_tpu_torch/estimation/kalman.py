"""Kalman filtering: pure functions and the trajectory filter of the data
pipeline (counterpart of ``mfgp_tpu/estimation/kalman.py``).

Semantics preserved from the reference pipeline (C16 in SURVEY.md §2):

* 6-state constant-velocity model (x, y, z, vx, vy, vz), A(dt) integrating
  velocity into position, no control input (B=0).
* GPS gating: x/y position measurements only enter when the true depth is
  at the surface (``z <= atSurface``), via a time-varying H
  (reference/trajectoryEstimateGenerator.py:62-63).
* Process noise scaled per-step as Q*dt; velocity pseudo-measurements from
  finite differences of the ground-truth positions.

The JAX package scans the steps inside one compiled program and vmaps the
scan over trajectories. Here every function takes leading batch axes
(``x`` (..., 6, 1), ``P`` (..., 6, 6)), and ``filter_trajectory`` runs one
loop for a whole batch of trajectories. The per-step inputs (A, Q dt, the
gated H, the noisy measurement) are built for all steps at once before the
loop, the GPS gate is a tensor mask, and nothing in the loop reads a value
back to the host. On the card the loop is captured as a CUDA graph of
``graph_steps`` steps and replayed, which takes the ~20 small launches per
step off the host's clock.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.utils import profiling
from mfgp_tpu_torch.utils.device import CUDA, resolve


def _solve(A, B):
    """``A^-1 B`` by a batched LU solve that never reads its status back
    (``torch.linalg.solve`` would synchronise the host on every call)."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def kf_update(x, P, z, H, R):
    """Linear measurement update (Joseph-free, the reference's ``(I-KH)P``
    form, reference/GraceObservers.py:16-23)."""
    PHT = P @ H.mT
    S = H @ PHT + R
    K = _solve(S.mT, PHT.mT).mT  # PH^T S^-1 without an explicit inverse
    x = x + K @ (z - H @ x)
    P = (torch.eye(P.shape[-1], dtype=P.dtype, device=P.device) - K @ H) @ P
    return x, P


def kf_predict(x, u, A, B, P, Q):
    """Linear time update ``x <- Ax + Bu``, ``P <- APA^T + Q``
    (reference/GraceObservers.py:25-30). Pass ``B=None`` for no input."""
    x = A @ x
    if B is not None:
        x = x + B @ u
    P = A @ P @ A.mT + Q
    return x, P


def kf_step(x, P, u, z, A, B, Q, H, R):
    """predict + update in one call (the per-tick pattern of every control
    loop)."""
    x, P = kf_predict(x, u, A, B, P, Q)
    return kf_update(x, P, z, H, R)


class KFModel(NamedTuple):
    """Constant-velocity 6-state model matrices (SURVEY C26 config values,
    reference/exploreSimSettings.py:143-152)."""

    P0: torch.Tensor  # (6, 6) initial covariance
    Q: torch.Tensor  # (6, 6) process noise (per unit time)
    R: torch.Tensor  # (6, 6) measurement noise
    meas_noise_std: torch.Tensor  # (6,) additive noise on simulated measurements
    at_surface: float  # GPS gate depth threshold

    @staticmethod
    def A(dt, dtype=torch.float64, device=CUDA):
        """x,y,z integrate vx,vy,vz; ``dt`` may carry batch axes. A tensor
        ``dt`` keeps its own device, anything else goes to ``device``."""
        if isinstance(dt, torch.Tensor):
            dt = dt.to(dtype)
        else:
            dt = torch.as_tensor(dt, dtype=dtype, device=resolve(device))
        A = torch.eye(6, dtype=dtype, device=dt.device).repeat(
            dt.shape + (1, 1))
        for i in range(3):
            A[..., i, i + 3] = dt
        return A


def kf_model_from_numpy(P0, Q, R, meas_noise_std, at_surface, device=CUDA,
                        dtype=torch.float64) -> KFModel:
    """The port's model from numpy values (``np.asarray`` of each field of
    the JAX package's ``KFModel``)."""
    z = dict(dtype=dtype, device=resolve(device))
    return KFModel(*(torch.tensor(np.asarray(a), **z)
                     for a in (P0, Q, R, meas_noise_std)), float(at_surface))


def _run_eager(step, x, P, inputs, n_steps: int):
    out = []
    for j in range(n_steps):
        x, P, o = step(x, P, *(a[:, j] for a in inputs))
        out.append(o)
    return torch.stack(out, dim=1)


def _run_graphed(step, x, P, inputs, n_steps: int, chunk: int,
                 cache: dict | None = None):
    """The same loop as ``chunk``-step CUDA graphs: the inputs of one chunk
    are copied into fixed buffers, the graph replays ``chunk`` steps on
    them and on the carried (x, P), and its outputs are copied out. The
    steps past ``n_steps`` in the last chunk run on repeats of the last
    input and are dropped. ``cache`` (a dict the caller keeps for one
    model) holds the graph and its buffers per shape, so a later call of
    the same shapes replays it without capturing."""
    n_chunks = -(-n_steps // chunk)
    pad = n_chunks * chunk - n_steps
    if pad:
        inputs = [torch.cat([a, a[:, -1:].expand(-1, pad, *a.shape[2:])], 1)
                  for a in inputs]
    key = (chunk, tuple(x.shape)) + tuple(tuple(a.shape) for a in inputs)
    if cache is not None and key in cache:
        graph, bufs, x_buf, P_buf, out_buf = cache[key]
        x_buf.copy_(x)
        P_buf.copy_(P)
        return _replay(graph, bufs, inputs, out_buf, n_chunks, chunk,
                       n_steps)
    bufs = [torch.empty_like(a[:, :chunk]) for a in inputs]
    x_buf, P_buf = x.clone(), P.clone()

    def run_chunk():
        xc, Pc = x_buf, P_buf
        outs = []
        for j in range(chunk):
            xc, Pc, o = step(xc, Pc, *(b[:, j] for b in bufs))
            outs.append(o)
        x_buf.copy_(xc)
        P_buf.copy_(Pc)
        return torch.stack(outs, dim=1)

    for b, a in zip(bufs, inputs):
        b.copy_(a[:, :chunk])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        run_chunk()
    torch.cuda.current_stream().wait_stream(side)
    x_buf.copy_(x)
    P_buf.copy_(P)
    graph = torch.cuda.CUDAGraph()
    profiling.count("graph.captures")
    with torch.cuda.graph(graph):
        out_buf = run_chunk()
    if cache is not None:
        cache[key] = (graph, bufs, x_buf, P_buf, out_buf)
    return _replay(graph, bufs, inputs, out_buf, n_chunks, chunk, n_steps)


def _replay(graph, bufs, inputs, out_buf, n_chunks, chunk, n_steps):
    out = []
    for c in range(n_chunks):
        for b, a in zip(bufs, inputs):
            b.copy_(a[:, c * chunk:(c + 1) * chunk])
        graph.replay()
        out.append(out_buf.clone())
    return torch.cat(out, dim=1)[:, :n_steps]


def filter_trajectory(model: KFModel, t, pos_true, seed: int = 0,
                      noise=None, generator: torch.Generator | None = None,
                      graph_steps: int | None = None,
                      graph_cache: dict | None = None):
    """Run the estimate-generation filter over recorded trajectories.

    t: (T,) timestamps and pos_true: (T, 3) ground-truth positions, or a
    batch (B, T) and (B, T, 3); they go to the model's device and dtype.

    The measurement noise is ``model.meas_noise_std`` times standard normal
    draws of shape (T-1, 6) (batched: (B, T-1, 6)): ``noise`` when given
    (an array of such draws, e.g. another package's own), else drawn on the
    CPU from ``generator``, else from a CPU ``torch.Generator`` seeded with
    ``seed`` (batched: one stream of B (T-1) 6 draws), so a seed repeats on
    every device.

    Returns a dict of (T-1,)-leading columns matching the reference's
    ``T<seed>_<vmn>.csv`` schema
    (reference/trajectoryEstimateGenerator.py:47: t,x,y,z,xh,yh,zh,
    sigx,sigy,sigz,xe,ye,ze). Step j consumes row j-1's position (the
    reference's off-by-one loop convention) and the finite-difference
    velocity between rows j-1 and j.

    ``graph_steps``: steps per CUDA graph on the card (default 128; 0 runs
    the loop eagerly, as a CPU model always does). ``graph_cache``: a dict
    the caller keeps for this model, in which the captured graph of each
    shape is kept and replayed by later calls (a flight per replan of a
    mission) instead of captured anew.
    """
    dtype, device = model.P0.dtype, model.P0.device
    z = dict(dtype=dtype, device=device)
    t = torch.as_tensor(t, **z)
    pos_true = torch.as_tensor(pos_true, **z)
    single = t.dim() == 1
    if single:
        t, pos_true = t[None], pos_true[None]
    B, T = t.shape
    n = T - 1
    if noise is None:
        gen = generator or torch.Generator().manual_seed(seed)
        noise = torch.randn((B, n, 6), generator=gen, dtype=torch.float64)
    noise = torch.as_tensor(noise, **z).reshape(B, n, 6)

    dts = t[:, 1:] - t[:, :-1]  # (B, n)
    pos_prev = pos_true[:, :-1]
    vels = (pos_true[:, 1:] - pos_prev) / dts[..., None]
    meas = (torch.cat([pos_prev, vels], dim=2)
            + model.meas_noise_std * noise)[..., None]  # (B, n, 6, 1)
    gps = (pos_prev[..., 2] <= model.at_surface).to(dtype)
    H = torch.diag_embed(torch.cat(
        [gps[..., None], gps[..., None], torch.ones((B, n, 4), **z)], dim=2))
    A = KFModel.A(dts, dtype)
    Qdt = model.Q * dts[..., None, None]
    R = model.R

    def step(x, P, A, Qdt, H, meas, pos_prev):
        x, P = kf_predict(x, None, A, None, P, Qdt)
        x, P = kf_update(x, P, meas, H, R)
        xh = x[:, :3, 0]
        diagP = torch.diagonal(P, dim1=-2, dim2=-1)
        return x, P, torch.cat([xh, diagP[:, :3], pos_prev - xh], dim=1)

    x0 = torch.cat([pos_true[:, 0], torch.zeros((B, 3), **z)],
                   dim=1)[..., None]
    P0 = model.P0.expand(B, 6, 6)
    inputs = [A, Qdt, H, meas, pos_prev]
    if graph_steps is None:
        graph_steps = 128 if device.type == "cuda" else 0
    with torch.no_grad():
        if n == 0:  # one row: no step to run, empty columns (as JAX's scan)
            out = torch.zeros((B, 0, 9), **z)
        elif graph_steps and device.type == "cuda":
            out = _run_graphed(step, x0, P0, inputs, n,
                               min(graph_steps, n), graph_cache)
        else:
            out = _run_eager(step, x0, P0, inputs, n)
    cols = {"t": t[:, :-1], "pos": pos_prev, "xh": out[..., 0:3],
            "sig": out[..., 3:6], "err": out[..., 6:9]}
    return {k: v[0] for k, v in cols.items()} if single else cols


def fidelity_bin(cov_trace_half, fidlevels):
    """Fidelity label from localization covariance (SURVEY C18).

    ``covComp = 0.5 tr(P_xy)`` -> level 1 (best) / 2 / 3 against thresholds
    (reference/prepGPData.py:58-65). Vectorized over points; a tensor gives
    a tensor, anything else a numpy array."""
    if isinstance(cov_trace_half, torch.Tensor):
        c = cov_trace_half
        return torch.where(c < fidlevels[0], 1,
                           torch.where(c < fidlevels[1], 2, 3))
    c = np.asarray(cov_trace_half)
    return np.where(c < fidlevels[0], 1, np.where(c < fidlevels[1], 2, 3))
