"""The (dp, mp) device mesh and its collectives (counterpart of
``mfgp_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
``shard_map``/GSPMD place the collectives. Here every device is a process
(a rank). On a node of GPUs the ranks are started by ``torchrun
--nproc-per-node <GPUs> script.py``, and each calls ``init_ranks()`` before
it makes a tensor: that binds rank r to ``cuda:LOCAL_RANK`` and joins the
process group with a finite timeout. A caller that starts its ranks
otherwise joins them with ``torch.distributed.init_process_group`` and
binds each to its device itself. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over those ranks with the
JAX package's two dimensions:

* ``"dp"``: data/restart parallelism (restart lanes, ensemble members),
* ``"mp"``: model/grid parallelism (grid rows, covariance columns).

Each rank runs the same function on its shard. ``jax.lax.axis_index(MP)``
is ``mesh.get_local_rank("mp")`` and ``jax.lax.psum`` an ``all_reduce``
over ``mesh.get_group("mp")``; an output that JAX leaves sharded comes back
whole on every rank (what a JAX caller's global array holds).

Every collective of the package goes through ``psum``, ``broadcast``,
``all_gather`` or ``gather_lanes`` here, which count their calls and
bytes in ``COLLECTIVES``. gloo takes CUDA tensors in some collectives
only: an operand of a collective outside ``GLOO_CUDA_OPS`` is staged
through the host explicitly and counted under ``host_staged``. NCCL is
never staged. Each collective is also the recorder's span ``par.comm``
(``utils/profiling``), and its bytes feed the recorder's counter
``par.collective_bytes``.
"""

from __future__ import annotations

import math
import os
import pickle
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from mfgp_tpu_torch.utils import profiling
from mfgp_tpu_torch.utils.device import resolve

DP_AXIS = "dp"
MP_AXIS = "mp"

# the collectives gloo runs on CUDA tensors in the torch of the H100
# machine (torch 2.11; checked there on 2 ranks): the others are staged
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})

COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
               "gather_objects": 0, "bytes": 0, "host_staged": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def init_ranks(backend: str = "nccl",
               timeout_s: float = 120.0) -> torch.device:
    """Join this process to the process group that ``torchrun`` starts, and
    return the rank's device.

    Reads the launcher's environment: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` (``RANK`` where absent) and the rendezvous
    ``MASTER_ADDR``/``MASTER_PORT``. With ``"nccl"`` the rank binds
    ``cuda:LOCAL_RANK`` (``torch.cuda.set_device``) before the group is
    made, and the group is bound to that device, so the ranks of one node
    land on their own GPUs (the port's tensors go to the current device);
    with ``"gloo"`` the rank's device is the CPU. A collective that waits
    longer than ``timeout_s`` fails, and NCCL then tears the process down:
    one failed rank stops the others within the timeout instead of leaving
    them blocked in a broadcast. ``make_mesh`` runs on the group as it
    is."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(
            "init_ranks needs the launcher's environment "
            f"({', '.join(missing)} unset): start the ranks with torchrun "
            "--nproc-per-node <n>")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    kw = {}
    if backend == "nccl":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        kw["device_id"] = device
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return device


def make_mesh(n_devices: int | None = None, mp: int | None = None,
              device="cuda"):
    """A 2D (dp, mp) ``DeviceMesh`` over the first ``n_devices`` ranks of
    the initialised process group (all of them by default).

    ``mp`` defaults to the largest power of two <= sqrt(n) that divides n
    (a square-ish mesh keeps both shard counts useful). One rank gives a
    (1, 1) mesh, so the same functions run unmodified on one device.
    Every rank of the group calls it (the mesh's groups are made
    collectively); a rank outside the first ``n_devices`` gets a mesh it
    is not part of (``get_coordinate()`` is None). ``device``: the ranks'
    device type, the card unless the caller asks for the CPU (without
    CUDA the default raises)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: every rank "
            "calls torch.distributed.init_process_group(backend, "
            "init_method or store, rank=, world_size=) first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if world < n_devices:
        raise ValueError(
            f"requested n_devices={n_devices} but the process group has "
            f"only {world} ranks; start one rank per device")
    if mp is None:
        mp = default_mp(n_devices)
    if n_devices % mp:
        raise ValueError(f"mp={mp} does not divide n_devices={n_devices}")
    ranks = torch.arange(n_devices).reshape(n_devices // mp, mp)
    return DeviceMesh(resolve(device).type, ranks,
                      mesh_dim_names=(DP_AXIS, MP_AXIS))


def default_mp(n: int) -> int:
    """The mp extent of an n-device mesh: the largest power of two <=
    sqrt(n) that divides n."""
    mp = 1
    while mp * 2 <= math.isqrt(n) and n % (mp * 2) == 0:
        mp *= 2
    return mp


def axis_size(mesh, dim: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(dim))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_rows(mesh, a: torch.Tensor, dim: str = MP_AXIS) -> torch.Tensor:
    """This rank's block of ``a``'s leading axis over ``dim`` (its length a
    multiple of the axis size): the JAX package's ``P(dim)`` layout."""
    n = axis_size(mesh, dim)
    b = a.shape[0] // n
    i = mesh.get_local_rank(dim)
    return a[i * b:(i + 1) * b]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _staged(op: str, t: torch.Tensor, group) -> bool:
    return (t.is_cuda and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def _count(op: str, nbytes: int, staged: bool) -> None:
    COLLECTIVES[op] += 1
    COLLECTIVES["bytes"] += int(nbytes)
    COLLECTIVES["host_staged"] += int(staged)
    profiling.count("par.collective_bytes", int(nbytes))


def psum(mesh, t: torch.Tensor, dim: str = MP_AXIS) -> torch.Tensor:
    """``jax.lax.psum(t, dim)``: the sum of ``t`` over the ranks of the
    mesh dimension, on every one of them (a new tensor)."""
    group = mesh.get_group(dim)
    staged = _staged("all_reduce", t, group)
    with profiling.span("par.comm", device=t.is_cuda):
        buf = t.detach().to("cpu" if staged else t.device, copy=True)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        _count("all_reduce", buf.numel() * buf.element_size(), staged)
        return buf.to(t.device)


def broadcast(mesh, t: torch.Tensor, src: int,
              dim: str = MP_AXIS) -> torch.Tensor:
    """``t`` of the rank whose index along ``dim`` is ``src``, on every
    rank of that dimension (a new tensor; other ranks' ``t`` gives only
    the shape and dtype). The JAX package broadcasts a panel with a psum
    to which every other rank adds zeros: the same values."""
    group = mesh.get_group(dim)
    staged = _staged("broadcast", t, group)
    with profiling.span("par.comm", device=t.is_cuda):
        buf = t.detach().to("cpu" if staged else t.device, copy=True)
        dist.broadcast(buf, src=dist.get_global_rank(group, src),
                       group=group)
        _count("broadcast", buf.numel() * buf.element_size(), staged)
        return buf.to(t.device)


def all_gather(mesh, t: torch.Tensor, dim: str = MP_AXIS,
               axis: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) of the mesh dimension, in the
    order of their index, concatenated along ``axis``: a ``P(dim)``
    sharded output made whole on every rank."""
    group = mesh.get_group(dim)
    staged = _staged("all_gather", t, group)
    with profiling.span("par.comm", device=t.is_cuda):
        buf = t.detach().to("cpu" if staged else t.device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(axis_size(mesh, dim))]
        dist.all_gather(parts, buf, group=group)
        _count("all_gather", buf.numel() * buf.element_size() * len(parts),
               staged)
        return torch.cat(parts, dim=axis).to(t.device)


def gather_lanes(mesh, st: dict, dim: str = DP_AXIS) -> dict:
    """A host state (a dict of numpy arrays, lanes on the leading axis) with
    every rank's lanes of the mesh dimension, concatenated in rank order
    (``all_gather_object``): an ensemble sharded over dp made whole on
    every rank."""
    parts = [None] * axis_size(mesh, dim)
    with profiling.span("par.comm"):
        dist.all_gather_object(parts, st, group=mesh.get_group(dim))
        _count("gather_objects", sum(len(pickle.dumps(p)) for p in parts),
               False)
    return {k: np.concatenate([p[k] for p in parts]) for k in st}
