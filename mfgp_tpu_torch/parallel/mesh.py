"""The (dp, mp) device mesh and its collectives (counterpart of
``mfgp_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
``shard_map``/GSPMD place the collectives. Here every device is a process
(a rank) that the caller starts and joins with
``torch.distributed.init_process_group``; the mesh is a
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
never staged.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch
import torch.distributed as dist

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


def psum(mesh, t: torch.Tensor, dim: str = MP_AXIS) -> torch.Tensor:
    """``jax.lax.psum(t, dim)``: the sum of ``t`` over the ranks of the
    mesh dimension, on every one of them (a new tensor)."""
    group = mesh.get_group(dim)
    staged = _staged("all_reduce", t, group)
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
    buf = t.detach().to("cpu" if staged else t.device, copy=True)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", buf.numel() * buf.element_size(), staged)
    return buf.to(t.device)


def all_gather(mesh, t: torch.Tensor, dim: str = MP_AXIS,
               axis: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) of the mesh dimension, in the
    order of their index, concatenated along ``axis``: a ``P(dim)``
    sharded output made whole on every rank."""
    group = mesh.get_group(dim)
    staged = _staged("all_gather", t, group)
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
    dist.all_gather_object(parts, st, group=mesh.get_group(dim))
    _count("gather_objects", sum(len(pickle.dumps(p)) for p in parts), False)
    return {k: np.concatenate([p[k] for p in parts]) for k in st}
