"""Process group, device mesh and the collectives of the sharded paths.

Port of the JAX package's ``parallel/mesh.py``.  There one process drives
every device through ``shard_map``; here each rank is a process of its own
under ``torch.distributed`` and drives one device, ``cuda:{LOCAL_RANK}``
(NCCL) or the CPU (gloo).  The mesh is a ``DeviceMesh`` with the JAX
package's two axes:

* ``trials`` — data parallelism over channel realizations: each rank
  decodes its own realizations, and the metric sums are all-reduced over
  this axis once per call;
* ``model`` — the frame's channel uses (the operator's columns) split
  over ranks, the halo, dense and SV-domain decoders of :mod:`.banded`,
  :mod:`.tensor` and :mod:`.vamp_tp`.

JAX's collectives map as follows: ``lax.psum`` is :func:`all_reduce`,
``lax.all_gather(..., axis=1, tiled=True)`` is :func:`gather_dim1` and the
model ring's ``lax.ppermute`` is :func:`ring_shift`.  Complex tensors
travel as their real views, as the JAX halo exchange splits them into re/im
lanes.  A collective over an axis of one rank is skipped: it is the
identity.
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

TRIALS_AXIS = "trials"
MODEL_AXIS = "model"

# ``all_gather_into_tensor`` under its newer name where torch has it.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *, device=None,
                           timeout: Optional[float] = None) -> torch.device:
    """Start this rank's process group and return the rank's device.

    With no arguments it reads the environment ``torch.distributed.run``
    sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``); where
    there is none it starts a group of one rank, as a single JAX process is
    a mesh of one device.  ``device`` is where the rank runs: None means the
    card (``cuda:{LOCAL_RANK}``, set current before the group starts), and
    raises without one; ``'cpu'`` runs on the CPU.  The backend follows the
    device: NCCL on the card, gloo on the CPU (``backend`` overrides).
    ``timeout`` (seconds) bounds every collective, so that a rank that
    misses one raises instead of hanging.  Does nothing but return the
    device when a group is already running.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world_size = int(os.environ.get("WORLD_SIZE", "1")
                     if world_size is None else world_size)
    rank = int(os.environ.get("RANK", "0") if rank is None else rank)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size != 1:
            raise ValueError(f"a group of {world_size} ranks needs an "
                             "init_method or torch.distributed.run's "
                             "environment")
        # one rank: an in-process store, no address or port
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank, **kw)
    return dev


def make_mesh(trials: Optional[int] = None, model: int = 1,
              device_type: Optional[str] = None):
    """The ``(trials, model)`` device mesh over every rank of the running
    group (started with :func:`initialize_distributed` first if none is).

    ``trials`` defaults to ``world_size // model``.  Raises where the mesh
    needs more ranks than the group has, as the JAX package raises where it
    needs more devices; and, unlike JAX, where it leaves ranks out: a rank
    outside the mesh would have no realizations to decode.
    ``device_type`` defaults to the backend's (``cuda`` for NCCL, ``cpu``
    for gloo).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        initialize_distributed(device=device_type)
    world = dist.get_world_size()
    if trials is None:
        trials = world // model
    n = trials * model
    if n > world:
        raise ValueError(f"mesh {trials}x{model} needs {n} devices, "
                         f"have {world}")
    if n != world:
        raise ValueError(f"mesh {trials}x{model} covers {n} of {world} "
                         "ranks; it must cover every rank")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (trials, model),
                            mesh_dim_names=(TRIALS_AXIS, MODEL_AXIS))


class Axis(NamedTuple):
    """One axis of the mesh as this rank sees it: the process group, its
    size, this rank's index along it (``lax.axis_index``) and the global
    ranks in axis order."""

    group: object
    size: int
    index: int
    ranks: tuple


def axis_of(mesh, name: str) -> Axis:
    """The :class:`Axis` ``name`` of ``mesh`` for this rank."""
    group = mesh.get_group(name)
    return Axis(group=group, size=mesh.size(mesh.mesh_dim_names.index(name)),
                index=mesh.get_local_rank(name),
                ranks=tuple(dist.get_process_group_ranks(group)))


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.psum`` of ``t`` over ``axis`` (a new tensor; complex as its
    real view, bool as int32)."""
    if t.dtype == torch.bool:
        t = t.to(torch.int32)
    else:
        t = t.clone()
    if axis.size > 1:
        dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t,
                        group=axis.group)
    return t


def gather_dim1(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.all_gather(t, axis, axis=1, tiled=True)``: the shards of every
    rank of ``axis`` side by side along dim 1, in axis order."""
    if axis.size == 1:
        return t
    src = torch.view_as_real(t) if t.is_complex() else t
    src = src.contiguous()
    B, rest = src.shape[0], tuple(src.shape[1:])
    out = torch.empty((axis.size * B,) + rest, dtype=src.dtype,
                      device=src.device)
    _all_gather(out, src, group=axis.group)
    # (k B, n, ...) -> (B, k n, ...)
    out = out.reshape((axis.size, B) + rest).movedim(0, 1).reshape(
        (B, axis.size * rest[0]) + rest[1:])
    return torch.view_as_complex(out) if t.is_complex() else out


def ring_shift(buf: torch.Tensor, axis: Axis, step: int,
               cyclic: bool) -> torch.Tensor:
    """``lax.ppermute`` of a real ``buf`` one place along the ring of
    ``axis``: rank ``d`` sends to ``d + step`` and receives from
    ``d - step`` (``step`` is +1 or -1).  Without ``cyclic`` the ring does
    not wrap: the end that has no sender receives zeros and the end that
    has no receiver sends nothing, so every posted send meets its recv.  A
    ring of one rank under ``cyclic`` sends to itself, which
    ``torch.distributed`` refuses: the exchange is then a copy."""
    k, d = axis.size, axis.index
    if k == 1:
        return buf.clone() if cyclic else torch.zeros_like(buf)
    dst, src = d + step, d - step
    ops = []
    recv = torch.zeros_like(buf)
    if cyclic or 0 <= dst < k:
        ops.append(dist.P2POp(dist.isend, buf.contiguous(),
                              axis.ranks[dst % k], axis.group))
    if cyclic or 0 <= src < k:
        ops.append(dist.P2POp(dist.irecv, recv, axis.ranks[src % k],
                              axis.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def broadcast_float(value: Optional[float], device) -> float:
    """Global rank 0's ``value`` on every rank (None travels as NaN)."""
    t = torch.tensor([float("nan") if value is None else value],
                     dtype=torch.float64, device=device)
    if dist.get_world_size() > 1:
        dist.broadcast(t, src=0)
    return float(t.item())
