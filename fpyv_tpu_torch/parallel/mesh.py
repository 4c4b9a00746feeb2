"""The rank layout and the env-bank sharding helpers (mirrors
``fpyv_tpu.parallel.mesh``).

JAX drives every device from one process: a ``Mesh`` of devices with one
"env" axis, ``shard_map`` over it, ``pmean`` inside. The port runs one
process per GPU under ``torch.distributed``, so a :class:`Mesh` is one
rank's view of a 1-D group of ranks: the axis name, this rank, the group's
size, the process group and this rank's device.

- :func:`make_mesh` joins the process group that torchrun's ``env://``
  variables describe, or one set up from an explicit ``init_method``,
  ``rank`` and ``world_size``; with neither it is the one-rank mesh, as
  JAX's ``make_mesh`` is on one device.
- The backend is explicit: ``"nccl"`` for CUDA, ``"gloo"`` for the CPU by
  default. NCCL takes one rank per GPU, so two ranks asking for one device
  under NCCL raise; gloo lets ranks share a card (the one-card checks).
- :func:`shard_leading_axis` takes this rank's rows of every leaf,
  :func:`replicate` broadcasts rank 0's tensors, :func:`pmean_` averages
  tensors over the ranks with one all-reduce.
- ``PpoConfig.axis_name`` names the mesh axis the learner's gradients
  average over (:func:`axis_mesh`); the port's mesh has one axis, over
  every rank of the job.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.distributed as dist

from fpyv_tpu_torch.device import divisor, resolve_device
from fpyv_tpu_torch.envs.base import Part, tree_map_tensors

ENV_AXIS = "env"

# the mesh whose process group this process joined (torch.distributed's
# default group is per process too)
_JOINED: Optional["Mesh"] = None


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh of ``size`` ranks."""

    axis: str
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None  # the process group; None for the one-rank mesh

    def part(self, n: int) -> Part:
        """This rank's contiguous rows ``[r·n/W, (r+1)·n/W)`` of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        k = n // self.size
        return Part(self.rank * k, (self.rank + 1) * k, n)


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current)


def _join(axis, init_method, rank, world_size, backend, device) -> Mesh:
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and (dev.type != "cuda" or dev.index not in (None, local_rank)):
        raise ValueError(
            f"NCCL takes one rank per GPU, cuda:LOCAL_RANK: rank {rank} (local rank "
            f"{local_rank}) asks for {dev}; two ranks on one device make NCCL refuse or "
            "hang. Give each rank its own GPU, or pass backend='gloo' to share one")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} asks for {dev}, but this host has "
                             f"{torch.cuda.device_count()} CUDA devices; pass device= to place "
                             "it (with backend='gloo' to share a card)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return Mesh(axis, dist.get_rank(), dist.get_world_size(), dev, dist.group.WORLD)


def make_mesh(axis: str = ENV_AXIS, *, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              backend: Optional[str] = None, device=None) -> Mesh:
    """The 1-D mesh over every rank of the job, this process's view of it.

    - Once this process has joined a group, the mesh over it (``device``,
      when given, must be this rank's).
    - With ``init_method``, ``rank`` and ``world_size`` (a ``file://`` or
      ``tcp://`` store), or torchrun's ``RANK``/``WORLD_SIZE`` variables
      (``env://``), it joins that group. Each rank takes ``device`` (by
      default ``cuda:LOCAL_RANK``) and calls ``torch.cuda.set_device``
      before it joins. ``backend`` defaults to ``"nccl"`` on CUDA and
      ``"gloo"`` on the CPU.
    - Otherwise it is the one-rank mesh on ``device`` (CUDA unless told).

    JAX's ``make_mesh(n_devices)`` can take the first n devices; a rank
    cannot leave the job's group, so the mesh is always the whole job.
    """
    global _JOINED
    explicit = init_method is not None
    if _JOINED is not None:
        if explicit:
            raise ValueError("this process has joined a process group already")
        if device is not None and not _same_device(torch.device(device), _JOINED.device):
            raise ValueError(f"this rank's device is {_JOINED.device}, not {device}")
        return replace(_JOINED, axis=axis)
    if explicit or "WORLD_SIZE" in os.environ:
        if not explicit:
            init_method = "env://"
            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if rank is None or world_size is None:
            raise ValueError("init_method needs rank and world_size")
        _JOINED = _join(axis, init_method, rank, world_size, backend, device)
        return _JOINED
    return Mesh(axis, 0, 1, resolve_device(device))


def make_hybrid_mesh(axis: str = ENV_AXIS) -> Mesh:
    """JAX's DCN-aware mesh. torchrun numbers the ranks host-major already,
    so this is :func:`make_mesh`'s 1-D mesh: NCCL's all-reduce rings within
    a host over NVLink and between hosts over the network on its own, which
    is what JAX's hybrid device order arranges for ICI and DCN."""
    return make_mesh(axis=axis)


def axis_mesh(axis: str) -> Mesh:
    """The mesh a learner's ``PpoConfig.axis_name`` averages over: the
    group this process joined, or the one-rank mesh, over which an average
    is the identity."""
    if _JOINED is None:
        return Mesh(axis, 0, 1, torch.device("cpu"))
    return replace(_JOINED, axis=axis)


def shard_leading_axis(tree, mesh: Mesh):
    """This rank's rows ``[r·n/W, (r+1)·n/W)`` of every tensor's leading
    axis (copies, so the whole bank can be freed); raises when the size
    ``W`` does not divide a leaf's ``n``. Leaves that are not tensors pass
    through."""
    def take(x):
        lo, hi, _ = mesh.part(x.shape[0])
        return x[lo:hi].clone()

    return tree_map_tensors(take, tree)


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    tree_map_tensors(out.append, tree)
    return out


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of a tree (a module's parameters and buffers)
    from rank 0, in place: one broadcast of their flattened concatenation
    (float64, which holds float32 and integer buffers exactly). Returns the
    tree."""
    tensors = _tensors(tree)
    if mesh.size > 1 and tensors:
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
        dist.broadcast(flat, src=0, group=mesh.group)
        _unflatten(flat, tensors)
    return tree


def _unflatten(flat: torch.Tensor, tensors) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n


@torch.no_grad()
def psum_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks in place (one all-reduce)."""
    if mesh.size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


@torch.no_grad()
def pmean_(tensors, mesh: Mesh) -> None:
    """Average the tensors over the ranks in place, as JAX's ``pmean``: ONE
    all-reduce of their flattened float32 concatenation, a sum (gloo has no
    average) and then a true division by the size."""
    tensors = list(tensors)
    if mesh.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    psum_(flat, mesh)
    _unflatten(flat / divisor(mesh.size, flat), tensors)


def pmean_tree(info: dict, mesh: Mesh) -> dict:
    """A dict of 0-d tensors averaged over the ranks (the learner's info)."""
    if mesh.size == 1:
        return info
    keys = list(info)
    stacked = torch.stack([info[k].detach().to(torch.float32) for k in keys])
    pmean_([stacked], mesh)
    return {k: stacked[i].to(info[k].dtype) for i, k in enumerate(keys)}
