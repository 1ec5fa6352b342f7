"""Device mesh over torch.distributed ranks.

Port of ``redgnn_tpu/parallel/mesh.py``. Two axes:

  * ``data`` — query-parallel: each rank expands and propagates the
    frontiers of its own sub-batch; no communication until the loss and
    gradient sums.
  * ``edge`` — edge-parallel within a sub-batch: the per-hop edge list is
    sliced across the ranks of an edge group; each computes attention and
    messages for its slice and a partial segment sum, and a sum
    all-reduce over the group reassembles the per-node aggregates every
    hop (`models/layers.py:RelAttnLayer`).

One process is one rank. Ranks are laid out as ``jax.make_mesh((n_data,
n_edge), ("data", "edge"))`` lays out devices: edge-major within a data
row, rank = data_index * n_edge + edge_index.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "edge")
# every process group's collective timeout: a rank that skips a collective
# makes the others fail within this, rather than hang
DEFAULT_TIMEOUT_S = 60.0


class Mesh:
    """The (data, edge) layout of the default process group and this
    rank's place in it: its coordinates, its data and edge groups (None
    where the axis has one rank, the world group where it spans the
    world) and its device."""

    def __init__(self, n_data: int, n_edge: int, rank: int,
                 device: torch.device, backend: str,
                 groups: Dict[str, Optional[dist.ProcessGroup]]):
        self.shape = {"data": n_data, "edge": n_edge}
        self.rank = rank
        self.world_size = n_data * n_edge
        self.coords = {"data": rank // n_edge, "edge": rank % n_edge}
        self.device = device
        self.backend = backend
        self._groups = groups

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, axis: Optional[str] = None) -> int:
        return self.world_size if axis is None else self.shape[axis]

    def group(self, axis: Optional[str] = None):
        return None if axis is None else self._groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of ``t`` over ``axis`` (the whole world when
        None); a no-op over one rank. Returns ``t``."""
        if self.size(axis) > 1:
            dist.all_reduce(t, op=op, group=self.group(axis))
        return t

    def barrier(self) -> None:
        """Every rank reaches this point before any goes on."""
        self.all_reduce(torch.zeros(1, device=self.device))


class _AllReduceSum(torch.autograd.Function):
    """Sum all-reduce whose backward is the sum all-reduce of the
    cotangents: its exact adjoint (what
    ``torch.distributed.nn.functional.all_reduce`` computes, without its
    deprecation)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``mesh``'s ``axis`` group."""
    if mesh.size(axis) == 1:
        return t
    return _AllReduceSum.apply(t, mesh.group(axis))


def default_devices() -> list:
    """This host's CUDA devices, one per local rank, repeated for each
    host of a torchrun job (WORLD_SIZE / LOCAL_WORLD_SIZE hosts)."""
    n_local = torch.cuda.device_count()
    local = [torch.device("cuda", i) for i in range(n_local)]
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n_local or 1))
    hosts = max(1, int(os.environ.get("WORLD_SIZE", per_host))
                // max(per_host, 1))
    return local[:per_host] * hosts


def make_mesh(n_data: int = 1, n_edge: int = 1,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """An ``n_data x n_edge`` mesh over ``n_data * n_edge`` ranks.

    ``devices[r]`` is rank r's device (default: the CUDA devices,
    `default_devices`); fewer devices than ranks raise ValueError, as in
    the JAX package: nothing folds onto fewer devices unless the caller
    lists one device twice, which only gloo accepts (NCCL refuses two
    ranks on one GPU). ``backend`` defaults to NCCL on CUDA devices and
    gloo on the CPU; two ranks on one card take gloo, by the caller's
    choice, never as a fallback.

    If the default process group is not initialized yet, it is, with
    ``init_method`` (``env://`` by default, as torchrun sets it) and
    ``rank`` (default ``$RANK``, or 0); a 1x1 mesh needs no rendezvous.
    Every rank must call this with the same arguments, since each group
    is created collectively."""
    need = n_data * n_edge
    if n_data < 1 or n_edge < 1:
        raise ValueError(f"mesh {n_data}x{n_edge}: axis sizes must be >= 1")
    devices = [torch.device(d) for d in (
        devices if devices is not None else default_devices())]
    if len(devices) < need:
        raise ValueError(f"mesh {n_data}x{n_edge} needs {need} devices, "
                         f"have {len(devices)}")
    devices = devices[:need]
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if backend == "nccl" and len(set(map(str, devices))) < need:
        raise ValueError(
            f"NCCL refuses two ranks on one GPU ({[str(d) for d in devices]});"
            " pass backend='gloo' to share a card")
    to = timedelta(seconds=timeout)
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        if need == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, timeout=to)
        else:
            dist.init_process_group(backend,
                                    init_method=init_method or "env://",
                                    world_size=need, rank=rank, timeout=to)
    if dist.get_world_size() != need:
        raise ValueError(f"mesh {n_data}x{n_edge} needs a world of {need} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # every rank creates every group, in the same order
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    rows = {"edge": [[d * n_edge + e for e in range(n_edge)]
                     for d in range(n_data)],
            "data": [[d * n_edge + e for d in range(n_data)]
                     for e in range(n_edge)]}
    for axis in AXES:
        size = n_data if axis == "data" else n_edge
        groups[axis] = None
        if size == 1:
            continue
        if size == need:
            groups[axis] = dist.group.WORLD
            continue
        for ranks in rows[axis]:
            g = dist.new_group(ranks, timeout=to, backend=backend)
            if rank in ranks:
                groups[axis] = g
    return Mesh(n_data, n_edge, rank, device, backend, groups)


def destroy() -> None:
    """Tear the default process group down (after the last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()
