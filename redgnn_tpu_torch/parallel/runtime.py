"""Multi-process runtime initialization.

Port of ``redgnn_tpu/parallel/runtime.py``. The JAX package reads
``JAX_COORDINATOR_ADDRESS`` (or TPU pod metadata) and calls
``jax.distributed.initialize``; here the coordinator is torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) and the call is ``torch.distributed.init_process_group``
with NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from redgnn_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(device: Optional[str] = "cuda",
                           timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the process group that torchrun's environment describes (a
    no-op without it: the run stays single-process, with a warning).

    ``device`` picks the backend: NCCL for ``cuda`` (this process then
    uses ``cuda:$LOCAL_RANK``), gloo for ``cpu``. Returns a summary dict
    for logging."""
    coordinator = all(os.environ.get(k) for k in _ENV)
    on_cuda = torch.device(device or "cuda").type == "cuda"
    if coordinator and not dist.is_initialized():
        if on_cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if on_cuda else "gloo",
            init_method="env://",
            world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]),
            timeout=timedelta(seconds=timeout))
    up = dist.is_initialized()
    local = (torch.cuda.device_count() if on_cuda
             and torch.cuda.is_available() else 1)
    info = {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": local,
        # one device per process
        "global_devices": dist.get_world_size() if up else local,
    }
    if info["process_count"] == 1 and not coordinator:
        print("warning: --distributed requested but no coordinator "
              "environment found (RANK, WORLD_SIZE, MASTER_ADDR, "
              "MASTER_PORT, as torchrun sets them); running single-process")
    return info


def default_mesh_shape(n_devices: int, prefer_edge: int = 2):
    """data x edge factorization: keep the edge group within one host's
    ICI domain (edge-psum every hop), put the rest on data (one psum per
    step)."""
    n_edge = 1
    while (n_edge * 2 <= prefer_edge and n_devices % (n_edge * 2) == 0):
        n_edge *= 2
    return n_devices // n_edge, n_edge
