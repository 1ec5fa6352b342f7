"""Local worker processes: one rank per process, joined with a deadline.

`run_mesh` starts ``n_data * n_edge`` fresh processes (the ``spawn``
start method: no CUDA state or open file is inherited), builds the mesh
in each over a file rendezvous of its own, calls ``target(mesh, *args)``
and returns every rank's return value. A rank that raises, or a run that
outlives its deadline, ends every process and raises here: a collective
that one rank skipped cannot hold the caller.

``target`` must be importable in the child: a module-level function of a
module whose import is cheap (this module imports nothing heavier than
torch, so the workers of the CLI and of the tests start in seconds).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          timeout: Optional[float] = 600.0) -> None:
    """``fn(rank, *args)`` in ``nprocs`` fresh processes; raises if one
    fails or the run outlives ``timeout`` seconds (None: no deadline; the
    ranks' collective timeout still ends a rank that waits on another
    that died). No process outlives the call."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + (float("inf") if timeout is None
                                   else timeout)
    try:
        while not ctx.join(timeout=max(0.1, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} worker processes still ran "
                                   f"after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


def _mesh_entry(rank: int, target: Callable, n_data: int, n_edge: int,
                devices: Sequence[str], backend: Optional[str],
                rdzv_dir: str, timeout: float, args: tuple) -> None:
    from redgnn_tpu_torch.parallel.mesh import destroy, make_mesh

    if torch.device(devices[rank]).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // len(devices)))
    mesh = make_mesh(n_data, n_edge, devices=devices, backend=backend,
                     init_method=f"file://{os.path.join(rdzv_dir, 'rdzv')}",
                     rank=rank, timeout=timeout)
    try:
        out = target(mesh, *args)
        torch.save(out, os.path.join(rdzv_dir, f"out_{rank}.pt"))
        # no rank tears its groups down while another still talks
        mesh.barrier()
    finally:
        destroy()


def run_mesh(target: Callable, n_data: int, n_edge: int,
             devices: Sequence[str], backend: Optional[str] = None,
             args: tuple = (), timeout: Optional[float] = 600.0,
             collective_timeout: float = 60.0) -> List[Any]:
    """Run ``target(mesh, *args)`` on every rank of an ``n_data x n_edge``
    mesh of local processes (rank r on ``devices[r]``) and return the
    ranks' return values, in rank order (``torch.save``-able values;
    tensors come back on the CPU)."""
    world = n_data * n_edge
    if len(devices) < world:
        raise ValueError(f"mesh {n_data}x{n_edge} needs {world} devices, "
                         f"have {len(devices)}")
    with tempfile.TemporaryDirectory() as rdzv_dir:
        spawn(_mesh_entry, world,
              (target, n_data, n_edge, [str(d) for d in devices[:world]],
               backend, rdzv_dir, collective_timeout, args), timeout)
        return [torch.load(os.path.join(rdzv_dir, f"out_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
