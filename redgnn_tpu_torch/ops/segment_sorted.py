"""Sorted-segment sum: the hand-written Hopper kernel and its plain version.

Port of ``redgnn_tpu/ops/segment_pallas.py``. The CUDA kernel
(``csrc/segment_sum_sorted.cu``) gives each block of threads a run of
consecutive segments, splits their edges evenly among its workers and
adds boundary partials in a fixed order, without atomics; its source says
what bounds it and why. ``_launch_plan`` picks its grid and its load
width. ``segment_sum_sorted_reference`` is the same function in plain
PyTorch (masked ``index_add_``): tensors on the CPU take it, tensors on a
CUDA device always launch the kernel. ``segment_sum_sorted_checked.launches``
counts the kernel's launches through either entry point.

``segment_sum_sorted`` is differentiable in ``data``. On the card the
kernel sits in a ``torch.autograd.Function`` whose backward is the JAX
package's ``_bwd`` (`segment_pallas.py:169-174`): a gather of the output
gradient at the segment ids, zero where the id was dropped. That backward
is an XLA gather in the JAX package, not a TPU kernel, so it is a masked
``index_select`` here; on the CPU the plain version's own autograd gives
the same rows. ``segment_sum_sorted_checked`` (the ``kmax`` contract) is
forward only, as ``segment_sum_pallas_checked`` is.

The ``kmax`` contract of ``segment_sum_pallas_checked`` is kept: output
nodes come in blocks of ``bn``, edges in chunks of ``chunk``; block j
consumes at most ``kmax`` chunks from the first chunk that holds one of
its edges, drops the rest, and the overflow flag says it happened.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

CHUNK = 1024
BN = 512
# Segments a block owns: the kernel's kSegs (csrc/segment_sum_sorted.cu),
# which sets its grid; the plan mirrors it. Timed on the H100 at the
# serving hops (time_kernel_variants.py): 16 is as fast as or faster than
# 4, 8, 32 and 64 there.
SEGS_PER_BLOCK = 16

_LIB = None


class LaunchPlan(NamedTuple):
    grid: int    # blocks; block b owns segments [16 b, 16 (b + 1))
    vec: bool    # 16-byte loads (D % 4 == 0, data 16-byte aligned)


def _launch_plan(n_seg: int, dim: int, data_ptr: int) -> LaunchPlan:
    """The kernel's grid and load width for one call. The kernel splits
    each block's edges among its workers itself, so the edge count does
    not enter the plan. ``vec`` is the wrapper's choice and is passed to
    the kernel. How many blocks share a segment run's column passes (wide
    rows, few segments) is the C entry point's choice alone."""
    grid = -(-n_seg // SEGS_PER_BLOCK)
    vec = dim % 4 == 0 and data_ptr % 16 == 0
    return LaunchPlan(grid=grid, vec=vec)


def _kernel():
    """The ctypes handle of the built kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        from redgnn_tpu_torch import _build

        lib = _build.load("segment_sum_sorted")
        fn = lib.segment_sum_sorted_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def _block_limits(segment_ids: torch.Tensor, num_segments: int,
                  kmax: int | None, chunk: int, bn: int):
    """(limit, overflow): per node block, the first edge position it may
    no longer consume (None without ``kmax``), and whether any block
    needed more than ``kmax`` chunks — `segment_pallas.py:117-125`."""
    e = segment_ids.shape[0]
    dev = segment_ids.device
    if not kmax:
        return None, torch.zeros((), dtype=torch.bool, device=dev)
    nb = -(-num_segments // bn)
    block_lo = torch.arange(nb, dtype=torch.int32, device=dev) * bn
    starts = torch.searchsorted(segment_ids, block_lo)
    ends = torch.searchsorted(segment_ids, block_lo + bn)
    chunk0 = starts // chunk
    chunk1 = torch.where(ends > starts, (ends - 1) // chunk, chunk0 - 1)
    nchunks = chunk1 - chunk0 + 1
    overflow = torch.any(nchunks > kmax)
    limit = torch.clamp((chunk0 + kmax) * chunk, max=e)
    return limit.to(torch.int64).contiguous(), overflow


def _check(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    if data.dim() != 2 or segment_ids.dim() != 1 \
            or data.shape[0] != segment_ids.shape[0]:
        raise ValueError(
            f"segment sum wants data (E, D) and segment_ids (E,), got "
            f"{tuple(data.shape)} and {tuple(segment_ids.shape)}")
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_ids must be int32, got {segment_ids.dtype}")
    if data.device != segment_ids.device:
        raise ValueError(f"data on {data.device}, segment_ids on "
                         f"{segment_ids.device}")
    if num_segments < 0 or num_segments >= 2 ** 31 - 1:
        raise ValueError(f"num_segments out of range: {num_segments}")


def segment_sum_sorted_reference(data: torch.Tensor,
                                 segment_ids: torch.Tensor,
                                 num_segments: int,
                                 kmax: int | None = None,
                                 chunk: int = CHUNK, bn: int = BN):
    """Plain PyTorch version of `segment_sum_sorted_checked`: masked
    ``index_add_`` into one spare row that is cut off. Returns
    (out (num_segments, D) float32, overflow () bool)."""
    _check(data, segment_ids, num_segments)
    data = data.to(torch.float32)
    limit, overflow = _block_limits(segment_ids, num_segments, kmax,
                                    chunk, bn)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    if limit is not None and num_segments > 0:
        blk = torch.clamp(segment_ids, 0, num_segments - 1) // bn
        pos = torch.arange(segment_ids.shape[0], device=data.device)
        keep = keep & (pos < limit[blk])
    idx = torch.where(keep, segment_ids,
                      torch.full_like(segment_ids, num_segments))
    out = torch.zeros((num_segments + 1, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, idx.long(), data)
    return out[:num_segments], overflow


def _launch(data: torch.Tensor, segment_ids: torch.Tensor,
            num_segments: int, limit: torch.Tensor | None,
            bn: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that passed `_check` and return
    the (N, D) sum; raises on what the kernel does not take."""
    if not data.is_cuda:
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype != torch.float32:
        data = data.to(torch.float32)
    if not (data.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("segment sum wants contiguous data and segment_ids")
    n_edges, dim = data.shape
    out = data.new_empty((num_segments, dim))
    if num_segments == 0 or dim == 0:
        return out
    ptr = data.data_ptr()
    args = (ptr, segment_ids.data_ptr(),
            None if limit is None else limit.data_ptr(), out.data_ptr(),
            n_edges, dim, num_segments, bn,
            int(_launch_plan(num_segments, dim, ptr).vec))
    fn = _kernel()
    index = data.get_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:  # the kernel launches on the current device
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:  # a failed launch, or arguments the C entry point refuses
        raise RuntimeError(f"segment_sum_sorted kernel launch failed or was "
                           f"refused ({n_edges} edges): cudaError {err}")
    segment_sum_sorted_checked.launches += 1
    return out


def segment_sum_sorted_checked(data: torch.Tensor, segment_ids: torch.Tensor,
                               num_segments: int, kmax: int | None = None,
                               chunk: int = CHUNK, bn: int = BN):
    """Sum rows of ``data`` by ascending ``segment_ids`` into
    ``num_segments`` rows; ids outside [0, num_segments) are dropped.

    Returns (out (num_segments, D) float32, overflow () bool tensor);
    overflow means some block of ``bn`` segments needed more than
    ``kmax`` chunks of ``chunk`` edges and its tail was dropped
    (`segment_sum_pallas_checked`). ``kmax=None`` drops nothing.

    A CUDA tensor launches the kernel (and counts one launch in
    ``segment_sum_sorted_checked.launches``); a CPU tensor takes
    `segment_sum_sorted_reference`. Forward only on either device, as
    `segment_sum_pallas_checked` is (a chunk budget that drops edges has
    no defined gradient): ``data`` that requires grad is refused; the
    differentiable entry point is `segment_sum_sorted`.
    """
    if data.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "segment_sum_sorted_checked is forward only; differentiate "
            "segment_sum_sorted")
    if data.device.type == "cpu":
        return segment_sum_sorted_reference(data, segment_ids, num_segments,
                                            kmax, chunk, bn)
    _check(data, segment_ids, num_segments)
    limit, overflow = _block_limits(segment_ids, num_segments, kmax,
                                    chunk, bn)
    return _launch(data, segment_ids, num_segments, limit, bn), overflow


segment_sum_sorted_checked.launches = 0


class _SegmentSumSorted(torch.autograd.Function):
    """The kernel with the JAX package's custom VJP around it."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        return _launch(data.detach(), segment_ids, num_segments, None, BN)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return _gather_grad(g, segment_ids, ctx.num_segments), None, None


def _gather_grad(g: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """d_data of the segment sum: ``g[seg]``, zero where the forward
    dropped the edge. The JAX package masks ``seg < N`` only; the port's
    forward also drops negative ids, so both sides are masked."""
    # dropped ids read one zero row appended to g: one gather, no second
    # pass over the (E, D) result
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    idx = torch.where(keep, segment_ids, num_segments)
    return torch.cat([g, g.new_zeros((1, g.shape[1]))]).index_select(0, idx)


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """`segment_sum_pallas`: the sum without the overflow flag, no kmax;
    differentiable in ``data``. The serving and training paths' call: on
    the card it launches the kernel and builds nothing else."""
    if data.device.type == "cpu":
        return segment_sum_sorted_reference(data, segment_ids,
                                            num_segments)[0]
    _check(data, segment_ids, num_segments)
    if data.requires_grad and torch.is_grad_enabled():
        return _SegmentSumSorted.apply(data, segment_ids, num_segments)
    return _launch(data, segment_ids, num_segments, None, BN)
