"""Sorted-segment sum: the hand-written Hopper kernel and its plain version.

Port of ``redgnn_tpu/ops/segment_pallas.py``. The CUDA kernel
(``csrc/segment_sum_sorted.cu``) gives each segment's contiguous edge
range to one warp and writes every output row once, without atomics;
its source says what bounds it and why. ``segment_sum_sorted_reference``
is the same function in plain PyTorch (masked ``index_add_``): tensors on
the CPU take it, tensors on a CUDA device always launch the kernel.

The ``kmax`` contract of ``segment_sum_pallas_checked`` is kept: output
nodes come in blocks of ``bn``, edges in chunks of ``chunk``; block j
consumes at most ``kmax`` chunks from the first chunk that holds one of
its edges, drops the rest, and the overflow flag says it happened.
"""

from __future__ import annotations

import ctypes

import torch

CHUNK = 1024
BN = 512

_LIB = None


def _kernel():
    """The ctypes handle of the built kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        from redgnn_tpu_torch import _build

        lib = _build.load("segment_sum_sorted")
        fn = lib.segment_sum_sorted_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
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
    `segment_sum_sorted_reference`. The kernel has no backward yet.
    """
    if data.device.type == "cpu":
        return segment_sum_sorted_reference(data, segment_ids, num_segments,
                                            kmax, chunk, bn)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    _check(data, segment_ids, num_segments)
    if data.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the sorted-segment-sum kernel has no backward yet")
    data = data.to(torch.float32)
    if not (data.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("segment sum wants contiguous data and segment_ids")
    limit, overflow = _block_limits(segment_ids, num_segments, kmax,
                                    chunk, bn)
    n_edges, dim = data.shape
    out = torch.empty((num_segments, dim), dtype=torch.float32,
                      device=data.device)
    if num_segments == 0 or dim == 0:
        return out, overflow
    fn = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), segment_ids.data_ptr(),
                 None if limit is None else limit.data_ptr(),
                 out.data_ptr(), n_edges, dim, num_segments, bn, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_sorted kernel launch failed: "
                           f"cudaError {err}")
    segment_sum_sorted_checked.launches += 1
    return out, overflow


segment_sum_sorted_checked.launches = 0


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """`segment_sum_pallas`: the sum without the overflow flag, no kmax."""
    return segment_sum_sorted_checked(data, segment_ids, num_segments)[0]
