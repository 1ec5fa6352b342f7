"""Segment reductions — the aggregation primitives of relational propagation.

Port of ``redgnn_tpu/ops/segment.py``. `segment_sum` has the JAX
package's three implementations under their old names, so configs carry
over: ``impl='xla'`` is a plain masked ``index_add_`` (any id order);
``impl='pallas'`` goes to the sorted-segment-sum kernel of
:mod:`redgnn_tpu_torch.ops.segment_sorted`; ``impl='scan'`` is the
cumsum + boundary-difference formulation. The last two need ascending
ids. `segment_max`, `segment_softmax`, `segment_topk_mask` and
`segment_normalize_l1` are plain PyTorch.

torch's scatters raise on an out-of-range index where JAX's
``mode="drop"`` drops the write, so dropped ids go to one spare row past
the end that is cut off.
"""

from __future__ import annotations

import torch

from redgnn_tpu_torch.ops.segment_sorted import (
    _gather_grad,
    segment_sum_sorted,
)

_NEG_INF = -1e30


def _spare_row_ids(segment_ids: torch.Tensor, num_segments: int
                   ) -> torch.Tensor:
    """int64 ids with every id outside [0, num_segments) sent to the
    spare row ``num_segments``."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    return torch.where(keep, ids, num_segments)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    indices_are_sorted: bool = False,
    impl: str = "xla",
) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets keyed by
    ``segment_ids``. Out-of-range ids are dropped."""
    if impl == "pallas":
        if not indices_are_sorted:
            raise ValueError("segment_sum impl='pallas' requires sorted ids"
                             " (dedup_impl='sort' frontiers)")
        return segment_sum_sorted(data, segment_ids, num_segments)
    if impl == "scan":
        if not indices_are_sorted:
            raise ValueError("segment_sum impl='scan' requires sorted ids")
        return _segment_sum_scan(data, segment_ids, num_segments)
    if impl != "xla":
        raise ValueError(f"unknown segment_sum impl {impl!r}")
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, _spare_row_ids(segment_ids, num_segments),
                          data)[:num_segments]


class _SegmentSumScan(torch.autograd.Function):
    """Sorted-segment sum as cumsum + boundary difference, with the JAX
    package's custom VJP (a masked gather of the output gradient).

    Accumulation order differs from a sequential scatter by prefix
    cancellation, bounded by O(total magnitude * eps): fine for training,
    not for strict parity tests (use ``impl='xla'`` there)."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        e = data.shape[0]
        out_shape = (num_segments,) + tuple(data.shape[1:])
        if e == 0 or num_segments == 0:
            return data.new_zeros(out_shape)
        p = torch.cumsum(data.to(torch.float32), 0)
        pos = torch.arange(e, device=data.device)
        # last edge position of each segment (-1 when the segment is empty)
        last = torch.full((num_segments + 1,), -1, dtype=torch.int64,
                          device=data.device).scatter_reduce_(
            0, _spare_row_ids(segment_ids, num_segments), pos, "amax",
            include_self=True)[:num_segments]
        # last position of any non-empty segment before this one
        prev_last = torch.cat([last.new_full((1,), -1),
                               torch.cummax(last, 0).values[:-1]])
        wide = (slice(None),) + (None,) * (data.dim() - 1)
        pe = torch.where((last >= 0)[wide], p[last.clamp(min=0)], 0.0)
        ps = torch.where(((prev_last >= 0) & (last >= 0))[wide],
                         p[prev_last.clamp(min=0)], 0.0)
        return (pe - ps).to(data.dtype)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        flat = g.reshape(g.shape[0], -1)
        d = _gather_grad(flat, segment_ids, ctx.num_segments)
        return d.reshape((segment_ids.shape[0],) + g.shape[1:]), None, None


def _segment_sum_scan(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    return _SegmentSumScan.apply(data, segment_ids, num_segments)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Per-segment maximum; empty segments get -inf (clamped to -1e30)."""
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]),
                     float("-inf"), dtype=data.dtype, device=data.device)
    ids = _spare_row_ids(segment_ids, num_segments)
    ids = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = out.scatter_reduce(0, ids, data, "amax",
                             include_self=True)[:num_segments]
    return torch.clamp(out, min=_NEG_INF)


def _rows_of(per_segment: torch.Tensor, seg: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """``per_segment[min(seg, num_segments - 1)]``."""
    return per_segment[seg.long().clamp(max=num_segments - 1)]


def segment_softmax(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Numerically stable softmax within each segment (segment-max ->
    exp -> segment-sum -> divide). ``valid`` masks padded entries: they
    contribute nothing and get 0."""
    if valid is not None:
        seg = torch.where(valid, segment_ids, num_segments)
    else:
        seg = segment_ids
    m = segment_max(data, seg, num_segments, indices_are_sorted)
    z = data - _rows_of(m, seg, num_segments)
    # clamp BEFORE exp: valid entries have z <= 0 already; a masked entry's
    # z can be huge, and exp(z) = inf would poison the backward pass
    # through the where below (0 * inf = NaN)
    centered = torch.exp(torch.clamp(z, max=0.0))
    if valid is not None:
        centered = torch.where(valid, centered, 0.0)
    denom = segment_sum(centered, seg, num_segments, indices_are_sorted)
    denom = torch.clamp(denom, min=1e-20)
    out = centered / _rows_of(denom, seg, num_segments)
    if valid is not None:
        out = torch.where(valid, out, 0.0)
    return out


def segment_topk_mask(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    k: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Boolean mask of the k largest entries within each segment.

    Entry e is kept iff its rank within its segment (by descending value,
    ties broken by position) is < k. The JAX package sorts once with a
    lexsort over (segment, -value, position); here two stable sorts do
    the same: by -value (stable, so ties keep their position order), then
    by segment."""
    e = data.shape[0]
    if valid is not None:
        seg = torch.where(valid, segment_ids, num_segments)
        vals = torch.where(valid, data, float("-inf"))
    else:
        seg = segment_ids
        vals = data
    by_value = torch.argsort(-vals, stable=True)
    order = by_value[torch.argsort(seg[by_value], stable=True)]
    seg_sorted = seg[order]
    is_new = torch.ones(e, dtype=torch.bool, device=data.device)
    is_new[1:] = seg_sorted[1:] != seg_sorted[:-1]
    # rank within segment = position - start-of-segment position
    pos = torch.arange(e, device=data.device)
    seg_start = torch.cummax(torch.where(is_new, pos, 0), 0).values
    keep = torch.zeros(e, dtype=torch.bool, device=data.device)
    keep[order] = (pos - seg_start) < k
    if valid is not None:
        keep &= valid
    return keep


def segment_normalize_l1(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """L1-normalize non-negative scores within each segment."""
    if valid is not None:
        seg = torch.where(valid, segment_ids, num_segments)
        data = torch.where(valid, data, 0.0)
    else:
        seg = segment_ids
    denom = segment_sum(data, seg, num_segments, indices_are_sorted)
    denom = torch.clamp(denom, min=1e-20)
    return data / _rows_of(denom, seg, num_segments)
