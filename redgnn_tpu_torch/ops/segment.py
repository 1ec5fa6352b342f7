"""Segment reductions — the aggregation primitive of relational propagation.

Port of ``redgnn_tpu/ops/segment.py:segment_sum``. ``impl='pallas'``
(the name is kept so configs carry over) goes to the sorted-segment-sum
kernel of :mod:`redgnn_tpu_torch.ops.segment_sorted`; ``impl='xla'`` is a
plain masked ``index_add_``.
"""

from __future__ import annotations

import torch

from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    indices_are_sorted: bool = False,
    impl: str = "xla",
) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets keyed by
    ``segment_ids``. Out-of-range ids are dropped, as JAX's
    ``mode="drop"`` does (torch's ``index_add_`` would raise, so they go
    to a spare row that is cut off)."""
    if impl == "pallas":
        if not indices_are_sorted:
            raise ValueError("segment_sum impl='pallas' requires sorted ids"
                             " (dedup_impl='sort' frontiers)")
        return segment_sum_sorted(data, segment_ids, num_segments)
    if impl == "scan":
        raise NotImplementedError("segment_sum impl='scan' is not ported")
    if impl != "xla":
        raise ValueError(f"unknown segment_sum impl {impl!r}")
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    idx = torch.where(keep, segment_ids.long(),
                      torch.full_like(segment_ids, num_segments,
                                      dtype=torch.long))
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, idx, data)[:num_segments]
