"""Filtered ranking with the reference's exact tie semantics.

Port of ``redgnn_tpu/ops/ranking.py`` (static part). The reference ranks
on the host with scipy (`Static/transductive/utils.py:7-14`):

    scores     = scores - min(scores, axis=1) + 1e-8
    full_rank  = rankdata(-scores, method='average', axis=1)
    filter_rank= rankdata(-(scores * filters), method='min', axis=1)
    rank(a)    = full_rank(a) - filter_rank(a) + 1     for each answer a

Here both ranks come from one stable argsort per row and tie-group scans
over the sorted order, for all rows at once.
"""

from __future__ import annotations

import torch


def _sorted_groups(s: torch.Tensor):
    """Stable descending order of each row, its positions, and the
    tie-group boundaries of the sorted values."""
    n = s.shape[-1]
    order = torch.argsort(-s, dim=-1, stable=True)
    sorted_s = torch.gather(s, -1, order)
    pos = torch.arange(n, dtype=torch.float32, device=s.device).expand_as(s)
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[..., 1:] = sorted_s[..., 1:] != sorted_s[..., :-1]
    return order, pos, is_new


def _unsort(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(values).scatter_(-1, order, values)


def _avg_rank_desc(s: torch.Tensor) -> torch.Tensor:
    """Average-tie rank of every element of each row, descending order."""
    n = s.shape[-1]
    order, pos, is_new = _sorted_groups(s)
    group_start = torch.cummax(torch.where(is_new, pos, 0.0), -1).values
    rev_new = torch.ones_like(is_new)
    rev_new[..., :-1] = is_new[..., 1:]
    # group end: reverse cummin of (next boundary - 1)
    group_end = torch.flip(torch.cummin(torch.flip(
        torch.where(rev_new, pos, float(n)), [-1]), -1).values, [-1])
    return _unsort(order, (group_start + group_end) / 2.0 + 1.0)


def _min_rank_desc(s: torch.Tensor) -> torch.Tensor:
    """Min-tie rank (rankdata method='min') of each row, descending."""
    order, pos, is_new = _sorted_groups(s)
    min_sorted = torch.cummax(torch.where(is_new, pos, 0.0), -1).values + 1.0
    return _unsort(order, min_sorted)


def filtered_rank_all(
    scores: torch.Tensor,   # (B, n_ent) raw model scores
    filters: torch.Tensor,  # (B, n_ent) 1.0 for known-true tails (all splits)
) -> torch.Tensor:
    """Per-entity filtered rank, replicating cal_ranks for every candidate.

    Returns (B, n_ent) float ranks; the caller gathers at answers."""
    s = scores - torch.min(scores, dim=1, keepdim=True).values + 1e-8
    sf = s * filters
    return _avg_rank_desc(s) - _min_rank_desc(sf) + 1.0


def rank_metric_sums(
    scores: torch.Tensor,
    labels: torch.Tensor,   # (B, n_ent) 1.0 at answer entities (0 on padded rows)
    filters: torch.Tensor,
) -> dict:
    """Partial sums for MRR / Hits@k over all answers in the batch
    (`cal_performance`, `Static/transductive/utils.py:17-21`)."""
    ranks = filtered_rank_all(scores, filters)
    lab = labels.to(scores.dtype)
    return {
        "rr_sum": torch.sum(lab / torch.clamp(ranks, min=1e-9)),
        "h1_sum": torch.sum(lab * (ranks <= 1.0)),
        "h3_sum": torch.sum(lab * (ranks <= 3.0)),
        "h10_sum": torch.sum(lab * (ranks <= 10.0)),
        "count": torch.sum(lab),
    }
