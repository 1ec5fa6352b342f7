"""Metric aggregation across batches (MRR, Hits@k)."""

from __future__ import annotations

from typing import Dict, Iterable


def combine_metric_sums(partials: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Combine per-batch partial sums into MRR / Hits@{1,3,10}.

    Equivalent to `cal_performance` (`Static/transductive/utils.py:17-21`)
    applied to the concatenated rank list.
    """
    tot = {"rr_sum": 0.0, "h1_sum": 0.0, "h3_sum": 0.0, "h10_sum": 0.0,
           "count": 0.0}
    for p in partials:
        for k in tot:
            tot[k] += float(p[k])
    n = max(tot["count"], 1.0)
    return {
        "mrr": tot["rr_sum"] / n,
        "h1": tot["h1_sum"] / n,
        "h3": tot["h3_sum"] / n,
        "h10": tot["h10_sum"] / n,
        "n": tot["count"],
    }
