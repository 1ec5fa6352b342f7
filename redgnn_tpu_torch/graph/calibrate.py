"""Per-hop capacity calibration for fixed-shape frontier expansion.

Port of ``redgnn_tpu/graph/calibrate.py`` (static part). Every hop is
bounded by a (node_cap, edge_cap) budget, measured host-side by simulating
the exact expansion (numpy CSR walk) on sampled query batches, padded with
headroom and rounded up. Keeping the shapes static keeps every
intermediate comparable with the JAX package bit for bit, and leaves the
door open to CUDA-graph capture.

The numpy walk is the JAX package's own path when its native walker is
unbuilt; the native walker is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def _round_up(x: int, m: int = 256) -> int:
    return int(-(-x // m) * m)


@dataclass(frozen=True)
class FrontierCaps:
    """Static per-hop shape budget: node_caps has n_layer+1 entries."""

    node_caps: Tuple[int, ...]
    edge_caps: Tuple[int, ...]


def simulate_hops(
    rowptr: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    heads: np.ndarray,
    n_layer: int,
) -> Tuple[List[int], List[int]]:
    """Exact node/edge counts per hop for one batch of query heads (a
    vectorized numpy CSR walk, the host-side mirror of
    ops.frontier.expand_frontier)."""
    rowptr = rowptr.astype(np.int64)
    keys = np.arange(len(heads), dtype=np.int64) * n_ent + heads
    node_counts = [len(keys)]
    edge_counts = []
    for _ in range(n_layer):
        ents = keys % n_ent
        batch_base = keys - ents  # b * n_ent
        starts = rowptr[ents]
        degs = rowptr[ents + 1] - starts
        total = int(degs.sum())
        edge_counts.append(total)
        if total == 0:
            keys = np.empty(0, dtype=np.int64)
            node_counts.append(0)
            continue
        node_of_e = np.repeat(np.arange(len(keys)), degs)
        excl = np.concatenate([[0], np.cumsum(degs)[:-1]])
        within = np.arange(total) - excl[node_of_e]
        edge_id = starts[node_of_e] + within
        tails = tail[edge_id].astype(np.int64) + batch_base[node_of_e]
        keys = np.unique(tails)
        node_counts.append(len(keys))
    return node_counts, edge_counts


def calibrate_caps(
    rowptr: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    query_heads: np.ndarray,
    batch_size: int,
    n_layer: int,
    n_sample_batches: int = 6,
    headroom: float = 1.2,
    seed: int = 0,
) -> FrontierCaps:
    """Measure max frontier sizes over sampled batches, add headroom."""
    rng = np.random.default_rng(seed)
    node_max = [batch_size] + [0] * n_layer
    edge_max = [0] * n_layer
    n = len(query_heads)
    for _ in range(n_sample_batches):
        idx = rng.choice(n, size=min(batch_size, n), replace=False)
        nc, ec = simulate_hops(rowptr, tail, n_ent, query_heads[idx], n_layer)
        for i in range(n_layer):
            node_max[i + 1] = max(node_max[i + 1], nc[i + 1])
            edge_max[i] = max(edge_max[i], ec[i])
    node_caps = [batch_size] + [
        min(_round_up(int(c * headroom) + 8), _round_up(batch_size * n_ent))
        for c in node_max[1:]
    ]
    edge_caps = [_round_up(int(c * headroom) + 8) for c in edge_max]
    return FrontierCaps(tuple(node_caps), tuple(edge_caps))
