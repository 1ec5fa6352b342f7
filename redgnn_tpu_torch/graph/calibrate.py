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


# unique query heads walked together by per_query_counts
_WALK_CHUNK = 256


def _round_up(x: int, m: int = 256) -> int:
    return int(-(-x // m) * m)


@dataclass(frozen=True)
class FrontierCaps:
    """Static per-hop shape budget: node_caps has n_layer+1 entries."""

    node_caps: Tuple[int, ...]
    edge_caps: Tuple[int, ...]

    def covers(self, other: "FrontierCaps") -> bool:
        return all(a >= b for a, b in zip(self.node_caps, other.node_caps)) \
            and all(a >= b for a, b in zip(self.edge_caps, other.edge_caps))

    def union(self, other: "FrontierCaps") -> "FrontierCaps":
        return FrontierCaps(
            tuple(max(a, b) for a, b in zip(self.node_caps,
                                            other.node_caps)),
            tuple(max(a, b) for a, b in zip(self.edge_caps,
                                            other.edge_caps)))


def _walk(rowptr: np.ndarray, tail: np.ndarray, n_ent: int,
          heads: np.ndarray, n_layer: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query node (n, n_layer+1) and edge (n, n_layer) counts of the
    exact expansion from ``heads``, all queries walked together (a
    vectorized numpy CSR walk, the host-side mirror of
    ops.frontier.expand_frontier). Keys are ``query * n_ent + entity``,
    so queries never share a node and a key's query is ``key // n_ent``."""
    rowptr = rowptr.astype(np.int64)
    n = len(heads)
    keys = np.arange(n, dtype=np.int64) * n_ent + heads
    node_counts = np.zeros((n, n_layer + 1), np.int64)
    edge_counts = np.zeros((n, n_layer), np.int64)
    node_counts[:, 0] = 1
    for hop in range(n_layer):
        ents = keys % n_ent
        batch_base = keys - ents  # query * n_ent
        starts = rowptr[ents]
        degs = rowptr[ents + 1] - starts
        edge_counts[:, hop] = np.bincount(keys // n_ent, weights=degs,
                                          minlength=n)
        total = int(degs.sum())
        node_of_e = np.repeat(np.arange(len(keys)), degs)
        excl = np.cumsum(degs) - degs
        within = np.arange(total) - excl[node_of_e]
        edge_id = starts[node_of_e] + within
        tails = tail[edge_id].astype(np.int64) + batch_base[node_of_e]
        keys = np.unique(tails)
        node_counts[:, hop + 1] = np.bincount(keys // n_ent, minlength=n)
    return node_counts, edge_counts


def simulate_hops(
    rowptr: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    heads: np.ndarray,
    n_layer: int,
) -> Tuple[List[int], List[int]]:
    """Exact node/edge counts per hop for one batch of query heads."""
    nc, ec = _walk(rowptr, tail, n_ent, np.asarray(heads, np.int64), n_layer)
    return [int(c) for c in nc.sum(0)], [int(c) for c in ec.sum(0)]


def per_query_counts(
    rowptr: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    heads: np.ndarray,
    n_layer: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-query frontier counts: (n, n_layer+1) nodes, (n, n_layer)
    edges.

    Composite batch keys (b*n_ent + ent) never collide across batch
    elements, so any batch's frontier counts are exactly the sum of its
    queries' rows — this is what makes permutation-exact capacity
    calibration possible (`caps_for_batches`). Counts depend only on the
    query head, so unique heads are walked once (``_WALK_CHUNK`` at a
    time, which bounds the walk's memory) and broadcast back."""
    heads = np.asarray(heads, np.int64)
    uniq, inv = np.unique(heads, return_inverse=True)
    ncs = np.zeros((len(uniq), n_layer + 1), np.int64)
    ecs = np.zeros((len(uniq), n_layer), np.int64)
    for lo in range(0, len(uniq), _WALK_CHUNK):
        sl = slice(lo, lo + _WALK_CHUNK)
        ncs[sl], ecs[sl] = _walk(rowptr, tail, n_ent, uniq[sl], n_layer)
    return ncs[inv], ecs[inv]


def caps_for_batches(node_pq: np.ndarray, edge_pq: np.ndarray,
                     batch_size: int, slack: int = 8) -> FrontierCaps:
    """Exact caps covering every contiguous batch of the given per-query
    count rows (row order = the actual epoch batch order). With these caps
    a frontier overflow cannot happen in this epoch: no sampling headroom,
    no replay."""
    n = len(node_pq)
    nb = max(-(-n // batch_size), 1)
    pad = nb * batch_size - n
    npad = np.concatenate(
        [node_pq, np.zeros((pad, node_pq.shape[1]), np.int64)])
    epad = np.concatenate(
        [edge_pq, np.zeros((pad, edge_pq.shape[1]), np.int64)])
    nmax = npad.reshape(nb, batch_size, -1).sum(1).max(0)
    emax = epad.reshape(nb, batch_size, -1).sum(1).max(0)
    node_caps = [batch_size] + [_round_up(int(c) + slack) for c in nmax[1:]]
    edge_caps = [_round_up(int(c) + slack) for c in emax]
    return FrontierCaps(tuple(node_caps), tuple(edge_caps))


def caps_upper_bound(node_pq: np.ndarray, edge_pq: np.ndarray,
                     batch_size: int, slack: int = 8) -> FrontierCaps:
    """Permutation-independent exact upper bound: the sum of the top-b
    per-query counts. Valid for any shuffle of the split, at the cost of
    looser padding than `caps_for_batches`."""

    def topb(a):
        k = min(batch_size, len(a))
        s = np.partition(a, len(a) - k, axis=0)[len(a) - k:]
        return s.sum(0)

    nmax = topb(node_pq)
    emax = topb(edge_pq)
    node_caps = [batch_size] + [_round_up(int(c) + slack) for c in nmax[1:]]
    edge_caps = [_round_up(int(c) + slack) for c in emax]
    return FrontierCaps(tuple(node_caps), tuple(edge_caps))


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
