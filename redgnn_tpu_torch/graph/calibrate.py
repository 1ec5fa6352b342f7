"""Per-hop capacity calibration for fixed-shape frontier expansion.

Port of ``redgnn_tpu/graph/calibrate.py``. Every hop is
bounded by a (node_cap, edge_cap) budget, measured host-side by simulating
the exact expansion (numpy CSR walk) on sampled query batches, padded with
headroom and rounded up. Keeping the shapes static keeps every
intermediate comparable with the JAX package bit for bit, and leaves the
door open to CUDA-graph capture.

The static counts come from the native walker (`redgnn_tpu_torch.native`,
the port's copy of the JAX package's ``graphcore.cpp``, built at first
use), as in the JAX package; unlike there, a failed build raises instead
of falling back. The numpy edge walk (`_walk`) stays as the plain
reference the tests hold it to. The temporal counts come from a
frontier-bitmap walk over scipy's sparse adjacency (`_walk_bitmap`): the
same counts, at a cost that does not grow with the frontiers, which
saturate on temporal graphs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from redgnn_tpu_torch import native


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
    """Exact node/edge counts per hop for one batch of query heads (the
    native walker)."""
    return native.simulate_hops(rowptr, tail, n_ent, heads, n_layer)


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
    query head, so unique heads are walked once (the native walker) and
    broadcast back."""
    heads = np.asarray(heads, np.int64)
    uniq, inv = np.unique(heads, return_inverse=True)
    ncs, ecs = native.per_query_hop_counts(rowptr, tail, n_ent, uniq,
                                           n_layer)
    return ncs[inv], ecs[inv]


def per_query_counts_numpy(
    rowptr: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    heads: np.ndarray,
    n_layer: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """`per_query_counts` through the numpy edge walk (`_walk`), unique
    heads ``_WALK_CHUNK`` at a time (which bounds the walk's memory): the
    plain reference of the native walker."""
    heads = np.asarray(heads, np.int64)
    uniq, inv = np.unique(heads, return_inverse=True)
    ncs = np.zeros((len(uniq), n_layer + 1), np.int64)
    ecs = np.zeros((len(uniq), n_layer), np.int64)
    for lo in range(0, len(uniq), _WALK_CHUNK):
        sl = slice(lo, lo + _WALK_CHUNK)
        ncs[sl], ecs[sl] = _walk(rowptr, tail, n_ent, uniq[sl], n_layer)
    return ncs[inv], ecs[inv]


def _walk_bitmap(adj_t, deg: np.ndarray, n_ent: int, heads: np.ndarray,
                 n_layer: int, keep_frontier: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query node (n, n_layer+1) and edge (n, n_layer) counts of the
    expansion from ``heads`` with every frontier as one 0/1 column of a
    dense (n_ent, n) matrix: a hop's edge count is ``deg @ column`` and the
    next frontier the nonzeros of ``adj_t @ column``. ``adj_t`` is the
    (tail, head) adjacency (scipy CSR, multi-edges summed), ``deg`` the
    edges each node expands; ``keep_frontier`` keeps every node in the
    next frontier (its self-loop edge, which ``deg`` counts).

    The counts equal those of the edge walk (`_walk`); the work is
    |edges| x n per hop whatever the frontiers' sizes, which is what a
    graph whose L-hop neighbourhoods cover it (a whole-timeline temporal
    graph) needs, where the edge walk moves |edges| per query and hop."""
    n = len(heads)
    f = np.zeros((n_ent, n), np.float32)
    f[heads, np.arange(n)] = 1.0
    deg = deg.astype(np.float64)
    node_counts = np.zeros((n, n_layer + 1), np.int64)
    edge_counts = np.zeros((n, n_layer), np.int64)
    node_counts[:, 0] = 1
    for hop in range(n_layer):
        edge_counts[:, hop] = np.rint(deg @ f)
        nxt = (adj_t @ f) > 0
        if keep_frontier:
            nxt |= f > 0
        node_counts[:, hop + 1] = nxt.sum(0)
        f = nxt.astype(np.float32)
    return node_counts, edge_counts


def _bitmap_chunk(n_ent: int) -> int:
    """Queries walked together by `_walk_bitmap`: a frontier matrix of
    at most 64 MB."""
    return max(1, (16 << 20) // max(n_ent, 1))


def _adjacency_t(heads: np.ndarray, tails: np.ndarray, n_ent: int):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (np.ones(len(tails), np.float32), (tails, heads)),
        shape=(n_ent, n_ent))


def per_query_counts_dense(
    rowptr: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    heads: np.ndarray,
    n_layer: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """`per_query_counts` (the same counts) through the frontier-bitmap
    walk, for graphs whose frontiers saturate: unique heads are walked
    once and broadcast back."""
    heads = np.asarray(heads, np.int64)
    uniq, inv = np.unique(heads, return_inverse=True)
    rowptr = rowptr.astype(np.int64)
    deg = np.diff(rowptr)
    adj_t = _adjacency_t(np.repeat(np.arange(n_ent), deg), tail, n_ent)
    ncs = np.zeros((len(uniq), n_layer + 1), np.int64)
    ecs = np.zeros((len(uniq), n_layer), np.int64)
    step = _bitmap_chunk(n_ent)
    for lo in range(0, len(uniq), step):
        sl = slice(lo, lo + step)
        ncs[sl], ecs[sl] = _walk_bitmap(adj_t, deg, n_ent, uniq[sl],
                                        n_layer, keep_frontier=False)
    return ncs[inv], ecs[inv]


def per_query_counts_windowed(
    ekey: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    key_base: int,
    heads: np.ndarray,
    times: np.ndarray,
    window: int,
    n_layer: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-query counts of the time-windowed (extrapolation)
    expansion: a node of a query at time t expands the edges of its row
    with time in [t - window, t) plus its self-loop, which keeps it in the
    next frontier. ``ekey`` holds head * key_base + time per CSR slot,
    sorted. Queries sharing a time share the window's graph: each unique
    time is one bitmap walk (`_walk_bitmap`) of its unique heads."""
    heads = np.asarray(heads, np.int64)
    times = np.asarray(times, np.int64)
    e_head = ekey.astype(np.int64) // key_base
    e_time = ekey.astype(np.int64) % key_base
    ncs = np.zeros((len(heads), n_layer + 1), np.int64)
    ecs = np.zeros((len(heads), n_layer), np.int64)
    step = _bitmap_chunk(n_ent)
    for t in np.unique(times):
        rows = np.nonzero(times == t)[0]
        uniq, inv = np.unique(heads[rows], return_inverse=True)
        sel = (e_time >= max(int(t) - window, 0)) & (e_time < t)
        adj_t = _adjacency_t(e_head[sel], tail[sel].astype(np.int64), n_ent)
        deg = np.bincount(e_head[sel], minlength=n_ent) + 1  # + self-loop
        nc = np.zeros((len(uniq), n_layer + 1), np.int64)
        ec = np.zeros((len(uniq), n_layer), np.int64)
        for lo in range(0, len(uniq), step):
            sl = slice(lo, lo + step)
            nc[sl], ec[sl] = _walk_bitmap(adj_t, deg, n_ent, uniq[sl],
                                          n_layer, keep_frontier=True)
        ncs[rows], ecs[rows] = nc[inv], ec[inv]
    return ncs, ecs


def per_query_counts_windowed_native(
    ekey: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    key_base: int,
    heads: np.ndarray,
    times: np.ndarray,
    window: int,
    n_layer: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """`per_query_counts_windowed` (the same counts) through the native
    walker, as the JAX package computes them: each unique (head, time)
    pair is walked once, query by query, and broadcast back."""
    heads = np.asarray(heads, np.int64)
    times = np.asarray(times, np.int64)
    t_span = int(times.max()) + 1 if len(times) else 1
    uniq, inv = np.unique(heads * t_span + times, return_inverse=True)
    ncs, ecs = native.per_query_hop_counts_windowed(
        ekey, tail, n_ent, key_base, uniq // t_span, uniq % t_span, window,
        n_layer)
    return ncs[inv], ecs[inv]


def simulate_hops_windowed(
    ekey: np.ndarray,          # (n_edges,) head*key_base+time, sorted
    tail: np.ndarray,          # (n_edges,) CSR-ordered tails
    n_ent: int,
    key_base: int,
    heads: np.ndarray,
    times: np.ndarray,         # per-query time ids
    window: int,
    n_layer: int,
) -> Tuple[List[int], List[int]]:
    """Exact counts for the time-windowed (extrapolation) expansion of one
    batch, including the always-present self-loop edge per frontier
    node: the sum of its queries' rows (keys never collide across
    queries)."""
    nc, ec = per_query_counts_windowed(ekey, tail, n_ent, key_base, heads,
                                       times, window, n_layer)
    return [int(c) for c in nc.sum(0)], [int(c) for c in ec.sum(0)]


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


def _calibrate(sim_fn, n_queries, batch_size, n_ent, n_layer,
               n_sample_batches, headroom, seed) -> FrontierCaps:
    """Max frontier sizes of ``sim_fn(idx)`` over sampled batches of
    query indices, with headroom."""
    rng = np.random.default_rng(seed)
    node_max = [batch_size] + [0] * n_layer
    edge_max = [0] * n_layer
    for _ in range(n_sample_batches):
        idx = rng.choice(n_queries, size=min(batch_size, n_queries),
                         replace=False)
        nc, ec = sim_fn(idx)
        for i in range(n_layer):
            node_max[i + 1] = max(node_max[i + 1], nc[i + 1])
            edge_max[i] = max(edge_max[i], ec[i])
    node_caps = [batch_size] + [
        min(_round_up(int(c * headroom) + 8), _round_up(batch_size * n_ent))
        for c in node_max[1:]
    ]
    edge_caps = [_round_up(int(c * headroom) + 8) for c in edge_max]
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
    return _calibrate(
        lambda idx: simulate_hops(rowptr, tail, n_ent, query_heads[idx],
                                  n_layer),
        len(query_heads), batch_size, n_ent, n_layer, n_sample_batches,
        headroom, seed)


def calibrate_caps_windowed(
    ekey: np.ndarray,
    tail: np.ndarray,
    n_ent: int,
    key_base: int,
    query_heads: np.ndarray,
    query_times: np.ndarray,
    window: int,
    batch_size: int,
    n_layer: int,
    n_sample_batches: int = 6,
    headroom: float = 1.2,
    seed: int = 0,
) -> FrontierCaps:
    """`calibrate_caps` for the time-windowed expansion."""
    return _calibrate(
        lambda idx: simulate_hops_windowed(
            ekey, tail, n_ent, key_base, query_heads[idx], query_times[idx],
            window, n_layer),
        len(query_heads), batch_size, n_ent, n_layer, n_sample_batches,
        headroom, seed)
