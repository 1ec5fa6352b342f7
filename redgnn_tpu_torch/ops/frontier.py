"""Fixed-shape, fully on-device frontier expansion.

Port of ``redgnn_tpu/ops/frontier.py`` with ``dedup_impl='sort'``. The
frontier is a flat array of node keys (``batch_idx * n_ent + entity``)
padded to a per-hop capacity with SENTINEL; incident edges are enumerated
from a degree cumsum over the device-resident CSR; next-hop nodes are
deduplicated by a stable sort + adjacent compare, which leaves the edge
list sorted by destination for the sorted-segment-sum kernel.

Every field of a `Frontier` equals the JAX package's for the same input.
Scatters never raise on out-of-range slots (as JAX's ``mode="drop"``):
dropped writes go to one spare slot past the end that is cut off, so the
expansion needs no host synchronisation.

Not ported yet: bitmap dedup (and its ``key_prefix``), ``etime``,
``extra_edge_slot``, ``edge_mask_fn`` and ``node_values``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Padding key. Max int32 so that padded entries sort to the end.
SENTINEL = 2 ** 31 - 1


class Frontier(NamedTuple):
    """One hop of expansion: the new node set and its incident edge list.

    Edge arrays have length ``edge_cap`` and are sorted by ``dst``; node
    arrays have length ``node_cap``. Integer fields are int32 tensors,
    flags bool tensors, counts 0-dim int32 tensors."""

    # --- nodes (next frontier) ---
    node_keys: torch.Tensor  # (node_cap,) sorted asc; SENTINEL = pad
    num_nodes: torch.Tensor  # () count of valid (non-pad) nodes
    # --- edges ---
    src: torch.Tensor        # (edge_cap,) slot in the *previous* frontier
    dst: torch.Tensor        # (edge_cap,) slot in node_keys (sorted asc)
    rel: torch.Tensor        # (edge_cap,) relation id
    batch: torch.Tensor      # (edge_cap,) query index within batch
    edge_id: torch.Tensor    # (edge_cap,) CSR slot of the fact edge
    edge_valid: torch.Tensor  # (edge_cap,) bool
    num_edges: torch.Tensor  # () true incident edge count (pre-clip)
    # --- overflow diagnostics ---
    edge_overflow: torch.Tensor  # () bool — edge count exceeded edge_cap
    node_overflow: torch.Tensor  # () bool — node count exceeded node_cap
    # fields of the unported variants, kept so the layout matches JAX
    key_prefix: torch.Tensor | None = None
    time: torch.Tensor | None = None
    src_values: torch.Tensor | None = None


def _scatter_drop(size: int, idx: torch.Tensor, values: torch.Tensor,
                  fill) -> torch.Tensor:
    """``full(size, fill).at[idx].set(values, mode="drop")`` for int64
    ``idx`` already mapped to ``size`` where the write must be dropped.
    Callers guarantee that kept writes to one slot agree."""
    out = torch.full((size + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:size]


def expand_frontier(
    rowptr: torch.Tensor,
    erel: torch.Tensor,
    etail: torch.Tensor,
    n_ent: int,
    node_keys: torch.Tensor,
    edge_cap: int,
    node_cap: int,
    edge_mask_fn=None,
    dedup_impl: str = "sort",
    key_space: int | None = None,
    etime: torch.Tensor | None = None,
    node_values: torch.Tensor | None = None,
) -> Frontier:
    """Expand one hop: gather all edges whose head is in the frontier.

    rowptr: (n_ent + 1,) CSR row offsets (rows = head); erel / etail:
    head-sorted relation / tail columns; node_keys: (prev_cap,) int32
    frontier keys, SENTINEL-padded; edge_cap / node_cap: static
    capacities of the emitted edge list and next frontier."""
    valid_node = node_keys != SENTINEL
    ent = torch.where(valid_node, node_keys % n_ent, 0).long()
    row_start = rowptr[ent]
    deg = torch.where(valid_node, rowptr[ent + 1] - row_start, 0)
    return expand_frontier_ranges(
        erel, etail, n_ent, node_keys, row_start, deg, edge_cap, node_cap,
        extra_edge_slot=None, edge_mask_fn=edge_mask_fn,
        dedup_impl=dedup_impl, key_space=key_space, etime=etime,
        node_values=node_values,
    )


def expand_frontier_ranges(
    erel: torch.Tensor,
    etail: torch.Tensor,
    n_ent: int,
    node_keys: torch.Tensor,
    row_start: torch.Tensor,   # (prev_cap,) first CSR slot per frontier node
    deg: torch.Tensor,         # (prev_cap,) edges per frontier node (0 for pads)
    edge_cap: int,
    node_cap: int,
    extra_edge_slot: torch.Tensor | None = None,
    edge_mask_fn=None,
    dedup_impl: str = "sort",
    key_space: int | None = None,
    etime: torch.Tensor | None = None,
    node_values: torch.Tensor | None = None,
) -> Frontier:
    """Core expansion over per-node edge ranges (sort dedup)."""
    if dedup_impl != "sort":
        raise NotImplementedError(
            f"dedup_impl={dedup_impl!r} is not ported; use 'sort'")
    for name, arg in (("extra_edge_slot", extra_edge_slot),
                      ("edge_mask_fn", edge_mask_fn), ("etime", etime),
                      ("node_values", node_values)):
        if arg is not None:
            raise NotImplementedError(f"expand_frontier {name} is not ported")
    dev = node_keys.device
    prev_cap = node_keys.shape[0]
    valid_node = node_keys != SENTINEL
    ent = torch.where(valid_node, node_keys % n_ent, 0)
    deg = deg.long()
    cum = torch.cumsum(deg, 0)  # int64 (JAX: int32; values agree)
    total_edges = cum[-1]
    start = cum - deg

    e_idx = torch.arange(edge_cap, dtype=torch.int64, device=dev)
    # Owner of each output edge slot: every node with deg > 0 marks its
    # start (starts are strictly increasing, so marks never collide) and
    # a cummax fills the slots after it.
    mark_at = torch.where((deg > 0) & (start < edge_cap), start, edge_cap)
    marker = _scatter_drop(
        edge_cap, mark_at, torch.arange(prev_cap, device=dev), 0)
    src = torch.cummax(marker, 0).values
    edge_valid = e_idx < total_edges
    src_c = torch.clamp(src, max=prev_cap - 1)

    base = torch.where(valid_node, node_keys - ent, 0).long()
    offset = row_start.long() - start
    edge_id = torch.where(edge_valid, e_idx + offset[src_c], 0)
    rel_e = erel[edge_id].long()
    tail_e = etail[edge_id].long()
    base_e = base[src_c]
    batch_e = base_e // n_ent
    tail_key = torch.where(edge_valid, base_e + tail_e, SENTINEL)

    # Deduplicate destination keys: stable sort + adjacent-compare; pads
    # (SENTINEL) land at the end.
    order = torch.argsort(tail_key, stable=True)
    sk = tail_key[order]
    is_new = torch.ones_like(sk, dtype=torch.bool)
    is_new[1:] = sk[1:] != sk[:-1]
    uid = torch.cumsum(is_new, 0) - 1  # dense unique rank per edge
    num_unique_valid = torch.sum(is_new & (sk != SENTINEL)).to(torch.int32)
    node_overflow = num_unique_valid > node_cap

    new_keys = _scatter_drop(
        node_cap, torch.where(uid < node_cap, uid, node_cap),
        sk.to(torch.int32), SENTINEL)
    dst = torch.clamp(uid, max=node_cap - 1)
    edge_valid_sorted = edge_valid[order] & (uid < node_cap)

    def masked(x):
        return torch.where(edge_valid_sorted, x[order], 0).to(torch.int32)

    return Frontier(
        node_keys=new_keys,
        num_nodes=num_unique_valid,
        src=src_c[order].to(torch.int32),
        dst=dst.to(torch.int32),
        rel=masked(rel_e),
        batch=masked(batch_e),
        edge_id=masked(edge_id),
        edge_valid=edge_valid_sorted,
        num_edges=total_edges.to(torch.int32),
        edge_overflow=total_edges > edge_cap,
        node_overflow=node_overflow,
    )


def align_old_to_new(
    old_keys: torch.Tensor,
    new_keys: torch.Tensor,
    old_values: torch.Tensor,
    node_cap: int,
    key_prefix: torch.Tensor | None = None,
) -> torch.Tensor:
    """Carry per-node state across a re-indexing hop.

    Each old node has a self-loop, so it appears in the new frontier; its
    new slot is found by binary search over the sorted new keys. New nodes
    get zeros. An old key missing from the new frontier (its self-loop
    clipped by an edge-cap overflow) is dropped rather than written into
    another node's slot (`frontier.py:332-343` of the JAX package)."""
    if key_prefix is not None:
        raise NotImplementedError("align_old_to_new key_prefix (bitmap "
                                  "dedup) is not ported")
    valid = old_keys != SENTINEL
    pos = torch.searchsorted(new_keys, old_keys)
    pos_c = torch.clamp(pos, 0, node_cap - 1)
    hit = valid & (pos >= 0) & (new_keys[pos_c] == old_keys)
    return _scatter_drop(node_cap, torch.where(hit, pos_c, node_cap),
                         old_values, 0)
