"""Fixed-shape, fully on-device frontier expansion.

Port of ``redgnn_tpu/ops/frontier.py``. The frontier is a flat array of
node keys (``batch_idx * n_ent + entity``) padded to a per-hop capacity
with SENTINEL; incident edges are enumerated from a degree cumsum over
the device-resident CSR. Next-hop nodes are deduplicated either by a
stable sort + adjacent compare (``dedup_impl='sort'``), which leaves the
edge list sorted by destination for the sorted-segment-sum kernel, or by
a presence bitmap + prefix sum over the (batch x entity) key space
(``'bitmap'``), which leaves the edges in expansion order.

Every integer and boolean field of a `Frontier` equals the JAX package's
for the same input. Scatters never raise on out-of-range slots (as JAX's
``mode="drop"``): dropped writes go to one spare slot past the end that
is cut off, so the expansion needs no host synchronisation. Index
arithmetic is int64 inside (JAX: int32; the values agree).

The owner of each output edge slot (`slot_owner`) is a search of the
slot in the degree cumsum: on a CUDA device the hand-written kernel
``csrc/slot_owner.cu``, on the CPU ``torch.searchsorted``. The JAX
package scatters a marker at each node's first slot and fills the rest
with ``cummax`` (a search lowers slowly on a TPU); the integers are the
same.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from redgnn_tpu_torch import _build
from redgnn_tpu_torch.ops.gather import gather_rows_packed

# Padding key. Max int32 so that padded entries sort to the end.
SENTINEL = 2 ** 31 - 1


class Frontier(NamedTuple):
    """One hop of expansion: the new node set and its incident edge list.

    Edge arrays have length ``edge_cap``. With ``dedup_impl='sort'`` they
    are sorted by ``dst`` (what the 'scan' and 'pallas' segment sums
    need); with ``'bitmap'`` they stay in expansion order (non-decreasing
    ``src``). ``node_keys`` is sorted ascending in both schemes; node
    arrays have length ``node_cap``. Integer fields are int32 tensors,
    flags bool tensors, counts 0-dim int32 tensors."""

    # --- nodes (next frontier) ---
    node_keys: torch.Tensor  # (node_cap,) sorted asc; SENTINEL = pad
    num_nodes: torch.Tensor  # () count of valid (non-pad) nodes
    # --- edges ---
    src: torch.Tensor        # (edge_cap,) slot in the *previous* frontier
    dst: torch.Tensor        # (edge_cap,) slot in node_keys
    rel: torch.Tensor        # (edge_cap,) relation id
    batch: torch.Tensor      # (edge_cap,) query index within batch
    edge_id: torch.Tensor    # (edge_cap,) CSR slot of the fact edge
    edge_valid: torch.Tensor  # (edge_cap,) bool
    num_edges: torch.Tensor  # () true incident edge count (pre-clip)
    # --- overflow diagnostics ---
    edge_overflow: torch.Tensor  # () bool — edge count exceeded edge_cap
    node_overflow: torch.Tensor  # () bool — node count exceeded node_cap
    # bitmap dedup only: (key_space,) int32 key -> slot + 1 prefix table,
    # so align_old_to_new is one gather instead of a binary search
    key_prefix: torch.Tensor | None = None
    # (edge_cap,) per-edge timestamp, when ``etime`` is passed
    time: torch.Tensor | None = None
    # (edge_cap, D) per-edge source-node values (hidden states), when
    # ``node_values`` is passed (bitmap dedup only); differentiable in
    # ``node_values`` (ops/gather.gather_rows_packed)
    src_values: torch.Tensor | None = None


def scatter_drop(size: int, idx: torch.Tensor, values: torch.Tensor,
                  fill) -> torch.Tensor:
    """``full(size, fill).at[idx].set(values, mode="drop")`` for int64
    ``idx`` already mapped to ``size`` where the write must be dropped.
    Callers guarantee that kept writes to one slot agree."""
    out = torch.full((size + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:size]


def slot_owner_plain(cum: torch.Tensor, edge_cap: int) -> torch.Tensor:
    """`slot_owner` in plain PyTorch: ``searchsorted(cum, min(e, total -
    1), right=True)`` over the slots ``e``, ``total`` kept on the device
    (the CPU path and the card's yardstick)."""
    e = torch.arange(edge_cap, dtype=torch.int64, device=cum.device)
    return torch.searchsorted(cum, torch.minimum(e, cum[-1] - 1), right=True)


def slot_owner_cummax(cum: torch.Tensor, edge_cap: int) -> torch.Tensor:
    """`slot_owner` the JAX package's way: each node with edges marks its
    first slot (starts strictly increase, so marks never collide) and a
    cummax fills the slots after it (tests and the card's smoke run)."""
    p = cum.shape[0]
    deg = torch.diff(cum, prepend=cum.new_zeros(1))
    start = cum - deg
    mark_at = torch.where((deg > 0) & (start < edge_cap), start, edge_cap)
    marker = scatter_drop(edge_cap, mark_at,
                          torch.arange(p, device=cum.device), 0)
    return torch.cummax(marker, 0).values


def slot_owner(cum: torch.Tensor, edge_cap: int) -> torch.Tensor:
    """Owner of each of ``edge_cap`` output edge slots: slot ``e`` belongs
    to the first node ``i`` with ``cum[i] > min(e, total - 1)``, ``total =
    cum[-1]`` (slots past the total take the last node with edges; every
    slot 0 when total is 0), as the JAX package's scatter-and-cummax fill.

    cum: (P,) int64, the inclusive cumsum of nonnegative degrees, P >= 1.
    Returns (edge_cap,) int64. A CUDA tensor launches the kernel
    (``csrc/slot_owner.cu``, counted in ``slot_owner.launches``), which
    reads ``total`` on the device (no host synchronisation); a CPU tensor
    takes `slot_owner_plain`."""
    if cum.dim() != 1 or cum.shape[0] == 0 or cum.dtype != torch.int64:
        raise ValueError(f"slot_owner wants a non-empty (P,) int64 cumsum, "
                         f"got {tuple(cum.shape)} {cum.dtype}")
    if cum.device.type == "cpu":
        return slot_owner_plain(cum, edge_cap)
    cum = cum.contiguous()
    out = torch.empty(edge_cap, dtype=torch.int64, device=cum.device)
    if edge_cap == 0:
        return out
    fn = _build.entry("slot_owner", "slot_owner_i64",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p])
    _build.launch(fn, (cum.data_ptr(), out.data_ptr(), cum.shape[0],
                       edge_cap), cum,
                  f"slot_owner ({cum.shape[0]} nodes, {edge_cap} slots)")
    slot_owner.launches += 1
    return out


slot_owner.launches = 0


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
    extra_edge_slot: torch.Tensor | None = None,  # (prev_cap,) one extra edge
    edge_mask_fn=None,
    dedup_impl: str = "sort",
    key_space: int | None = None,  # B * n_ent, required for 'bitmap'
    etime: torch.Tensor | None = None,  # (n_edges,) timestamps (temporal)
    node_values: torch.Tensor | None = None,  # (prev_cap, D) float32
) -> Frontier:
    """Core expansion over per-node edge ranges.

    ``row_start`` / ``deg`` describe a contiguous CSR sub-row per frontier
    node. ``extra_edge_slot`` appends one extra edge per valid node, as
    the node's last slot (the always-included self-loop of a windowed
    temporal graph). ``edge_mask_fn(edge_id, batch, rel) -> bool`` keeps
    or drops edges BEFORE deduplication: masked edges generate no
    frontier nodes. ``etime`` is gathered per edge into ``Frontier.time``.
    ``node_values`` is fetched per edge at the expansion's own ``src``
    into ``Frontier.src_values`` under bitmap dedup and silently dropped
    under sort (which permutes the edges afterwards).

    ``dedup_impl``: 'sort' (edges come out sorted by destination,
    O(E log E)) or 'bitmap' (presence bitmap + prefix sum over
    ``key_space``; edges stay in expansion order, O(key_space + E))."""
    if dedup_impl not in ("sort", "bitmap"):
        raise ValueError(f"dedup_impl must be 'sort' or 'bitmap', got "
                         f"{dedup_impl!r}")
    dev = node_keys.device
    prev_cap = node_keys.shape[0]
    valid_node = node_keys != SENTINEL
    ent = torch.where(valid_node, node_keys % n_ent, 0)
    deg = deg.long()
    deg_eff = deg if extra_edge_slot is None else deg + valid_node.long()
    cum = torch.cumsum(deg_eff, 0)
    total_edges = cum[-1]
    start = cum - deg_eff

    e_idx = torch.arange(edge_cap, dtype=torch.int64, device=dev)
    # owner of each output edge slot: a search of the slot in cum
    src = slot_owner(cum, edge_cap)
    edge_valid = e_idx < total_edges
    src_c = torch.clamp(src, max=prev_cap - 1)

    if dedup_impl != "bitmap":
        node_values = None
    base = torch.where(valid_node, node_keys - ent, 0).long()
    # every per-node value an edge needs, as one row table
    if extra_edge_slot is not None:
        node_tab = torch.stack([start, row_start.long(), deg,
                                extra_edge_slot.long(), base], 1)
    else:
        node_tab = torch.stack([row_start.long() - start, base], 1)
    if node_values is not None:
        rows, src_values = gather_rows_packed(node_tab, node_values, src_c,
                                              start, deg_eff)
    else:
        rows, src_values = node_tab[src_c], None
    if extra_edge_slot is not None:
        within = e_idx - rows[:, 0]
        edge_id = torch.where(within < rows[:, 2], rows[:, 1] + within,
                              rows[:, 3])
        base_e = rows[:, 4]
    else:
        edge_id = e_idx + rows[:, 0]
        base_e = rows[:, 1]
    edge_id = torch.where(edge_valid, edge_id, 0)
    rel_e = erel[edge_id].long()
    tail_e = etail[edge_id].long()
    time_e = None if etime is None else etime[edge_id].long()
    batch_e = base_e // n_ent
    if edge_mask_fn is not None:
        edge_valid = edge_valid & edge_mask_fn(edge_id, batch_e, rel_e)
    tail_key = torch.where(edge_valid, base_e + tail_e, SENTINEL)

    if dedup_impl == "bitmap":
        if key_space is None:
            raise ValueError("dedup_impl='bitmap' needs key_space")
        present = scatter_drop(
            key_space, torch.clamp(tail_key, max=key_space),
            torch.ones_like(edge_valid), False)
        prefix = torch.cumsum(present, 0, dtype=torch.int32)
        num_unique_valid = prefix[-1]
        # an invalid edge (SENTINEL) reads the last prefix entry; its dst
        # is node_cap - 1 and it stays invalid
        uid = prefix[torch.clamp(tail_key, max=key_space - 1)].long() - 1
        dst = torch.where(edge_valid, torch.clamp(uid, max=node_cap - 1),
                          node_cap - 1)
        slot = prefix.long() - 1
        new_keys = scatter_drop(
            node_cap, torch.where(present & (slot < node_cap), slot, node_cap),
            torch.arange(key_space, dtype=torch.int32, device=dev), SENTINEL)
        order = None
        edge_valid_out = edge_valid & (uid < node_cap)
    else:
        # stable sort + adjacent-compare; pads (SENTINEL) land at the end
        order = torch.argsort(tail_key, stable=True)
        sk = tail_key[order]
        is_new = torch.ones_like(sk, dtype=torch.bool)
        is_new[1:] = sk[1:] != sk[:-1]
        uid = torch.cumsum(is_new, 0) - 1  # dense unique rank per edge
        num_unique_valid = torch.sum(
            is_new & (sk != SENTINEL)).to(torch.int32)
        new_keys = scatter_drop(
            node_cap, torch.where(uid < node_cap, uid, node_cap),
            sk.to(torch.int32), SENTINEL)
        dst = torch.clamp(uid, max=node_cap - 1)
        prefix = src_values = None
        edge_valid_out = edge_valid[order] & (uid < node_cap)
        src_c = src_c[order]

    def masked(x):
        if x is None:
            return None
        x = x if order is None else x[order]
        return torch.where(edge_valid_out, x, 0).to(torch.int32)

    return Frontier(
        node_keys=new_keys,
        num_nodes=num_unique_valid,
        src=src_c.to(torch.int32),
        dst=dst.to(torch.int32),
        rel=masked(rel_e),
        batch=masked(batch_e),
        edge_id=masked(edge_id),
        edge_valid=edge_valid_out,
        num_edges=total_edges.to(torch.int32),
        edge_overflow=total_edges > edge_cap,
        node_overflow=num_unique_valid > node_cap,
        key_prefix=prefix,
        time=masked(time_e),
        src_values=src_values,
    )


def align_old_to_new(
    old_keys: torch.Tensor,
    new_keys: torch.Tensor,
    old_values: torch.Tensor,
    node_cap: int,
    key_prefix: torch.Tensor | None = None,
) -> torch.Tensor:
    """Carry per-node state across a re-indexing hop.

    Each old node has a self-loop, so it appears in the new frontier.
    With a bitmap-dedup ``key_prefix`` its new slot is ``prefix[key] - 1``
    (one gather); otherwise it is found by binary search over the sorted
    new keys. New nodes get zeros. An old key missing from the new
    frontier (its self-loop clipped by an edge-cap overflow; the prefix
    then gives -1 or another node's slot) is dropped rather than written
    into another node's slot (`frontier.py:332-343` of the JAX package):
    the ``hit`` test sees the slot before any index does."""
    valid = old_keys != SENTINEL
    if key_prefix is not None:
        safe = torch.where(valid, old_keys, 0).long()
        pos = key_prefix[
            torch.clamp(safe, max=key_prefix.shape[0] - 1)].long() - 1
    else:
        pos = torch.searchsorted(new_keys, old_keys)
    pos_c = torch.clamp(pos, 0, node_cap - 1)
    hit = valid & (pos >= 0) & (new_keys[pos_c] == old_keys)
    return scatter_drop(node_cap, torch.where(hit, pos_c, node_cap),
                        old_values, 0)
