"""T-RED-GNN: time-aware relational digraph propagation.

Port of ``redgnn_tpu/models/temporal.py``. One module covers both
temporal workloads of the reference:

  * interpolation (`Temporal/interpolation/model_cuda_new_embdding.py`):
    whole-timeline propagation, signed relative time Δ = τ_edge − τ_query,
    direction-specific past/now/future transforms (`:160-163`), per-example
    leave-one-out during training (`:110`) as an edge mask; once a hop's
    frontier saturates, dense hops over the whole tail-sorted edge table,
    shared by the batch;
  * extrapolation (`Temporal/extrapolation/model_cuda_new_embedding.py`):
    per-query time window [τ_q − W, τ_q) (`:166-177`) read as a contiguous
    slice of the (head, time)-sorted CSR row plus the node's self-loop,
    Δ = τ_query − τ_edge, one past transform (`:211`), and a softmax over
    the final frontier for segment ranking (`:248-257`).

Shared math:
    msg_e  = h_src + R_i[rel] + PeriodicTimeEmbed(Δ)
    t(msg) = direction-selected linear transform
    α_e    = σ(A2_i · ReLU(A1_i · [h_src ‖ R_i[rel] ‖ R_i[q_rel]]))
    h'_v   = act(Σ_{dst(e)=v} α_e · t(msg_e))      (+ dropout, interpolation)
    score  = w·h + b over reached entities, 0 elsewhere.

Parameters carry the flax names and layouts (``time_w`` is (2K, d),
``past_linear`` (d, d), ...) and are applied as ``x @ W``, so a flax tree
maps onto the state dict one to one. They are drawn on the CPU from a
``torch.Generator`` and moved to the model's device; dropout masks come
from the generator passed to ``forward``, never the global RNG.

The aggregations go through `ops.segment.segment_sum` with the config's
``segment_impl``: ``'pallas'`` is the sorted-segment-sum kernel. Sparse
hops send padding edges past the last segment and spread their sources
over the rows, as `models/layers.py:RelAttnLayer` does. The dense hop's
two sums (messages and live counts) follow ``segment_impl`` too; **this
differs from the JAX package**, whose temporal dense hop always takes the
plain scatter-add (``impl="xla"``, `redgnn_tpu/models/temporal.py:558-563`)
whatever ``segment_impl`` says, so there the kernel never sees a dense
hop. The sums are the same function either way; with
``segment_impl='xla'`` (the default) the two packages agree in route as
well.

``collect_alpha`` exposes each sparse hop's per-edge attention in
``aux`` (``alpha``, ``alpha_rel``, ``alpha_qrel``, ``alpha_valid``: one
tensor per hop), for the attention statistics of `utils/viz.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph
from redgnn_tpu_torch.models.layers import _uniform_init_
from redgnn_tpu_torch.models.redgnn import _dropout, _resolve_dedup
from redgnn_tpu_torch.ops.dense_hop import (
    ACTS,
    dense_hop_temporal_fn,
    temporal_terms,
)
from redgnn_tpu_torch.ops.frontier import (
    SENTINEL,
    expand_frontier,
    expand_frontier_ranges,
    scatter_drop,
)
from redgnn_tpu_torch.ops.gather import gather_rows_listed, take_rows
from redgnn_tpu_torch.ops.segment import segment_softmax, segment_sum
from redgnn_tpu_torch.utils.device import resolve_device

# one table of activations with the dense hop kernel's (its codes)
TEMPORAL_ACTS = {name: fn for name, (_, fn) in ACTS.items()}


def periodic_time_embedding(x: torch.Tensor, freq: torch.Tensor,
                            w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """rtdl-style PLR embedding of a scalar time offset
    (`Temporal/interpolation/rtdl_num_embeddings.py:126-215`, the JAX
    package's `PeriodicTimeEmbedding`): z = 2π·c·x, features
    [cos z ‖ sin z] -> linear -> ReLU. x: (E,) -> (E, d)."""
    z = 2.0 * math.pi * x[:, None] * freq[None, :]
    feats = torch.cat([torch.cos(z), torch.sin(z)], -1)
    return torch.relu(feats @ w + b)


class PeriodicTimeEmbedding(nn.Module):
    """`periodic_time_embedding` with its own parameters, named as the JAX
    package's module names them (``frequencies`` ~ 0.01 · N(0, 1)
    truncated at ±3, ``w`` (2K, d), ``b`` (d,))."""

    def __init__(self, d_embedding: int, n_frequencies: int = 48,
                 sigma: float = 0.01,
                 generator: torch.Generator | None = None):
        super().__init__()
        k2 = 2 * n_frequencies
        self.frequencies = nn.Parameter(torch.empty(n_frequencies))
        self.w = nn.Parameter(torch.empty(k2, d_embedding))
        self.b = nn.Parameter(torch.empty(d_embedding))
        with torch.no_grad():
            nn.init.trunc_normal_(self.frequencies, 0.0, 1.0, -3.0, 3.0,
                                  generator=generator)
            self.frequencies.mul_(sigma)
        _uniform_init_(self.w, k2, generator)
        _uniform_init_(self.b, k2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (E,) -> (E, d)
        return periodic_time_embedding(x, self.frequencies, self.w, self.b)


@dataclass(frozen=True)
class TemporalModelConfig:
    n_ent: int
    n_rel_vocab: int      # rows in the relation embedding tables
    idd_rel: int          # self-loop relation id
    hidden_dim: int = 20
    attn_dim: int = 30
    n_layer: int = 4
    dropout: float = 0.1
    act: str = "leakyrelu"
    mode: str = "interpolation"   # or "extrapolation"
    window: Optional[int] = None  # time units; extrapolation uses 120
    time_key_base: Optional[int] = None  # composite (head,time) key stride
    n_frequencies: int = 48
    segment_impl: str = "xla"
    # recompute each sparse hop's per-edge math in the backward
    # (torch.utils.checkpoint); dropout masks are drawn before the
    # recomputed function, so both passes see the same masks
    remat: bool = False
    dedup_impl: str = "bitmap"  # 'sort' | 'bitmap' | 'auto' (_resolve_dedup)
    # bitmap hops fetch hidden[src] inside the frontier's metadata gather
    # (range-sum backward, ops/gather.gather_rows_packed: the exact kernel
    # on a CUDA device, a prefix-sum difference with O(total * eps) noise
    # on the CPU); set False for strict CPU gradient comparisons
    scan_src_backward: bool = True
    mxu_gather_backward: bool = True  # take_rows (one-hot matmul backward)
    edge_dropout: float = 0.0  # random per-hop edge drop during training
    # dense hops (interpolation) from the first hop whose edge cap reaches
    # dense_switch * b * |edges|
    dense_hops: bool = True
    dense_switch: float = 0.25
    dense_agg: str = "sorted_scatter"  # or "cumsum" (range-diff of prefix)
    # ablations (`Temporal/interpolation/model_cuda_aba.py:14,189,353`)
    use_time: bool = True               # False => T_RED_GNN_wo_tau
    use_attention: bool = True          # False => T_RED_GNN_wo_Attn
    collect_alpha: bool = False  # per-edge attention in aux (sparse hops)
    direction_transform: str = "linear"  # "bias" => T_RED_GNN_W
    time_embedding: str = "periodic"     # "absolute" => per-timestamp table
    n_time: Optional[int] = None         # rows for absolute time table


def temporal_hop_plan(cfg: TemporalModelConfig, n_edges: int,
                      caps: FrontierCaps, b: int, has_dense: bool) -> list:
    """The scheme of each hop of a batch of ``b`` queries: 'sort' or
    'bitmap' for a sparse hop, 'dense' from the first hop whose edge cap
    reaches ``dense_switch * b * n_edges`` on (interpolation with
    ``dense_hops`` and the dense table given). Decided from the static
    capacities alone, as the JAX package decides it while tracing."""
    dense_from = cfg.n_layer
    if cfg.mode == "interpolation" and cfg.dense_hops and has_dense:
        for i in range(cfg.n_layer):
            if caps.edge_caps[i] >= cfg.dense_switch * b * n_edges:
                dense_from = i
                break
    return [_resolve_dedup(cfg.dedup_impl, b * cfg.n_ent, caps.edge_caps[i],
                           cfg.segment_impl)
            for i in range(dense_from)] + ["dense"] * (cfg.n_layer
                                                       - dense_from)


def _xavier_uniform_(t: torch.Tensor, generator) -> None:
    """flax ``xavier_uniform`` for a 2-D (fan_in, fan_out) parameter."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class TRedGNN(nn.Module):
    """L-hop temporal frontier propagation scoring every reached entity."""

    def __init__(self, cfg: TemporalModelConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d, k = cfg.hidden_dim, cfg.n_frequencies

        def param(name, *shape, init="uniform", fan_in=None):
            p = nn.Parameter(torch.empty(*shape))
            if init == "uniform":
                _uniform_init_(p, fan_in or shape[0], generator)
            elif init == "xavier":
                _xavier_uniform_(p, generator)
            elif init == "zeros":
                nn.init.zeros_(p)
            else:  # 0.01 * truncated normal in [-3, 3]
                with torch.no_grad():
                    nn.init.trunc_normal_(p, 0.0, 1.0, -3.0, 3.0,
                                          generator=generator)
                    p.mul_(0.01)
            self.register_parameter(name, p)

        if cfg.time_embedding == "periodic":
            param("time_freq", k, init="trunc_normal")
            param("time_w", 2 * k, d)
            param("time_b", d, fan_in=2 * k)
        else:
            # absolute per-timestamp table (`model_cuda_aba.py`)
            param("time_embed_abs", cfg.n_time or 1, d, init="xavier")
        for name in ("past", "now", "future"):
            if cfg.direction_transform == "linear":
                param(f"{name}_linear", d, d)
            else:  # learned additive biases (T_RED_GNN_W)
                param(f"{name}_bias", d, init="zeros")
        for i in range(cfg.n_layer):
            param(f"rela_embed_{i}", cfg.n_rel_vocab, d, init="xavier")
            param(f"attn1_{i}", 3 * d, cfg.attn_dim)
            param(f"attn2_{i}", cfg.attn_dim, 1)
        param("classifier_w", d, 1)
        param("classifier_b", 1, fan_in=d)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.classifier_w.device

    # -- per-edge pieces shared by the sparse and dense hops -------------
    def _direction(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.direction_transform == "linear":
            return x @ getattr(self, f"{name}_linear")
        return x + getattr(self, f"{name}_bias")

    def _rows(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if self.cfg.mxu_gather_backward:
            return take_rows(table, idx)
        return table[idx.long()]

    def _abs_time(self, e_time: torch.Tensor) -> torch.Tensor:
        t_idx = torch.clamp(e_time.long(), 0, (self.cfg.n_time or 1) - 1)
        return self.time_embed_abs[t_idx]

    def forward(
        self,
        graph: DeviceGraph,
        etime: torch.Tensor,          # (n_edges,) time per CSR slot
        subs: torch.Tensor,           # (B,)
        rels: torch.Tensor,           # (B,)
        times: torch.Tensor,          # (B,) query time ids
        qmask: torch.Tensor,          # (B,) bool
        caps: FrontierCaps,
        exclude_slots: Optional[torch.Tensor] = None,  # (B,) CSR slots
        train: bool = False,
        ekey: Optional[torch.Tensor] = None,          # (n_edges,) head*K+time
        selfloop_slot: Optional[torch.Tensor] = None,  # (n_ent,)
        time_rowptr: Optional[torch.Tensor] = None,   # (n_ent, K+1)
        dense_arrs: Optional[tuple] = None,  # (src, rel, time, slot, tail,
        # tail_rowptr) tail-sorted: enables dense hops
        generator: torch.Generator | None = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Scores (B, n_ent) and ``aux`` (per-hop edge_overflow,
        node_overflow, num_nodes, num_edges; in extrapolation also
        frontier_softmax and frontier_keys over the final frontier).

        ``train`` turns on dropout and edge dropout, whose masks are drawn
        from ``generator`` (on the model's device)."""
        cfg = self.cfg
        dev = self.device
        b = subs.shape[0]
        d = cfg.hidden_dim
        n_ent = cfg.n_ent
        drop_sparse = cfg.mode == "interpolation" and train \
            and cfg.dropout > 0
        drop_dense = train and cfg.dropout > 0
        edrop = train and cfg.edge_dropout > 0
        if (drop_sparse or drop_dense or edrop) and generator is None:
            raise ValueError("training with dropout needs a torch.Generator "
                             "on the model's device")
        rels = rels.to(torch.int32)
        keys0 = (subs.to(torch.int32)
                 + torch.arange(b, dtype=torch.int32, device=dev) * n_ent)
        node_keys = torch.where(qmask, keys0, SENTINEL)
        hidden = torch.zeros((b, d), device=dev)

        if exclude_slots is not None:
            excl = exclude_slots.to(dev)

            def edge_mask_fn(edge_id, batch_e, rel_e):
                # leave-one-out: drop the batch's own training quadruples
                # for every query of the batch (np.delete semantics, `:110`)
                return ~torch.any(edge_id[:, None] == excl[None, :], dim=1)
        else:
            edge_mask_fn = None

        aux: Dict[str, Any] = {"edge_overflow": [], "node_overflow": [],
                               "num_nodes": [], "num_edges": []}
        plan = temporal_hop_plan(cfg, graph.n_edges, caps, b,
                                 dense_arrs is not None)
        dense_state = None  # (hidden (N, b, d), visited (N, b))
        excl_keep = None
        false = torch.zeros((), dtype=torch.bool, device=dev)
        windowed = cfg.mode == "extrapolation" and cfg.window is not None

        for i, scheme in enumerate(plan):
            rela = getattr(self, f"rela_embed_{i}")
            a1_k = getattr(self, f"attn1_{i}")
            a2_k = getattr(self, f"attn2_{i}")
            if scheme == "dense":
                tsrc, trel, ttime, tslot, ttail, tail_rowptr = dense_arrs
                if dense_state is None:
                    dense_state = self._to_dense(node_keys, hidden, b)
                    if exclude_slots is not None:
                        # leave-one-out in dense order: one (E,) keep mask
                        # shared by the whole batch
                        excl_keep = ~torch.any(
                            tslot[:, None] == excl[None, :], dim=1)
                dense_state, n_nodes, n_edges = self._dense_hop(
                    dense_state, rela, a1_k, a2_k, rels, times, tsrc, trel,
                    ttime, ttail, tail_rowptr, graph.tsrc_order,
                    graph.rowptr, excl_keep,
                    generator if drop_dense else None,
                    generator if edrop else None, graph.tail_items,
                    graph.n_time, graph.time_order, graph.time_off)
                aux["edge_overflow"].append(false)
                aux["node_overflow"].append(false)
                aux["num_nodes"].append(n_nodes)
                aux["num_edges"].append(n_edges)
                continue

            node_values = (hidden if scheme == "bitmap"
                           and cfg.scan_src_backward else None)
            if windowed:
                # each frontier node's in-window edges are a contiguous
                # CSR sub-row; its self-loop is re-added as an extra slot
                valid_node = node_keys != SENTINEL
                ent = torch.where(valid_node, node_keys % n_ent, 0).long()
                t_q = times[torch.where(valid_node, node_keys // n_ent,
                                        0).long()].long()
                lo = torch.clamp(t_q - cfg.window, min=0)
                if time_rowptr is not None:
                    w_start = time_rowptr[ent, lo]
                    w_end = time_rowptr[ent, t_q]
                else:
                    base = ent * cfg.time_key_base
                    w_start = torch.searchsorted(
                        ekey, (base + lo).to(ekey.dtype)).to(torch.int32)
                    w_end = torch.searchsorted(
                        ekey, (base + t_q).to(ekey.dtype)).to(torch.int32)
                deg = torch.where(valid_node, w_end - w_start, 0)
                fr = expand_frontier_ranges(
                    graph.rel, graph.tail, n_ent, node_keys, w_start, deg,
                    edge_cap=caps.edge_caps[i],
                    node_cap=caps.node_caps[i + 1],
                    extra_edge_slot=selfloop_slot[ent],
                    edge_mask_fn=edge_mask_fn, dedup_impl=scheme,
                    key_space=b * n_ent, etime=etime,
                    node_values=node_values)
            else:
                fr = expand_frontier(
                    graph.rowptr, graph.rel, graph.tail, n_ent, node_keys,
                    edge_cap=caps.edge_caps[i],
                    node_cap=caps.node_caps[i + 1],
                    edge_mask_fn=edge_mask_fn, dedup_impl=scheme,
                    key_space=b * n_ent, etime=etime,
                    node_values=node_values)
            node_cap = caps.node_caps[i + 1]
            edge_valid = fr.edge_valid
            if edrop:
                keep = torch.rand(edge_valid.shape, generator=generator,
                                  device=dev) < 1.0 - cfg.edge_dropout
                edge_valid = edge_valid & keep
            # the hop's dropout mask, drawn here so that a recomputation
            # under remat sees the same one
            drop_keep = (torch.rand((node_cap, d), generator=generator,
                                    device=dev) < 1.0 - cfg.dropout
                         if drop_sparse else None)
            args = (hidden, rela, a1_k, a2_k, fr.src, fr.dst, fr.rel,
                    fr.batch, edge_valid, fr.time, fr.src_values, drop_keep)
            hop = lambda *a: self._sparse_hop(*a, rels=rels, times=times,
                                              node_cap=node_cap,
                                              edges_sorted=scheme == "sort")
            if cfg.remat and torch.is_grad_enabled():
                hidden = checkpoint(hop, *args, use_reentrant=False)
            else:
                hidden = hop(*args)
            if cfg.collect_alpha:
                hidden, alpha_i = hidden
                aux.setdefault("alpha", []).append(alpha_i)
                aux.setdefault("alpha_rel", []).append(fr.rel)
                aux.setdefault("alpha_qrel", []).append(rels[fr.batch.long()])
                aux.setdefault("alpha_valid", []).append(edge_valid)
            node_keys = fr.node_keys
            aux["edge_overflow"].append(fr.edge_overflow)
            aux["node_overflow"].append(fr.node_overflow)
            aux["num_nodes"].append(fr.num_nodes)
            aux["num_edges"].append(fr.num_edges)

        cls_w, cls_b = self.classifier_w, self.classifier_b
        if dense_state is not None:
            hidden_dense, visited = dense_state
            scores_all = (hidden_dense @ cls_w)[:, :, 0].T + cls_b[0]
            scores_all = torch.where(visited.T, scores_all, 0.0)
        else:
            scores = (hidden @ cls_w + cls_b)[:, 0]
            valid = node_keys != SENTINEL
            # a key is already the flat (batch, entity) index b * n_ent + ent
            flat = torch.where(valid, node_keys.long(), b * n_ent)
            scores_all = scatter_drop(
                b * n_ent, flat, torch.where(valid, scores, 0.0),
                0).view(b, n_ent)

        if cfg.mode == "extrapolation":
            # per-query distribution over the final frontier
            # (`model_cuda_new_embedding.py:248`), for segment ranking
            batch_idx = torch.where(valid, node_keys // n_ent, b)
            aux["frontier_softmax"] = segment_softmax(
                scores, torch.clamp(batch_idx, max=b - 1), b, valid=valid)
            aux["frontier_keys"] = node_keys

        for k in ("edge_overflow", "node_overflow", "num_nodes", "num_edges"):
            aux[k] = torch.stack(aux[k])
        return scores_all, aux

    # -- sparse hop ------------------------------------------------------
    def _sparse_hop(self, hidden, rela, a1_k, a2_k, src, dst, rel, batch,
                    edge_valid, e_time, src_vals, drop_keep, *, rels, times,
                    node_cap: int, edges_sorted: bool) -> torch.Tensor:
        """One hop over a frontier's edge list (`temporal.py:326-392`)."""
        cfg = self.cfg
        if src_vals is not None:
            # h_src came with the frontier's metadata gather (range-sum
            # backward: the kernel on a CUDA device, a prefix-sum
            # difference on the CPU)
            hs = src_vals
        else:
            # padding edges all carry the last frontier slot as src; spread
            # them over the rows so the gather's backward does not add a
            # long run of equal indices (their messages are masked below)
            spread = torch.arange(src.shape[0], device=src.device) \
                % hidden.shape[0]
            hs = hidden[torch.where(edge_valid, src.long(), spread)]
        hr = self._rows(rela, rel)
        h_qr = self._rows(self._rows(rela, rels), batch)

        t_e = e_time.to(torch.float32)
        t_q = times[batch.long()].to(torch.float32)
        if cfg.mode == "interpolation":
            delta = t_e - t_q
        else:
            # Δ = τ_q − τ_edge ≥ 0; self-loops sit at the window floor
            # (`model_cuda_new_embedding.py:170`)
            delta = t_q - t_e
            if cfg.window is not None:
                floor_delta = torch.clamp(t_q, max=float(cfg.window))
                delta = torch.where(rel == cfg.idd_rel, floor_delta, delta)

        msg = hs + hr
        if cfg.use_time:
            if cfg.time_embedding == "periodic":
                msg = msg + periodic_time_embedding(
                    delta, self.time_freq, self.time_w, self.time_b)
            else:
                msg = msg + self._abs_time(e_time)
        if cfg.mode == "interpolation":
            transformed = torch.where(
                (delta > 0)[:, None], self._direction("future", msg),
                torch.where((delta < 0)[:, None],
                            self._direction("past", msg),
                            self._direction("now", msg)))
        else:
            transformed = self._direction("past", msg)

        if cfg.use_attention:
            pre = torch.cat([hs, hr, h_qr], -1)
            alpha = torch.sigmoid(torch.relu(pre @ a1_k) @ a2_k)
            message = transformed * alpha
        else:
            alpha = torch.ones((hs.shape[0], 1), device=hs.device)
            message = transformed
        message = torch.where(edge_valid[:, None], message, 0.0)
        # padding edges go past the end: the sum drops them instead of one
        # segment walking them all; in a dst-sorted list the valid edges
        # form a prefix, so the ids stay sorted
        seg = torch.where(edge_valid, dst, node_cap)
        agg = segment_sum(message, seg, node_cap,
                          indices_are_sorted=edges_sorted,
                          impl=cfg.segment_impl)
        if drop_keep is not None:
            agg = torch.where(drop_keep, agg / (1.0 - cfg.dropout), 0.0)
        out = TEMPORAL_ACTS[cfg.act](agg)
        if cfg.collect_alpha:
            return out, alpha[:, 0]
        return out

    # -- dense hops --------------------------------------------------------
    def _to_dense(self, node_keys, hidden, b):
        """Sparse padded frontier -> batch-shared dense node state
        (n_ent, b, d) + visited mask (n_ent, b); pads are dropped."""
        n = self.cfg.n_ent
        valid = node_keys != SENTINEL
        keys = node_keys.long()
        flat = torch.where(valid, (keys % n) * b + keys // n, n * b)
        return (scatter_drop(n * b, flat, hidden, 0).view(n, b, -1),
                scatter_drop(n * b, flat, valid, False).view(n, b))

    def _dense_hop(self, state, rela, a1_k, a2_k, rels, times, tsrc, trel,
                   ttime, ttail, tail_rowptr, tsrc_order, rowptr, excl_keep,
                   drop_gen, edrop_gen, tail_items, n_time, time_order=None,
                   time_off=None):
        """One hop over the whole tail-sorted edge table, shared by the
        batch (saturated-frontier regime; `temporal.py:461-572`): the
        sparse hop's math with edge metadata read in order and aggregation
        over the static per-tail ranges, as `_dense_hop_fused`, gradients
        on or off. Its backward sums the state's gradient by source
        through ``tsrc_order`` and the CSR's ``rowptr`` and the time
        term's by time id through ``time_order`` and ``time_off`` (the
        graph's lists: the list-sum kernel on a CUDA device needs them)."""
        return self._dense_hop_fused(
            state, rela, a1_k, a2_k, rels, times, tsrc, trel, ttime, ttail,
            tail_rowptr, excl_keep, drop_gen, edrop_gen, tail_items, n_time,
            tsrc_order, rowptr, time_order, time_off)

    def _dense_hop_autograd(self, state, rela, a1_k, a2_k, rels, times, tsrc,
                            trel, ttime, ttail, tail_rowptr, tsrc_order,
                            rowptr, excl_keep, drop_gen, edrop_gen):
        """`_dense_hop` through autograd-able tensor ops: the old route,
        which no model path calls. It stays as the yardstick that
        chip_smoke.py times the fused hop against (phases 7i and 7j) and
        as a float64 referee in tests."""
        cfg = self.cfg
        hidden_dense, visited = state
        d = cfg.hidden_dim
        n, b = visited.shape
        e_all = tsrc.shape[0]

        # pack the visited bit as an extra channel: one gather serves both
        packed = torch.cat(
            [hidden_dense, visited[:, :, None].to(hidden_dense.dtype)], -1)
        g = gather_rows_listed(packed, tsrc, tsrc_order,
                               rowptr)               # (E, b, d+1)
        hs = g[..., :d]
        live = g[..., d] > 0.5                       # (E, b)

        hr = self._rows(rela, trel)                  # (E, d)
        h_qr = self._rows(rela, rels)                # (b, d)

        t_e = ttime.to(torch.float32)
        t_q = times.to(torch.float32)
        delta = t_e[:, None] - t_q[None, :]          # (E, b)

        msg = hs + hr[:, None, :]
        if cfg.use_time:
            if cfg.time_embedding == "periodic":
                # z = 2πf(t_e − t_q) = z_e − z_q, so cos / sin of the
                # difference factor into per-edge and per-query terms, and
                # [cosΔ ‖ sinΔ] @ W is one (E, 2K) x (2K, b·d) product;
                # the (E·b, 2K) feature tensor never materializes
                k = cfg.n_frequencies
                freq, t_w = self.time_freq, self.time_w
                z_e = 2.0 * math.pi * t_e[:, None] * freq[None, :]
                z_q = 2.0 * math.pi * t_q[:, None] * freq[None, :]
                ce, se = torch.cos(z_e), torch.sin(z_e)   # (E, K)
                cq, sq = torch.cos(z_q), torch.sin(z_q)   # (b, K)
                w_c, w_s = t_w[:k], t_w[k:]               # (K, d)
                p = cq[:, :, None] * w_c[None] - sq[:, :, None] * w_s[None]
                q = sq[:, :, None] * w_c[None] + cq[:, :, None] * w_s[None]
                pq = torch.cat([p, q], 1).permute(1, 0, 2).reshape(
                    2 * k, b * d)
                h_pre = (torch.cat([ce, se], 1) @ pq).view(e_all, b, d)
                msg = msg + torch.relu(h_pre + self.time_b)
            else:
                msg = msg + self._abs_time(ttime)[:, None, :]
        transformed = torch.where(
            (delta > 0)[..., None], self._direction("future", msg),
            torch.where((delta < 0)[..., None], self._direction("past", msg),
                        self._direction("now", msg)))
        if cfg.use_attention:
            # [hs ‖ hr ‖ h_qr] @ A1 split by rows: the hr / h_qr terms are
            # shared over the batch / the edges
            pre = (hs @ a1_k[:d]
                   + (hr @ a1_k[d:2 * d])[:, None, :]
                   + (h_qr @ a1_k[2 * d:])[None, :, :])
            message = transformed * torch.sigmoid(torch.relu(pre) @ a2_k)
        else:
            message = transformed
        keep = live
        if excl_keep is not None:
            keep = keep & excl_keep[:, None]
        if edrop_gen is not None:
            keep = keep & (torch.rand(keep.shape, generator=edrop_gen,
                                      device=keep.device)
                           < 1.0 - cfg.edge_dropout)
        message = torch.where(keep[..., None], message, 0.0)

        if cfg.dense_agg == "cumsum":
            lo, hi = tail_rowptr[:-1].long(), tail_rowptr[1:].long()
            pref = torch.cat([message.new_zeros((1, b, d)),
                              torch.cumsum(message, 0)])
            agg = pref[hi] - pref[lo]
            cnt = torch.cat([
                torch.zeros((1, b), dtype=torch.int32, device=keep.device),
                torch.cumsum(keep, 0, dtype=torch.int32)])
            new_visited = (cnt[hi] - cnt[lo]) > 0
        elif cfg.dense_agg == "sorted_scatter":
            # tail ids ascend: 'pallas' is the sorted-segment-sum kernel
            agg = segment_sum(message.reshape(e_all, b * d), ttail, n,
                              indices_are_sorted=True,
                              impl=cfg.segment_impl).reshape(n, b, d)
            new_visited = segment_sum(
                keep.to(torch.float32), ttail, n, indices_are_sorted=True,
                impl=cfg.segment_impl) > 0
        else:
            raise ValueError(f"unknown dense_agg {cfg.dense_agg!r}")
        if drop_gen is not None:
            agg = _dropout(agg, cfg.dropout, drop_gen)
        h = TEMPORAL_ACTS[cfg.act](agg)
        h = torch.where(new_visited[..., None], h, 0.0)
        n_nodes = torch.sum(new_visited).to(torch.int32)
        n_edges = torch.sum(keep).to(torch.int32)
        return (h, new_visited), n_nodes, n_edges

    def _dense_hop_fused(self, state, rela, a1_k, a2_k, rels, times, tsrc,
                         trel, ttime, ttail, tail_rowptr, excl_keep,
                         drop_gen, edrop_gen, tail_items, n_time,
                         tsrc_order=None, rowptr=None, time_order=None,
                         time_off=None):
        """`_dense_hop` as `ops.dense_hop.dense_hop_temporal_fn`: one
        forward kernel on a CUDA device (``tail_items``: the graph's work
        plan of it) and, when a gradient flows, one backward kernel (its
        sums by source and time id through the graph's lists); their plain
        versions on the CPU. The time term is computed once per (time
        id, query) over the graph's ``n_time`` time ids and the
        attention's relation and query terms once each
        (`ops.dense_hop.temporal_terms`). The dropout
        masks are drawn as the autograd route draws them, in its order
        (edge dropout, then dropout), so one generator gives the same
        masks either way."""
        cfg = self.cfg
        hidden_dense, visited = state
        n, b = visited.shape
        dev = hidden_dense.device
        edge_keep = drop_keep = None
        if edrop_gen is not None:
            edge_keep = torch.rand((tsrc.shape[0], b), generator=edrop_gen,
                                   device=dev) < 1.0 - cfg.edge_dropout
        if drop_gen is not None:
            shape = (n, b, cfg.hidden_dim)
            drop_keep = (torch.zeros(shape, dtype=torch.bool, device=dev)
                         if cfg.dropout >= 1.0
                         else torch.rand(shape, generator=drop_gen,
                                         device=dev) < 1.0 - cfg.dropout)
        periodic = cfg.use_time and cfg.time_embedding == "periodic"
        absolute = cfg.use_time and not periodic
        ra, qa, tt = temporal_terms(
            rela, a1_k, rels, times, n_time,
            self.time_freq if periodic else None,
            self.time_w if periodic else None,
            self.time_b if periodic else None,
            self.time_embed_abs if absolute else None,
            use_attention=cfg.use_attention)
        d = cfg.hidden_dim
        linear = cfg.direction_transform == "linear"
        names = ("past", "now", "future")
        wdir = (torch.stack([getattr(self, f"{k}_linear") for k in names])
                if linear else None)
        bdir = (None if linear else
                torch.stack([getattr(self, f"{k}_bias") for k in names]))
        h, new_visited, n_nodes, n_edges = dense_hop_temporal_fn(
            hidden_dense, visited, rela, tsrc, trel, ttime, ttail,
            tail_rowptr, times.to(torch.int32), excl_keep, edge_keep, tt, ra,
            qa, a1_k[:d], a2_k, wdir, bdir, drop_keep, cfg.dropout, cfg.act,
            cfg.dense_agg, tail_items, tsrc_order, rowptr, time_order,
            time_off)
        return (h, new_visited), n_nodes, n_edges
