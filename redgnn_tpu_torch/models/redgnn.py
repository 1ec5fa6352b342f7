"""RED-GNN: query-dependent relational digraph propagation.

Port of ``redgnn_tpu/models/redgnn.py``. The L-hop loop — expansion,
attention, aggregation, gating, scoring — runs on the model's device with
static per-hop capacities and no host round-trip; entities never reached
within L hops score 0 (`Static/transductive/models.py:86-88`). A hop
expands a sparse frontier (sort or bitmap dedup, `_resolve_dedup`) until
the plan switches to dense mode: a batch-shared (n_ent, b, d) layout over
the graph's tail-sorted edge table. Every op on the path differentiates
as the JAX package's does; dropout acts on each hop's new hidden state
before the gate, in training only.

No parameter depends on the entity count: it is read from the graph of
each call, so one model scores the training graph and an inductive test
graph with another vocabulary.

Edge sharding (``edge_axis`` / ``edge_shards``, the JAX package's
fields) splits each sparse hop's edges over a mesh's edge group
(`models/layers.py`); a model built so takes the ``mesh`` and runs no
dense hop, as in the JAX package. ``compute_dtype="bfloat16"`` gathers
bf16 rows in every layer (`models/layers.py`); the hidden states, the
gate and the scores stay float32, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph
from redgnn_tpu_torch.models.layers import (
    GRUGate,
    RelAttnLayer,
    _uniform_init_,
)
from redgnn_tpu_torch.ops.frontier import (
    SENTINEL,
    align_old_to_new,
    expand_frontier,
    scatter_drop,
)
from redgnn_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ModelConfig:
    # kept so the config matches the JAX package's; `forward` does not read
    # it: the entity count is the graph's, and no parameter depends on it
    n_ent: int
    n_rel: int
    hidden_dim: int = 48
    attn_dim: int = 5
    n_layer: int = 3
    dropout: float = 0.29
    act: str = "relu"
    segment_impl: str = "xla"
    # 'float32' or 'bfloat16': the dtype of the layers' gathered rows
    compute_dtype: str = "float32"
    # node-dedup scheme per hop: 'sort', 'bitmap' or 'auto' (_resolve_dedup)
    dedup_impl: str = "auto"
    # bitmap hops fetch hidden[src] inside the frontier's metadata gather
    # and differentiate it as a range sum of the gradient
    # (ops/gather.gather_rows_packed): exact on a CUDA device (the range-sum
    # kernel); on the CPU a difference of the prefix sum, with noise
    # O(total * eps) there alone; set False for strict CPU comparisons
    scan_src_backward: bool = True
    # dense-mode hops once a hop's edge cap reaches dense_switch * b * |E|
    # (needs the graph's tail-sorted view, DeviceGraph.from_csr)
    dense_hops: bool = True
    dense_switch: float = 0.25
    dense_agg: str = "sorted_scatter"  # or 'cumsum' (models/layers.py)
    # edge-parallel propagation over the mesh axis edge_axis, whose
    # edge_shards ranks each take a slice of every sparse hop's edges
    edge_axis: str | None = None
    edge_shards: int = 1
    # the relation-table lookups' backward as a one-hot matmul
    # (ops/gather.take_rows); a sharded step clears it, as the JAX
    # package's shard_map does (parallel/shard.py)
    mxu_gather_backward: bool = True


def _resolve_dedup(dedup_impl: str, key_space: int, edge_cap: int,
                   segment_impl: str = "xla") -> str:
    """The JAX package's choice of dedup scheme for one hop: 'auto' takes
    bitmap while the key space is at most 16x the edge capacity; the
    'scan' and 'pallas' segment implementations need dst-sorted edges and
    force 'sort'."""
    needs_sorted = segment_impl in ("scan", "pallas")
    if dedup_impl == "auto":
        if needs_sorted:
            return "sort"
        return "bitmap" if key_space <= 16 * edge_cap else "sort"
    if dedup_impl not in ("sort", "bitmap"):
        raise ValueError(
            f"dedup_impl must be 'sort', 'bitmap' or 'auto', got "
            f"{dedup_impl!r}")
    if needs_sorted and dedup_impl == "bitmap":
        raise ValueError(
            f"segment_impl={segment_impl!r} requires dst-sorted edges; "
            "use dedup_impl='sort' (or 'auto')")
    return dedup_impl


def hop_plan(cfg: ModelConfig, graph: DeviceGraph, caps: FrontierCaps,
             b: int) -> list:
    """The scheme of each hop of a batch of ``b`` queries, from the static
    capacities alone: 'sort' or 'bitmap' for a sparse hop, 'dense' from
    the first hop whose edge cap reaches ``dense_switch * b * |edges|``
    on (the frontier has saturated), if the graph has its tail-sorted
    view."""
    dense_from = cfg.n_layer
    if cfg.dense_hops and graph.has_dense and cfg.edge_axis is None:
        for i in range(cfg.n_layer):
            if caps.edge_caps[i] >= cfg.dense_switch * b * graph.n_edges:
                dense_from = i
                break
    return [_resolve_dedup(cfg.dedup_impl, b * graph.n_ent,
                           caps.edge_caps[i], cfg.segment_impl)
            for i in range(dense_from)] + ["dense"] * (cfg.n_layer
                                                       - dense_from)


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keep with probability
    ``1 - rate`` and scale the kept values by ``1 / (1 - rate)``."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class RedGNN(nn.Module):
    """L-hop frontier propagation scoring every reached entity.

    Parameters are drawn on the CPU from ``generator`` (a fresh one seeded
    with 0 by default) and then moved to ``device``, so one seed gives the
    same weights on every device. State-dict keys follow the JAX
    package's parameter names (``layer_{i}``, ``gate``, ``W_final``).
    ``mesh`` (`parallel/mesh.py`) is needed when ``cfg.edge_axis`` is
    set."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        for i in range(cfg.n_layer):
            self.add_module(f"layer_{i}", RelAttnLayer(
                cfg.hidden_dim, cfg.attn_dim, cfg.n_rel, act=cfg.act,
                segment_impl=cfg.segment_impl, generator=generator,
                mxu_gather_backward=cfg.mxu_gather_backward,
                edge_axis=cfg.edge_axis, edge_shards=cfg.edge_shards,
                mesh=mesh, compute_dtype=cfg.compute_dtype))
        self.gate = GRUGate(cfg.hidden_dim, generator=generator)
        self.W_final = nn.Linear(cfg.hidden_dim, 1, bias=False)
        _uniform_init_(self.W_final.weight, cfg.hidden_dim, generator)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.W_final.weight.device

    def forward(
        self,
        graph: DeviceGraph,
        subs: torch.Tensor,    # (B,) query head entities
        rels: torch.Tensor,    # (B,) query relations
        qmask: torch.Tensor,   # (B,) bool — false for padded queries
        caps: FrontierCaps,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scores (B, n_ent) and ``aux`` per-hop tensors
        (edge_overflow, node_overflow, num_nodes, num_edges).

        ``train`` turns dropout on; its masks are drawn from
        ``generator``, which must live on the model's device (the global
        RNG is never used)."""
        cfg = self.cfg
        drop = train and cfg.dropout > 0.0
        if drop and generator is None:
            raise ValueError("training with dropout needs a torch.Generator "
                             "on the model's device")
        dev = self.device
        b = subs.shape[0]
        d = cfg.hidden_dim
        n_ent = graph.n_ent

        # initial frontier: one node per query, key = b * n_ent + head
        keys0 = (subs.to(torch.int32)
                 + torch.arange(b, dtype=torch.int32, device=dev) * n_ent)
        node_keys = torch.where(qmask, keys0, SENTINEL)
        hidden = torch.zeros((b, d), device=dev)
        h0 = torch.zeros((b, d), device=dev)
        rels = rels.to(torch.int32)

        aux = {"edge_overflow": [], "node_overflow": [], "num_nodes": [],
               "num_edges": []}

        dense_state = None  # (hidden (N, b, d), visited (N, b))
        false = torch.zeros((), dtype=torch.bool, device=dev)

        for i, scheme in enumerate(hop_plan(cfg, graph, caps, b)):
            layer = getattr(self, f"layer_{i}")
            if scheme == "dense":
                if dense_state is None:
                    # sparse frontier -> (entity, batch) layout; pads are
                    # dropped (their slot lies past the end)
                    valid = node_keys != SENTINEL
                    keys = node_keys.long()
                    flat = torch.where(
                        valid, (keys % n_ent) * b + keys // n_ent, n_ent * b)
                    dense_state = (
                        scatter_drop(n_ent * b, flat, hidden,
                                     0).view(n_ent, b, d),
                        scatter_drop(n_ent * b, flat, valid,
                                     False).view(n_ent, b))
                hd, vis = dense_state
                new_hidden, new_vis, n_live = layer.dense(
                    hd, vis, rels, graph.tsrc, graph.trel, graph.ttail,
                    graph.tail_rowptr, cfg.dense_agg, graph.tsrc_order,
                    graph.rowptr)
                if drop:
                    new_hidden = _dropout(new_hidden, cfg.dropout, generator)
                # GRU carry: hd is zero at never-visited nodes, exactly
                # the align_old_to_new semantics (new nodes start at 0)
                hdn = self.gate(new_hidden, hd)
                hdn = torch.where(new_vis[..., None], hdn, 0.0)
                dense_state = (hdn, new_vis)
                aux["edge_overflow"].append(false)
                aux["node_overflow"].append(false)
                aux["num_nodes"].append(torch.sum(new_vis).to(torch.int32))
                aux["num_edges"].append(n_live)
                continue
            fr = expand_frontier(
                graph.rowptr, graph.rel, graph.tail,
                n_ent, node_keys,
                edge_cap=caps.edge_caps[i],
                node_cap=caps.node_caps[i + 1],
                dedup_impl=scheme,
                key_space=b * n_ent,
                # fetch h_src inside the expansion's metadata row gather
                node_values=(hidden if scheme == "bitmap"
                             and cfg.scan_src_backward else None),
            )
            new_hidden = layer(hidden, rels, fr, caps.node_caps[i + 1],
                               edges_sorted=(scheme == "sort"))
            # carry GRU state: previous nodes keep h0, new nodes start at 0
            h0 = align_old_to_new(node_keys, fr.node_keys, h0,
                                  caps.node_caps[i + 1],
                                  key_prefix=fr.key_prefix)
            if drop:
                new_hidden = _dropout(new_hidden, cfg.dropout, generator)
            hidden = self.gate(new_hidden, h0)
            h0 = hidden
            node_keys = fr.node_keys

            aux["edge_overflow"].append(fr.edge_overflow)
            aux["node_overflow"].append(fr.node_overflow)
            aux["num_nodes"].append(fr.num_nodes)
            aux["num_edges"].append(fr.num_edges)

        if dense_state is not None:
            hd, vis = dense_state
            scores_all = self.W_final(hd)[:, :, 0].T    # (b, n_ent)
            scores_all = torch.where(vis.T, scores_all, 0.0)
        else:
            scores = self.W_final(hidden)[:, 0]  # (node_cap_L,)
            valid = node_keys != SENTINEL
            # a key is already the flat (batch, entity) index b * n_ent + ent
            flat = torch.where(valid, node_keys.long(), b * n_ent)
            scores_all = scatter_drop(
                b * n_ent, flat, torch.where(valid, scores, 0.0),
                0).view(b, n_ent)
        return scores_all, {k: torch.stack(v) for k, v in aux.items()}
