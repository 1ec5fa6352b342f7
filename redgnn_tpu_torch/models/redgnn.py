"""RED-GNN: query-dependent relational digraph propagation.

Port of ``redgnn_tpu/models/redgnn.py`` (sparse hops, inference). The
L-hop loop — expansion, attention, aggregation, gating, scoring — runs
on the model's device with static per-hop capacities and no host
round-trip; entities never reached within L hops score 0
(`Static/transductive/models.py:86-88`).

Not ported yet: bitmap dedup, dense-mode hops, edge sharding, bfloat16
compute, dropout and gradients (the training slice).
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
)
from redgnn_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ModelConfig:
    n_ent: int
    n_rel: int
    hidden_dim: int = 48
    attn_dim: int = 5
    n_layer: int = 3
    act: str = "relu"
    segment_impl: str = "xla"
    # node-dedup scheme per hop: 'sort', 'bitmap' or 'auto' (_resolve_dedup)
    dedup_impl: str = "auto"
    # dense-mode hops once a hop's edge cap reaches dense_switch * b * |E|
    dense_hops: bool = True
    dense_switch: float = 0.25


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


class RedGNN(nn.Module):
    """L-hop frontier propagation scoring every reached entity.

    Parameters are drawn on the CPU from ``generator`` (a fresh one seeded
    with 0 by default) and then moved to ``device``, so one seed gives the
    same weights on every device. State-dict keys follow the JAX
    package's parameter names (``layer_{i}``, ``gate``, ``W_final``)."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        for i in range(cfg.n_layer):
            self.add_module(f"layer_{i}", RelAttnLayer(
                cfg.hidden_dim, cfg.attn_dim, cfg.n_rel, act=cfg.act,
                segment_impl=cfg.segment_impl, generator=generator))
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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scores (B, n_ent) and ``aux`` per-hop tensors
        (edge_overflow, node_overflow, num_nodes, num_edges)."""
        cfg = self.cfg
        dev = self.device
        b = subs.shape[0]
        d = cfg.hidden_dim

        if cfg.dense_hops and graph.has_dense:
            n_all_edges = int(graph.tail.shape[0])
            for i in range(cfg.n_layer):
                if caps.edge_caps[i] >= cfg.dense_switch * b * n_all_edges:
                    raise NotImplementedError(
                        f"hop {i} would run in dense mode (edge cap "
                        f"{caps.edge_caps[i]} >= {cfg.dense_switch} * {b} * "
                        f"{n_all_edges}); dense hops are not ported — set "
                        "dense_hops=False")

        # initial frontier: one node per query, key = b * n_ent + head
        keys0 = (subs.to(torch.int32)
                 + torch.arange(b, dtype=torch.int32, device=dev) * cfg.n_ent)
        node_keys = torch.where(qmask, keys0, SENTINEL)
        hidden = torch.zeros((b, d), device=dev)
        h0 = torch.zeros((b, d), device=dev)
        rels = rels.to(torch.int32)

        aux = {"edge_overflow": [], "node_overflow": [], "num_nodes": [],
               "num_edges": []}
        for i in range(cfg.n_layer):
            dedup = _resolve_dedup(cfg.dedup_impl, b * cfg.n_ent,
                                   caps.edge_caps[i], cfg.segment_impl)
            fr = expand_frontier(
                graph.rowptr, graph.rel, graph.tail,
                cfg.n_ent, node_keys,
                edge_cap=caps.edge_caps[i],
                node_cap=caps.node_caps[i + 1],
                dedup_impl=dedup,
                key_space=b * cfg.n_ent,
            )
            layer = getattr(self, f"layer_{i}")
            new_hidden = layer(hidden, rels, fr, caps.node_caps[i + 1])
            # carry GRU state: previous nodes keep h0, new nodes start at 0
            h0 = align_old_to_new(node_keys, fr.node_keys, h0,
                                  caps.node_caps[i + 1])
            hidden = self.gate(new_hidden, h0)
            h0 = hidden
            node_keys = fr.node_keys

            aux["edge_overflow"].append(fr.edge_overflow)
            aux["node_overflow"].append(fr.node_overflow)
            aux["num_nodes"].append(fr.num_nodes)
            aux["num_edges"].append(fr.num_edges)

        scores = self.W_final(hidden)[:, 0]  # (node_cap_L,)
        valid = node_keys != SENTINEL
        # a key is already the flat (batch, entity) index b * n_ent + ent
        flat = torch.where(valid, node_keys.long(), b * cfg.n_ent)
        scores_all = torch.zeros(b * cfg.n_ent + 1, device=dev)
        scores_all[flat] = torch.where(valid, scores, 0.0)
        scores_all = scores_all[:-1].view(b, cfg.n_ent)
        return scores_all, {k: torch.stack(v) for k, v in aux.items()}
