"""xERTE: subgraph-sampling attention flow for temporal KG forecasting.

Port of ``redgnn_tpu/models/xerte.py`` (the baseline of
`Temporal/extrapolation/model.py:18-806`). Every DP step works on
fixed-capacity padded tensors:

  * node identity is a composite key ``b * (n_ent * T) + ent * T + ts``
    over a compact time index (``INVALID`` = 2**31 - 1 pads), deduplicated
    by a stable sort (`_dedup_keys`);
  * neighbor sampling draws K edges per attended node from the
    (head, time)-sorted CSR: 'uniform', 'first' / 'whole', 'last' and
    recency-'weighted' (exponential offsets from the window end), plus a
    self-loop edge per node;
  * transition scores are the G3 bilinear form over
    (node_i ‖ rel ‖ q_src ‖ q_rel) x (node_j ‖ rel ‖ q_src ‖ q_rel),
    segment-softmaxed over source nodes; pruning keeps the top
    ``max_attended_edges`` per query (`ops.segment.segment_topk_mask`);
  * node scores aggregate (sum / mean / max) and L1-normalize per query,
    representations propagate along every retained edge list, and each
    step applies the dimension-shrinking linear + LeakyReLU bypass.

The sampling semantics (and their deliberate drift from the reference for
'weighted' and 'whole') are the JAX package's; see its module docstring.

Differences in mechanism, not in result:

  * random draws. The JAX model draws ``jax.random.uniform`` from
    ``fold_in(fold_in(PRNGKey(17), step), rng_seed)``, a stream torch
    cannot replay. Here step ``s`` draws from a ``torch.Generator`` on the
    model's device seeded from (s, rng_seed) (`sample_draws`), and
    ``forward(draws=...)`` takes the per-step (n_att, K) uniforms from the
    caller instead, so both packages can be fed the same draws. Only
    'uniform' and 'weighted' read them;
  * out-of-range scatters. JAX drops them (``mode="drop"``) where torch
    raises, so dropped writes go to a spare row (`ops.frontier.
    scatter_drop`). Relocating the visited state also sends every INVALID
    key to that spare row. JAX relocates them onto the INVALID key's
    slot, which nothing reads unmasked; but when the new visited set
    fills its capacity exactly (no overflow flag), that slot is clamped
    to the last one, which holds a valid key, and JAX writes the INVALID
    rows' state over it. The port leaves that key's state alone and
    equals a run with room to spare (`tests/test_torch_xerte.py::
    test_visited_set_filled_exactly`);
  * keys and slot indices are int64 (the values are the JAX package's
    int32 ones).

``aux`` holds ``node_overflow`` (dp_steps,) and ``visited`` (B, n_ent) as
in JAX, and ``steps``: per DP step the sampled edges' target keys
(``edge_keys``, INVALID where not sampled), their transition scores
(``target_score``) and the top-k mask (``keep``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from redgnn_tpu_torch.ops.frontier import scatter_drop
from redgnn_tpu_torch.ops.segment import (
    segment_max,
    segment_normalize_l1,
    segment_softmax,
    segment_sum,
    segment_topk_mask,
)
from redgnn_tpu_torch.utils.device import resolve_device

INVALID = 2 ** 31 - 1
SAMPLINGS = ("uniform", "first", "last", "weighted", "whole")


@dataclass(frozen=True)
class XErteConfig:
    n_ent: int
    n_rel: int              # true relations (selfloop id == n_rel)
    n_time: int             # compact time index size
    emb_dim: Tuple[int, ...] = (256, 128, 64, 32)  # len == DP_steps + 1
    dp_steps: int = 3
    dp_num_edges: int = 15          # K sampled neighbors per node
    max_attended_edges: int = 40
    node_score_aggregation: str = "sum"   # sum | mean | max
    ent_score_aggregation: str = "sum"    # sum | mean
    ratio_update: float = 0.0
    # uniform | first | last | weighted | whole (`Temporal/extrapolation/
    # utils.py:402-499`); 'whole' is 'first' with dp_num_edges >= the max
    # per-node span (oldest-K truncation otherwise)
    sampling: str = "weighted"
    weight_factor: float = 2.0
    # "cut": neighbors before the NODE's timestamp; "query": before the
    # QUERY's timestamp (get_temporal_neighbor_v2, `utils.py:344-400`)
    time_bound: str = "cut"
    use_time_embedding: bool = True
    # visited-set capacity multiplier: keys are inserted before pruning, so
    # degree-skewed batches can exceed the pruned-frontier budget; the
    # trainer doubles it on aux['node_overflow'] and replays
    cap_factor: float = 1.0

    @property
    def node_key_base(self) -> int:
        return self.n_ent * self.n_time

    def visited_cap(self, step: int, batch: int) -> int:
        """Static visited-node capacity entering step ``step``."""
        per_step = int(batch * self.max_attended_edges * self.cap_factor)
        return batch + per_step * step

    def edge_cap(self, batch: int) -> int:
        # attended nodes are bounded by pruned edges of the previous step
        return batch * self.max_attended_edges * (self.dp_num_edges + 1)


def _trunc_normal_(t: torch.Tensor, std: float, generator) -> None:
    """flax ``truncated_normal`` of stddev ``std``: a normal cut at two
    standard deviations, rescaled so the result has stddev ``std``."""
    s = std / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                              generator=generator)


def _xavier_normal_(t: torch.Tensor, generator) -> None:
    """flax ``xavier_normal`` (fan_avg, truncated) of a 2-D parameter."""
    _trunc_normal_(t, math.sqrt(2.0 / (t.shape[0] + t.shape[1])), generator)


def _dense(d_in: int, d_out: int, generator) -> nn.Linear:
    """flax ``Dense(d_out, kernel_init=xavier_normal())``: zero bias."""
    lin = nn.Linear(d_in, d_out)
    _xavier_normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


class TimeEncode(nn.Module):
    """Bochner time embedding: cos(t * w + phi), w init 1/10^linspace(0,9)
    (`model.py:18-65`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.basis_freq = nn.Parameter(torch.tensor(
            1.0 / 10 ** np.linspace(0, 9, dim), dtype=torch.float32))
        self.phase = nn.Parameter(torch.zeros(dim))

    def forward(self, ts: torch.Tensor) -> torch.Tensor:
        return torch.cos(ts[:, None] * self.basis_freq[None, :]
                         + self.phase[None, :])


class G3(nn.Module):
    """Bilinear transition score: sum(Wq x_left * Wk x_right)
    (`model.py:67-97`)."""

    def __init__(self, dim_in: int, dim_out: int, generator=None):
        super().__init__()
        self.query_proj = nn.Linear(dim_in, dim_out, bias=False)
        self.key_proj = nn.Linear(dim_in, dim_out, bias=False)
        with torch.no_grad():
            for lin in (self.query_proj, self.key_proj):
                lin.weight.normal_(0.0, math.sqrt(2.0 / dim_in),
                                   generator=generator)

    def forward(self, left: torch.Tensor, right: torch.Tensor
                ) -> torch.Tensor:
        return torch.sum(self.query_proj(left) * self.key_proj(right), -1)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0, differentiated by ``index_add_``.
    Advanced indexing's backward sorts the indices and adds each run of
    equal ones serially: at full width, where 81,920 edges read 128 query
    rows and 461 relation rows, that took ~440 ms of a train step on an
    H100."""
    return torch.index_select(table, 0, idx)


def _dedup_keys(keys: torch.Tensor, cap: int):
    """Sort-dedup int keys (INVALID pads) -> (unique_sorted (cap,),
    inverse, count, overflow). Ties keep their position (stable sort);
    unique ids past ``cap`` are dropped and their inverse clamped to
    ``cap - 1``, as in the JAX package."""
    sk, order = torch.sort(keys, stable=True)
    is_new = torch.ones_like(sk, dtype=torch.bool)
    is_new[1:] = sk[1:] != sk[:-1]
    uid_sorted = torch.cumsum(is_new, 0) - 1
    n_unique = torch.sum(is_new & (sk != INVALID))
    unique = scatter_drop(cap, torch.where(uid_sorted < cap, uid_sorted, cap),
                          sk, INVALID)
    inverse = torch.empty_like(uid_sorted)
    inverse[order] = torch.clamp(uid_sorted, max=cap - 1)
    return unique, inverse, n_unique, n_unique > cap


def sample_draws(cfg: XErteConfig, batch: int, rng_seed: int,
                 device) -> List[Optional[torch.Tensor]]:
    """The per-step (n_att, K) uniforms of a forward with ``rng_seed``:
    step s draws from a generator on ``device`` seeded from (s, rng_seed);
    n_att is ``batch`` at step 0 and ``batch * max_attended_edges`` after.
    None for the strategies that read no draws."""
    if cfg.sampling not in ("uniform", "weighted"):
        return [None] * cfg.dp_steps
    out = []
    for step in range(cfg.dp_steps):
        n_att = batch if step == 0 else batch * cfg.max_attended_edges
        gen = torch.Generator(device=device).manual_seed(
            17 + (int(rng_seed) << 8) + step)
        out.append(torch.rand((n_att, cfg.dp_num_edges), generator=gen,
                              device=device))
    return out


class XErte(nn.Module):
    """The xERTE model; parameters carry the flax names
    (``entity_raw_embed``, ``time_encoder.basis_freq``,
    ``transition_fn_{s}.query_proj``, ...), so a flax tree maps onto the
    state dict by a rename (`utils/port_params.params_from_flax`)."""

    def __init__(self, cfg: XErteConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.sampling not in SAMPLINGS:
            raise ValueError(
                "sampling must be one of uniform/first/last/weighted/"
                f"whole, got {cfg.sampling!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d0 = cfg.emb_dim[0]
        self.entity_raw_embed = nn.Parameter(torch.empty(cfg.n_ent, d0))
        self.relation_raw_embed = nn.Parameter(torch.empty(cfg.n_rel + 1,
                                                           d0))
        _xavier_normal_(self.entity_raw_embed, generator)
        _xavier_normal_(self.relation_raw_embed, generator)
        if cfg.use_time_embedding:  # flax creates it only when used
            self.time_encoder = TimeEncode(d0)
        self.node_emb_proj = _dense(
            2 * d0 if cfg.use_time_embedding else d0, d0, generator)
        for s in range(cfg.dp_steps):
            self.add_module(f"linear_between_steps_{s}", _dense(
                cfg.emb_dim[s], cfg.emb_dim[s + 1], generator))
        for s in range(cfg.dp_steps):
            self.add_module(f"transition_fn_{s}", G3(
                4 * cfg.emb_dim[s], 4 * cfg.emb_dim[s], generator))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.entity_raw_embed.device

    def _bypass(self, s: int, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(getattr(self, f"linear_between_steps_{s}")(x),
                            0.01)

    def _node_emb(self, ent: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
        base = _rows(self.entity_raw_embed, ent)
        if self.cfg.use_time_embedding:
            base = torch.cat([base, self.time_encoder(dt.float())], -1)
        return self.node_emb_proj(base)

    def forward(
        self,
        graph_rowptr: torch.Tensor,
        graph_rel: torch.Tensor,
        graph_tail: torch.Tensor,
        ekey: torch.Tensor,           # (n_edges,) head*time_key_base+time
        time_key_base: int,
        subs: torch.Tensor,           # (B,)
        rels: torch.Tensor,           # (B,)
        times: torch.Tensor,          # (B,) compact time ids
        qmask: torch.Tensor,          # (B,) bool
        rng_seed: int,                # sampling seed
        draws: Optional[Sequence[Optional[torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Returns (entity_mass (B, n_ent), aux) — the per-entity
        attention distribution the BCE loss and segment ranking act on.
        ``draws`` replaces `sample_draws(cfg, B, rng_seed, device)`."""
        cfg = self.cfg
        dev = self.device
        b = subs.shape[0]
        nkb, nt = cfg.node_key_base, cfg.n_time
        k = cfg.dp_num_edges
        subs, rels, times = subs.long(), rels.long(), times.long()
        qmask = qmask.bool()
        if draws is None:
            draws = sample_draws(cfg, b, rng_seed, dev)
        n_edges = graph_rel.shape[0]
        ar_k = torch.arange(k, device=dev)

        def query_row(eg):
            return torch.clamp(eg, max=b - 1)

        # ---- initialize: one node per query --------------------------
        visited_keys = torch.where(
            qmask, subs * nt + times + torch.arange(b, device=dev) * nkb,
            INVALID)
        visited_score = torch.where(qmask, 1.0 - 1e-8, 0.0)
        visited_repr = self._node_emb(subs, torch.zeros(b, device=dev))
        attended_slots = torch.arange(b, device=dev)
        attended_valid = qmask

        q_src_emb = visited_repr
        q_rel_emb = _rows(self.relation_raw_embed, rels)

        edge_lists: List[Dict[str, torch.Tensor]] = []
        overflows, steps = [], []

        for step in range(cfg.dp_steps):
            n_att = attended_slots.shape[0]
            # ---- sample K neighbors per attended node + self-loop ----
            att_keys = visited_keys[attended_slots]
            att_valid = attended_valid & (att_keys != INVALID)
            ent_i = torch.where(att_valid, (att_keys % nkb) // nt, 0)
            ts_i = torch.where(att_valid, att_keys % nt, 0)
            eg_i = torch.where(att_valid, att_keys // nkb, b)

            base = ent_i * time_key_base
            if cfg.time_bound == "cut":
                bound = ts_i
            else:
                bound = torch.where(att_valid, times[query_row(eg_i)], 0)
            lo = torch.searchsorted(ekey, base.to(ekey.dtype))
            hi = torch.searchsorted(ekey, (base + bound).to(ekey.dtype))
            span = hi - lo  # candidate historical edges (t' < bound)

            u = draws[step]
            if cfg.sampling == "uniform":
                off = (u * span[:, None]).long()
            elif cfg.sampling in ("first", "whole"):
                off = ar_k[None, :].expand(n_att, k)
            elif cfg.sampling == "last":
                off = span[:, None] - 1 - ar_k[None, :]
            else:  # weighted: exponential offsets from the window end
                off = span[:, None] - 1 - (
                    -torch.log(u + 1e-12) * cfg.weight_factor * k).long()
            off = torch.minimum(torch.clamp(off, min=0),
                                torch.clamp(span - 1, min=0)[:, None])
            samp_valid = (att_valid[:, None] & (span > 0)[:, None]
                          & (ar_k[None, :] < span[:, None]))
            # a gather past the table's end reads its last row in JAX
            edge_id = torch.clamp((lo[:, None] + off).reshape(-1),
                                  max=n_edges - 1)
            # + self-loop edge per attended node (`model.py:628`)
            e_rel = torch.cat([graph_rel[edge_id].long(),
                               torch.full((n_att,), cfg.n_rel, device=dev)])
            e_tail = torch.cat([graph_tail[edge_id].long(), ent_i])
            e_time = torch.cat([ekey[edge_id].long() % time_key_base, ts_i])
            e_src_slot = torch.cat([attended_slots.repeat_interleave(k),
                                    attended_slots])
            e_valid = torch.cat([samp_valid.reshape(-1), att_valid])
            e_eg = torch.cat([eg_i.repeat_interleave(k), eg_i])

            # ---- target node keys; extend visited set ---------------
            tgt_keys = torch.where(e_valid, e_eg * nkb + e_tail * nt + e_time,
                                   INVALID)
            v_cap_next = cfg.visited_cap(step + 1, b)
            n_old = visited_keys.shape[0]
            new_visited, inv, _, overflow = _dedup_keys(
                torch.cat([visited_keys, tgt_keys]), v_cap_next)
            overflows.append(overflow)
            old_pos = inv[:n_old]
            e_dst_slot = inv[n_old:]

            # scatter old state into the new slot space; INVALID keys are
            # dropped (see the module docstring)
            kept_pos = torch.where(visited_keys != INVALID, old_pos,
                                   v_cap_next)
            new_repr = scatter_drop(v_cap_next, kept_pos, visited_repr, 0.0)
            new_score = scatter_drop(v_cap_next, kept_pos, visited_score,
                                     0.0)
            filled = scatter_drop(v_cap_next, kept_pos,
                                  torch.ones(n_old, dtype=torch.bool,
                                             device=dev), False)
            nk = new_visited
            nk_valid = nk != INVALID
            nk_ent = torch.where(nk_valid, (nk % nkb) // nt, 0)
            nk_ts = torch.where(nk_valid, nk % nt, 0)
            nk_eg = torch.where(nk_valid, nk // nkb, 0)
            # node-relative time vs the query time (`model.py:577`)
            dt = nk_ts - times[query_row(nk_eg)]
            fresh_emb = self._node_emb(nk_ent, dt)
            for i in range(step):
                fresh_emb = self._bypass(i, fresh_emb)
            new_repr = torch.where((nk_valid & ~filled)[:, None], fresh_emb,
                                   new_repr)
            visited_keys = new_visited
            visited_repr = new_repr
            visited_score = new_score
            e_src_slot = old_pos[e_src_slot]  # into the new slot space

            # fresh relation embeddings pass through the previous steps'
            # bypass layers so dims line up (`model.py:521-523`)
            fresh_rel = _rows(self.relation_raw_embed, e_rel)
            for i in range(step):
                fresh_rel = self._bypass(i, fresh_rel)
            edge_lists.append({
                "src": e_src_slot, "dst": e_dst_slot,
                "rel_emb": fresh_rel, "eg": e_eg, "valid": e_valid,
            })

            # ---- transition attention + pruning (`model.py:204-244`) --
            for j in range(step):
                edge_lists[j]["rel_emb"] = self._bypass(
                    step - 1, edge_lists[j]["rel_emb"])
            g3 = getattr(self, f"transition_fn_{step}")

            def transition(edges):
                qs = _rows(q_src_emb, query_row(edges["eg"]))
                qr = _rows(q_rel_emb, query_row(edges["eg"]))
                left = torch.cat([_rows(visited_repr, edges["src"]),
                                  edges["rel_emb"], qs, qr], -1)
                right = torch.cat([_rows(visited_repr, edges["dst"]),
                                   edges["rel_emb"], qs, qr], -1)
                return segment_softmax(g3(left, right), edges["src"],
                                       visited_repr.shape[0],
                                       valid=edges["valid"])

            el = edge_lists[-1]
            alpha = transition(el)
            src_score = _rows(visited_score, el["src"])
            target_score = alpha * src_score
            keep = segment_topk_mask(target_score, el["eg"], b + 1,
                                     cfg.max_attended_edges,
                                     valid=el["valid"])
            el["valid"] = keep
            el["alpha"] = alpha
            steps.append({"edge_keys": tgt_keys, "target_score": target_score,
                          "keep": keep})

            # node score aggregation (`model.py:246-272`)
            dst = torch.where(keep, el["dst"], v_cap_next)
            if cfg.node_score_aggregation == "max":
                new_score = segment_max(
                    torch.where(keep, target_score, -1e30), dst, v_cap_next)
                new_score = torch.clamp(new_score, min=0.0)
            else:
                w = alpha
                if cfg.node_score_aggregation == "mean":
                    cnt = segment_sum(keep.float(), dst, v_cap_next)
                    w = alpha / torch.clamp(
                        cnt[torch.clamp(dst, max=v_cap_next - 1)], min=1.0)
                new_score = segment_sum(
                    torch.where(keep, w * src_score, 0.0), dst, v_cap_next)

            # L1-normalize per query (`model.py:478`)
            vk_valid = visited_keys != INVALID
            vk_eg = torch.where(vk_valid, visited_keys // nkb, b)
            visited_score = segment_normalize_l1(
                new_score, vk_eg, b + 1, valid=vk_valid & (new_score > 0))

            # ---- representation propagation over ALL edge lists ------
            def propagate(repr_, edges, weight):
                n = repr_.shape[0]
                valid = edges["valid"]
                agg = segment_sum(
                    torch.where(valid[:, None],
                                weight[:, None] * _rows(repr_, edges["src"]),
                                0.0),
                    edges["dst"], n)
                has_in = segment_sum(torch.where(valid, weight, 0.0),
                                     edges["dst"], n) > 0
                return torch.where(
                    has_in[:, None],
                    (1 - cfg.ratio_update) * agg + cfg.ratio_update * repr_,
                    repr_)

            visited_repr = propagate(visited_repr, el, el["alpha"])
            for j in range(step - 1, -1, -1):
                visited_repr = propagate(visited_repr, edge_lists[j],
                                         transition(edge_lists[j]))

            visited_repr = self._bypass(step, visited_repr)
            q_src_emb = self._bypass(step, q_src_emb)
            q_rel_emb = self._bypass(step, q_rel_emb)

            # ---- next attended set: target nodes of pruned edges -----
            att_keys_next = torch.where(keep, visited_keys[el["dst"]],
                                        INVALID)
            uniq, _, _, _ = _dedup_keys(att_keys_next,
                                        b * cfg.max_attended_edges)
            attended_slots = torch.clamp(
                torch.searchsorted(visited_keys, uniq), max=v_cap_next - 1)
            attended_valid = uniq != INVALID

        # ---- entity aggregation (`model.py:596-640`) ----------------
        att_keys = torch.where(attended_valid, visited_keys[attended_slots],
                               INVALID)
        att_score = torch.where(attended_valid,
                                _rows(visited_score, attended_slots), 0.0)
        eg = torch.where(attended_valid, att_keys // nkb, b)
        ent = torch.where(attended_valid, (att_keys % nkb) // nt, 0)
        flat = torch.where(eg < b, eg * cfg.n_ent + ent, b * cfg.n_ent)
        size = b * cfg.n_ent

        def add(values):
            return torch.zeros(size + 1, device=dev).index_add_(
                0, flat, values)[:size].view(b, cfg.n_ent)

        mass = add(att_score)
        if cfg.ent_score_aggregation == "mean":
            mass = mass / torch.clamp(add(attended_valid.float()), min=1.0)
        visited = scatter_drop(size, flat, attended_valid, False).view(
            b, cfg.n_ent)
        return mass, {"node_overflow": torch.stack(overflows),
                      "visited": visited, "steps": steps}


def bce_loss(entity_mass: torch.Tensor, targets: torch.Tensor,
             qmask: torch.Tensor) -> torch.Tensor:
    """BCE over per-entity attention with the (0.999x + 0.0009) squash
    (`model.py:550`). The reference sums over the sparse candidate list;
    dense zeros contribute a constant -log(1 - 0.0009) absorbed here."""
    n_ent = entity_mass.shape[1]
    p = entity_mass * 0.999 + 0.0009
    onehot = F.one_hot(targets.long(), n_ent).to(p.dtype)
    per = -(onehot * torch.log(p) + (1 - onehot) * torch.log1p(-p))
    qmask = qmask.bool()
    return torch.sum(torch.where(qmask[:, None], per, 0.0)) / torch.clamp(
        torch.sum(qmask) * n_ent, min=1)
