"""Train and eval loops for the temporal workloads.

Port of ``redgnn_tpu/train/temporal_loop.py``. Capability parity:
  * interpolation (`Temporal/interpolation/main.py:56-253`): shuffled
    quadruple batches, per-example leave-one-out, softmax + NLL mean loss
    (`:71-75`), AdamW + ReduceLROnPlateau on the valid loss
    (`:212-213,243`), the NaN scrub (`:87-93`), raw hits@k / MRR
    (`:154-164`), best checkpoint by valid hits@1 (`:247-249`);
  * extrapolation (`Temporal/extrapolation/main.py:286-481`): windowed
    propagation, NLL on dense scores (`:386-391`), Adam with coupled weight
    decay, raw / (s,p)-filtered / (s,p,t)-filtered ranking over the final
    frontier (`:404-411` -> `segment.py:346-387`).

As in `train/loop.py`, the steps of a chunk run back to back on the device
and the host reads it once per chunk (loss sum, overflow flag, rejected
steps); every parameter is a view of one flat vector and the optimizer is
one functional update over it. Frontier capacities are exact for the
batches they serve (per-query counts, `graph/calibrate.py`) and only grow.

Under a mesh (`parallel/mesh.py`, the data axis) every rank runs this
loop on the same global batches and takes its data shard of each: the
loss is the global mean NLL (the loss sum and the query count both
summed over the shards), the leave-one-out exclusion stays replicated, so
every shard drops the whole global batch's quadruples, and evaluation
sums each shard's metric sums.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from redgnn_tpu_torch.graph.calibrate import (
    FrontierCaps,
    caps_for_batches,
    per_query_counts_dense,
    per_query_counts_windowed,
)
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models.redgnn import _resolve_dedup
from redgnn_tpu_torch.models.temporal import TemporalModelConfig, TRedGNN
from redgnn_tpu_torch.ops.frontier import SENTINEL, scatter_drop
from redgnn_tpu_torch.ops.ranking import (
    frontier_rank_metric_sums,
    raw_rank_metric_sums,
)
from redgnn_tpu_torch.parallel.shard import (
    agree_caps,
    data_shard,
    reduce_step,
    sharded_config,
)
from redgnn_tpu_torch.train.loop import Adam, FlatParams, nan_scrub
from redgnn_tpu_torch.utils.checkpoint import (
    load_host,
    load_trainer_checkpoint,
    save_checkpoint,
    save_latest,
)
from redgnn_tpu_torch.utils.config import TemporalTrainConfig
from redgnn_tpu_torch.utils.timers import PhaseTimer

RAW_SUMS = ("rr_sum", "h1_sum", "h3_sum", "h10_sum", "count", "loss_sum")
EX_SUMS = tuple(
    [f"{pre}_{s}_sum" for pre in ("raw", "fil", "fil_t")
     for s in ("rr", "h1", "h3", "h10", "mr")]
    + ["count", "found_sum", "loss_sum"])


def nll_sum(scores: torch.Tensor, targets: torch.Tensor,
            qmask: torch.Tensor) -> torch.Tensor:
    """sum over the live queries of -log(softmax(s)[target] + 1e-12)."""
    logp = torch.log_softmax(scores, dim=1)
    p = torch.exp(logp.gather(1, targets.long()[:, None])[:, 0])
    per_row = -torch.log(p + 1e-12)
    return torch.sum(torch.where(qmask, per_row, 0.0))


def nll_softmax_loss(scores: torch.Tensor, targets: torch.Tensor,
                     qmask: torch.Tensor) -> torch.Tensor:
    """mean over the live queries of -log(softmax(s)[target] + 1e-12)
    (`Temporal/interpolation/main.py:71-75`)."""
    return nll_sum(scores, targets, qmask) / torch.clamp(torch.sum(qmask),
                                                         min=1)


def stage_quads(data: np.ndarray, b: int, device) -> torch.Tensor:
    """(nb, 5, b) int32 device batches of quadruples ``data``: rows subs,
    rels, objs, times and qmask, zero-padded to whole batches (the JAX
    trainers' ``_batches``)."""
    nb = -(-len(data) // b)
    rows = np.zeros((nb * b, 5), np.int32)
    rows[:len(data), :4] = data[:, :4]
    rows[:len(data), 4] = 1
    return torch.as_tensor(rows.reshape(nb, b, 5).transpose(0, 2, 1).copy(),
                           device=device)


def stage_filter_indices(sp2o, spt2o, data, b: int, n_ent: int):
    """Padded known-answer index lists per eval query, staged once per
    split. Returns (fil_idx, filt_idx) of shape (nb, b, max_k) with pad id
    ``n_ent``: entities to exclude from ranking under the (s,p)-filtered
    and (s,p,t)-filtered protocols (`Temporal/extrapolation/segment.py:
    346-387`), the target kept in."""
    fil_rows, filt_rows = [], []
    for s, p, o, t in data:
        fil_rows.append([e for e in sp2o.get((s, p), ()) if e != o])
        filt_rows.append([e for e in spt2o.get((s, p, t), ()) if e != o])
    nb = -(-len(data) // b)

    def pack(rows_list):
        m = max((len(r) for r in rows_list), default=1) or 1
        m = -(-m // 32) * 32  # rounded up, as in the JAX package
        out = np.full((nb * b, m), n_ent, np.int64)
        for i, r in enumerate(rows_list):
            out[i, :len(r)] = r
        return out.reshape(nb, b, m)

    return pack(fil_rows), pack(filt_rows)


def answer_filters(splits) -> tuple:
    """(s,p) -> sorted known objects and (s,p,t) -> sorted known objects
    over the train, valid and test quadruples: the filters of the
    extrapolation protocol (`Temporal/extrapolation/segment.py:346-387`)."""
    sp2o: Dict[tuple, set] = defaultdict(set)
    spt2o: Dict[tuple, set] = defaultdict(set)
    for split in ("train", "valid", "test"):
        for s, p, o, t in splits[split]:
            sp2o[(s, p)].add(o)
            spt2o[(s, p, t)].add(o)
    return ({k: np.array(sorted(v)) for k, v in sp2o.items()},
            {k: np.array(sorted(v)) for k, v in spt2o.items()})


def _windowed(cfg: TemporalTrainConfig) -> bool:
    return cfg.mode == "extrapolation" and cfg.window is not None


def query_counts(kg: TemporalKG, cfg: TemporalTrainConfig,
                 data: np.ndarray):
    """Exact per-query hop counts (nodes (n, L+1), edges (n, L)) of the
    quadruples ``data``: windowed in extrapolation, by head over the whole
    timeline otherwise.

    Both take the scipy bitmap walk, where the JAX package takes its
    native walker: of the port's two walkers, which give the same counts
    (graph/calibrate.py), the bitmap walk was the faster on ICEWS14-sized
    test splits, timed on the host CPU of an NVIDIA H100 machine
    (chip_smoke.py phase 7, PERF.md §5): 1.6-1.7x over the whole timeline
    and 3.6-5.9x in the window, where the native walker walks each
    (head, time) pair and the bitmap walk each time once."""
    if _windowed(cfg):
        return per_query_counts_windowed(
            kg.ekey_np, kg.graph_np[2], kg.n_ent, kg.time_key_base,
            data[:, 0], data[:, 3], cfg.window, cfg.n_layer)
    return per_query_counts_dense(kg.graph_np[0], kg.graph_np[2], kg.n_ent,
                                  data[:, 0], cfg.n_layer)


def exact_caps(kg: TemporalKG, cfg: TemporalTrainConfig, data: np.ndarray,
               b: int) -> FrontierCaps:
    """Exact caps of every contiguous batch of ``b`` rows of ``data``."""
    return caps_for_batches(*query_counts(kg, cfg, data), b)


def _keep_mask(idx: torch.Tensor, n_ent: int) -> torch.Tensor:
    """(b, M) padded entity lists (pad id ``n_ent``) -> (b, n_ent) bool,
    False at the listed entities."""
    out = torch.ones((idx.shape[0], n_ent + 1), dtype=torch.bool,
                     device=idx.device)
    out.scatter_(1, idx.clamp(0, n_ent).long(), False)
    return out[:, :n_ent]


class TemporalOptimizer:
    """The JAX trainer's optax chain as one functional update over a flat
    vector: ``inject_hyperparams`` (the learning rate ``lr`` lives in the
    state, so the plateau scheduler rewrites it without touching the
    moments) over ``adamw`` (decoupled decay, ``optimizer='adamw'``) or
    ``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``
    (coupled L2, torch's ``Adam(weight_decay=...)``, `optimizer='adam'`),
    after ``clip_by_global_norm(grad_clip)`` when set, all inside
    ``MultiSteps(grad_accum_steps)`` when that is above 1 (gradients are
    averaged over k calls; the inner update is applied on the k-th)."""

    def __init__(self, optimizer: str, weight_decay: float,
                 grad_clip: Optional[float], accum_steps: int):
        if optimizer not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.decoupled = optimizer == "adamw"
        self.wd = weight_decay
        self.clip = (grad_clip if grad_clip is not None
                     and np.isfinite(grad_clip) and grad_clip > 0 else None)
        self.k = accum_steps
        self.adam = Adam(0.0, 1.0, 0.0, 1)  # its moments only

    def init(self, params: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        dev = params.device
        state = self.adam.init(params)
        state["lr"] = torch.tensor(lr, dtype=torch.float32, device=dev)
        if self.k > 1:
            state["acc_grads"] = torch.zeros_like(params)
            state["mini_step"] = torch.zeros((), dtype=torch.int64,
                                             device=dev)
            state["gradient_step"] = torch.zeros((), dtype=torch.int64,
                                                 device=dev)
        return state

    def _inner(self, g, state, params):
        if self.clip is not None:
            norm = torch.sqrt(torch.sum(g * g))
            g = torch.where(norm < self.clip, g, g / norm * self.clip)
        if not self.decoupled:
            g = g + self.wd * params
        direction, new = self.adam.moments(g, state)
        if self.decoupled:
            direction = direction + self.wd * params
        new["lr"] = state["lr"]
        return -state["lr"] * direction, new

    def update(self, grads: torch.Tensor, state: Dict[str, torch.Tensor],
               params: torch.Tensor):
        """(updates, new_state); nothing is modified in place."""
        if self.k == 1:
            return self._inner(grads, state, params)
        mini = state["mini_step"]
        acc = state["acc_grads"] + (grads - state["acc_grads"]) / (
            mini + 1).to(grads.dtype)
        updates, inner = self._inner(acc, state, params)
        emit = mini == self.k - 1
        new = {k: torch.where(emit, inner[k], state[k])
               for k in ("mu", "nu", "count", "lr")}
        new["mini_step"] = (mini + 1) % self.k
        new["gradient_step"] = state["gradient_step"] + emit.long()
        # products, not selections: a non-finite value stays visible to
        # the step's finiteness check, as in optax
        on = emit.to(grads.dtype)
        new["acc_grads"] = (1 - on) * acc
        return on * updates, new


class TemporalTrainer(FlatParams):
    """Epoch loop for temporal KGC (interpolation and extrapolation) on
    the KG's device, or on each rank of a mesh."""

    def __init__(self, kg: TemporalKG, cfg: TemporalTrainConfig, mesh=None):
        """``mesh`` (`parallel/mesh.py`; every rank builds its trainer
        alike) runs every train and eval step data-parallel: queries shard
        over 'data', the graph and the parameters are replicated, and the
        loss and metric sums are summed over the mesh. Frontier caps are
        per shard (``batch / n_data`` queries)."""
        self.kg = kg
        self.cfg = cfg
        self.device = kg.device
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._init_mesh(mesh, cfg.seed)
        if cfg.batch_size % self.n_data or cfg.eval_batch_size % self.n_data:
            raise ValueError(
                f"batch sizes ({cfg.batch_size}/{cfg.eval_batch_size}) must "
                f"divide the mesh data axis ({self.n_data})")
        self.model_cfg = TemporalModelConfig(
            n_ent=kg.n_ent,
            n_rel_vocab=kg.n_rel + 1,
            idd_rel=kg.idd_rel,
            hidden_dim=cfg.hidden_dim, attn_dim=cfg.attn_dim,
            n_layer=cfg.n_layer, dropout=cfg.dropout, act=cfg.act,
            mode=cfg.mode, window=cfg.window,
            time_key_base=kg.time_key_base,
            n_frequencies=cfg.n_frequencies,
            segment_impl=cfg.segment_impl,
            scan_src_backward=cfg.scan_src_backward,
            dense_hops=cfg.dense_hops, dense_switch=cfg.dense_switch,
            use_time=cfg.use_time, use_attention=cfg.use_attention,
            direction_transform=cfg.direction_transform,
            time_embedding=cfg.time_embedding,
            n_time=kg.n_time if cfg.time_embedding == "absolute" else None,
            edge_dropout=cfg.edge_dropout,
        )
        # the JAX trainer initializes its parameters through a forward with
        # sparse hops only, which refuses what a sparse hop refuses (bitmap
        # dedup under segment_impl='pallas'); so does this one
        _resolve_dedup(self.model_cfg.dedup_impl, cfg.batch_size * kg.n_ent,
                       64, cfg.segment_impl)
        # under a mesh: plain gathers and the strict backward, as the JAX
        # trainer's shard model has them (no parameter changes)
        self.model = TRedGNN(
            self.model_cfg if mesh is None
            else sharded_config(self.model_cfg, mesh), device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed))
        self._init_flat()
        self.tx = TemporalOptimizer(cfg.optimizer, cfg.weight_decay,
                                    cfg.grad_clip, cfg.grad_accum_steps)
        self.opt_state = self.tx.init(self._flat, cfg.lr)

        # ReduceLROnPlateau state (torch semantics: factor, patience)
        self._lr = cfg.lr
        self._plateau_best = np.inf
        self._plateau_bad = 0

        self.caps: Dict[str, FrontierCaps] = {}
        self.ckpt_dir: Optional[str] = None  # set by fit() for mid-epoch saves
        self.t_train = 0.0
        self._np_rng = np.random.default_rng(cfg.seed)
        self.history: List[Dict[str, Any]] = []
        self.timer = PhaseTimer(enabled=False)
        # device-to-host reads made by train_epoch and evaluate
        self.host_syncs = 0
        # exact per-query hop counts: interpolation by head (walked on
        # demand, -1 = not walked yet), extrapolation by split row
        self._pq_head = None
        self._pq_split: Dict[str, tuple] = {}
        self._fil_cache: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    def _forward(self, subs, rels, times, qmask, caps, exclude=None,
                 train: bool = False):
        graph, etime, ekey, selfloop_slot, time_rowptr, dense = \
            self.kg.model_args()
        return self.model(graph, etime, subs, rels, times, qmask, caps,
                          exclude, train, ekey, selfloop_slot, time_rowptr,
                          dense, generator=self._drop_rng if train else None)

    def _cap_b(self, b: int) -> int:
        """Frontier caps are per shard under a mesh (each rank expands its
        own b / n_data sub-batch)."""
        return b // self.n_data

    def _loss_and_grads(self, subs, rels, objs, times, qmask, exclude,
                        caps: FrontierCaps):
        """One batch's (loss, flat gradient, overflow), device tensors.
        Under a mesh the batch is global: the rank differentiates its
        shard's loss sum over the global query count, and one all-reduce
        sums gradient, loss and overflow flag over the mesh (the same on
        every rank); ``exclude`` stays the global batch's."""
        mesh = self.mesh
        with record_function("step.forward"):
            if mesh is None:
                scores, aux = self._forward(subs, rels, times, qmask, caps,
                                            exclude, train=True)
                loss = nll_softmax_loss(scores, objs, qmask)
            else:
                count = torch.clamp(torch.sum(qmask), min=1)
                sl = data_shard(mesh, subs.shape[0])
                scores, aux = self._forward(subs[sl], rels[sl], times[sl],
                                            qmask[sl], caps, exclude,
                                            train=True)
                # the edge ranks (if any) hold identical copies
                loss = nll_sum(scores, objs[sl], qmask[sl]) / (
                    count * mesh.size("edge"))
        with record_function("step.backward"):
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
            with torch.no_grad():
                # an unused parameter (e.g. now_linear in extrapolation)
                # has a zero gradient, as in JAX
                g = torch.cat([(torch.zeros_like(p) if x is None else x)
                               .reshape(-1)
                               for x, p in zip(grads, self._params)])
                overflow = (torch.any(aux["edge_overflow"])
                            | torch.any(aux["node_overflow"]))
                loss = loss.detach()
                if mesh is not None:
                    g, loss, overflow = reduce_step(mesh, g, loss, overflow)
                return loss, g, overflow

    def _train_step(self, subs, rels, objs, times, qmask, exclude,
                    caps: FrontierCaps):
        """One step on device tensors: forward, loss, backward, the gated
        update and the scrub. Returns device scalars (loss, overflow,
        rejected); reads nothing back."""
        loss, g, overflow = self._loss_and_grads(subs, rels, objs, times,
                                                 qmask, exclude, caps)
        with record_function("step.optimizer"), torch.no_grad():
            # Reject the whole update when the loss, any gradient, the
            # update or any new floating state is non-finite: parameters
            # and the whole optimizer state (moments, counts, the
            # accumulator) stay bit-identical.
            updates, new = self.tx.update(g, self.opt_state, self._flat)
            finite = (torch.isfinite(loss) & torch.isfinite(g).all()
                      & torch.isfinite(updates).all())
            for v in new.values():
                if v.is_floating_point():
                    finite = finite & torch.isfinite(v).all()
            flat = torch.where(finite, self._flat + updates, self._flat)
            for k, v in new.items():
                self.opt_state[k].copy_(torch.where(finite, v,
                                                    self.opt_state[k]))
            self._flat.copy_(nan_scrub(flat, self._owner,
                                       len(self._params), self.rng))
            loss = torch.where(finite, loss, 0.0)
        return loss, overflow, ~finite

    def _run_chunk(self, batches: torch.Tensor, caps: FrontierCaps):
        """``batches`` (steps, 6, b) int32 on the device — rows subs, rels,
        objs, times, qmask, leave-one-out slots (ignored outside
        interpolation). Returns device scalars (loss_sum, overflow_any,
        rejected steps)."""
        loss_sum = torch.zeros((), device=self.device)
        overflow_any = torch.zeros((), dtype=torch.bool, device=self.device)
        n_bad = torch.zeros((), dtype=torch.int32, device=self.device)
        loo = self.cfg.mode == "interpolation"
        for subs, rels, objs, times, qm, excl in batches.unbind(0):
            loss, overflow, bad = self._train_step(
                subs, rels, objs, times, qm.bool(), excl if loo else None,
                caps)
            loss_sum = loss_sum + loss
            overflow_any = overflow_any | overflow
            n_bad = n_bad + bad.to(torch.int32)
        return loss_sum, overflow_any, n_bad

    # ------------------------------------------------------------------
    def _caps_cache_path(self, split: str, b: int) -> Optional[str]:
        if not self.ckpt_dir:
            return None
        cfg = self.cfg
        return os.path.join(
            self.ckpt_dir,
            f"caps_{split}_b{b}_h{cfg.cap_headroom}_L{cfg.n_layer}.json")

    def _pq_heads(self, heads: np.ndarray):
        """Exact hop counts of whole-timeline queries, by head (they depend
        on the head alone). Only the heads asked for are walked, once;
        the table is kept beside the checkpoints."""
        cfg, kg = self.cfg, self.kg
        path = (os.path.join(self.ckpt_dir, f"pq_heads_L{cfg.n_layer}.npz")
                if self.ckpt_dir else None)
        if self._pq_head is None:
            self._pq_head = (np.full((kg.n_ent, cfg.n_layer + 1), -1,
                                     np.int64),
                             np.full((kg.n_ent, cfg.n_layer), -1, np.int64))
            if path and os.path.exists(path):
                z = np.load(path)
                if z["nodes"].shape == self._pq_head[0].shape:
                    self._pq_head = (z["nodes"], z["edges"])
        nc, ec = self._pq_head
        heads = np.asarray(heads, np.int64)
        todo = np.unique(heads[nc[heads, 0] < 0])
        if len(todo):
            nc[todo], ec[todo] = per_query_counts_dense(
                kg.graph_np[0], kg.graph_np[2], kg.n_ent, todo, cfg.n_layer)
            if path:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.savez(path, nodes=nc, edges=ec)
        return nc[heads], ec[heads]

    def _split_pq_windowed(self, split: str):
        """Windowed per-query counts aligned with kg.splits[split] rows."""
        if split in self._pq_split:
            return self._pq_split[split]
        cfg, kg = self.cfg, self.kg
        data = kg.splits[split]
        path = None
        if self.ckpt_dir:
            path = os.path.join(
                self.ckpt_dir,
                f"pq_{split}_L{cfg.n_layer}_w{cfg.window}.npz")
            if os.path.exists(path):
                z = np.load(path)
                if len(z["nodes"]) == len(data):
                    self._pq_split[split] = (z["nodes"], z["edges"])
                    return self._pq_split[split]
        nc, ec = query_counts(kg, cfg, data)
        self._pq_split[split] = (nc, ec)
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez(path, nodes=nc, edges=ec)
        return nc, ec

    def _pq_for(self, data: np.ndarray, base_split: str,
                order: Optional[np.ndarray] = None):
        """Per-query count rows aligned with ``data`` (the batch order:
        permuted for train, split order for eval)."""
        if _windowed(self.cfg):
            nc, ec = self._split_pq_windowed(base_split)
            if order is not None:
                return nc[order], ec[order]
            return nc[: len(data)], ec[: len(data)]
        return self._pq_heads(data[:, 0])

    def _get_caps(self, split: str, data: np.ndarray, b: int,
                  order: Optional[np.ndarray] = None) -> FrontierCaps:
        """Exact caps for the given batch order, grow-only across calls
        (a persisted JSON seeds the floor): with them an overflow cannot
        happen for the batches they were computed over."""
        cur = self.caps.get(split)
        if cur is None:
            path = self._caps_cache_path(split, b)
            if path and os.path.exists(path):
                with open(path) as f:
                    d = json.load(f)
                cur = FrontierCaps(tuple(d["node_caps"]),
                                   tuple(d["edge_caps"]))
        base = split.split("_", 1)[1] if split.startswith(
            ("eval_", "attn_")) else split
        nc, ec = self._pq_for(data, base, order)
        needed = caps_for_batches(nc, ec, b)
        if cur is None:
            self.caps[split] = agree_caps(self.mesh, needed)
            self._persist_caps(split, b)
        elif not cur.covers(needed):
            self.caps[split] = agree_caps(self.mesh, cur.union(needed))
            self._persist_caps(split, b)
        else:
            self.caps[split] = agree_caps(self.mesh, cur)
        return self.caps[split]

    def _persist_caps(self, split: str, b: int) -> None:
        path = self._caps_cache_path(split, b)
        if not path:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        c = self.caps[split]
        with open(path, "w") as f:
            json.dump({"node_caps": list(c.node_caps),
                       "edge_caps": list(c.edge_caps)}, f)

    def _recalibrate_exact(self, split: str, data: np.ndarray, b: int):
        """Grow ``split``'s caps to cover every contiguous batch of ``b``
        rows of ``data``."""
        if _windowed(self.cfg):
            nc, ec = query_counts(self.kg, self.cfg, data)
        else:
            nc, ec = self._pq_heads(data[:, 0])
        self.caps[split] = agree_caps(
            self.mesh, self.caps[split].union(caps_for_batches(nc, ec, b)))
        self._persist_caps(split, b)

    # ------------------------------------------------------------------
    def _stage(self, data: np.ndarray, b: int, *extra: np.ndarray):
        """(nb, b) int32 device columns subs, rels, objs, times and qmask
        of ``data`` zero-padded to whole batches, then each of ``extra``
        (arrays of nb * b rows, padded by the caller)."""
        nb = -(-len(data) // b)
        pad = nb * b - len(data)
        padded = np.concatenate([data, np.zeros((pad, 4), np.int64)])
        qmask = np.ones(nb * b, np.int64)
        if pad:
            qmask[-pad:] = 0
        cols = [padded[:, j] for j in range(4)] + [qmask] + list(extra)
        return [torch.as_tensor(c.reshape((nb, b) + c.shape[1:])
                                .astype(np.int32), device=self.device)
                for c in cols]

    def train_epoch(self, epoch: int) -> float:
        """One shuffled pass over the training quadruples (the first
        ``max_train_batches`` batches of it when set). Each chunk of
        ``scan_chunk`` steps runs without a host read and ends in one;
        if a frontier bucket overflowed, only that chunk is rolled back
        (parameters, optimizer state, generator) and replayed with caps
        grown to cover it."""
        cfg, kg = self.cfg, self.kg
        t0 = time.time()
        b = cfg.batch_size
        with self.timer.phase("train", "stage"):
            train = kg.splits["train"]
            order = self._np_rng.permutation(len(train))
            if cfg.max_train_batches is not None:
                order = order[: cfg.max_train_batches * b]
            data = train[order]
            caps = self._get_caps("train", data, self._cap_b(b),
                                  order=order)
            nb = -(-len(data) // b)
            if cfg.mode == "interpolation":
                # graph row = train-file row for interpolation graphs; pads
                # exclude an out-of-range slot, i.e. nothing
                excl = np.concatenate([
                    kg.exclusion_slots(order),
                    np.full(nb * b - len(data), len(kg.graph_quads),
                            np.int64)])
            else:
                excl = np.zeros(nb * b, np.int64)
            batches = torch.stack(self._stage(data, b, excl), 1)

        total = 0.0
        with self.timer.phase("train", "device"):
            start, retries = 0, 0
            while start < nb:
                stop = min(start + cfg.scan_chunk, nb)
                snap = self._snapshot()
                loss_sum, overflow, n_bad = self._run_chunk(
                    batches[start:stop], caps)
                overflow, loss_sum, n_bad = torch.stack(
                    [overflow.float(), loss_sum, n_bad.float()]).tolist()
                self.host_syncs += 1
                if overflow:
                    if retries >= 3:
                        raise RuntimeError(
                            "temporal train caps failed to stabilize")
                    retries += 1
                    self._rollback(snap)
                    self._recalibrate_exact("train", data[start * b:stop * b],
                                            self._cap_b(b))
                    caps = self.caps["train"]
                    print(f"  epoch {epoch}: overflow in chunk at step "
                          f"{start} — grew caps, retrying chunk (kept "
                          f"{start} steps)", flush=True)
                    continue
                retries = 0
                if n_bad:
                    print(f"  epoch {epoch}: {int(n_bad)} non-finite step(s) "
                          f"rejected in chunk at {start}", flush=True)
                total += loss_sum
                # intra-epoch progress anchor
                if self.ckpt_dir and (start // cfg.scan_chunk) % 8 == 7:
                    save_latest(self.ckpt_dir, self.state(), epoch, -1.0,
                                host=self.host_state())
                start = stop
        self.t_train += time.time() - t0
        return total

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_chunk(self, staged, caps: FrontierCaps):
        """Metric sums and the overflow flag over a chunk of staged eval
        batches, accumulated on the device."""
        ex = self.cfg.mode == "extrapolation"
        names = EX_SUMS if ex else RAW_SUMS
        n_ent = self.kg.n_ent
        sums = torch.zeros(len(names), device=self.device)
        overflow_any = torch.zeros((), dtype=torch.bool, device=self.device)
        if self.mesh is not None:
            sl = data_shard(self.mesh, staged[0].shape[1])
            staged = [t[:, sl] for t in staged]
        for batch in zip(*staged):
            subs, rels, objs, times, qmask = batch[:5]
            qmask = qmask.bool()
            scores, aux = self._forward(subs, rels, times, qmask, caps)
            if ex:
                b = subs.shape[0]
                keys = aux["frontier_keys"]
                valid = keys != SENTINEL
                flat = torch.where(valid, keys.long(), b * n_ent)
                prob = scatter_drop(
                    b * n_ent, flat,
                    torch.where(valid, aux["frontier_softmax"], 0.0),
                    0).view(b, n_ent)
                visited = scatter_drop(b * n_ent, flat, valid,
                                       False).view(b, n_ent)
                part = frontier_rank_metric_sums(
                    prob, visited, objs, qmask,
                    _keep_mask(batch[5], n_ent), _keep_mask(batch[6], n_ent))
            else:
                part = raw_rank_metric_sums(scores, objs, qmask)
            part["loss_sum"] = nll_softmax_loss(scores, objs, qmask) \
                * torch.sum(qmask)
            sums = sums + torch.stack([part[k].to(torch.float32)
                                       for k in names])
            overflow_any = (overflow_any | torch.any(aux["edge_overflow"])
                            | torch.any(aux["node_overflow"]))
        return self._reduce_sums(sums, overflow_any)

    def evaluate(self, split: str) -> Dict[str, float]:
        """Interpolation: raw MRR / Hits@k over the dense scores.
        Extrapolation: raw, (s,p)-filtered and (s,p,t)-filtered ranks over
        the final frontier (``mrr``, ``h1``... are the filtered ones). The
        first ``max_eval_batches`` batches of the split when set; one host
        read per chunk of ``scan_chunk`` batches."""
        cfg, kg = self.cfg, self.kg
        data = kg.splits[split]
        if cfg.max_eval_batches is not None:
            data = data[: cfg.max_eval_batches * cfg.eval_batch_size]
        b = cfg.eval_batch_size
        caps = self._get_caps(f"eval_{split}", data, self._cap_b(b))
        with self.timer.phase("eval", "stage"):
            extra = ()
            if cfg.mode == "extrapolation":
                fil3, filt3 = self._staged_filters(split, data, b)
                extra = tuple(torch.as_tensor(a.astype(np.int32),
                                              device=self.device)
                              for a in (fil3, filt3))
            staged = self._stage(data, b)[:5] + list(extra)
        names = EX_SUMS if cfg.mode == "extrapolation" else RAW_SUMS
        nb = staged[0].shape[0]
        for _ in range(3):
            partials, overflow_seen = [], False
            for start in range(0, nb, cfg.scan_chunk):
                sums, overflow = self._eval_chunk(
                    [t[start:start + cfg.scan_chunk] for t in staged], caps)
                *sums, overflow = torch.cat(
                    [sums, overflow.to(sums.dtype)[None]]).tolist()
                self.host_syncs += 1
                if overflow:
                    overflow_seen = True
                    break
                partials.append(dict(zip(names, sums)))
            if not overflow_seen:
                return self._combine(partials)
            self._recalibrate_exact(f"eval_{split}", data, self._cap_b(b))
            caps = self.caps[f"eval_{split}"]
        raise RuntimeError("temporal eval caps failed to stabilize")

    @staticmethod
    def _combine(partials) -> Dict[str, float]:
        tot = defaultdict(float)
        for p in partials:
            for k, v in p.items():
                tot[k] += float(v)
        n = max(tot["count"], 1.0)
        out = {"n": tot["count"], "loss": tot["loss_sum"] / n}
        prefixes = [""] if "rr_sum" in tot else ["raw_", "fil_", "fil_t_"]
        for pre in prefixes:
            out[f"{pre}mrr"] = tot[f"{pre}rr_sum"] / n
            for h in ("h1", "h3", "h10"):
                out[f"{pre}{h}"] = tot[f"{pre}{h}_sum"] / n
        if "found_sum" in tot:
            out["found_rate"] = tot["found_sum"] / n
        # the extrapolation names: mrr, h1, ... are the filtered metrics
        if "raw_mrr" in out:
            out["mrr"], out["h1"], out["h3"], out["h10"] = (
                out["fil_mrr"], out["fil_h1"], out["fil_h3"], out["fil_h10"])
        return out

    def _staged_filters(self, split: str, data: np.ndarray, b: int):
        key = (split, len(data), b)
        cached = self._fil_cache.get(key)
        if cached is None:
            sp2o, spt2o = self._filters()
            cached = stage_filter_indices(sp2o, spt2o, data, b,
                                          self.kg.n_ent)
            self._fil_cache[key] = cached
        return cached

    def _filters(self):
        if not hasattr(self, "_sp2o"):
            self._sp2o, self._spt2o = answer_filters(self.kg.splits)
        return self._sp2o, self._spt2o

    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect_attention(self, split: str = "valid",
                          max_batches: int = 8) -> np.ndarray:
        """(n_rel, n_rel, 2) [attention sum, count] keyed by (query rel,
        edge rel) — the reference's attention_vis bookkeeping
        (`model_cuda_new_embdding.py:117-125,169-172`), from a few forward
        passes of a `collect_alpha` twin of the model (sparse hops only)
        over whole batches of ``split``; under a mesh every rank computes
        the same statistics."""
        import dataclasses

        from redgnn_tpu_torch.utils.viz import collect_attention_stats

        model = TRedGNN(dataclasses.replace(
            self.model.cfg, collect_alpha=True, dense_hops=False),
            device=self.device)
        model.load_state_dict(self.model.state_dict())
        b = self.cfg.eval_batch_size
        data = self.kg.splits[split][: max_batches * b]
        # whole-batch caps of their own: this forward is not sharded
        caps = self._get_caps(f"attn_{split}", data, b)
        n_rel = self.model_cfg.n_rel_vocab
        graph, etime, ekey, selfloop_slot, time_rowptr, dense = \
            self.kg.model_args()
        staged = self._stage(data, b)
        for _ in range(3):
            acc = np.zeros((n_rel, n_rel, 2))
            overflow_seen = False
            for subs, rels, _, times, qmask in zip(*staged):
                _, aux = model(graph, etime, subs, rels, times,
                               qmask.bool(), caps, None, False, ekey,
                               selfloop_slot, time_rowptr, dense)
                if bool(torch.any(aux["edge_overflow"])
                        | torch.any(aux["node_overflow"])):
                    overflow_seen = True
                    break
                for a, er, qr, va in zip(*([t.cpu().numpy() for t in aux[k]]
                                           for k in ("alpha", "alpha_rel",
                                                     "alpha_qrel",
                                                     "alpha_valid"))):
                    acc += collect_attention_stats(a, er, qr, va, n_rel)
            if not overflow_seen:
                return acc
            self._recalibrate_exact(f"attn_{split}", data, b)
            caps = self.caps[f"attn_{split}"]
        raise RuntimeError("attention-stats caps failed to stabilize")

    # ------------------------------------------------------------------
    def plateau_step(self, valid_loss: float) -> None:
        """torch ReduceLROnPlateau(mode=min) semantics; a cut is written
        into the optimizer's live learning rate."""
        if valid_loss < self._plateau_best - 1e-8:
            self._plateau_best = valid_loss
            self._plateau_bad = 0
            return
        self._plateau_bad += 1
        if self._plateau_bad > self.cfg.patience:
            self.force_lr(self._lr * self.cfg.plateau_factor)
            self._plateau_bad = 0

    def force_lr(self, lr: float) -> None:
        """Set the live learning rate (host mirror and optimizer state;
        the moments are kept). A restore brings back the checkpoint's lr,
        so an explicit one is written through after it."""
        self._lr = float(lr)
        self.opt_state["lr"].fill_(self._lr)

    def _sync_lr_from_opt(self) -> None:
        self._lr = float(self.opt_state["lr"])

    def host_state(self) -> Dict[str, Any]:
        """Host-side state (plateau counters, rngs): the checkpoint's JSON
        sidecar; `state()` holds the device tensors."""
        return {
            "lr": float(self._lr),
            "plateau_best": float(self._plateau_best),
            "plateau_bad": int(self._plateau_bad),
            "np_rng": self._np_rng.bit_generator.state,
            "torch_rng": self.rng.get_state().tolist(),
        }

    def restore_host(self, ckpt_path: str) -> None:
        """Re-apply host-side training state after a restore. The sidecar's
        lr is authoritative and written through to the optimizer; without
        a sidecar the live lr is read back from the optimizer state. A
        sidecar of the JAX package (its ``jax_rng`` has no counterpart
        here) restores lr, plateau counters and the numpy rng."""
        host = load_host(ckpt_path)
        if host is None:
            self._sync_lr_from_opt()
            return
        self.force_lr(float(host["lr"]))
        self._plateau_best = float(host["plateau_best"])
        self._plateau_bad = int(host["plateau_bad"])
        try:
            self._np_rng.bit_generator.state = host["np_rng"]
        except (KeyError, ValueError):
            pass
        if "torch_rng" in host:
            self.rng.set_state(torch.tensor(host["torch_rng"],
                                            dtype=torch.uint8))

    def save(self, ckpt_dir: str, epoch: int, metric: float) -> str:
        return save_checkpoint(ckpt_dir, self.state(), epoch, metric,
                               host=self.host_state())

    def restore(self, path: str) -> int:
        """Restore parameters, optimizer state and host state from a
        checkpoint of this trainer (``.pt``) or of the JAX package's
        TemporalTrainer (``.msgpack`` with its ``.host.json``); a state of
        another structure (model shape, optimizer chain) raises."""
        state, epoch = load_trainer_checkpoint(path, self.state())
        self.load_state(state)
        self.restore_host(path)
        return epoch

    def fit(self, epochs: Optional[int] = None, log=print, logger=None,
            ckpt_dir: Optional[str] = None,
            start_epoch: int = 0) -> Dict[str, Any]:
        """Train, evaluate valid (plateau scheduler on its loss), evaluate
        test and save on a new best valid hits@1; ``logger``
        (`utils/reporting.py:ExperimentLogger`) gets each epoch's row."""
        epochs = epochs or self.cfg.epochs
        self.ckpt_dir = ckpt_dir
        best: Dict[str, Any] = {"valid_h1": -1.0}
        for epoch in range(start_epoch, epochs):
            loss = self.train_epoch(epoch)
            vm = self.evaluate("valid")
            self.plateau_step(vm["loss"])
            row = {"epoch": epoch, "loss": loss, "lr": self._lr,
                   **{f"valid_{k}": v for k, v in vm.items()}}
            if vm["h1"] > best["valid_h1"]:
                tm = self.evaluate("test")
                row.update({f"test_{k}": v for k, v in tm.items()})
                best = dict(row, valid_h1=vm["h1"])
                if ckpt_dir:
                    self.save(ckpt_dir, epoch, vm["h1"])
            if logger is not None:
                # after the best-update so test metrics reach the JSONL
                logger.log_scalars(epoch, {k: v for k, v in row.items()
                                           if isinstance(v, (int, float))},
                                   tag="eval")
            self.history.append(row)
            if ckpt_dir:
                save_latest(ckpt_dir, self.state(), epoch + 1, vm["h1"],
                            host=self.host_state())
            log(f"epoch {epoch} loss {loss:.3f} valid MRR {vm['mrr']:.4f} "
                f"H@1 {vm['h1']:.4f} H@10 {vm['h10']:.4f} lr {self._lr:.2e}")
            if self.timer.enabled:
                log(f"  timer: {self.timer}")
                self.timer.reset()
        return best
