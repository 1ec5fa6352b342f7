"""Train/eval steps and the epoch loop for static KGC.

Port of ``redgnn_tpu/train/loop.py`` (single device). Capability parity
with `Static/transductive/base_model.py`:
  * Adam with coupled weight decay + per-epoch exponential LR decay
    (`base_model.py:27-28`),
  * max-stabilized softmax cross-entropy over all entities
    (`base_model.py:58-60`),
  * the NaN parameter scrub (`base_model.py:64-69`),
  * filtered evaluation on valid+test every epoch (`base_model.py:85-151`),
  * the per-epoch facts/train graph re-split (`base_model.py:82`).

The step is eager PyTorch with no host round-trip: the host reads the
device once per chunk of ``scan_chunk`` steps (the loss sum and the
overflow flag), as the JAX loop does. That is why a non-finite step is
rejected with ``torch.where`` on a device flag rather than by a branch on
the host, and why the optimizer is a short functional Adam over one flat
vector that holds every parameter (the model's parameters are views of
it): a step costs a dozen optimizer launches, not a dozen per tensor.

Under a mesh (`parallel/mesh.py`) every rank runs this loop on the same
global batches: the step takes its data shard through
`parallel/shard.py:dp_loss`, one all-reduce sums gradients, loss and
overflow flag over the world, and evaluation sums the metric sums the
same way, so every rank branches alike.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from redgnn_tpu_torch.graph.calibrate import (
    FrontierCaps,
    calibrate_caps,
    caps_for_batches,
    per_query_counts,
)
from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN
from redgnn_tpu_torch.ops.ranking import rank_metric_sums
from redgnn_tpu_torch.parallel.shard import (
    agree_caps,
    data_shard,
    dp_loss,
    fold_seed,
    reduce_step,
    sharded_config,
)
from redgnn_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_host,
    save_checkpoint,
    save_latest,
)
from redgnn_tpu_torch.utils.config import TrainConfig
from redgnn_tpu_torch.utils.metrics import combine_metric_sums
from redgnn_tpu_torch.utils.timers import PhaseTimer

METRIC_SUMS = ("rr_sum", "h1_sum", "h3_sum", "h10_sum", "count")


def softmax_ce_loss(scores: torch.Tensor, objs: torch.Tensor,
                    qmask: torch.Tensor) -> torch.Tensor:
    """sum(-pos + max + log(sum(exp(s - max)))) — `base_model.py:58-60`."""
    pos = scores.gather(1, objs.long()[:, None])[:, 0]
    max_n = torch.max(scores, dim=1).values
    lse = torch.log(torch.sum(torch.exp(scores - max_n[:, None]), dim=1))
    per_row = -pos + max_n + lse
    return torch.sum(torch.where(qmask, per_row, 0.0))


def nan_scrub(flat: torch.Tensor, owner: torch.Tensor, n_tensors: int,
              generator: torch.Generator) -> torch.Tensor:
    """Replace NaN parameters with uniform randoms (`base_model.py:64-69`).

    ``flat`` holds ``n_tensors`` parameter tensors end to end and
    ``owner[i]`` is the tensor element i belongs to. One U[0, 1) scalar is
    drawn per tensor and broadcast over it, as the JAX package does."""
    u = torch.rand(n_tensors, generator=generator, device=flat.device,
                   dtype=flat.dtype)
    return torch.where(torch.isnan(flat), u[owner], flat)


class Adam:
    """optax ``chain(add_decayed_weights(lamb), scale_by_adam(),
    scale_by_learning_rate(exponential_decay(lr, steps_per_epoch,
    decay_rate, staircase=True)))`` as one functional update: coupled
    weight decay ``g + lamb * p``, Adam (b1 0.9, b2 0.999, eps 1e-8
    outside the root, bias-corrected), and the step size
    ``lr * decay_rate ** floor(count / steps_per_epoch)`` where ``count``
    is the number of updates applied so far."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, decay_rate: float, lamb: float,
                 steps_per_epoch: int):
        self.lr = lr
        self.decay_rate = decay_rate
        self.lamb = lamb
        self.steps_per_epoch = max(steps_per_epoch, 1)

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"mu": torch.zeros_like(params),
                "nu": torch.zeros_like(params),
                "count": torch.zeros((), dtype=torch.int64,
                                     device=params.device)}

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        epochs = torch.div(count, self.steps_per_epoch,
                           rounding_mode="floor").to(torch.float32)
        return self.lr * torch.pow(self.decay_rate, epochs)

    def update(self, grads: torch.Tensor, state: Dict[str, torch.Tensor],
               params: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(updates, new_state); the caller adds ``updates`` to ``params``.
        Nothing is modified in place."""
        direction, new = self.moments(grads + self.lamb * params, state)
        return -self.learning_rate(state["count"]) * direction, new

    def moments(self, g: torch.Tensor, state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """optax ``scale_by_adam`` of gradient ``g``: the bias-corrected
        direction ``mu_hat / (sqrt(nu_hat) + eps)`` and the new moments
        and count."""
        mu = self.b1 * state["mu"] + (1 - self.b1) * g
        nu = self.b2 * state["nu"] + (1 - self.b2) * (g * g)
        count = state["count"] + 1
        t = count.to(torch.float32)
        # (scalar ** tensor: no scalar is copied to the device per step)
        mu_hat = mu / (1 - torch.pow(self.b1, t))
        nu_hat = nu / (1 - torch.pow(self.b2, t))
        return (mu_hat / (torch.sqrt(nu_hat) + self.eps),
                {"mu": mu, "nu": nu, "count": count})


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> Adam:
    """torch.optim.Adam(weight_decay=lamb) + ExponentialLR per epoch."""
    return Adam(cfg.lr, cfg.decay_rate, cfg.lamb, steps_per_epoch)


def _one_hot_rows(idx: torch.Tensor, n_ent: int) -> torch.Tensor:
    """(b, M) index lists padded with ``n_ent`` -> (b, n_ent) 0/1 rows."""
    out = torch.zeros((idx.shape[0], n_ent + 1), device=idx.device)
    out.scatter_(1, idx.clamp(max=n_ent).long(), 1.0)
    return out[:, :n_ent]


class FlatParams:
    """Every parameter of ``self.model`` as a view of one flat vector
    ``self._flat`` (state-dict order), so that the optimizer, the step
    rejection and the scrub are a few launches over one tensor. A trainer
    sets ``model``, ``device``, ``opt_state`` (a dict of tensors) and
    ``rng`` (the device generator), then calls ``_init_flat``."""

    def _init_flat(self) -> None:
        named = list(self.model.named_parameters())
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        sizes = [p.numel() for p in self._params]
        self._slices = [slice(o - n, o) for n, o in
                        zip(sizes, np.cumsum(sizes).tolist())]
        self._flat = torch.cat([p.detach().reshape(-1)
                                for p in self._params])
        for p, sl in zip(self._params, self._slices):
            p.data = self._flat[sl].view(p.shape)
        self._owner = torch.repeat_interleave(
            torch.arange(len(sizes)), torch.tensor(sizes)).to(self.device)

    def _tree(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Named views of a flat vector laid out like the parameters."""
        return {n: flat[sl].view(p.shape) for n, p, sl in
                zip(self._names, self._params, self._slices)}

    def _flatten(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        if tree.keys() != set(self._names):
            raise ValueError("state names differ from the model's: "
                             f"{sorted(tree.keys() ^ set(self._names))}")
        return torch.cat([
            tree[n].to(self.device, torch.float32).reshape(p.shape)
            .reshape(-1) for n, p in zip(self._names, self._params)])

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters by state-dict name (views, not copies)."""
        return self._tree(self._flat)

    def state(self) -> Dict[str, Any]:
        """Parameters and optimizer state by name (views of the live
        tensors; the checkpoint functions copy them to the host). The
        optimizer's flat vectors (moments, accumulated gradients) appear
        as trees laid out like the parameters."""
        opt = {k: (self._tree(v) if k in ("mu", "nu", "acc_grads")
                    else v)
               for k, v in self.opt_state.items()}
        return {"params": self.params, "opt_state": opt}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Copy a `state()`-shaped tree (tensors on any device) in."""
        self._flat.copy_(self._flatten(state["params"]))
        for k, v in state["opt_state"].items():
            self.opt_state[k].copy_(self._flatten(v) if isinstance(v, dict)
                                    else v)

    def _generators(self) -> list:
        """The trainer's device generators: ``rng``, and under a mesh the
        rank's dropout generator."""
        drop = getattr(self, "_drop_rng", self.rng)
        return [self.rng] + ([drop] if drop is not self.rng else [])

    def _snapshot(self):
        return (self._flat.clone(),
                {k: v.clone() for k, v in self.opt_state.items()},
                [g.get_state() for g in self._generators()])

    def _rollback(self, snap) -> None:
        flat, opt_state, rng_states = snap
        self._flat.copy_(flat)
        for k, v in opt_state.items():
            self.opt_state[k].copy_(v)
        for g, state in zip(self._generators(), rng_states):
            g.set_state(state)

    def _init_mesh(self, mesh, seed: int) -> None:
        """``mesh`` and the rank's dropout generator: the trainer's own
        one alone; under a mesh one per data shard, alike on the edge
        ranks of a shard, while ``rng`` (the scrub's) stays replicated."""
        self.mesh = mesh
        self.n_data = mesh.size("data") if mesh is not None else 1
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the KG lies on {self.device}, the mesh rank "
                             f"on {mesh.device}")
        self._drop_rng = self.rng if mesh is None else torch.Generator(
            device=self.device).manual_seed(
                fold_seed(seed, mesh.index("data")))

    def _reduce_sums(self, sums: torch.Tensor, overflow: torch.Tensor):
        """Eval sums and overflow over the mesh (psum over data, mean over
        the identical edge copies), in one all-reduce."""
        if self.mesh is None:
            return sums, overflow
        buf = torch.cat([sums, overflow.to(sums.dtype).reshape(1)])
        self.mesh.all_reduce(buf)
        return buf[:-1] / self.mesh.size("edge"), buf[-1] > 0


class StaticTrainer(FlatParams):
    """Epoch loop for static KGC (transductive and inductive) on one
    device, or on each rank of a mesh."""

    def __init__(self, kg, cfg: TrainConfig, mesh=None):
        """``kg`` is a StaticKG or an InductiveKG (anything with
        train_data, graph/graph_np, n_ent/n_rel, eval_spec(split),
        resplit(rng)). The trainer runs on the KG's device.

        ``mesh`` (`parallel/mesh.py`, axes 'data' and 'edge'; every rank
        builds its trainer alike) shards the train step as
        `parallel/shard.py` does: queries over 'data', each sparse hop's
        edges over 'edge'. Caps are per data shard (``n_batch / n_data``
        queries), ``n_tbatch`` is rounded up to a multiple of the data
        axis, and evaluation shards the same way with the metric sums
        summed over the mesh."""
        self.kg = kg
        self.cfg = cfg
        self.device = kg.graph.device
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._init_mesh(mesh, cfg.seed)
        if cfg.n_batch % self.n_data:
            raise ValueError(f"n_batch ({cfg.n_batch}) must divide the "
                             f"mesh data axis ({self.n_data})")
        # eval batches are qmask-padded anyway, so n_tbatch can simply be
        # rounded up to a mesh multiple
        self.n_tbatch = -(-cfg.n_tbatch // self.n_data) * self.n_data
        self.model_cfg = ModelConfig(
            n_ent=kg.n_ent, n_rel=kg.n_rel, hidden_dim=cfg.hidden_dim,
            attn_dim=cfg.attn_dim, n_layer=cfg.n_layer, dropout=cfg.dropout,
            act=cfg.act, segment_impl=cfg.segment_impl,
            compute_dtype=cfg.compute_dtype, dedup_impl=cfg.dedup_impl,
            scan_src_backward=cfg.scan_src_backward,
            dense_hops=cfg.dense_hops, dense_switch=cfg.dense_switch,
        )
        # parameters from a CPU generator (one seed, the same weights on
        # every device and rank); dropout and the scrub from device
        # generators
        self.model = RedGNN(
            self.model_cfg if mesh is None
            else sharded_config(self.model_cfg, mesh),
            device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed), mesh=mesh)

        self._init_flat()

        self.steps_per_epoch = max(
            1, -(-len(kg.train_data) // cfg.n_batch)
        )
        self.tx = make_optimizer(cfg, self.steps_per_epoch)
        self.opt_state = self.tx.init(self._flat)

        # --- frontier capacity calibration (train graph, train batch) ---
        rowptr, _, tail = kg.graph_np
        # per-shard caps under a mesh: each rank expands b / n_data queries
        self.train_caps = agree_caps(mesh, calibrate_caps(
            rowptr, tail, kg.n_ent, kg.train_data[:, 0],
            cfg.n_batch // self.n_data, cfg.n_layer,
            headroom=cfg.cap_headroom,
        ))
        # per-split eval caps, built lazily
        self.eval_caps: Dict[str, FrontierCaps] = {}
        self.t_train = 0.0
        self._np_rng = np.random.default_rng(cfg.seed)
        self.history: List[Dict[str, Any]] = []
        # --timer phase buckets (`extrapolation/main.py:39-52`)
        self.timer = PhaseTimer(enabled=False)
        # device-to-host reads made by train_epoch and evaluate
        self.host_syncs = 0

    # ------------------------------------------------------------------
    def _loss_and_grads(self, subs, rels, objs, qmask, caps: FrontierCaps):
        """One batch's (loss, flat gradient, overflow, per-hop edge
        counts), device tensors. Under a mesh the batch is global, the rank
        takes its data shard, and the gradient, loss and overflow flag come
        back summed over the mesh (the same on every rank); the per-hop
        edge counts are then zeros, as in the JAX package."""
        mesh = self.mesh
        with record_function("step.forward"):
            if mesh is None:
                scores, aux = self.model(self.kg.graph, subs, rels, qmask,
                                         caps, train=True,
                                         generator=self.rng)
                loss = softmax_ce_loss(scores, objs, qmask)
            else:
                loss, overflow = dp_loss(self.model, mesh, self.kg.graph,
                                         subs, rels, objs, qmask, caps,
                                         self._drop_rng)
        with record_function("step.backward"):
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=mesh is not None)
            with torch.no_grad():
                loss = loss.detach()
                g = torch.cat([(torch.zeros_like(p) if x is None else x)
                               .reshape(-1)
                               for x, p in zip(grads, self._params)])
                if mesh is None:
                    overflow = (torch.any(aux["edge_overflow"])
                                | torch.any(aux["node_overflow"]))
                    return loss, g, overflow, aux["num_edges"]
                g, loss, overflow = reduce_step(mesh, g, loss, overflow)
                return loss, g, overflow, torch.zeros(
                    self.cfg.n_layer, dtype=torch.int32, device=self.device)

    def _train_step(self, subs, rels, objs, qmask, caps: FrontierCaps):
        """One step on device tensors: forward, loss, backward, the gated
        Adam update and the scrub. Returns device scalars and the per-hop
        edge counts (loss, overflow, num_edges); reads nothing back. The
        three ``record_function`` ranges let a torch.profiler trace split
        the step's device time."""
        loss, g, overflow, num_edges = self._loss_and_grads(
            subs, rels, objs, qmask, caps)
        with record_function("step.optimizer"), torch.no_grad():
            # Reject the whole update when the loss, any gradient, any
            # update or any new moment is non-finite: parameters, moments
            # and the update count stay bit-identical. Without this one
            # bad batch would poison the moments, and the scrub below
            # would then write random values into the parameters.
            updates, new = self.tx.update(g, self.opt_state, self._flat)
            finite = (torch.isfinite(loss) & torch.isfinite(g).all()
                      & torch.isfinite(updates).all()
                      & torch.isfinite(new["mu"]).all()
                      & torch.isfinite(new["nu"]).all())
            flat = torch.where(finite, self._flat + updates, self._flat)
            for k in ("mu", "nu", "count"):
                self.opt_state[k].copy_(
                    torch.where(finite, new[k], self.opt_state[k]))
            self._flat.copy_(nan_scrub(flat, self._owner,
                                       len(self._params), self.rng))
            loss = torch.where(finite, loss, 0.0)
        return loss, overflow, num_edges

    def _run_chunk(self, batches: torch.Tensor, caps: FrontierCaps):
        """``batches`` (steps, 4, b) int32 on the device — rows subs, rels,
        objs, qmask. Runs the steps back to back and returns the device
        scalars (loss_sum, overflow_any); nothing is read back here."""
        loss_sum = torch.zeros((), device=self.device)
        overflow_any = torch.zeros((), dtype=torch.bool, device=self.device)
        for subs, rels, objs, qm in batches.unbind(0):
            loss, overflow, _ = self._train_step(subs, rels, objs,
                                                 qm.bool(), caps)
            loss_sum = loss_sum + loss
            overflow_any = overflow_any | overflow
        return loss_sum, overflow_any

    def _recalibrate_exact(self, caps: FrontierCaps, graph_np, data, b,
                           n_ent=None) -> FrontierCaps:
        """Grow caps to exactly cover every batch of this epoch: one
        batched host walk over the unique query heads plus a vectorized
        max over per-batch sums (`caps_for_batches`). Per-query counts sum
        exactly to batch counts because frontier keys are composed as
        b*n_ent+ent; the batch layout (contiguous chunks of b, zero-padded
        tail) matches `train_epoch`'s reshape."""
        n_ent = n_ent or self.kg.n_ent
        rowptr, _, tail = graph_np
        nc, ec = per_query_counts(rowptr, tail, n_ent,
                                  np.asarray(data[:, 0], np.int64),
                                  self.cfg.n_layer)
        return agree_caps(self.mesh, caps.union(caps_for_batches(nc, ec, b)))

    def train_epoch(self, epoch: int) -> float:
        """One pass over the (doubled) training triples.

        The epoch's batches are staged on the device once; each chunk of
        ``scan_chunk`` steps is enqueued without reading anything back and
        ends in one device-to-host read of its loss sum and overflow flag.
        If a frontier bucket overflowed, only that chunk is rolled back
        (parameters, moments, update count, generator state) and replayed
        with exactly recalibrated capacities; completed chunks keep their
        progress."""
        kg, cfg = self.kg, self.cfg
        t0 = time.time()
        data = kg.train_data
        b = cfg.n_batch
        nb = -(-len(data) // b)
        pad = nb * b - len(data)
        padded = np.concatenate([data, np.zeros((pad, 3), np.int64)])
        qmask_all = np.ones((nb * b, 1), np.int64)
        if pad:
            qmask_all[-pad:] = 0
        staged = np.concatenate([padded, qmask_all], 1).astype(np.int32)
        batches = torch.as_tensor(
            np.ascontiguousarray(staged.reshape(nb, b, 4).transpose(0, 2, 1)),
            device=self.device)

        # exact caps upfront: one batched host walk per epoch makes a
        # frontier overflow impossible for this split and order; grow-only
        # union. The chunk retry below stays as a safety net only.
        self.train_caps = self._recalibrate_exact(
            self.train_caps, kg.graph_np, data, b // self.n_data)

        total_loss = 0.0
        c = cfg.scan_chunk
        with self.timer.phase("train", "device"):
            start, retries = 0, 0
            while start < nb:
                snap = self._snapshot()
                loss_sum, overflow = self._run_chunk(
                    batches[start:start + c], self.train_caps)
                overflow, loss_sum = torch.stack(
                    [overflow.to(loss_sum.dtype), loss_sum]).tolist()
                self.host_syncs += 1
                if overflow:
                    if retries >= 3:
                        raise RuntimeError(
                            "frontier caps failed to stabilize")
                    retries += 1
                    # roll back and retry just this chunk with caps that
                    # exactly cover the rest of the epoch
                    self._rollback(snap)
                    self.train_caps = self._recalibrate_exact(
                        self.train_caps, kg.graph_np, data[start * b:],
                        b // self.n_data)
                    continue
                retries = 0
                total_loss += loss_sum
                start += c
        self.t_train += time.time() - t0
        return total_loss

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_chunk(self, spec, staged: Sequence[torch.Tensor],
                    caps: FrontierCaps):
        """Metric sums (5,) and the overflow flag over a chunk of staged
        eval batches, accumulated on the device (under a mesh: this rank's
        data shard of each batch, then summed over the mesh)."""
        sums = torch.zeros(len(METRIC_SUMS), device=self.device)
        overflow_any = torch.zeros((), dtype=torch.bool, device=self.device)
        if self.mesh is not None:
            sl = data_shard(self.mesh, staged[0].shape[1])
            staged = [t[:, sl] for t in staged]
        for subs, rels, ans, fil, qmask in zip(*staged):
            labels = _one_hot_rows(ans, spec.n_ent) * qmask[:, None]
            filters = _one_hot_rows(fil, spec.n_ent)
            scores, aux = self.model(spec.graph, subs, rels, qmask, caps)
            part = rank_metric_sums(scores, labels, filters)
            sums = sums + torch.stack([part[k] for k in METRIC_SUMS])
            overflow_any = (overflow_any | torch.any(aux["edge_overflow"])
                            | torch.any(aux["node_overflow"]))
        return self._reduce_sums(sums, overflow_any)

    def evaluate(self, split: str) -> Dict[str, float]:
        """Filtered MRR / Hits@k over a whole split. Labels and filters
        travel as padded index lists and become one-hot rows on the
        device; each chunk of ``scan_chunk`` batches ends in one
        device-to-host read. The split's graph may have another entity
        count than the training graph (the inductive task's test side):
        the parameters are shared, and the model reads the count from
        the graph."""
        cfg = self.cfg
        spec = self.kg.eval_spec(split)
        b = self.n_tbatch
        if split not in self.eval_caps:
            rowptr, _, tail = spec.graph_np
            heads = (spec.queries[:, 0] if len(spec.queries)
                     else np.zeros(1, np.int64))
            # per-shard caps under a mesh (each rank expands b / n_data)
            self.eval_caps[split] = agree_caps(self.mesh, calibrate_caps(
                rowptr, tail, spec.n_ent, heads, b // self.n_data,
                cfg.n_layer, headroom=cfg.cap_headroom,
            ))
        queries, answers = spec.queries, spec.answers
        nq = len(queries)
        nb = -(-nq // b)
        pad = nb * b - nq
        padded_q = np.concatenate([queries, np.zeros((pad, 2), np.int64)])
        qmask = np.ones(nb * b, bool)
        if pad:
            qmask[-pad:] = False
        # stage answers/filters as padded index lists (pad id = n_ent)
        filt_rows = [spec.filter_row(h, r) for h, r in padded_q]
        max_a = max((len(a) for a in answers), default=1) or 1
        max_f = max((len(f) for f in filt_rows), default=1) or 1
        ans_idx = np.full((nb * b, max_a), spec.n_ent, np.int64)
        fil_idx = np.full((nb * b, max_f), spec.n_ent, np.int64)
        for i, a in enumerate(answers):
            ans_idx[i, :len(a)] = a
        for i, f in enumerate(filt_rows):
            fil_idx[i, :len(f)] = f

        def stage(a, dtype=np.int32):
            return torch.as_tensor(
                a.reshape((nb, b) + a.shape[1:]).astype(dtype),
                device=self.device)

        staged = (stage(padded_q[:, 0]), stage(padded_q[:, 1]),
                  stage(ans_idx), stage(fil_idx), stage(qmask, bool))
        c = cfg.scan_chunk
        for _ in range(3):
            partials, overflow_seen = [], False
            for start in range(0, nb, c):
                sums, overflow = self._eval_chunk(
                    spec, [t[start:start + c] for t in staged],
                    self.eval_caps[split])
                *sums, overflow = torch.cat(
                    [sums, overflow.to(sums.dtype)[None]]).tolist()
                self.host_syncs += 1
                if overflow:
                    overflow_seen = True
                    break
                partials.append(dict(zip(METRIC_SUMS, sums)))
            if not overflow_seen:
                return combine_metric_sums(partials)
            self.eval_caps[split] = self._recalibrate_exact(
                self.eval_caps[split], spec.graph_np, queries,
                b // self.n_data, n_ent=spec.n_ent,
            )
        raise RuntimeError("eval frontier caps failed to stabilize")

    # ------------------------------------------------------------------
    def host_state(self) -> Dict[str, Any]:
        # the numpy rng drives the per-epoch 3:1 graph re-split; carrying
        # it across restarts keeps the split sequence identical
        return {"np_rng": self._np_rng.bit_generator.state}

    def restore_host(self, ckpt_path: str) -> None:
        host = load_host(ckpt_path)
        if host is None:
            return
        try:
            self._np_rng.bit_generator.state = host["np_rng"]
        except (KeyError, TypeError, ValueError) as err:
            # continuing would draw another resplit sequence than the run
            # that wrote the checkpoint, without a word
            raise ValueError(
                f"{ckpt_path}: the host sidecar holds no usable numpy rng "
                f"state ({err!r})") from err

    def save(self, ckpt_dir: str, epoch: int, metric: float) -> str:
        return save_checkpoint(ckpt_dir, self.state(), epoch, metric,
                               host=self.host_state())

    def restore(self, path: str) -> int:
        state, epoch, _ = load_checkpoint(path, self.state())
        self.load_state(state)
        self.restore_host(path)
        return epoch

    def fit(self, epochs: Optional[int] = None, log=print,
            eval_every: int = 1, logger=None,
            ckpt_dir: Optional[str] = None,
            start_epoch: int = 0) -> Dict[str, Any]:
        """The whole run: train, eval valid+test, keep best-valid epoch,
        re-split the graph — `train.py:119-131` + `base_model.py:81-82`;
        ``logger`` (`utils/reporting.py:ExperimentLogger`) gets each
        evaluated epoch's perf line and metrics."""
        epochs = epochs or self.cfg.epochs
        best = {"valid_mrr": -1.0}
        if start_epoch > 0:
            # the sidecar rng was saved before the resplit that produced
            # start_epoch's split; replay that one resplit so the resumed
            # run trains on the exact same facts/train partition sequence
            if self.cfg.shuffle_train:
                self.kg.resplit(self._np_rng)
        for epoch in range(start_epoch, epochs):
            loss = self.train_epoch(epoch)
            row: Dict[str, Any] = {"epoch": epoch, "loss": loss}
            if (epoch + 1) % eval_every == 0:
                t0 = time.time()
                vm = self.evaluate("valid")
                tm = self.evaluate("test")
                row.update(
                    valid_mrr=vm["mrr"], valid_h1=vm["h1"], valid_h10=vm["h10"],
                    test_mrr=tm["mrr"], test_h1=tm["h1"], test_h10=tm["h10"],
                    infer_time=time.time() - t0, train_time=self.t_train,
                )
                if logger is not None:
                    logger.epoch_line(epoch, vm, tm, self.t_train,
                                      row["infer_time"])
                if vm["mrr"] > best["valid_mrr"]:
                    best = dict(row, valid_mrr=vm["mrr"])
                    if ckpt_dir:
                        self.save(ckpt_dir, epoch, vm["mrr"])
                log(
                    f"epoch {epoch} loss {loss:.2f} "
                    f"[VALID] MRR:{vm['mrr']:.4f} H@1:{vm['h1']:.4f} "
                    f"H@10:{vm['h10']:.4f} [TEST] MRR:{tm['mrr']:.4f} "
                    f"H@1:{tm['h1']:.4f} H@10:{tm['h10']:.4f}"
                )
            if self.timer.enabled:
                log(f"  timer: {self.timer}")
                self.timer.reset()
            self.history.append(row)
            if ckpt_dir:
                # before the resplit: fit() replays one resplit on resume,
                # so the restored rng regenerates the exact split the
                # original run used for epoch+1
                save_latest(ckpt_dir, self.state(), epoch + 1,
                            row.get("valid_mrr", -1.0),
                            host=self.host_state())
            if self.cfg.shuffle_train:
                self.kg.resplit(self._np_rng)
        return best
