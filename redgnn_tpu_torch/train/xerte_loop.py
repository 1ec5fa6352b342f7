"""Trainer for the xERTE baseline.

Port of ``redgnn_tpu/train/xerte_loop.py``. Capability parity with
`Temporal/extrapolation/train.py` + `eval.py`: Adam behind a global-norm
clip, BCE on the per-entity attention mass vs the one-hot answer
(`model.py:545-570`), raw / filtered / time-filtered segment ranking over
the final attended entities (`eval.py` -> `segment.py:346-387`), gradient
accumulation, best checkpoint on valid MRR.

The model's visited-node set has a static capacity (``XErteConfig.
cap_factor`` x the pruned-frontier budget); the model reports insertion
overflow in ``aux['node_overflow']`` and the trainer restores the epoch's
snapshot (a copy: the port updates its parameters in place), doubles the
capacity and replays; evaluation retries the same way.

Every parameter is a view of one flat vector and the optimizer is one
functional update over it (`train/temporal_loop.TemporalOptimizer`). A
step reads nothing back; the host reads the epoch's losses and overflow
flags once per attempt, and an evaluation's sums once per attempt.
Sampling seeds: step ``i`` of the run draws with ``rng_seed = i``,
evaluation with 0, as in the JAX trainer.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models.xerte import XErte, XErteConfig, bce_loss
from redgnn_tpu_torch.ops.ranking import frontier_rank_metric_sums
from redgnn_tpu_torch.train.loop import FlatParams
from redgnn_tpu_torch.train.temporal_loop import (
    TemporalOptimizer,
    _keep_mask,
    answer_filters,
    stage_filter_indices,
    stage_quads,
)
from redgnn_tpu_torch.utils.checkpoint import (
    load_host,
    load_trainer_checkpoint,
    save_checkpoint,
    save_latest,
)
from redgnn_tpu_torch.utils.device import resolve_device

RANK_SUMS = tuple(f"{pre}_{s}_sum" for pre in ("raw", "fil", "fil_t")
                  for s in ("rr", "h1", "h3", "h10")) + (
    "count", "found_sum", "loss_sum")


class XErteTrainer(FlatParams):
    """Epoch loop of xERTE on one device (``cuda`` unless the caller asks
    for another; the KG's arrays are copied there)."""

    def __init__(self, kg: TemporalKG, cfg: XErteConfig,
                 lr: float = 1e-3, batch_size: int = 128,
                 grad_clip: float = 1.0,
                 grad_accum_steps: int = 1, seed: int = 1,
                 epochs: int = 20, max_train_batches=None,
                 max_eval_batches=None, device="cuda"):
        self.kg = kg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr = lr
        self.batch_size = batch_size
        self.epochs = epochs
        self.max_train_batches = max_train_batches
        self.max_eval_batches = max_eval_batches
        self._fil_cache: Dict[tuple, tuple] = {}
        self._answers: Optional[tuple] = None
        self.model = XErte(cfg, device=self.device,
                           generator=torch.Generator().manual_seed(seed))
        self._init_flat()
        # reference parity: xERTE clips the gradient's global norm to 1.0
        # (`Temporal/extrapolation/train.py:243`); a non-positive or
        # non-finite grad_clip turns clipping off
        self.tx = TemporalOptimizer("adam", 0.0, grad_clip, grad_accum_steps)
        self.opt_state = self.tx.init(self._flat, lr)
        self._np_rng = np.random.default_rng(seed)
        g = kg.graph
        self._kgarrs = tuple(t.to(self.device)
                             for t in (g.rowptr, g.rel, g.tail, kg.ekey))
        self._step_counter = 0
        self._ckpt_dir: Optional[str] = None
        self.history: List[Dict[str, Any]] = []

    def _grow_caps(self) -> None:
        """Double the visited-set capacity (overflow path)."""
        self.cfg = dataclasses.replace(self.cfg,
                                       cap_factor=self.cfg.cap_factor * 2)
        self.model.cfg = self.cfg

    def _apply(self, subs, rels, times, qmask, seed: int, draws=None):
        rowptr, rel, tail, ekey = self._kgarrs
        return self.model(rowptr, rel, tail, ekey, self.kg.time_key_base,
                          subs, rels, times, qmask.bool(), seed, draws)

    def _train_step(self, subs, rels, objs, times, qmask, seed: int):
        """One step on device tensors: forward, BCE, backward and the
        update. Returns device scalars (loss, overflow)."""
        mass, aux = self._apply(subs, rels, times, qmask, seed)
        loss = bce_loss(mass, objs, qmask)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        with torch.no_grad():
            g = torch.cat([(torch.zeros_like(p) if x is None else x)
                           .reshape(-1) for x, p in zip(grads, self._params)])
            updates, new = self.tx.update(g, self.opt_state, self._flat)
            self._flat.add_(updates)
            for k, v in new.items():
                self.opt_state[k].copy_(v)
        return loss.detach(), torch.any(aux["node_overflow"])

    def _eval_step(self, subs, rels, objs, times, qmask, fil_idx, filt_idx):
        """(sums in RANK_SUMS order, overflow) of one batch, seed 0."""
        with torch.no_grad():
            mass, aux = self._apply(subs, rels, times, qmask, 0)
            qmask = qmask.bool()
            n_ent = self.cfg.n_ent
            sums = frontier_rank_metric_sums(
                mass, aux["visited"], objs, qmask, _keep_mask(fil_idx, n_ent),
                _keep_mask(filt_idx, n_ent))
            sums["loss_sum"] = bce_loss(mass, objs, qmask) * torch.sum(qmask)
        return (torch.stack([sums[k].float() for k in RANK_SUMS]),
                torch.any(aux["node_overflow"]))

    def train_epoch(self, epoch: int) -> float:
        """One shuffled pass over the training quadruples (the first
        ``max_train_batches`` batches of it when set); the summed loss."""
        data = self.kg.splits["train"]
        data = data[self._np_rng.permutation(len(data))]
        if self.max_train_batches is not None:
            data = data[: self.max_train_batches * self.batch_size]
        batches = stage_quads(data, self.batch_size, self.device)
        for _attempt in range(6):
            snap = (self._flat.clone(),
                    {k: v.clone() for k, v in self.opt_state.items()},
                    self._step_counter)
            losses, overflows = [], []
            for bi, (subs, rels, objs, times, qmask) in enumerate(batches):
                self._step_counter += 1
                loss, ov = self._train_step(subs, rels, objs, times, qmask,
                                            self._step_counter)
                losses.append(loss)
                overflows.append(ov)
                # intra-epoch progress anchor, as in the JAX trainer
                if self._ckpt_dir and bi % 128 == 127:
                    save_latest(self._ckpt_dir, self.state(), epoch, -1.0,
                                host=self.host_state())
            read = torch.cat([torch.stack(losses),
                              torch.stack(overflows).any()[None].float()]
                             ).cpu().numpy()
            if not read[-1]:
                return float(np.sum(read[:-1]))
            flat, opt_state, self._step_counter = snap
            self._flat.copy_(flat)
            for k, v in opt_state.items():
                self.opt_state[k].copy_(v)
            self._grow_caps()
            print(f"xerte epoch {epoch}: visited-set overflow; "
                  f"cap_factor -> {self.cfg.cap_factor}, replaying",
                  flush=True)
        raise RuntimeError("xerte visited caps failed to stabilize")

    def _staged_filters(self, split: str, data, b: int):
        """Known-answer index lists of ``data``'s batches on the device,
        staged once per (split, rows, batch)."""
        key = (split, len(data), b)
        cached = self._fil_cache.get(key)
        if cached is None:
            if self._answers is None:
                self._answers = answer_filters(self.kg.splits)
            sp2o, spt2o = self._answers
            cached = tuple(
                torch.as_tensor(a.astype(np.int32), device=self.device)
                for a in stage_filter_indices(sp2o, spt2o, data, b,
                                              self.cfg.n_ent))
            self._fil_cache[key] = cached
        return cached

    def evaluate(self, split: str) -> Dict[str, float]:
        """Raw, (s,p)-filtered and (s,p,t)-filtered ranks over the final
        attended entities (``mrr`` is the filtered one); the first
        ``max_eval_batches`` batches of the split when set."""
        data = self.kg.splits[split]
        b = self.batch_size
        if self.max_eval_batches is not None:
            data = data[: self.max_eval_batches * b]
        fil3, filt3 = self._staged_filters(split, data, b)
        batches = stage_quads(data, b, self.device)
        for _attempt in range(6):
            partials, overflows = [], []
            for bi, (subs, rels, objs, times, qmask) in enumerate(batches):
                sums, ov = self._eval_step(subs, rels, objs, times, qmask,
                                           fil3[bi], filt3[bi])
                partials.append(sums)
                overflows.append(ov)
            if not bool(torch.stack(overflows).any()):
                break
            self._grow_caps()
            print(f"xerte eval[{split}]: visited-set overflow; "
                  f"cap_factor -> {self.cfg.cap_factor}, retrying",
                  flush=True)
        else:
            raise RuntimeError("xerte visited caps failed to stabilize")
        tot = defaultdict(float)
        for row in torch.stack(partials).cpu().numpy():
            for k, v in zip(RANK_SUMS, row):
                tot[k] += float(v)
        n = max(tot["count"], 1.0)
        out = {"n": n, "loss": tot["loss_sum"] / n,
               "found_rate": tot["found_sum"] / n}
        for pre in ("raw_", "fil_", "fil_t_"):
            for m in ("mrr", "h1", "h3", "h10"):
                key = "rr_sum" if m == "mrr" else f"{m}_sum"
                out[pre + m] = tot[pre + key] / n
        out["mrr"] = out["fil_mrr"]
        return out

    # -- checkpointing (`state` / `load_state` of FlatParams) -----------
    def host_state(self) -> Dict[str, Any]:
        return {"np_rng": self._np_rng.bit_generator.state,
                "step_counter": int(self._step_counter),
                "cap_factor": float(self.cfg.cap_factor)}

    def restore_host(self, ckpt_path: str) -> None:
        """The sidecar's numpy rng, step counter and cap factor (the JAX
        trainer's sidecar has the same keys)."""
        host = load_host(ckpt_path)
        if host is None:
            return
        try:
            self._np_rng.bit_generator.state = host["np_rng"]
        except (KeyError, ValueError):
            pass
        self._step_counter = int(host.get("step_counter", 0))
        cap = float(host.get("cap_factor", self.cfg.cap_factor))
        if cap != self.cfg.cap_factor:
            self.cfg = dataclasses.replace(self.cfg, cap_factor=cap)
            self.model.cfg = self.cfg

    def save(self, ckpt_dir: str, epoch: int, metric: float) -> str:
        return save_checkpoint(ckpt_dir, self.state(), epoch, metric,
                               host=self.host_state())

    def restore(self, path: str) -> int:
        """Restore parameters, optimizer state and host state from a
        checkpoint of this trainer (``.pt``) or of the JAX package's
        XErteTrainer (``.msgpack`` with its ``.host.json``; its optimizer
        state holds no learning rate, so this trainer's ``lr`` is kept);
        a state of another structure raises."""
        state, epoch = load_trainer_checkpoint(path, self.state(), self.lr)
        self.load_state(state)
        self.restore_host(path)
        return epoch

    def fit(self, epochs: Optional[int] = None, log=print, logger=None,
            ckpt_dir: Optional[str] = None,
            start_epoch: int = 0) -> Dict[str, Any]:
        """Train, evaluate valid, evaluate test and save on a new best
        valid MRR; ``latest`` is written every epoch, and ``logger``
        (`utils/reporting.py:ExperimentLogger`) gets each epoch's row."""
        epochs = epochs or self.epochs
        self._ckpt_dir = ckpt_dir
        best: Dict[str, Any] = {"valid_mrr": -1.0}
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            loss = self.train_epoch(epoch)
            vm = self.evaluate("valid")
            row = {"epoch": epoch, "loss": loss, "time": time.time() - t0,
                   **{f"valid_{k}": v for k, v in vm.items()}}
            if vm["mrr"] > best["valid_mrr"]:
                tm = self.evaluate("test")
                row.update({f"test_{k}": v for k, v in tm.items()})
                best = dict(row, valid_mrr=vm["mrr"])
                if ckpt_dir:
                    self.save(ckpt_dir, epoch, vm["mrr"])
            # after the best/test update, so that a best epoch's row
            # carries its test metrics into the JSONL
            if logger is not None:
                logger.log_scalars(epoch, {k: v for k, v in row.items()
                                           if isinstance(v, (int, float))},
                                   tag="eval")
            self.history.append(row)
            if ckpt_dir:
                save_latest(ckpt_dir, self.state(), epoch + 1, vm["mrr"],
                            host=self.host_state())
            log(f"xerte epoch {epoch} loss {loss:.3f} "
                f"valid fil-MRR {vm['mrr']:.4f}")
        return best
