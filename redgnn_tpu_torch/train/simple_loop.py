"""Trainer for the SimplE embedding baseline.

Port of ``redgnn_tpu/train/simple_loop.py``, the counterpart of
`Temporal/extrapolation/main_nontemporal.py`: plain cross-entropy over all
entities, Adam, raw ranking (`ops.ranking.raw_rank_metric_sums`). The
parameters are views of one flat vector updated by one functional Adam
(`train/temporal_loop.TemporalOptimizer` without clipping); the host reads
an epoch's losses once, and an evaluation's sums once.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from redgnn_tpu_torch.models.baselines import SimplE
from redgnn_tpu_torch.ops.ranking import raw_rank_metric_sums
from redgnn_tpu_torch.train.loop import FlatParams
from redgnn_tpu_torch.train.temporal_loop import (
    TemporalOptimizer,
    stage_quads,
)
from redgnn_tpu_torch.utils.checkpoint import (
    load_host,
    load_trainer_checkpoint,
    save_checkpoint,
    save_latest,
)
from redgnn_tpu_torch.utils.device import resolve_device

RAW_SUMS = ("rr_sum", "h1_sum", "h3_sum", "h10_sum", "count")


def simple_loss(scores: torch.Tensor, objs: torch.Tensor,
                qmask: torch.Tensor) -> torch.Tensor:
    """Mean over the live queries of -log_softmax(scores)[obj]."""
    logp = torch.log_softmax(scores, dim=1)
    nll = -logp.gather(1, objs.long()[:, None])[:, 0]
    qmask = qmask.bool()
    return torch.sum(torch.where(qmask, nll, 0.0)) / torch.clamp(
        torch.sum(qmask), min=1)


class SimplETrainer(FlatParams):
    def __init__(self, kg, hidden_dim: int = 64, lr: float = 1e-3,
                 batch_size: int = 256, seed: int = 0, epochs: int = 20,
                 device="cuda"):
        """``kg`` needs n_ent, n_rel and splits['train'/'valid'/'test']
        with (h, r, t[, tau]) rows (TemporalKG works directly). Runs on
        ``device`` (``cuda`` unless the caller asks for another)."""
        self.kg = kg
        self.device = resolve_device(device)
        self.lr = lr
        self.batch_size = batch_size
        self.epochs = epochs
        self.model = SimplE(kg.n_ent, kg.n_rel + 1, hidden_dim,
                            device=self.device,
                            generator=torch.Generator().manual_seed(seed))
        self._init_flat()
        self.tx = TemporalOptimizer("adam", 0.0, None, 1)
        self.opt_state = self.tx.init(self._flat, lr)
        self._np_rng = np.random.default_rng(seed)
        self.history: List[Dict[str, Any]] = []

    def _train_step(self, heads, rels, objs, qmask):
        """One step on device tensors; returns the loss (device scalar)."""
        loss = simple_loss(self.model(heads, rels), objs, qmask)
        grads = torch.autograd.grad(loss, self._params)
        with torch.no_grad():
            g = torch.cat([x.reshape(-1) for x in grads])
            updates, new = self.tx.update(g, self.opt_state, self._flat)
            self._flat.add_(updates)
            for k, v in new.items():
                self.opt_state[k].copy_(v)
        return loss.detach()

    def train_epoch(self, epoch: int) -> float:
        data = self.kg.splits["train"]
        data = data[self._np_rng.permutation(len(data))]
        losses = [self._train_step(subs, rels, objs, qmask)
                  for subs, rels, objs, _, qmask in
                  stage_quads(data, self.batch_size, self.device)]
        return float(np.sum(torch.stack(losses).cpu().numpy()))

    def evaluate(self, split: str) -> Dict[str, float]:
        parts = []
        with torch.no_grad():
            for subs, rels, objs, _, qmask in stage_quads(
                    self.kg.splits[split], self.batch_size, self.device):
                s = raw_rank_metric_sums(self.model(subs, rels), objs,
                                         qmask.bool())
                parts.append(torch.stack([s[k] for k in RAW_SUMS]))
        sums = dict(zip(RAW_SUMS, torch.stack(parts).cpu().numpy()
                        .sum(0, dtype=np.float64)))
        n = max(sums["count"], 1.0)
        return {"mrr": sums["rr_sum"] / n, "h1": sums["h1_sum"] / n,
                "h3": sums["h3_sum"] / n, "h10": sums["h10_sum"] / n,
                "n": n}

    # -- checkpointing (`state` / `load_state` of FlatParams) -----------
    def host_state(self) -> Dict[str, Any]:
        return {"np_rng": self._np_rng.bit_generator.state}

    def restore_host(self, ckpt_path: str) -> None:
        host = load_host(ckpt_path)
        if host is None:
            return
        try:
            self._np_rng.bit_generator.state = host["np_rng"]
        except (KeyError, ValueError):
            pass

    def save(self, ckpt_dir: str, epoch: int, metric: float) -> str:
        return save_checkpoint(ckpt_dir, self.state(), epoch, metric,
                               host=self.host_state())

    def restore(self, path: str) -> int:
        """From this trainer's ``.pt`` or the JAX package's ``.msgpack``
        (its plain ``adam`` state holds no learning rate: ``lr`` is kept)."""
        state, epoch = load_trainer_checkpoint(path, self.state(), self.lr)
        self.load_state(state)
        self.restore_host(path)
        return epoch

    def fit(self, epochs=None, log=print, logger=None, ckpt_dir=None,
            start_epoch: int = 0) -> Dict[str, Any]:
        epochs = epochs or self.epochs
        best = {"valid_mrr": -1.0}
        for epoch in range(start_epoch, epochs):
            loss = self.train_epoch(epoch)
            vm = self.evaluate("valid")
            row = {"epoch": epoch, "loss": loss,
                   **{f"valid_{k}": v for k, v in vm.items()}}
            if logger is not None:
                logger.log_scalars(epoch, {k: v for k, v in row.items()
                                           if isinstance(v, (int, float))},
                                   tag="eval")
            if vm["mrr"] > best["valid_mrr"]:
                tm = self.evaluate("test")
                row.update({f"test_{k}": v for k, v in tm.items()})
                best = dict(row, valid_mrr=vm["mrr"])
                if ckpt_dir:
                    self.save(ckpt_dir, epoch, vm["mrr"])
            self.history.append(row)
            if ckpt_dir:
                save_latest(ckpt_dir, self.state(), epoch + 1, vm["mrr"],
                            host=self.host_state())
            log(f"simple epoch {epoch} loss {loss:.2f} "
                f"valid MRR {vm['mrr']:.4f}")
        return best
