"""Batch inference / serving entry point.

Port of ``redgnn_tpu/serve.py:Predictor``: takes (head, relation[, time])
queries and returns the top-k candidate entities with their scores, built
either from a model and a state dict or, as in the JAX package, from a
fitted trainer (`Predictor.from_trainer`). Static KGs: the per-hop
capacities are calibrated on the split's query heads, as the JAX package
does. Temporal KGs: they are the exact caps of the split's quadruples in
batches of ``eval_batch_size`` (the JAX Predictor's profile: the
trainer's ``_get_caps`` of ``eval_<split>``). A batch that expands past
them is detected by the on-device overflow flags and raised, never
silently truncated.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from redgnn_tpu_torch.graph.calibrate import FrontierCaps, calibrate_caps
from redgnn_tpu_torch.train.temporal_loop import exact_caps
from redgnn_tpu_torch.utils.config import TemporalTrainConfig


class Predictor:
    """Top-k link prediction over a frozen model + graph."""

    def __init__(self, model, state_dict: Optional[Dict[str, torch.Tensor]],
                 kg, cfg, split: str = "test", top_k: int = 10,
                 caps: Optional[FrontierCaps] = None):
        """``model`` (a RedGNN over a static KG, or a TRedGNN over a
        TemporalKG with a TemporalTrainConfig) serves on its own device,
        over ``kg``'s graph for ``split`` (which must lie on the same
        device); ``state_dict``, when given, is loaded into it first (e.g.
        from `utils.port_params.params_from_flax`). ``cfg`` supplies the
        batch size (``n_tbatch`` / ``eval_batch_size``), ``n_layer`` and,
        for static KGs, ``cap_headroom``.

        ``split`` picks the capacity profile, so serve-time queries of
        similar locality fit; ``caps``, when given, is used instead."""
        if state_dict is not None:
            model.load_state_dict(state_dict)
        model.eval()
        self.model = model
        self.top_k = top_k
        self.temporal = isinstance(cfg, TemporalTrainConfig)
        if self.temporal:
            self.batch = cfg.eval_batch_size
            self.graph = kg.graph
            self._kg_args = kg.model_args()
            if caps is None:
                caps = exact_caps(kg, cfg, kg.splits[split], self.batch)
        else:
            spec = kg.eval_spec(split)
            self.batch = cfg.n_tbatch
            self.graph = spec.graph
            if caps is None:
                rowptr, _, tail = spec.graph_np
                heads = (spec.queries[:, 0] if len(spec.queries)
                         else np.zeros(1, np.int64))
                caps = calibrate_caps(rowptr, tail, spec.n_ent, heads,
                                      cfg.n_tbatch, cfg.n_layer,
                                      headroom=cfg.cap_headroom)
        if self.graph.device != model.device:
            raise ValueError(f"graph on {self.graph.device}, model on "
                             f"{model.device}")
        self.caps = caps

    @classmethod
    def from_trainer(cls, trainer, split: str = "test",
                     top_k: int = 10) -> "Predictor":
        """The JAX package's constructor shape: serve a fitted
        `StaticTrainer`'s or `TemporalTrainer`'s model over its KG. A
        static trainer's eval caps of ``split`` are used when it has
        evaluated that split already, and are kept there otherwise; a
        temporal trainer gives its exact caps of ``eval_<split>`` (grown
        to the whole split), as the JAX Predictor takes them."""
        if isinstance(trainer.cfg, TemporalTrainConfig):
            caps = trainer._get_caps(f"eval_{split}",
                                     trainer.kg.splits[split],
                                     trainer.cfg.eval_batch_size)
            return cls(trainer.model, None, trainer.kg, trainer.cfg,
                       split=split, top_k=top_k, caps=caps)
        pred = cls(trainer.model, None, trainer.kg, trainer.cfg,
                   split=split, top_k=top_k,
                   caps=trainer.eval_caps.get(split))
        pred.caps = trainer.eval_caps.setdefault(split, pred.caps)
        return pred

    @torch.inference_mode()
    def _predict_batch(self, heads: np.ndarray, rels: np.ndarray,
                       times: Optional[np.ndarray]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One padded batch of ``self.batch`` queries, on the device:
        (top-k scores, top-k entities, overflow flag)."""
        dev = self.model.device
        n = len(heads)
        qmask = torch.arange(self.batch, device=dev) < n
        cols = [torch.zeros(self.batch, dtype=torch.int32, device=dev)
                for _ in range(3)]
        if n:
            for col, vals in zip(cols, (heads, rels, times)):
                if vals is not None:
                    col[:n] = torch.as_tensor(np.asarray(vals), device=dev)
        hs, rs, ts = cols
        if self.temporal:
            graph, etime, ekey, selfloop_slot, time_rowptr, dense = \
                self._kg_args
            scores, aux = self.model(graph, etime, hs, rs, ts, qmask,
                                     self.caps, None, False, ekey,
                                     selfloop_slot, time_rowptr, dense)
        else:
            scores, aux = self.model(self.graph, hs, rs, qmask, self.caps)
        overflow = torch.any(aux["edge_overflow"]) | torch.any(
            aux["node_overflow"])
        top_s, top_e = torch.topk(scores, self.top_k, dim=1)
        return top_s[:n], top_e[:n], overflow

    def predict(self, heads: np.ndarray, rels: np.ndarray,
                times: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores, entities), each (n_queries, top_k). ``times``
        (time ids) is read by temporal models only; None means time 0."""
        b = self.batch
        out_s, out_e = [], []
        for start in range(0, len(heads), b):
            hs = heads[start:start + b]
            ts = None if times is None else times[start:start + b]
            s, e, overflow = self._predict_batch(hs, rels[start:start + b],
                                                 ts)
            if bool(overflow):
                raise RuntimeError(
                    "frontier capacity overflow for queries "
                    f"[{start}:{start + len(hs)}]: these heads expand past "
                    "the serving profile calibrated at construction — "
                    "rebuild the Predictor with a wider split profile or "
                    "raise cfg.cap_headroom")
            out_s.append(s.cpu().numpy())
            out_e.append(e.cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_e)
