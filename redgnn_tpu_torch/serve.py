"""Batch inference / serving entry point (static KGs).

Port of ``redgnn_tpu/serve.py:Predictor``: takes (head, relation)
queries and returns the top-k candidate entities with their scores,
built either from a model and a state dict or, as in the JAX package,
from a fitted trainer (`Predictor.from_trainer`). The
per-hop capacities are calibrated on the split's query heads, as the JAX
package does; a batch that expands past them is detected by the
on-device overflow flags and raised, never silently truncated.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from redgnn_tpu_torch.graph.calibrate import calibrate_caps
from redgnn_tpu_torch.models.redgnn import RedGNN
from redgnn_tpu_torch.utils.config import TrainConfig


class Predictor:
    """Top-k link prediction over a frozen model + graph."""

    def __init__(self, model: RedGNN,
                 state_dict: Optional[Dict[str, torch.Tensor]],
                 kg, cfg: TrainConfig, split: str = "test",
                 top_k: int = 10):
        """``model`` serves on its own device, over ``kg``'s graph for
        ``split`` (which must lie on the same device); ``state_dict``,
        when given, is loaded into it first (e.g. from
        `utils.port_params.params_from_flax`). ``cfg`` supplies the batch
        size ``n_tbatch``, ``n_layer`` and ``cap_headroom``.

        ``split`` picks the capacity profile: the caps are calibrated on
        that split's query heads, so serve-time queries of similar
        locality fit."""
        if state_dict is not None:
            model.load_state_dict(state_dict)
        model.eval()
        self.model = model
        self.top_k = top_k
        spec = kg.eval_spec(split)
        if spec.graph.device != model.device:
            raise ValueError(f"graph on {spec.graph.device}, model on "
                             f"{model.device}")
        rowptr, _, tail = spec.graph_np
        heads = (spec.queries[:, 0] if len(spec.queries)
                 else np.zeros(1, np.int64))
        self.caps = calibrate_caps(rowptr, tail, spec.n_ent, heads,
                                   cfg.n_tbatch, cfg.n_layer,
                                   headroom=cfg.cap_headroom)
        self.batch = cfg.n_tbatch
        self.graph = spec.graph

    @classmethod
    def from_trainer(cls, trainer, split: str = "test",
                     top_k: int = 10) -> "Predictor":
        """The JAX package's constructor shape: serve a fitted
        `StaticTrainer`'s model over its KG. The trainer's eval caps of
        ``split`` are used when it has evaluated that split already, and
        are kept there otherwise, as the JAX Predictor does."""
        pred = cls(trainer.model, None, trainer.kg, trainer.cfg,
                   split=split, top_k=top_k)
        pred.caps = trainer.eval_caps.setdefault(split, pred.caps)
        return pred

    @torch.inference_mode()
    def _predict_batch(self, heads: np.ndarray, rels: np.ndarray
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One padded batch of ``self.batch`` queries, on the device:
        (top-k scores, top-k entities, overflow flag)."""
        dev = self.model.device
        n = len(heads)
        qmask = torch.arange(self.batch, device=dev) < n
        hs = torch.zeros(self.batch, dtype=torch.int32, device=dev)
        rs = torch.zeros(self.batch, dtype=torch.int32, device=dev)
        if n:
            hs[:n] = torch.as_tensor(np.asarray(heads), device=dev)
            rs[:n] = torch.as_tensor(np.asarray(rels), device=dev)
        scores, aux = self.model(self.graph, hs, rs, qmask, self.caps)
        overflow = torch.any(aux["edge_overflow"]) | torch.any(
            aux["node_overflow"])
        top_s, top_e = torch.topk(scores, self.top_k, dim=1)
        return top_s[:n], top_e[:n], overflow

    def predict(self, heads: np.ndarray, rels: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores, entities), each (n_queries, top_k)."""
        b = self.batch
        out_s, out_e = [], []
        for start in range(0, len(heads), b):
            hs = heads[start:start + b]
            s, e, overflow = self._predict_batch(hs, rels[start:start + b])
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
