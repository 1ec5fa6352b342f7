"""Non-propagation baselines shipped with the reference.

Port of ``redgnn_tpu/models/baselines.py``:

  * SimplE (`Temporal/extrapolation/simple.py`): bilinear embedding
    scorer over all entities — two plain matmuls per batch.
"""

from __future__ import annotations

import torch
from torch import nn

from redgnn_tpu_torch.models.temporal import _xavier_uniform_
from redgnn_tpu_torch.utils.device import resolve_device


class SimplE(nn.Module):
    """score(h, r, t) = ( <eh_h, rf_r, et_t> + <eh_t, ri_r, et_h> ) / 2
    evaluated against every candidate tail at once (`simple.py:38-45`).
    Parameters carry the flax names and (rows, hidden) layouts."""

    def __init__(self, n_ent: int, n_rel: int, hidden_dim: int = 64,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, rows in (("ent_embs_h", n_ent), ("ent_embs_t", n_ent),
                           ("rel_embs_f", n_rel), ("rel_embs_i", n_rel)):
            p = nn.Parameter(torch.empty(rows, hidden_dim))
            _xavier_uniform_(p, generator)
            self.register_parameter(name, p)
        self.to(resolve_device(device))

    def forward(self, heads: torch.Tensor, rels: torch.Tensor
                ) -> torch.Tensor:
        heads, rels = heads.long(), rels.long()
        fwd = (self.ent_embs_h[heads] * self.rel_embs_f[rels]) \
            @ self.ent_embs_t.T                             # (B, n_ent)
        inv = (self.ent_embs_t[heads] * self.rel_embs_i[rels]) \
            @ self.ent_embs_h.T
        return (fwd + inv) / 2.0
