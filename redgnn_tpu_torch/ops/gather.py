"""Row gathers. Port of ``redgnn_tpu/ops/gather.py`` (forward only).

The JAX package gives ``take_rows`` a one-hot matmul backward for the
TPU; the backward belongs to the training slice and is not ported yet.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an (R, D) table and int indices in [0, R)."""
    return table[idx.long()]
