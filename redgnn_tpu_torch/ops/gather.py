"""Row gathers. Port of ``redgnn_tpu/ops/gather.py:take_rows``.

The per-edge embedding lookups (``rela_embed[rel]``) differentiate to a
scatter-add of one row per edge. ``take_rows`` keeps the forward a plain
gather and computes the backward as ``one_hot(idx).T @ grad`` while the
one-hot fits a modest buffer, as the JAX package does; larger tables take
a scatter-add (``index_put_(accumulate=True)``, which sorts the indices
on a CUDA device and adds equal ones in order: no float atomics, the same
bits on every run). The product is exact only in full fp32: with TF32 matmuls
it would round the gradient to 10 mantissa bits, so the backward refuses
to run on a CUDA device while ``torch.backends.cuda.matmul.allow_tf32`` is
set.

Not ported yet: ``take_rows_sorted`` and ``gather_rows_packed`` (they
serve bitmap-dedup hops).
"""

from __future__ import annotations

import torch

# Largest fp32 one-hot (elements) the matmul backward may materialize:
# 32M elements = 128 MB, the JAX package's budget.
_ONEHOT_BUDGET = 32 * 1024 * 1024


class _TakeRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        r = ctx.table_shape[0]
        flat_idx = idx.reshape(-1).long()
        flat_g = g.reshape(flat_idx.shape[0], -1)
        if flat_idx.shape[0] * r <= _ONEHOT_BUDGET:
            if g.is_cuda and torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError(
                    "take_rows: the one-hot backward needs fp32 matmuls; "
                    "set torch.backends.cuda.matmul.allow_tf32 = False")
            onehot = (flat_idx[:, None] == torch.arange(
                r, device=g.device)[None, :]).to(flat_g.dtype)
            d_table = onehot.T @ flat_g
        else:
            d_table = flat_g.new_zeros((r, flat_g.shape[1])).index_put_(
                (flat_idx,), flat_g, accumulate=True)
        return d_table.reshape(ctx.table_shape), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with a matmul backward for a small ``table``.

    table: (R, D) float tensor; idx: int tensor of any shape with values
    in [0, R)."""
    if table.requires_grad and torch.is_grad_enabled():
        return _TakeRows.apply(table, idx)
    return table[idx.long()]
