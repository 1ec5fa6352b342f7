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

``take_rows_sorted`` and ``gather_rows_packed`` serve bitmap-dedup hops,
whose index vector is non-decreasing: their backward is a difference of
the gradient's prefix sum instead of a scatter-add. The prefix sum
(``torch.cumsum``, float32) cancels large partial sums, so those
gradients carry O(total magnitude * eps) noise: fine for training, not
for a strict gradient comparison (``scan_src_backward=False`` there).

bfloat16 compute (``compute_dtype="bfloat16"``) gathers rows of bf16
copies of float32 tensors. The backward of such a gather adds the bf16
cotangents of every row gathered more than once: in bf16 that sum stalls
(at 256, adding ones: 256 + 1 rounds back to 256), as it does in the JAX
package, whose gathers from bf16 tables scatter-add in bf16. Here every
such sum is taken in float32: `gather_bf16` hands its float32 gradient
straight to the float32 source, and `take_rows` on a bf16 table sums in
float32 and rounds once, as the JAX package's one-hot product does.
"""

from __future__ import annotations

import torch

from redgnn_tpu_torch.ops.segment import _segment_sum_scan

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
        # a bf16 cotangent is summed in float32 and rounded once (the JAX
        # package's one-hot product: preferred_element_type=float32)
        low = flat_g.dtype != torch.float32
        if low:
            flat_g = flat_g.to(torch.float32)
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
        if low:
            d_table = d_table.to(g.dtype)
        return d_table.reshape(ctx.table_shape), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with a matmul backward for a small ``table``.

    table: (R, D) float tensor; idx: int tensor of any shape with values
    in [0, R)."""
    if table.requires_grad and torch.is_grad_enabled():
        return _TakeRows.apply(table, idx)
    return table[idx.long()]


class _GatherBf16(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx):
        i = idx.long()
        ctx.save_for_backward(i)
        ctx.table_shape = table.shape
        return table.to(torch.bfloat16)[i]

    @staticmethod
    def backward(ctx, g):
        (i,) = ctx.saved_tensors
        flat_i = i.reshape(-1)
        flat_g = g.reshape((flat_i.shape[0],) + ctx.table_shape[1:])
        # float32 sums; index_put_ sorts the indices on a CUDA device and
        # adds equal ones in order (no float atomics)
        d_table = flat_g.new_zeros(ctx.table_shape, dtype=torch.float32)
        return d_table.index_put_((flat_i,), flat_g.to(torch.float32),
                                  accumulate=True), None


def gather_bf16(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.to(bfloat16)[idx]``: rows of the bf16 copy of a float32
    ``table``, whose gradient is the float32 sum of the rows' bf16
    cotangents, handed to ``table`` as it is (no bf16 round trip).

    table: (R, ...) float32 tensor; idx: int tensor of any shape with
    values in [0, R). Returns idx.shape + table.shape[1:], bf16."""
    if table.dtype != torch.float32:
        raise TypeError(f"gather_bf16 takes a float32 table, got "
                        f"{table.dtype}")
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherBf16.apply(table, idx)
    return table.to(torch.bfloat16)[idx.long()]


class _TakeRowsSorted(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        r = ctx.rows
        flat_g = g.reshape(idx.shape[0], -1)
        d_table = _segment_sum_scan(flat_g, idx, r)
        return d_table.reshape((r,) + g.shape[1:]).to(g.dtype), None


def take_rows_sorted(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for NON-DECREASING ``idx``, with a prefix-sum
    backward (`ops.segment._segment_sum_scan`) in place of the
    scatter-add. Sortedness is not checked: a wrong claim mis-sums the
    gradient without a word.

    table: (R, D) float tensor; idx: (E,) int tensor, non-decreasing,
    values in [0, R)."""
    if table.requires_grad and torch.is_grad_enabled():
        return _TakeRowsSorted.apply(table, idx)
    return table[idx.long()]


class _GatherRowsPacked(torch.autograd.Function):

    @staticmethod
    def forward(ctx, meta, values, idx, start, count):
        ctx.save_for_backward(start, count)
        i = idx.long()
        rows = meta[i]
        ctx.mark_non_differentiable(rows)
        return rows, values[i]

    @staticmethod
    def backward(ctx, _g_meta, g_vals):
        start, count = ctx.saved_tensors
        start, count = start.long(), count.long()
        e_cap = g_vals.shape[0]
        p = torch.cumsum(g_vals.to(torch.float32), 0)
        # clip before indexing: a range cut by e_cap reads the last slot
        # on both sides and adds P[last] - P[last] = 0
        last = torch.clamp(start + count - 1, 0, e_cap - 1)
        prev = torch.clamp(start - 1, 0, e_cap - 1)
        owns = count > 0
        pe = torch.where(owns[:, None], p[last], 0.0)
        ps = torch.where((owns & (start > 0))[:, None], p[prev], 0.0)
        return None, pe - ps, None, None, None


def gather_rows_packed(meta: torch.Tensor, values: torch.Tensor,
                       idx: torch.Tensor, start: torch.Tensor,
                       count: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(meta[idx], values[idx])`` at a shared index vector with
    CSR-range structure: row ``v`` of the tables is referenced by exactly
    the index slots ``[start[v], start[v] + count[v])``.

    Forward: two plain gathers. The JAX package bitcasts the float rows
    into the int table and fetches one (M + D)-wide row because a TPU row
    gather costs the same at any width; on a GPU a gather is bound by the
    bytes it moves, and the packed table would be one more pass over
    ``values`` to build it. The bits are those of two gathers either way.

    Backward (``values`` only): ``P = cumsum(g)``,
    ``d_values[v] = P[start + count - 1] - P[start - 1]`` — no edge-length
    scatter. Index slots outside every range (the padded tail) must carry
    zero gradient, as the frontier's masked pads do. Ranges clipped by the
    length of ``idx`` degrade to partial sums.

    meta: (P, M) int tensor; values: (P, D) float32 (anything else
    raises, as in the JAX package); idx: (E,) int, non-decreasing, in
    [0, P); start / count: (P,) int32 or int64."""
    if values.dtype != torch.float32:
        raise TypeError("gather_rows_packed requires float32 values "
                        f"(got {values.dtype})")
    if values.requires_grad and torch.is_grad_enabled():
        return _GatherRowsPacked.apply(meta, values, idx, start, count)
    i = idx.long()
    return meta[i], values[i]
