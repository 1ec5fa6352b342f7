"""Row gathers. Port of ``redgnn_tpu/ops/gather.py:take_rows``.

The per-edge embedding lookups (``rela_embed[rel]``) differentiate to a
scatter-add of one row per edge. ``take_rows`` keeps the forward a plain
gather and computes the backward as ``one_hot(idx).T @ grad`` while the
one-hot fits a modest buffer, as the JAX package does. Larger tables take
a scatter-add, `scatter_rows_add`: on a CUDA device the hand-written
kernel ``csrc/take_rows_grad.cu`` (per-block partial tables in shared
memory, added in a fixed order: no float atomics, the same bits on every
run) for every table that `_scatter_plan` admits by shape, else
``index_put_(accumulate=True)``, which sorts the indices and adds equal
ones in order; on the CPU ``index_put_``. The product is exact only in
full fp32: with TF32 matmuls it would round the gradient to 10 mantissa
bits, so the backward refuses to run on a CUDA device while
``torch.backends.cuda.matmul.allow_tf32`` is set.

``take_rows_sorted`` and ``gather_rows_packed`` serve bitmap-dedup hops,
whose index vector is non-decreasing. ``gather_rows_packed``'s backward
sums each row's range of the gradient, `range_sum`: on a CUDA device the
hand-written kernel ``csrc/range_sum.cu``, which adds each range's own
rows (exact up to float32 rounding in a fixed order); on the CPU the JAX
package's difference of the gradient's float32 prefix sum
(`range_sum_scan`), which cancels large partial sums, so those CPU
gradients carry O(total magnitude * eps) noise: fine for training, not
for a strict gradient comparison (``scan_src_backward=False`` there).
``take_rows_sorted``'s backward is that prefix-sum difference on every
device. `range_sum_reference` (float64) is the yardstick the kernel is
held to; only tests and the card's smoke run call it.

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

import ctypes

import torch

from redgnn_tpu_torch import _build
from redgnn_tpu_torch.ops.segment import _segment_sum_scan

# Largest fp32 one-hot (elements) the matmul backward may materialize:
# 32M elements = 128 MB, the JAX package's budget.
_ONEHOT_BUDGET = 32 * 1024 * 1024

# The scatter kernel's partial table lives in shared memory: at most
# this many bytes of it (csrc/take_rows_grad.cu: kMaxTableBytes), at most
# SCATTER_MAX_COLS columns a tile (kMaxCols)
SCATTER_MAX_TABLE_BYTES = 200 * 1024
SCATTER_MAX_COLS = 128


def _scatter_plan(rows: int, dim: int) -> tuple[int, int] | None:
    """(tile, chunk) of the scatter kernel for a (rows, dim) table, or
    None: the table then goes to ``index_put_``.

    The rule, by shape: the kernel takes a table when ``rows *
    min(dim, 32) * 4`` bytes fit ``SCATTER_MAX_TABLE_BYTES`` (200 KB of
    shared memory: up to 1,600 rows at 32 or more columns). ``tile`` is
    the widest of ``min(dim, 128)`` and the multiples of 32 below it
    whose ``rows * tile * 4`` bytes fit (a wider table takes
    ``ceil(dim / tile)`` column tiles); ``chunk``, the ids a block sums,
    is the power of two at or above ``2 * rows`` within [1024, 65536]: a
    function of the table alone, so the order of the sums, and the bits,
    do not depend on the card."""
    if rows <= 0 or dim <= 0:
        return None
    top = min(dim, SCATTER_MAX_COLS)
    for tile in [top] + list(range((top - 1) // 32 * 32, 0, -32)):
        if rows * tile * 4 <= SCATTER_MAX_TABLE_BYTES:
            break
    else:
        return None
    chunk = min(max(1 << (2 * rows - 1).bit_length(), 1024), 65536)
    return tile, chunk


def scatter_rows_add(g: torch.Tensor, idx: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """``d_table[r] = sum of g[e] over idx[e] == r``: the backward of
    `take_rows` above the one-hot budget, the JAX package's
    ``jax.ops.segment_sum`` branch.

    g: (E, D) float32; idx: (E,) int32 or int64 in [0, rows). Returns
    (rows, D) float32. A CUDA tensor launches the kernel
    (``csrc/take_rows_grad.cu``, counted in ``scatter_rows_add.launches``)
    when `_scatter_plan` admits the table by shape, else takes
    ``index_put_(accumulate=True)``; a CPU tensor takes ``index_put_``."""
    if g.dim() != 2 or idx.shape != g.shape[:1]:
        raise ValueError(f"scatter_rows_add wants g (E, D) and idx (E,), "
                         f"got {tuple(g.shape)} and {tuple(idx.shape)}")
    if g.dtype != torch.float32:
        raise TypeError(f"scatter_rows_add sums float32, got {g.dtype}")
    plan = _scatter_plan(rows, g.shape[1])
    if g.device.type == "cpu" or plan is None:
        return g.new_zeros((rows, g.shape[1])).index_put_(
            (idx.long(),), g, accumulate=True)
    tile, chunk = plan
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    g, idx = g.contiguous(), idx.contiguous()
    n, d = g.shape
    out = g.new_empty((rows, d))
    part = g.new_empty((-(-n // chunk), rows, d))
    fn = _build.entry("take_rows_grad", "take_rows_grad_f32",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.launch(fn, (g.data_ptr(), idx.data_ptr(),
                       int(idx.dtype == torch.int64), part.data_ptr(),
                       out.data_ptr(), n, rows, d, tile, chunk), g,
                  f"take_rows_grad ({n} ids, table {rows} x {d})")
    scatter_rows_add.launches += 1
    return out


scatter_rows_add.launches = 0


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
        flat_idx = idx.reshape(-1)
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
            onehot = (flat_idx.long()[:, None] == torch.arange(
                r, device=g.device)[None, :]).to(flat_g.dtype)
            d_table = onehot.T @ flat_g
        else:
            d_table = scatter_rows_add(flat_g, flat_idx, r)
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


def _range_check(g: torch.Tensor, start: torch.Tensor, count: torch.Tensor):
    if g.dim() != 2 or start.dim() != 1 or start.shape != count.shape:
        raise ValueError(f"range sum wants g (E, D), start and count (P,), "
                         f"got {tuple(g.shape)}, {tuple(start.shape)} and "
                         f"{tuple(count.shape)}")


def range_sum_scan(g: torch.Tensor, start: torch.Tensor,
                   count: torch.Tensor) -> torch.Tensor:
    """`range_sum` as the JAX package's ``_gp_bwd`` computes it: the
    difference of the float32 prefix sum ``P = cumsum(g)`` at each
    range's ends, ``P[start + count - 1] - P[start - 1]``. The CPU path;
    its cancellation noise is O(E * u * sum|g|)."""
    _range_check(g, start, count)
    start, count = start.long(), count.long()
    e_cap = g.shape[0]
    p = torch.cumsum(g.to(torch.float32), 0)
    # clip before indexing: a range cut by e_cap reads the last slot
    # on both sides and adds P[last] - P[last] = 0
    last = torch.clamp(start + count - 1, 0, e_cap - 1)
    prev = torch.clamp(start - 1, 0, e_cap - 1)
    owns = count > 0
    pe = torch.where(owns[:, None], p[last], 0.0)
    ps = torch.where((owns & (start > 0))[:, None], p[prev], 0.0)
    return pe - ps


def range_sum_reference(g: torch.Tensor, start: torch.Tensor,
                        count: torch.Tensor) -> torch.Tensor:
    """`range_sum` in float64, with no prefix cancellation: every slot of
    every clipped range added to its row by ``index_add_``. The yardstick
    the kernel is held to (tests and the card's smoke run); returns
    (P, D) float64."""
    _range_check(g, start, count)
    e, d = g.shape
    p = start.shape[0]
    s, c = start.long(), count.long()
    lo = torch.clamp(s, 0, e)
    hi = torch.maximum(torch.clamp(s + torch.clamp(c, min=0), max=e), lo)
    length = hi - lo
    owner = torch.repeat_interleave(torch.arange(p, device=g.device), length)
    first = torch.cumsum(length, 0) - length
    slot = lo[owner] + torch.arange(owner.shape[0], device=g.device) \
        - first[owner]
    out = torch.zeros((p, d), dtype=torch.float64, device=g.device)
    return out.index_add_(0, owner, g.to(torch.float64)[slot])


def range_sum(g: torch.Tensor, start: torch.Tensor,
              count: torch.Tensor) -> torch.Tensor:
    """Row ``v`` of the result: the float32 sum of ``g[e]`` over ``e`` in
    ``[start[v], start[v] + count[v])`` intersected with ``[0, E)`` (0
    for ``count <= 0`` or ``start >= E``; a range cut by E is a partial
    sum). The backward of `gather_rows_packed`.

    g: (E, D) float; start / count: (P,) int32 or int64. Returns (P, D)
    float32. A CUDA tensor launches the kernel (``csrc/range_sum.cu``,
    counted in ``range_sum.launches``), which adds each range's own rows
    in a fixed order; a CPU tensor takes `range_sum_scan`, the JAX
    package's prefix-sum difference."""
    if g.device.type == "cpu":
        return range_sum_scan(g, start, count)
    _range_check(g, start, count)
    g = g.to(torch.float32).contiguous()
    start, count = start.long().contiguous(), count.long().contiguous()
    e, d = g.shape
    p = start.shape[0]
    out = g.new_empty((p, d))
    if p == 0 or d == 0:
        return out
    vec = d % 4 == 0 and g.data_ptr() % 16 == 0
    fn = _build.entry("range_sum", "range_sum_f32",
                      [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _build.launch(fn, (g.data_ptr(), start.data_ptr(), count.data_ptr(),
                       out.data_ptr(), e, d, p, int(vec)), g,
                  f"range_sum ({e} slots, {p} rows)")
    range_sum.launches += 1
    return out


range_sum.launches = 0


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
        return None, range_sum(g_vals, start, count), None, None, None


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

    Backward (``values`` only): `range_sum`, ``d_values[v] = sum of
    g[start[v] : start[v] + count[v]]`` — no edge-length scatter; on a
    CUDA device the kernel, on the CPU the JAX package's prefix-sum
    difference. Index slots outside every range (the padded tail) must
    carry zero gradient, as the frontier's masked pads do. Ranges clipped
    by the length of ``idx`` degrade to partial sums.

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
