"""Row gathers. Port of ``redgnn_tpu/ops/gather.py:take_rows``.

The per-edge embedding lookups (``rela_embed[rel]``) differentiate to a
scatter-add of one row per edge. ``take_rows`` keeps the forward a plain
gather and computes the backward as ``one_hot(idx).T @ grad`` while the
one-hot fits a modest buffer, as the JAX package does. Larger tables take
a scatter-add, `scatter_rows_add`: on a CUDA device the hand-written
kernel ``csrc/take_rows_grad.cu`` (a stable counting sort of the ids,
then slot-balanced sums of the sorted runs, added in a fixed order: no
float atomics, the same bits on every run) for every table that
`_scatter_plan` admits by shape, else
``index_put_(accumulate=True)``, which sorts the indices and adds equal
ones in order; on the CPU ``index_put_``. The product is exact only in
full fp32: with TF32 matmuls it would round the gradient to 10 mantissa
bits, so the backward refuses to run on a CUDA device while
``torch.backends.cuda.matmul.allow_tf32`` is set.

``gather_rows_listed`` is the dense hop's packed-row gather
``packed[tsrc]``: a plain gather forward, and a backward that sums each
table row's edges through a list given with the graph (the stable order
of ``tsrc`` and the CSR's own row offsets), `list_sum`: on a CUDA device
the hand-written kernel ``csrc/list_sum.cu`` (the share pass of the two
kernels above, no atomics, one order fixed by shapes), on the CPU the
``index_put_(accumulate=True)`` that autograd of the plain gather takes.

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
device. `range_sum_reference` and `list_sum_reference` (float64) are the
yardsticks the kernels are held to; `range_sum_model`,
`scatter_rows_add_model` and `list_sum_model` repeat the three kernels'
summation order in plain PyTorch. Only tests and the card's smoke run
call those five.

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
from typing import NamedTuple

import torch

from redgnn_tpu_torch import _build
from redgnn_tpu_torch.ops.segment import _segment_sum_scan

# Largest fp32 one-hot (elements) the matmul backward may materialize:
# 32M elements = 128 MB, the JAX package's budget.
_ONEHOT_BUDGET = 32 * 1024 * 1024

# Both gather backwards end in the share pass of csrc/share_sum.cuh: a
# block of SHARE_WARPS warps sums SHARE_WARPS * share consecutive positions
# of a list of slots laid out in runs of equal row, each warp `share` of
# them; the fix-up pass adds the block partials of a row that crosses
# blocks in groups of SHARE_FIX_GROUP blocks. A block sums at most
# SHARE_MAX_COLS columns (wider rows take column tiles).
SHARE_WARPS = 8
SHARE_FIX_GROUP = 16
SHARE_MAX_COLS = 128
SHARE_TARGET_BLOCKS = 1024
# csrc/take_rows_grad.cu: the sort passes' ids a block (kChunk) and the
# table rows its count tables take (kMaxRows)
SCATTER_CHUNK = 4096
SCATTER_MAX_ROWS = 4096
# csrc/range_sum.cu: rows a block of the scan passes takes (kScanRows)
RANGE_SCAN_ROWS = 512


class ScatterPlan(NamedTuple):
    tile: int    # columns a block of the share pass sums
    chunk: int   # ids a block of the sort passes reads
    share: int   # sorted slots a warp of the share pass sums
    chunks: int  # blocks of the sort passes
    blocks: int  # blocks of the share and fix-up passes


class RangePlan(NamedTuple):
    tile: int    # columns a block of the share pass sums
    share: int   # list positions a warp of the share pass sums
    tiles: int   # blocks of the scan passes
    blocks: int  # blocks of the share and fix-up passes


class ListPlan(NamedTuple):
    tile: int    # columns a block of the share pass sums
    share: int   # list positions a warp of the share pass sums
    blocks: int  # blocks of the share and fix-up passes


def share_slots(n: int) -> int:
    """Positions a warp of the share pass sums, for a list of ``n``: the
    power of two at or below ``n / (SHARE_WARPS * SHARE_TARGET_BLOCKS)``
    within [64, 1024], so that a list of up to 8.4M positions takes about
    SHARE_TARGET_BLOCKS blocks or more (several waves on the card) and a
    warp at least 64 positions. A function of ``n`` alone."""
    q = max(n // (SHARE_WARPS * SHARE_TARGET_BLOCKS), 1)
    return min(max(1 << (q.bit_length() - 1), 64), 1024)


def _blocks(n: int, share: int) -> int:
    return -(-n // (SHARE_WARPS * share))


def _scatter_plan(n: int, rows: int, dim: int) -> ScatterPlan | None:
    """The scatter kernel's launch plan for ``n`` ids into a (rows, dim)
    table, or None: the table then goes to ``index_put_``.

    The rule, by shape: the kernel takes tables of 1 to SCATTER_MAX_ROWS
    rows (its count tables; the table itself never sits in shared
    memory) at any width (column tiles of up to SHARE_MAX_COLS) and up to
    2^31 - 1 ids. Every number is a function of (n, rows, dim) alone, so
    the order of the sums, and the bits, do not depend on the card."""
    if rows <= 0 or dim <= 0 or rows > SCATTER_MAX_ROWS or n >= 2 ** 31:
        return None
    share = share_slots(n)
    return ScatterPlan(min(dim, SHARE_MAX_COLS), SCATTER_CHUNK, share,
                       -(-n // SCATTER_CHUNK), _blocks(n, share))


def _range_plan(n: int, p: int, dim: int) -> RangePlan:
    """The range-sum kernel's launch plan for ``p`` ranges over ``n``
    slots of width ``dim``: a function of (n, p, dim) alone. The share
    pass's grid is sized by ``n``: ranges that do not overlap list at most
    ``n`` slots; a longer list takes wider shares on the device
    (csrc/share_sum.cuh: effective_share)."""
    share = share_slots(n)
    return RangePlan(min(max(dim, 1), SHARE_MAX_COLS), share,
                     -(-p // RANGE_SCAN_ROWS), _blocks(n, share))


def _list_plan(e: int, n: int, w: int) -> ListPlan | None:
    """The list-sum kernel's launch plan for a list of ``e`` positions
    into ``n`` rows of width ``w``, or None where the kernel's int32
    positions and rows do not reach (``e`` or ``n`` at 2^31 or more): a
    function of (e, n, w) alone."""
    if e >= 2 ** 31 or n >= 2 ** 31:
        return None
    share = share_slots(e)
    return ListPlan(min(max(w, 1), SHARE_MAX_COLS), share, _blocks(e, share))


def _copy_bytes(g: torch.Tensor, tile: int) -> int:
    """Bytes of a piece of a row-by-row copy into shared memory: 16, 8 or
    4, as g's row width, the tile and g's alignment allow."""
    d, ptr = g.shape[1], g.data_ptr()
    for wb in (16, 8):
        if d % (wb // 4) == 0 and tile % (wb // 4) == 0 and ptr % wb == 0:
            return wb
    return 4


def _fold_runs(x: torch.Tensor, key: torch.Tensor, group: torch.Tensor):
    """Sum each run of equal (group, key) of ``x``'s rows from 0, left to
    right, one float32 add at a time. Returns the runs' (key, group,
    sum)."""
    n = key.shape[0]
    if n == 0:
        return key, group, x[:0]
    new = torch.ones(n, dtype=torch.bool, device=x.device)
    new[1:] = (key[1:] != key[:-1]) | (group[1:] != group[:-1])
    starts = torch.nonzero(new).squeeze(1)
    length = torch.diff(starts, append=starts.new_tensor([n]))
    acc = x.new_zeros((starts.shape[0],) + x.shape[1:])
    for t in range(int(length.max())):
        live = torch.nonzero(length > t).squeeze(1)
        acc[live] = acc[live] + x[starts[live] + t]
    return key[starts], group[starts], acc


def _share_order_sum(x: torch.Tensor, key: torch.Tensor, share: int,
                     rows: int) -> torch.Tensor:
    """The share pass's sums, in its order, in plain PyTorch: row r of
    the result adds the rows of ``x`` (the list, in order) whose ``key``
    is r (keys non-decreasing): each warp's runs (``share`` positions a
    warp), then a row's warp sums within a block (SHARE_WARPS warps), then
    its block sums within a group of SHARE_FIX_GROUP blocks, then the
    groups' sums; every sum from 0, left to right. Float adds are exact
    IEEE operations on both devices, so this gives the kernels' bits."""
    pos = torch.arange(key.shape[0], device=x.device)
    k, grp, s = _fold_runs(x, key, pos // share)
    k, grp, s = _fold_runs(s, k, grp // SHARE_WARPS)
    k, grp, s = _fold_runs(s, k, grp // SHARE_FIX_GROUP)
    k, _, s = _fold_runs(s, k, torch.zeros_like(grp))
    out = x.new_zeros((rows,) + x.shape[1:])
    out[k] = s
    return out


def scatter_rows_add_model(g: torch.Tensor, idx: torch.Tensor, rows: int,
                           share: int | None = None) -> torch.Tensor:
    """`scatter_rows_add` in the kernel's order, in plain PyTorch (tests
    and the card's smoke run): the stable sort of the valid ids, then
    `_share_order_sum` at the plan's share (or ``share``)."""
    i = idx.reshape(-1).long()
    slots = torch.nonzero((i >= 0) & (i < rows)).squeeze(1)
    keys, order = torch.sort(i[slots], stable=True)
    if share is None:
        share = share_slots(g.shape[0])
    return _share_order_sum(g[slots[order]].to(torch.float32), keys, share,
                            rows)


def range_sum_model(g: torch.Tensor, start: torch.Tensor,
                    count: torch.Tensor,
                    share: int | None = None) -> torch.Tensor:
    """`range_sum` in the kernel's order, in plain PyTorch (tests and the
    card's smoke run): the clipped ranges' slots laid end to end, then
    `_share_order_sum` at the plan's share (or ``share``), widened as the
    kernel widens it for a list longer than its grid."""
    _range_check(g, start, count)
    e, p = g.shape[0], start.shape[0]
    lo, length = _clipped(start, count, e)
    if share is None:
        share = share_slots(e)
    total = int(length.sum())
    cap, block = max(_blocks(e, share), 1), SHARE_WARPS * share
    shares = -(-total // block)
    if shares > cap:
        share *= -(-shares // cap)
    owner = torch.repeat_interleave(torch.arange(p, device=g.device), length)
    first = torch.cumsum(length, 0) - length
    slot = lo[owner] + torch.arange(total, device=g.device) - first[owner]
    return _share_order_sum(g[slot].to(torch.float32), owner, share, p)


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
    n, d = g.shape
    plan = _scatter_plan(n, rows, d)
    if g.device.type == "cpu" or plan is None:
        return g.new_zeros((rows, d)).index_put_(
            (idx.long(),), g, accumulate=True)
    out, _ = _scatter_launch(g, idx, rows, plan)
    return out


def _scatter_launch(g: torch.Tensor, idx: torch.Tensor, rows: int,
                    plan: ScatterPlan):
    """Launch csrc/take_rows_grad.cu on CUDA tensors: (out, sorted), the
    (rows, D) sums and the kernel's sorted list, (E, 2) int32 (slot, row)
    pairs of the valid ids in its first rows (the card tests read it)."""
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    g, idx = g.contiguous(), idx.contiguous()
    n, d = g.shape
    out = g.new_empty((rows, d))
    # int32 scratch: the sorted (slot, row) pairs first (8-byte aligned),
    # then the count table, the totals, the row starts and the tails
    sizes = [2 * n, rows * plan.chunks, rows, rows + 1, plan.blocks]
    ints = torch.empty(sum(sizes), dtype=torch.int32, device=g.device)
    ptrs, at = [], 0
    for size in sizes:
        ptrs.append(ints.data_ptr() + 4 * at)
        at += size
    bpart = g.new_empty((plan.blocks, 2, d))
    fn = _build.entry("take_rows_grad", "take_rows_grad_f32",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                      + [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    _build.launch(fn, (g.data_ptr(), idx.data_ptr(),
                       int(idx.dtype == torch.int64), *ptrs, bpart.data_ptr(),
                       out.data_ptr(), n, rows, d, plan.tile, plan.chunk,
                       plan.share, _copy_bytes(g, plan.tile)), g,
                  f"take_rows_grad ({n} ids, table {rows} x {d})")
    scatter_rows_add.launches += 1
    return out, ints[:2 * n].view(n, 2)


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


def _clipped(start: torch.Tensor, count: torch.Tensor, e: int):
    """(lo, length) of each range clipped to [0, e), int64."""
    s, c = start.long(), count.long()
    lo = torch.clamp(s, 0, e)
    hi = torch.maximum(torch.clamp(s + torch.clamp(c, min=0), max=e), lo)
    return lo, hi - lo


def range_sum_reference(g: torch.Tensor, start: torch.Tensor,
                        count: torch.Tensor) -> torch.Tensor:
    """`range_sum` in float64, with no prefix cancellation: every slot of
    every clipped range added to its row by ``index_add_``. The yardstick
    the kernel is held to (tests and the card's smoke run); returns
    (P, D) float64."""
    _range_check(g, start, count)
    e, d = g.shape
    p = start.shape[0]
    lo, length = _clipped(start, count, e)
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
    in a fixed order (`range_sum_model`); a CPU tensor takes
    `range_sum_scan`, the JAX package's prefix-sum difference."""
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
    plan = _range_plan(e, p, d)
    # int64 scratch: the tiles' sums, the row starts in the list and the
    # clipped starts
    longs = torch.empty(plan.tiles + 2 * p + 1, dtype=torch.int64,
                        device=g.device)
    # int32 scratch: the shares' tail rows, each warp's first row
    ints = torch.empty((SHARE_WARPS + 1) * plan.blocks, dtype=torch.int32,
                       device=g.device)
    bpart = g.new_empty((plan.blocks, 2, d))
    base, ibase = longs.data_ptr(), ints.data_ptr()
    fn = _build.entry("range_sum", "range_sum_f32",
                      [ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _build.launch(fn, (g.data_ptr(), start.data_ptr(), count.data_ptr(),
                       out.data_ptr(), base, base + 8 * plan.tiles,
                       base + 8 * (plan.tiles + p + 1), ibase,
                       ibase + 4 * plan.blocks, bpart.data_ptr(), e, d, p,
                       plan.tile, plan.share, _copy_bytes(g, plan.tile)), g,
                  f"range_sum ({e} slots, {p} rows)")
    range_sum.launches += 1
    return out


range_sum.launches = 0


def _list_check(g: torch.Tensor, order: torch.Tensor, off: torch.Tensor):
    if g.dim() != 2 or order.shape != g.shape[:1] or off.dim() != 1 \
            or off.shape[0] < 1:
        raise ValueError(f"list sum wants g (E, W), order (E,) and off "
                         f"(N + 1,), got {tuple(g.shape)}, "
                         f"{tuple(order.shape)} and {tuple(off.shape)}")


def _list_rows(off: torch.Tensor) -> torch.Tensor:
    """The row of each listed position, (off[-1],) int64."""
    n = off.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=off.device),
                                   torch.diff(off.long()))


def list_sum_model(g: torch.Tensor, order: torch.Tensor, off: torch.Tensor,
                   plan: ListPlan | None = None) -> torch.Tensor:
    """`list_sum` in the kernel's order, in plain PyTorch (tests and the
    card's smoke run): the listed slots' rows in list order, then
    `_share_order_sum` at the plan's share (`_list_plan`, or ``plan``)."""
    _list_check(g, order, off)
    e, w = g.shape
    n = off.shape[0] - 1
    if plan is None:
        plan = _list_plan(e, n, w)
    rows = _list_rows(off)
    x = g[order[:rows.shape[0]].long()].to(torch.float32)
    return _share_order_sum(x, rows, plan.share, n)


def list_sum_reference(g: torch.Tensor, order: torch.Tensor,
                       off: torch.Tensor) -> torch.Tensor:
    """`list_sum` in float64 by ``index_add_``: the yardstick the kernel
    is held to (tests and the card's smoke run); returns (N, W)
    float64."""
    _list_check(g, order, off)
    rows = _list_rows(off)
    out = torch.zeros((off.shape[0] - 1, g.shape[1]), dtype=torch.float64,
                      device=g.device)
    return out.index_add_(0, rows, g[order[:rows.shape[0]].long()].double())


def list_sum(g: torch.Tensor, order: torch.Tensor,
             off: torch.Tensor) -> torch.Tensor:
    """Row ``v`` of the result: the float32 sum of ``g[order[t]]`` over
    ``t`` in ``[off[v], off[v + 1])`` (0 for an empty row). The backward
    of `gather_rows_listed`.

    g: (E, W) float32; order: (E,) int32, each list position's slot of g
    (a permutation); off: (N + 1,) int32, the rows' first positions,
    ``off[0] = 0``, ``off[N] <= E``. Returns (N, W) float32. A CUDA tensor
    launches the kernel (``csrc/list_sum.cu``, counted in
    ``list_sum.launches``), which adds in a fixed order (`list_sum_model`)
    and raises on what it does not take (another dtype, 2^31 positions or
    more); a CPU tensor takes ``index_put_(accumulate=True)`` of the
    listed rows by their row."""
    _list_check(g, order, off)
    e, w = g.shape
    n = off.shape[0] - 1
    if g.device.type == "cpu":
        rows = _list_rows(off)
        return g.new_zeros((n, w), dtype=torch.float32).index_put_(
            (rows,), g[order[:rows.shape[0]].long()].to(torch.float32),
            accumulate=True)
    if g.dtype != torch.float32:
        raise TypeError(f"list_sum sums float32 rows, got {g.dtype}")
    if order.dtype != torch.int32 or off.dtype != torch.int32:
        raise TypeError(f"list_sum takes int32 order and off, got "
                        f"{order.dtype} and {off.dtype}")
    plan = _list_plan(e, n, w)
    if plan is None:
        raise ValueError(f"list_sum: the kernel takes fewer than 2^31 "
                         f"positions and rows, got {e} and {n}")
    g, order, off = g.contiguous(), order.contiguous(), off.contiguous()
    if n == 0 or w == 0 or e == 0:
        return g.new_zeros((n, w))
    out = g.new_empty((n, w))
    tails = torch.empty(plan.blocks, dtype=torch.int32, device=g.device)
    bpart = g.new_empty((plan.blocks, 2, w))
    fn = _build.entry("list_sum", "list_sum_f32",
                      [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _build.launch(fn, (g.data_ptr(), order.data_ptr(), off.data_ptr(),
                       out.data_ptr(), tails.data_ptr(), bpart.data_ptr(), e,
                       w, n, plan.tile, plan.share,
                       _copy_bytes(g, plan.tile)), g,
                  f"list_sum ({e} positions, {n} rows of {w})")
    list_sum.launches += 1
    return out


list_sum.launches = 0


class _GatherRowsListed(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx, order, off, dtype):
        i = idx.long()
        ctx.save_for_backward(i, order, off)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table.to(dtype)[i]

    @staticmethod
    def backward(ctx, g):
        i, order, off = ctx.saved_tensors
        shape = ctx.table_shape
        # bf16 cotangents are summed in float32 (a float64 one stays)
        flat = g.reshape(i.shape[0], -1).to(
            torch.promote_types(g.dtype, torch.float32))
        if g.device.type == "cpu":
            d_table = flat.new_zeros((shape[0], flat.shape[1])).index_put_(
                (i,), flat, accumulate=True)
        else:
            d_table = list_sum(flat.contiguous(), order, off)
        return (d_table.reshape(shape).to(ctx.table_dtype), None, None,
                None, None)


def gather_rows_listed(table: torch.Tensor, idx: torch.Tensor,
                       order: torch.Tensor | None, off: torch.Tensor | None,
                       dtype: torch.dtype | None = None) -> torch.Tensor:
    """``table.to(dtype)[idx]`` (``dtype`` None: the table's own) whose
    backward sums each table row's
    cotangents through a list given with the index: ``order`` lists the
    slots of ``idx`` row by row, ``off`` gives each row's first place in
    it (for the dense hop's ``tsrc``: `graph.kg.build_src_order` and the
    CSR's ``rowptr``).

    Forward: a plain gather (in bf16 the rows of the bf16 copy). Backward:
    the float32 cotangent (a bf16 one cast up), summed by `list_sum`, the
    kernel, on a CUDA device; on the CPU ``index_put_(accumulate=True)``
    over ``idx``, what autograd of the plain gather computes (a float64
    table, a CPU referee's, sums in float64). So in bf16 the table gets
    the float32 sum of the rows' bf16 cotangents, as `gather_bf16` gives
    it. A CUDA call without the list raises, and so does a float64 one
    (the kernel sums float32).

    table: (R, ...) float; idx: (E,) int in [0, R); order: (E,) int32, the
    stable argsort of ``idx``; off: (R + 1,) int32, the bincount of
    ``idx``'s scan. Returns (E,) + table.shape[1:] in ``dtype``."""
    if table.device.type != "cpu" and (order is None or off is None):
        raise ValueError("gather_rows_listed on a CUDA device needs the "
                         "index's list (order, off): build the graph with "
                         "DeviceGraph.from_csr, which sets tsrc_order")
    dtype = table.dtype if dtype is None else dtype
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherRowsListed.apply(table, idx, order, off, dtype)
    return table.to(dtype)[idx.long()]


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
