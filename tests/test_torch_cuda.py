"""Card tests of the port: the CUDA kernels (the sorted-segment sum and its
backward, the gather primitives' backwards: the range sum and the
small-table scatter-add; the hop's index kernels: the slot owner and the
dense hop's listed gather backward) against their plain versions, a small model and a
train step on the card against the CPU, and run-to-run determinism of
training.

These need an NVIDIA GPU and skip without one. They import neither JAX
nor the conftest fixtures, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph, StaticKG, build_csr
from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN
from redgnn_tpu_torch.ops.gather import range_sum
from redgnn_tpu_torch.ops.segment_sorted import (
    segment_sum_sorted,
    segment_sum_sorted_checked,
    segment_sum_sorted_reference,
)
from redgnn_tpu_torch.train.loop import StaticTrainer, softmax_ce_loss
from redgnn_tpu_torch.utils.config import TrainConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ids(rng, kind, e, n):
    if kind == "random":
        seg = rng.integers(0, n, e)
    elif kind == "skewed":  # one hub segment, many empty ones
        seg = np.where(rng.random(e) < 0.7, 7, rng.integers(0, n, e))
    else:  # "out_of_range": negative and past-the-end ids are dropped
        seg = rng.integers(-20, n + 50, e)
    return np.sort(seg).astype(np.int32)


@pytest.mark.parametrize("kind,e,d,n", [
    ("random", 5000, 48, 700), ("skewed", 4096, 48, 512),
    ("out_of_range", 3000, 33, 200), ("random", 0, 48, 10),
    ("random", 2000, 100, 3000),
])
@pytest.mark.parametrize("kmax", [None, 1])
def test_kernel_matches_plain(card, kind, e, d, n, kmax):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    s = torch.from_numpy(_ids(rng, kind, e, n)).to(card)
    before = segment_sum_sorted_checked.launches
    got, ovf = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=256,
                                          bn=64)
    torch.cuda.synchronize()
    assert segment_sum_sorted_checked.launches == before + 1
    want, want_ovf = segment_sum_sorted_reference(x, s, n, kmax=kmax,
                                                  chunk=256, bn=64)
    assert bool(ovf) == bool(want_ovf)
    # the plain version adds with atomics in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    # no atomics: the kernel gives the same bits run to run
    again, _ = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=256,
                                          bn=64)
    assert torch.equal(got, again)


def _boundary_ids(rng, kind, e, n):
    if kind == "spans_shares":
        # block 0 (segments 0-15 at this n): segment 3 holds hundreds of
        # edges across many workers' shares, its neighbours a few each;
        # block 1: segment 20 alone holds the block's whole edge range
        seg = np.concatenate([rng.integers(0, 16, e // 4), np.full(e // 2, 3),
                              np.full(e - e // 4 - e // 2, 20)])
    elif kind == "one_segment":  # every edge on one segment
        seg = np.full(e, n // 2)
    elif kind == "sparse":  # N >> E: mostly empty segments
        seg = rng.integers(0, n, e)
    elif kind == "all_out_of_range":
        seg = np.where(rng.random(e) < 0.5, rng.integers(-30, 0, e),
                       rng.integers(n, n + 30, e))
    else:  # "negative_first": negative ids, then in-range ones
        seg = np.concatenate([rng.integers(-30, 0, e // 3),
                              rng.integers(0, n, e - e // 3)])
    return np.sort(seg).astype(np.int32)


@pytest.mark.parametrize("kind,e,n", [
    ("spans_shares", 3000, 64), ("one_segment", 20000, 10),
    ("sparse", 500, 200_000), ("all_out_of_range", 2000, 300),
    ("negative_first", 3000, 700),
])
@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernel_boundaries(card, kind, e, n, d, misaligned):
    rng = np.random.default_rng(0)
    # multiples of 1/8 below 8: every partial sum of 20k of them is exact
    # in fp32, so any summation order gives the plain version's bits and
    # a difference can only be a wrong partition of the edges
    x = torch.from_numpy(
        (rng.integers(-64, 64, size=(e + 1, d)) / 8).astype(np.float32))
    x = x.to(card)
    # x[1:] starts 4*d bytes in: 16-byte aligned only when d % 4 == 0, so
    # the D = 48 case is shifted by one float to leave the vector path
    data = (x.view(-1)[1:1 + e * d].view(e, d) if misaligned and d % 4 == 0
            else x[1:] if misaligned else x[:e])
    s = torch.from_numpy(_boundary_ids(rng, kind, e, n)).to(card)
    got, _ = segment_sum_sorted_checked(data, s, n)
    want, _ = segment_sum_sorted_reference(data, s, n)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, segment_sum_sorted(data, s, n))


@pytest.mark.parametrize("kmax", [1, 2, 3])
@pytest.mark.parametrize("d", [48, 33])
def test_kernel_kmax_block_not_dividing(card, kmax, d):
    # bn = 24 segments per kmax block against the kernel's 16 per block
    rng = np.random.default_rng(2)
    e, n = 6000, 5000
    x = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    ids = np.sort(np.concatenate([rng.integers(0, 60, 3000),
                                  rng.integers(0, n + 40, e - 3000)]))
    s = torch.from_numpy(ids.astype(np.int32)).to(card)
    got, ovf = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=64, bn=24)
    want, want_ovf = segment_sum_sorted_reference(x, s, n, kmax=kmax,
                                                  chunk=64, bn=24)
    torch.cuda.synchronize()
    assert bool(ovf) == bool(want_ovf)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    again, _ = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=64,
                                          bn=24)
    assert torch.equal(got, again)


def _backward_pair(data, s, n, g):
    """(kernel's autograd.Function, plain version's autograd) gradients of
    sum(out * g) with respect to ``data``."""
    grads = []
    for fn in (segment_sum_sorted,
               lambda x, i, k: segment_sum_sorted_reference(x, i, k)[0]):
        x = data.clone().requires_grad_()
        before = segment_sum_sorted_checked.launches
        out = fn(x, s, n)
        launched = segment_sum_sorted_checked.launches - before
        assert launched == (1 if fn is segment_sum_sorted else 0)
        out.backward(g)
        grads.append(x.grad)
    torch.cuda.synchronize()
    return grads


def test_kernel_rejects_grad(card):
    """The kmax entry point stays forward only; the plain entry point is
    differentiable on the card (the test's name dates from when neither
    was)."""
    x = torch.ones(4, 2, device=card, requires_grad=True)
    s = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="forward only"):
        segment_sum_sorted_checked(x, s, 1)
    out = segment_sum_sorted(x, s, 1)
    assert out.requires_grad
    out.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    with torch.no_grad():  # no graph: the bare launch
        assert not segment_sum_sorted(x, s, 1).requires_grad


@pytest.mark.parametrize("e,d,n", [(2560, 48, 2048), (44032, 48, 8704),
                                   (170496, 48, 9984)])
def test_kernel_backward_hop_shapes(card, e, d, n):
    """Gradient through the kernel at the slice's hop shapes, padding ids
    past the end and a non-contiguous output gradient: a gather on both
    sides, so bit for bit."""
    rng = np.random.default_rng(3)
    n_valid = e * 4 // 5
    ids = np.concatenate([np.sort(rng.integers(0, n, n_valid)),
                          np.full(e - n_valid, n)]).astype(np.int32)
    data = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32))
    got, want = _backward_pair(data.to(card), torch.from_numpy(ids).to(card),
                               n, g.to(card).T)
    assert torch.equal(got, want)
    assert bool((got[n_valid:] == 0).all())


@pytest.mark.parametrize("kind,e,n", [
    ("spans_shares", 3000, 64), ("one_segment", 20000, 10),
    ("sparse", 500, 200_000), ("all_out_of_range", 2000, 300),
    ("negative_first", 3000, 700),
])
def test_kernel_backward_boundaries(card, kind, e, n):
    rng = np.random.default_rng(0)
    ids = _boundary_ids(rng, kind, e, n)
    data = torch.from_numpy(rng.normal(size=(e, 33)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 33)).astype(np.float32))
    got, want = _backward_pair(data.to(card), torch.from_numpy(ids).to(card),
                               n, g.to(card))
    assert torch.equal(got, want)
    dropped = torch.from_numpy((ids < 0) | (ids >= n))
    assert bool((got.cpu()[dropped] == 0).all())


@pytest.mark.parametrize("idx_shape", [(53504,), (20, 7)])
def test_take_rows_over_budget_backward(card, monkeypatch, idx_shape):
    """Over the one-hot budget the backward is a scatter-add through the
    kernel (`scatter_rows_add`, csrc/take_rows_grad.cu): the same gradient
    as the one-hot product (another summation order), and the same bits
    on a second run."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(5)
    r, d = 25, 48
    table = torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, r, idx_shape).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=idx_shape + (d,)).astype(np.float32))

    def grad():
        t = table.to(card).requires_grad_()
        (gather.take_rows(t, idx.to(card)) * w.to(card)).sum().backward()
        return t.grad

    onehot = grad()
    monkeypatch.setattr(gather, "_ONEHOT_BUDGET", 0)
    before = gather.scatter_rows_add.launches
    over, again = grad(), grad()
    assert gather.scatter_rows_add.launches == before + 2
    assert torch.equal(over, again)
    torch.testing.assert_close(over, onehot, rtol=1e-4,
                               atol=1e-5 * float(onehot.abs().max()))
    cpu = table.clone().requires_grad_()
    (cpu[idx.long()] * w).sum().backward()
    torch.testing.assert_close(over.cpu(), cpu.grad, rtol=1e-4,
                               atol=1e-5 * float(cpu.grad.abs().max()))


U = 2.0 ** -24


def _sum_bound(got, want, s_abs, m):
    """|got - want| <= 1e-5 |want| + 2 (m - 1) u sum|x| for sums of m
    float32 terms (``want`` and ``s_abs`` float64): the rounding bound of a
    recursive float32 sum in any order, against an exact one."""
    m = m.to(torch.float64)[:, None]
    bound = 1e-5 * want.abs() + 2 * torch.clamp(m - 1, min=0) * U * s_abs
    diff = (got.to(torch.float64) - want).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())


def _csr_ranges(rng, p, e, cap):
    """(start, count) of P ranges laid end to end from 0, Zipf lengths up
    to ``cap``, a tenth of them empty, cut at E."""
    deg = np.minimum(rng.zipf(1.6, p), cap)
    deg[rng.random(p) < 0.1] = 0
    deg = np.diff(np.minimum(np.cumsum(deg), e), prepend=0)
    return np.cumsum(deg) - deg, deg


def _range_sum_check(g, start, count):
    from redgnn_tpu_torch.ops import gather

    before = gather.range_sum.launches
    got = gather.range_sum(g, start, count)
    again = gather.range_sum(g, start, count)
    torch.cuda.synchronize()
    assert gather.range_sum.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = gather.range_sum_reference(g, start, count)
    s_abs = gather.range_sum_reference(g.abs(), start, count)
    e = g.shape[0]
    st, ct = start.long(), count.long()
    lo = torch.clamp(st, 0, e)
    m = torch.maximum(torch.clamp(st + torch.clamp(ct, min=0), max=e), lo) - lo
    _sum_bound(got, want, s_abs, m)
    # the kernel adds in the order its plain model repeats, bit for bit
    assert torch.equal(got, gather.range_sum_model(g, start, count))
    return got


@pytest.mark.parametrize("e,p", [(36_864, 3_000), (590_592, 42_000),
                                 (1_683_200, 120_000), (657_664, 45_568),
                                 (246_272, 6_400)])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_range_sum_kernel_hop_shapes(card, e, p, index_dtype):
    """The range-sum kernel at the forecasting model's hop shapes (E slots
    of D = 30; ranges laid end to end, the contiguous path) against the
    float64 range sum and its order's model, and the same bits on a second
    call."""
    rng = np.random.default_rng(7)
    start, count = _csr_ranges(rng, p, e, 2000)
    g = torch.from_numpy(rng.normal(size=(e, 30)).astype(np.float32))
    _range_sum_check(g.to(card), torch.from_numpy(start).to(card, index_dtype),
                     torch.from_numpy(count).to(card, index_dtype))


@pytest.mark.parametrize("d", [30, 33, 48, 20, 200])
@pytest.mark.parametrize("misaligned", [False, True])
def test_range_sum_kernel_contract_cases(card, d, misaligned):
    """Empty ranges, ranges cut by E, ranges at or past E, a hub of 10^5
    slots, at odd and vector widths, 16-byte aligned or not."""
    rng = np.random.default_rng(8)
    e = 300_000
    start = np.array([0, 5, 5, 100, 100_100, 250_000, 299_990, 310_000,
                      299_999, 0, 300_000], np.int64)
    count = np.array([5, 0, 95, 100_000, 10, 0, 50, 5, 1, 0, 3], np.int64)
    buf = torch.from_numpy(
        rng.normal(size=e * d + 1).astype(np.float32)).to(card)
    g = buf[1:].view(e, d) if misaligned else buf[:-1].view(e, d)
    got = _range_sum_check(g, torch.from_numpy(start).to(card),
                           torch.from_numpy(count).to(card))
    assert bool((got[[1, 5, 7, 9, 10]] == 0).all())
    # multiples of 1/8: every partial sum exact, so the bits of float64
    x = torch.from_numpy(
        (rng.integers(-64, 64, size=(e, d)) / 8).astype(np.float32)).to(card)
    from redgnn_tpu_torch.ops import gather

    st, ct = (torch.from_numpy(a).to(card) for a in (start, count))
    assert torch.equal(gather.range_sum(x, st, ct).double(),
                       gather.range_sum_reference(x, st, ct))


@pytest.mark.parametrize("kind", ["overlapping", "hub", "longer_than_grid"])
def test_range_sum_kernel_general_ranges(card, kind):
    """Ranges that are not laid end to end (unordered, overlapping, cut by
    E, past it, negative starts) at the forecasting model's first training
    call (E = 657,664, D = 30): the row-by-row path. A hub of 10^5 slots
    crosses 200 shares; ranges whose slots add up past E take wider shares
    on the device. Each against float64, its model, and twice."""
    rng = np.random.default_rng(13)
    e, d = 657_664, 30
    if kind == "overlapping":
        p = 45_568
        start = rng.integers(-100, e + 100, p)
        count = rng.integers(-5, 40, p)
    elif kind == "hub":
        start, count = _csr_ranges(rng, 45_568, e, 40)
        count[7] = 100_000
        start = np.cumsum(count) - count
    else:
        start = rng.integers(0, e // 2, 64)
        count = np.full(64, e // 2)
    g = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    got = _range_sum_check(g, torch.from_numpy(start).to(card),
                           torch.from_numpy(count).to(card))
    assert bool((got[torch.from_numpy((count <= 0) | (start >= e))] == 0)
                .all())


def test_gather_rows_packed_backward_launches_the_kernel(card):
    """Through autograd on the card, the packed gather's backward is the
    range-sum kernel: one launch, the float64 range sum's values."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(9)
    p, d = 5_000, 30
    start, count = _csr_ranges(rng, p, 10 ** 9, 300)
    e = int(count.sum()) + 100
    idx = np.concatenate([np.repeat(np.arange(p), count),
                          np.full(100, p - 1)]).astype(np.int32)
    vals = torch.from_numpy(rng.normal(size=(p, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    w[-100:] = 0  # the padded tail carries zero gradient
    v = vals.to(card).requires_grad_()
    st, ct = torch.from_numpy(start).to(card), torch.from_numpy(count).to(card)
    _, rows = gather.gather_rows_packed(
        torch.zeros(p, 1, dtype=torch.int32, device=card), v,
        torch.from_numpy(idx).to(card), st, ct)
    before = gather.range_sum.launches
    (rows * w).sum().backward()
    torch.cuda.synchronize()
    assert gather.range_sum.launches == before + 1
    m = torch.from_numpy(count).to(card)
    _sum_bound(v.grad, gather.range_sum_reference(w, st, ct),
               gather.range_sum_reference(w.abs(), st, ct), m)


# ------------------------------------------------ the hop's index kernels

def _owner_cum(rng, kind, p=110_336):
    """(cum, edge_cap): the inclusive degree cumsum of a P-node frontier
    (Zipf degrees, a tenth zero, SENTINEL pads at the end) and a slot
    capacity, by the contract's cases."""
    deg = np.minimum(rng.zipf(1.5, p), 3_000)
    deg[rng.random(p) < 0.1] = 0
    deg[-p // 8:] = 0  # pads
    if kind == "zero":
        deg[:] = 0
    elif kind == "hub":
        deg[17] = 200_000
    elif kind == "hubs":  # 1.7M slots, half of them in hubs past a block
        deg[rng.choice(p - p // 8, 20, replace=False)] = 40_000
    elif kind == "sparse_owners":  # spans past a block's stage
        deg[:] = 0
        deg[rng.choice(p, 40, replace=False)] = rng.integers(1, 5_000, 40)
    elif kind == "zero_runs":  # walks run out before and after the pads
        deg[:5_000] = 0
        deg[50_000:70_000] = 0
        deg[-p // 8 - 20_000:] = 0
    elif kind == "one_node":
        deg = np.array([5])
    total = int(deg.sum())
    cap = {"overflow": total // 3, "zero": 4_097,
           "odd": (total + 12_345) | 1, "one_node": 9}.get(kind,
                                                           total + 12_346)
    return torch.from_numpy(np.cumsum(deg).astype(np.int64)), cap


@pytest.mark.parametrize("kind", ["random", "zero", "hub", "hubs",
                                  "overflow", "odd", "sparse_owners",
                                  "zero_runs", "one_node"])
def test_slot_owner_kernel_matches_plain(card, kind):
    """The slot-owner kernel at a 7c served hop's size (110,336 nodes, ~1.7M
    slots; hubs past a block, total 0, edge_cap below total or odd, long
    runs of zero degrees before and after the pads, one node) against its
    plain twin (searchsorted), the scatter-and-cummax route and its
    partition's model (`slot_owner_runs`), bit for bit, one launch a call;
    and with no host sync."""
    from redgnn_tpu_torch.ops import frontier

    rng = np.random.default_rng(21)
    cum, cap = _owner_cum(rng, kind)
    cum = cum.to(card)
    before = frontier.slot_owner.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = frontier.slot_owner(cum, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert frontier.slot_owner.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (cap,)
    assert torch.equal(got, frontier.slot_owner_plain(cum, cap))
    assert torch.equal(got, frontier.slot_owner_cummax(cum, cap))
    assert torch.equal(got, frontier.slot_owner_runs(cum, cap)[0])
    assert frontier.slot_owner(cum, 0).shape == (0,)


def test_expansion_on_card_fills_owners_by_the_kernel(card):
    """expand_frontier on the card launches the slot-owner kernel once and
    gives the CPU's integers."""
    from redgnn_tpu_torch.ops import frontier

    rng = np.random.default_rng(22)
    n_ent = 300
    tri = np.stack([rng.integers(0, n_ent, 4_000), rng.integers(0, 8, 4_000),
                    rng.integers(0, n_ent, 4_000)], 1)
    rowptr, rel, tail = build_csr(tri, n_ent)
    keys = np.full(64, frontier.SENTINEL, np.int32)
    keys[:50] = np.sort(rng.choice(4 * n_ent, 50, replace=False))
    out = []
    for dev in ("cpu", card):
        before = frontier.slot_owner.launches
        fr = frontier.expand_frontier(
            *(torch.from_numpy(a).to(dev) for a in (rowptr, rel, tail)),
            n_ent, torch.from_numpy(keys).to(dev), edge_cap=2_048,
            node_cap=1_024, dedup_impl="bitmap", key_space=4 * n_ent)
        assert frontier.slot_owner.launches == before + (dev != "cpu")
        out.append(fr)
    for name in ("src", "dst", "edge_id", "edge_valid", "node_keys"):
        assert torch.equal(getattr(out[1], name).cpu(),
                           getattr(out[0], name)), name


def _list_case(rng, e, n, w, hub):
    """(order, off): E positions in N rows, a third of the rows empty and
    the first and last three too (where N allows), one hub of ``hub``
    positions, a random permutation as the list."""
    live = np.flatnonzero(rng.random(n) < 0.67)
    if n > 12:
        live = live[(live >= 3) & (live < n - 3)]
    cnt = np.bincount(rng.choice(live, e - hub), minlength=n)
    cnt[n // 2] += hub
    off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    return (torch.from_numpy(rng.permutation(e).astype(np.int32)),
            torch.from_numpy(off))


@pytest.mark.parametrize("e,n,w,hub", [(152_780, 7_128, 672, 9_000),
                                       (7_959, 135, 980, 2_000),
                                       (10_567, 135, 980, 2_000),
                                       (40_000, 3_000, 20, 30_000),
                                       (40_000, 3_000, 33, 0),
                                       (6_000, 300, 2_450, 1_000),
                                       (3, 2, 672, 0)])
@pytest.mark.parametrize("shift", [0, 1, 2])
def test_list_sum_kernel_matches_model(card, e, n, w, hub, shift):
    """The list-sum kernel at the dense hops' lists and widths (7a: 152,780
    edges into 7,128 rows of 672; umls: 7,959 and 10,567 into 135 rows of
    980), odd and narrow widths (33, 20) and one past a block's tile
    (2,450: three tiles), a hub longer than a share, a third of the rows
    empty and empty rows at both ends; g 16-byte aligned (bulk copies) or
    shifted by one or two floats (4- and 8-byte pieces): within the
    rounding bound of float64, bit-equal to `list_sum_model` and on a
    second call, one launch a call, its row counters left at 0."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(23)
    order, off = _list_case(rng, e, n, w, hub)
    buf = torch.from_numpy(
        rng.normal(size=e * w + 2).astype(np.float32)).to(card)
    g = buf[shift:shift + e * w].view(e, w)
    order, off = order.to(card), off.to(card)
    before = gather.list_sum.launches
    got = gather.list_sum(g, order, off)
    again = gather.list_sum(g, order, off)
    torch.cuda.synchronize()
    assert gather.list_sum.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert torch.equal(got, gather.list_sum_model(g, order, off))
    m = torch.diff(off.long())
    _sum_bound(got, gather.list_sum_reference(g, order, off),
               gather.list_sum_reference(g.abs(), order, off), m)
    assert bool((got[m == 0] == 0).all())
    for bufs in gather._LIST_COUNTS.values():
        assert all(int(b.abs().sum()) == 0 for b in bufs)


def test_list_sum_kernel_in_a_cuda_graph(card):
    """The list-sum kernel captured in a CUDA graph and replayed (its row
    counters persist between launches): each replay gives the eager
    call's bits."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(24)
    order, off = (t.to(card) for t in _list_case(rng, 7_959, 135, 980,
                                                 2_000))
    g = torch.from_numpy(rng.normal(size=(7_959, 980)).astype(
        np.float32)).to(card)
    want = gather.list_sum(g, order, off)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather.list_sum(g, order, off)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gather.list_sum(g, order, off)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_hop_backward_launches_list_sum(card, dtype):
    """RelAttnLayer.dense on the card takes the state's gradient through
    the dense hop's backward kernel and the list-sum kernel (one launch
    each a backward), in float32 and bf16; the dense states' gradient lies
    within rtol 1e-4 + 1e-5·max of the CPU's (bf16: 2e-2·max, as the bf16
    step's gradients are held, since a float32 difference upstream may
    flip a bf16 rounding). Without the graph's list it raises."""
    from redgnn_tpu_torch.models.layers import RelAttnLayer
    from redgnn_tpu_torch.ops import dense_hop as dh
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(24)
    n_ent, b, d = 60, 5, 16
    tri = np.stack([rng.integers(0, n_ent, 900), rng.integers(0, 8, 900),
                    rng.integers(0, n_ent, 900)], 1)
    csr = build_csr(tri, n_ent)
    vis = torch.from_numpy(rng.random((n_ent, b)) < 0.5)
    hd = torch.from_numpy(rng.normal(size=(n_ent, b, d)).astype(np.float32))
    q_rel = torch.from_numpy(rng.integers(0, 8, b).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(n_ent, b, d)).astype(np.float32))
    layer = RelAttnLayer(d, 5, 4, compute_dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    grads = []
    for dev in ("cpu", card):
        g = DeviceGraph.from_csr(*csr, n_ent, device=dev)
        lay = layer.to(dev)
        h = hd.to(dev, copy=True).requires_grad_()
        before = gather.list_sum.launches, dh.dense_hop_static_bwd.launches
        out, _, _ = lay.dense(h, vis.to(dev), q_rel.to(dev), g.tsrc, g.trel,
                              g.ttail, g.tail_rowptr, "sorted_scatter",
                              g.tsrc_order, g.rowptr, g.tail_items)
        (out * w.to(dev)).sum().backward()
        torch.cuda.synchronize()
        assert (gather.list_sum.launches,
                dh.dense_hop_static_bwd.launches) == tuple(
                    x + (dev != "cpu") for x in before)
        grads.append(h.grad.cpu())
        if dev != "cpu":
            with pytest.raises(ValueError, match="tsrc_order"):
                lay.dense(h, vis.to(dev), q_rel.to(dev), g.tsrc, g.trel,
                          g.ttail, g.tail_rowptr)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4,
                               atol=tol * float(grads[0].abs().max()))


@pytest.mark.parametrize("r", [16, 32, 462, 475])
@pytest.mark.parametrize("d", [20, 30, 48])
def test_scatter_kernel_tables(card, r, d):
    """The scatter-add kernel at the relation tables (462, 475 rows) and
    batch tables (16, 32) of the paths, random and sorted ids, int32 and
    int64, against a float64 index_add_; the same bits on a second call."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(10)
    assert gather._scatter_plan(200_000, r, d) is not None
    for e, sort, index_dtype in ((200_000, False, torch.int64),
                                 (70_001, True, torch.int32)):
        ids = rng.integers(0, r, e)
        ids = np.sort(ids) if sort else ids
        idx = torch.from_numpy(ids).to(card, index_dtype)
        g = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
        g = g.to(card)
        before = gather.scatter_rows_add.launches
        got = gather.scatter_rows_add(g, idx, r)
        again = gather.scatter_rows_add(g, idx, r)
        torch.cuda.synchronize()
        assert gather.scatter_rows_add.launches == before + 2
        assert torch.equal(got, again)
        want = torch.zeros(r, d, dtype=torch.float64, device=card).index_add_(
            0, idx.long(), g.double())
        s_abs = torch.zeros(r, d, dtype=torch.float64,
                            device=card).index_add_(0, idx.long(),
                                                    g.abs().double())
        _sum_bound(got, want, s_abs, torch.bincount(idx.long(), minlength=r))
        assert torch.equal(got, gather.scatter_rows_add_model(g, idx, r))


def _scatter_ids(rng, kind, e, r):
    if kind == "one_row":
        return np.full(e, r // 2)
    if kind == "sorted_batch":
        return np.sort(rng.integers(0, r, e))
    if kind == "dropped":
        return rng.integers(-50, r + 50, e)
    # "skewed": one relation holds 70% of the ids, as at a training hop
    return np.where(rng.random(e) < 0.7, 17, rng.integers(0, r, e))


@pytest.mark.parametrize("kind,r", [("skewed", 462), ("one_row", 462),
                                    ("sorted_batch", 32), ("one_row", 1),
                                    ("dropped", 462)])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_scatter_kernel_contract_cases(card, kind, r, index_dtype):
    """At the forecasting model's first training call (E = 657,664, D =
    30): skewed ids, all ids on one row, sorted batch ids, R = 1, ids
    outside [0, R) dropped. The kernel's sorted list is the stable sort of
    the valid ids (torch.sort(stable=True)); the sums hold to float64
    within the bound, equal their order's model and a second call; the
    counter moves by the calls made."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(14)
    e, d = 657_664, 30
    ids = torch.from_numpy(_scatter_ids(rng, kind, e, r)).to(card,
                                                            index_dtype)
    g = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    plan = gather._scatter_plan(e, r, d)
    before = gather.scatter_rows_add.launches
    got, srt = gather._scatter_launch(g, ids, r, plan)
    again = gather.scatter_rows_add(g, ids, r)
    torch.cuda.synchronize()
    assert gather.scatter_rows_add.launches == before + 2
    assert torch.equal(got, again)
    i = ids.long()
    ok = (i >= 0) & (i < r)
    slots = torch.nonzero(ok).squeeze(1)
    keys, order = torch.sort(i[slots], stable=True)
    n_ok = int(ok.sum())
    assert torch.equal(srt[:n_ok, 0].long(), slots[order])
    assert torch.equal(srt[:n_ok, 1].long(), keys)
    want = torch.zeros(r, d, dtype=torch.float64, device=card).index_add_(
        0, i[ok], g[ok].double())
    s_abs = torch.zeros_like(want).index_add_(0, i[ok], g[ok].abs().double())
    _sum_bound(got, want, s_abs, torch.bincount(i[ok], minlength=r))
    assert torch.equal(got, gather.scatter_rows_add_model(g, ids, r))


def test_scatter_kernel_column_tiles(card):
    """A table wider than a tile (1000 x 200) takes 128-column tiles over
    the grid's second dimension."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(11)
    r, d, e = 1000, 200, 100_000
    assert gather._scatter_plan(e, r, d).tile == 128
    idx = torch.from_numpy(rng.integers(0, r, e)).to(card)
    # multiples of 1/8: every order of summation gives the same bits
    g = torch.from_numpy(
        (rng.integers(-64, 64, size=(e, d)) / 8).astype(np.float32)).to(card)
    got = gather.scatter_rows_add(g, idx, r)
    want = torch.zeros(r, d, device=card).index_add_(0, idx, g)
    assert torch.equal(got, want)
    assert torch.equal(gather.scatter_rows_add(g[:0], idx[:0], r),
                       torch.zeros(r, d, device=card))


def test_scatter_routes_large_tables_to_index_put(card):
    """A table of more rows than the kernel's count tables take (the rule
    of `_scatter_plan`) takes index_put_: no launch, its values."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(12)
    r, d, e = 5_000, 48, 50_000
    assert gather._scatter_plan(e, r, d) is None
    idx = torch.from_numpy(rng.integers(0, r, e)).to(card)
    g = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    before = gather.scatter_rows_add.launches
    got = gather.scatter_rows_add(g, idx, r)
    assert gather.scatter_rows_add.launches == before
    assert torch.equal(got, torch.zeros(r, d, device=card).index_put_(
        (idx,), g, accumulate=True))


def _write_kg(path, rng, n_ent=40, n_rel=4):
    """A small KG in the reference's file format (a composition rule plus
    noise), split 60/25/10/5."""
    p1, p0 = rng.permutation(n_ent), rng.permutation(n_ent)
    tri = []
    for i in range(n_ent):
        tri += [(i, 1, p1[i]), (p1[i], 0, p0[p1[i]]), (i, 2, p0[p1[i]]),
                (i, 3, rng.integers(n_ent))]
    tri = [tri[i] for i in rng.permutation(len(tri))]
    n = len(tri)
    cuts = {"facts.txt": (0, int(n * .6)), "train.txt": (int(n * .6),
            int(n * .85)), "valid.txt": (int(n * .85), int(n * .95)),
            "test.txt": (int(n * .95), n)}
    (path / "entities.txt").write_text(
        "".join(f"e{i}\n" for i in range(n_ent)))
    (path / "relations.txt").write_text(
        "".join(f"r{i}\n" for i in range(n_rel)))
    for name, (lo, hi) in cuts.items():
        (path / name).write_text(
            "".join(f"e{h}\tr{r}\te{t}\n" for h, r, t in tri[lo:hi]))
    return str(path)


TRAIN = dict(hidden_dim=16, attn_dim=5, n_layer=3, lr=0.01, lamb=1e-4,
             n_batch=8, n_tbatch=8, segment_impl="pallas", dense_hops=False,
             scan_chunk=2)


def test_train_step_on_card_matches_cpu(card, tmp_path):
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**TRAIN, dropout=0.0)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        b = cfg.n_batch
        batch = torch.as_tensor(tr.kg.train_data[:b], dtype=torch.int32,
                                device=dev)
        qmask = torch.ones(b, dtype=torch.bool, device=dev)
        scores, aux = tr.model(tr.kg.graph, batch[:, 0], batch[:, 1], qmask,
                               tr.train_caps)
        loss = softmax_ce_loss(scores, batch[:, 2], qmask)
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        before = segment_sum_sorted_checked.launches
        step_loss, overflow, num_edges = tr._train_step(
            batch[:, 0], batch[:, 1], batch[:, 2], qmask, tr.train_caps)
        launched = segment_sum_sorted_checked.launches - before
        assert launched == (cfg.n_layer if dev == "cuda" else 0)
        out[dev] = (loss.item(), [g.cpu() for g in grads], step_loss.item(),
                    bool(overflow), num_edges.cpu(), tr._flat.cpu())
    c, g = out["cpu"], out["cuda"]
    assert g[0] == pytest.approx(c[0], rel=1e-5)
    assert g[2] == pytest.approx(c[2], rel=1e-5)
    for a, b_ in zip(g[1], c[1]):
        torch.testing.assert_close(a, b_, rtol=1e-4,
                                   atol=1e-5 * float(b_.abs().max()))
    assert g[3] == c[3] is False and torch.equal(g[4], c[4])
    # one Adam step moves every weight by about lr whatever the gradient's
    # size, so a gradient's rounding shows up scaled by lr / |grad|
    torch.testing.assert_close(g[5], c[5], rtol=0, atol=1e-3)


def test_training_on_card_is_deterministic(card, tmp_path):
    """Two identical runs of 4 steps (2 chunks, dropout on) end at the
    same bits: no float atomics on the training path."""
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**TRAIN, dropout=0.2)
    ends = []
    for _ in range(2):
        kg = StaticKG.load(d, device="cuda")
        kg.train_data = kg.train_data[:4 * cfg.n_batch]
        tr = StaticTrainer(kg, cfg)
        loss = tr.train_epoch(0)
        assert int(tr.opt_state["count"]) == 4 and tr.host_syncs == 2
        ends.append((loss, tr._flat.clone(), tr.opt_state["nu"].clone()))
    assert ends[0][0] == ends[1][0]
    assert torch.equal(ends[0][1], ends[1][1])
    assert torch.equal(ends[0][2], ends[1][2])


def test_model_on_card_matches_cpu(card):
    rng = np.random.default_rng(1)
    n_ent, n_rel, b = 30, 4, 4
    tri = np.stack([rng.integers(0, n_ent, 120), rng.integers(0, 2 * n_rel, 120),
                    rng.integers(0, n_ent, 120)], 1)
    ents = np.arange(n_ent)
    tri = np.concatenate(
        [tri, np.stack([ents, np.full(n_ent, 2 * n_rel), ents], 1)])
    csr = build_csr(tri, n_ent)
    cfg = ModelConfig(n_ent=n_ent, n_rel=n_rel, hidden_dim=16, attn_dim=5,
                      n_layer=3, segment_impl="pallas", dense_hops=False)
    caps = FrontierCaps((b, 256, 256, 256), (1024, 1024, 1024))
    subs = torch.from_numpy(rng.integers(0, n_ent, b).astype(np.int32))
    rels = torch.from_numpy(rng.integers(0, 2 * n_rel, b).astype(np.int32))
    qmask = torch.tensor([True, True, True, False])
    out = {}
    for dev in ("cpu", card):
        model = RedGNN(cfg, device=dev)
        before = segment_sum_sorted_checked.launches
        with torch.inference_mode():
            out[str(dev)] = model(DeviceGraph.from_csr(*csr, n_ent, device=dev),
                                  subs.to(dev), rels.to(dev), qmask.to(dev),
                                  caps)
        launched = segment_sum_sorted_checked.launches - before
        assert launched == (3 if str(dev) == "cuda" else 0)
    (s_cpu, aux_cpu), (s_gpu, aux_gpu) = out["cpu"], out["cuda"]
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, rtol=0, atol=1e-5)
    for k in aux_cpu:
        assert torch.equal(aux_gpu[k].cpu(), aux_cpu[k]), k


@pytest.mark.parametrize("settings", [
    dict(segment_impl="pallas", dense_hops=False),
    dict(segment_impl="xla", dedup_impl="auto", dense_hops=True,
         dense_switch=0.4)], ids=["kernel_sort", "defaults_dense"])
def test_bf16_train_step_on_card_matches_cpu(card, tmp_path, settings):
    """compute_dtype='bfloat16' on the card against the CPU: scores of one
    batch within 1e-3 of the row's largest |score|, one step's loss rtol
    1e-4 and gradients within 2e-2 of each parameter's largest (the
    bounds of tests/test_torch_bf16.py); the kernel launched once a sort
    hop, the dense hops' backward kernel where they run, and the card's
    bf16 scores within 5e-2 of its float32 ones."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    d = _write_kg(tmp_path, np.random.default_rng(0))
    out = {}
    for dev, dtype in (("cpu", "bfloat16"), ("cuda", "bfloat16"),
                       ("cuda", "float32")):
        cfg = TrainConfig(**dict(TRAIN, **settings), dropout=0.0,
                          compute_dtype=dtype)
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        b = cfg.n_batch
        batch = torch.as_tensor(tr.kg.train_data[:b], dtype=torch.int32,
                                device=dev)
        qmask = torch.ones(b, dtype=torch.bool, device=dev)
        before = segment_sum_sorted_checked.launches
        bwd = dh.dense_hop_static_bwd.launches
        scores, _ = tr.model(tr.kg.graph, batch[:, 0], batch[:, 1], qmask,
                             tr.train_caps)
        launched = segment_sum_sorted_checked.launches - before
        loss = softmax_ce_loss(scores, batch[:, 2], qmask)
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        # the dense hops' gradients through the backward kernel
        assert (dh.dense_hop_static_bwd.launches > bwd) == (
            dev == "cuda" and settings["dense_hops"])
        out[dev, dtype] = (scores.detach().cpu(), loss.item(),
                           [g.cpu() for g in grads], launched)
    (s_c, l_c, g_c, n_c), (s_g, l_g, g_g, n_g) = (
        out["cpu", "bfloat16"], out["cuda", "bfloat16"])
    assert n_c == 0 and n_g == (TRAIN["n_layer"] if settings["segment_impl"]
                                == "pallas" else 0)
    scale = s_c.abs().amax(1, keepdim=True)
    assert bool(((s_g - s_c).abs() <= 1e-3 * scale).all())
    assert l_g == pytest.approx(l_c, rel=1e-4)
    for a, b_ in zip(g_g, g_c):
        assert float((a - b_).abs().max()) <= 2e-2 * float(b_.abs().max())
    torch.testing.assert_close(s_g, out["cuda", "float32"][0], rtol=5e-2,
                               atol=5e-2)


# ------------------------------------------------- dense-hop shapes, defaults

def _dense_ids(rng, e, n, kind):
    """Ascending tail ids of a small, dense KG's edge table."""
    if kind == "every_segment":
        ids = np.concatenate([np.arange(n), rng.integers(0, n, e - n)])
    else:  # "empty_segments": every third segment has no edge
        ids = rng.integers(0, n, e)
        ids[ids % 3 == 1] += 1
        ids = np.minimum(ids, n - 1)
    return np.sort(ids).astype(np.int32)


@pytest.mark.parametrize("d", [960, 2400, 20, 50])
@pytest.mark.parametrize("kind", ["every_segment", "empty_segments"])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernel_dense_hop_shapes(card, d, kind, misaligned):
    """Few segments (135) and wide rows (b*d = 960 or 2400 messages, b = 20
    or 50 live counts), as a dense hop sums them: forward against the
    plain version, same bits twice, backward bit for bit."""
    from redgnn_tpu_torch.ops.segment_sorted import _launch_plan

    rng = np.random.default_rng(4)
    e, n = 10_567, 135
    buf = torch.from_numpy(
        rng.normal(size=e * d + 1).astype(np.float32)).to(card)
    data = buf[1:].view(e, d) if misaligned else buf[:-1].view(e, d)
    s = torch.from_numpy(_dense_ids(rng, e, n, kind)).to(card)
    plan = _launch_plan(n, d, data.data_ptr())
    assert plan.vec == (d % 4 == 0 and not misaligned)
    got = segment_sum_sorted(data, s, n)
    want = segment_sum_sorted_reference(data, s, n)[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, segment_sum_sorted(data, s, n))
    if kind == "empty_segments":
        assert bool((got[1::3][:-1] == 0).all())
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card)
    g_kernel, g_plain = _backward_pair(data, s, n, g)
    assert torch.equal(g_kernel, g_plain)


def test_kernel_column_blocks_cover_wide_rows(card):
    """More column passes than blocks to spread them over: a block then
    walks several passes (the kernel source gives N = 2000 125 segment
    blocks and room for 4 column blocks; D = 1000 needs 11 passes)."""
    rng = np.random.default_rng(6)
    e, d, n = 3000, 1000, 2000
    x = torch.from_numpy(
        (rng.integers(-64, 64, size=(e, d)) / 8).astype(np.float32)).to(card)
    s = torch.from_numpy(np.sort(rng.integers(0, n, e)).astype(np.int32))
    got = segment_sum_sorted(x, s.to(card), n)
    # multiples of 1/8: every order of summation gives the same bits
    assert torch.equal(got, segment_sum_sorted_reference(x, s.to(card), n)[0])


DEFAULTS = dict(hidden_dim=16, attn_dim=5, n_layer=3, lr=0.01, lamb=1e-4,
                n_batch=8, n_tbatch=8, scan_chunk=2, dense_switch=0.4)


@pytest.mark.parametrize("segment_impl", ["xla", "pallas"])
@pytest.mark.parametrize("scan_src_backward", [True, False])
def test_registry_default_step_on_card_matches_cpu(card, tmp_path,
                                                   segment_impl,
                                                   scan_src_backward):
    """dedup 'auto' and dense hops (sparse hops bitmap under 'xla', sort
    under 'pallas', then a dense hop): loss, aux and gradients of one step
    on the card against the CPU. With scan_src_backward the packed
    gather's backward is the range-sum kernel on the card and a prefix-sum
    difference on the CPU, whose noise (O(total * eps)) gets the looser
    bound."""
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**DEFAULTS, dropout=0.0, segment_impl=segment_impl,
                      scan_src_backward=scan_src_backward)
    assert cfg.dedup_impl == "auto" and cfg.dense_hops
    out = {}
    for dev in ("cpu", "cuda"):
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        b = cfg.n_batch
        # hops: 256 and 512 edges sparse, 1024 >= 0.4 * 8 * 232 dense
        assert tr.train_caps.edge_caps == (256, 512, 1024)
        batch = torch.as_tensor(tr.kg.train_data[:b], dtype=torch.int32,
                                device=dev)
        qmask = torch.ones(b, dtype=torch.bool, device=dev)
        before = segment_sum_sorted_checked.launches
        scores, aux = tr.model(tr.kg.graph, batch[:, 0], batch[:, 1], qmask,
                               tr.train_caps)
        launched = segment_sum_sorted_checked.launches - before
        # 2 sparse hops through the kernel; the dense hop takes the dense
        # hop kernels, gradients on or off
        assert launched == (2 if (dev, segment_impl) == ("cuda", "pallas")
                            else 0)
        loss = softmax_ce_loss(scores, batch[:, 2], qmask)
        before = range_sum.launches
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        # the second sparse hop (bitmap under 'xla') differentiates
        # hidden[src] through the range-sum kernel on the card
        assert (range_sum.launches - before > 0) == (
            dev == "cuda" and scan_src_backward and segment_impl == "xla")
        out[dev] = (loss.item(), [g.cpu() for g in grads],
                    {k: v.cpu() for k, v in aux.items()})
    c, g = out["cpu"], out["cuda"]
    assert g[0] == pytest.approx(c[0], rel=1e-5)
    for k in c[2]:
        assert torch.equal(g[2][k], c[2][k]), k
    rtol, atol = (1e-3, 1e-4) if scan_src_backward else (1e-4, 1e-5)
    for a, b_ in zip(g[1], c[1]):
        torch.testing.assert_close(a, b_, rtol=rtol,
                                   atol=atol * float(b_.abs().max()))


def test_registry_default_eval_on_card_matches_cpu(card, tmp_path):
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**DEFAULTS, dropout=0.0)
    metrics = {}
    for dev in ("cpu", "cuda"):
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        metrics[dev] = tr.evaluate("valid")
    assert metrics["cuda"]["n"] == metrics["cpu"]["n"] > 0
    for k in ("mrr", "h1", "h3", "h10"):
        assert metrics["cuda"][k] == pytest.approx(metrics["cpu"][k],
                                                   rel=1e-4), k


def _temporal_dir(tmp_path, rng, n_ent=40, n_rel=3, n=400):
    """A tiny id-based temporal dir (5-column quadruples, day stamps)."""
    d = tmp_path / "toy_temporal"
    d.mkdir()
    (d / "entity2id.txt").write_text(
        "".join(f"e{i}\t{i}\n" for i in range(n_ent)))
    (d / "relation2id.txt").write_text(
        "".join(f"r{i}\t{i}\n" for i in range(n_rel)))
    q = np.stack([rng.integers(0, n_ent, n), rng.integers(0, n_rel, n),
                  rng.integers(0, n_ent, n), rng.integers(0, 30, n)], 1)
    for name, part in zip(("train", "valid", "test"),
                          np.split(q, [int(n * 0.8), int(n * 0.9)])):
        (d / f"{name}.txt").write_text(
            "".join(f"{a}\t{b}\t{c}\t{t}\t0\n" for a, b, c, t in part))
    return str(d)


@pytest.mark.parametrize("mode", ["interpolation", "extrapolation"])
def test_temporal_kernel_path_on_card_matches_cpu(card, tmp_path, mode):
    """TRedGNN with sort dedup and the kernel (a sparse hop, then dense
    hops in interpolation; windowed sparse hops in extrapolation) on the
    card against the CPU: scores, aux and every parameter's gradient; the
    kernel launches once per sparse hop and twice per dense hop.

    The gradients are held to a float64 referee: the same step on the CPU
    with the same weights in float64 (float64 as the default dtype, as
    chip_smoke.py's reference_scores computes it; plain sums and plain
    gathers, which change no value). Card and CPU float32 both lie off it
    by the rounding of sums taken in other orders, and a gradient that
    cancels to ~1e-8 (terms near 1) differs between them by more than a
    tolerance on its own size; so each parameter's card error may be at
    most twice the CPU's own error plus 1e-6 of its largest float64
    gradient. A parameter whose float64 gradient is zero (to 1e-12 of the
    step's largest: the classifier's bias, whose gradient is a sum of
    softmax residues that cancel exactly) has no size of its own: both
    float32 values are rounding residue, and its 1e-6 is taken of the
    step's largest float64 gradient."""
    import dataclasses

    from redgnn_tpu_torch.graph.temporal import TemporalKG
    from redgnn_tpu_torch.models.temporal import (
        TemporalModelConfig,
        TRedGNN,
        temporal_hop_plan,
    )
    from redgnn_tpu_torch.ops import dense_hop as dh
    from redgnn_tpu_torch.train.temporal_loop import (
        exact_caps,
        nll_softmax_loss,
    )
    from redgnn_tpu_torch.utils.config import TemporalTrainConfig

    path = _temporal_dir(tmp_path, np.random.default_rng(0))
    ex = mode == "extrapolation"
    tcfg = TemporalTrainConfig(mode=mode, window=6 if ex else None,
                               n_layer=3, hidden_dim=12, batch_size=8)
    kgs = {dev: TemporalKG.load_id_dir(path, graph_from_all_splits=ex,
                                       device=dev) for dev in ("cpu", "cuda")}
    kg = kgs["cpu"]
    cfg = TemporalModelConfig(
        n_ent=kg.n_ent, n_rel_vocab=kg.n_rel + 1, idd_rel=kg.idd_rel,
        hidden_dim=12, attn_dim=5, n_layer=3, dropout=0.0, mode=mode,
        window=tcfg.window, time_key_base=kg.time_key_base,
        dedup_impl="sort", segment_impl="pallas", dense_switch=0.3)
    quads = kg.splits["train"][:8]
    caps = exact_caps(kg, tcfg, quads, 8)
    plan = temporal_hop_plan(cfg, kg.graph.n_edges, caps, 8, True)
    # the sparse hops; a dense hop takes the dense hop kernels, forward
    # and backward
    launches = len(plan) - plan.count("dense")
    if not ex:
        assert plan[0] == "sort" and "dense" in plan, plan
    out = {}

    def step(model, dev):
        g = kgs[dev]
        b = [torch.as_tensor(quads[:, j].astype(np.int32), device=dev)
             for j in range(4)]
        qmask = torch.ones(8, dtype=torch.bool, device=dev)
        graph, etime, ekey, sl, trp, dense = g.model_args()
        scores, aux = model(graph, etime, b[0], b[1], b[3], qmask, caps,
                            None, False, ekey, sl, trp, dense)
        nll_softmax_loss(scores, b[2], qmask).backward()
        return scores, aux

    weights = None
    for dev in ("cpu", "cuda"):
        model = TRedGNN(cfg, device=dev)
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        before = segment_sum_sorted_checked.launches
        bwd = dh.dense_hop_temporal_bwd.launches
        scores, aux = step(model, dev)
        if dev == "cuda":
            assert segment_sum_sorted_checked.launches - before == launches
            assert dh.dense_hop_temporal_bwd.launches - bwd == \
                plan.count("dense")
        out[dev] = (scores.detach().cpu(),
                    {k: v.cpu() for k, v in aux.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
    (s_c, a_c, g_c), (s_g, a_g, g_g) = out["cpu"], out["cuda"]
    torch.testing.assert_close(s_g, s_c, rtol=1e-5, atol=1e-5)
    for k in ("num_nodes", "num_edges", "edge_overflow", "node_overflow"):
        assert torch.equal(a_g[k], a_c[k]), k
    assert g_g.keys() == g_c.keys()
    ref = TRedGNN(dataclasses.replace(cfg, segment_impl="xla",
                                      scan_src_backward=False,
                                      mxu_gather_backward=False),
                  device="cpu").double()
    ref.load_state_dict({k: v.double() for k, v in weights.items()})
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        step(ref, "cpu")
    finally:
        torch.set_default_dtype(default)
    g_ref = {n: p.grad for n, p in ref.named_parameters()
             if p.grad is not None}
    assert g_ref.keys() == g_c.keys()
    step_scale = max(float(v.abs().max()) for v in g_ref.values())
    for n in g_c:
        want = g_ref[n]
        assert want.dtype == torch.float64, n
        err_card = float((g_g[n].double() - want).abs().max())
        err_cpu = float((g_c[n].double() - want).abs().max())
        scale = float(want.abs().max())
        if scale <= 1e-12 * step_scale:  # an exact zero: no size of its own
            scale = step_scale
        bound = 2.0 * err_cpu + 1e-6 * scale
        assert err_card <= bound, (n, err_card, err_cpu, bound)


def test_edge_parallel_step_on_card_matches_single_process(card):
    """Two ranks on cuda:0 through gloo (NCCL refuses a GPU twice), mesh
    1x2: each rank sums its slice of every hop's edges through the kernel
    and the ranks all-reduce the aggregates; the summed gradient and the
    loss equal the single-process step on the card."""
    from redgnn_tpu_torch.parallel.launch import run_mesh

    import torch_mesh_workers as W

    rng = np.random.default_rng(0)
    n_ent, n_rel, b = 40, 4, 8
    tri = np.stack([rng.integers(0, n_ent, 300),
                    rng.integers(0, 2 * n_rel, 300),
                    rng.integers(0, n_ent, 300)], 1)
    ents = np.arange(n_ent)
    tri = np.concatenate([tri, np.stack([ents, np.full(n_ent, 2 * n_rel),
                                         ents], 1)])
    arrays = [a.astype(np.int32) for a in build_csr(tri, n_ent)]
    batch = [rng.integers(0, n_ent, b).astype(np.int32),
             rng.integers(0, 2 * n_rel, b).astype(np.int32),
             rng.integers(0, n_ent, b).astype(np.int32), np.ones(b, bool)]
    cfg_kw = dict(n_ent=n_ent, n_rel=n_rel, hidden_dim=16, attn_dim=5,
                  n_layer=3, dropout=0.0, segment_impl="pallas",
                  dense_hops=False)
    caps = FrontierCaps((b, 512, 512, 512), (2048, 2048, 2048))
    model = RedGNN(ModelConfig(**dict(cfg_kw, mxu_gather_backward=False)),
                   device="cuda")
    graph = DeviceGraph(*(torch.as_tensor(a, device="cuda") for a in arrays))
    subs, rels, objs, qmask = (torch.as_tensor(a, device="cuda")
                               for a in batch)
    scores, aux = model(graph, subs, rels, qmask.bool(), caps)
    assert not bool(aux["edge_overflow"].any() | aux["node_overflow"].any())
    loss = softmax_ce_loss(scores, objs, qmask.bool())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = run_mesh(W.grad_probe, 1, 2, ["cuda:0"] * 2, backend="gloo",
                   args=(arrays, cfg_kw, params, batch, caps), timeout=300)
    for o in out:
        assert not o["overflow"]
        assert o["loss"] == pytest.approx(loss.item(), rel=1e-5)
        for (name, _), g in zip(model.named_parameters(), grads):
            want = g.cpu()
            torch.testing.assert_close(
                o["grads"][name], want, rtol=1e-4,
                atol=1e-5 * float(want.abs().max()), msg=name)


# ------------------------------------------ the dense hop's forward kernels

def _dense_table(rng, n, e, hub, dev):
    """(tsrc, ttail, tail_rowptr) int32 of a tail-sorted table of ``e``
    edges over ``n`` entities; ``hub``: a quarter of them into one tail
    (hundreds of chunks of the kernel's walk), the rest random (empty
    tails among them); "zipf": tails drawn by Zipf(1) over the entities
    (a few hubs split into many items, many short tails)."""
    if hub == "zipf":
        p = 1.0 / np.arange(1, n + 1)
        tail = rng.choice(n, e, p=p / p.sum())
    else:
        tail = rng.integers(0, n, e)
    if hub is True:
        tail[: e // 4] = min(3, n - 1)
    src = rng.integers(0, n, e)
    order = np.argsort(tail, kind="stable")
    tail, src = tail[order], src[order]
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(tail, minlength=n), out=rowptr[1:])
    return [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (src, tail, rowptr)]


def _f64(x):
    """A float32 input as float64 for the referee (bf16 tables stay bf16:
    the referee promotes their rows as the kernel does)."""
    return x.double() if torch.is_tensor(x) and x.dtype == torch.float32 \
        else x


def _dense_bound(got, want, s_abs, ttail, n, plain):
    """|got - want| <= (1e-5 + 2 (m - 1) u) sum|x| + 2 |plain - want| per
    (tail, query, channel), m the tail's edges: the terms' own float32
    rounding (relative 1e-5 of each term), a recursive float32 sum of m
    terms in any order, against float64, and twice the plain float32
    version's own error (a term that is itself a sum, the transform's or
    the attention's, carries cancellation that both float32 routes
    share)."""
    m = torch.bincount(ttail.long(), minlength=n).to(torch.float64)
    bound = (1e-5 + 2 * torch.clamp(m - 1, min=0)[:, None, None] * U) \
        * s_abs + 2 * (plain.to(torch.float64) - want).abs()
    diff = (got.to(torch.float64) - want).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())


def _segment64(x, ttail, n):
    return torch.zeros((n,) + x.shape[1:], dtype=torch.float64,
                       device=x.device).index_add_(0, ttail.long(), x)


DENSE_STATIC_CASES = [
    # (N, b, d, A, E, hub, visited share): umls's served dense call; odd
    # widths; a hub over hundreds of chunks at the widest width; an empty
    # table; b = 64 (two query groups), A = 64
    (135, 50, 48, 5, 10_600, False, 0.5), (40, 7, 13, 3, 700, True, 0.5),
    (300, 33, 61, 9, 9_000, True, 0.5), (64, 32, 8, 1, 0, False, 0.5),
    (500, 64, 64, 64, 20_000, True, 0.5),
    # umls-shaped with Zipf tails, ~25% and all pairs kept (a second query
    # group of 18); state rows of b * d odd floats (no 16-byte blocks);
    # chunks no lane keeps an edge of; a Zipf hub over many items at 64
    (135, 50, 48, 5, 10_567, "zipf", 0.25),
    (135, 50, 48, 5, 10_567, "zipf", 1.0), (61, 9, 21, 5, 3_000, False, 0.5),
    (200, 5, 20, 30, 8_000, "zipf", 0.02),
    (300, 20, 64, 5, 60_000, "zipf", 0.5)]


def _static_hop_inputs(card, case, dtype):
    """`dense_hop_static`'s inputs (but its plan) for a case of
    DENSE_STATIC_CASES, seeded by its width."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    n, b, d, a, e, hub, share = case
    rng = np.random.default_rng(d)
    tsrc, ttail, rowptr = _dense_table(rng, n, e, hub, card)
    r = 20
    vis = torch.from_numpy(rng.random((n, b)) < share).to(card)
    g = torch.Generator(device=card).manual_seed(d)
    rand = lambda *s: torch.randn(*s, generator=g, device=card)  # noqa: E731
    inp = dict(hidden=(rand(n, b, d) * vis[..., None]).to(dtype),
               visited=vis, rela=rand(r, d).to(dtype), tsrc=tsrc,
               trel=torch.from_numpy(rng.integers(0, r, e).astype(
                   np.int32)).to(card), ttail=ttail, tail_rowptr=rowptr)
    q_rel = torch.from_numpy(rng.integers(0, r, b)).to(card)
    ws, wr_w, wq_w = (rand(a, d) * 0.3 for _ in range(3))
    wr, wq = dh.static_terms(inp["rela"], q_rel, wr_w, wq_w, rand(a))
    inp.update(wr=wr, wq=wq, ws=ws, w_alpha=rand(a), b_alpha=rand(1))
    return inp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DENSE_STATIC_CASES)
def test_dense_hop_static_kernel(card, case, dtype):
    """csrc/dense_hop_static.cu against a float64 referee on its own
    inputs (`_dense_bound`); new visited set and live count equal to the
    plain version's; the same bits on a second call; both launches
    counted."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    inp = _static_hop_inputs(card, case, dtype)
    n, ttail = inp["hidden"].shape[0], inp["ttail"]
    before = dh.dense_hop_static.launches
    plan = dict(dense_agg="sorted_scatter",
                item_ptr=dh.tail_items(inp["tail_rowptr"]))
    got = dh.dense_hop_static(**inp, **plan)
    again = dh.dense_hop_static(**inp, **plan)
    torch.cuda.synchronize()
    assert dh.dense_hop_static.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    plain = dh.dense_hop_static_plain(**inp)
    assert torch.equal(got[1], plain[1]) and int(got[2]) == int(plain[2])
    ref = {k: _f64(v) for k, v in inp.items()}
    msg, _ = dh.static_messages(*(ref[k] for k in (
        "hidden", "visited", "rela", "tsrc", "trel", "wr", "wq", "ws",
        "w_alpha", "b_alpha")))
    _dense_bound(got[0], _segment64(msg, ttail, n),
                 _segment64(msg.abs(), ttail, n), ttail, n, plain[0])


DENSE_TEMPORAL_CASES = {
    # name: (N, b, d, A, E, hub, use_time, attention, linear, masks, act,
    #        visited share)
    "icews14": (7_128, 32, 20, 30, 152_780, False, True, True, True, False,
                "idd", 0.5),
    "icews14_hub_loo": (7_128, 32, 20, 30, 152_780, True, True, True, True,
                        True, "leakyrelu", 0.5),
    "wo_time": (300, 37, 12, 5, 6_000, True, False, True, True, True,
                "idd", 0.5),
    "wo_attention": (200, 5, 8, 0, 3_000, False, True, False, True, False,
                     "tanh", 0.5),
    "bias": (200, 40, 30, 30, 9_000, True, True, True, False, True,
             "sigmoid", 0.5),
    "bias_wo_both": (100, 64, 16, 0, 4_000, True, False, False, False,
                     False, "softplus", 0.5),
    "relu_w32": (400, 33, 32, 64, 8_000, False, True, True, True, True,
                 "relu", 0.5),
    # the widths of the interpolation search (hidden_dim 48) and the
    # widest, whose transforms need 74 KB of shared memory at A = 64
    "w48": (300, 32, 48, 40, 9_000, True, True, True, True, True,
            "leakyrelu", 0.5),
    "w48_bias": (300, 20, 48, 40, 9_000, False, True, True, False, False,
                 "tanh", 0.5),
    "w64": (250, 40, 64, 64, 8_000, True, True, True, True, True, "relu",
            0.5),
    "w61_wo_time": (200, 9, 61, 7, 5_000, False, False, True, True, False,
                    "idd", 0.5),
    "empty": (50, 3, 20, 30, 0, False, True, True, True, False, "idd", 0.5),
    # ICEWS14-sized with Zipf tails, ~25% and all pairs kept; state rows
    # of b * d odd floats and a second query group of 9; chunks no lane
    # keeps an edge of (bias form); Zipf hubs over many items at 48 and 64
    "icews14_zipf_sparse": (7_128, 32, 20, 30, 152_780, "zipf", True, True,
                            True, False, "idd", 0.25),
    "icews14_zipf_full": (7_128, 32, 20, 30, 152_780, "zipf", True, True,
                          True, False, "leakyrelu", 1.0),
    "odd_rows": (61, 41, 21, 7, 3_000, False, True, True, True, True,
                 "relu", 0.5),
    "no_lane_keeps": (200, 5, 20, 30, 8_000, "zipf", True, True, False,
                      False, "tanh", 0.02),
    "w48_zipf": (300, 20, 48, 40, 60_000, "zipf", True, True, True, True,
                 "leakyrelu", 0.5),
    "w64_zipf_full": (250, 40, 64, 64, 20_000, "zipf", True, True, True,
                      False, "relu", 1.0),
}


def _temporal_hop_inputs(card, case):
    """`dense_hop_temporal`'s inputs (but its plan) for a case of
    DENSE_TEMPORAL_CASES, seeded by its batch."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    n, b, d, a, e, hub, use_time, attn, linear, masks, act, share = \
        DENSE_TEMPORAL_CASES[case]
    rng = np.random.default_rng(b)
    tsrc, ttail, rowptr = _dense_table(rng, n, e, hub, card)
    r, t_ids = 50, 365
    g = torch.Generator(device=card).manual_seed(b)
    rand = lambda *s: torch.randn(*s, generator=g, device=card)  # noqa: E731
    ints = lambda hi, *s: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi, s).astype(np.int32)).to(card)
    vis = torch.from_numpy(rng.random((n, b)) < share).to(card)
    rela, a1 = rand(r, d), rand(3 * d, a) * 0.3
    times = ints(t_ids, b)
    ra, qa, tt = dh.temporal_terms(
        rela, a1, ints(r, b), times, t_ids,
        rand(48) * 0.01 if use_time else None, rand(96, d) * 0.1,
        rand(d) * 0.1, use_attention=attn)
    keep = lambda *s: torch.from_numpy(  # noqa: E731
        rng.random(s) < 0.9).to(card) if masks else None
    return dict(hidden=rand(n, b, d) * vis[..., None], visited=vis,
                rela=rela, tsrc=tsrc, trel=ints(r, e), ttime=ints(t_ids, e),
                ttail=ttail, tail_rowptr=rowptr, times=times,
                excl_keep=keep(e), edge_keep=keep(e, b), tt=tt, ra=ra,
                qa=qa, a1s=a1[:d], a2=rand(a, 1) * 0.3,
                wdir=rand(3, d, d) * 0.3 if linear else None,
                bdir=None if linear else rand(3, d), drop_keep=keep(n, b, d),
                dropout=0.1, act=act)


@pytest.mark.parametrize("case", list(DENSE_TEMPORAL_CASES))
def test_dense_hop_temporal_kernel(card, case):
    """csrc/dense_hop_temporal.cu against a float64 referee on its own
    inputs: the sum within `_dense_bound` before the epilogue, which each
    activation passes on at most 1-Lipschitz (dropout scales it by
    1 / (1 - p)); new visited set and both counts equal to the plain
    version's; the same bits on a second call; both launches counted.
    ``masks``: the leave-one-out, edge-dropout and dropout masks."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    inp = _temporal_hop_inputs(card, case)
    n, ttail, masks = inp["hidden"].shape[0], inp["ttail"], \
        DENSE_TEMPORAL_CASES[case][9]
    p = inp["dropout"]
    before = dh.dense_hop_temporal.launches
    plan = dict(dense_agg="sorted_scatter",
                item_ptr=dh.tail_items(inp["tail_rowptr"]))
    got = dh.dense_hop_temporal(**inp, **plan)
    again = dh.dense_hop_temporal(**inp, **plan)
    torch.cuda.synchronize()
    assert dh.dense_hop_temporal.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    plain = dh.dense_hop_temporal_plain(**inp)
    assert torch.equal(got[1], plain[1])
    assert (int(got[2]), int(got[3])) == (int(plain[2]), int(plain[3]))
    ref = {k: _f64(v) for k, v in inp.items()}
    msg, _ = dh.temporal_messages(*(ref[k] for k in (
        "hidden", "visited", "rela", "tsrc", "trel", "ttime", "times",
        "excl_keep", "edge_keep", "tt", "ra", "qa", "a1s", "a2", "wdir",
        "bdir")))
    s_abs = _segment64(msg.abs(), ttail, n) / (1 - p if masks else 1)
    want = dh.dense_hop_temporal_plain(**ref)[0]
    _dense_bound(got[0], want, s_abs + 4 * U * want.abs(), ttail, n,
                 plain[0])


# ----------------------------------------- the dense hop's backward kernels

def _lists(tsrc, ttime, n, n_time):
    """The graph's lists the backward sums by: (tsrc_order, the sources'
    row offsets, time_order, time_off)."""
    from redgnn_tpu_torch.graph.kg import build_src_order, build_time_order

    dev = tsrc.device
    src = tsrc.cpu().numpy()
    off = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=n), out=off[1:])
    lists = [build_src_order(src), off]
    if ttime is not None:
        lists += build_time_order(ttime.cpu().numpy(), n_time)
    return [torch.from_numpy(x).to(dev) for x in lists]


def _bwd_check(kind, plain_args, got, m):
    """The backward kernel's gradients ``got`` against the float64 plain
    backward on the same inputs within `bwd_bound` (the float32 plain
    backward's own error allowed twice, and the whole of every attention
    term whose relu mask float32 may flip; the parameters' sums at the
    kernel's chain of additions, ``m``, and at their scale). Returns the
    bound's share."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    plain = getattr(dh, f"dense_hop_{kind}_bwd_plain")
    want32 = plain(**plain_args)
    ref = {k: _f64(v) for k, v in plain_args.items()}
    want = plain(**ref)
    s_abs = plain(**ref, absolute=True)
    kinks = plain(**ref, kinks=True)
    shares = dh.bwd_shares(got, want, s_abs, m, want32, kinks)
    share = max(x for x in shares if x is not None)
    assert share <= 1.0, shares
    return share


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DENSE_STATIC_CASES)
def test_dense_hop_static_bwd_kernel(card, case, dtype):
    """csrc/dense_hop_static_bwd.cu (and the list and scatter sums it
    feeds) at every forward case: each gradient against the float64 plain
    backward on the same inputs within `bwd_bound` (bf16 tables: the
    referee promotes the same bf16 rows); the same bits on a second call;
    both launches counted."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    inp = _static_hop_inputs(card, case, dtype)
    n, b, d = inp["hidden"].shape
    g = torch.randn(n, b, d, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    order, off = _lists(inp["tsrc"], None, n, None)
    args = dict(g=g, **inp)
    before = dh.dense_hop_static_bwd.launches
    kw = dict(item_ptr=dh.tail_items(inp["tail_rowptr"]), tsrc_order=order,
              rowptr=off)
    got = dh.dense_hop_static_bwd(**args, **kw)
    again = dh.dense_hop_static_bwd(**args, **kw)
    torch.cuda.synchronize()
    assert dh.dense_hop_static_bwd.launches == before + 2 * (
        inp["tsrc"].shape[0] > 0)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    del args["tail_rowptr"]
    m = dh.bwd_term_counts("static", inp["tsrc"], inp["trel"], None, b, n,
                           inp["rela"].shape[0], None,
                           dh.dense_hop_static_bwd.plan)
    _bwd_check("static", args, got, m)


@pytest.mark.parametrize("case", list(DENSE_TEMPORAL_CASES))
def test_dense_hop_temporal_bwd_kernel(card, case):
    """csrc/dense_hop_temporal_bwd.cu (and the list and scatter sums it
    feeds) at every forward case (ICEWS14's sizes, every ablation, b > 32,
    widths 48 and 64): each gradient against the float64 plain backward
    on the same inputs (h the forward kernel's output) within
    `bwd_bound`; the same bits on a second call; both launches
    counted."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    inp = _temporal_hop_inputs(card, case)
    n, b, d = inp["hidden"].shape
    plan = dict(dense_agg="sorted_scatter",
                item_ptr=dh.tail_items(inp["tail_rowptr"]))
    h, new_visited, _, _ = dh.dense_hop_temporal(**inp, **plan)
    g_h = torch.randn(n, b, d, device=card,
                      generator=torch.Generator(device=card).manual_seed(2))
    n_time = 365
    order, off, t_order, t_off = _lists(inp["tsrc"], inp["ttime"], n,
                                        n_time)
    args = dict(g_h=g_h, h=h, new_visited=new_visited, **inp)
    kw = dict(item_ptr=plan["item_ptr"], tsrc_order=order, rowptr=off,
              time_order=t_order, time_off=t_off)
    before = dh.dense_hop_temporal_bwd.launches
    got = dh.dense_hop_temporal_bwd(**args, **kw)
    again = dh.dense_hop_temporal_bwd(**args, **kw)
    torch.cuda.synchronize()
    assert dh.dense_hop_temporal_bwd.launches == before + 2 * (
        inp["tsrc"].shape[0] > 0)
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))
    del args["tail_rowptr"]
    m = dh.bwd_term_counts("temporal", inp["tsrc"], inp["trel"],
                           inp["ttime"], b, n, inp["rela"].shape[0], n_time,
                           dh.dense_hop_temporal_bwd.plan)
    _bwd_check("temporal", args, got, m)


def test_dense_hop_kernels_refuse_before_launching(card):
    """A width, dtype or layout the kernels do not take raises ValueError
    and launches nothing."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    rng = np.random.default_rng(3)
    tsrc, ttail, rowptr = _dense_table(rng, 30, 200, False, card)
    vis = torch.ones(30, 4, dtype=torch.bool, device=card)
    z = lambda *s, **k: torch.zeros(*s, device=card, **k)  # noqa: E731
    trel = torch.zeros_like(tsrc)
    plan = dict(dense_agg="sorted_scatter", item_ptr=dh.tail_items(rowptr))
    static = dict(visited=vis, tsrc=tsrc, trel=trel, ttail=ttail,
                  tail_rowptr=rowptr, wq=z(4, 5), w_alpha=z(5), b_alpha=z(1),
                  **plan)
    before = dh.dense_hop_static.launches, dh.dense_hop_temporal.launches
    for d, dtype, match in ((65, torch.float32, "width 65"),
                            (16, torch.float64, "float32 or bfloat16")):
        with pytest.raises(ValueError, match=match):
            dh.dense_hop_static(hidden=z(30, 4, d, dtype=dtype),
                                rela=z(3, d, dtype=dtype), wr=z(3, 5),
                                ws=z(5, d), **static)
    with pytest.raises(ValueError, match="contiguous"):
        dh.dense_hop_static(hidden=z(4, 30, 16).transpose(0, 1),
                            rela=z(3, 16), wr=z(3, 5), ws=z(5, 16), **static)
    with pytest.raises(ValueError, match="width 65"):
        dh.dense_hop_temporal(
            z(30, 4, 65), vis, z(3, 65), tsrc, trel, trel, ttail, rowptr,
            z(4, dtype=torch.int32), None, None, None, None, None, None,
            None, None, z(3, 65), None, 0.0, "relu", **plan)
    with pytest.raises(ValueError, match="item_ptr"):
        dh.dense_hop_static(hidden=z(30, 4, 16), rela=z(3, 16), wr=z(3, 5),
                            ws=z(5, 16), **dict(static, item_ptr=None))
    assert (dh.dense_hop_static.launches,
            dh.dense_hop_temporal.launches) == before


def _write_temporal(path, rng, n_ent=30, n_rel=3, n_time=20, n=300):
    """Name-based TSV quadruples (with inverses), split 80/10/10."""
    rows = []
    for _ in range(n):
        h, r, t = rng.integers(0, n_ent, 3)
        r, tau = r % n_rel, rng.integers(1, n_time)
        rows += [(f"e{h}", f"r{r}", f"e{t}", f"2014-{tau:02d}"),
                 (f"e{t}", f"~r{r}", f"e{h}", f"2014-{tau:02d}")]
    rows = [rows[i] for i in rng.permutation(len(rows))]
    cut = (int(len(rows) * 0.8), int(len(rows) * 0.9))
    for name, part in (("train.txt", rows[:cut[0]]),
                       ("valid.txt", rows[cut[0]:cut[1]]),
                       ("test.txt", rows[cut[1]:])):
        (path / name).write_text("".join("\t".join(x) + "\n" for x in part))
    return str(path)


@pytest.mark.parametrize("transform", ["linear", "bias"])
@pytest.mark.parametrize("hidden_dim", [16, 20, 32, 48, 64])
def test_temporal_evaluation_at_search_widths(card, tmp_path, hidden_dim,
                                              transform):
    """Interpolation evaluation (gradients off) at every hidden width of
    the interpolation search (`utils/hpo.py:INTERPOLATION_SPACE`, attention
    width 40) and the widest the kernels take: its dense hops launch the
    temporal kernel, and the metrics equal the CPU's (the loss within
    1e-5; a rank metric by at most one query's tie-level swap, 1 / n)."""
    from redgnn_tpu_torch.graph.temporal import TemporalKG
    from redgnn_tpu_torch.ops import dense_hop as dh
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer
    from redgnn_tpu_torch.utils.config import TemporalTrainConfig
    from redgnn_tpu_torch.utils.hpo import INTERPOLATION_SPACE

    assert hidden_dim in INTERPOLATION_SPACE["hidden_dim"].options \
        or hidden_dim == dh.MAX_WIDTH
    d = _write_temporal(tmp_path, np.random.default_rng(hidden_dim))
    cfg = TemporalTrainConfig(hidden_dim=hidden_dim, attn_dim=40, n_layer=3,
                              dropout=0.0, batch_size=16, eval_batch_size=16,
                              dense_switch=0.2, act="leakyrelu",
                              direction_transform=transform)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = TemporalTrainer(TemporalKG.load_vocab_dir(d, device=dev), cfg)
        before = dh.dense_hop_temporal.launches
        out[dev] = tr.evaluate("valid")
        launched = dh.dense_hop_temporal.launches - before
        assert (launched > 0) == (dev == "cuda"), (dev, launched)
    c, g = out["cpu"], out["cuda"]
    assert g["n"] == c["n"] > 0
    assert g["loss"] == pytest.approx(c["loss"], rel=1e-5)
    for k in ("mrr", "h1", "h3", "h10"):
        assert abs(g[k] - c[k]) <= 1.0 / c["n"] + 1e-9, (k, g[k], c[k])


@pytest.mark.parametrize("hidden_dim", [48, 64])
def test_temporal_train_step_at_search_widths(card, tmp_path, hidden_dim):
    """One interpolation train step's gradients (dropout off, leave-one-out
    on) at the interpolation search's widest hidden width and the widest
    the kernels take, attention width 40: its dense hops launch both
    dense hop kernels, and every gradient lies within rtol 1e-4 +
    1e-5·max of the CPU's (the plain versions), the loss within 1e-5."""
    from redgnn_tpu_torch.graph.temporal import TemporalKG
    from redgnn_tpu_torch.models.temporal import (
        TemporalModelConfig,
        TRedGNN,
        temporal_hop_plan,
    )
    from redgnn_tpu_torch.ops import dense_hop as dh
    from redgnn_tpu_torch.train.temporal_loop import (
        exact_caps,
        nll_softmax_loss,
    )
    from redgnn_tpu_torch.utils.config import TemporalTrainConfig

    d = _write_temporal(tmp_path, np.random.default_rng(hidden_dim))
    kgs = {dev: TemporalKG.load_vocab_dir(d, device=dev)
           for dev in ("cpu", "cuda")}
    kg = kgs["cpu"]
    cfg = TemporalModelConfig(
        n_ent=kg.n_ent, n_rel_vocab=kg.n_rel + 1, idd_rel=kg.idd_rel,
        hidden_dim=hidden_dim, attn_dim=40, n_layer=3, dropout=0.0,
        time_key_base=kg.time_key_base, dense_switch=0.2)
    quads = kg.splits["train"][:16]
    caps = exact_caps(kg, TemporalTrainConfig(hidden_dim=hidden_dim,
                                              n_layer=3, batch_size=16),
                      quads, 16)
    plan = temporal_hop_plan(cfg, kg.graph.n_edges, caps, 16, True)
    assert plan[0] != "dense" and "dense" in plan, plan
    out, weights = {}, None
    for dev in ("cpu", "cuda"):
        g = kgs[dev]
        model = TRedGNN(cfg, device=dev)
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        b = [torch.as_tensor(quads[:, j].astype(np.int32), device=dev)
             for j in range(4)]
        qmask = torch.ones(16, dtype=torch.bool, device=dev)
        graph, etime, ekey, sl, trp, dense = g.model_args()
        excl = torch.as_tensor(g.exclusion_slots(np.arange(16)),
                               device=dev)
        before = (dh.dense_hop_temporal.launches,
                  dh.dense_hop_temporal_bwd.launches)
        scores, _ = model(graph, etime, b[0], b[1], b[3], qmask, caps, excl,
                          False, ekey, sl, trp, dense)
        loss = nll_softmax_loss(scores, b[2], qmask)
        loss.backward()
        torch.cuda.synchronize()
        launched = (dh.dense_hop_temporal.launches - before[0],
                    dh.dense_hop_temporal_bwd.launches - before[1])
        assert (min(launched) > 0) == (dev == "cuda"), launched
        out[dev] = (loss.item(), {n: p.grad.cpu() for n, p in
                                  model.named_parameters()
                                  if p.grad is not None})
    (l_c, g_c), (l_g, g_g) = out["cpu"], out["cuda"]
    assert l_g == pytest.approx(l_c, rel=1e-5)
    assert g_g.keys() == g_c.keys()
    for name, want in g_c.items():
        torch.testing.assert_close(g_g[name], want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)


def test_model_dense_hops_launch_the_kernels(card):
    """With gradients off every dense hop of RedGNN.forward launches the
    static kernel (float32 and bf16) and the scores match the CPU's plain
    route; with gradients on each launches it again, and its backward
    kernel once."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    rng = np.random.default_rng(5)
    n_ent, n_rel, b = 30, 4, 4
    tri = np.stack([rng.integers(0, n_ent, 200),
                    rng.integers(0, 2 * n_rel, 200),
                    rng.integers(0, n_ent, 200)], 1)
    csr = build_csr(tri, n_ent)
    caps = FrontierCaps((b, 256, 256, 256), (64, 1024, 1024))
    subs = torch.from_numpy(rng.integers(0, n_ent, b).astype(np.int32))
    rels = torch.from_numpy(rng.integers(0, 2 * n_rel, b).astype(np.int32))
    qmask = torch.tensor([True, True, True, False])
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(n_ent=n_ent, n_rel=n_rel, hidden_dim=16,
                          attn_dim=5, n_layer=3, dense_hops=True,
                          dense_switch=0.3, dedup_impl="auto",
                          compute_dtype=dtype)
        scores = {}
        for dev in ("cpu", card):
            model = RedGNN(cfg, device=dev)
            g = DeviceGraph.from_csr(*csr, n_ent, device=dev)
            args = (g, subs.to(dev), rels.to(dev), qmask.to(dev), caps)
            before = dh.dense_hop_static.launches
            with torch.no_grad():
                scores[str(dev)], _ = model(*args)
            launched = dh.dense_hop_static.launches - before
            assert launched == (2 if str(dev) == "cuda" else 0), launched
        bwd = dh.dense_hop_static_bwd.launches
        model(*args)[0].sum().backward()
        assert dh.dense_hop_static.launches - before == 4
        assert dh.dense_hop_static_bwd.launches - bwd == 2
        tol = 1e-5 if dtype == "float32" else 1e-3
        torch.testing.assert_close(
            scores["cuda"].cpu(), scores["cpu"], rtol=0,
            atol=tol * float(scores["cpu"].abs().max()))
