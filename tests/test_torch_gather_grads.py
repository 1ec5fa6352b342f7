"""The backwards of the port's gather primitives (ops/gather.py) against
the JAX package, on the CPU.

`range_sum` is the backward of ``gather_rows_packed``: on a CUDA device a
hand-written kernel, held on the card to `range_sum_reference` (float64,
no prefix cancellation); on the CPU the JAX package's prefix-sum
difference (`range_sum_scan`). `scatter_rows_add` is the backward of
``take_rows`` above the one-hot budget: on a CUDA device a hand-written
kernel for every table `_scatter_plan` admits, on the CPU ``index_put_``.
Here both wrappers take their plain versions (the kernels have no CPU
mode; tests/test_torch_cuda.py holds them on the card), so the launch
counters must not move.

Tolerances: the JAX gradient is a difference of two float32 prefix sums
over E rows, each off its exact value by at most E * u * sum|g| (u =
2^-24, recursive summation), so the float64 range sum lies within
2 * E * u * sum|g| of it, column by column. On inputs that are multiples
of 1/8 every partial sum is exact in float32, so there the two agree
bit for bit. The CPU path against JAX: GRAD_TOL, as
tests/test_torch_gather.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redgnn_tpu.ops import gather as jg
from redgnn_tpu_torch.ops import gather as tg

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
U = 2.0 ** -24


def ranges(rng, kind):
    """(start, count, E) of one of the contract's layouts."""
    if kind == "hub":  # one range of 10^5 slots between short ones
        count = np.array([3, 0, 100_000, 5, 0, 2], np.int64)
        start = np.cumsum(count) - count
        return start, count, int(count.sum()) + 4
    count = rng.integers(0, 9, size=40)
    count[[3, 11, 12]] = 0  # empty ranges
    start = np.cumsum(count) - count
    total = int(count.sum())
    if kind == "csr":  # ranges tile [0, total), a padded tail after them
        return start, count, total + 7
    if kind == "clipped":  # the last ranges cut by E
        return start, count, total - 10
    # "past_end": ranges that start at or past E (count > 0), one that
    # straddles it
    e = int(start[30]) + 2
    return start, count, e


def jax_range_grad(g, start, count):
    """d_values of JAX `gather_rows_packed` at cotangent ``g`` (its
    `_gp_bwd`): the forward's rows do not enter the gradient."""
    p = start.shape[0]
    meta = jnp.zeros((p, 1), jnp.int32)
    idx = jnp.zeros((g.shape[0],), jnp.int32)
    _, vjp = jax.vjp(
        lambda v: jg.gather_rows_packed(meta, v, idx,
                                        jnp.asarray(start, jnp.int32),
                                        jnp.asarray(count, jnp.int32))[1],
        jnp.zeros((p, g.shape[1]), jnp.float32))
    return np.asarray(vjp(jnp.asarray(g))[0])


def gradient(rng, e, d, dyadic):
    if dyadic:  # multiples of 1/8 below 8: every partial sum exact
        return (rng.integers(-64, 64, size=(e, d)) / 8).astype(np.float32)
    return rng.normal(size=(e, d)).astype(np.float32)


KINDS = ["csr", "clipped", "past_end", "hub"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dyadic", [False, True], ids=["normal", "dyadic"])
def test_range_sum_reference_matches_jax(rng, kind, index_dtype, dyadic):
    start, count, e = ranges(rng, kind)
    d = 3 if kind == "hub" else 5
    g = gradient(rng, e, d, dyadic)
    want = jax_range_grad(g, start, count)
    got = tg.range_sum_reference(torch.from_numpy(g),
                                 torch.from_numpy(start.astype(index_dtype)),
                                 torch.from_numpy(count.astype(index_dtype)))
    assert got.dtype == torch.float64 and got.shape == (len(start), d)
    got = got.numpy()
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        bound = 2 * e * U * np.abs(g).sum(0)
        assert np.all(np.abs(got - want) <= bound), (
            np.abs(got - want).max(), bound)
    # the contract's zeros: empty ranges, ranges at or past E
    assert np.all(got[(count == 0) | (start >= e)] == 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_range_sum_cpu_path_matches_jax(rng, kind, index_dtype):
    """On the CPU `range_sum` is the JAX package's prefix-sum difference:
    held to the JAX gradient within GRAD_TOL (exactly, on dyadic
    inputs), bit-equal to `range_sum_scan`, and no kernel launch. At the
    hub's 10^5 slots the two prefix sums (XLA's and PyTorch's, in other
    orders) carry more noise than GRAD_TOL: there each lies within
    2 * E * u * sum|g| of the exact sum, so they within twice that."""
    start, count, e = ranges(rng, kind)
    d = 3 if kind == "hub" else 5
    before = tg.range_sum.launches
    for dyadic in (False, True):
        g = gradient(rng, e, d, dyadic)
        want = jax_range_grad(g, start, count)
        args = (torch.from_numpy(g),
                torch.from_numpy(start.astype(index_dtype)),
                torch.from_numpy(count.astype(index_dtype)))
        got = tg.range_sum(*args)
        assert got.dtype == torch.float32
        assert torch.equal(got, tg.range_sum_scan(*args))
        if dyadic:
            np.testing.assert_array_equal(got.numpy(), want)
        elif kind == "hub":
            bound = 4 * e * U * np.abs(g).sum(0)
            assert np.all(np.abs(got.numpy() - want) <= bound)
        else:
            np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    assert tg.range_sum.launches == before


def test_range_sum_reference_matches_a_loop(rng):
    """The yardstick itself, against a Python loop, on ranges the frontier
    never makes (unordered, overlapping, negative starts)."""
    e, d, p = 50, 4, 30
    g = rng.normal(size=(e, d)).astype(np.float32)
    start = rng.integers(-10, 60, size=p)
    count = rng.integers(-3, 25, size=p)
    want = np.zeros((p, d))
    for v in range(p):
        for s in range(start[v], start[v] + max(count[v], 0)):
            if 0 <= s < e:
                want[v] += g[s].astype(np.float64)
    got = tg.range_sum_reference(torch.from_numpy(g), torch.from_numpy(start),
                                 torch.from_numpy(count))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_range_sum_rejects_bad_shapes():
    g = torch.zeros(5, 2)
    for fn in (tg.range_sum, tg.range_sum_scan, tg.range_sum_reference):
        with pytest.raises(ValueError, match="range sum"):
            fn(g, torch.zeros(3, dtype=torch.int64),
               torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("rows,idx_shape", [(16, (600,)), (462, (40, 9)),
                                            (50, (1000,))])
def test_take_rows_over_budget_matches_jax_segment_sum(rng, monkeypatch,
                                                       rows, idx_shape):
    """At ``_ONEHOT_BUDGET = 0`` both packages take their scatter branch:
    the port's `scatter_rows_add` (on the CPU ``index_put_``) against
    JAX's ``jax.ops.segment_sum``, and both against the one-hot product."""
    d = 7
    table = rng.normal(size=(rows, d)).astype(np.float32)
    idx = rng.integers(0, rows, size=idx_shape).astype(np.int32)
    if rows == 50:  # the batch table: sorted ids, long runs
        idx = np.sort(idx)
    w = rng.normal(size=idx_shape + (d,)).astype(np.float32)

    def jax_grad():
        return np.asarray(jax.grad(lambda t: jnp.sum(
            jnp.tanh(jg.take_rows(t, jnp.asarray(idx))) * w))(
            jnp.asarray(table)))

    def port_grad():
        t = torch.from_numpy(table).requires_grad_()
        (torch.tanh(tg.take_rows(t, torch.from_numpy(idx)))
         * torch.from_numpy(w)).sum().backward()
        return t.grad.numpy()

    onehot_jax, onehot_port = jax_grad(), port_grad()
    monkeypatch.setattr(jg, "_ONEHOT_BUDGET", 0)
    monkeypatch.setattr(tg, "_ONEHOT_BUDGET", 0)
    before = tg.scatter_rows_add.launches
    over_jax, over_port = jax_grad(), port_grad()
    assert tg.scatter_rows_add.launches == before
    np.testing.assert_allclose(over_port, over_jax, **GRAD_TOL)
    np.testing.assert_allclose(over_port, onehot_jax, **GRAD_TOL)
    np.testing.assert_allclose(onehot_port, onehot_jax, **GRAD_TOL)


@pytest.mark.parametrize("n,rows,dim,plan", [
    # ICEWS14_forecasting's relation table at a training hop
    (657_664, 462, 30, (30, 4096, 64, 161, 1285)),
    (246_272, 462, 30, (30, 4096, 64, 61, 481)),
    (1_683_200, 32, 30, (30, 4096, 128, 411, 1644)),  # a sorted batch table
    (152_780, 461, 20, (20, 4096, 64, 38, 299)),      # ICEWS14_TeMP
    (1000, 1, 48, (48, 4096, 64, 1, 2)),              # R = 1
    (0, 16, 20, (20, 4096, 64, 0, 0)),                # E = 0
    (100_000, 1000, 200, (128, 4096, 64, 25, 196)),   # column tiles
    (20_000_000, 4096, 32, (32, 4096, 1024, 4883, 2442)),  # the share's cap
    (5000, 4097, 30, None),     # past the count tables: index_put_
    (2 ** 31, 10, 30, None),    # past int32 slots
])
def test_scatter_plan_routing_by_shape(n, rows, dim, plan):
    assert tg._scatter_plan(n, rows, dim) == plan


def test_scatter_plan_admits_every_table_of_the_paths():
    """Relation tables of up to 475 rows and batch tables of up to 50, at
    the models' widths, all take the kernel; every plan's numbers follow
    its rule: the widest tile up to SHARE_MAX_COLS, the ids in chunks,
    the shares a power of two covering the ids."""
    for rows in range(1, 476):
        for dim in (16, 20, 30, 32, 48, 64):
            assert tg._scatter_plan(152_780, rows, dim) is not None
    for n in (0, 1, 4095, 4096, 4097, 10 ** 6, 10 ** 8):
        for rows in (1, 7, 100, 462, 4096, 4097, 60_000):
            for dim in (1, 5, 31, 33, 100, 129, 500):
                plan = tg._scatter_plan(n, rows, dim)
                assert (plan is None) == (rows > tg.SCATTER_MAX_ROWS)
                if plan is None:
                    continue
                assert plan.tile == min(dim, tg.SHARE_MAX_COLS)
                assert plan.chunk % 256 == 0
                assert plan.chunks * plan.chunk >= n > (plan.chunks - 1) \
                    * plan.chunk
                assert plan.share & (plan.share - 1) == 0
                assert 64 <= plan.share <= 1024
                block = tg.SHARE_WARPS * plan.share
                assert plan.blocks * block >= n > (plan.blocks - 1) * block


@pytest.mark.parametrize("n", [0, 1, 63, 64, 511, 512, 513, 152_780,
                               657_664, 1_683_200, 10 ** 7])
def test_shares_hold_every_slot_once(n):
    """The share pass's blocks and warps split positions [0, n) into
    disjoint pieces that cover it: each position lies in exactly one
    warp's share, the same for both kernels' plans at that n."""
    share = tg.share_slots(n)
    blocks = tg._blocks(n, share)
    assert tg._range_plan(n, 7, 30).share == share
    assert tg._range_plan(n, 7, 30).blocks == blocks
    assert tg._scatter_plan(n, 5, 30).blocks == blocks
    warp = torch.arange(blocks * tg.SHARE_WARPS)
    lo = warp * share
    hi = torch.clamp(lo + share, max=n)
    lo = torch.clamp(lo, max=n)
    assert int((hi - lo).sum()) == n
    assert bool((lo[1:] == hi[:-1]).all())
    if n:
        assert int(lo[0]) == 0 and int(hi[-1]) == n
        # no block past the list
        assert (blocks - 1) * tg.SHARE_WARPS * share < n
    else:
        assert blocks == 0


def test_plans_depend_on_shapes_alone():
    """The launch plans take the shapes (E, R, D) / (E, P, D) and nothing
    else, and every number in them is an int: the kernels' order of
    summation, and so their bits, is fixed by the inputs' shapes."""
    import inspect

    assert list(inspect.signature(tg._scatter_plan).parameters) == \
        ["n", "rows", "dim"]
    assert list(inspect.signature(tg._range_plan).parameters) == \
        ["n", "p", "dim"]
    assert list(inspect.signature(tg.share_slots).parameters) == ["n"]
    for plan in (tg._scatter_plan(657_664, 462, 30),
                 tg._range_plan(657_664, 45_568, 30)):
        assert all(type(v) is int for v in plan)
    assert tg._range_plan(246_272, 6_400, 30) == (30, 64, 13, 481)


def _scatter_cases(rng):
    """(name, g, idx, rows) of the contract's scatter layouts."""
    d = 5
    out = []
    for name, n, rows in (("random", 20_000, 462), ("one_row", 30_000, 9),
                          ("sorted_batch", 40_000, 32), ("r1", 5_000, 1),
                          ("dropped", 8_000, 40), ("empty", 0, 12)):
        ids = rng.integers(0, rows, n)
        if name == "one_row":
            ids[:] = 4
        elif name == "sorted_batch":
            ids = np.sort(ids)
        elif name == "dropped":
            ids = rng.integers(-6, rows + 6, n)
        g = rng.normal(size=(n, d)).astype(np.float32)
        out.append((name, torch.from_numpy(g), torch.from_numpy(ids), rows))
    return out


def _model_bound(got, want, s_abs, m):
    """|got - want| <= 1e-5 |want| + 2 (m - 1) u sum|x| per cell."""
    m = m.to(torch.float64)[:, None]
    bound = 1e-5 * want.abs() + 2 * torch.clamp(m - 1, min=0) * U * s_abs
    diff = (got.double() - want).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.parametrize("case", range(6))
def test_scatter_model_matches_float64(rng, case):
    """The kernel's order in plain PyTorch (stable sort, warp shares,
    block and group fix-ups, `scatter_rows_add_model`) against a float64
    index_add_, within the rounding bound of a float32 sum of m terms;
    ids outside [0, R) dropped, an empty table row 0. On multiples of 1/8
    every partial sum is exact, so the model gives float64's bits."""
    name, g, idx, rows = _scatter_cases(rng)[case]
    ok = (idx >= 0) & (idx < rows)
    got = tg.scatter_rows_add_model(g, idx, rows)
    assert got.dtype == torch.float32 and got.shape == (rows, g.shape[1])
    want = torch.zeros(rows, g.shape[1], dtype=torch.float64).index_add_(
        0, idx[ok], g[ok].double())
    s_abs = torch.zeros_like(want).index_add_(0, idx[ok], g[ok].abs().double())
    _model_bound(got, want, s_abs, torch.bincount(idx[ok], minlength=rows))
    dyadic = torch.from_numpy(
        (rng.integers(-64, 64, size=tuple(g.shape)) / 8).astype(np.float32))
    exact = torch.zeros_like(want).index_add_(0, idx[ok], dyadic[ok].double())
    assert torch.equal(tg.scatter_rows_add_model(dyadic, idx, rows).double(),
                       exact)
    # and JAX's segment_sum on the valid ids
    jx = np.asarray(jax.ops.segment_sum(jnp.asarray(g[ok].numpy()),
                                        jnp.asarray(idx[ok].numpy()),
                                        num_segments=rows))
    np.testing.assert_allclose(got.numpy(), jx, **GRAD_TOL)


def test_scatter_model_spreads_a_hot_row_over_groups(rng):
    """One row holding 90% of 10^5 ids crosses ~1,400 warp shares, ~176
    blocks and 6 fix-up groups at share 64: every level of the order is
    taken, and the sum still lies within the bound of float64."""
    n, rows = 100_000, 3
    idx = torch.from_numpy(np.where(rng.random(n) < 0.9, 1,
                                    rng.integers(0, rows, n)))
    g = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    assert tg.share_slots(n) == 64
    assert n * 0.9 / (tg.SHARE_WARPS * 64) > tg.SHARE_FIX_GROUP
    got = tg.scatter_rows_add_model(g, idx, rows)
    want = torch.zeros(rows, 4, dtype=torch.float64).index_add_(
        0, idx, g.double())
    s_abs = torch.zeros_like(want).index_add_(0, idx, g.abs().double())
    _model_bound(got, want, s_abs, torch.bincount(idx, minlength=rows))


def _range_cases(rng):
    """(name, start, count, E) of the contract's range layouts."""
    out = [(kind,) + ranges(rng, kind) for kind in KINDS]
    p = 60
    start = rng.integers(-10, 900, p)     # unordered, overlapping, negative
    count = rng.integers(-3, 300, p)
    out.append(("overlapping", start, count, 1000))
    start = np.zeros(40, np.int64)        # longer than the grid's shares
    out.append(("over_grid", start, np.full(40, 700), 700))
    out.append(("empty_g", np.array([0, 3]), np.array([2, 1]), 0))
    return out


@pytest.mark.parametrize("case", range(7))
def test_range_model_matches_reference(rng, case):
    """The kernel's order in plain PyTorch (`range_sum_model`: the clipped
    ranges laid end to end, warp shares, block and group fix-ups) against
    `range_sum_reference` (float64) within the rounding bound of a float32
    sum of m terms, and against JAX's `_gp_bwd` where the ranges are the
    packed gather's; on multiples of 1/8, float64's bits."""
    name, start, count, e = _range_cases(rng)[case]
    d = 3
    g = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    st, ct = torch.from_numpy(start), torch.from_numpy(count)
    got = tg.range_sum_model(g, st, ct)
    want = tg.range_sum_reference(g, st, ct)
    lo, m = tg._clipped(st, ct, e)
    _model_bound(got, want, tg.range_sum_reference(g.abs(), st, ct), m)
    assert bool((got[(ct <= 0) | (st >= e)] == 0).all())
    dyadic = torch.from_numpy(
        (rng.integers(-64, 64, size=(e, d)) / 8).astype(np.float32))
    assert torch.equal(tg.range_sum_model(dyadic, st, ct).double(),
                       tg.range_sum_reference(dyadic, st, ct))
    if name in KINDS:
        jx = jax_range_grad(g.numpy(), start, count)
        bound = 2 * e * U * np.abs(g.numpy()).sum(0) + 1e-5 * np.abs(jx)
        assert np.all(np.abs(got.numpy() - jx) <= bound)


def test_wrappers_take_the_plain_path_on_the_cpu(rng):
    """Through autograd and called directly, the CPU path is the plain
    version, bit for bit, and neither kernel's counter moves."""
    a0, b0 = tg.range_sum.launches, tg.scatter_rows_add.launches
    # gather_rows_packed's backward
    p, d = 9, 4
    start, count, e = ranges(rng, "csr")
    start, count = start[:p], count[:p]
    e = int(start[-1] + count[-1]) + 3
    vals = torch.from_numpy(rng.normal(size=(p, d)).astype(np.float32))
    idx = torch.from_numpy(np.minimum(np.repeat(np.arange(p), count),
                                      p - 1)[:e].astype(np.int32))
    idx = torch.cat([idx, idx[-1:].repeat(e - idx.shape[0])])
    v = vals.clone().requires_grad_()
    w = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    _, rows = tg.gather_rows_packed(torch.zeros(p, 1, dtype=torch.int32), v,
                                    idx, torch.from_numpy(start),
                                    torch.from_numpy(count))
    (rows * w).sum().backward()
    assert torch.equal(v.grad, tg.range_sum_scan(
        w, torch.from_numpy(start), torch.from_numpy(count)))
    # scatter_rows_add, directly and as take_rows' over-budget backward
    r = 13
    g = torch.from_numpy(rng.normal(size=(200, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, r, 200))
    want = torch.zeros(r, d).index_put_((ids,), g, accumulate=True)
    assert torch.equal(tg.scatter_rows_add(g, ids, r), want)
    assert torch.equal(tg.scatter_rows_add(g, ids.int(), r), want)
    assert tg.range_sum.launches == a0 and tg.scatter_rows_add.launches == b0


def test_scatter_rows_add_rejects_what_it_does_not_take():
    g = torch.zeros(6, 3)
    with pytest.raises(TypeError, match="float32"):
        tg.scatter_rows_add(g.double(), torch.zeros(6, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="scatter_rows_add"):
        tg.scatter_rows_add(g, torch.zeros(5, dtype=torch.int64), 4)
