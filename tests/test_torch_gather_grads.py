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


@pytest.mark.parametrize("rows,dim,plan", [
    (462, 30, (30, 1024)),      # ICEWS14_forecasting's relation table
    (475, 48, (48, 1024)),
    (16, 20, (20, 1024)),       # batch tables: the chunk's floor
    (50, 30, (30, 1024)),
    (1000, 200, (32, 2048)),   # 1000 x 128 fp32 is 500 KB: 32-column tiles
    (1600, 32, (32, 4096)),    # the widest table at 32 columns
    (1601, 32, None),           # past it: index_put_
    (5000, 30, None),
    (20_000, 1, (1, 65536)),   # the chunk's ceiling
])
def test_scatter_plan_routing_by_shape(rows, dim, plan):
    assert tg._scatter_plan(rows, dim) == plan


def test_scatter_plan_admits_every_table_of_the_paths():
    """Relation tables of up to 475 rows and batch tables of up to 50, at
    the models' widths, all take the kernel; every plan's table fits the
    shared-memory budget at a tile of at most 128 columns, the widest
    that fits, and a chunk that is a power of two."""
    for rows in range(1, 476):
        for dim in (16, 20, 30, 32, 48, 64):
            assert tg._scatter_plan(rows, dim) is not None, (rows, dim)
    for rows in (1, 7, 100, 462, 1000, 1600, 1601, 20_000, 60_000):
        for dim in (1, 5, 31, 33, 100, 129, 500):
            plan = tg._scatter_plan(rows, dim)
            narrowest = min(dim, 32)
            assert (plan is None) == (
                rows * narrowest * 4 > tg.SCATTER_MAX_TABLE_BYTES)
            if plan is None:
                continue
            tile, chunk = plan
            assert tile <= min(dim, tg.SCATTER_MAX_COLS)
            assert rows * tile * 4 <= tg.SCATTER_MAX_TABLE_BYTES
            wider = tile + 32 if tile % 32 == 0 else None
            if tile < min(dim, tg.SCATTER_MAX_COLS) and wider:
                assert rows * min(wider, dim) * 4 > \
                    tg.SCATTER_MAX_TABLE_BYTES
            assert chunk & (chunk - 1) == 0 and 1024 <= chunk <= 65536
            assert chunk >= min(2 * rows, 65536)


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
