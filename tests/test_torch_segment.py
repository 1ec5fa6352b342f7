"""Port's sorted-segment sum and segment_sum dispatcher vs the JAX package.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_segment_pallas.py does; the port's CPU path is its plain
version. Summation orders differ (one-hot matmul per chunk vs edge
order), hence rtol=atol=1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from redgnn_tpu.ops import segment as jseg
from redgnn_tpu.ops.segment import segment_sum as jax_segment_sum
from redgnn_tpu.ops.segment_pallas import (
    segment_sum_pallas,
    segment_sum_pallas_checked,
)
from redgnn_tpu_torch.ops import segment as tseg
from redgnn_tpu_torch.ops.segment import segment_sum
from redgnn_tpu_torch.ops.segment_sorted import (
    SEGS_PER_BLOCK,
    _launch,
    _launch_plan,
    segment_sum_sorted,
    segment_sum_sorted_checked,
    segment_sum_sorted_reference,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, kind, e, d, n):
    data = rng.normal(size=(e, d)).astype(np.float32)
    if kind == "random":
        seg = np.sort(rng.integers(0, n, e))
    elif kind == "skewed":
        # one hub segment takes most edges, many segments stay empty
        seg = np.sort(np.where(rng.random(e) < 0.7, 7,
                               rng.integers(0, n, e)))
    elif kind == "negative":  # negative ids first, dropped like the rest
        seg = np.sort(rng.integers(-20, n + 20, e))
    elif kind == "sparse":  # far more segments than edges
        seg = np.sort(rng.integers(0, n, e))
    else:  # "out_of_range": pad ids past num_segments, dropped
        seg = np.sort(rng.integers(0, n + 50, e))
    return data, seg.astype(np.int32)


@pytest.mark.parametrize("kind,e,d,n", [
    ("random", 512, 48, 128), ("random", 1000, 16, 300),
    ("random", 256, 128, 50), ("skewed", 512, 32, 256),
    ("out_of_range", 256, 8, 64), ("negative", 300, 33, 40),
    ("sparse", 64, 48, 2000),
])
def test_matches_pallas(rng, kind, e, d, n):
    data, seg = _case(rng, kind, e, d, n)
    want = segment_sum_pallas(jnp.asarray(data), jnp.asarray(seg), n)
    got = segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(seg), n)
    assert got.shape == (n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_empty_segments_are_zero(rng):
    data, seg = _case(rng, "skewed", 512, 32, 256)
    got = segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(seg),
                             256).numpy()
    present = np.zeros(256, bool)
    present[seg] = True
    assert np.all(got[~present] == 0)


@pytest.mark.parametrize("kmax,chunk,bn", [(1, 64, 32), (2, 32, 64),
                                           (None, 64, 32)])
def test_checked_kmax_matches_pallas(rng, kmax, chunk, bn):
    # a skewed layout: block 0 needs many chunks, so small kmax overflows
    e, d, n = 600, 16, 150
    data = rng.normal(size=(e, d)).astype(np.float32)
    seg = np.sort(np.concatenate([rng.integers(0, 20, 400),
                                  rng.integers(0, n + 10, e - 400)]))
    seg = seg.astype(np.int32)
    want, want_ovf = segment_sum_pallas_checked(
        jnp.asarray(data), jnp.asarray(seg), n, kmax=kmax, chunk=chunk, bn=bn)
    got, ovf = segment_sum_sorted_checked(
        torch.from_numpy(data), torch.from_numpy(seg), n, kmax=kmax,
        chunk=chunk, bn=bn)
    assert bool(ovf) == bool(want_ovf)
    assert bool(ovf) == (kmax is not None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_dispatcher_xla_matches_jax(rng, sorted_ids):
    e, d, n = 300, 12, 40
    seg = rng.integers(-5, n + 20, e).astype(np.int32)
    if sorted_ids:
        seg = np.sort(seg)
    data = rng.normal(size=(e, d)).astype(np.float32)
    want = jax_segment_sum(jnp.asarray(data), jnp.asarray(seg), n,
                           indices_are_sorted=sorted_ids)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(seg), n,
                      indices_are_sorted=sorted_ids, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dispatcher_pallas_and_unported(rng):
    data = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 16, 64)).astype(np.int32))
    want = segment_sum_sorted_reference(data, seg, 16)[0]
    torch.testing.assert_close(
        segment_sum(data, seg, 16, indices_are_sorted=True, impl="pallas"),
        want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        segment_sum(data, seg, 16, indices_are_sorted=False, impl="pallas")
    with pytest.raises(ValueError):
        segment_sum(data, seg, 16, indices_are_sorted=False, impl="scan")
    with pytest.raises(ValueError):
        segment_sum(data, seg, 16, indices_are_sorted=True, impl="mxu")


def test_wrapper_rejects_bad_inputs(rng):
    data = torch.zeros(10, 4)
    with pytest.raises(TypeError):
        segment_sum_sorted(data, torch.zeros(10, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        segment_sum_sorted(data, torch.zeros(9, dtype=torch.int32), 3)


@pytest.mark.parametrize("n_seg", [1, 15, 16, 17, 2048, 8704, 9984, 70_000,
                                   1_000_000, 2 ** 31 - 2])
def test_launch_plan_covers_every_segment_once(n_seg):
    plan = _launch_plan(n_seg, 48, 0)
    # block b owns [b*segs, min((b+1)*segs, n_seg)): consecutive, disjoint,
    # each non-empty, the last one ending at n_seg
    los = np.arange(plan.grid, dtype=np.int64) * SEGS_PER_BLOCK
    his = np.minimum(los + SEGS_PER_BLOCK, n_seg)
    assert los[0] == 0 and his[-1] == n_seg
    assert np.all(los < his) and np.all(los[1:] == his[:-1])


@pytest.mark.parametrize("dim", [48, 33, 4, 1, 128, 100])
@pytest.mark.parametrize("offset", [0, 4, 8, 12, 16, 256])
def test_launch_plan_vector_path(dim, offset):
    ptr = 0x7F0000000000 + offset
    vec = _launch_plan(100, dim, ptr).vec
    assert vec == (dim % 4 == 0 and offset % 16 == 0)


def test_launch_plan_of_misaligned_view():
    # the card tests' misaligned case: rows of 33 floats, one row in
    x = torch.zeros(11, 33)
    assert _launch_plan(5, 33, x[1:].data_ptr()).vec is False
    y = torch.zeros(11 * 48 + 1)[1:].view(11, 48)
    assert y.data_ptr() % 16 != 0
    assert _launch_plan(5, 48, y.data_ptr()).vec is False


def test_launch_refuses_cpu_tensors():
    # the kernel's launch path never takes a CPU tensor (no fallback there)
    data = torch.zeros(4, 8)
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        _launch(data, seg, 2, None, 512)


# ------------------------------------------- scan, max, softmax, top-k, l1

def _padded_case(rng, e=300, n=40, d=5, pads=7):
    """Sorted ids with empty segments and a zeroed out-of-range pad tail
    (tests/test_segment.py's case)."""
    ids = np.sort(rng.integers(0, n, e))
    ids[ids == 11] = 12  # an empty segment in the middle
    ids[-pads:] = n
    data = rng.normal(size=(e, d)).astype(np.float32)
    data[-pads:] = 0.0
    return data, ids.astype(np.int32)


def test_segment_sum_scan_matches(rng):
    """impl='scan' vs the JAX scan (and the scatter path) at the
    tolerance tests/test_segment.py uses, values and gradients."""
    import jax

    n = 40
    data, ids = _padded_case(rng, n=n)
    w = rng.normal(size=(n, data.shape[1])).astype(np.float32)
    want = jax_segment_sum(jnp.asarray(data), jnp.asarray(ids), n,
                           indices_are_sorted=True, impl="scan")
    x = torch.from_numpy(data).requires_grad_()
    got = segment_sum(x, torch.from_numpy(ids), n, indices_are_sorted=True,
                      impl="scan")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.detach().numpy(),
        segment_sum(x.detach(), torch.from_numpy(ids), n).numpy(),
        rtol=1e-4, atol=1e-4)
    assert np.all(got.detach().numpy()[11] == 0)
    (got * torch.from_numpy(w)).sum().backward()
    g_want = jax.grad(lambda v: jnp.sum(jax_segment_sum(
        v, jnp.asarray(ids), n, indices_are_sorted=True, impl="scan") * w))(
        jnp.asarray(data))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want),
                               rtol=1e-5, atol=1e-5)
    assert np.all(x.grad.numpy()[-7:] == 0)


@pytest.mark.parametrize("e,n", [(0, 5), (6, 0)])
def test_segment_sum_scan_empty(e, n):
    out = segment_sum(torch.ones(e, 3), torch.zeros(e, dtype=torch.int32), n,
                      indices_are_sorted=True, impl="scan")
    assert out.shape == (n, 3) and bool((out == 0).all())


@pytest.mark.parametrize("d", [None, 4])
def test_segment_max_equal(rng, d):
    n = 12
    shape = (80,) if d is None else (80, d)
    data = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(0, n + 3, 80).astype(np.int32)  # unsorted, some dropped
    ids[ids == 5] = 6  # an empty segment
    want = jseg.segment_max(jnp.asarray(data), jnp.asarray(ids), n)
    got = tseg.segment_max(torch.from_numpy(data), torch.from_numpy(ids), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.all(got.numpy()[5] == np.float32(-1e30))


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_equal(rng, masked):
    """Values, and a finite gradient equal to JAX's; a masked entry holds
    a huge logit that must not reach exp()."""
    import jax

    n, e = 9, 70
    data = rng.normal(size=e).astype(np.float32) * 3
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    valid = None
    if masked:
        valid = rng.random(e) < 0.8
        data[~valid] = 1e4
    w = rng.normal(size=e).astype(np.float32)
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)

    def jfn(x):
        return jseg.segment_softmax(x, jnp.asarray(ids), n, valid=jvalid)

    want = jfn(jnp.asarray(data))
    g_want = jax.grad(lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    got = tseg.segment_softmax(x, torch.from_numpy(ids), n, valid=tvalid)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    (got * torch.from_numpy(w)).sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want),
                               rtol=1e-4, atol=1e-6)
    if masked:
        assert np.all(got.detach().numpy()[~valid] == 0)
        assert np.all(x.grad.numpy()[~valid] == 0)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_topk_mask_equal(rng, k, masked):
    """Equal masks with deliberate ties (broken by position)."""
    n, e = 7, 90
    data = rng.integers(0, 4, e).astype(np.float32)  # many ties
    ids = rng.integers(0, n, e).astype(np.int32)     # unsorted
    valid = (rng.random(e) < 0.7) if masked else None
    want = jseg.segment_topk_mask(
        jnp.asarray(data), jnp.asarray(ids), n, k,
        valid=None if valid is None else jnp.asarray(valid))
    got = tseg.segment_topk_mask(
        torch.from_numpy(data), torch.from_numpy(ids), n, k,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = got.numpy() if valid is None else got.numpy() & valid
    assert np.bincount(ids[live], minlength=n).max() <= k


@pytest.mark.parametrize("masked", [False, True])
def test_segment_normalize_l1_equal(rng, masked):
    n, e = 6, 50
    data = rng.random(e).astype(np.float32)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    valid = (rng.random(e) < 0.7) if masked else None
    want = jseg.segment_normalize_l1(
        jnp.asarray(data), jnp.asarray(ids), n,
        valid=None if valid is None else jnp.asarray(valid))
    got = tseg.segment_normalize_l1(
        torch.from_numpy(data), torch.from_numpy(ids), n,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
