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

from redgnn_tpu.ops.segment import segment_sum as jax_segment_sum
from redgnn_tpu.ops.segment_pallas import (
    segment_sum_pallas,
    segment_sum_pallas_checked,
)
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
    with pytest.raises(NotImplementedError):
        segment_sum(data, seg, 16, indices_are_sorted=True, impl="scan")


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
