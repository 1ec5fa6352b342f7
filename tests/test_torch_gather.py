"""Port's range-structured gathers (ops/gather.py) vs the JAX package.

Forward bits must equal plain gathers. The prefix-sum backwards add in
another order than XLA's cumsum, so gradients are held to the JAX
gradient at rtol 1e-4, atol 1e-5, as tests/test_segment.py holds the JAX
functions to plain-gather autodiff.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from redgnn_tpu.ops import gather as jg
from redgnn_tpu_torch.ops import gather as tg

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def range_layout(rng, p=11, pad=9):
    """CSR-style layout: each of ``p`` rows owns a contiguous (possibly
    empty) range of index slots; the padded tail holds the last index."""
    count = rng.integers(0, 6, size=p).astype(np.int32)
    count[3] = 0
    start = (np.cumsum(count) - count).astype(np.int32)
    total = int(count.sum())
    idx = np.repeat(np.arange(p, dtype=np.int32), count)
    idx = np.concatenate([idx, np.full(pad, idx[-1], np.int32)])
    return start, count, total, idx


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_gather_rows_packed_forward_bits(rng, index_dtype):
    p = 11
    meta = rng.integers(-5, 2 ** 30, size=(p, 3)).astype(np.int32)
    vals = rng.normal(size=(p, 7)).astype(np.float32)
    vals[2, 1] = -0.0
    start, count, _, idx = range_layout(rng, p)
    jm, jv = jg.gather_rows_packed(*(jnp.asarray(a) for a in
                                     (meta, vals, idx, start, count)))
    for grad in (False, True):
        v = torch.from_numpy(vals).requires_grad_(grad)
        m_rows, v_rows = tg.gather_rows_packed(
            torch.from_numpy(meta), v, torch.from_numpy(idx),
            torch.from_numpy(start.astype(index_dtype)),
            torch.from_numpy(count.astype(index_dtype)))
        assert not m_rows.requires_grad and v_rows.requires_grad == grad
        np.testing.assert_array_equal(m_rows.numpy(), np.asarray(jm))
        # bit for bit, the sign of zero included
        np.testing.assert_array_equal(
            v_rows.detach().numpy().view(np.int32),
            np.asarray(jv).view(np.int32))
        np.testing.assert_array_equal(m_rows.numpy(), meta[idx])


def test_gather_rows_packed_rejects_other_dtypes():
    meta = torch.zeros(3, 2, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        tg.gather_rows_packed(meta, torch.zeros(3, 2, dtype=torch.float64),
                              idx, z, z)


@pytest.mark.parametrize("clip", [0, 2, 7], ids=["whole", "clip2", "clip7"])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_gather_rows_packed_grad(rng, clip, index_dtype):
    """The range-difference backward vs the JAX gradient, with empty
    ranges, a padded tail, and ranges clipped by the index length."""
    p = 11
    meta = rng.integers(0, 100, size=(p, 2)).astype(np.int32)
    vals = rng.normal(size=(p, 7)).astype(np.float32)
    start, count, total, idx = range_layout(rng, p)
    if clip:
        idx = idx[:max(total - clip, 1)]
    mask = (np.arange(len(idx)) < total)[:, None].astype(np.float32)
    w = rng.normal(size=(7,)).astype(np.float32)

    def jloss(v, fused):
        rows = (jg.gather_rows_packed(jnp.asarray(meta), v, jnp.asarray(idx),
                                      jnp.asarray(start),
                                      jnp.asarray(count))[1]
                if fused else v[jnp.asarray(idx)])
        return jnp.sum((jnp.tanh(rows) * mask) @ w)

    want = np.asarray(jax.grad(lambda v: jloss(v, True))(jnp.asarray(vals)))
    plain = np.asarray(jax.grad(lambda v: jloss(v, False))(jnp.asarray(vals)))
    v = torch.from_numpy(vals).requires_grad_()
    _, rows = tg.gather_rows_packed(
        torch.from_numpy(meta), v, torch.from_numpy(idx),
        torch.from_numpy(start.astype(index_dtype)),
        torch.from_numpy(count.astype(index_dtype)))
    ((torch.tanh(rows) * torch.from_numpy(mask))
     @ torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), want, **GRAD_TOL)
    np.testing.assert_allclose(v.grad.numpy(), plain, **GRAD_TOL)
    assert np.all(v.grad.numpy()[count == 0] == 0)


def test_take_rows_sorted(rng):
    """Value and gradient for non-decreasing indices with repeats, gaps
    and a clamped pad tail (tests/test_segment.py's case)."""
    table = rng.normal(size=(13, 6)).astype(np.float32)
    idx = np.sort(rng.integers(0, 12, size=90)).astype(np.int32)
    idx = np.concatenate([idx, np.full(10, 12, np.int32)])
    w = rng.normal(size=(6,)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(
        jnp.tanh(jg.take_rows_sorted(t, jnp.asarray(idx))) @ w))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = tg.take_rows_sorted(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (torch.tanh(out) @ torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD_TOL)
    t2 = torch.from_numpy(table).requires_grad_()
    (torch.tanh(t2[torch.from_numpy(idx).long()])
     @ torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), **GRAD_TOL)
    with torch.no_grad():
        assert torch.equal(tg.take_rows_sorted(t, torch.from_numpy(idx)),
                           out.detach())
