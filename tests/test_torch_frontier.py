"""Port's frontier expansion and state carry vs the JAX package.

Integer outputs must be equal, field for field, including the overflow
flags under deliberately small caps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from redgnn_tpu.graph.kg import build_csr
from redgnn_tpu.ops import frontier as jf
from redgnn_tpu_torch.ops import frontier as tf

SMAX = np.iinfo(np.int32).max
FIELDS = ("node_keys", "num_nodes", "src", "dst", "rel", "batch", "edge_id",
          "edge_valid", "num_edges", "edge_overflow", "node_overflow")


def random_graph(rng, n_ent=30, n_edges=120, n_rel=5):
    """Random triples + self-loops, CSR arrays."""
    h = rng.integers(0, n_ent, n_edges)
    r = rng.integers(0, 2 * n_rel, n_edges)
    t = rng.integers(0, n_ent, n_edges)
    ents = np.arange(n_ent)
    idd = np.stack([ents, np.full(n_ent, 2 * n_rel), ents], 1)
    return build_csr(np.concatenate([np.stack([h, r, t], 1), idd], 0), n_ent)


def frontier_keys(rng, n_ent, b, cap):
    keys = np.full(cap, SMAX, np.int32)
    heads = rng.integers(0, n_ent, b)
    keys[:b] = np.sort(np.arange(b) * n_ent + heads)
    return keys


def both(rowptr, rel, tail, n_ent, keys, edge_cap, node_cap):
    want = jax.device_get(jf.expand_frontier(
        jnp.asarray(rowptr), jnp.asarray(rel), jnp.asarray(tail), n_ent,
        jnp.asarray(keys), edge_cap, node_cap, dedup_impl="sort"))
    got = tf.expand_frontier(
        torch.from_numpy(rowptr), torch.from_numpy(rel),
        torch.from_numpy(tail), n_ent, torch.from_numpy(keys), edge_cap,
        node_cap, dedup_impl="sort")
    return want, got


def assert_frontier_equal(want, got):
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        assert g.shape == w.shape, (f, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("edge_cap,node_cap", [
    (1024, 256),   # roomy
    (12, 256),     # edge overflow: the emitted list is clipped
    (1024, 5),     # node overflow: unique tails past node_cap
    (40, 9),       # both
])
def test_expand_equal(rng, edge_cap, node_cap):
    n_ent = 30
    rowptr, rel, tail = random_graph(rng, n_ent=n_ent)
    keys = frontier_keys(rng, n_ent, 4, 8)
    want, got = both(rowptr, rel, tail, n_ent, keys, edge_cap, node_cap)
    assert_frontier_equal(want, got)
    if edge_cap == 12:
        assert bool(got.edge_overflow)
    if node_cap in (5, 9):
        assert bool(got.node_overflow)


def test_multi_hop_chain_equal(rng):
    """Three hops fed from the previous hop's keys, as the model does."""
    n_ent = 40
    rowptr, rel, tail = random_graph(rng, n_ent=n_ent, n_edges=200)
    keys = frontier_keys(rng, n_ent, 3, 3)
    for edge_cap, node_cap in ((256, 128), (1024, 256), (4096, 512)):
        want, got = both(rowptr, rel, tail, n_ent, keys, edge_cap, node_cap)
        assert_frontier_equal(want, got)
        keys = got.node_keys.numpy()


def test_unported_options_raise(rng):
    rowptr, rel, tail = random_graph(rng)
    args = (torch.from_numpy(rowptr), torch.from_numpy(rel),
            torch.from_numpy(tail), 30,
            torch.from_numpy(frontier_keys(rng, 30, 2, 4)), 64, 64)
    with pytest.raises(NotImplementedError):
        tf.expand_frontier(*args, dedup_impl="bitmap", key_space=60)
    with pytest.raises(NotImplementedError):
        tf.expand_frontier(*args, node_values=torch.zeros(4, 2))
    with pytest.raises(NotImplementedError):
        tf.align_old_to_new(args[4], args[4], torch.zeros(4, 1), 4,
                            key_prefix=torch.zeros(60, dtype=torch.int32))


def _align_both(old_keys, new_keys, old_vals, cap):
    want = np.asarray(jf.align_old_to_new(
        jnp.asarray(old_keys), jnp.asarray(new_keys), jnp.asarray(old_vals),
        cap))
    got = tf.align_old_to_new(
        torch.from_numpy(old_keys), torch.from_numpy(new_keys),
        torch.from_numpy(old_vals), cap).numpy()
    return want, got


def test_align_old_to_new_equal(rng):
    old_keys = np.array([5, 17, 42, SMAX], np.int32)
    new_keys = np.array([2, 5, 17, 30, 42, 50, SMAX, SMAX], np.int32)
    old_vals = rng.normal(size=(4, 3)).astype(np.float32)
    want, got = _align_both(old_keys, new_keys, old_vals, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[1, 2, 4]], old_vals[:3])


def test_align_drops_missing_keys(rng):
    """Keys missing from the new frontier (a clipped self-loop), keys past
    its last valid slot and keys below its first are dropped, never
    written into another node's slot (`frontier.py:332-343`)."""
    old_keys = np.array([1, 6, 17, 99, SMAX], np.int32)
    new_keys = np.array([5, 17, 30, 42], np.int32)  # full: no pad slot
    old_vals = rng.normal(size=(5, 2)).astype(np.float32)
    want, got = _align_both(old_keys, new_keys, old_vals, 4)
    np.testing.assert_array_equal(got, want)
    expected = np.zeros((4, 2), np.float32)
    expected[1] = old_vals[2]
    np.testing.assert_array_equal(got, expected)
