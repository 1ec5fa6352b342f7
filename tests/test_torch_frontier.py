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


ALL_FIELDS = FIELDS + ("key_prefix", "time", "src_values")


def assert_all_fields_equal(want, got):
    """Every field, the optional ones too: both None or both equal
    (``src_values`` is a plain gather, so its float bits are equal)."""
    assert_frontier_equal(want, got)
    for f in ALL_FIELDS[len(FIELDS):]:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert g.numpy().dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def expand_both(csr, n_ent, keys, edge_cap, node_cap, dedup, b, *,
                etime=None, node_values=None, mask_edges=None):
    """The same expansion through both packages; ``mask_edges`` is a bool
    array over CSR slots that becomes each side's ``edge_mask_fn``."""
    jmask = tmask = None
    if mask_edges is not None:
        jkeep, tkeep = jnp.asarray(mask_edges), torch.from_numpy(mask_edges)
        jmask = lambda eid, batch, rel: jkeep[eid] & (rel != 3)
        tmask = lambda eid, batch, rel: tkeep[eid] & (rel != 3)
    opt = lambda x, conv: None if x is None else conv(x)
    want = jax.device_get(jf.expand_frontier(
        *(jnp.asarray(a) for a in csr), n_ent, jnp.asarray(keys), edge_cap,
        node_cap, edge_mask_fn=jmask, dedup_impl=dedup, key_space=b * n_ent,
        etime=opt(etime, jnp.asarray), node_values=opt(node_values,
                                                       jnp.asarray)))
    got = tf.expand_frontier(
        *(torch.from_numpy(a) for a in csr), n_ent, torch.from_numpy(keys),
        edge_cap, node_cap, edge_mask_fn=tmask, dedup_impl=dedup,
        key_space=b * n_ent, etime=opt(etime, torch.from_numpy),
        node_values=opt(node_values, torch.from_numpy))
    return want, got


@pytest.mark.parametrize("edge_cap,node_cap", [
    (1024, 256),   # roomy
    (12, 256),     # edge overflow: the emitted list is clipped
    (1024, 5),     # node overflow: slots past node_cap are dropped
    (40, 9),       # both
])
def test_bitmap_expand_equal(rng, edge_cap, node_cap):
    """Bitmap dedup with node_values: every field incl. key_prefix and
    src_values, under roomy and overflowing caps."""
    n_ent, b = 30, 4
    csr = random_graph(rng, n_ent=n_ent)
    keys = frontier_keys(rng, n_ent, b, 8)
    vals = rng.normal(size=(8, 6)).astype(np.float32)
    want, got = expand_both(csr, n_ent, keys, edge_cap, node_cap, "bitmap",
                            b, node_values=vals)
    assert got.key_prefix is not None and got.src_values is not None
    assert_all_fields_equal(want, got)
    assert bool(got.edge_overflow) == (int(got.num_edges) > edge_cap)
    assert bool(got.node_overflow) == (int(got.num_nodes) > node_cap)
    if edge_cap == 12:
        assert bool(got.edge_overflow)
    if node_cap in (5, 9):
        assert bool(got.node_overflow)
    # expansion order: src never decreases
    assert bool((got.src[1:] >= got.src[:-1]).all())


@pytest.mark.parametrize("dedup", ["bitmap", "sort"])
def test_expand_mask_and_time_equal(rng, dedup):
    """edge_mask_fn (applied before dedup) and etime -> Frontier.time."""
    n_ent, b = 30, 3
    csr = random_graph(rng, n_ent=n_ent)
    keys = frontier_keys(rng, n_ent, b, 6)
    etime = rng.integers(0, 50, len(csr[1])).astype(np.int32)
    mask = rng.random(len(csr[1])) < 0.6
    want, got = expand_both(csr, n_ent, keys, 256, 64, dedup, b,
                            etime=etime, mask_edges=mask,
                            node_values=np.ones((6, 2), np.float32))
    assert got.time is not None
    # node_values is silently dropped under sort dedup
    assert (got.src_values is None) == (dedup == "sort")
    assert_all_fields_equal(want, got)
    # no masked edge survives, and its tail made no node
    eid = got.edge_id.numpy()[got.edge_valid.numpy()]
    assert mask[eid].all() and (csr[1][eid] != 3).all()


@pytest.mark.parametrize("dedup", ["bitmap", "sort"])
@pytest.mark.parametrize("edge_cap", [256, 20])
def test_expand_ranges_extra_edge_slot_equal(rng, dedup, edge_cap):
    """expand_frontier_ranges over a sub-range of each row plus one extra
    edge per valid node (its last slot), with and without edge overflow."""
    n_ent, b = 30, 3
    rowptr, rel, tail = random_graph(rng, n_ent=n_ent)
    keys = frontier_keys(rng, n_ent, b, 6)
    ent = np.where(keys != SMAX, keys % n_ent, 0)
    full = rowptr[ent + 1] - rowptr[ent]
    deg = np.where(keys != SMAX, full // 2, 0).astype(np.int32)
    row_start = rowptr[ent].astype(np.int32)
    extra = (rowptr[ent + 1] - 1).astype(np.int32)  # the row's last edge
    etime = rng.integers(0, 9, len(rel)).astype(np.int32)
    vals = rng.normal(size=(6, 3)).astype(np.float32)

    def run(mod, conv):
        return mod.expand_frontier_ranges(
            conv(rel), conv(tail), n_ent, conv(keys), conv(row_start),
            conv(deg), edge_cap, 64, extra_edge_slot=conv(extra),
            dedup_impl=dedup, key_space=b * n_ent, etime=conv(etime),
            node_values=conv(vals))

    want = jax.device_get(run(jf, jnp.asarray))
    got = run(tf, torch.from_numpy)
    assert_all_fields_equal(want, got)
    assert int(got.num_edges) == int(deg.sum()) + b


def test_bitmap_and_sort_same_nodes(rng):
    """Both dedup schemes give the same sorted node set, and the same
    (key of src, key of dst, rel) edge multiset."""
    n_ent, b = 40, 3
    csr = random_graph(rng, n_ent=n_ent, n_edges=200)
    keys = frontier_keys(rng, n_ent, b, 3)
    args = (*(torch.from_numpy(a) for a in csr), n_ent,
            torch.from_numpy(keys), 512, 128)
    s = tf.expand_frontier(*args, dedup_impl="sort")
    m = tf.expand_frontier(*args, dedup_impl="bitmap", key_space=b * n_ent)
    assert torch.equal(s.node_keys, m.node_keys)
    assert int(s.num_nodes) == int(m.num_nodes)

    def edge_set(fr):
        v = fr.edge_valid
        rows = torch.stack([fr.src[v], fr.node_keys[fr.dst[v].long()],
                            fr.rel[v], fr.edge_id[v]], 1)
        return sorted(map(tuple, rows.tolist()))

    assert edge_set(s) == edge_set(m)


def test_unported_options_raise(rng):
    """The options that used to raise (the name dates from then): bitmap
    dedup and node_values run, an unknown scheme raises, and bitmap
    without a key space raises."""
    rowptr, rel, tail = random_graph(rng)
    args = (torch.from_numpy(rowptr), torch.from_numpy(rel),
            torch.from_numpy(tail), 30,
            torch.from_numpy(frontier_keys(rng, 30, 2, 4)), 64, 64)
    fr = tf.expand_frontier(*args, dedup_impl="bitmap", key_space=60,
                            node_values=torch.zeros(4, 2))
    assert fr.key_prefix.shape == (60,) and fr.src_values.shape == (64, 2)
    assert tf.expand_frontier(*args,
                              node_values=torch.zeros(4, 2)).src_values is None
    with pytest.raises(ValueError):
        tf.expand_frontier(*args, dedup_impl="bitmap")
    with pytest.raises(ValueError):
        tf.expand_frontier(*args, dedup_impl="hash")


def test_align_with_key_prefix_equal(rng):
    """align_old_to_new through a bitmap frontier's key_prefix, with an
    old key absent from the new frontier (prefix - 1 = -1 or another
    node's slot): dropped on both sides."""
    n_ent, b = 30, 3
    csr = random_graph(rng, n_ent=n_ent)
    keys = frontier_keys(rng, n_ent, b, 6)
    want_fr, got_fr = expand_both(csr, n_ent, keys, 256, 64, "bitmap", b)
    new_keys = got_fr.node_keys.numpy()
    present = set(new_keys.tolist())
    absent = [k for k in range(b * n_ent) if k not in present]
    # one absent key below every present one (prefix 0 -> -1), one in the
    # middle (prefix points at another node)
    old = np.array(sorted([absent[0], absent[len(absent) // 2],
                           *keys[:b].tolist()]) + [SMAX], np.int32)
    assert absent[0] < new_keys[0]
    vals = rng.normal(size=(len(old), 4)).astype(np.float32)
    want = np.asarray(jf.align_old_to_new(
        jnp.asarray(old), jnp.asarray(new_keys), jnp.asarray(vals), 64,
        key_prefix=jnp.asarray(want_fr.key_prefix)))
    got = tf.align_old_to_new(
        torch.from_numpy(old), got_fr.node_keys, torch.from_numpy(vals), 64,
        key_prefix=got_fr.key_prefix).numpy()
    np.testing.assert_array_equal(got, want)
    kept = np.isin(old, new_keys[new_keys != SMAX])
    assert kept.sum() == b and np.count_nonzero(got.any(1)) == b


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
