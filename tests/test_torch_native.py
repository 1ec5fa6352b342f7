"""The port's native walker (`redgnn_tpu_torch.native`, its own copy of
``graphcore.cpp``) against the JAX package's bindings of the same library
(`redgnn_tpu.native`) and against the port's plain walkers: the numpy edge
walk (`graph/calibrate._walk`) and the scipy bitmap walks. Counts are
integers: every comparison is exact. Edge cases: no heads, no hops,
heads with no edges, an empty window (time 0) and a window that covers
the whole timeline."""

import numpy as np
import pytest

from redgnn_tpu import native as jnative
from redgnn_tpu_torch import _build, native
from redgnn_tpu_torch.graph import calibrate as tcal
from redgnn_tpu_torch.graph.kg import build_csr
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.train import temporal_loop
from redgnn_tpu_torch.utils.config import TemporalTrainConfig

from test_temporal import write_temporal_dir

N_ENT = 40


@pytest.fixture(scope="module")
def jlib():
    """The JAX package's build of its own graphcore.cpp."""
    assert jnative.available(), "the JAX package's native build failed"
    return jnative._load()


def static_graph(rng, n_edges=300):
    """Random triples with self-loops on all but the last 5 entities,
    which keep no edge at all (isolated heads)."""
    h = rng.integers(0, N_ENT - 5, n_edges)
    r = rng.integers(0, 6, n_edges)
    t = rng.integers(0, N_ENT, n_edges)
    ents = np.arange(N_ENT - 5)
    tri = np.concatenate([np.stack([h, r, t], 1),
                          np.stack([ents, np.full(len(ents), 6), ents], 1)])
    return tri


def temporal_arrays(rng, n_edges=400, n_time=30):
    """(quads, ekey, tail, key_base): quadruples sorted by (head, time)
    as a TemporalKG keys them."""
    quads = np.stack([rng.integers(0, N_ENT - 5, n_edges),
                      rng.integers(0, 6, n_edges),
                      rng.integers(0, N_ENT, n_edges),
                      rng.integers(0, n_time, n_edges)], 1)
    order = np.lexsort((quads[:, 3], quads[:, 0]))
    key_base = n_time + 1
    s = quads[order]
    ekey = (s[:, 0] * key_base + s[:, 3]).astype(np.int32)
    return quads, ekey, s[:, 2].astype(np.int32), key_base


HEADS = {"some": lambda rng: rng.integers(0, N_ENT, 12),
         "isolated": lambda rng: np.array([N_ENT - 1, N_ENT - 2, 0]),
         "none": lambda rng: np.zeros(0, np.int64)}


def test_build_csr_matches_jax_and_numpy(rng, jlib):
    tri = static_graph(rng)
    got = native.build_csr(tri, N_ENT)
    want = jnative.build_csr(tri, N_ENT)
    ref = build_csr(tri, N_ENT)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="build_csr returned 1"):
        native.build_csr(np.array([[N_ENT, 0, 1]]), N_ENT)


def test_build_csr_temporal_matches_jax_and_numpy(rng, jlib):
    quads, ekey, tail, key_base = temporal_arrays(rng)
    rowptr, rel, tl, time, perm = native.build_csr_temporal(quads, N_ENT)
    # the JAX package binds no wrapper: its library's C function itself
    n = len(quads)
    want = [np.zeros(N_ENT + 1, np.int32)] + [np.zeros(n, np.int32)
                                              for _ in range(4)]
    assert jlib.build_csr_temporal(np.ascontiguousarray(quads, np.int64),
                                   n, N_ENT, *want) == 0
    for g, w in zip((rowptr, rel, tl, time, perm), want):
        np.testing.assert_array_equal(g, w)
    order = np.lexsort((quads[:, 3], quads[:, 0]))  # stable in (head, time)
    np.testing.assert_array_equal(tl, quads[order, 2])
    np.testing.assert_array_equal(time, quads[order, 3])
    np.testing.assert_array_equal(rel, quads[order, 1])
    np.testing.assert_array_equal(perm[order], np.arange(n))
    np.testing.assert_array_equal(
        rowptr, np.concatenate([[0], np.cumsum(np.bincount(
            quads[:, 0], minlength=N_ENT))]))
    np.testing.assert_array_equal(tl, tail)
    with pytest.raises(ValueError, match="returned 1"):
        native.build_csr_temporal(np.array([[-1, 0, 1, 2]]), N_ENT)


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("n_layer", [0, 1, 3])
def test_static_walks_match_jax_and_numpy(rng, jlib, heads, n_layer):
    """simulate_hops and per_query_hop_counts (and calibrate's
    per_query_counts, which takes them) against the JAX package's bindings
    and the numpy edge walk."""
    rowptr, _, tail = build_csr(static_graph(rng), N_ENT)
    h = HEADS[heads](rng)
    nc, ec = native.per_query_hop_counts(rowptr, tail, N_ENT, h, n_layer)
    assert nc.shape == (len(h), n_layer + 1) and ec.shape == (len(h),
                                                              n_layer)
    want = jnative.per_query_hop_counts(rowptr, tail, N_ENT, h, n_layer)
    ref = tcal._walk(rowptr, tail, N_ENT, np.asarray(h, np.int64), n_layer)
    for g, w, r in zip((nc, ec), want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    for g, r in zip(tcal.per_query_counts(rowptr, tail, N_ENT, h, n_layer),
                    tcal.per_query_counts_numpy(rowptr, tail, N_ENT, h,
                                                n_layer)):
        np.testing.assert_array_equal(g, r)
    hops = native.simulate_hops(rowptr, tail, N_ENT, h, n_layer)
    assert hops == jnative.simulate_hops(rowptr, tail, N_ENT, h, n_layer)
    assert hops == (ref[0].sum(0).tolist(), ref[1].sum(0).tolist())
    assert tcal.simulate_hops(rowptr, tail, N_ENT, h, n_layer) == hops
    if heads == "isolated":  # no edge out of the first two heads
        assert ec[:2].sum() == 0 and (nc[:2, 1:] == 0).all()


@pytest.mark.parametrize("when", ["some", "empty_window", "whole_timeline"])
@pytest.mark.parametrize("n_layer", [0, 2])
def test_windowed_walks_match_jax_and_bitmap(rng, jlib, when, n_layer):
    """simulate_hops_windowed and per_query_hop_counts_windowed against
    the JAX package's bindings and the port's bitmap walk: queries at
    random times, at time 0 (an empty window: every node keeps only its
    self-loop) and with a window longer than the timeline."""
    _, ekey, tail, key_base = temporal_arrays(rng)
    h = np.concatenate([rng.integers(0, N_ENT, 10), [N_ENT - 1]])
    t = {"some": rng.integers(0, key_base, len(h)),
         "empty_window": np.zeros(len(h), np.int64),
         "whole_timeline": np.full(len(h), key_base - 1)}[when]
    window = key_base + 5 if when == "whole_timeline" else 7
    args = (ekey, tail, N_ENT, key_base, h, t, window, n_layer)
    nc, ec = native.per_query_hop_counts_windowed(*args)
    want = jnative.per_query_hop_counts_windowed(*args)
    ref = tcal.per_query_counts_windowed(*args)
    for g, w, r in zip((nc, ec), want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    for g, r in zip(tcal.per_query_counts_windowed_native(*args), ref):
        np.testing.assert_array_equal(g, r)
    hops = native.simulate_hops_windowed(*args)
    assert hops == jnative.simulate_hops_windowed(*args)
    assert hops == (ref[0].sum(0).tolist(), ref[1].sum(0).tolist())
    if when == "empty_window" and n_layer:
        assert (nc == 1).all() and (ec == 1).all()  # the self-loop alone


def test_out_of_range_inputs_raise(rng):
    """A head outside [0, n_ent) raises ValueError, from the library's
    return code or, where the library does not check, before the call; so
    do a time outside the key base, a negative window and a broken
    CSR."""
    rowptr, _, tail = build_csr(static_graph(rng), N_ENT)
    _, ekey, etail, kb = temporal_arrays(rng)
    with pytest.raises(ValueError, match="per_query_hop_counts returned 1"):
        native.per_query_hop_counts(rowptr, tail, N_ENT, [0, N_ENT], 2)
    with pytest.raises(ValueError, match="returned 1"):
        native.per_query_hop_counts_windowed(ekey, etail, N_ENT, kb, [-1],
                                             [3], 5, 2)
    with pytest.raises(ValueError, match="head out of range"):
        native.simulate_hops(rowptr, tail, N_ENT, [N_ENT + 3], 2)
    with pytest.raises(ValueError, match="head out of range"):
        native.simulate_hops_windowed(ekey, etail, N_ENT, kb, [-2], [1], 5,
                                      2)
    with pytest.raises(ValueError, match="time out of range"):
        native.simulate_hops_windowed(ekey, etail, N_ENT, kb, [1], [kb], 5,
                                      2)
    with pytest.raises(ValueError, match="window"):
        native.per_query_hop_counts_windowed(ekey, etail, N_ENT, kb, [1],
                                             [3], -1, 2)
    with pytest.raises(ValueError, match="rowptr"):
        native.simulate_hops(rowptr[:-1], tail, N_ENT, [0], 2)
    with pytest.raises(ValueError, match="tail out of range"):
        native.per_query_hop_counts(rowptr, tail + N_ENT, N_ENT, [0], 2)


def test_library_built_once():
    """The library is built into _build/ under a name that carries its
    source's hash; a second build and a second load reuse it."""
    first = _build.build_host("graphcore")
    again = _build.build_host("graphcore")
    assert again["path"] == first["path"] and again["seconds"] == 0.0
    assert first["path"].startswith(_build.BUILD_DIR)
    assert "graphcore-" in first["path"] and first["path"].endswith(".so")
    assert native.library() is native.library()


def test_temporal_kg_hands_over_its_keys(tmp_path):
    """A TemporalKG's own int32 keys and key base reach the windowed
    walker; the trainer's route (temporal_loop.query_counts, the bitmap
    walk) gives the counts of both walkers, windowed and over the whole
    timeline."""
    d = tmp_path / "tkg"
    d.mkdir()
    write_temporal_dir(d, np.random.default_rng(3))
    kg = TemporalKG.load_vocab_dir(str(d), device="cpu")
    assert kg.ekey_np.dtype == np.int32
    data = kg.splits["test"]
    for mode, window in (("interpolation", None), ("extrapolation", 4)):
        cfg = TemporalTrainConfig(mode=mode, window=window, n_layer=2)
        got = temporal_loop.query_counts(kg, cfg, data)
        if window is None:
            walks = (tcal.per_query_counts, tcal.per_query_counts_dense)
            args = (kg.graph_np[0], kg.graph_np[2], kg.n_ent, data[:, 0], 2)
        else:
            walks = (tcal.per_query_counts_windowed_native,
                     tcal.per_query_counts_windowed)
            args = (kg.ekey_np, kg.graph_np[2], kg.n_ent, kg.time_key_base,
                    data[:, 0], data[:, 3], window, 2)
        for walk in walks:
            for g, w in zip(got, walk(*args)):
                np.testing.assert_array_equal(g, w)
