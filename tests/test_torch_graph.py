"""Port's graph host side, capacity calibration and config vs the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

from redgnn_tpu.graph import calibrate as jcal
from redgnn_tpu.graph import kg as jkg
from redgnn_tpu.utils import config as jcfg
from redgnn_tpu_torch.graph import calibrate as tcal
from redgnn_tpu_torch.graph import kg as tkg
from redgnn_tpu_torch.utils import config as tcfg

from test_train_loop import write_kg


def _triples(rng, n_ent=40, n=150, n_rel=4):
    return np.stack([rng.integers(0, n_ent, n), rng.integers(0, n_rel, n),
                     rng.integers(0, n_ent, n)], 1).astype(np.int64)


def test_build_csr_and_tail_sorted_equal(rng):
    n_ent = 40
    raw = _triples(rng)
    tri = jkg._add_self_loops(jkg._double(raw, 4), n_ent, 8)
    np.testing.assert_array_equal(
        tkg._add_self_loops(tkg._double(raw, 4), n_ent, 8), tri)
    want = jkg.build_csr(tri, n_ent)
    got = tkg.build_csr(tri, n_ent)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for w, g in zip(jkg.build_tail_sorted(*want, n_ent),
                    tkg.build_tail_sorted(*got, n_ent)):
        np.testing.assert_array_equal(g, w)


def _assert_graph_equal(tgraph, jgraph):
    """Every field the JAX graph has, equal; the port's own list of the
    dense hop's gather backward (``tsrc_order``, which JAX's graph lacks)
    is the stable order of the equal ``tsrc``."""
    for f in tkg.DeviceGraph.FIELDS:
        g = getattr(tgraph, f)
        assert g.dtype == torch.int32
        w = (tkg.build_src_order(np.asarray(jgraph.tsrc))
             if f == "tsrc_order" else getattr(jgraph, f))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def test_static_kg_load_equal(tmp_path, rng):
    d = str(write_kg(tmp_path, rng))
    want = jkg.StaticKG.load(d)
    got = tkg.StaticKG.load(d, device="cpu")
    assert (got.n_ent, got.n_rel, got.idd_rel) == \
        (want.n_ent, want.n_rel, want.idd_rel)
    assert got.entity2id == want.entity2id
    assert got.relation2id == want.relation2id
    for f in ("fact", "train", "valid", "test", "train_data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.filters.keys() == want.filters.keys()
    for k in want.filters:
        np.testing.assert_array_equal(got.filters[k], want.filters[k])
    for w, g in zip(want.graph_np, got.graph_np):
        np.testing.assert_array_equal(g, w)
    _assert_graph_equal(got.graph, want.graph)
    _assert_graph_equal(got.eval_graph, want.eval_graph)

    for split in ("valid", "test"):
        ws, gs = want.eval_spec(split), got.eval_spec(split)
        np.testing.assert_array_equal(gs.queries, ws.queries)
        assert len(gs.answers) == len(ws.answers)
        for a, b in zip(gs.answers, ws.answers):
            np.testing.assert_array_equal(a, b)
        assert gs.n_ent == ws.n_ent
        for w, g in zip(ws.graph_np, gs.graph_np):
            np.testing.assert_array_equal(g, w)


def test_load_defaults_to_cuda(tmp_path, rng):
    d = str(write_kg(tmp_path, rng))
    if torch.cuda.is_available():
        assert tkg.StaticKG.load(d).eval_graph.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tkg.StaticKG.load(d)


@pytest.mark.parametrize("b,n_layer,headroom", [(4, 2, 1.2), (8, 3, 1.0),
                                                (16, 3, 1.5)])
def test_calibrate_caps_equal(rng, b, n_layer, headroom):
    n_ent = 40
    tri = jkg._add_self_loops(jkg._double(_triples(rng, n_ent), 4), n_ent, 8)
    rowptr, _, tail = jkg.build_csr(tri, n_ent)
    heads = rng.integers(0, n_ent, 50)
    want = jcal.calibrate_caps(rowptr, tail, n_ent, heads, b, n_layer,
                               headroom=headroom)
    got = tcal.calibrate_caps(rowptr, tail, n_ent, heads, b, n_layer,
                              headroom=headroom)
    assert (got.node_caps, got.edge_caps) == (want.node_caps, want.edge_caps)

    def counts(fn):
        return [[int(c) for c in x]
                for x in fn(rowptr, tail, n_ent, heads[:b], n_layer)]

    assert counts(tcal.simulate_hops) == counts(jcal.simulate_hops)
    assert tcal._round_up(257) == jcal._round_up(257) == 512


def test_config_registry_equal():
    assert jcfg.DATASET_CONFIGS.keys() == tcfg.DATASET_CONFIGS.keys()
    for task, table in jcfg.DATASET_CONFIGS.items():
        assert table.keys() == tcfg.DATASET_CONFIGS[task].keys()
        for name in list(table) + ["not_in_the_registry"]:
            assert dataclasses.asdict(tcfg.dataset_config(task, name)) == \
                dataclasses.asdict(jcfg.dataset_config(task, name))
    assert len(tcfg.DATASET_CONFIGS["temporal"]) == 6
    assert [f.name for f in dataclasses.fields(tcfg.TemporalTrainConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.TemporalTrainConfig)]
    got = tcfg.dataset_config("static_transductive", "family",
                              segment_impl="pallas", dense_hops=False)
    assert (got.hidden_dim, got.attn_dim, got.n_layer, got.act,
            got.n_tbatch, got.segment_impl, got.dense_hops) == \
        (48, 5, 3, "relu", 50, "pallas", False)
