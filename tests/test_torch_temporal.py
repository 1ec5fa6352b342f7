"""The port's temporal slice vs the JAX package on the CPU: TemporalKG from
both loaders, the windowed and whole-timeline exact counts and caps,
TRedGNN scores, aux and strict gradients in both modes (sparse, dense,
windowed, leave-one-out, ablations, sort + the sorted-segment sum), the
flax msgpack decoder on the banked checkpoints. Tiny graphs (30 entities,
hidden 8), parameters carried by params_from_flax, dropout off wherever
the packages are compared (their RNG streams differ)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from redgnn_tpu.graph import calibrate as jcal
from redgnn_tpu.graph.temporal import TemporalKG as JKG
from redgnn_tpu.models import temporal as jtm
from redgnn_tpu_torch.graph import calibrate as tcal
from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models import temporal as ttm
from redgnn_tpu_torch.utils.checkpoint import load_msgpack, msgpack_restore
from redgnn_tpu_torch.utils.port_params import (
    params_from_flax,
    temporal_opt_state_from_optax,
)

from test_temporal import write_temporal_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_id_dir(path, rng, n_ent=30, n_rel=3, n_days=24, n=240,
                 granularity=24):
    """An id-based dir (`*_forecasting` style): entity2id / relation2id and
    5-column quadruples with hour stamps in steps of ``granularity``,
    train / valid / test in time order."""
    path.mkdir()
    (path / "entity2id.txt").write_text(
        "".join(f"e{i}\t{i}\n" for i in range(n_ent)))
    (path / "relation2id.txt").write_text(
        "".join(f"r{i}\t{i}\n" for i in range(n_rel)))
    w = 1.0 / np.arange(1, n_ent + 1) ** 0.7
    h = rng.choice(n_ent, n, p=w / w.sum())
    t = rng.integers(0, n_ent, n)
    r = rng.integers(0, n_rel, n)
    day = np.sort(rng.integers(0, n_days, n))
    cut = (int(n * 0.7), int(n * 0.85))
    for name, sl in (("train.txt", slice(0, cut[0])),
                     ("valid.txt", slice(cut[0], cut[1])),
                     ("test.txt", slice(cut[1], n))):
        (path / name).write_text("".join(
            f"{a}\t{b}\t{c}\t{d * granularity}\t0\n"
            for a, b, c, d in zip(h[sl], r[sl], t[sl], day[sl])))
    return str(path)


@pytest.fixture
def vocab_dir(tmp_path, rng):
    return str(write_temporal_dir(tmp_path, rng))


@pytest.fixture
def id_dir(tmp_path, rng):
    return write_id_dir(tmp_path / "toy_forecasting", rng)


# ------------------------------------------------------------- TemporalKG

def assert_kg_equal(got: TemporalKG, want: JKG):
    for name in ("n_ent", "n_rel", "n_time", "idd_rel", "n_facts",
                 "time_key_base"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.graph_quads, want.graph_quads)
    np.testing.assert_array_equal(got.row_to_slot, want.row_to_slot)
    assert got.splits.keys() == want.splits.keys()
    for k in want.splits:
        np.testing.assert_array_equal(got.splits[k], want.splits[k], k)
    for name in ("etime_np", "ekey_np", "selfloop_slot_np",
                 "time_rowptr_np"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    for a, b in zip(got.graph_np + got.dense_np, want.graph_np
                    + want.dense_np):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the device side holds the same arrays
    for t, w in [(getattr(got.graph, f), getattr(want.graph, f))
                 for f in ("rowptr", "rel", "tail")] + [
            (got.etime, want.etime), (got.ekey, want.ekey),
            (got.selfloop_slot, want.selfloop_slot),
            (got.time_rowptr, want.time_rowptr)] + list(
            zip(got.dense, want.dense)):
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    rows = np.arange(0, len(want.graph_quads), 7)
    np.testing.assert_array_equal(got.exclusion_slots(rows),
                                  want.exclusion_slots(rows))


@pytest.mark.parametrize("loader,kw", [
    ("vocab", {}),
    ("id", dict(time_granularity=24)),
    ("id", dict(time_granularity=24, graph_from_all_splits=True,
                warm_start_time=48)),
    ("id", dict(add_inverse=False, self_loops=False)),
], ids=["vocab", "id", "id_forecasting", "id_plain"])
def test_temporal_kg_matches_jax(vocab_dir, id_dir, loader, kw):
    if loader == "vocab":
        want = JKG.load_vocab_dir(vocab_dir)
        got = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
        assert got.entity_vocab.itos == want.entity_vocab.itos
        assert got.relation_vocab.stoi == want.relation_vocab.stoi
        assert got.time_vocab.itos == want.time_vocab.itos
        assert got.time_vocab("nowhere") == 1  # _UNK
    else:
        want = JKG.load_id_dir(id_dir, **kw)
        got = TemporalKG.load_id_dir(id_dir, device="cpu", **kw)
    assert_kg_equal(got, want)
    a1, *_ = got.model_args()
    assert a1 is got.graph and got.device.type == "cpu"


# ------------------------------------------------------------ counts, caps

@pytest.mark.parametrize("window", [3, 6, 120])
def test_windowed_counts_and_caps_match_jax(id_dir, window):
    kg = JKG.load_id_dir(id_dir, time_granularity=24,
                         graph_from_all_splits=True)
    args = (kg.ekey_np, kg.graph_np[2], kg.n_ent, kg.time_key_base)
    for split in ("train", "valid"):
        h, t = kg.splits[split][:, 0], kg.splits[split][:, 3]
        want = jcal.per_query_counts_windowed(*args, h, t, window, 3)
        got = tcal.per_query_counts_windowed(*args, h, t, window, 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for b in (8, 5):
            jc = jcal.caps_for_batches(*want, b)
            tc = tcal.caps_for_batches(*got, b)
            assert (tc.node_caps, tc.edge_caps) == (jc.node_caps,
                                                    jc.edge_caps)
    h, t = kg.splits["valid"][:, 0], kg.splits["valid"][:, 3]
    assert tcal.simulate_hops_windowed(*args, h[:8], t[:8], window, 3) == \
        jcal.simulate_hops_windowed(*args, h[:8], t[:8], window, 3)
    want = jcal.calibrate_caps_windowed(*args, h, t, window, 8, 3)
    got = tcal.calibrate_caps_windowed(*args, h, t, window, 8, 3)
    assert (got.node_caps, got.edge_caps) == (want.node_caps,
                                              want.edge_caps)


def test_whole_timeline_counts_match_jax(vocab_dir, monkeypatch):
    monkeypatch.setattr(tcal, "_bitmap_chunk", lambda n_ent: 7)
    kg = JKG.load_vocab_dir(vocab_dir)
    rowptr, _, tail = kg.graph_np
    heads = kg.splits["train"][:, 0]
    want = jcal.per_query_counts(rowptr, tail, kg.n_ent, heads, 4)
    got = tcal.per_query_counts_dense(rowptr, tail, kg.n_ent, heads, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the frontiers saturate: the regime the bitmap walk is for
    assert int(want[0][:, -1].max()) == len(np.unique(
        kg.graph_quads[:, [0, 2]]))


# ------------------------------------------------------------------ model

def test_periodic_embedding_matches_jax(rng):
    """|x| up to 365 days: z = 2π·c·x reaches tens of radians, where fp32
    sin / cos of XLA and torch differ in the last bits."""
    m = jtm.PeriodicTimeEmbedding(16, 48)
    x = (rng.uniform(-365, 365, 200)).astype(np.float32)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda p: p * 30.0, params)  # wide freqs
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    module = ttm.PeriodicTimeEmbedding(16, 48)
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in params.items()})
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    assert float(ttm.PeriodicTimeEmbedding(16).frequencies.abs().max()) \
        <= 0.03


B = 4


def model_case(kg, rng, mode="interpolation", n_layer=2, loo=False,
               exact_caps=True, **over):
    """(JAX config, params, batch arrays, caps) for a batch of B train
    quadruples with one padded query."""
    cfg = jtm.TemporalModelConfig(**{**dict(
        n_ent=kg.n_ent, n_rel_vocab=kg.n_rel + 1, idd_rel=kg.idd_rel,
        hidden_dim=8, attn_dim=5, n_layer=n_layer, dropout=0.0, mode=mode,
        time_key_base=kg.time_key_base, scan_src_backward=False,
        window=6 if mode == "extrapolation" else None), **over})
    rows = rng.permutation(len(kg.splits["train"]))[:B]
    data = kg.splits["train"][rows]  # train row = graph row (vocab dirs)
    subs, rels, objs, times = (data[:, j].astype(np.int32) for j in range(4))
    qmask = np.array([True] * (B - 1) + [False])
    if cfg.mode == "extrapolation" and cfg.window is not None:
        nc, ec = jcal.per_query_counts_windowed(
            kg.ekey_np, kg.graph_np[2], kg.n_ent, kg.time_key_base,
            subs, times, cfg.window, n_layer)
    else:
        nc, ec = jcal.per_query_counts(kg.graph_np[0], kg.graph_np[2],
                                       kg.n_ent, subs, n_layer)
    c = jcal.caps_for_batches(nc, ec, B)
    caps = (c.node_caps, c.edge_caps)
    excl = kg.exclusion_slots(rows).astype(np.int32) if loo else None
    return cfg, (subs, rels, objs, times, qmask), caps, excl


def jax_apply(kg, cfg, batch, caps, excl, params=None, time_rowptr=True):
    subs, rels, _, times, qmask = batch
    args = (kg.graph, kg.etime, jnp.asarray(subs), jnp.asarray(rels),
            jnp.asarray(times), jnp.asarray(qmask), jcal.FrontierCaps(*caps),
            None if excl is None else jnp.asarray(excl), False, kg.ekey,
            kg.selfloop_slot, kg.time_rowptr if time_rowptr else None,
            kg.dense)
    model = jtm.TRedGNN(cfg)
    if params is None:
        params = model.init({"params": jax.random.PRNGKey(3),
                             "dropout": jax.random.PRNGKey(4)},
                            *args)["params"]
    return params, args, model


def port_model(cfg, params):
    model = ttm.TRedGNN(ttm.TemporalModelConfig(**dataclasses.asdict(cfg)),
                        device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def port_apply(model, kg, batch, caps, excl, time_rowptr=True):
    subs, rels, _, times, qmask = (torch.from_numpy(a) for a in batch)
    return model(kg.graph, kg.etime, subs, rels, times, qmask,
                 FrontierCaps(*caps),
                 None if excl is None else torch.from_numpy(excl), False,
                 kg.ekey, kg.selfloop_slot,
                 kg.time_rowptr if time_rowptr else None, kg.dense)


MODEL_CASES = {
    # name: (mode, leave-one-out, time_rowptr gathers, config overrides,
    #        expected hop plan)
    "interp_sparse": ("interpolation", False, True, dict(dense_hops=False),
                      ["bitmap"] * 2),
    "interp_sparse_loo": ("interpolation", True, True,
                          dict(dense_hops=False), ["bitmap"] * 2),
    "interp_dense_loo": ("interpolation", True, True,
                         dict(dense_switch=0.4), None),
    "interp_dense_cumsum": ("interpolation", True, True,
                            dict(dense_switch=0.4, dense_agg="cumsum"), None),
    "interp_packed_gather": ("interpolation", False, True,
                             dict(scan_src_backward=True, dense_hops=False),
                             ["bitmap"] * 2),
    "extrap_window": ("extrapolation", False, True, {}, ["bitmap"] * 2),
    "extrap_window_search": ("extrapolation", False, False, {},
                             ["bitmap"] * 2),
    "extrap_no_window": ("extrapolation", False, True, dict(window=None),
                         ["bitmap"] * 2),
    "wo_time": ("interpolation", True, True,
                dict(use_time=False, dense_switch=0.4), None),
    "wo_attention": ("interpolation", False, True,
                     dict(use_attention=False, dense_switch=0.4), None),
    "bias_transform": ("interpolation", False, True,
                       dict(direction_transform="bias", dense_switch=0.4),
                       None),
    "absolute_time": ("interpolation", True, True,
                      dict(time_embedding="absolute", dense_switch=0.4),
                      None),
    "sort_pallas_interp": ("interpolation", True, True,
                           dict(dedup_impl="sort", segment_impl="pallas",
                                dense_switch=0.4), None),
    "sort_pallas_extrap": ("extrapolation", False, True,
                           dict(dedup_impl="sort", segment_impl="pallas"),
                           ["sort"] * 2),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_tredgnn_matches_jax(vocab_dir, rng, case):
    """Scores within atol 1e-5 and every aux count equal; in
    extrapolation the frontier keys equal and the frontier softmax within
    1e-6. JAX's Pallas kernel runs in interpret mode here."""
    mode, loo, trp, over, plan = MODEL_CASES[case]
    kg, jkg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu"), \
        JKG.load_vocab_dir(vocab_dir)
    if over.get("time_embedding") == "absolute":
        over = dict(over, n_time=kg.n_time)
    cfg, batch, caps, excl = model_case(jkg, rng, mode, loo=loo, **over)
    params, args, jmodel = jax_apply(jkg, cfg, batch, caps, excl,
                                     time_rowptr=trp)
    want, want_aux = jmodel.apply({"params": params}, *args)
    model = port_model(cfg, params)
    got_plan = ttm.temporal_hop_plan(model.cfg, kg.graph.n_edges,
                                     FrontierCaps(*caps), B, True)
    if plan is None:  # a sparse hop, then dense ones
        assert got_plan[0] != "dense" and "dense" in got_plan, got_plan
    else:
        assert got_plan == plan
    with torch.inference_mode():
        got, aux = port_apply(model, kg, batch, caps, excl, trp)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for k in ("edge_overflow", "node_overflow", "num_nodes", "num_edges"):
        np.testing.assert_array_equal(aux[k].numpy(),
                                      np.asarray(want_aux[k]), err_msg=k)
    if mode == "extrapolation":
        np.testing.assert_array_equal(aux["frontier_keys"].numpy(),
                                      np.asarray(want_aux["frontier_keys"]))
        np.testing.assert_allclose(aux["frontier_softmax"].numpy(),
                                   np.asarray(want_aux["frontier_softmax"]),
                                   atol=1e-6)


def _loss(scores, objs, qmask, xp):
    """nll_softmax_loss written once for both packages."""
    if xp is jnp:
        logp = jax.nn.log_softmax(scores, axis=1)
        p = jnp.exp(logp[jnp.arange(scores.shape[0]), objs])
        per = -jnp.log(p + 1e-12)
        return jnp.sum(jnp.where(qmask, per, 0.0)) / jnp.maximum(
            jnp.sum(qmask), 1)
    from redgnn_tpu_torch.train.temporal_loop import nll_softmax_loss
    return nll_softmax_loss(scores, objs, qmask)


@pytest.mark.parametrize("case", ["interp_dense_loo", "extrap_window",
                                  "sort_pallas_interp", "absolute_time"])
def test_tredgnn_gradients_match_jax(vocab_dir, rng, case):
    """Strict gradients (scan_src_backward=False) of the NLL loss within
    rtol 1e-4 + 1e-5·max|grad| for every parameter."""
    mode, loo, trp, over, _ = MODEL_CASES[case]
    kg, jkg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu"), \
        JKG.load_vocab_dir(vocab_dir)
    if over.get("time_embedding") == "absolute":
        over = dict(over, n_time=kg.n_time)
    cfg, batch, caps, excl = model_case(jkg, rng, mode, loo=loo, **over)
    params, args, jmodel = jax_apply(jkg, cfg, batch, caps, excl)
    objs, qmask = batch[2], batch[4]

    def jloss(p):
        s, _ = jmodel.apply({"params": p}, *args)
        return _loss(s, jnp.asarray(objs), jnp.asarray(qmask), jnp)

    want_loss, want = jax.value_and_grad(jloss)(params)
    model = port_model(cfg, params)
    scores, _ = port_apply(model, kg, batch, caps, excl)
    loss = _loss(scores, torch.from_numpy(objs), torch.from_numpy(qmask),
                 torch)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = params_from_flax(jax.device_get(want))
    nonzero = 0
    for name, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale + 1e-9,
                                   err_msg=name)
        nonzero += scale > 0
    assert nonzero >= len(want) - 3  # now/future/past may see no edge


def test_dropout_remat_and_refusals(vocab_dir, rng):
    kg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
    jkg = JKG.load_vocab_dir(vocab_dir)
    cfg, batch, caps, excl = model_case(jkg, rng, dropout=0.3,
                                        edge_dropout=0.2, dense_switch=0.4)
    params, _, _ = jax_apply(jkg, cfg, batch, caps, excl)
    plain = port_model(cfg, params)
    remat = port_model(dataclasses.replace(cfg, remat=True), params)
    subs, rels, objs, times, qmask = (torch.from_numpy(a) for a in batch)
    caps = FrontierCaps(*caps)

    def run(model, seed, train=True):
        model.zero_grad()
        s, _ = model(kg.graph, kg.etime, subs, rels, times, qmask, caps,
                     None, train, kg.ekey, kg.selfloop_slot, kg.time_rowptr,
                     kg.dense, generator=torch.Generator().manual_seed(seed))
        s.sum().backward()
        return s.detach(), [p.grad.clone() for p in model.parameters()
                            if p.grad is not None]

    a, ga = run(plain, 1)
    b, gb = run(plain, 1)
    c, _ = run(plain, 2)
    e, _ = run(plain, 1, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, e)
    # remat recomputes the sparse hops in the backward with the same masks
    r, gr = run(remat, 1)
    torch.testing.assert_close(r, a, rtol=0, atol=0)
    for x, y in zip(gr, ga):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="Generator"):
        plain(kg.graph, kg.etime, subs, rels, times, qmask, caps, None, True,
              kg.ekey, kg.selfloop_slot, kg.time_rowptr, kg.dense)
    # collect_alpha (ported) exposes each sparse hop's attention and leaves
    # the scores as they are
    collect = port_model(dataclasses.replace(cfg, collect_alpha=True),
                         params)
    with torch.no_grad():
        s_c, aux_c = collect(kg.graph, kg.etime, subs, rels, times, qmask,
                             caps, None, False, kg.ekey, kg.selfloop_slot,
                             kg.time_rowptr, kg.dense)
    torch.testing.assert_close(s_c, e, rtol=0, atol=0)
    n_sparse = sum(k != "dense" for k in ttm.temporal_hop_plan(
        collect.cfg, kg.graph.n_edges, caps, subs.shape[0], True))
    assert len(aux_c["alpha"]) == n_sparse >= 1
    assert all(((a >= 0) & (a <= 1)).all() for a in aux_c["alpha"])
    # bitmap dedup under the kernel is refused, as in the JAX package
    bad = ttm.TRedGNN(ttm.TemporalModelConfig(**dict(
        dataclasses.asdict(cfg), segment_impl="pallas", dense_hops=False)),
        device="cpu")
    with pytest.raises(ValueError, match="dst-sorted"):
        bad(kg.graph, kg.etime, subs, rels, times, qmask, caps)


# ----------------------------------------------------- banked checkpoints

CHECKPOINTS = {
    # file: (hidden, layers, mode, optimizer-state count)
    "icews14_temp_interp_ep1.msgpack": (20, 4, "interpolation", 4544),
    "icews14_forecasting_best.msgpack": (30, 3, "extrapolation", 12655),
}


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_banked_msgpack_checkpoint_decoded_and_loaded(name):
    """Every leaf bit-equal to flax's decoder; the parameters load into a
    full-width TRedGNN (ICEWS14: 7,128 entities, 230 relations doubled
    plus the self-loop, 462 table rows) with strict=True."""
    path = os.path.join(ROOT, "artifacts", name)
    with open(path, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    got = msgpack_restore(data)
    w_leaves, w_tree = jax.tree_util.tree_flatten(want)
    g_leaves, g_tree = jax.tree_util.tree_flatten(got)
    assert w_tree == g_tree
    for a, b in zip(g_leaves, w_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    d, n_layer, mode, count = CHECKPOINTS[name]
    state, epoch, _ = load_msgpack(path)
    assert epoch == int(want["_meta"][0])
    model = ttm.TRedGNN(ttm.TemporalModelConfig(
        n_ent=7128, n_rel_vocab=462, idd_rel=460, hidden_dim=d, attn_dim=30,
        n_layer=n_layer, mode=mode, window=120 if mode != "interpolation"
        else None), device="cpu")
    model.load_state_dict(params_from_flax(state["params"]), strict=True)
    assert model.time_w.shape == (96, d)
    opt = temporal_opt_state_from_optax(state["opt_state"])
    assert int(opt["count"]) == count and "acc_grads" in opt
    assert opt["mu"].keys() == model.state_dict().keys()
    np.testing.assert_array_equal(
        opt["nu"]["rela_embed_0"].numpy(),
        want["opt_state"]["inner_opt_state"]["inner_state"]["0"]["nu"][
            "rela_embed_0"])
