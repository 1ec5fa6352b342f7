"""Port's RedGNN, RelAttnLayer and GRUGate vs the JAX package's, with the
parameters carried over by params_from_flax. Dropout is off (inference);
atol=1e-5 is the bound tests/test_pallas_model.py uses."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from redgnn_tpu.graph.calibrate import FrontierCaps as JCaps
from redgnn_tpu.graph.kg import DeviceGraph as JGraph
from redgnn_tpu.graph.kg import build_csr
from redgnn_tpu.models import layers as jlayers
from redgnn_tpu.models import redgnn as jmodel
from redgnn_tpu.ops.frontier import expand_frontier as jexpand
from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph
from redgnn_tpu_torch.models import layers as tlayers
from redgnn_tpu_torch.models import redgnn as tmodel
from redgnn_tpu_torch.ops.frontier import Frontier
from redgnn_tpu_torch.utils.port_params import params_from_flax

N_ENT, N_REL, D, A = 25, 4, 16, 5


def make_csr(rng, n_edges=100):
    h = rng.integers(0, N_ENT, n_edges)
    r = rng.integers(0, 2 * N_REL, n_edges)
    t = rng.integers(0, N_ENT, n_edges)
    ents = np.arange(N_ENT)
    idd = np.stack([ents, np.full(N_ENT, 2 * N_REL), ents], 1)
    return build_csr(np.concatenate([np.stack([h, r, t], 1), idd], 0), N_ENT)


def jax_model(rng, n_layer, segment_impl, b=4, edge_caps=None, **cfg_over):
    """(csr, JAX model config, params, inputs) for a tiny batch with one
    padded query. Sort dedup and sparse hops unless ``cfg_over`` says
    otherwise."""
    csr = make_csr(rng)
    cfg = jmodel.ModelConfig(**{**dict(
        n_ent=N_ENT, n_rel=N_REL, hidden_dim=D, attn_dim=A, n_layer=n_layer,
        dropout=0.0, segment_impl=segment_impl, dedup_impl="sort",
        dense_hops=False), **cfg_over})
    subs = rng.integers(0, N_ENT, b).astype(np.int32)
    rels = rng.integers(0, 2 * N_REL, b).astype(np.int32)
    qmask = np.array([True] * (b - 1) + [False])
    caps = ((b,) + (256,) * n_layer, edge_caps or (1024,) * n_layer)
    graph = JGraph.from_csr(*csr, N_ENT)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    params = jmodel.RedGNN(cfg).init(
        {"params": key, "dropout": key}, graph, jnp.asarray(subs),
        jnp.asarray(rels), jnp.asarray(qmask), JCaps(*caps), False)["params"]
    return csr, cfg, params, (subs, rels, qmask, caps)


def port_model(jcfg, params):
    # every field of the port's config has the JAX package's name
    cfg = tmodel.ModelConfig(**{f.name: getattr(jcfg, f.name) for f in
                                dataclasses.fields(tmodel.ModelConfig)})
    model = tmodel.RedGNN(cfg, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


@pytest.mark.parametrize("segment_impl,n_layer", [("pallas", 2),
                                                  ("pallas", 3),
                                                  ("xla", 3)])
def test_redgnn_scores_and_aux_match(rng, segment_impl, n_layer):
    csr, jcfg, params, (subs, rels, qmask, caps) = jax_model(
        rng, n_layer, segment_impl)
    want, want_aux = jmodel.RedGNN(jcfg).apply(
        {"params": params}, JGraph.from_csr(*csr, N_ENT), jnp.asarray(subs),
        jnp.asarray(rels), jnp.asarray(qmask), JCaps(*caps), False)
    model = port_model(jcfg, params)
    with torch.inference_mode():
        got, aux = model(DeviceGraph.from_csr(*csr, N_ENT, device="cpu"),
                         torch.from_numpy(subs), torch.from_numpy(rels),
                         torch.from_numpy(qmask), FrontierCaps(*caps))
    assert got.shape == (4, N_ENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert np.all(got.numpy()[3] == 0)  # padded query scores nothing
    for k in ("edge_overflow", "node_overflow", "num_nodes", "num_edges"):
        np.testing.assert_array_equal(aux[k].numpy(),
                                      np.asarray(want_aux[k]), err_msg=k)


def run_both(csr, jcfg, params, inputs):
    """(JAX scores, JAX aux, port scores, port aux) of one inference
    call."""
    subs, rels, qmask, caps = inputs
    want, want_aux = jmodel.RedGNN(jcfg).apply(
        {"params": params}, JGraph.from_csr(*csr, N_ENT), jnp.asarray(subs),
        jnp.asarray(rels), jnp.asarray(qmask), JCaps(*caps), False)
    with torch.inference_mode():
        got, aux = port_model(jcfg, params)(
            DeviceGraph.from_csr(*csr, N_ENT, device="cpu"),
            torch.from_numpy(subs), torch.from_numpy(rels),
            torch.from_numpy(qmask), FrontierCaps(*caps))
    return np.asarray(want), want_aux, got.numpy(), aux


def assert_aux_equal(aux, want_aux):
    for k in ("edge_overflow", "node_overflow", "num_nodes", "num_edges"):
        assert aux[k].numpy().dtype == np.asarray(want_aux[k]).dtype, k
        np.testing.assert_array_equal(aux[k].numpy(),
                                      np.asarray(want_aux[k]), err_msg=k)


# The registry's defaults on a KG small enough to saturate: with b = 4,
# 25 entities and 125 edges, edge caps (64, 256, 1024, 1024) and
# dense_switch 0.6 give two sparse hops and then two dense ones.
DEFAULTS = dict(dedup_impl="auto", dense_hops=True, dense_switch=0.6)
DEFAULT_EDGE_CAPS = (64, 256, 1024, 1024)


def plan(jcfg, csr, caps, b=4):
    """The port's hop plan for a JAX config (same field names)."""
    return tmodel.hop_plan(jcfg, DeviceGraph.from_csr(*csr, N_ENT,
                                                      device="cpu"),
                           FrontierCaps(*caps), b)


@pytest.mark.parametrize("dense_agg", ["sorted_scatter", "cumsum"])
@pytest.mark.parametrize("segment_impl", ["xla", "pallas"])
def test_redgnn_registry_defaults_match(rng, segment_impl, dense_agg):
    """dedup 'auto' + dense hops, through bitmap (xla) or sort (pallas)
    sparse hops and then dense hops: scores atol 1e-5, aux equal."""
    csr, jcfg, params, inputs = jax_model(
        rng, 4, segment_impl, edge_caps=DEFAULT_EDGE_CAPS,
        dense_agg=dense_agg, **DEFAULTS)
    sparse = "bitmap" if segment_impl == "xla" else "sort"
    assert plan(jcfg, csr, inputs[3]) == \
        [sparse, sparse, "dense", "dense"]
    want, want_aux, got, aux = run_both(csr, jcfg, params, inputs)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want[:3]).max() > 1e-3 and np.all(got[3] == 0)
    assert_aux_equal(aux, want_aux)
    assert not aux["edge_overflow"].any() and not aux["node_overflow"].any()


@pytest.mark.parametrize("scan_src_backward", [True, False])
def test_redgnn_bitmap_hops_only_match(rng, scan_src_backward):
    """All hops bitmap (no dense plan): the packed gather or the plain
    one feeds the layer; sparse scoring."""
    csr, jcfg, params, inputs = jax_model(
        rng, 3, "xla", dedup_impl="bitmap",
        scan_src_backward=scan_src_backward)
    want, want_aux, got, aux = run_both(csr, jcfg, params, inputs)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert_aux_equal(aux, want_aux)


@pytest.mark.parametrize("agg", ["sorted_scatter", "cumsum"])
@pytest.mark.parametrize("segment_impl", ["xla", "pallas", "scan"])
def test_dense_hops_match_sparse_in_port(rng, segment_impl, agg):
    """Dense-mode hops == the sparse frontier path, inside the port
    (tests/test_model_static.py's bound: rtol 2e-4, atol 3e-5)."""
    csr = make_csr(rng)
    base = tmodel.ModelConfig(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D,
                              attn_dim=A, n_layer=3, dropout=0.0,
                              segment_impl=segment_impl)
    sparse_m = tmodel.RedGNN(dataclasses.replace(base, dense_hops=False),
                             device="cpu")
    dense_m = tmodel.RedGNN(dataclasses.replace(
        base, dense_hops=True, dense_switch=0.0, dense_agg=agg), device="cpu")
    dense_m.load_state_dict(sparse_m.state_dict())
    b = 6
    args = (DeviceGraph.from_csr(*csr, N_ENT, device="cpu"),
            torch.from_numpy(rng.integers(0, N_ENT, b).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 2 * N_REL, b).astype(np.int32)),
            torch.tensor([True] * (b - 2) + [False] * 2),
            FrontierCaps((b, 256, 256, 256), (1024,) * 3))
    with torch.inference_mode():
        s_scores, s_aux = sparse_m(*args)
        d_scores, d_aux = dense_m(*args)
    np.testing.assert_allclose(d_scores.numpy(), s_scores.numpy(),
                               rtol=2e-4, atol=3e-5)
    assert torch.equal(d_aux["num_nodes"], s_aux["num_nodes"])
    assert torch.equal(d_aux["num_edges"], s_aux["num_edges"])


def test_dense_plan_and_bitmap_raise(rng):
    """The two configurations that used to raise (the name dates from
    then) run and equal the JAX package: dense hops from hop 0 over sort
    dedup, and 'auto' picking bitmap dedup with the plain segment sum."""
    csr, jcfg, params, inputs = jax_model(rng, 2, "xla")
    dense = dataclasses.replace(jcfg, dense_hops=True)
    assert plan(dense, csr, inputs[3]) == ["dense"] * 2
    want, want_aux, got, aux = run_both(csr, dense, params, inputs)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert_aux_equal(aux, want_aux)
    # key space 4 * 25 <= 16 * edge cap
    bitmap = dataclasses.replace(jcfg, dedup_impl="auto")
    assert plan(bitmap, csr, inputs[3]) == ["bitmap"] * 2
    want, want_aux, got, aux = run_both(csr, bitmap, params, inputs)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert_aux_equal(aux, want_aux)
    assert tmodel._resolve_dedup("auto", 100, 1024, "pallas") == \
        jmodel._resolve_dedup("auto", 100, 1024, "pallas") == "sort"


def test_graph_without_dense_view_stays_sparse(rng):
    """A DeviceGraph built without the tail-sorted view disables the
    dense plan, as in the JAX package."""
    csr, jcfg, params, inputs = jax_model(rng, 2, "xla", dense_hops=True)
    subs, rels, qmask, caps = inputs
    model = port_model(jcfg, params)
    bare = DeviceGraph(*(torch.from_numpy(a) for a in csr))
    assert not bare.has_dense and bare.n_ent == N_ENT
    with torch.inference_mode():
        got, aux = model(bare, torch.from_numpy(subs), torch.from_numpy(rels),
                         torch.from_numpy(qmask), FrontierCaps(*caps))
        want, _ = port_model(dataclasses.replace(jcfg, dense_hops=False),
                             params)(
            DeviceGraph.from_csr(*csr, N_ENT, device="cpu"),
            torch.from_numpy(subs), torch.from_numpy(rels),
            torch.from_numpy(qmask), FrontierCaps(*caps))
    assert torch.equal(got, want)


@pytest.mark.parametrize("segment_impl", ["pallas", "xla"])
def test_rel_attn_layer_matches(rng, segment_impl):
    csr, jcfg, params, (subs, rels, qmask, caps) = jax_model(
        rng, 1, segment_impl)
    keys = np.where(qmask, np.arange(4) * N_ENT + subs,
                    np.iinfo(np.int32).max).astype(np.int32)
    fr = jexpand(*(jnp.asarray(a) for a in csr), N_ENT, jnp.asarray(keys),
                 1024, 256, dedup_impl="sort")
    hidden = rng.normal(size=(4, D)).astype(np.float32)
    layer = jlayers.RelAttnLayer(hidden_dim=D, attn_dim=A, n_rel=N_REL,
                                 segment_impl=segment_impl)
    want = layer.apply({"params": params["layer_0"]}, jnp.asarray(hidden),
                       jnp.asarray(rels), fr, 256)

    tl = tlayers.RelAttnLayer(D, A, N_REL, segment_impl=segment_impl)
    sd = params_from_flax(jax.device_get(params))
    tl.load_state_dict({k[len("layer_0."):]: v for k, v in sd.items()
                        if k.startswith("layer_0.")})
    tfr = Frontier(*(None if x is None else torch.from_numpy(np.array(x))
                     for x in fr))
    with torch.inference_mode():
        got = tl(torch.from_numpy(hidden), torch.from_numpy(rels), tfr, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gru_gate_matches(rng):
    d = 8
    x = rng.normal(size=(6, d)).astype(np.float32)
    h = rng.normal(size=(6, d)).astype(np.float32)
    gate = jlayers.GRUGate(d)
    p = gate.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(h))
    want = gate.apply(p, jnp.asarray(x), jnp.asarray(h))
    tg = tlayers.GRUGate(d)
    g = jax.device_get(p["params"])
    tg.load_state_dict({
        "weight_ih": torch.from_numpy(np.asarray(g["w_ih"]).T.copy()),
        "weight_hh": torch.from_numpy(np.asarray(g["w_hh"]).T.copy()),
        "bias_ih": torch.from_numpy(np.array(g["b_ih"])),
        "bias_hh": torch.from_numpy(np.array(g["b_hh"]))})
    with torch.inference_mode():
        got = tg(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_params_from_flax_covers_state_dict(rng):
    _, jcfg, params, _ = jax_model(rng, 3, "pallas")
    sd = params_from_flax(jax.device_get(params))
    model = port_model(jcfg, params)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape, k


def test_init_bounds_and_seed():
    cfg = tmodel.ModelConfig(n_ent=10, n_rel=3, hidden_dim=D, attn_dim=A,
                             n_layer=2)
    a = tmodel.RedGNN(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(7))
    b = tmodel.RedGNN(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(7))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
        if k.endswith("rela_embed"):
            assert v.shape == (2 * 3 + 1, D)
            continue
        fan_in = A if "w_alpha" in k else D
        assert v.abs().max() <= 1 / math.sqrt(fan_in), k
