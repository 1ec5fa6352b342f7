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


def jax_model(rng, n_layer, segment_impl, b=4):
    """(csr, JAX model config, params, inputs) for a tiny batch with one
    padded query."""
    csr = make_csr(rng)
    cfg = jmodel.ModelConfig(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D,
                             attn_dim=A, n_layer=n_layer, dropout=0.0,
                             segment_impl=segment_impl, dedup_impl="sort",
                             dense_hops=False)
    subs = rng.integers(0, N_ENT, b).astype(np.int32)
    rels = rng.integers(0, 2 * N_REL, b).astype(np.int32)
    qmask = np.array([True] * (b - 1) + [False])
    caps = ((b,) + (256,) * n_layer, (1024,) * n_layer)
    graph = JGraph.from_csr(*csr, N_ENT)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    params = jmodel.RedGNN(cfg).init(
        {"params": key, "dropout": key}, graph, jnp.asarray(subs),
        jnp.asarray(rels), jnp.asarray(qmask), JCaps(*caps), False)["params"]
    return csr, cfg, params, (subs, rels, qmask, caps)


def port_model(jcfg, params):
    cfg = tmodel.ModelConfig(
        n_ent=jcfg.n_ent, n_rel=jcfg.n_rel, hidden_dim=jcfg.hidden_dim,
        attn_dim=jcfg.attn_dim, n_layer=jcfg.n_layer,
        segment_impl=jcfg.segment_impl, dedup_impl=jcfg.dedup_impl,
        dense_hops=jcfg.dense_hops)
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


def test_dense_plan_and_bitmap_raise(rng):
    csr, jcfg, params, (subs, rels, qmask, caps) = jax_model(rng, 2, "xla")
    graph = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    args = (graph, torch.from_numpy(subs), torch.from_numpy(rels),
            torch.from_numpy(qmask), FrontierCaps(*caps))
    dense = port_model(dataclasses.replace(jcfg, dense_hops=True), params)
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                               match="dense"):
        dense(*args)
    # 'auto' with the xla segment sum picks bitmap dedup here (key space
    # 4 * 25 <= 16 * edge cap), which is not ported
    bitmap = port_model(dataclasses.replace(jcfg, dedup_impl="auto"), params)
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                               match="bitmap"):
        bitmap(*args)
    assert tmodel._resolve_dedup("auto", 100, 1024, "pallas") == \
        jmodel._resolve_dedup("auto", 100, 1024, "pallas") == "sort"


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
