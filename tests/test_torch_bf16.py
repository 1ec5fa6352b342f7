"""bfloat16 compute (``compute_dtype="bfloat16"``) in the port against the
JAX package's bf16 path on the CPU, on the same numpy inputs with the
parameters carried over by params_from_flax. Dropout is off.

The JAX functions are compiled with ``xla_allow_excess_precision`` off
(`jit_rounded`), so that every bf16 value is rounded where the source
writes it, as it is when they run op by op. With the flag on (XLA's
default) the CPU compiler drops float32 -> bf16 -> float32 round trips:
the jitted bf16 model then lies 2.9e-3 of the row's largest |score| off
its own op-by-op run (measured on test_redgnn_bf16_matches_jax's sort
case), 2.5e-7 with the flag off. The port rounds where the source does.

Tolerances, measured on these inputs before they were set:
- Layer outputs and scores: the gathered rows are the same bf16 values in
  both packages and everything after them is float32, so the two differ
  by float32 summation order (measured up to 5e-7 of the row's largest
  |score|) unless such a difference flips a bf16 rounding in a later hop.
  Held to SCORE_TOL = 1e-3 of the row's largest |score|: a few flips'
  worth.
- Gradients: the JAX package sums the cotangents of its bf16 gathers in
  bf16 (and rounds each sum to bf16); the port sums them in float32
  (`ops/gather.py`). On graphs where no row is gathered more than ~30
  times the two differ by up to 6.7e-3 of a parameter's largest |grad|
  (measured); held to GRAD_TOL = 2e-2 of it.
- Against the port's own float32 model: atol and rtol 5e-2, the bound of
  the JAX package's own bf16 test (tests/test_model_static.py)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redgnn_tpu.graph.calibrate import FrontierCaps as JCaps
from redgnn_tpu.graph.kg import DeviceGraph as JGraph
from redgnn_tpu.graph.kg import StaticKG as JKG
from redgnn_tpu.models import layers as jlayers
from redgnn_tpu.models import redgnn as jmodel
from redgnn_tpu.ops import gather as jgather
from redgnn_tpu.ops.frontier import expand_frontier as jexpand
from redgnn_tpu.train import loop as jloop
from redgnn_tpu.utils.config import TrainConfig as JConfig
from redgnn_tpu_torch.cli.train import main as cli_main
from redgnn_tpu_torch.graph import calibrate as tcal
from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph, StaticKG
from redgnn_tpu_torch.models import layers as tlayers
from redgnn_tpu_torch.models import redgnn as tmodel
from redgnn_tpu_torch.ops import gather as tgather
from redgnn_tpu_torch.ops.frontier import SENTINEL
from redgnn_tpu_torch.ops.frontier import expand_frontier as texpand
from redgnn_tpu_torch.parallel.launch import run_mesh
from redgnn_tpu_torch.serve import Predictor
from redgnn_tpu_torch.train import loop as tloop
from redgnn_tpu_torch.utils.config import TrainConfig
from redgnn_tpu_torch.utils.port_params import params_from_flax

import torch_mesh_workers as W
from test_torch_model import (
    A,
    D,
    DEFAULT_EDGE_CAPS,
    DEFAULTS,
    N_ENT,
    N_REL,
    make_csr,
    port_model,
)
from test_torch_train import SETTINGS, carry, kg_dir  # noqa: F401
from test_torch_train import _step_args

SCORE_TOL = 1e-3   # of the row's largest |score|
GRAD_TOL = 2e-2    # of each parameter's largest |grad|
F32_TOL = 5e-2     # bf16 against float32 (atol and rtol)
BF16 = dict(compute_dtype="bfloat16")


def jit_rounded(fn, **kw):
    """``jax.jit`` that keeps every bf16 rounding the source writes."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False},
                   **kw)


def assert_rows_close(got, want, tol=SCORE_TOL):
    """|got - want| within ``tol`` of each row's largest |want| (the last
    axis is a row)."""
    want = np.asarray(want)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert float(scale.max()) > 0
    err = np.abs(np.asarray(got) - want)
    assert np.all(err <= tol * scale), float((err / np.maximum(
        scale, 1e-30)).max())


def assert_grads_close(got: dict, want: dict, tol=GRAD_TOL, min_moved=0):
    """Each gradient within ``tol`` of its own largest |value|."""
    moved = 0
    for name, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(got[name]) - w).max())
        assert err <= tol * scale, (name, err, scale)
        moved += int(scale > 1e-6)
    assert moved >= min_moved, moved


@pytest.fixture(scope="module")
def params():
    """JAX parameters of a 3-layer RedGNN (hidden 16) for every test here:
    their shapes depend on neither the hop plan nor compute_dtype; one
    jitted init (an eager flax init takes seconds)."""
    g = JGraph.from_csr(*make_csr(np.random.default_rng(1)), N_ENT)
    cfg = jmodel.ModelConfig(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D,
                             attn_dim=A, n_layer=3, dropout=0.0,
                             dense_hops=False)
    caps = JCaps((4, 256, 256, 256), (1024, 1024, 1024))
    b = jnp.zeros(4, jnp.int32)
    init = jax.jit(lambda k: jmodel.RedGNN(cfg).init(
        {"params": k, "dropout": k}, g, b, b, b == 0, caps, False))
    return init(jax.random.PRNGKey(11))["params"]


def model_inputs(rng, n_layer=3, edge_caps=None, **cfg_over):
    """(csr, JAX model config, (subs, rels, qmask, caps)) of
    test_torch_model.jax_model: a tiny batch with one padded query, sort
    dedup and sparse hops unless ``cfg_over`` says otherwise."""
    csr = make_csr(rng)
    cfg = jmodel.ModelConfig(**{**dict(
        n_ent=N_ENT, n_rel=N_REL, hidden_dim=D, attn_dim=A, n_layer=n_layer,
        dropout=0.0, segment_impl="xla", dedup_impl="sort",
        dense_hops=False), **cfg_over})
    subs = rng.integers(0, N_ENT, 4).astype(np.int32)
    rels = rng.integers(0, 2 * N_REL, 4).astype(np.int32)
    qmask = np.array([True] * 3 + [False])
    caps = ((4,) + (256,) * n_layer, edge_caps or (1024,) * n_layer)
    return csr, cfg, (subs, rels, qmask, caps)


def layer_state(params):
    sd = params_from_flax(jax.device_get(params))
    return {k[len("layer_0."):]: v for k, v in sd.items()
            if k.startswith("layer_0.")}


# ------------------------------------------------------------------ gathers

def test_bf16_gather_backward_accumulates_in_fp32():
    """Witness of the reference's fault: one row gathered 1,000 times from
    a bf16 table. The JAX package's gather backward adds the 1,000 unit
    cotangents in bf16 and stalls at 256 (256 + 1 rounds to 256); the
    port's `gather_bf16` adds them in float32: 1000, the float64 sum."""
    idx = np.zeros(1000, np.int32)
    table = np.ones((3, 4), np.float32)
    j = jax.grad(lambda t: t[jnp.asarray(idx)].sum())(
        jnp.asarray(table, jnp.bfloat16))
    assert float(j[0, 0]) == 256.0
    j_seg = jax.ops.segment_sum(jnp.ones(1000, jnp.bfloat16),
                                jnp.asarray(idx), 1)
    assert float(j_seg[0]) == 256.0

    t = torch.from_numpy(table).requires_grad_()
    out = tgather.gather_bf16(t, torch.from_numpy(idx))
    assert out.dtype == torch.bfloat16 and out.shape == (1000, 4)
    out.sum().backward()
    assert t.grad.dtype == torch.float32
    want = np.zeros((3, 4))
    want[0] = np.ones((1000, 4), np.float64).sum(0)
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert float(t.grad[0, 0]) - float(j[0, 0]) == 744.0
    # torch's own bf16 gather stalls on the CPU too; the port never takes it
    tb = torch.ones(3, 4, dtype=torch.bfloat16, requires_grad=True)
    tb[torch.from_numpy(idx).long()].sum().backward()
    assert float(tb.grad[0, 0]) == 256.0


def test_gather_bf16_rows_and_shapes(rng):
    """Forward: the rows of the table's bf16 copy, with or without a
    gradient; any index shape; trailing dims kept. A bf16 table is
    refused (its gradient could not be float32)."""
    table = rng.normal(size=(7, 3, 5)).astype(np.float32)
    idx = rng.integers(0, 7, (4, 6)).astype(np.int32)
    want = torch.from_numpy(table).to(torch.bfloat16)[
        torch.from_numpy(idx).long()]
    t = torch.from_numpy(table).requires_grad_()
    got = tgather.gather_bf16(t, torch.from_numpy(idx))
    assert got.shape == (4, 6, 3, 5) and torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(tgather.gather_bf16(t, torch.from_numpy(idx)),
                           want)
    w = rng.normal(size=(4, 6, 3, 5)).astype(np.float32)
    (got.float() * torch.from_numpy(w)).sum().backward()
    g16 = torch.from_numpy(w).to(torch.bfloat16).double().numpy()
    want_g = np.zeros((7, 3, 5))
    np.add.at(want_g, idx, g16)
    np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(TypeError, match="float32"):
        tgather.gather_bf16(t.detach().to(torch.bfloat16),
                            torch.from_numpy(idx))


@pytest.mark.parametrize("budget", [None, 0])
def test_take_rows_bf16_backward_matches_jax(rng, monkeypatch, budget):
    """take_rows on a bf16 table: under the one-hot budget both packages
    take a float32 product of the bf16 cotangents and round it once to
    bf16; over it the JAX package adds in bf16 (segment_sum), the port in
    float32 and rounds once. The port is held to one bf16 rounding of the
    float64 sum (2^-8 relative), and to JAX's within two under the budget;
    over it JAX's bf16 sum lies further off."""
    if budget is not None:
        monkeypatch.setattr(tgather, "_ONEHOT_BUDGET", budget)
        monkeypatch.setattr(jgather, "_ONEHOT_BUDGET", budget)
    r, d = 9, 16
    table = rng.normal(size=(r, d)).astype(np.float32)
    idx = rng.integers(0, r, 200).astype(np.int32)
    w = rng.normal(size=(200, d)).astype(np.float32)
    w16 = jnp.asarray(w, jnp.bfloat16)

    want = jax.grad(lambda t: jnp.sum(
        jgather.take_rows(t.astype(jnp.bfloat16), jnp.asarray(idx))
        * w16))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = tgather.take_rows(t.to(torch.bfloat16), torch.from_numpy(idx))
    assert out.dtype == torch.bfloat16
    (out * torch.from_numpy(w).to(torch.bfloat16)).sum().backward()
    exact = np.zeros((r, d))
    np.add.at(exact, idx, np.asarray(w16, np.float64))
    got = t.grad.numpy()
    np.testing.assert_allclose(got, exact, rtol=2 ** -8, atol=1e-6)
    if budget is None:
        np.testing.assert_allclose(got, np.asarray(want), rtol=2 ** -7,
                                   atol=1e-6)
    else:  # JAX's bf16 sum of ~22 cotangents a row drifts further
        j_err = np.abs(np.asarray(want, np.float64) - exact).max()
        assert j_err > 4 * np.abs(got - exact).max(), j_err


# ------------------------------------------------------------------ layers

# (dedup, src_values, take_rows): sort hops gather hidden[src]; bitmap hops
# with the packed gather hand h_src over in float32 (cast after the
# gather), without it they gather like sort hops
LAYER_CASES = [("sort", False, True), ("sort", False, False),
               ("bitmap", True, True), ("bitmap", False, True)]


@pytest.mark.parametrize("dedup,src_values,mxu", LAYER_CASES)
def test_rel_attn_layer_bf16_matches_jax(rng, params, dedup, src_values,
                                         mxu):
    """One sparse hop: output within SCORE_TOL of JAX's bf16 layer; the
    parameters' and the previous states' gradients within GRAD_TOL."""
    csr, _, (subs, rels, qmask, _) = model_inputs(rng)
    segment_impl = "pallas" if dedup == "sort" else "xla"
    keys = np.where(qmask, np.arange(4) * N_ENT + subs,
                    SENTINEL).astype(np.int32)
    hidden = rng.normal(size=(4, D)).astype(np.float32)
    w = rng.normal(size=(256, D)).astype(np.float32)
    # the JAX package's sort hops sum with its plain scatter here (the same
    # function as its Pallas kernel, which is slow to interpret on the
    # CPU); the port's take the kernel's plain version
    layer = jlayers.RelAttnLayer(
        hidden_dim=D, attn_dim=A, n_rel=N_REL, segment_impl="xla",
        compute_dtype="bfloat16", edges_sorted=(dedup == "sort"),
        mxu_gather_backward=mxu)
    jcsr = [jnp.asarray(a) for a in csr]

    def jforward(p, h):
        fr = jexpand(*jcsr, N_ENT, jnp.asarray(keys), 1024, 256,
                     dedup_impl=dedup, key_space=4 * N_ENT,
                     node_values=h if src_values else None)
        return layer.apply({"params": p}, h, jnp.asarray(rels), fr, 256)

    want = jit_rounded(jforward)(params["layer_0"], jnp.asarray(hidden))
    gp, gh = jit_rounded(jax.grad(lambda p, h: jnp.sum(jforward(p, h) * w),
                                  argnums=(0, 1)))(params["layer_0"],
                                                   jnp.asarray(hidden))

    tl = tlayers.RelAttnLayer(D, A, N_REL, segment_impl=segment_impl,
                              mxu_gather_backward=mxu, **BF16)
    tl.load_state_dict(layer_state(params))
    h = torch.from_numpy(hidden).requires_grad_()
    tfr = texpand(*(torch.from_numpy(a) for a in csr), N_ENT,
                  torch.from_numpy(keys), 1024, 256, dedup_impl=dedup,
                  key_space=4 * N_ENT, node_values=h if src_values else None)
    got = tl(h, torch.from_numpy(rels), tfr, 256,
             edges_sorted=(dedup == "sort"))
    assert got.dtype == torch.float32
    assert_rows_close(got.detach().numpy(), want)
    (got * torch.from_numpy(w)).sum().backward()
    assert h.grad.dtype == torch.float32
    assert_grads_close({"h": h.grad.numpy()}, {"h": np.asarray(gh)})
    want_p = layer_state({**params, "layer_0": gp})
    assert_grads_close({k: p.grad.numpy() for k, p in tl.named_parameters()},
                       {k: v.numpy() for k, v in want_p.items()},
                       min_moved=5)


@pytest.mark.parametrize("mxu", [True, False])
def test_dense_hop_bf16_matches_jax(rng, params, mxu):
    """RelAttnLayer.dense in bf16: the packed (state, visited) rows, the
    relation rows and h_qr in bf16, float32 messages. Output, new visited
    set and live count against JAX's; gradients of the parameters and of
    the dense states within GRAD_TOL."""
    csr = make_csr(rng)
    b = 3
    vis = rng.random((N_ENT, b)) < 0.4
    hd = (rng.normal(size=(N_ENT, b, D)) * vis[..., None]).astype(np.float32)
    q_rel = rng.integers(0, 2 * N_REL, b).astype(np.int32)
    w = rng.normal(size=(N_ENT, b, D)).astype(np.float32)
    jg = JGraph.from_csr(*csr, N_ENT)
    tg = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    layer = jlayers.RelAttnLayer(hidden_dim=D, attn_dim=A, n_rel=N_REL,
                                 compute_dtype="bfloat16",
                                 mxu_gather_backward=mxu)

    def jforward(p, h):
        return layer.apply({"params": p}, h, jnp.asarray(vis),
                           jnp.asarray(q_rel), jg.tsrc, jg.trel, jg.ttail,
                           jg.tail_rowptr, method=jlayers.RelAttnLayer.dense)

    want, want_vis, want_live = jit_rounded(jforward)(params["layer_0"],
                                                      jnp.asarray(hd))
    gp, gh = jit_rounded(jax.grad(
        lambda p, h: jnp.sum(jforward(p, h)[0] * w),
        argnums=(0, 1)))(params["layer_0"], jnp.asarray(hd))

    tl = tlayers.RelAttnLayer(D, A, N_REL, mxu_gather_backward=mxu, **BF16)
    tl.load_state_dict(layer_state(params))
    h = torch.from_numpy(hd).requires_grad_()
    got, got_vis, got_live = tl.dense(
        h, torch.from_numpy(vis), torch.from_numpy(q_rel), tg.tsrc, tg.trel,
        tg.ttail, tg.tail_rowptr)
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
    assert int(got_live) == int(want_live) > 0
    assert_rows_close(got.detach().numpy(), want)
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_close({"h": h.grad.numpy()}, {"h": np.asarray(gh)})
    want_p = layer_state({**params, "layer_0": gp})
    assert_grads_close({k: p.grad.numpy() for k, p in tl.named_parameters()},
                       {k: v.numpy() for k, v in want_p.items()},
                       min_moved=5)


def test_compute_dtype_refused():
    """Only 'float32' and 'bfloat16' are accepted, by the layer, the model
    config's layers and the trainer config."""
    for bad in ("float16", "bf16", "fp32"):
        with pytest.raises(ValueError, match="compute_dtype"):
            tlayers.RelAttnLayer(D, A, N_REL, compute_dtype=bad)
        with pytest.raises(ValueError, match="compute_dtype"):
            tmodel.RedGNN(tmodel.ModelConfig(n_ent=5, n_rel=2,
                                             compute_dtype=bad),
                          device="cpu")
        with pytest.raises(ValueError, match="compute_dtype"):
            TrainConfig(compute_dtype=bad)


# ------------------------------------------------------------------- model

# hidden 16, L=3: sort hops, bitmap hops without the packed gather, the
# registry's defaults (bitmap hops with the packed gather, then dense) and
# sort hops then dense hops. The JAX model sums with its plain scatter (sort hops with
# dedup_impl='sort'); the port's sort cases take the kernel's plain version
MODEL_CASES = {
    "sort": ("pallas", {}),
    "bitmap_strict": ("xla", dict(dedup_impl="bitmap",
                                  scan_src_backward=False)),
    "defaults": ("xla", dict(DEFAULTS, edge_caps=DEFAULT_EDGE_CAPS)),
    "sort_dense": ("pallas", dict(DEFAULTS, dedup_impl="sort",
                                  edge_caps=DEFAULT_EDGE_CAPS)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_redgnn_bf16_matches_jax(rng, params, case):
    """Scores within SCORE_TOL of JAX's bf16 model, aux counts equal, and
    the gradients of a weighted score sum within GRAD_TOL; the same
    scores and gradients within F32_TOL of the port's float32 model."""
    seg, over = MODEL_CASES[case]
    csr, jcfg, (subs, rels, qmask, caps) = model_inputs(rng, **BF16, **over)
    w = rng.normal(size=(4, N_ENT)).astype(np.float32)
    jg = JGraph.from_csr(*csr, N_ENT)

    def jloss(p):
        s, aux = jmodel.RedGNN(jcfg).apply(
            {"params": p}, jg, jnp.asarray(subs), jnp.asarray(rels),
            jnp.asarray(qmask), JCaps(*caps), False)
        return jnp.sum(s * w), (s, aux)

    (_, (want, want_aux)), jgrad = jit_rounded(jax.value_and_grad(
        jloss, has_aux=True))(params)
    tg = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    args = (tg, torch.from_numpy(subs), torch.from_numpy(rels),
            torch.from_numpy(qmask), FrontierCaps(*caps))
    grads = {}
    for dtype in ("bfloat16", "float32"):
        model = port_model(dataclasses.replace(
            jcfg, compute_dtype=dtype, segment_impl=seg), params)
        s, aux = model(*args)
        (s * torch.from_numpy(w)).sum().backward()
        grads[dtype] = ({k: p.grad.numpy() for k, p in
                         model.named_parameters()}, s.detach().numpy(), aux)
    got_g, got, aux = grads["bfloat16"]
    assert_rows_close(got[:3], np.asarray(want)[:3])
    assert np.all(got[3] == 0)  # the padded query scores nothing
    for k in want_aux:
        np.testing.assert_array_equal(aux[k].numpy(),
                                      np.asarray(want_aux[k]), err_msg=k)
    want_g = {k: v.numpy() for k, v in
              params_from_flax(jax.device_get(jgrad)).items()}
    assert_grads_close(got_g, want_g, min_moved=len(want_g) - 1)
    f32_g, f32, _ = grads["float32"]
    np.testing.assert_allclose(got, f32, rtol=F32_TOL, atol=F32_TOL)
    assert float(np.abs(got - f32).max()) > 0  # bf16 did round
    for k in f32_g:
        np.testing.assert_allclose(got_g[k], f32_g[k], rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)


# ----------------------------------------------------------------- trainer

# a bf16 step against JAX's: Adam divides the first moment by the root of
# the second, so the gradients' bf16 differences reach a parameter whose
# gradient is near zero at up to ~lr a step (measured after 3 steps at lr
# 0.01 on three toy KGs: parameters 3.2e-3 at one entry, 3.0e-4
# elsewhere; first moments 3.1e-5, second 1.2e-7; loss 8.3e-7 relative)
STEP_ATOL = {"params": 5e-3, "mu": 1e-4, "nu": 5e-7}


def test_train_steps_bf16_match_jax(kg_dir):
    """3 bf16 StaticTrainer steps from the JAX trainer's parameters and
    moments (made non-trivial by one JAX step): loss rtol 1e-5, parameters
    and Adam's moments within STEP_ATOL."""
    settings = dict(SETTINGS, **BF16)
    # the JAX trainer's sort hops on its plain scatter (the port's on the
    # kernel's plain version, segment_impl='pallas')
    jt = jloop.StaticTrainer(JKG.load(kg_dir), JConfig(**dict(
        settings, segment_impl="xla", dedup_impl="sort")))
    pt = tloop.StaticTrainer(StaticKG.load(kg_dir, device="cpu"),
                             TrainConfig(**settings))
    assert pt.model_cfg.compute_dtype == "bfloat16"
    b = jt.cfg.n_batch
    step = jit_rounded(jt._train_step_impl, static_argnames=("caps",))

    def jstep(params, opt_state, lo):
        s, r, o, q = _step_args(jt.kg, lo, b)
        return step(params, opt_state, jt.kg.graph, jnp.asarray(s, jnp.int32),
                    jnp.asarray(r, jnp.int32), jnp.asarray(o, jnp.int32),
                    jnp.asarray(q), jax.random.PRNGKey(0), jt.train_caps)

    params, opt_state, *_ = jstep(jt.params, jt.opt_state, 0)
    carry(params, opt_state, pt)
    for k in range(1, 4):
        params, opt_state, jl, jov, jne = jstep(params, opt_state, k * b)
        s, r, o, q = (torch.from_numpy(a) for a in
                      _step_args(pt.kg, k * b, b))
        loss, overflow, num_edges = pt._train_step(
            s.int(), r.int(), o.int(), q, pt.train_caps)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert bool(overflow) == bool(jov)
        np.testing.assert_array_equal(num_edges.numpy(), np.asarray(jne))
        adam = jax.device_get(opt_state[1])
        got = pt.state()
        for group, want, mine in (
                ("params", params, got["params"]),
                ("mu", adam.mu, got["opt_state"]["mu"]),
                ("nu", adam.nu, got["opt_state"]["nu"])):
            for name, v in params_from_flax(jax.device_get(want)).items():
                np.testing.assert_allclose(
                    mine[name].numpy(), v.numpy(), atol=STEP_ATOL[group],
                    err_msg=f"{group}/{name}")
        assert int(pt.opt_state["count"]) == int(adam.count)


def test_trainer_bf16_trains_evaluates_and_serves(kg_dir):
    """At the registry's implementation defaults (bitmap, then dense
    hops) a bf16 trainer runs an epoch, evaluates (metrics within 5e-2 of
    the float32 trainer's from the same seed) and serves through
    Predictor.from_trainer."""
    settings = dict(SETTINGS, segment_impl="xla", dedup_impl="auto",
                    dense_hops=True, dense_switch=0.4, n_layer=3)
    out = {}
    for dtype in ("bfloat16", "float32"):
        tr = tloop.StaticTrainer(StaticKG.load(kg_dir, device="cpu"),
                                 TrainConfig(**settings,
                                             compute_dtype=dtype))
        loss = tr.train_epoch(0)
        assert np.isfinite(loss) and loss > 0
        out[dtype] = (tr.evaluate("valid"), tr)
    (m16, tr), (m32, _) = out["bfloat16"], out["float32"]
    for k in ("mrr", "h1", "h10"):
        assert abs(m16[k] - m32[k]) <= 5e-2, (k, m16, m32)
    assert m16["n"] == m32["n"] > 0
    pred = Predictor.from_trainer(tr, "test", top_k=5)
    q = tr.kg.eval_spec("test").queries
    s, e = pred.predict(q[:, 0], q[:, 1])
    assert s.shape == (len(q), 5) and np.isfinite(s).all()
    assert ((e >= 0) & (e < tr.kg.n_ent)).all()


def test_cli_bf16_one_epoch(kg_dir, capsys):
    """--set compute_dtype=bfloat16 reaches the model through the CLI;
    another value exits with the config's reason."""
    cli_main(["--task", "transductive", "--data_path", kg_dir, "--device",
              "cpu", "--epochs", "1", "--set", "hidden_dim=16", "n_layer=2",
              "n_batch=16", "n_tbatch=16", "compute_dtype=bfloat16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["compute_dtype"] == "bfloat16"
    best = json.loads(lines[-1][len("BEST "):])
    assert 0.0 <= best["valid_mrr"] <= 1.0
    with pytest.raises(ValueError, match="compute_dtype"):
        cli_main(["--task", "transductive", "--data_path", kg_dir,
                  "--device", "cpu", "--epochs", "1", "--set",
                  "compute_dtype=float16"])


def test_mesh_bf16_step_matches_jax(rng, params):
    """The sharded bf16 loss's gradient on a (2, 2) mesh (plain gathers
    through gather_bf16; each rank's data shard and edge slice; summed
    over the mesh) against jax.grad of the JAX package's bf16 model on the
    whole batch with the same flags: loss rtol 1e-5, gradients within
    GRAD_TOL."""
    n_data, n_edge = 2, 2
    arrays = [a.astype(np.int32) for a in make_csr(rng)]
    b = 8
    batch = [rng.integers(0, N_ENT, b).astype(np.int32),
             rng.integers(0, 2 * N_REL, b).astype(np.int32),
             rng.integers(0, N_ENT, b).astype(np.int32), np.ones(b, bool)]
    nc, ec = tcal.per_query_counts(arrays[0], arrays[2], N_ENT,
                                   batch[0].astype(np.int64), 3)
    caps = tcal.caps_for_batches(nc, ec, b // n_data)
    gcaps = tcal.caps_for_batches(nc, ec, b)
    cfg_kw = dict(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D, attn_dim=A,
                  n_layer=3, dropout=0.0, **BF16)
    jcfg = jmodel.ModelConfig(**cfg_kw, mxu_gather_backward=False,
                              scan_src_backward=False)
    jg = JGraph(*(jnp.asarray(a) for a in arrays))
    jb = [jnp.asarray(x) for x in batch]

    def jloss(p):
        s, _ = jmodel.RedGNN(jcfg).apply(
            {"params": p}, jg, jb[0], jb[1], jb[3],
            JCaps(*dataclasses.astuple(gcaps)), False)
        return jloop.softmax_ce_loss(s, jb[2], jb[3])

    loss, grads = jit_rounded(jax.value_and_grad(jloss))(params)
    want = {k: v.numpy() for k, v in
            params_from_flax(jax.device_get(grads)).items()}
    outs = run_mesh(W.grad_probe, n_data, n_edge, ["cpu"] * 4,
                    args=(arrays, cfg_kw,
                          params_from_flax(jax.device_get(params)), batch,
                          caps))
    for out in outs:
        assert not out["overflow"]
        np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
        assert_grads_close({k: v.numpy() for k, v in out["grads"].items()},
                           want, min_moved=len(want) - 1)
