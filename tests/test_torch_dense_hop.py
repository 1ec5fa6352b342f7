"""The dense hop's fused forward (`ops/dense_hop.py`) on the CPU, where it
is the kernels' plain version: against the JAX package's dense hops on the
same numpy inputs and weights (`params_from_flax`), and the rule that
picks it (gradients off, or nothing requiring one).

Tolerances:
- float32 layer outputs and scores: within 1e-5 of the row's largest
  |value| of the JAX package's (the fused factoring reassociates the
  attention and time terms' sums; measured ~1e-7 here). JAX's 'cumsum'
  route takes differences of prefix sums over all edges, whose
  cancellation noise grows with the table, so whole forwards are held,
  both packages, to a float64 run of the port within 1e-5 of the row's
  largest |score|.
- bf16 (static): 2e-2 of each row's largest |value|, as
  tests/test_torch_bf16.py holds bf16 gradients (the two packages round
  the same bf16 rows; a float32 order difference may flip a bf16 round).
- visited sets and aux counts: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redgnn_tpu.graph.calibrate import FrontierCaps as JCaps
from redgnn_tpu.graph.kg import DeviceGraph as JGraph
from redgnn_tpu.graph.temporal import TemporalKG as JKG
from redgnn_tpu.models import layers as jlayers
from redgnn_tpu.models import redgnn as jmodel
from redgnn_tpu.models import temporal as jtm
from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models import layers as tlayers
from redgnn_tpu_torch.models import temporal as ttm
from redgnn_tpu_torch.ops import dense_hop as dh
from redgnn_tpu_torch.utils.hpo import INTERPOLATION_SPACE, STATIC_SPACE
from redgnn_tpu_torch.utils.port_params import params_from_flax

from test_torch_bf16 import jit_rounded
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
from test_torch_temporal import (  # noqa: F401
    B,
    jax_apply,
    model_case,
    port_apply,
    vocab_dir,
)
from test_torch_temporal import port_model as temporal_port_model

TOL = 1e-5    # float32, of the row's largest |value|
BF16_TOL = 2e-2


def rows_close(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert float(scale.max()) > 1e-3
    err = np.abs(np.asarray(got, np.float64) - want)
    assert np.all(err <= tol * np.maximum(scale, 1e-30)), \
        float((err / np.maximum(scale, 1e-30)).max())


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the plain versions' calls (the fused route on the CPU)."""
    calls = {"static": 0, "temporal": 0}
    args = calls["args"] = {"static": [], "temporal": []}
    for kind in ("static", "temporal"):
        name = f"dense_hop_{kind}_plain"
        fn = getattr(dh, name)

        def spy(*a, _fn=fn, _kind=kind, **k):
            calls[_kind] += 1
            args[_kind].append(a)
            return _fn(*a, **k)

        monkeypatch.setattr(dh, name, spy)
    return calls


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("degrees", [
    [0, 0, 0], [1, 31, 32, 33, 0, 64, 65], [300, 0, 5], [7] * 40,
    # many tails; a Zipf hub split into many items
    [1] * 4096, [2000 // k for k in range(1, 201)]])
def test_tail_items_plan(degrees):
    """Each tail's chunks of EDGE_CHUNK edges (one for an empty tail, so
    every tail has an item), the first item of each tail; the count stays
    within the grid's bound N + E // EDGE_CHUNK."""
    deg = np.asarray(degrees)
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                              .astype(np.int32))
    got = dh.tail_items(rowptr).numpy()
    c = dh.EDGE_CHUNK
    want = np.concatenate([[0], np.cumsum(np.maximum(1, -(-deg // c)))])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert np.all(np.diff(got) >= 1)
    assert got[-1] <= len(deg) + deg.sum() // c


def test_graphs_carry_the_plans(vocab_dir, rng):
    """A DeviceGraph given a tail-sorted view builds its `tail_items`;
    the temporal graph keeps its own and the count of time ids, past
    every edge time; `to` keeps them."""
    g = DeviceGraph.from_csr(*make_csr(rng), N_ENT, device="cpu")
    assert torch.equal(g.tail_items, dh.tail_items(g.tail_rowptr))
    assert g.n_time is None
    assert torch.equal(g.to("cpu").tail_items, g.tail_items)
    assert DeviceGraph(g.rowptr, g.rel, g.tail).tail_items is None
    kg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
    assert torch.equal(kg.graph.tail_items, dh.tail_items(kg.dense[5]))
    assert kg.graph.n_time == kg.graph.to("cpu").n_time == kg.n_time
    assert int(kg.dense[2].max()) < kg.n_time


# ---------------------------------------------------------------- static

def static_case(rng, b=3):
    csr = make_csr(rng)
    vis = rng.random((N_ENT, b)) < 0.4
    hd = (rng.normal(size=(N_ENT, b, D)) * vis[..., None]).astype(np.float32)
    q_rel = rng.integers(0, 2 * N_REL, b).astype(np.int32)
    return csr, vis, hd, q_rel


@pytest.fixture(scope="module")
def static_params():
    g = JGraph.from_csr(*make_csr(np.random.default_rng(1)), N_ENT)
    cfg = jmodel.ModelConfig(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D,
                             attn_dim=A, n_layer=1, dropout=0.0,
                             dense_hops=False)
    z = jnp.zeros(4, jnp.int32)
    return jax.jit(lambda k: jmodel.RedGNN(cfg).init(
        {"params": k, "dropout": k}, g, z, z, z == 0,
        JCaps((4, 64), (256,)), False))(jax.random.PRNGKey(5))["params"]


def port_layer(params, **kw):
    tl = tlayers.RelAttnLayer(D, A, N_REL, **kw)
    sd = params_from_flax(jax.device_get(params))
    tl.load_state_dict({k[len("layer_0."):]: v for k, v in sd.items()
                        if k.startswith("layer_0.")})
    return tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dense_agg", ["sorted_scatter", "cumsum"])
def test_static_fused_matches_jax(rng, static_params, fused_calls, dense_agg,
                                  dtype):
    """RelAttnLayer.dense under no_grad (the fused plain version) against
    flax's ``apply(method=RelAttnLayer.dense)``: output within TOL
    (float32) or BF16_TOL (bf16) of each row's largest, new visited set
    and live count equal."""
    csr, vis, hd, q_rel = static_case(rng)
    jg = JGraph.from_csr(*csr, N_ENT)
    layer = jlayers.RelAttnLayer(hidden_dim=D, attn_dim=A, n_rel=N_REL,
                                 compute_dtype=dtype)
    want, want_vis, want_live = jit_rounded(
        lambda p, h: layer.apply(
            {"params": p}, h, jnp.asarray(vis), jnp.asarray(q_rel), jg.tsrc,
            jg.trel, jg.ttail, jg.tail_rowptr, dense_agg,
            method=jlayers.RelAttnLayer.dense))(static_params["layer_0"],
                                                jnp.asarray(hd))
    tl = port_layer(static_params, compute_dtype=dtype)
    g = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    with torch.no_grad():
        got, got_vis, got_live = tl.dense(
            torch.from_numpy(hd), torch.from_numpy(vis),
            torch.from_numpy(q_rel), g.tsrc, g.trel, g.ttail, g.tail_rowptr,
            dense_agg, g.tsrc_order, g.rowptr, g.tail_items)
    assert fused_calls["static"] == 1
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
    assert got_live.dtype == torch.int32
    assert int(got_live) == int(want_live) > 0
    rows_close(got.numpy(), want, TOL if dtype == "float32" else BF16_TOL)


def test_static_plain_sums_agree(rng, static_params):
    """The plain version's two summations and the graph's work plan: the
    same sums within float32 rounding (a prefix-sum difference against a
    scatter), the same visited flags and counts, bit-equal whether the
    plan comes with the graph or not."""
    csr, vis, hd, q_rel = static_case(rng, b=5)
    tl = port_layer(static_params)
    g = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    args = (torch.from_numpy(hd), torch.from_numpy(vis),
            torch.from_numpy(q_rel), g.tsrc, g.trel, g.ttail, g.tail_rowptr)
    with torch.no_grad():
        a = tl.dense(*args, "sorted_scatter", g.tsrc_order, g.rowptr,
                     g.tail_items)
        b = tl.dense(*args, "cumsum")
        c = tl.dense(*args, "sorted_scatter")
    for x, y in zip(a, c):
        assert torch.equal(x, y)
    rows_close(b[0].numpy(), a[0].numpy(), TOL)
    assert torch.equal(a[1], b[1]) and int(a[2]) == int(b[2])
    with pytest.raises(ValueError, match="dense_agg"):
        with torch.no_grad():
            tl.dense(*args, "segment")


def test_grad_free_rule(rng, static_params, fused_calls):
    """The fused route runs with gradients off, or on when nothing the hop
    reads requires one; with a parameter or the state requiring a
    gradient the autograd route runs, and its output differs from the
    fused one by float32 rounding only."""
    csr, vis, hd, q_rel = static_case(rng)
    tl = port_layer(static_params)
    g = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    h = torch.from_numpy(hd)

    def run(state):
        return tl.dense(state, torch.from_numpy(vis),
                        torch.from_numpy(q_rel), g.tsrc, g.trel, g.ttail,
                        g.tail_rowptr, "sorted_scatter", g.tsrc_order,
                        g.rowptr, g.tail_items)

    with torch.inference_mode():
        fused = run(h)
    assert fused_calls["static"] == 1
    autograd = run(h)                       # parameters require grad
    assert fused_calls["static"] == 1 and autograd[0].requires_grad
    tl.requires_grad_(False)
    run(h.clone().requires_grad_())          # the state requires grad
    assert fused_calls["static"] == 1
    again = run(h)                           # nothing requires grad
    assert fused_calls["static"] == 2 and not again[0].requires_grad
    assert torch.equal(again[0], fused[0])
    rows_close(autograd[0].detach().numpy(), fused[0].numpy(), TOL)
    assert torch.equal(autograd[1], fused[1])
    assert dh.grad_free(None) and dh.grad_free(h)


# ----------------------------------------------------------- whole models

def float64_scores(model, fn):
    """``fn(model)``'s scores from the model's weights in float64 (the
    default dtype float64 during the call), no gradients, with the plain
    src gather and sums (which change no value of the forward)."""
    cfg = dataclasses.replace(model.cfg, scan_src_backward=False,
                              segment_impl="xla")
    twin = type(model)(cfg, device="cpu").double()
    twin.load_state_dict({k: v.double() for k, v in
                          model.state_dict().items()})
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with torch.no_grad():
            scores, _ = fn(twin)
    finally:
        torch.set_default_dtype(default)
    assert scores.dtype == torch.float64
    return scores.numpy()


@pytest.mark.parametrize("dense_agg", ["sorted_scatter", "cumsum"])
def test_redgnn_fused_forward_matches_jax(rng, fused_calls, dense_agg):
    """A umls-like toy at the registry's defaults (bitmap hops, then dense
    hops from dense_switch 0.6) under no_grad: one fused call a dense
    hop; scores within TOL of the row's largest of JAX's and of the
    port's autograd route (gradients on); aux counts equal to JAX's. (At
    this size JAX's cumsum route is within float32 rounding: the static
    model's sparse hops compute in float32, so it has no float64 run.)"""
    csr = make_csr(rng)
    jcfg = jmodel.ModelConfig(
        n_ent=N_ENT, n_rel=N_REL, hidden_dim=D, attn_dim=A, n_layer=4,
        dropout=0.0, dense_agg=dense_agg, **DEFAULTS)
    b = 4
    subs = rng.integers(0, N_ENT, b).astype(np.int32)
    rels = rng.integers(0, 2 * N_REL, b).astype(np.int32)
    qmask = np.array([True] * (b - 1) + [False])
    caps = ((b,) + (256,) * 4, DEFAULT_EDGE_CAPS)
    jg = JGraph.from_csr(*csr, N_ENT)
    jargs = (jg, jnp.asarray(subs), jnp.asarray(rels), jnp.asarray(qmask),
             JCaps(*caps), False)
    net = jmodel.RedGNN(jcfg)
    # jitted (an eager flax init and apply take seconds each)
    params = jax.jit(lambda k: net.init({"params": k, "dropout": k},
                                        *jargs))(
        jax.random.PRNGKey(int(rng.integers(1 << 30))))["params"]
    want, want_aux = jax.jit(lambda p: net.apply({"params": p}, *jargs))(
        params)
    model = port_model(jcfg, params)
    graph = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    args = (graph, torch.from_numpy(subs), torch.from_numpy(rels),
            torch.from_numpy(qmask), FrontierCaps(*caps))
    with torch.no_grad():
        got, aux = model(*args)
    assert fused_calls["static"] == 2  # two dense hops
    auto, _ = model(*args)
    assert auto.requires_grad and fused_calls["static"] == 2
    rows_close(got.numpy()[:3], np.asarray(want)[:3], TOL)
    rows_close(got.numpy()[:3], auto.detach().numpy()[:3], TOL)
    assert np.all(got.numpy()[3] == 0)
    for k in ("edge_overflow", "node_overflow", "num_nodes", "num_edges"):
        np.testing.assert_array_equal(aux[k].numpy(),
                                      np.asarray(want_aux[k]), err_msg=k)


TEMPORAL_CASES = {
    # name: (leave-one-out, config overrides)
    "interp_dense_loo": (True, {}),
    "interp_dense_cumsum": (True, dict(dense_agg="cumsum")),
    "wo_time": (True, dict(use_time=False)),
    "wo_attention": (False, dict(use_attention=False)),
    "bias_transform": (False, dict(direction_transform="bias")),
    "absolute_time": (True, dict(time_embedding="absolute")),
    "act_tanh": (False, dict(act="tanh")),
    "act_sigmoid": (False, dict(act="sigmoid")),
    "act_softplus": (False, dict(act="softplus")),
    "act_relu_idd": (False, dict(act="idd")),
    # the interpolation search's widest hidden and attention widths
    "search_width_48": (True, dict(hidden_dim=48, attn_dim=40)),
    # three hops, two of them dense: tails whose kept edges fall in all
    # three directions (asserted), linear and bias transforms
    "three_directions": (False, dict(n_layer=3)),
    "three_directions_bias": (False, dict(n_layer=3,
                                          direction_transform="bias")),
}


def three_directions_kept(args) -> bool:
    """Whether a temporal dense hop (the plain version's arguments) keeps,
    for some (tail, query), edges of all three directions."""
    (_, visited, _, tsrc, _, ttime, ttail, _, times, excl_keep,
     edge_keep) = args[:11]
    keep = visited[tsrc.long()]
    if excl_keep is not None:
        keep = keep & excl_keep[:, None]
    if edge_keep is not None:
        keep = keep & edge_keep
    direction = torch.sign(ttime[:, None] - times[None, :]) + 1
    b = keep.shape[1]
    key = (ttail.long()[:, None] * b + torch.arange(b)) * 3 + direction
    seen = torch.unique(key[keep])
    return bool((torch.bincount(seen // 3) == 3).any())


@pytest.mark.parametrize("case", list(TEMPORAL_CASES))
def test_tredgnn_fused_forward_matches_jax(vocab_dir, rng, fused_calls,
                                           case):
    """Interpolation TRedGNN with a sparse hop and then dense ones, under
    no_grad: one fused call a dense hop; scores of both packages within
    TOL of the row's largest off a float64 run of the port; every aux
    count equal to JAX's."""
    loo, over = TEMPORAL_CASES[case]
    kg, jkg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu"), \
        JKG.load_vocab_dir(vocab_dir)
    over = dict(over, dense_switch=0.4)
    if over.get("time_embedding") == "absolute":
        over["n_time"] = kg.n_time
    cfg, batch, caps, excl = model_case(jkg, rng, "interpolation", loo=loo,
                                        **over)
    _, args, jm = jax_apply(jkg, cfg, batch, caps, excl, params={})
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        *args)["params"])()
    want, want_aux = jax.jit(lambda p: jm.apply({"params": p}, *args))(
        params)
    model = temporal_port_model(cfg, params)
    plan = ttm.temporal_hop_plan(model.cfg, kg.graph.n_edges,
                                 FrontierCaps(*caps), B, True)
    assert plan[0] != "dense" and "dense" in plan, plan
    with torch.no_grad():
        got, aux = port_apply(model, kg, batch, caps, excl)
    assert fused_calls["temporal"] == plan.count("dense")
    if case.startswith("three_directions"):
        assert any(three_directions_kept(a)
                   for a in fused_calls["args"]["temporal"])
    ref = float64_scores(model, lambda m: port_apply(m, kg, batch, caps,
                                                     excl))
    q = B - 1  # the padded query scores nothing
    rows_close(got.numpy()[:q], ref[:q], TOL)
    rows_close(np.asarray(want)[:q], ref[:q], TOL)
    for k in ("edge_overflow", "node_overflow", "num_nodes", "num_edges"):
        np.testing.assert_array_equal(aux[k].numpy(),
                                      np.asarray(want_aux[k]), err_msg=k)


def test_tredgnn_fused_draws_the_autograd_routes_masks(vocab_dir, rng,
                                                       fused_calls):
    """Training with dropout and edge dropout: the fused route (no_grad)
    draws the masks the autograd route draws from the same generator, in
    its order, so the two forwards agree within TOL, visited sets and
    counts equal."""
    kg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
    jkg = JKG.load_vocab_dir(vocab_dir)
    cfg, batch, caps, excl = model_case(jkg, rng, dropout=0.3,
                                        edge_dropout=0.2, dense_switch=0.4)
    _, args, jm = jax_apply(jkg, cfg, batch, caps, excl, params={})
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        *args)["params"])()
    model = temporal_port_model(cfg, params)
    subs, rels, _, times, qmask = (torch.from_numpy(a) for a in batch)

    def run(seed):
        return model(kg.graph, kg.etime, subs, rels, times, qmask,
                     FrontierCaps(*caps), None, True,
                     kg.ekey, kg.selfloop_slot, kg.time_rowptr, kg.dense,
                     generator=torch.Generator().manual_seed(seed))

    with torch.no_grad():
        fused, f_aux = run(7)
    assert fused_calls["temporal"] >= 1
    auto, a_aux = run(7)
    assert auto.requires_grad
    rows_close(fused.numpy()[:B - 1], auto.detach().numpy()[:B - 1], TOL)
    for k in ("num_nodes", "num_edges"):
        assert torch.equal(f_aux[k], a_aux[k]), k
    with torch.no_grad():
        other, _ = run(8)
    assert not torch.equal(other, fused)


def _kernel_inputs(rng):
    """Valid inputs of both kernels (on the CPU): (static, temporal)
    argument dicts in the order of `check_static_inputs` and
    `check_temporal_inputs`."""
    csr, vis, hd, q_rel = static_case(rng)
    g = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    e, b, r = g.tsrc.shape[0], vis.shape[1], 2 * N_REL + 1
    f = lambda *shape: torch.zeros(shape)
    static = dict(hidden=torch.from_numpy(hd), visited=torch.from_numpy(vis),
                  rela=f(r, D), tsrc=g.tsrc, trel=g.trel,
                  tail_rowptr=g.tail_rowptr, item_ptr=g.tail_items,
                  wr=f(r, A), wq=f(b, A), ws=f(A, D), w_alpha=f(A),
                  b_alpha=f(1))
    temporal = dict(static, ttime=g.trel.clone(),
                    times=torch.zeros(b, dtype=torch.int32),
                    excl_keep=torch.ones(e, dtype=torch.bool),
                    edge_keep=torch.ones(e, b, dtype=torch.bool),
                    tt=f(9, b, D), ra=f(r, A), qa=f(b, A), a1s=f(D, A),
                    a2=f(A, 1), wdir=f(3, D, D), bdir=None,
                    drop_keep=torch.ones(N_ENT, b, D, dtype=torch.bool))
    for k in ("wr", "wq", "ws", "w_alpha", "b_alpha"):
        del temporal[k]
    return static, temporal


BAD_INPUTS = [
    # (which kernel, argument, replacement, words of the error)
    ("static", "hidden", lambda t: t.double(), "float32 or bfloat16"),
    ("static", "hidden", lambda t: t.transpose(0, 1), "visited must be"),
    ("static", "visited", lambda t: t.to(torch.uint8), "visited must be"),
    ("static", "rela", lambda t: t.to(torch.bfloat16), "rela must be"),
    ("static", "tsrc", lambda t: t.long(), "tsrc must be"),
    ("static", "item_ptr", lambda t: t[:-1], "item_ptr must be"),
    ("static", "ws", lambda t: t[:, 1:], "ws must be"),
    ("static", "wq", lambda t: t[:, :2], "wq must be"),
    ("static", "w_alpha", lambda t: t[::2], "w_alpha must be"),
    ("static", "hidden", lambda t: torch.zeros(t.shape[:2] + (65,)),
     "width 65"),
    ("temporal", "hidden", lambda t: torch.zeros(t.shape[:2] + (65,)),
     "width 65"),
    ("temporal", "hidden", lambda t: t.to(torch.bfloat16), "hidden must be"),
    ("temporal", "times", lambda t: t.long(), "times must be"),
    ("temporal", "edge_keep", lambda t: t.T.contiguous(), "edge_keep must"),
    ("temporal", "tt", lambda t: t[:, :1], "tt must be"),
    ("temporal", "qa", lambda t: None, "attention needs"),
    ("temporal", "wdir", lambda t: t[:, :, ::2], "wdir must be"),
    ("temporal", "drop_keep", lambda t: t[:1], "drop_keep must be"),
    ("temporal", "a1s", lambda t: torch.zeros(A, D).T, "contiguous"),
]


@pytest.mark.parametrize("kind,arg,bad,words", BAD_INPUTS,
                         ids=[f"{k}-{a}-{i}" for i, (k, a, _, _)
                              in enumerate(BAD_INPUTS)])
def test_kernel_input_checks(rng, kind, arg, bad, words):
    """The wrappers' checks, which run before a launch, on any device:
    valid inputs pass and give (N, b, d, A); each wrong dtype, shape,
    width or layout raises ValueError naming it."""
    static, temporal = _kernel_inputs(rng)
    args, check = ((static, dh.check_static_inputs) if kind == "static"
                   else (temporal, dh.check_temporal_inputs))
    assert check(**args) == (N_ENT, 3, D, A)
    with pytest.raises(ValueError, match=words):
        check(**dict(args, **{arg: bad(args[arg])}))


def test_temporal_wrapper_refusals():
    """The wrapper takes one of the direction transforms and known
    activations, on any device."""
    z = torch.zeros(0)
    with pytest.raises(ValueError, match="activation"):
        dh.dense_hop_temporal(*[z] * 18, None, 0.0, "gelu", "sorted_scatter",
                              z)
    with pytest.raises(ValueError, match="wdir and bdir"):
        dh.dense_hop_temporal(*[z] * 16, z, z, None, 0.0, "relu",
                              "sorted_scatter", z)


SEARCH_WIDTHS = sorted(
    {("static", d, a) for d in STATIC_SPACE["hidden_dim"].options
     for a in STATIC_SPACE["attn_dim"].options}
    | {("temporal", d, a) for d in INTERPOLATION_SPACE["hidden_dim"].options
       for a in INTERPOLATION_SPACE["attn_dim"].options})


@pytest.mark.parametrize("kind,d,a", SEARCH_WIDTHS)
def test_kernels_take_the_search_widths(rng, kind, d, a):
    """Every (hidden, attention) width the hyperparameter searches
    (`utils/hpo.py`) can pick passes the kernel's checks: an evaluation
    under no_grad on a CUDA device reaches the kernel at any of them."""
    static, temporal = _kernel_inputs(rng)
    f = lambda *shape: torch.zeros(shape)  # noqa: E731
    n, b = static["visited"].shape
    r = static["rela"].shape[0]
    if kind == "static":
        args = dict(static, hidden=f(n, b, d), rela=f(r, d), wr=f(r, a),
                    wq=f(b, a), ws=f(a, d), w_alpha=f(a))
        assert dh.check_static_inputs(**args) == (n, b, d, a)
    else:
        args = dict(temporal, hidden=f(n, b, d), rela=f(r, d),
                    drop_keep=torch.ones(n, b, d, dtype=torch.bool),
                    tt=f(9, b, d), ra=f(r, a), qa=f(b, a), a1s=f(d, a),
                    a2=f(a, 1), wdir=f(3, d, d))
        assert dh.check_temporal_inputs(**args) == (n, b, d, a)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "bias"])
def test_three_direction_hop_matches_jax(linear):
    """One temporal dense hop of the JAX package (``TRedGNN._dense_hop``,
    periodic time term) and `dense_hop_temporal`'s plain version (each
    edge's message through its direction's transform, as the kernel
    does) on the same numpy inputs, at the interpolation search's widest
    widths, in which every tail keeps edges of all three directions
    (past, now, future) for every query: the state within TOL of each
    row's largest, visited set and counts equal."""
    d, a, n, b, e = 48, 40, 9, 3, 120
    rng = np.random.default_rng(d * 100 + a + linear)
    times = np.array([10, 11, 12], np.int32)[:b]
    # each tail: one edge of each direction per query, then random ones
    tail = np.concatenate([np.repeat(np.arange(n), 3 * b),
                           rng.integers(0, n, e - 3 * b * n)])
    ttime = np.concatenate([np.tile(np.concatenate(
        [times - 1, times, times + 1]), n), rng.integers(8, 15, len(tail)
                                                       - 3 * b * n)])
    order = np.argsort(tail, kind="stable")
    tail, ttime = tail[order].astype(np.int32), ttime[order].astype(np.int32)
    src = rng.integers(0, n, len(tail)).astype(np.int32)
    trel = rng.integers(0, 5, len(tail)).astype(np.int32)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(tail, minlength=n))]
                            ).astype(np.int32)
    vis = np.ones((n, b), bool)
    vis[0, 1] = False
    hid = (rng.normal(size=(n, b, d)) * vis[..., None]).astype(np.float32)
    f = lambda *s, scale=0.3: (rng.normal(size=s) * scale).astype(  # noqa
        np.float32)
    rela, a1, a2 = f(5, d), f(3 * d, a), f(a, 1)
    rels = rng.integers(0, 5, b).astype(np.int32)
    k = 4
    freq, t_w, t_b = f(k, scale=0.05), f(2 * k, d), f(d)
    w3, b3 = f(3, d, d), f(3, d)
    keep = vis[src]
    dirs = np.sign(ttime[:, None] - times[None, :]) + 1
    for v in range(n):
        for q in range(b):
            sel = keep[rowptr[v]:rowptr[v + 1], q]
            assert set(dirs[rowptr[v]:rowptr[v + 1], q][sel]) == {0, 1, 2}
    cfg = jtm.TemporalModelConfig(
        n_ent=n, n_rel_vocab=5, idd_rel=4, hidden_dim=d, attn_dim=a,
        n_frequencies=k, dropout=0.0, act="leakyrelu",
        direction_transform="linear" if linear else "bias")
    J = jnp.asarray
    if linear:
        past, now, future = (lambda x, w=w: x @ J(w) for w in w3)
    else:
        past, now, future = (lambda x, c=c: x + J(c) for c in b3)
    (want, want_vis), want_nodes, want_edges = jtm.TRedGNN(cfg)._dense_hop(
        (J(hid), J(vis)), J(rela), J(a1), J(a2), J(rels), J(times), J(src),
        J(trel), J(ttime), J(tail), J(rowptr), None,
        (J(freq), J(t_w), J(t_b)), None, past, now, future, None, None)
    T = torch.from_numpy
    ra, qa, tt = dh.temporal_terms(T(rela), T(a1), T(rels), T(times),
                                   int(ttime.max()) + 1, T(freq), T(t_w),
                                   T(t_b))
    h, new_vis, n_nodes, n_edges = dh.dense_hop_temporal(
        T(hid), T(vis), T(rela), T(src), T(trel), T(ttime), T(tail),
        T(rowptr), T(times), None, None, tt, ra, qa, T(a1[:d]), T(a2),
        T(w3) if linear else None, None if linear else T(b3), None, 0.0,
        "leakyrelu", "sorted_scatter", dh.tail_items(T(rowptr)))
    np.testing.assert_array_equal(new_vis.numpy(), np.asarray(want_vis))
    assert (int(n_nodes), int(n_edges)) == (int(want_nodes),
                                            int(want_edges))
    rows_close(h.numpy(), want, TOL)
