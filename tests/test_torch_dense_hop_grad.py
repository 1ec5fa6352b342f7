"""The dense hop's backward (`ops/dense_hop.py`) on the CPU, where the
backward kernels' wrappers take their plain versions (`*_bwd_plain`, the
kernels' factoring written out): each plain backward against
``torch.autograd`` of its plain forward, the autograd Functions that the
models call against ``jax.grad`` of the JAX package's dense hops on the
same numpy inputs and weights, and the graph's time list.

Tolerances:
- plain backward against autograd, float64: within 1e-10 of each
  gradient's largest |value| (the same function summed in another order;
  measured ~1e-15), but softplus: 1e-8 (its derivative is taken from h
  alone, 1 - e^-h, where torch's softplus returns x above 20: e^-20 ~ 2e-9
  of a term).
- bf16 tables (static): the tables' gradients are held to autograd of a
  float64 forward on the same bf16 values whose bf16 round of hs + hr is
  passed straight through (autograd of the bf16 forward itself sums the
  tables' cotangents in bf16), within 1e-10 as above.
- the port's Functions against JAX, float32: rtol 1e-4 and atol 1e-5 of
  each gradient's largest |value|, as tests/test_torch_hop_index.py holds
  strict gradients against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redgnn_tpu.graph.kg import DeviceGraph as JGraph
from redgnn_tpu.models import layers as jlayers
from redgnn_tpu.models import temporal as jtm
from redgnn_tpu_torch.graph.kg import DeviceGraph, build_time_order
from redgnn_tpu_torch.models import layers as tlayers
from redgnn_tpu_torch.ops import dense_hop as dh

from test_torch_model import N_ENT, N_REL, make_csr

T = torch.from_numpy


def close(got, want, rtol, atol_rel, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * scale + 1e-12, err_msg=what)


# ----------------------------------------------------------- the time list

@pytest.mark.parametrize("n_time", [1, 7, 40])
def test_time_list_matches_argsort(n_time):
    """`build_time_order`: the stable argsort of the time ids and the
    offsets of each time id's run in it (empty runs included)."""
    rng = np.random.default_rng(n_time)
    ttime = rng.integers(0, max(1, n_time - 2), 300)
    order, off = build_time_order(ttime, n_time)
    np.testing.assert_array_equal(order, np.argsort(ttime, kind="stable"))
    assert order.dtype == off.dtype == np.int32
    assert off.shape == (n_time + 1,) and off[0] == 0 and off[-1] == 300
    for t in range(n_time):
        assert np.all(ttime[order[off[t]:off[t + 1]]] == t)


# ------------------------------------------------ plain backward vs autograd

def temporal_case(rng, n=9, b=5, d=6, a=4, e=60, r=5, n_time=7,
                  linear=True, time="periodic", attn=True, masks=True,
                  dtype=torch.float64):
    """Random inputs of `dense_hop_temporal_plain` (tail-sorted table,
    the terms of `temporal_terms`, masks) in ``dtype``; the float ones
    require gradients."""
    tail = np.sort(rng.integers(0, n, e))
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(tail, minlength=n))])
    ints = lambda x: T(np.asarray(x, np.int32))  # noqa: E731

    def rnd(*s, scale=1.0):
        return (T(rng.normal(size=s)) * scale).to(dtype).requires_grad_()

    inp = dict(
        hidden=rnd(n, b, d), visited=T(rng.random((n, b)) < 0.6),
        rela=rnd(r, d), tsrc=ints(rng.integers(0, n, e)),
        trel=ints(rng.integers(0, r, e)),
        ttime=ints(rng.integers(0, n_time, e)), ttail=ints(tail),
        tail_rowptr=ints(rowptr), times=ints(rng.integers(0, n_time, b)),
        excl_keep=T(rng.random(e) < 0.9) if masks else None,
        edge_keep=T(rng.random((e, b)) < 0.8) if masks else None,
        tt=rnd(n_time, b, d, scale=0.5) if time else None,
        ra=rnd(r, a) if attn else None, qa=rnd(b, a) if attn else None,
        a1s=rnd(d, a, scale=0.5) if attn else None,
        a2=rnd(a, 1, scale=0.5) if attn else None,
        wdir=rnd(3, d, d, scale=0.5) if linear else None,
        bdir=None if linear else rnd(3, d),
        drop_keep=T(rng.random((n, b, d)) < 0.7) if masks else None,
        dropout=0.3)
    return inp


TEMPORAL_PLAIN = {
    # name: temporal_case overrides
    "linear": {}, "bias": dict(linear=False),
    "wo_time": dict(time=None), "wo_attention": dict(attn=False),
    "bias_wo_both": dict(linear=False, time=None, attn=False),
    "no_masks": dict(masks=False), "two_groups": dict(b=40),
    "width_48": dict(d=48, a=30, e=40), "width_64": dict(d=64, a=64, e=30),
}
ACTS = sorted(dh.ACTS)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", list(TEMPORAL_PLAIN))
def test_temporal_plain_backward_matches_autograd(case, act):
    """`dense_hop_temporal_bwd_plain` against torch.autograd of
    `dense_hop_temporal_plain` in float64, every ablation and activation:
    every gradient within 1e-10 of its largest (softplus 1e-8)."""
    rng = np.random.default_rng(len(case) * 7 + len(act))
    inp = temporal_case(rng, **TEMPORAL_PLAIN[case])
    h, nv, _, _ = dh.dense_hop_temporal_plain(**inp, act=act)
    g = T(rng.normal(size=h.shape))
    names = ("hidden", "rela", "tt", "ra", "qa", "a1s", "a2", "wdir", "bdir")
    live = [k for k in names if inp[k] is not None]
    want = torch.autograd.grad((h * g).sum(), [inp[k] for k in live])
    plain = {k: v.detach() if torch.is_tensor(v) else v
             for k, v in inp.items() if k != "tail_rowptr"}
    got = dh.dense_hop_temporal_bwd_plain(g, h.detach(), nv, **plain,
                                          act=act)
    got = dict(zip(names, got))
    assert all((got[k] is None) == (inp[k] is None) for k in names)
    tol = 1e-8 if act == "softplus" else 1e-10
    for k, w in zip(live, want):
        close(got[k].numpy(), w.numpy(), 0, tol, k)


STATIC_PLAIN = {"b5": dict(b=5), "two_groups": dict(b=40),
                "width_48": dict(d=48, a=5), "width_64": dict(d=64, a=64)}


def static_case(rng, n=9, b=5, d=6, a=4, e=60, r=5, table=torch.float64):
    tail = np.sort(rng.integers(0, n, e))
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(tail, minlength=n))])
    ints = lambda x: T(np.asarray(x, np.int32))  # noqa: E731

    def rnd(*s, dtype=torch.float64):
        return T(rng.normal(size=s)).to(dtype).requires_grad_()

    return dict(hidden=rnd(n, b, d, dtype=table),
                visited=T(rng.random((n, b)) < 0.6),
                rela=rnd(r, d, dtype=table),
                tsrc=ints(rng.integers(0, n, e)),
                trel=ints(rng.integers(0, r, e)), ttail=ints(tail),
                tail_rowptr=ints(rowptr), wr=rnd(r, a), wq=rnd(b, a),
                ws=rnd(a, d), w_alpha=rnd(a), b_alpha=rnd(1))


def static_straight_through(hidden, visited, rela, tsrc, trel, ttail,
                            wr, wq, ws, w_alpha, b_alpha):
    """The static hop's sum in float64 from float64 tables holding bf16
    values, hs + hr rounded to bf16 in the forward and passed straight
    through in the backward (the derivative both the kernel and the plain
    backward take): autograd's referee for the tables' gradients."""
    src, rel = tsrc.long(), trel.long()
    hs = hidden[src]
    m = hs + rela[rel][:, None, :]
    m = m + (m.to(torch.bfloat16).double() - m).detach()
    pre = hs @ ws.T + wr[rel][:, None, :] + wq[None]
    alpha = torch.sigmoid(torch.relu(pre) @ w_alpha[:, None] + b_alpha)
    msg = torch.where(visited[src][..., None], m * alpha, 0.0)
    return torch.zeros((hidden.shape[0],) + msg.shape[1:],
                       dtype=msg.dtype).index_add(0, ttail.long(), msg)


@pytest.mark.parametrize("table", ["float64", "bfloat16"])
@pytest.mark.parametrize("case", list(STATIC_PLAIN))
def test_static_plain_backward_matches_autograd(case, table):
    """`dense_hop_static_bwd_plain` against torch.autograd of
    `dense_hop_static_plain` (float64 weights): every gradient within
    1e-10 of its largest. With bf16 tables the tables' gradients are held
    to autograd of `static_straight_through` (autograd of the bf16 forward
    sums the tables' cotangents in bf16), also within 1e-10."""
    rng = np.random.default_rng(len(case) + len(table))
    dtype = getattr(torch, table)
    inp = static_case(rng, table=dtype, **STATIC_PLAIN[case])
    agg, _, _ = dh.dense_hop_static_plain(**inp)
    g = T(rng.normal(size=agg.shape))
    names = ("hidden", "rela", "wr", "wq", "ws", "w_alpha", "b_alpha")
    want = list(torch.autograd.grad((agg * g).sum(),
                                    [inp[k] for k in names]))
    if table == "bfloat16":
        ref = {k: v.detach().double().requires_grad_()
               if k in ("hidden", "rela") else v for k, v in inp.items()
               if k != "tail_rowptr"}
        out = static_straight_through(**ref)
        want[:2] = torch.autograd.grad((out * g).sum(),
                                       [ref["hidden"], ref["rela"]])
    plain = {k: v.detach() for k, v in inp.items() if k != "tail_rowptr"}
    got = dh.dense_hop_static_bwd_plain(g, **plain)
    assert got[0].dtype == got[1].dtype == torch.float64
    for k, x, w in zip(names, got, want):
        close(x.numpy(), w.double().numpy(), 0, 1e-10, k)


def test_bwd_bound_holds_the_plain_float32():
    """`bwd_bound` (the card's float64 check) passes the float32 plain
    backward against its float64 run, and fails a gradient off by more
    than the bound; at this size no pre-activation lies within rounding
    of 0, so the kinks term is 0."""
    rng = np.random.default_rng(5)
    inp = temporal_case(rng, dtype=torch.float32, b=7)
    h, nv, _, _ = dh.dense_hop_temporal_plain(**inp, act="leakyrelu")
    g = T(rng.normal(size=h.shape).astype(np.float32))
    plain = {k: v.detach() if torch.is_tensor(v) else v
             for k, v in inp.items() if k != "tail_rowptr"}
    args = dict(g_h=g, h=h.detach(), new_visited=nv, **plain,
                act="leakyrelu")
    got = dh.dense_hop_temporal_bwd_plain(**args)
    ref = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
           else v for k, v in args.items()}
    want = dh.dense_hop_temporal_bwd_plain(**ref)
    s_abs = dh.dense_hop_temporal_bwd_plain(**ref, absolute=True)
    kinks = dh.dense_hop_temporal_bwd_plain(**ref, kinks=True)
    n, b, _ = inp["hidden"].shape
    m = dh.bwd_term_counts("temporal", inp["tsrc"], inp["trel"],
                           inp["ttime"], b, n, inp["rela"].shape[0],
                           inp["tt"].shape[0])
    assert dh.bwd_bound(got, want, s_abs, m, got, kinks) <= 1.0
    bad = list(got)
    bad[7] = bad[7] + 1e-2 * float(want[7].abs().max())
    assert dh.bwd_bound(bad, want, s_abs, m, got, kinks) > 1.0
    # a flipped relu mask: the kinks term is the whole of the flipped
    # terms, and 0 where no pre-activation lies within rounding of 0
    assert all(k is None or float(k.abs().max()) == 0.0 for k in kinks)



def test_bwd_bound_holds_parameter_sums_to_their_scale():
    """A parameters' sum that loses a block's share of its terms fails the
    check by its scale, also at a count as large as 7a's 4.9M pairs, where
    the sum|x| term alone would let it through; with the kernel's
    ``chain`` the sums' m is that chain, the sums by an index keep their
    counts."""
    rng = np.random.default_rng(6)
    inp = temporal_case(rng, dtype=torch.float32, b=7)
    h, nv, _, _ = dh.dense_hop_temporal_plain(**inp, act="relu")
    g = T(rng.normal(size=h.shape).astype(np.float32))
    args = dict(g_h=g, h=h.detach(), new_visited=nv, act="relu",
                **{k: v.detach() if torch.is_tensor(v) else v
                   for k, v in inp.items() if k != "tail_rowptr"})
    got = dh.dense_hop_temporal_bwd_plain(**args)
    ref = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
           else v for k, v in args.items()}
    want = dh.dense_hop_temporal_bwd_plain(**ref)
    s_abs = dh.dense_hop_temporal_bwd_plain(**ref, absolute=True)
    n, b, _ = inp["hidden"].shape
    counts = dict(tsrc=inp["tsrc"], trel=inp["trel"], ttime=inp["ttime"],
                  b=b, n=n, r=inp["rela"].shape[0], n_time=inp["tt"].shape[0])
    m = dh.bwd_term_counts("temporal", **counts)
    e = inp["tsrc"].shape[0]
    assert int(m[5]) == e * b and int(m[4]) == e
    chained = dh.bwd_term_counts("temporal", **counts, plan={"chain": 40})
    assert [int(chained[k]) for k in (4, 5, 6, 7)] == [min(e, 40), 40, 40, 40]
    assert torch.equal(chained[0], m[0]) and torch.equal(chained[1], m[1])
    assert dh.bwd_bound(got, want, s_abs, chained, got) <= 1.0
    seven_a = [torch.tensor(4_900_000) if x.dim() == 0 else x for x in m]
    for k in (4, 5, 6, 7):  # d_qa, d_a1s, d_a2, d_wdir: one block of 264 lost
        bad = list(got)
        bad[k] = got[k] * (1 - 1 / 264)
        for counts in (m, seven_a):
            shares = dh.bwd_shares(bad, want, s_abs, counts, got)
            assert shares[k] > 1.0, (k, shares)

# ------------------------------------------------------ Functions vs JAX

def layer_state(p):
    """The port's RelAttnLayer state dict from flax's RelAttnLayer tree
    (`params_from_flax`'s rule for a model's layer: kernels transposed)."""
    sd = {"rela_embed": T(np.asarray(p["rela_embed"]))}
    for lin in ("Ws_attn", "Wr_attn", "W_h", "Wqr_attn", "w_alpha"):
        sd[f"{lin}.weight"] = T(np.asarray(p[lin]["kernel"]).T.copy())
        if "bias" in p[lin]:
            sd[f"{lin}.bias"] = T(np.asarray(p[lin]["bias"]))
    return sd


def jax_static_layer(d, a, b, seed):
    layer = jlayers.RelAttnLayer(hidden_dim=d, attn_dim=a, n_rel=N_REL)
    rng = np.random.default_rng(seed)
    csr = make_csr(rng)
    vis = rng.random((N_ENT, b)) < 0.4
    hd = (rng.normal(size=(N_ENT, b, d)) * vis[..., None]).astype(np.float32)
    q_rel = rng.integers(0, 2 * N_REL, b).astype(np.int32)
    jg = JGraph.from_csr(*csr, N_ENT)
    args = (jnp.asarray(vis), jnp.asarray(q_rel), jg.tsrc, jg.trel, jg.ttail,
            jg.tail_rowptr)
    params = jax.jit(lambda k: layer.init(
        k, jnp.asarray(hd), *args,
        method=jlayers.RelAttnLayer.dense))(jax.random.PRNGKey(seed))
    return layer, params["params"], csr, vis, hd, q_rel, args


@pytest.mark.parametrize("d,a,b,dense_agg", [
    (16, 5, 3, "sorted_scatter"), (16, 5, 3, "cumsum"),
    (8, 4, 40, "sorted_scatter"), (48, 5, 4, "sorted_scatter"),
    (64, 64, 3, "sorted_scatter")])
def test_static_function_grads_match_jax(d, a, b, dense_agg):
    """RelAttnLayer.dense with gradients on (`dense_hop_static_fn`: the
    plain forward and backward here) against jax.grad of flax's
    RelAttnLayer.dense on the same inputs and weights: the state's and
    every parameter's gradient within rtol 1e-4 + 1e-5 of its largest."""
    layer, params, csr, vis, hd, q_rel, args = jax_static_layer(
        d, a, b, d * 10 + b)
    w = np.random.default_rng(b).normal(size=hd.shape).astype(np.float32)

    def loss(p, h):
        out = layer.apply({"params": p}, h, *args, dense_agg,
                          method=jlayers.RelAttnLayer.dense)[0]
        return jnp.sum(out * jnp.asarray(w))

    gp, gh = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(hd))
    tl = tlayers.RelAttnLayer(d, a, N_REL)
    tl.load_state_dict(layer_state(params))
    g = DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    h = T(hd).requires_grad_()
    out, _, _ = tl.dense(h, T(vis), T(q_rel), g.tsrc, g.trel, g.ttail,
                         g.tail_rowptr, dense_agg, g.tsrc_order, g.rowptr,
                         g.tail_items)
    (out * T(w)).sum().backward()
    close(h.grad.numpy(), gh, 1e-4, 1e-5, "state")
    want = layer_state(gp)
    for k, p in tl.named_parameters():
        close(p.grad.numpy(), want[k].numpy(), 1e-4, 1e-5, k)


TEMPORAL_JAX = {
    # name: (temporal_case overrides, activation, dropout, edge dropout,
    #        leave-one-out, dense_agg)
    "linear": ({}, "leakyrelu", 0.0, 0.0, False, "sorted_scatter"),
    "bias": (dict(linear=False), "leakyrelu", 0.0, 0.0, False,
             "sorted_scatter"),
    "wo_time": (dict(time=None), "tanh", 0.0, 0.0, True, "sorted_scatter"),
    "absolute_time": (dict(time="absolute"), "sigmoid", 0.0, 0.0, True,
                      "sorted_scatter"),
    "wo_attention": (dict(attn=False), "softplus", 0.0, 0.0, False,
                     "sorted_scatter"),
    "relu_cumsum": ({}, "relu", 0.0, 0.0, False, "cumsum"),
    "idd": ({}, "idd", 0.0, 0.0, False, "sorted_scatter"),
    "dropouts_loo": ({}, "leakyrelu", 0.3, 0.2, True, "sorted_scatter"),
    "two_groups": (dict(b=40, e=50), "leakyrelu", 0.0, 0.0, True,
                   "sorted_scatter"),
    "width_48": (dict(d=48, a=40, e=50), "leakyrelu", 0.0, 0.0, True,
                 "sorted_scatter"),
    "width_64": (dict(d=64, a=64, e=40, linear=False), "tanh", 0.0, 0.0,
                 False, "sorted_scatter"),
}


@pytest.mark.parametrize("case", list(TEMPORAL_JAX))
def test_temporal_function_grads_match_jax(case):
    """`dense_hop_temporal_fn` (the plain forward and backward here) on the
    terms of `temporal_terms` against jax.grad of the JAX package's
    ``TRedGNN._dense_hop`` on the same numpy inputs and weights (periodic
    time term, or the absolute table, or none), the dropout and edge
    dropout masks that JAX draws fed to the port: h within 1e-5 of its
    largest and every input's gradient within rtol 1e-4 + 1e-5 of its
    largest."""
    over, act, p_drop, p_edge, loo, dense_agg = TEMPORAL_JAX[case]
    over = dict(dict(n=10, b=4, d=8, a=6, e=70, r=5, n_time=6), **over)
    rng = np.random.default_rng(len(case))
    n, b, d, a, e, r, n_time = (over[k] for k in
                                ("n", "b", "d", "a", "e", "r", "n_time"))
    linear = over.get("linear", True)
    time = over.get("time", "periodic")
    attn = over.get("attn", True)
    tail = np.sort(rng.integers(0, n, e)).astype(np.int32)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(tail, minlength=n))]
                            ).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    trel = rng.integers(0, r, e).astype(np.int32)
    ttime = rng.integers(0, n_time, e).astype(np.int32)
    times = rng.integers(0, n_time, b).astype(np.int32)
    rels = rng.integers(0, r, b).astype(np.int32)
    vis = rng.random((n, b)) < 0.6
    excl = rng.random(e) < 0.85 if loo else None
    f = lambda *s, scale=0.5: (rng.normal(size=s) * scale).astype(  # noqa
        np.float32)
    hid = (f(n, b, d, scale=1.0) * vis[..., None]).astype(np.float32)
    k = 4
    floats = dict(hidden=hid, rela=f(r, d), a1=f(3 * d, a), a2=f(a, 1),
                  freq=f(k, scale=0.05), t_w=f(2 * k, d), t_b=f(d),
                  abs_table=f(n_time, d), w3=f(3, d, d), b3=f(3, d))
    cfg = jtm.TemporalModelConfig(
        n_ent=n, n_rel_vocab=r, idd_rel=r - 1, hidden_dim=d, attn_dim=a,
        n_frequencies=k, dropout=p_drop, edge_dropout=p_edge, act=act,
        use_time=time is not None, use_attention=attn,
        time_embedding="absolute" if time == "absolute" else "periodic",
        n_time=n_time, dense_agg=dense_agg,
        direction_transform="linear" if linear else "bias")
    drop_rng, edrop_rng = jax.random.split(jax.random.PRNGKey(len(case)))
    drop_rng = drop_rng if p_drop else None
    edrop_rng = edrop_rng if p_edge else None
    J = jnp.asarray
    w_out = f(n, b, d, scale=1.0)

    def jhop(x):
        if linear:
            past, now, future = (lambda m, i=i: m @ x["w3"][i]
                                 for i in range(3))
        else:
            past, now, future = (lambda m, i=i: m + x["b3"][i]
                                 for i in range(3))
        (h, _), _, _ = jtm.TRedGNN(cfg)._dense_hop(
            (x["hidden"], J(vis)), x["rela"], x["a1"], x["a2"], J(rels),
            J(times), J(src), J(trel), J(ttime), J(tail), J(rowptr),
            None if excl is None else J(excl),
            (x["freq"], x["t_w"], x["t_b"]) if time == "periodic" else None,
            x["abs_table"] if time == "absolute" else None, past, now,
            future, drop_rng, edrop_rng)
        return h

    def jloss(x):
        h = jhop(x)
        return jnp.sum(h * J(w_out)), h

    jx = {key: J(v) for key, v in floats.items()}
    (_, want_h), want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jx)
    # the masks JAX draws, drawn here the same way
    edge_keep = (np.array(jax.random.bernoulli(
        edrop_rng, 1.0 - p_edge, (e, b))) if p_edge else None)
    drop_keep = (np.array(jax.random.bernoulli(
        drop_rng, 1.0 - p_drop, (n, b, d))) if p_drop else None)

    tx = {key: T(v).requires_grad_() for key, v in floats.items()}
    ra, qa, tt = dh.temporal_terms(
        tx["rela"], tx["a1"], T(rels), T(times), n_time,
        tx["freq"] if time == "periodic" else None, tx["t_w"], tx["t_b"],
        tx["abs_table"] if time == "absolute" else None,
        use_attention=attn)
    h, _, _, _ = dh.dense_hop_temporal_fn(
        tx["hidden"], T(vis), tx["rela"], T(src), T(trel), T(ttime),
        T(tail), T(rowptr), T(times), None if excl is None else T(excl),
        None if edge_keep is None else T(edge_keep), tt, ra, qa,
        tx["a1"][:d] if attn else None, tx["a2"] if attn else None,
        torch.stack([tx["w3"][i] for i in range(3)]) if linear else None,
        None if linear else torch.stack([tx["b3"][i] for i in range(3)]),
        None if drop_keep is None else T(drop_keep), p_drop, act,
        dense_agg, dh.tail_items(T(rowptr)))
    close(h.detach().numpy(), want_h, 0, 1e-5, "h")
    (h * T(w_out)).sum().backward()
    for key, x in tx.items():
        w = np.asarray(want[key])
        got = (x.grad.numpy() if x.grad is not None
               else np.zeros_like(w))
        close(got, w, 1e-4, 1e-5, key)
