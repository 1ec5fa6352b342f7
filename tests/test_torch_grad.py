"""Gradients of the port vs jax.grad of the JAX package, on the same numpy
inputs and carried-over parameters (CPU, dropout off). Where the JAX
function reaches the Pallas kernel it runs in interpret mode, as
tests/test_segment_pallas.py runs it. Tolerances: 1e-5 for one op, 1e-4
for a layer or the model (the bound tests/test_pallas_model.py uses)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from redgnn_tpu.graph.calibrate import FrontierCaps as JCaps
from redgnn_tpu.graph.kg import DeviceGraph as JGraph
from redgnn_tpu.models import layers as jlayers
from redgnn_tpu.models import redgnn as jmodel
from redgnn_tpu.ops.frontier import expand_frontier as jexpand
from redgnn_tpu.ops.gather import take_rows as jtake_rows
from redgnn_tpu.ops.segment_pallas import _bwd as j_segment_bwd
from redgnn_tpu.ops.segment_pallas import segment_sum_pallas
from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph
from redgnn_tpu_torch.models import layers as tlayers
from redgnn_tpu_torch.ops import gather as tgather
from redgnn_tpu_torch.ops.frontier import Frontier
from redgnn_tpu_torch.ops.segment_sorted import (
    _gather_grad,
    segment_sum_sorted,
    segment_sum_sorted_checked,
)
from redgnn_tpu_torch.utils.port_params import params_from_flax

from test_torch_model import (
    A,
    D,
    DEFAULT_EDGE_CAPS,
    DEFAULTS,
    N_ENT,
    N_REL,
    jax_model,
    port_model,
)


def _ids(rng, kind, e, n):
    hi = n + 40 if kind == "out_of_range" else n
    return np.sort(rng.integers(0, hi, e)).astype(np.int32)


@pytest.mark.parametrize("kind,e,d,n", [("in_range", 300, 16, 90),
                                        ("out_of_range", 500, 48, 120)])
def test_segment_sum_sorted_grad_matches_pallas(rng, kind, e, d, n):
    seg = _ids(rng, kind, e, n)
    data = rng.normal(size=(e, d)).astype(np.float32)
    w = rng.normal(size=(n, d)).astype(np.float32)

    want = jax.grad(lambda x: jnp.sum(
        segment_sum_pallas(x, jnp.asarray(seg), n) * w))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    (segment_sum_sorted(x, torch.from_numpy(seg), n)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-5)
    if kind == "out_of_range":  # a dropped edge gets no gradient
        assert np.all(x.grad.numpy()[seg >= n] == 0)


def test_segment_backward_rule_matches_jax_bwd(rng):
    """`_gather_grad` is the backward of the kernel's autograd.Function on
    the card; here it is held to the JAX package's `_bwd` on a
    non-contiguous output gradient, and to the plain version's autograd
    where ids are negative (JAX masks only ``seg < N``)."""
    e, d, n = 400, 12, 70
    seg = _ids(rng, "out_of_range", e, n)
    g = rng.normal(size=(d, n)).astype(np.float32)
    want, _ = j_segment_bwd(n, None, (jnp.asarray(seg), e), jnp.asarray(g.T))
    g_t = torch.from_numpy(g).T
    assert not g_t.is_contiguous()
    got = _gather_grad(g_t, torch.from_numpy(seg), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    seg = np.sort(rng.integers(-20, n + 20, e)).astype(np.int32)
    x = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    x.requires_grad_()
    (segment_sum_sorted(x, torch.from_numpy(seg), n) * g_t).sum().backward()
    got = _gather_grad(g_t, torch.from_numpy(seg), n)
    assert torch.equal(got, x.grad)
    assert torch.all(got[torch.from_numpy((seg < 0) | (seg >= n))] == 0)
    assert _gather_grad(g_t[:0], torch.from_numpy(seg), 0).shape == (e, d)


def test_segment_sum_checked_is_forward_only(rng):
    x = torch.ones(4, 2, requires_grad=True)
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="forward only"):
        segment_sum_sorted_checked(x, s, 1)
    with torch.no_grad():
        out, _ = segment_sum_sorted_checked(x, s, 1)
    assert out.tolist() == [[4.0, 4.0]]


@pytest.mark.parametrize("budget", [None, 0])
@pytest.mark.parametrize("idx_shape", [(200,), (6, 7)])
def test_take_rows_grad(rng, monkeypatch, budget, idx_shape):
    """Under the one-hot budget (the matmul backward) and over it (the
    scatter-add), for flat and 2-D indices."""
    if budget is not None:
        monkeypatch.setattr(tgather, "_ONEHOT_BUDGET", budget)
    r, d = 9, 16
    table = rng.normal(size=(r, d)).astype(np.float32)
    idx = rng.integers(0, r, idx_shape).astype(np.int32)
    w = rng.normal(size=idx_shape + (d,)).astype(np.float32)

    want = jax.grad(lambda t: jnp.sum(jtake_rows(t, jnp.asarray(idx)) * w))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = tgather.take_rows(t, torch.from_numpy(idx))
    assert out.shape == idx_shape + (d,)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-5)
    # and equal to autograd of the plain gather
    t2 = torch.from_numpy(table).requires_grad_()
    (t2[torch.from_numpy(idx).long()] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), atol=1e-5)


def test_take_rows_nested_grad(rng):
    """take_rows(take_rows(rela, q_rel), batch), as RelAttnLayer calls it."""
    rela = rng.normal(size=(9, D)).astype(np.float32)
    q_rel = rng.integers(0, 9, 4).astype(np.int32)
    batch = rng.integers(0, 4, 50).astype(np.int32)
    w = rng.normal(size=(50, D)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jtake_rows(
        jtake_rows(t, jnp.asarray(q_rel)), jnp.asarray(batch)) * w))(
        jnp.asarray(rela))
    t = torch.from_numpy(rela).requires_grad_()
    (tgather.take_rows(tgather.take_rows(t, torch.from_numpy(q_rel)),
                       torch.from_numpy(batch))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-5)


def _grads_as_state_dict(jgrads):
    return params_from_flax(jax.device_get(jgrads))


@pytest.mark.parametrize("segment_impl", ["pallas", "xla"])
def test_rel_attn_layer_grad(rng, segment_impl):
    csr, jcfg, params, (subs, rels, qmask, caps) = jax_model(
        rng, 1, segment_impl)
    keys = np.where(qmask, np.arange(4) * N_ENT + subs,
                    np.iinfo(np.int32).max).astype(np.int32)
    fr = jexpand(*(jnp.asarray(a) for a in csr), N_ENT, jnp.asarray(keys),
                 1024, 256, dedup_impl="sort")
    hidden = rng.normal(size=(4, D)).astype(np.float32)
    w = rng.normal(size=(256, D)).astype(np.float32)
    layer = jlayers.RelAttnLayer(hidden_dim=D, attn_dim=A, n_rel=N_REL,
                                 segment_impl=segment_impl)

    def jloss(p, h):
        return jnp.sum(layer.apply({"params": p}, h, jnp.asarray(rels), fr,
                                   256) * w)

    gp, gh = jax.grad(jloss, argnums=(0, 1))(params["layer_0"],
                                             jnp.asarray(hidden))

    tl = tlayers.RelAttnLayer(D, A, N_REL, segment_impl=segment_impl)
    sd = params_from_flax(jax.device_get(params))
    tl.load_state_dict({k[len("layer_0."):]: v for k, v in sd.items()
                        if k.startswith("layer_0.")})
    tfr = Frontier(*(None if x is None else torch.from_numpy(np.array(x))
                     for x in fr))
    h = torch.from_numpy(hidden).requires_grad_()
    (tl(h, torch.from_numpy(rels), tfr, 256)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(gh), atol=1e-4)
    want = _grads_as_state_dict({"layer_0": gp, "gate": params["gate"],
                                 "W_final": params["W_final"]})
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[f"layer_0.{name}"].numpy(),
                                   atol=1e-4, err_msg=name)


def test_rel_attn_layer_padding_src(rng):
    """Padding edges read rows spread over the previous states instead of
    the frontier's one last slot, with or without a gradient: the layer's
    output is the same bits as with the frontier's own src, and a padding
    edge sends no gradient to the row it read."""
    csr, _, _, (subs, rels, qmask, _) = jax_model(rng, 1, "xla")
    keys = np.where(qmask, np.arange(4) * N_ENT + subs,
                    np.iinfo(np.int32).max).astype(np.int32)
    fr = jexpand(*(jnp.asarray(a) for a in csr), N_ENT, jnp.asarray(keys),
                 1024, 256, dedup_impl="sort")
    tfr = Frontier(*(None if x is None else torch.from_numpy(np.array(x))
                     for x in fr))
    n_pad = int((~tfr.edge_valid).sum())
    assert n_pad > 100
    tl = tlayers.RelAttnLayer(D, A, N_REL,
                              generator=torch.Generator().manual_seed(0))
    # 8 previous rows, of which the frontier's edges read only the first 4
    hidden = torch.from_numpy(rng.normal(size=(8, D)).astype(np.float32))
    q_rel = torch.from_numpy(rels)
    with torch.no_grad():
        served = tl(hidden, q_rel, tfr, 256)
        src = tfr.src.long()
        hs = hidden[src]
        hr = tl.rela_embed[tfr.rel.long()]
        h_qr = tl.rela_embed[q_rel.long()][tfr.batch.long()]
        alpha = torch.sigmoid(tl.w_alpha(torch.relu(
            tl.Ws_attn(hs) + tl.Wr_attn(hr) + tl.Wqr_attn(h_qr))))
        msg = torch.where(tfr.edge_valid[:, None], (hs + hr) * alpha, 0.0)
        agg = torch.zeros(257, D).index_add_(
            0, torch.where(tfr.edge_valid, tfr.dst, 256).long(), msg)[:256]
        want = torch.relu(tl.W_h(agg))
    h = hidden.clone().requires_grad_()
    trained = tl(h, q_rel, tfr, 256)
    assert torch.equal(served, trained.detach())
    torch.testing.assert_close(served, want, rtol=1e-6, atol=1e-6)
    trained.sum().backward()
    assert bool((h.grad[4:] == 0).all()) and bool((h.grad[:4] != 0).any())


@pytest.mark.parametrize("segment_impl", ["pallas", "xla"])
def test_redgnn_grad(rng, segment_impl):
    """The loss of tests/test_pallas_model.py (sum of squared scores)."""
    csr, jcfg, params, (subs, rels, qmask, caps) = jax_model(
        rng, 2, segment_impl)
    jgraph = JGraph.from_csr(*csr, N_ENT)

    def jloss(p):
        s, _ = jmodel.RedGNN(jcfg).apply(
            {"params": p}, jgraph, jnp.asarray(subs), jnp.asarray(rels),
            jnp.asarray(qmask), JCaps(*caps), False)
        return jnp.sum(s * s)

    want = _grads_as_state_dict(jax.grad(jloss)(params))
    model = port_model(jcfg, params)
    s, _ = model(DeviceGraph.from_csr(*csr, N_ENT, device="cpu"),
                 torch.from_numpy(subs), torch.from_numpy(rels),
                 torch.from_numpy(qmask), FrontierCaps(*caps))
    (s * s).sum().backward()
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, err_msg=name)
        moved += int(np.abs(want[name].numpy()).max() > 1e-6)
    assert moved >= len(want) - 1  # the gradients are not trivially zero


def _model_grads(rng, n_layer, segment_impl, **cfg_over):
    """(JAX gradients as a state dict, the port's model after backward)
    for the cross-entropy-like loss of tests/test_model_static.py."""
    csr, jcfg, params, (subs, rels, qmask, caps) = jax_model(
        rng, n_layer, segment_impl, **cfg_over)
    b = len(subs)
    objs = rng.integers(0, N_ENT, b).astype(np.int32)
    jgraph = JGraph.from_csr(*csr, N_ENT)

    def jloss(p):
        s, _ = jmodel.RedGNN(jcfg).apply(
            {"params": p}, jgraph, jnp.asarray(subs), jnp.asarray(rels),
            jnp.asarray(qmask), JCaps(*caps), False)
        logp = jax.nn.log_softmax(s, axis=-1)
        return -jnp.mean(logp[jnp.arange(b), jnp.asarray(objs)])

    want = _grads_as_state_dict(jax.grad(jloss)(params))
    model = port_model(jcfg, params)
    s, _ = model(DeviceGraph.from_csr(*csr, N_ENT, device="cpu"),
                 torch.from_numpy(subs), torch.from_numpy(rels),
                 torch.from_numpy(qmask), FrontierCaps(*caps))
    logp = torch.log_softmax(s, dim=-1)
    (-logp[torch.arange(b), torch.from_numpy(objs).long()].mean()).backward()
    return want, model


def _assert_grads(want, model, rtol, atol):
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
        moved += int(np.abs(want[name].numpy()).max() > 1e-6)
    assert moved >= len(want) - 1  # the gradients are not trivially zero


@pytest.mark.parametrize("dense_agg", ["sorted_scatter", "cumsum"])
@pytest.mark.parametrize("segment_impl", ["xla", "pallas"])
def test_redgnn_registry_defaults_grad_strict(rng, segment_impl, dense_agg):
    """Sparse hops (bitmap under xla, sort under pallas) then dense hops,
    plain hidden[src] gather on both sides (scan_src_backward=False):
    rtol 1e-4 (atol 1e-6 for entries near zero)."""
    want, model = _model_grads(
        rng, 4, segment_impl, edge_caps=DEFAULT_EDGE_CAPS,
        scan_src_backward=False, dense_agg=dense_agg, **DEFAULTS)
    _assert_grads(want, model, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("cfg_over", [
    dict(edge_caps=DEFAULT_EDGE_CAPS, **DEFAULTS),
    dict(dedup_impl="bitmap"),
], ids=["defaults", "bitmap_only"])
def test_redgnn_scan_src_backward_grad(rng, cfg_over):
    """The packed gather's prefix-sum backward on both sides: the looser
    bound tests/test_model_static.py holds it to (rtol 1e-4, atol 1e-5)."""
    want, model = _model_grads(rng, 4, "xla", scan_src_backward=True,
                               **cfg_over)
    _assert_grads(want, model, rtol=1e-4, atol=1e-5)


def test_scan_src_backward_matches_plain_in_port(rng):
    """Inside the port: gradients with the prefix-sum backward equal those
    with the plain gather (tests/test_model_static.py:237-275)."""
    grads = []
    for flag in (True, False):
        _, model = _model_grads(np.random.default_rng(5), 3, "xla",
                                dedup_impl="bitmap", scan_src_backward=flag)
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name in grads[0]:
        np.testing.assert_allclose(grads[0][name].numpy(),
                                   grads[1][name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
