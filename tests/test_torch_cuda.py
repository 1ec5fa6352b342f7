"""Card tests of the port: the CUDA kernel and its backward against the
plain version, a small model and a train step on the card against the CPU,
and run-to-run determinism of training.

These need an NVIDIA GPU and skip without one. They import neither JAX
nor the conftest fixtures, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph, StaticKG, build_csr
from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN
from redgnn_tpu_torch.ops.segment_sorted import (
    segment_sum_sorted,
    segment_sum_sorted_checked,
    segment_sum_sorted_reference,
)
from redgnn_tpu_torch.train.loop import StaticTrainer, softmax_ce_loss
from redgnn_tpu_torch.utils.config import TrainConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ids(rng, kind, e, n):
    if kind == "random":
        seg = rng.integers(0, n, e)
    elif kind == "skewed":  # one hub segment, many empty ones
        seg = np.where(rng.random(e) < 0.7, 7, rng.integers(0, n, e))
    else:  # "out_of_range": negative and past-the-end ids are dropped
        seg = rng.integers(-20, n + 50, e)
    return np.sort(seg).astype(np.int32)


@pytest.mark.parametrize("kind,e,d,n", [
    ("random", 5000, 48, 700), ("skewed", 4096, 48, 512),
    ("out_of_range", 3000, 33, 200), ("random", 0, 48, 10),
    ("random", 2000, 100, 3000),
])
@pytest.mark.parametrize("kmax", [None, 1])
def test_kernel_matches_plain(card, kind, e, d, n, kmax):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    s = torch.from_numpy(_ids(rng, kind, e, n)).to(card)
    before = segment_sum_sorted_checked.launches
    got, ovf = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=256,
                                          bn=64)
    torch.cuda.synchronize()
    assert segment_sum_sorted_checked.launches == before + 1
    want, want_ovf = segment_sum_sorted_reference(x, s, n, kmax=kmax,
                                                  chunk=256, bn=64)
    assert bool(ovf) == bool(want_ovf)
    # the plain version adds with atomics in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    # no atomics: the kernel gives the same bits run to run
    again, _ = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=256,
                                          bn=64)
    assert torch.equal(got, again)


def _boundary_ids(rng, kind, e, n):
    if kind == "spans_shares":
        # block 0 (segments 0-15 at this n): segment 3 holds hundreds of
        # edges across many workers' shares, its neighbours a few each;
        # block 1: segment 20 alone holds the block's whole edge range
        seg = np.concatenate([rng.integers(0, 16, e // 4), np.full(e // 2, 3),
                              np.full(e - e // 4 - e // 2, 20)])
    elif kind == "one_segment":  # every edge on one segment
        seg = np.full(e, n // 2)
    elif kind == "sparse":  # N >> E: mostly empty segments
        seg = rng.integers(0, n, e)
    elif kind == "all_out_of_range":
        seg = np.where(rng.random(e) < 0.5, rng.integers(-30, 0, e),
                       rng.integers(n, n + 30, e))
    else:  # "negative_first": negative ids, then in-range ones
        seg = np.concatenate([rng.integers(-30, 0, e // 3),
                              rng.integers(0, n, e - e // 3)])
    return np.sort(seg).astype(np.int32)


@pytest.mark.parametrize("kind,e,n", [
    ("spans_shares", 3000, 64), ("one_segment", 20000, 10),
    ("sparse", 500, 200_000), ("all_out_of_range", 2000, 300),
    ("negative_first", 3000, 700),
])
@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernel_boundaries(card, kind, e, n, d, misaligned):
    rng = np.random.default_rng(0)
    # multiples of 1/8 below 8: every partial sum of 20k of them is exact
    # in fp32, so any summation order gives the plain version's bits and
    # a difference can only be a wrong partition of the edges
    x = torch.from_numpy(
        (rng.integers(-64, 64, size=(e + 1, d)) / 8).astype(np.float32))
    x = x.to(card)
    # x[1:] starts 4*d bytes in: 16-byte aligned only when d % 4 == 0, so
    # the D = 48 case is shifted by one float to leave the vector path
    data = (x.view(-1)[1:1 + e * d].view(e, d) if misaligned and d % 4 == 0
            else x[1:] if misaligned else x[:e])
    s = torch.from_numpy(_boundary_ids(rng, kind, e, n)).to(card)
    got, _ = segment_sum_sorted_checked(data, s, n)
    want, _ = segment_sum_sorted_reference(data, s, n)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, segment_sum_sorted(data, s, n))


@pytest.mark.parametrize("kmax", [1, 2, 3])
@pytest.mark.parametrize("d", [48, 33])
def test_kernel_kmax_block_not_dividing(card, kmax, d):
    # bn = 24 segments per kmax block against the kernel's 16 per block
    rng = np.random.default_rng(2)
    e, n = 6000, 5000
    x = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(card)
    ids = np.sort(np.concatenate([rng.integers(0, 60, 3000),
                                  rng.integers(0, n + 40, e - 3000)]))
    s = torch.from_numpy(ids.astype(np.int32)).to(card)
    got, ovf = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=64, bn=24)
    want, want_ovf = segment_sum_sorted_reference(x, s, n, kmax=kmax,
                                                  chunk=64, bn=24)
    torch.cuda.synchronize()
    assert bool(ovf) == bool(want_ovf)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    again, _ = segment_sum_sorted_checked(x, s, n, kmax=kmax, chunk=64,
                                          bn=24)
    assert torch.equal(got, again)


def _backward_pair(data, s, n, g):
    """(kernel's autograd.Function, plain version's autograd) gradients of
    sum(out * g) with respect to ``data``."""
    grads = []
    for fn in (segment_sum_sorted,
               lambda x, i, k: segment_sum_sorted_reference(x, i, k)[0]):
        x = data.clone().requires_grad_()
        before = segment_sum_sorted_checked.launches
        out = fn(x, s, n)
        launched = segment_sum_sorted_checked.launches - before
        assert launched == (1 if fn is segment_sum_sorted else 0)
        out.backward(g)
        grads.append(x.grad)
    torch.cuda.synchronize()
    return grads


def test_kernel_rejects_grad(card):
    """The kmax entry point stays forward only; the plain entry point is
    differentiable on the card (the test's name dates from when neither
    was)."""
    x = torch.ones(4, 2, device=card, requires_grad=True)
    s = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="forward only"):
        segment_sum_sorted_checked(x, s, 1)
    out = segment_sum_sorted(x, s, 1)
    assert out.requires_grad
    out.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    with torch.no_grad():  # no graph: the bare launch
        assert not segment_sum_sorted(x, s, 1).requires_grad


@pytest.mark.parametrize("e,d,n", [(2560, 48, 2048), (44032, 48, 8704),
                                   (170496, 48, 9984)])
def test_kernel_backward_hop_shapes(card, e, d, n):
    """Gradient through the kernel at the slice's hop shapes, padding ids
    past the end and a non-contiguous output gradient: a gather on both
    sides, so bit for bit."""
    rng = np.random.default_rng(3)
    n_valid = e * 4 // 5
    ids = np.concatenate([np.sort(rng.integers(0, n, n_valid)),
                          np.full(e - n_valid, n)]).astype(np.int32)
    data = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32))
    got, want = _backward_pair(data.to(card), torch.from_numpy(ids).to(card),
                               n, g.to(card).T)
    assert torch.equal(got, want)
    assert bool((got[n_valid:] == 0).all())


@pytest.mark.parametrize("kind,e,n", [
    ("spans_shares", 3000, 64), ("one_segment", 20000, 10),
    ("sparse", 500, 200_000), ("all_out_of_range", 2000, 300),
    ("negative_first", 3000, 700),
])
def test_kernel_backward_boundaries(card, kind, e, n):
    rng = np.random.default_rng(0)
    ids = _boundary_ids(rng, kind, e, n)
    data = torch.from_numpy(rng.normal(size=(e, 33)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 33)).astype(np.float32))
    got, want = _backward_pair(data.to(card), torch.from_numpy(ids).to(card),
                               n, g.to(card))
    assert torch.equal(got, want)
    dropped = torch.from_numpy((ids < 0) | (ids >= n))
    assert bool((got.cpu()[dropped] == 0).all())


@pytest.mark.parametrize("idx_shape", [(53504,), (20, 7)])
def test_take_rows_over_budget_backward(card, monkeypatch, idx_shape):
    """Over the one-hot budget the backward is a scatter-add by
    index_put_(accumulate=True): the same gradient as the one-hot product
    (another summation order), and the same bits on a second run."""
    from redgnn_tpu_torch.ops import gather

    rng = np.random.default_rng(5)
    r, d = 25, 48
    table = torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, r, idx_shape).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=idx_shape + (d,)).astype(np.float32))

    def grad():
        t = table.to(card).requires_grad_()
        (gather.take_rows(t, idx.to(card)) * w.to(card)).sum().backward()
        return t.grad

    onehot = grad()
    monkeypatch.setattr(gather, "_ONEHOT_BUDGET", 0)
    over, again = grad(), grad()
    assert torch.equal(over, again)
    torch.testing.assert_close(over, onehot, rtol=1e-4,
                               atol=1e-5 * float(onehot.abs().max()))
    cpu = table.clone().requires_grad_()
    (cpu[idx.long()] * w).sum().backward()
    torch.testing.assert_close(over.cpu(), cpu.grad, rtol=1e-4,
                               atol=1e-5 * float(cpu.grad.abs().max()))


def _write_kg(path, rng, n_ent=40, n_rel=4):
    """A small KG in the reference's file format (a composition rule plus
    noise), split 60/25/10/5."""
    p1, p0 = rng.permutation(n_ent), rng.permutation(n_ent)
    tri = []
    for i in range(n_ent):
        tri += [(i, 1, p1[i]), (p1[i], 0, p0[p1[i]]), (i, 2, p0[p1[i]]),
                (i, 3, rng.integers(n_ent))]
    tri = [tri[i] for i in rng.permutation(len(tri))]
    n = len(tri)
    cuts = {"facts.txt": (0, int(n * .6)), "train.txt": (int(n * .6),
            int(n * .85)), "valid.txt": (int(n * .85), int(n * .95)),
            "test.txt": (int(n * .95), n)}
    (path / "entities.txt").write_text(
        "".join(f"e{i}\n" for i in range(n_ent)))
    (path / "relations.txt").write_text(
        "".join(f"r{i}\n" for i in range(n_rel)))
    for name, (lo, hi) in cuts.items():
        (path / name).write_text(
            "".join(f"e{h}\tr{r}\te{t}\n" for h, r, t in tri[lo:hi]))
    return str(path)


TRAIN = dict(hidden_dim=16, attn_dim=5, n_layer=3, lr=0.01, lamb=1e-4,
             n_batch=8, n_tbatch=8, segment_impl="pallas", dense_hops=False,
             scan_chunk=2)


def test_train_step_on_card_matches_cpu(card, tmp_path):
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**TRAIN, dropout=0.0)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        b = cfg.n_batch
        batch = torch.as_tensor(tr.kg.train_data[:b], dtype=torch.int32,
                                device=dev)
        qmask = torch.ones(b, dtype=torch.bool, device=dev)
        scores, aux = tr.model(tr.kg.graph, batch[:, 0], batch[:, 1], qmask,
                               tr.train_caps)
        loss = softmax_ce_loss(scores, batch[:, 2], qmask)
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        before = segment_sum_sorted_checked.launches
        step_loss, overflow, num_edges = tr._train_step(
            batch[:, 0], batch[:, 1], batch[:, 2], qmask, tr.train_caps)
        launched = segment_sum_sorted_checked.launches - before
        assert launched == (cfg.n_layer if dev == "cuda" else 0)
        out[dev] = (loss.item(), [g.cpu() for g in grads], step_loss.item(),
                    bool(overflow), num_edges.cpu(), tr._flat.cpu())
    c, g = out["cpu"], out["cuda"]
    assert g[0] == pytest.approx(c[0], rel=1e-5)
    assert g[2] == pytest.approx(c[2], rel=1e-5)
    for a, b_ in zip(g[1], c[1]):
        torch.testing.assert_close(a, b_, rtol=1e-4,
                                   atol=1e-5 * float(b_.abs().max()))
    assert g[3] == c[3] is False and torch.equal(g[4], c[4])
    # one Adam step moves every weight by about lr whatever the gradient's
    # size, so a gradient's rounding shows up scaled by lr / |grad|
    torch.testing.assert_close(g[5], c[5], rtol=0, atol=1e-3)


def test_training_on_card_is_deterministic(card, tmp_path):
    """Two identical runs of 4 steps (2 chunks, dropout on) end at the
    same bits: no float atomics on the training path."""
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**TRAIN, dropout=0.2)
    ends = []
    for _ in range(2):
        kg = StaticKG.load(d, device="cuda")
        kg.train_data = kg.train_data[:4 * cfg.n_batch]
        tr = StaticTrainer(kg, cfg)
        loss = tr.train_epoch(0)
        assert int(tr.opt_state["count"]) == 4 and tr.host_syncs == 2
        ends.append((loss, tr._flat.clone(), tr.opt_state["nu"].clone()))
    assert ends[0][0] == ends[1][0]
    assert torch.equal(ends[0][1], ends[1][1])
    assert torch.equal(ends[0][2], ends[1][2])


def test_model_on_card_matches_cpu(card):
    rng = np.random.default_rng(1)
    n_ent, n_rel, b = 30, 4, 4
    tri = np.stack([rng.integers(0, n_ent, 120), rng.integers(0, 2 * n_rel, 120),
                    rng.integers(0, n_ent, 120)], 1)
    ents = np.arange(n_ent)
    tri = np.concatenate(
        [tri, np.stack([ents, np.full(n_ent, 2 * n_rel), ents], 1)])
    csr = build_csr(tri, n_ent)
    cfg = ModelConfig(n_ent=n_ent, n_rel=n_rel, hidden_dim=16, attn_dim=5,
                      n_layer=3, segment_impl="pallas", dense_hops=False)
    caps = FrontierCaps((b, 256, 256, 256), (1024, 1024, 1024))
    subs = torch.from_numpy(rng.integers(0, n_ent, b).astype(np.int32))
    rels = torch.from_numpy(rng.integers(0, 2 * n_rel, b).astype(np.int32))
    qmask = torch.tensor([True, True, True, False])
    out = {}
    for dev in ("cpu", card):
        model = RedGNN(cfg, device=dev)
        before = segment_sum_sorted_checked.launches
        with torch.inference_mode():
            out[str(dev)] = model(DeviceGraph.from_csr(*csr, n_ent, device=dev),
                                  subs.to(dev), rels.to(dev), qmask.to(dev),
                                  caps)
        launched = segment_sum_sorted_checked.launches - before
        assert launched == (3 if str(dev) == "cuda" else 0)
    (s_cpu, aux_cpu), (s_gpu, aux_gpu) = out["cpu"], out["cuda"]
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, rtol=0, atol=1e-5)
    for k in aux_cpu:
        assert torch.equal(aux_gpu[k].cpu(), aux_cpu[k]), k


@pytest.mark.parametrize("settings", [
    dict(segment_impl="pallas", dense_hops=False),
    dict(segment_impl="xla", dedup_impl="auto", dense_hops=True,
         dense_switch=0.4)], ids=["kernel_sort", "defaults_dense"])
def test_bf16_train_step_on_card_matches_cpu(card, tmp_path, settings):
    """compute_dtype='bfloat16' on the card against the CPU: scores of one
    batch within 1e-3 of the row's largest |score|, one step's loss rtol
    1e-4 and gradients within 2e-2 of each parameter's largest (the
    bounds of tests/test_torch_bf16.py); the kernel launched once a sort
    hop, and the card's bf16 scores within 5e-2 of its float32 ones."""
    d = _write_kg(tmp_path, np.random.default_rng(0))
    out = {}
    for dev, dtype in (("cpu", "bfloat16"), ("cuda", "bfloat16"),
                       ("cuda", "float32")):
        cfg = TrainConfig(**dict(TRAIN, **settings), dropout=0.0,
                          compute_dtype=dtype)
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        b = cfg.n_batch
        batch = torch.as_tensor(tr.kg.train_data[:b], dtype=torch.int32,
                                device=dev)
        qmask = torch.ones(b, dtype=torch.bool, device=dev)
        before = segment_sum_sorted_checked.launches
        scores, _ = tr.model(tr.kg.graph, batch[:, 0], batch[:, 1], qmask,
                             tr.train_caps)
        launched = segment_sum_sorted_checked.launches - before
        loss = softmax_ce_loss(scores, batch[:, 2], qmask)
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        out[dev, dtype] = (scores.detach().cpu(), loss.item(),
                           [g.cpu() for g in grads], launched)
    (s_c, l_c, g_c, n_c), (s_g, l_g, g_g, n_g) = (
        out["cpu", "bfloat16"], out["cuda", "bfloat16"])
    assert n_c == 0 and n_g == (TRAIN["n_layer"] if settings["segment_impl"]
                                == "pallas" else 0)
    scale = s_c.abs().amax(1, keepdim=True)
    assert bool(((s_g - s_c).abs() <= 1e-3 * scale).all())
    assert l_g == pytest.approx(l_c, rel=1e-4)
    for a, b_ in zip(g_g, g_c):
        assert float((a - b_).abs().max()) <= 2e-2 * float(b_.abs().max())
    torch.testing.assert_close(s_g, out["cuda", "float32"][0], rtol=5e-2,
                               atol=5e-2)


# ------------------------------------------------- dense-hop shapes, defaults

def _dense_ids(rng, e, n, kind):
    """Ascending tail ids of a small, dense KG's edge table."""
    if kind == "every_segment":
        ids = np.concatenate([np.arange(n), rng.integers(0, n, e - n)])
    else:  # "empty_segments": every third segment has no edge
        ids = rng.integers(0, n, e)
        ids[ids % 3 == 1] += 1
        ids = np.minimum(ids, n - 1)
    return np.sort(ids).astype(np.int32)


@pytest.mark.parametrize("d", [960, 2400, 20, 50])
@pytest.mark.parametrize("kind", ["every_segment", "empty_segments"])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernel_dense_hop_shapes(card, d, kind, misaligned):
    """Few segments (135) and wide rows (b*d = 960 or 2400 messages, b = 20
    or 50 live counts), as a dense hop sums them: forward against the
    plain version, same bits twice, backward bit for bit."""
    from redgnn_tpu_torch.ops.segment_sorted import _launch_plan

    rng = np.random.default_rng(4)
    e, n = 10_567, 135
    buf = torch.from_numpy(
        rng.normal(size=e * d + 1).astype(np.float32)).to(card)
    data = buf[1:].view(e, d) if misaligned else buf[:-1].view(e, d)
    s = torch.from_numpy(_dense_ids(rng, e, n, kind)).to(card)
    plan = _launch_plan(n, d, data.data_ptr())
    assert plan.vec == (d % 4 == 0 and not misaligned)
    got = segment_sum_sorted(data, s, n)
    want = segment_sum_sorted_reference(data, s, n)[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, segment_sum_sorted(data, s, n))
    if kind == "empty_segments":
        assert bool((got[1::3][:-1] == 0).all())
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card)
    g_kernel, g_plain = _backward_pair(data, s, n, g)
    assert torch.equal(g_kernel, g_plain)


def test_kernel_column_blocks_cover_wide_rows(card):
    """More column passes than blocks to spread them over: a block then
    walks several passes (the kernel source gives N = 2000 125 segment
    blocks and room for 4 column blocks; D = 1000 needs 11 passes)."""
    rng = np.random.default_rng(6)
    e, d, n = 3000, 1000, 2000
    x = torch.from_numpy(
        (rng.integers(-64, 64, size=(e, d)) / 8).astype(np.float32)).to(card)
    s = torch.from_numpy(np.sort(rng.integers(0, n, e)).astype(np.int32))
    got = segment_sum_sorted(x, s.to(card), n)
    # multiples of 1/8: every order of summation gives the same bits
    assert torch.equal(got, segment_sum_sorted_reference(x, s.to(card), n)[0])


DEFAULTS = dict(hidden_dim=16, attn_dim=5, n_layer=3, lr=0.01, lamb=1e-4,
                n_batch=8, n_tbatch=8, scan_chunk=2, dense_switch=0.4)


@pytest.mark.parametrize("segment_impl", ["xla", "pallas"])
@pytest.mark.parametrize("scan_src_backward", [True, False])
def test_registry_default_step_on_card_matches_cpu(card, tmp_path,
                                                   segment_impl,
                                                   scan_src_backward):
    """dedup 'auto' and dense hops (sparse hops bitmap under 'xla', sort
    under 'pallas', then a dense hop): loss, aux and gradients of one step
    on the card against the CPU. The prefix-sum backward of the packed
    gather gets a looser bound (its noise is O(total * eps))."""
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**DEFAULTS, dropout=0.0, segment_impl=segment_impl,
                      scan_src_backward=scan_src_backward)
    assert cfg.dedup_impl == "auto" and cfg.dense_hops
    out = {}
    for dev in ("cpu", "cuda"):
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        b = cfg.n_batch
        # hops: 256 and 512 edges sparse, 1024 >= 0.4 * 8 * 232 dense
        assert tr.train_caps.edge_caps == (256, 512, 1024)
        batch = torch.as_tensor(tr.kg.train_data[:b], dtype=torch.int32,
                                device=dev)
        qmask = torch.ones(b, dtype=torch.bool, device=dev)
        before = segment_sum_sorted_checked.launches
        scores, aux = tr.model(tr.kg.graph, batch[:, 0], batch[:, 1], qmask,
                               tr.train_caps)
        launched = segment_sum_sorted_checked.launches - before
        # 2 sparse hops + 2 launches for the dense hop, through the kernel
        assert launched == (4 if (dev, segment_impl) == ("cuda", "pallas")
                            else 0)
        loss = softmax_ce_loss(scores, batch[:, 2], qmask)
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        out[dev] = (loss.item(), [g.cpu() for g in grads],
                    {k: v.cpu() for k, v in aux.items()})
    c, g = out["cpu"], out["cuda"]
    assert g[0] == pytest.approx(c[0], rel=1e-5)
    for k in c[2]:
        assert torch.equal(g[2][k], c[2][k]), k
    rtol, atol = (1e-3, 1e-4) if scan_src_backward else (1e-4, 1e-5)
    for a, b_ in zip(g[1], c[1]):
        torch.testing.assert_close(a, b_, rtol=rtol,
                                   atol=atol * float(b_.abs().max()))


def test_registry_default_eval_on_card_matches_cpu(card, tmp_path):
    d = _write_kg(tmp_path, np.random.default_rng(0))
    cfg = TrainConfig(**DEFAULTS, dropout=0.0)
    metrics = {}
    for dev in ("cpu", "cuda"):
        tr = StaticTrainer(StaticKG.load(d, device=dev), cfg)
        metrics[dev] = tr.evaluate("valid")
    assert metrics["cuda"]["n"] == metrics["cpu"]["n"] > 0
    for k in ("mrr", "h1", "h3", "h10"):
        assert metrics["cuda"][k] == pytest.approx(metrics["cpu"][k],
                                                   rel=1e-4), k


def _temporal_dir(tmp_path, rng, n_ent=40, n_rel=3, n=400):
    """A tiny id-based temporal dir (5-column quadruples, day stamps)."""
    d = tmp_path / "toy_temporal"
    d.mkdir()
    (d / "entity2id.txt").write_text(
        "".join(f"e{i}\t{i}\n" for i in range(n_ent)))
    (d / "relation2id.txt").write_text(
        "".join(f"r{i}\t{i}\n" for i in range(n_rel)))
    q = np.stack([rng.integers(0, n_ent, n), rng.integers(0, n_rel, n),
                  rng.integers(0, n_ent, n), rng.integers(0, 30, n)], 1)
    for name, part in zip(("train", "valid", "test"),
                          np.split(q, [int(n * 0.8), int(n * 0.9)])):
        (d / f"{name}.txt").write_text(
            "".join(f"{a}\t{b}\t{c}\t{t}\t0\n" for a, b, c, t in part))
    return str(d)


@pytest.mark.parametrize("mode", ["interpolation", "extrapolation"])
def test_temporal_kernel_path_on_card_matches_cpu(card, tmp_path, mode):
    """TRedGNN with sort dedup and the kernel (a sparse hop, then dense
    hops in interpolation; windowed sparse hops in extrapolation) on the
    card against the CPU: scores, aux and every parameter's gradient; the
    kernel launches once per sparse hop and twice per dense hop."""
    from redgnn_tpu_torch.graph.temporal import TemporalKG
    from redgnn_tpu_torch.models.temporal import (
        TemporalModelConfig,
        TRedGNN,
        temporal_hop_plan,
    )
    from redgnn_tpu_torch.train.temporal_loop import (
        exact_caps,
        nll_softmax_loss,
    )
    from redgnn_tpu_torch.utils.config import TemporalTrainConfig

    path = _temporal_dir(tmp_path, np.random.default_rng(0))
    ex = mode == "extrapolation"
    tcfg = TemporalTrainConfig(mode=mode, window=6 if ex else None,
                               n_layer=3, hidden_dim=12, batch_size=8)
    kgs = {dev: TemporalKG.load_id_dir(path, graph_from_all_splits=ex,
                                       device=dev) for dev in ("cpu", "cuda")}
    kg = kgs["cpu"]
    cfg = TemporalModelConfig(
        n_ent=kg.n_ent, n_rel_vocab=kg.n_rel + 1, idd_rel=kg.idd_rel,
        hidden_dim=12, attn_dim=5, n_layer=3, dropout=0.0, mode=mode,
        window=tcfg.window, time_key_base=kg.time_key_base,
        dedup_impl="sort", segment_impl="pallas", dense_switch=0.3)
    quads = kg.splits["train"][:8]
    caps = exact_caps(kg, tcfg, quads, 8)
    plan = temporal_hop_plan(cfg, kg.graph.n_edges, caps, 8, True)
    launches = len(plan) + plan.count("dense")
    if not ex:
        assert plan[0] == "sort" and "dense" in plan, plan
    out = {}
    for dev in ("cpu", "cuda"):
        model = TRedGNN(cfg, device=dev)
        g = kgs[dev]
        b = [torch.as_tensor(quads[:, j].astype(np.int32), device=dev)
             for j in range(4)]
        qmask = torch.ones(8, dtype=torch.bool, device=dev)
        graph, etime, ekey, sl, trp, dense = g.model_args()
        before = segment_sum_sorted_checked.launches
        scores, aux = model(graph, etime, b[0], b[1], b[3], qmask, caps,
                            None, False, ekey, sl, trp, dense)
        if dev == "cuda":
            assert segment_sum_sorted_checked.launches - before == launches
        nll_softmax_loss(scores, b[2], qmask).backward()
        out[dev] = (scores.detach().cpu(),
                    {k: v.cpu() for k, v in aux.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
    (s_c, a_c, g_c), (s_g, a_g, g_g) = out["cpu"], out["cuda"]
    torch.testing.assert_close(s_g, s_c, rtol=1e-5, atol=1e-5)
    for k in ("num_nodes", "num_edges", "edge_overflow", "node_overflow"):
        assert torch.equal(a_g[k], a_c[k]), k
    assert g_g.keys() == g_c.keys()
    for n in g_c:
        scale = float(g_c[n].abs().max())
        torch.testing.assert_close(g_g[n], g_c[n], rtol=1e-4,
                                   atol=1e-5 * scale + 1e-9)


def test_edge_parallel_step_on_card_matches_single_process(card):
    """Two ranks on cuda:0 through gloo (NCCL refuses a GPU twice), mesh
    1x2: each rank sums its slice of every hop's edges through the kernel
    and the ranks all-reduce the aggregates; the summed gradient and the
    loss equal the single-process step on the card."""
    from redgnn_tpu_torch.parallel.launch import run_mesh

    import torch_mesh_workers as W

    rng = np.random.default_rng(0)
    n_ent, n_rel, b = 40, 4, 8
    tri = np.stack([rng.integers(0, n_ent, 300),
                    rng.integers(0, 2 * n_rel, 300),
                    rng.integers(0, n_ent, 300)], 1)
    ents = np.arange(n_ent)
    tri = np.concatenate([tri, np.stack([ents, np.full(n_ent, 2 * n_rel),
                                         ents], 1)])
    arrays = [a.astype(np.int32) for a in build_csr(tri, n_ent)]
    batch = [rng.integers(0, n_ent, b).astype(np.int32),
             rng.integers(0, 2 * n_rel, b).astype(np.int32),
             rng.integers(0, n_ent, b).astype(np.int32), np.ones(b, bool)]
    cfg_kw = dict(n_ent=n_ent, n_rel=n_rel, hidden_dim=16, attn_dim=5,
                  n_layer=3, dropout=0.0, segment_impl="pallas",
                  dense_hops=False)
    caps = FrontierCaps((b, 512, 512, 512), (2048, 2048, 2048))
    model = RedGNN(ModelConfig(**dict(cfg_kw, mxu_gather_backward=False)),
                   device="cuda")
    graph = DeviceGraph(*(torch.as_tensor(a, device="cuda") for a in arrays))
    subs, rels, objs, qmask = (torch.as_tensor(a, device="cuda")
                               for a in batch)
    scores, aux = model(graph, subs, rels, qmask.bool(), caps)
    assert not bool(aux["edge_overflow"].any() | aux["node_overflow"].any())
    loss = softmax_ce_loss(scores, objs, qmask.bool())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = run_mesh(W.grad_probe, 1, 2, ["cuda:0"] * 2, backend="gloo",
                   args=(arrays, cfg_kw, params, batch, caps), timeout=300)
    for o in out:
        assert not o["overflow"]
        assert o["loss"] == pytest.approx(loss.item(), rel=1e-5)
        for (name, _), g in zip(model.named_parameters(), grads):
            want = g.cpu()
            torch.testing.assert_close(
                o["grads"][name], want, rtol=1e-4,
                atol=1e-5 * float(want.abs().max()), msg=name)
