"""Card tests of the port: the CUDA kernel against its plain version, and
a small model on the card against the same model on the CPU.

These need an NVIDIA GPU and skip without one. They import neither JAX
nor the conftest fixtures, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.graph.kg import DeviceGraph, build_csr
from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN
from redgnn_tpu_torch.ops.segment_sorted import (
    segment_sum_sorted,
    segment_sum_sorted_checked,
    segment_sum_sorted_reference,
)

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


def test_kernel_rejects_grad(card):
    x = torch.ones(4, 2, device=card, requires_grad=True)
    s = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError):
        segment_sum_sorted_checked(x, s, 1)


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
