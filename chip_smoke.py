#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (redgnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(time_kernel_variants.py times other builds of the kernel at the same
hop shapes.)

Phases (any failure raises, and the script exits non-zero):
  1. device: the card's name and power limit; TF32 off.
  2. build: compile the sorted-segment-sum kernel from csrc/ with nvcc.
  3. kernel vs plain: the kernel against its plain PyTorch version on the
     card, at the shapes of the slice's own hops (batch 50, L=3, D=48)
     plus skewed / empty / out-of-range / kmax-overflow / scalar-path
     cases; per hop, the kernel's time with its inputs in L2 (as in the
     path), with L2 flushed and with no edges, its share of the byte
     bound, the plain version, one library call and one eager wrapper
     call.
  4. the slice end to end: a seeded synthetic KG of the family dataset's
     size, written in the reference's file format and loaded with
     StaticKG.load; RedGNN at family width (hidden 48, attn 5, L=3, relu)
     with seeded random weights, segment_impl='pallas' (the kernel),
     dense_hops=False; Predictor(split='test', top_k=10) answers batches
     of 50 queries. The launch counter must show the kernel on every hop;
     one batch's scores must equal the same model on the CPU.
The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed. Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N_ENT, N_REL = 3007, 12          # the family dataset's vocabulary sizes
N_GRAPH_TRIPLES = 27_000         # facts + train; ~57k edges once doubled
N_VALID, N_TEST = 2_000, 2_800
N_BATCHES = 8                    # served batches of n_tbatch=50 queries
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
L2_FLUSH_BYTES = 256 * 2 ** 20   # read between calls: 5x the 50 MB L2
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)  # summation order differs


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- data

def write_synthetic_kg(path: str, seed: int = SEED) -> None:
    """A family-sized KG in the reference's file format.

    Entities fall into communities (family trees) of skewed size; the
    triples of a community stay inside it, and its heads are drawn with
    Zipf weights, so a few members are hubs."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < N_ENT:
        sizes.append(int(np.clip(rng.lognormal(4.9, 0.5), 8, 400)))
    sizes[-1] -= sum(sizes) - N_ENT
    if sizes[-1] < 2:
        sizes[-2] += sizes.pop()
    perm = rng.permutation(N_ENT)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    comm_weight = np.array(sizes, float) / N_ENT

    need = N_GRAPH_TRIPLES + N_VALID + N_TEST
    triples = np.empty((0, 3), np.int64)
    while len(triples) < need:
        n = 2 * (need - len(triples))
        c = rng.choice(len(sizes), size=n, p=comm_weight)
        size = np.asarray(sizes)[c]
        u = rng.random(n)
        # Zipf-like head rank inside the community, uniform tail
        h_rank = np.minimum((size * u ** 2.5).astype(np.int64), size - 1)
        t_rank = rng.integers(0, size)
        h = perm[bounds[c] + h_rank]
        t = perm[bounds[c] + t_rank]
        r = rng.integers(0, N_REL, n)
        keep = h != t
        new = np.stack([h, r, t], 1)[keep]
        triples = np.unique(np.concatenate([triples, new]), axis=0)
    triples = triples[rng.permutation(len(triples))[:need]]

    n_fact = N_GRAPH_TRIPLES * 3 // 4
    splits = {
        "facts.txt": triples[:n_fact],
        "train.txt": triples[n_fact:N_GRAPH_TRIPLES],
        "valid.txt": triples[N_GRAPH_TRIPLES:N_GRAPH_TRIPLES + N_VALID],
        "test.txt": triples[N_GRAPH_TRIPLES + N_VALID:],
    }
    with open(os.path.join(path, "entities.txt"), "w") as f:
        f.write("".join(f"e{i}\n" for i in range(N_ENT)))
    with open(os.path.join(path, "relations.txt"), "w") as f:
        f.write("".join(f"r{i}\n" for i in range(N_REL)))
    for name, tri in splits.items():
        with open(os.path.join(path, name), "w") as f:
            f.write("".join(f"e{h}\tr{r}\te{t}\n" for h, r, t in tri))


def build_slice(data_dir: str, device: str):
    """(kg, cfg, model, predictor) of the slice on ``device``."""
    from redgnn_tpu_torch.graph.kg import StaticKG
    from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN
    from redgnn_tpu_torch.serve import Predictor
    from redgnn_tpu_torch.utils.config import dataset_config

    cfg = dataset_config("static_transductive", "family",
                         segment_impl="pallas", dense_hops=False)
    kg = StaticKG.load(data_dir, device=device)
    model = RedGNN(ModelConfig(
        n_ent=kg.n_ent, n_rel=kg.n_rel, hidden_dim=cfg.hidden_dim,
        attn_dim=cfg.attn_dim, n_layer=cfg.n_layer, act=cfg.act,
        segment_impl=cfg.segment_impl, dedup_impl=cfg.dedup_impl,
        dense_hops=cfg.dense_hops),
        device=device, generator=torch.Generator().manual_seed(SEED))
    pred = Predictor(model, None, kg, cfg, split="test", top_k=10)
    return kg, cfg, model, pred


def serving_queries(kg, n: int, seed: int = SEED) -> np.ndarray:
    """``n`` grouped test queries (head, rel) in a seeded random order."""
    q = kg.eval_spec("test").queries
    return q[np.random.default_rng(seed).permutation(len(q))[:n]]


def batch_tensors(pred, queries: np.ndarray):
    dev = pred.model.device
    b = len(queries)
    subs = torch.as_tensor(queries[:, 0], dtype=torch.int32, device=dev)
    rels = torch.as_tensor(queries[:, 1], dtype=torch.int32, device=dev)
    return subs, rels, torch.ones(b, dtype=torch.bool, device=dev)


def hop_inputs(pred, queries: np.ndarray):
    """The (dst, edge_valid, node_cap) that each hop of one batch hands to
    the segment sum: the real dst-sorted layout of the slice."""
    from redgnn_tpu_torch.ops.frontier import SENTINEL, expand_frontier

    g, caps, n_ent = pred.graph, pred.caps, pred.model.cfg.n_ent
    subs, _, qmask = batch_tensors(pred, queries)
    keys = subs + torch.arange(len(queries), dtype=torch.int32,
                               device=subs.device) * n_ent
    keys = torch.where(qmask, keys, SENTINEL)
    out = []
    for i in range(pred.model.cfg.n_layer):
        fr = expand_frontier(g.rowptr, g.rel, g.tail, n_ent, keys,
                             caps.edge_caps[i], caps.node_caps[i + 1])
        out.append((fr.dst, fr.edge_valid, caps.node_caps[i + 1]))
        keys = fr.node_keys
    return out


def topk_untied_agree(s_a, e_a, s_b, e_b, tol):
    """Scores within ``tol``; entities equal wherever a rank's score is not
    tied (within ``tol``) with a neighbouring rank. Returns the number of
    untied ranks compared."""
    assert np.allclose(s_a, s_b, rtol=0, atol=tol), np.abs(s_a - s_b).max()
    gap = np.diff(s_b, axis=1) < -tol
    untied = np.ones_like(s_b, dtype=bool)
    untied[:, 1:] &= gap
    untied[:, :-1] &= gap
    untied[:, -1] = False  # may tie with the first rank past k
    assert np.array_equal(e_a[untied], e_b[untied])
    return int(untied.sum())


# ------------------------------------------------------------- timing

def call_ms(fn, rounds: int = 5, iters: int = 20,
            warmup: int = 5) -> tuple[float, float]:
    """(least, median) over ``rounds`` of the mean time of ``iters``
    back-to-back eager calls of ``fn``, CUDA events around each round: for
    a small kernel this is the host's launch path (Python wrapper,
    allocations, ctypes), not the device. The host is shared, so a round's
    mean varies up to 2x; the least is the path's own cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return min(times), float(np.median(times))


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device time of one call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events, so the
    host's launch path leaves no gaps. Inputs stay in L2 across calls
    when they fit (50 MB), as in the path, where the segment sum reads a
    message written just before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def flushed_ms(fn) -> float:
    """Mean device time of one call of ``fn`` with its inputs evicted from
    L2: ``device_ms`` of (read a 256 MB buffer, call) minus ``device_ms``
    of the read alone. A read leaves L2 clean, so the call pays for its
    own misses and not for writing back the flush."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                     device="cuda")

    def both():
        buf.amax()
        fn()

    return device_ms(both) - device_ms(lambda: buf.amax())


# ------------------------------------------------------------- phases

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch.cuda.get_device_name: {name}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    return name, smi


def log_ptxas(text: str) -> None:
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] ptxas: {line.strip()}")


def phase_build():
    from redgnn_tpu_torch import _build

    res = _build.build("segment_sum_sorted")
    log(f"[build] segment_sum_sorted.cu -> {os.path.relpath(res['path'])} "
        f"in {res['seconds']:.2f} s (nvcc, sm_90a)")
    log_ptxas(res["log"])


def kernel_hops(pred, queries):
    """[(msg, seg, dst, n_valid, n)] of each hop of one batch: the real
    dst-sorted layout with seeded random messages; padding edges go past
    the end (``seg``), as RelAttnLayer sends them."""
    dev = pred.model.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hops = []
    for dst, valid, n in hop_inputs(pred, queries):
        msg = torch.randn(dst.shape[0], pred.model.cfg.hidden_dim,
                          generator=gen, device=dev)
        msg = torch.where(valid[:, None], msg, 0.0)
        hops.append((msg, torch.where(valid, dst, n), dst,
                     int(valid.sum()), n))
    return hops


def phase_kernel(pred, queries, card):
    from redgnn_tpu_torch.ops.segment_sorted import (
        SEGS_PER_BLOCK,
        _launch_plan,
        segment_sum_sorted,
        segment_sum_sorted_checked,
        segment_sum_sorted_reference,
    )

    dev = pred.model.device
    d = pred.model.cfg.hidden_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0

    def check(data, ids, n, kmax=None, chunk=1024, bn=512):
        nonlocal max_err
        got, ovf = segment_sum_sorted_checked(data, ids, n, kmax, chunk, bn)
        want, want_ovf = segment_sum_sorted_reference(data, ids, n, kmax,
                                                      chunk, bn)
        again, _ = segment_sum_sorted_checked(data, ids, n, kmax, chunk, bn)
        torch.cuda.synchronize()
        assert bool(ovf) == bool(want_ovf), (bool(ovf), bool(want_ovf))
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        assert torch.equal(got, again), "two calls gave different bits"
        max_err = max(max_err, float((got - want).abs().max()))
        return bool(ovf)

    hops = kernel_hops(pred, queries)
    for msg, seg, _, _, n in hops:
        check(msg, seg, n)
    # hop-3 shape, kmax too small: the flag fires and tails are dropped
    msg, seg, dst, _, n = hops[-1]
    assert check(msg, seg, n, kmax=1), "kmax=1 should overflow at hop 3"
    check(msg, dst, n)  # the frontier's own dst: padding on the last row
    # the same rows 4 bytes off alignment take the 4-byte-load path
    buf = torch.empty(msg.numel() + 1, device=dev)
    odd = buf[1:].view(msg.shape)
    odd.copy_(msg)
    assert not _launch_plan(n, d, odd.data_ptr()).vec
    check(odd, seg, n)
    check(msg[:, :33].contiguous(), seg, n)  # D = 33: 4-byte loads too
    # hub segments of up to 300 edges (the path's largest in-degree is
    # ~260), empty (odd) segments, out-of-range pad ids
    e = msg.shape[0]
    rng = np.random.default_rng(SEED)
    sizes = np.minimum(rng.zipf(1.5, n // 2), 300)
    ids = np.repeat(np.arange(0, n, 2)[:len(sizes)], sizes)[:e * 9 // 10]
    ids = np.concatenate([ids, rng.integers(n, n + 100, e - len(ids))])
    ids = torch.as_tensor(np.sort(ids).astype(np.int32), device=dev)
    data = torch.randn(e, d, generator=gen, device=dev)
    check(data, ids, n)
    check(data, ids, n, kmax=2, chunk=256, bn=64)
    log(f"[kernel] segment_sum_sorted == plain on the card at hop shapes "
        f"{[(h[0].shape[0], d, h[-1]) for h in hops]} (E, D, N) and "
        f"skew/empty/out-of-range/kmax/misaligned/D=33 cases, same bits "
        f"on a second call; max |diff| {max_err:.3g}")

    ms = plain = lib = bound = 0.0
    hop_rows = []
    for i, (msg, seg, dst, n_valid, n) in enumerate(hops):
        idx = dst.long()  # in range: index_add_ raises on the rest
        t_k = device_ms(lambda: segment_sum_sorted(msg, seg, n))
        t_f = flushed_ms(lambda: segment_sum_sorted(msg, seg, n))
        # the launch with no edges: grid, prologue and zero rows only
        t_0 = device_ms(lambda: segment_sum_sorted(msg[:0], seg[:0], n))
        t_p = device_ms(lambda: segment_sum_sorted_reference(msg, seg, n))
        t_l = device_ms(lambda: torch.zeros(n, d, device=dev).index_add_(
            0, idx, msg))
        t_call = call_ms(lambda: segment_sum_sorted(msg, seg, n))
        t_chk = call_ms(lambda: segment_sum_sorted_checked(msg, seg, n))
        e = msg.shape[0]
        # rows of valid edges read once, ids read once, output written once
        b_ms = (n_valid * d * 4 + e * 4 + n * d * 4) / HBM_BYTES_PER_S * 1e3
        plan = _launch_plan(n, d, msg.data_ptr())
        log(f"[kernel] hop {i}: E={e} ({n_valid} valid) D={d} N={n}, "
            f"{plan.grid} blocks of {SEGS_PER_BLOCK} segments, "
            f"vec={plan.vec}: kernel {t_k:.4f} ms with inputs in L2, "
            f"{t_f:.4f} ms with L2 flushed, {t_0:.4f} ms with no edges; "
            f"byte bound {b_ms * 1e3:.2f} us "
            f"= {b_ms / t_k:.1%} of the L2-warm time, {b_ms / t_f:.1%} of "
            f"the flushed; plain {t_p:.4f} ms, index_add_ {t_l:.4f} ms "
            f"(device, CUDA graph); one eager wrapper call "
            f"{t_call[0]:.4f} ms (segment_sum_sorted; median of rounds "
            f"{t_call[1]:.4f}), {t_chk[0]:.4f} ms (segment_sum_sorted_"
            f"checked; median {t_chk[1]:.4f}), least of 5 rounds of 20 "
            f"calls ({card})")
        hop_rows.append({"E": e, "valid": n_valid, "N": n, "ms": t_k,
                         "bound_ms": b_ms, "ms_l2_flushed": t_f,
                         "ms_no_edges": t_0, "call_ms": t_call[0]})
        ms, plain, lib, bound = ms + t_k, plain + t_p, lib + t_l, bound + b_ms
    t_pile = device_ms(lambda: segment_sum_sorted(msg, dst, n))
    log(f"[kernel] hop {len(hops) - 1} with the frontier's own dst (its "
        f"{e - n_valid} padding edges all on segment {int(dst[-1])}): "
        f"kernel {t_pile:.4f} ms ({card})")
    log(f"[kernel] per batch ({len(hops)} launches): kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, index_add_ {lib:.4f} ms, byte bound "
        f"{bound * 1e3:.2f} us at 3.35 TB/s ({card})")
    return {"name": "segment_sum_sorted", "route": "cuda",
            "source": "redgnn_tpu_torch/csrc/segment_sum_sorted.cu",
            "replaces": "redgnn_tpu/ops/segment_pallas.py:145",
            "launches": None,  # set from the main path's run
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib,
            "hops": hop_rows}


def profile_batches(pred, queries, card):
    """Device busy share and the largest kernels over a few served
    batches (torch.profiler); prints "not measured" if the profiler sees
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = pred.batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(0, len(queries), b):
            pred.predict(queries[k:k + b, 0], queries[k:k + b, 1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"[profile] device time not measured: the profiler saw no "
            f"device activity ({card})")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    n_batches = -(-len(queries) // b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {n_batches} batches: wall {wall_us / n_batches:.1f} us "
        f"per batch under the profiler, device busy "
        f"{busy / n_batches:.1f} us per batch, idle share "
        f"{1 - busy / wall_us:.3f}; {len(kernels) // n_batches} device "
        f"activities per batch ({card})")
    for name, us in top:
        log(f"[profile]   {us / n_batches:9.1f} us/batch  {name[:90]}")


def phase_slice(kg, model, pred, queries, card):
    from redgnn_tpu_torch.models.redgnn import RedGNN
    from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted_checked

    b = pred.batch
    assert b == 50 and model.cfg.hidden_dim == 48 and \
        model.cfg.attn_dim == 5 and model.cfg.n_layer == 3
    log(f"[slice] KG: {kg.n_ent} entities, {kg.n_rel} relations, "
        f"{len(kg.fact) + len(kg.train)} fact+train triples, "
        f"{kg.eval_graph.n_edges} edges with inverses and self-loops; "
        f"caps node {pred.caps.node_caps} edge {pred.caps.edge_caps}")
    pred.predict(queries[:b, 0], queries[:b, 1])  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    segment_sum_sorted_checked.launches = 0
    times, out_s, out_e = [], [], []
    for k in range(N_BATCHES):
        q = queries[k * b:(k + 1) * b]
        t0 = time.perf_counter()
        s, e = pred.predict(q[:, 0], q[:, 1])  # raises on overflow
        times.append((time.perf_counter() - t0) * 1e3)
        out_s.append(s)
        out_e.append(e)
    launches = segment_sum_sorted_checked.launches
    peak = torch.cuda.max_memory_allocated()

    assert launches == model.cfg.n_layer * N_BATCHES, launches
    s_all = np.concatenate(out_s)
    assert s_all.shape == (N_BATCHES * b, 10) and np.isfinite(s_all).all()
    ents = np.concatenate(out_e)
    assert ((ents >= 0) & (ents < kg.n_ent)).all()
    log(f"[slice] served {N_BATCHES} batches of {b}: per-batch ms "
        f"{[round(t, 3) for t in times]}; mean {np.mean(times):.3f} ms; "
        f"{N_BATCHES * b / (sum(times) / 1e3):.1f} queries/s; "
        f"max_memory_allocated {peak} B; launches {launches} "
        f"(= {model.cfg.n_layer} hops x {N_BATCHES}) ({card})")

    profile_batches(pred, queries[:2 * b], card)

    # one batch on the card vs the same model on the CPU (plain path)
    cpu = RedGNN(model.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    q = queries[:b]
    with torch.inference_mode():
        s_gpu, aux = model(pred.graph, *batch_tensors(pred, q), pred.caps)
        s_cpu, aux_cpu = cpu(pred.graph.to("cpu"),
                             *(t.cpu() for t in batch_tensors(pred, q)),
                             pred.caps)
    for k in aux:
        assert torch.equal(aux[k].cpu(), aux_cpu[k]), k
    s_gpu = s_gpu.cpu()
    diff = float((s_gpu - s_cpu).abs().max())
    assert diff <= 1e-4, diff
    tg, tc = torch.topk(s_gpu, 11), torch.topk(s_cpu, 11)
    n_cmp = topk_untied_agree(tg.values.numpy(), tg.indices.numpy(),
                              tc.values.numpy(), tc.indices.numpy(), 1e-4)
    log(f"[slice] card vs CPU, one batch: max |score diff| {diff:.3g} "
        f"(atol 1e-4); aux equal; top-10 equal at {n_cmp} untied ranks")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    name, smi = phase_device()
    card = smi
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_kg(tmp)
        kg, _, model, pred = build_slice(tmp, "cuda")
    queries = serving_queries(kg, N_BATCHES * pred.batch)
    kernel = phase_kernel(pred, queries[:pred.batch], card)
    kernel["launches"] = phase_slice(kg, model, pred, queries, card)
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
