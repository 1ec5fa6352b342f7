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
  5. training: StaticTrainer on the same KG and config (n_batch=20,
     lr 0.0036, lamb 1.7e-5, scan_chunk=32). At the three training-hop shapes, the
     kernel's forward (through the autograd.Function) against the plain
     version and its backward against autograd of the plain version, bit
     for bit; one step's loss, aux counts
     and every parameter's gradient on the card against the CPU plain
     path (dropout 0); then 64 steps (2 chunks) with dropout 0.29 through
     train_epoch: 3 kernel launches per step, finite loss, every update
     applied, parameters moved, one host read per chunk, and no
     synchronising call inside a chunk (CUDA sync debug mode); then
     evaluate("valid") over the whole split. Prints ms per step, true
     propagated edges/s, eval queries/s, peak memory and a torch.profiler
     pass over 2 steps (idle share, largest kernels, forward / backward /
     optimizer shares of device time).
  6. the whole static model on a seeded synthetic KG of the umls
     dataset's size (135 entities, 46 relations, 5,216 / 652 / 661 train /
     valid / test triples; it stands in for umls, whose files are not in
     the repository), at the umls registry entry (hidden 48, attn 5, L=4,
     n_batch 20, n_tbatch 50):
     6a. registry defaults (dedup 'auto', segment_impl='xla', dense hops):
         Predictor serves 8 batches; the hops' schemes are printed and at
         least one must be bitmap and one dense; one batch, and one train
         step's loss and gradients (with the packed gather's prefix-sum
         backward and without), against the CPU; 16 train steps; a
         whole-split evaluate("valid"). The plain segment sum is
         index_add_, which adds with float atomics on a CUDA device, so
         this configuration is held to tolerances and never to equal
         bits.
     6b. segment_impl='pallas': sort-dedup sparse hops, then dense hops
         through the kernel (2 launches a hop: the (E, b*d) messages and
         the (E, b) live counts by the tail-sorted table's ids). At every
         dense call's real inputs, serving and training, the kernel
         against its plain version, forward and backward, with device
         times, byte bound and index_add_; one served batch and one train
         step against the CPU; launches per batch counted; two runs of 4
         steps bit-equal; ms per batch and step, idle share, peak memory.
     6c. the family-sized KG of phase 4 at registry defaults (sort, then
         bitmap hops): one served batch and one train step (prefix-sum
         backward of the packed gather) against the CPU.
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
TRAIN_STEPS, TRAIN_CHUNK = 64, 32  # phase 5: 2 chunks of scan_chunk steps
# a parameter's gradient, card vs CPU: |diff| <= GRAD_RTOL * |cpu| +
# GRAD_ATOL_REL * max|cpu| (sums over ~60k edges in another order)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
# the same with scan_src_backward=True: the packed gather's backward takes
# differences of a float32 prefix sum over all edges of a hop, which adds
# O(total magnitude * eps) noise in another order on each device
SCAN_GRAD_RTOL, SCAN_GRAD_ATOL_REL = 1e-3, 1e-4
# phase 6: the umls dataset's sizes
UMLS_ENT, UMLS_REL = 135, 46
UMLS_TRAIN, UMLS_VALID, UMLS_TEST = 5_216, 652, 661
UMLS_TRAIN_STEPS = 16


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


def model_of(kg, cfg, device: str):
    """RedGNN of a registry entry ``cfg`` over ``kg``, seeded weights."""
    from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN

    return RedGNN(ModelConfig(
        n_ent=kg.n_ent, n_rel=kg.n_rel, hidden_dim=cfg.hidden_dim,
        attn_dim=cfg.attn_dim, n_layer=cfg.n_layer, act=cfg.act,
        segment_impl=cfg.segment_impl, dedup_impl=cfg.dedup_impl,
        scan_src_backward=cfg.scan_src_backward,
        dense_hops=cfg.dense_hops, dense_switch=cfg.dense_switch),
        device=device, generator=torch.Generator().manual_seed(SEED))


# phases 3-5: the family entry with the kernel on every hop, no dense hops
KERNEL_SLICE = dict(segment_impl="pallas", dense_hops=False)


def build_slice(data_dir: str, device: str, dataset: str = "family",
                **overrides):
    """(kg, cfg, model, predictor) on ``device``: the registry entry of
    ``dataset`` with ``overrides``."""
    from redgnn_tpu_torch.graph.kg import StaticKG
    from redgnn_tpu_torch.serve import Predictor
    from redgnn_tpu_torch.utils.config import dataset_config

    cfg = dataset_config("static_transductive", dataset, **overrides)
    kg = StaticKG.load(data_dir, device=device)
    model = model_of(kg, cfg, device)
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


def hop_inputs(graph, caps, n_ent: int, n_layer: int, heads: torch.Tensor):
    """The (dst, edge_valid, node_cap) that each hop of one batch of query
    ``heads`` hands to the segment sum: the real dst-sorted layout."""
    from redgnn_tpu_torch.ops.frontier import expand_frontier

    keys = heads.to(torch.int32) + torch.arange(
        len(heads), dtype=torch.int32, device=heads.device) * n_ent
    out = []
    for i in range(n_layer):
        fr = expand_frontier(graph.rowptr, graph.rel, graph.tail, n_ent, keys,
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


def kernel_hops(graph, caps, cfg, heads: torch.Tensor):
    """[(msg, seg, dst, n_valid, n)] of each hop of one batch: the real
    dst-sorted layout with seeded random messages; padding edges go past
    the end (``seg``), as RelAttnLayer sends them."""
    dev = heads.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hops = []
    for dst, valid, n in hop_inputs(graph, caps, cfg.n_ent, cfg.n_layer,
                                    heads):
        msg = torch.randn(dst.shape[0], cfg.hidden_dim, generator=gen,
                          device=dev)
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

    hops = kernel_hops(pred.graph, pred.caps, pred.model.cfg,
                       batch_tensors(pred, queries)[0])
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


def profile_report(prof, wall_us: float, n_units: int, unit: str, card):
    """Idle share, device activities and the 8 largest kernels of a
    torch.profiler trace over ``n_units`` batches or steps. Returns the
    profiler's events, or None (after printing "not measured") if it saw
    no device activity."""
    from torch.autograd import DeviceType

    events = prof.events()
    # record_function ranges also show up on the device side; they are
    # spans between launches, not work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("step.")]
    if not kernels:
        log(f"[profile] device time not measured: the profiler saw no "
            f"device activity ({card})")
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {n_units} {unit} units: wall {wall_us / n_units:.1f} us "
        f"per {unit} under the profiler, device busy "
        f"{busy / n_units:.1f} us per {unit}, idle share "
        f"{1 - busy / wall_us:.3f}; {len(kernels) // n_units} device "
        f"activities per {unit} ({card})")
    for name, us in top:
        log(f"[profile]   {us / n_units:9.1f} us/{unit}  {name[:90]}")
    return events


def profile_batches(pred, queries, card):
    """Device busy share and the largest kernels over a few served
    batches (torch.profiler)."""
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
    profile_report(prof, wall_us, -(-len(queries) // b), "batch", card)


def batch_card_vs_cpu(model, pred, q, tag: str):
    """One batch on the card vs the same model on the CPU (plain path):
    scores within 1e-4, aux counts equal, top-10 equal where untied.
    Returns the card's aux."""
    from redgnn_tpu_torch.models.redgnn import RedGNN

    cpu = RedGNN(model.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        s_gpu, aux = model(pred.graph, *batch_tensors(pred, q), pred.caps)
        s_cpu, aux_cpu = cpu(pred.graph.to("cpu"),
                             *(t.cpu() for t in batch_tensors(pred, q)),
                             pred.caps)
    for k in aux:
        assert torch.equal(aux[k].cpu(), aux_cpu[k]), k
    s_gpu = s_gpu.cpu()
    assert bool(torch.isfinite(s_gpu).all()) and float(s_cpu.abs().max()) > 0
    diff = float((s_gpu - s_cpu).abs().max())
    assert diff <= 1e-4, diff
    tg, tc = torch.topk(s_gpu, 11), torch.topk(s_cpu, 11)
    n_cmp = topk_untied_agree(tg.values.numpy(), tg.indices.numpy(),
                              tc.values.numpy(), tc.indices.numpy(), 1e-4)
    log(f"{tag} card vs CPU, one batch: max |score diff| {diff:.3g} "
        f"(atol 1e-4); aux equal, num_nodes {aux_cpu['num_nodes'].tolist()} "
        f"num_edges {aux_cpu['num_edges'].tolist()}; top-10 equal at "
        f"{n_cmp} untied ranks")
    return aux_cpu


def phase_slice(kg, model, pred, queries, card):
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

    batch_card_vs_cpu(model, pred, queries[:b], "[slice]")
    return launches


# ------------------------------------------------------- phase 5: training

def train_config(dropout: float):
    from redgnn_tpu_torch.utils.config import dataset_config

    return dataset_config("static_transductive", "family", **KERNEL_SLICE,
                          scan_chunk=TRAIN_CHUNK, dropout=dropout)


def make_trainer(data_dir: str, device: str, cfg,
                 steps: int = TRAIN_STEPS):
    """A StaticTrainer of ``cfg`` on the first ``steps`` batches of the
    synthetic KG's training queries."""
    from redgnn_tpu_torch.graph.kg import StaticKG
    from redgnn_tpu_torch.train.loop import StaticTrainer

    kg = StaticKG.load(data_dir, device=device)
    kg.train_data = kg.train_data[:steps * cfg.n_batch]
    return StaticTrainer(kg, cfg)


def exact_train_caps(trainer):
    return trainer._recalibrate_exact(
        trainer.train_caps, trainer.kg.graph_np, trainer.kg.train_data,
        trainer.cfg.n_batch)


def step_tensors(trainer, step: int):
    b, dev = trainer.cfg.n_batch, trainer.device
    d = trainer.kg.train_data[step * b:(step + 1) * b]
    subs, rels, objs = (torch.as_tensor(d[:, k], dtype=torch.int32,
                                        device=dev) for k in range(3))
    return subs, rels, objs, torch.ones(b, dtype=torch.bool, device=dev)


def kernel_train_hops_check(trainer, caps, card):
    """The kernel at the three training-hop shapes (padding ids lie past
    the end), on the card: the forward launch of the autograd.Function
    against the plain version (KERNEL_TOL), and its backward against
    autograd of the plain version (both are gathers, so bit for bit).
    Returns per-hop rows with the forward's error and the device times of
    the forward, the plain version, ``index_add_`` and the backward."""
    from redgnn_tpu_torch.ops.segment_sorted import (
        _gather_grad,
        segment_sum_sorted,
        segment_sum_sorted_reference,
    )

    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    hops = kernel_hops(trainer.kg.graph, caps, trainer.model_cfg,
                       step_tensors(trainer, 0)[0])
    rows = []
    for i, (msg, seg, dst, n_valid, n) in enumerate(hops):
        assert int((seg >= n).sum()) == msg.shape[0] - n_valid
        g = torch.randn(n, msg.shape[1], generator=gen, device=dev)
        outs, grads = [], []
        for fn in (segment_sum_sorted,
                   lambda x, s, k: segment_sum_sorted_reference(x, s, k)[0]):
            x = msg.clone().requires_grad_()
            out = fn(x, seg, n)
            # a non-contiguous output gradient, as a transposed matmul
            # operand would hand it over
            out.backward(g.T.contiguous().T)
            outs.append(out.detach())
            grads.append(x.grad)
        torch.cuda.synchronize()
        torch.testing.assert_close(outs[0], outs[1], **KERNEL_TOL)
        err = float((outs[0] - outs[1]).abs().max())
        assert torch.equal(grads[0], grads[1]), f"hop {i}: backward differs"
        assert bool((grads[0][seg >= n] == 0).all())
        idx = dst.long()  # in range: index_add_ raises on the rest
        t_f = device_ms(lambda: segment_sum_sorted(msg, seg, n))
        t_p = device_ms(lambda: segment_sum_sorted_reference(msg, seg, n))
        t_l = device_ms(lambda: torch.zeros(
            n, msg.shape[1], device=dev).index_add_(0, idx, msg))
        t_b = device_ms(lambda: _gather_grad(g, seg, n))
        e, d = msg.shape
        # forward: rows of valid edges read, ids read, output written;
        # backward: g read once, ids read, d_data written
        f_ms = (n_valid * d * 4 + e * 4 + n * d * 4) / HBM_BYTES_PER_S * 1e3
        b_ms = (n * d * 4 + e * 4 + e * d * 4) / HBM_BYTES_PER_S * 1e3
        log(f"[train] hop {i} (E={e}, {n_valid} valid, D={d}, N={n}): "
            f"forward kernel == plain, max |diff| {err:.3g} (rtol "
            f"{KERNEL_TOL['rtol']}, atol {KERNEL_TOL['atol']}); kernel "
            f"backward == plain autograd bit for bit; forward kernel "
            f"{t_f:.4f} ms (byte bound {f_ms * 1e3:.2f} us, plain "
            f"{t_p:.4f} ms, index_add_ {t_l:.4f} ms), backward gather "
            f"{t_b:.4f} ms (byte bound {b_ms * 1e3:.2f} us) (device, CUDA "
            f"graph, L2-warm) ({card})")
        rows.append({"E": e, "valid": n_valid, "N": n, "max_abs_err": err,
                     "fwd_ms": t_f, "fwd_bound_ms": f_ms, "plain_ms": t_p,
                     "library_ms": t_l, "bwd_ms": t_b, "bwd_bound_ms": b_ms})
    log(f"[train] per step ({len(rows)} hops): forward kernel "
        f"{sum(r['fwd_ms'] for r in rows):.4f} ms (byte bound "
        f"{sum(r['fwd_bound_ms'] for r in rows) * 1e3:.2f} us, plain "
        f"{sum(r['plain_ms'] for r in rows):.4f} ms, index_add_ "
        f"{sum(r['library_ms'] for r in rows):.4f} ms), backward gather "
        f"{sum(r['bwd_ms'] for r in rows):.4f} ms (byte bound "
        f"{sum(r['bwd_bound_ms'] for r in rows) * 1e3:.2f} us) ({card})")
    return rows


def step_card_vs_cpu(data_dir: str, gpu, caps, tag: str = "[train]",
                     rtol: float = GRAD_RTOL,
                     atol_rel: float = GRAD_ATOL_REL):
    """One step's loss, aux counts and every parameter's gradient on the
    card against the CPU plain path: same config and seed (same
    parameters), same batch, no dropout (inference-mode forward)."""
    from redgnn_tpu_torch.train.loop import softmax_ce_loss

    cpu = make_trainer(data_dir, "cpu", gpu.cfg,
                       steps=len(gpu.kg.train_data) // gpu.cfg.n_batch)
    out = {}
    for name, tr in (("cpu", cpu), ("cuda", gpu)):
        subs, rels, objs, qmask = step_tensors(tr, 0)
        scores, aux = tr.model(tr.kg.graph, subs, rels, qmask, caps)
        loss = softmax_ce_loss(scores, objs, qmask)
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
        out[name] = (float(loss.detach()), {k: v.cpu() for k, v in aux.items()},
                     [g.cpu() for g in grads])
    (l_c, aux_c, g_c), (l_g, aux_g, g_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c), (l_g, l_c)
    for k in aux_c:
        assert torch.equal(aux_g[k], aux_c[k]), k
    worst, nonzero = 0.0, 0
    for (name, _), a, b in zip(cpu.model.named_parameters(), g_g, g_c):
        scale = float(b.abs().max())
        err = float(((a - b).abs() - rtol * b.abs()).max())
        assert err <= atol_rel * scale, (name, err, scale)
        if scale > 0:  # hop 0 starts from zero states: W_s gets no gradient
            nonzero += 1
            worst = max(worst, float((a - b).abs().max()) / scale)
    assert nonzero >= len(g_c) - 1, nonzero
    log(f"{tag} one step, card vs CPU (dropout 0): loss {l_g:.6f} vs "
        f"{l_c:.6f} (rtol 1e-5); aux counts equal, num_edges "
        f"{aux_c['num_edges'].tolist()}; {len(g_c)} parameter gradients "
        f"within rtol {rtol} + {atol_rel} * max|grad|, worst "
        f"max|diff| / max|grad| {worst:.3g}")
    return int(aux_c["num_edges"].sum())


def profile_steps(trainer, caps, card):
    """torch.profiler over 2 steps: idle share, largest kernels, and the
    device time of the kernels launched inside each of the trainer's
    record_function ranges (forward / backward / optimizer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = torch.stack([torch.stack(
        [t.to(torch.int32) for t in step_tensors(trainer, k)])
        for k in range(2)])
    trainer._run_chunk(batches, caps)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._run_chunk(batches, caps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = profile_report(prof, wall_us, 2, "step", card)
    if events is None:
        return
    phases = ("step.forward", "step.backward", "step.optimizer")
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in events
              if e.name in phases and e.device_type == DeviceType.CPU]
    host = dict.fromkeys(phases, 0.0)
    for name, lo, hi in ranges:
        host[name] += hi - lo
    log("[profile] host time by range of the step, under the profiler: "
        + ", ".join(f"{n.split('.')[1]} {host[n] / 2:.1f} us/step"
                    for n in phases) + f" ({card})")
    share = dict.fromkeys(phases, 0.0)
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        for name, lo, hi in ranges:
            if lo <= e.time_range.start <= hi:
                share[name] += sum(k.duration for k in e.kernels)
                break
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA
                and e.name not in phases)
    seen = sum(share.values())
    if seen < 0.5 * total:
        log(f"[profile] forward / backward / optimizer shares not "
            f"measured: only {seen:.0f} of {total:.0f} us of device time "
            f"could be tied to a range ({card})")
        return
    log("[profile] device time by range of the step (kernels tied to the "
        "op that launched them; "
        f"{seen / total:.1%} of the device time tied): "
        + ", ".join(f"{n.split('.')[1]} {share[n] / seen:.3f} "
                    f"({share[n] / 2:.1f} us/step)" for n in phases)
        + f" ({card})")


def phase_train(data_dir: str, card):
    """Phase 5; returns (kernel launches on the training path, per-hop
    forward / backward rows of the kernel at the training shapes)."""
    from redgnn_tpu_torch.graph.calibrate import per_query_counts
    from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted_checked

    plain = make_trainer(data_dir, "cuda", train_config(0.0))
    caps = exact_train_caps(plain)
    cfg = plain.cfg
    assert (cfg.hidden_dim, cfg.attn_dim, cfg.n_layer, cfg.n_batch) == \
        (48, 5, 3, 20)
    log(f"[train] {TRAIN_STEPS} steps of n_batch={cfg.n_batch}, lr {cfg.lr},"
        f" lamb {cfg.lamb}, decay {cfg.decay_rate}, scan_chunk "
        f"{cfg.scan_chunk}; exact caps node {caps.node_caps} edge "
        f"{caps.edge_caps}")
    hop_rows = kernel_train_hops_check(plain, caps, card)
    edges_step0 = step_card_vs_cpu(data_dir, plain, caps)

    trainer = make_trainer(data_dir, "cuda", train_config(0.29))
    kg = trainer.kg
    nc, ec = per_query_counts(kg.graph_np[0], kg.graph_np[2], kg.n_ent,
                              kg.train_data[:, 0], cfg.n_layer)
    assert int(ec[:cfg.n_batch].sum()) == edges_step0
    true_edges = int(ec.sum())

    # no call inside a chunk may synchronise with the device
    batches = torch.stack([torch.stack(
        [t.to(torch.int32) for t in step_tensors(trainer, k)])
        for k in range(4)])
    snap = trainer._snapshot()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer._run_chunk(batches, caps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    trainer._rollback(snap)

    trainer.train_epoch(0)  # warm-up epoch: allocator, cuBLAS handles
    trainer.timer.enabled = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flat0 = trainer._flat.clone()
    count0, syncs0 = int(trainer.opt_state["count"]), trainer.host_syncs
    segment_sum_sorted_checked.launches = 0
    t0 = time.perf_counter()
    loss = trainer.train_epoch(1)  # ends in a device-to-host read
    epoch_s = time.perf_counter() - t0
    # the chunk loop alone (PhaseTimer); the rest is the exact-cap walk
    seconds = trainer.timer.buckets["train"]["device"]
    launches = segment_sum_sorted_checked.launches
    peak = torch.cuda.max_memory_allocated()
    applied = int(trainer.opt_state["count"]) - count0
    syncs = trainer.host_syncs - syncs0
    assert launches == cfg.n_layer * TRAIN_STEPS, launches
    assert np.isfinite(loss) and loss > 0, loss
    assert applied == TRAIN_STEPS, applied
    assert syncs == TRAIN_STEPS // TRAIN_CHUNK, syncs
    assert not torch.equal(trainer._flat, flat0)
    assert bool(torch.isfinite(trainer._flat).all())
    assert trainer.train_caps == caps
    log(f"[train] {TRAIN_STEPS} steps through train_epoch (dropout 0.29): "
        f"{seconds / TRAIN_STEPS * 1e3:.3f} ms per step, "
        f"{true_edges / seconds:.1f} true propagated edges/s "
        f"({true_edges} edges over the steps' hops; chunk loop "
        f"{seconds:.3f} s of the epoch's {epoch_s:.3f} s, the rest is the "
        f"host's exact-cap walk), loss sum {loss:.2f}; "
        f"{launches} kernel launches (= {cfg.n_layer} x {TRAIN_STEPS}), "
        f"{applied} updates applied, {syncs} host reads "
        f"(1 per chunk of {TRAIN_CHUNK}), no synchronising call inside a "
        f"chunk; max_memory_allocated {peak} B ({card})")

    spec = kg.eval_spec("valid")
    n_answers = sum(len(a) for a in spec.answers)
    trainer.evaluate("valid")  # calibrates the split's caps, warms up
    t0 = time.perf_counter()
    m = trainer.evaluate("valid")
    seconds = time.perf_counter() - t0
    assert m["n"] == n_answers, (m["n"], n_answers)
    assert all(0.0 <= m[k] <= 1.0 for k in ("mrr", "h1", "h3", "h10")), m
    assert m["h1"] <= m["h3"] <= m["h10"]
    log(f"[train] evaluate('valid'): {len(spec.queries)} grouped queries, "
        f"{n_answers} answers ranked, MRR {m['mrr']:.4f} H@1 {m['h1']:.4f} "
        f"H@10 {m['h10']:.4f} (random weights after {2 * TRAIN_STEPS} "
        f"steps); {seconds:.3f} s, {len(spec.queries) / seconds:.1f} "
        f"queries/s in batches of {cfg.n_tbatch} ({card})")
    profile_steps(trainer, caps, card)
    return launches, hop_rows


# ------------------------------------- phase 6: the whole static model

def write_umls_sized_kg(path: str, seed: int = SEED) -> None:
    """A KG of the umls dataset's size in the reference's file format:
    135 entities, 46 relations, 5,216 graph triples (3/4 in facts.txt,
    1/4 in train.txt), 652 valid and 661 test triples, all distinct. It
    stands in for umls: heads and relations are drawn with Zipf-like
    weights, so the graph is dense (a mean degree near 80 once doubled)
    with a few hubs, and the frontier saturates after one hop."""
    rng = np.random.default_rng(seed)
    need = UMLS_TRAIN + UMLS_VALID + UMLS_TEST
    w_ent = 1.0 / np.arange(1, UMLS_ENT + 1) ** 0.6
    w_rel = 1.0 / np.arange(1, UMLS_REL + 1) ** 0.8
    ent_perm = rng.permutation(UMLS_ENT)
    triples = np.empty((0, 3), np.int64)
    while len(triples) < need:
        n = 2 * (need - len(triples))
        h = ent_perm[rng.choice(UMLS_ENT, n, p=w_ent / w_ent.sum())]
        r = rng.choice(UMLS_REL, n, p=w_rel / w_rel.sum())
        t = rng.integers(0, UMLS_ENT, n)
        new = np.stack([h, r, t], 1)[h != t]
        triples = np.unique(np.concatenate([triples, new]), axis=0)
    triples = triples[rng.permutation(len(triples))[:need]]
    n_fact = UMLS_TRAIN * 3 // 4
    splits = {
        "facts.txt": triples[:n_fact],
        "train.txt": triples[n_fact:UMLS_TRAIN],
        "valid.txt": triples[UMLS_TRAIN:UMLS_TRAIN + UMLS_VALID],
        "test.txt": triples[UMLS_TRAIN + UMLS_VALID:],
    }
    with open(os.path.join(path, "entities.txt"), "w") as f:
        f.write("".join(f"e{i}\n" for i in range(UMLS_ENT)))
    with open(os.path.join(path, "relations.txt"), "w") as f:
        f.write("".join(f"r{i}\n" for i in range(UMLS_REL)))
    for name, tri in splits.items():
        with open(os.path.join(path, name), "w") as f:
            f.write("".join(f"e{h}\tr{r}\te{t}\n" for h, r, t in tri))


def timed_batches(pred, queries, n_batches: int):
    """Per-batch host ms of ``n_batches`` served batches, and the peak
    memory over them."""
    b = pred.batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for k in range(n_batches):
        q = queries[k * b:(k + 1) * b]
        t0 = time.perf_counter()
        s, e = pred.predict(q[:, 0], q[:, 1])  # raises on overflow
        times.append((time.perf_counter() - t0) * 1e3)
        assert s.shape == (b, 10) and np.isfinite(s).all()
        assert ((e >= 0) & (e < pred.graph.n_ent)).all()
    return times, torch.cuda.max_memory_allocated()


def train_steps_check(trainer, steps: int, tag: str, card):
    """``steps`` steps through train_epoch: every update applied, finite
    loss, parameters moved. Returns (ms per step of a second, warm epoch,
    peak memory of it)."""
    flat0 = trainer._flat.clone()
    loss = trainer.train_epoch(0)
    assert int(trainer.opt_state["count"]) == steps
    assert np.isfinite(loss) and loss > 0, loss
    assert not torch.equal(trainer._flat, flat0)
    assert bool(torch.isfinite(trainer._flat).all())
    trainer.timer.enabled = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss2 = trainer.train_epoch(1)
    seconds = trainer.timer.buckets["train"]["device"]
    peak = torch.cuda.max_memory_allocated()
    assert int(trainer.opt_state["count"]) == 2 * steps
    assert np.isfinite(loss2)
    log(f"{tag} {steps} steps through train_epoch: {steps} updates "
        f"applied, loss sum {loss:.2f}; a second, warm epoch "
        f"{seconds / steps * 1e3:.3f} ms per step, loss sum {loss2:.2f}, "
        f"max_memory_allocated {peak} B ({card})")
    return seconds / steps * 1e3, peak


def eval_check(trainer, tag: str, card):
    spec = trainer.kg.eval_spec("valid")
    n_answers = sum(len(a) for a in spec.answers)
    trainer.evaluate("valid")  # calibrates the split's caps, warms up
    t0 = time.perf_counter()
    m = trainer.evaluate("valid")
    seconds = time.perf_counter() - t0
    assert m["n"] == n_answers, (m["n"], n_answers)
    assert all(0.0 <= m[k] <= 1.0 for k in ("mrr", "h1", "h3", "h10")), m
    assert m["h1"] <= m["h3"] <= m["h10"]
    log(f"{tag} evaluate('valid'): {len(spec.queries)} grouped queries, "
        f"{n_answers} answers ranked, MRR {m['mrr']:.4f} H@1 {m['h1']:.4f} "
        f"H@10 {m['h10']:.4f} (random weights after a few steps); "
        f"{seconds:.3f} s, {len(spec.queries) / seconds:.1f} queries/s "
        f"({card})")


def phase_defaults(data_dir: str, card):
    """Phase 6a: the umls-sized KG at the registry's defaults."""
    from redgnn_tpu_torch.models.redgnn import hop_plan
    from redgnn_tpu_torch.utils.config import dataset_config

    kg, cfg, model, pred = build_slice(data_dir, "cuda", "umls",
                                       scan_chunk=UMLS_TRAIN_STEPS)
    assert (cfg.dedup_impl, cfg.segment_impl, cfg.dense_hops,
            cfg.scan_src_backward) == ("auto", "xla", True, True)
    assert (cfg.hidden_dim, cfg.attn_dim, cfg.n_layer, cfg.n_batch,
            cfg.n_tbatch) == (48, 5, 4, 20, 50)
    kinds = hop_plan(model.cfg, pred.graph, pred.caps, pred.batch)
    log(f"[6a] KG: {kg.n_ent} entities, {kg.n_rel} relations, "
        f"{len(kg.fact) + len(kg.train)} / {len(kg.valid)} / {len(kg.test)} "
        f"train / valid / test triples, {kg.eval_graph.n_edges} edges with "
        f"inverses and self-loops; serving caps node {pred.caps.node_caps} "
        f"edge {pred.caps.edge_caps}; hops at batch {pred.batch}: {kinds}")
    assert "bitmap" in kinds and "dense" in kinds, kinds
    queries = serving_queries(kg, N_BATCHES * pred.batch)
    assert len(queries) == N_BATCHES * pred.batch
    timed_batches(pred, queries, 1)  # warm-up
    times, peak = timed_batches(pred, queries, N_BATCHES)
    log(f"[6a] served {N_BATCHES} batches of {pred.batch} at registry "
        f"defaults: per-batch ms {[round(t, 3) for t in times]}; mean "
        f"{np.mean(times):.3f} ms; max_memory_allocated {peak} B ({card})")
    batch_card_vs_cpu(model, pred, queries[:pred.batch], "[6a]")

    for scan in (True, False):
        step_cfg = dataset_config("static_transductive", "umls",
                                  scan_chunk=UMLS_TRAIN_STEPS,
                                  scan_src_backward=scan)
        tr = make_trainer(data_dir, "cuda", step_cfg,
                          steps=UMLS_TRAIN_STEPS)
        caps = exact_train_caps(tr)
        tkinds = hop_plan(tr.model_cfg, tr.kg.graph, caps, step_cfg.n_batch)
        assert "bitmap" in tkinds and "dense" in tkinds, tkinds
        step_card_vs_cpu(
            data_dir, tr, caps, f"[6a] scan_src_backward={scan}, hops "
            f"{tkinds}:", *((SCAN_GRAD_RTOL, SCAN_GRAD_ATOL_REL) if scan
                            else (GRAD_RTOL, GRAD_ATOL_REL)))
    trainer = make_trainer(data_dir, "cuda", cfg,
                           steps=UMLS_TRAIN_STEPS)
    train_steps_check(trainer, UMLS_TRAIN_STEPS, "[6a]", card)
    eval_check(trainer, "[6a]", card)


def record_segment_sums(run):
    """The (data, ids, n) of every `segment_sum` call that the layers make
    while ``run()`` executes, in order."""
    from redgnn_tpu_torch.models import layers

    calls, orig = [], layers.segment_sum

    def recording(data, ids, num_segments, **kw):
        calls.append((data.detach().clone(), ids, num_segments))
        return orig(data, ids, num_segments, **kw)

    layers.segment_sum = recording
    try:
        run()
    finally:
        layers.segment_sum = orig
    return calls


def dense_kernel_check(calls, n_ent: int, tag: str, card):
    """The kernel at a path's dense calls (the ones that sum by the
    tail-sorted table into ``n_ent`` rows), at their real inputs: forward
    against the plain version (KERNEL_TOL), backward against autograd of
    the plain version (bit for bit), and device times. Returns one row
    per call."""
    from redgnn_tpu_torch.ops.segment_sorted import (
        _launch_plan,
        segment_sum_sorted,
        segment_sum_sorted_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for data, ids, n in calls:
        e, d = data.shape
        assert n == n_ent and bool((ids[1:] >= ids[:-1]).all())
        g = torch.randn(n, d, generator=gen, device="cuda")
        outs, grads = [], []
        for fn in (segment_sum_sorted,
                   lambda x, s, k: segment_sum_sorted_reference(x, s, k)[0]):
            x = data.clone().requires_grad_()
            out = fn(x, ids, n)
            out.backward(g)
            outs.append(out.detach())
            grads.append(x.grad)
        again = segment_sum_sorted(data, ids, n)
        torch.cuda.synchronize()
        torch.testing.assert_close(outs[0], outs[1], **KERNEL_TOL)
        assert torch.equal(outs[0], again), "two calls gave different bits"
        assert torch.equal(grads[0], grads[1]), "backward differs"
        err = float((outs[0] - outs[1]).abs().max())
        idx = ids.long()
        t_k = device_ms(lambda: segment_sum_sorted(data, ids, n))
        t_f = flushed_ms(lambda: segment_sum_sorted(data, ids, n))
        t_p = device_ms(lambda: segment_sum_sorted_reference(data, ids, n))
        t_l = device_ms(lambda: torch.zeros(n, d, device="cuda").index_add_(
            0, idx, data))
        # every row read once (dead rows are zeros, but rows all the
        # same), ids read once, output written once
        b_ms = (e * d * 4 + e * 4 + n * d * 4) / HBM_BYTES_PER_S * 1e3
        plan = _launch_plan(n, d, data.data_ptr())
        log(f"{tag} dense call E={e} D={d} N={n} ({e * d * 4 / 1e6:.1f} MB "
            f"of rows; vec={plan.vec}): kernel == plain, max |diff| {err:.3g} (rtol "
            f"{KERNEL_TOL['rtol']}, atol {KERNEL_TOL['atol']}), same bits "
            f"twice, backward == plain autograd bit for bit; kernel "
            f"{t_k:.4f} ms back to back, {t_f:.4f} ms with L2 flushed; "
            f"byte bound {b_ms * 1e3:.2f} us = {b_ms / t_k:.1%} of the "
            f"kernel's time; plain {t_p:.4f} ms, index_add_ {t_l:.4f} ms "
            f"(device, CUDA graph) ({card})")
        rows.append({"E": e, "D": d, "N": n, "max_abs_err": err, "ms": t_k,
                     "ms_l2_flushed": t_f, "bound_ms": b_ms, "plain_ms": t_p,
                     "library_ms": t_l})
    return rows


def phase_dense_kernel(data_dir: str, card):
    """Phase 6b: the umls-sized KG with the kernel on every hop. Returns
    the kernel's rows at the dense calls and its launches per batch and
    step."""
    from redgnn_tpu_torch.models.redgnn import hop_plan
    from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted_checked
    from redgnn_tpu_torch.train.loop import softmax_ce_loss

    over = dict(segment_impl="pallas", scan_chunk=UMLS_TRAIN_STEPS)
    kg, cfg, model, pred = build_slice(data_dir, "cuda", "umls", **over)
    kinds = hop_plan(model.cfg, pred.graph, pred.caps, pred.batch)
    n_dense = kinds.count("dense")
    assert n_dense >= 1 and set(kinds) <= {"sort", "dense"}, kinds
    per_batch = len(kinds) + n_dense  # 1 a sparse hop, 2 a dense one
    queries = serving_queries(kg, N_BATCHES * pred.batch)
    q0 = queries[:pred.batch]

    # the dense calls' real inputs, serving and training
    with torch.inference_mode():
        calls = record_segment_sums(
            lambda: model(pred.graph, *batch_tensors(pred, q0), pred.caps))
    assert len(calls) == per_batch, (len(calls), per_batch)
    dense_calls = calls[-2 * n_dense:]  # per hop: messages, live counts
    assert {c[0].shape[1] for c in dense_calls} == \
        {pred.batch * cfg.hidden_dim, pred.batch}
    serve_rows = dense_kernel_check(dense_calls, kg.n_ent, "[6b] serving",
                                    card)
    del calls, dense_calls  # ~400 MB of recorded inputs

    plain = make_trainer(data_dir, "cuda", cfg,
                         steps=UMLS_TRAIN_STEPS)
    caps = exact_train_caps(plain)
    tkinds = hop_plan(plain.model_cfg, plain.kg.graph, caps, cfg.n_batch)
    t_dense = tkinds.count("dense")
    per_step = len(tkinds) + t_dense
    assert t_dense >= 1 and set(tkinds) <= {"sort", "dense"}, tkinds

    def one_forward():
        subs, rels, objs, qmask = step_tensors(plain, 0)
        scores, _ = plain.model(plain.kg.graph, subs, rels, qmask, caps)
        softmax_ce_loss(scores, objs, qmask)

    calls = record_segment_sums(one_forward)
    assert len(calls) == per_step, (len(calls), per_step)
    train_rows = dense_kernel_check(calls[-2 * t_dense:], kg.n_ent,
                                    "[6b] training", card)
    del calls
    log(f"[6b] hops: serving (batch {pred.batch}) {kinds}, caps edge "
        f"{pred.caps.edge_caps}; training (batch {cfg.n_batch}) {tkinds}, "
        f"caps edge {caps.edge_caps}")

    # the main path of this phase: 8 served batches, counted
    timed_batches(pred, queries, 1)  # warm-up, not counted
    segment_sum_sorted_checked.launches = 0
    times, peak = timed_batches(pred, queries, N_BATCHES)
    launches = segment_sum_sorted_checked.launches
    assert launches == per_batch * N_BATCHES, (launches, per_batch)
    log(f"[6b] served {N_BATCHES} batches of {pred.batch} through the "
        f"kernel: per-batch ms {[round(t, 3) for t in times]}; mean "
        f"{np.mean(times):.3f} ms; {launches} kernel launches (= "
        f"({len(kinds) - n_dense} sparse + 2 x {n_dense} dense) x "
        f"{N_BATCHES}); max_memory_allocated {peak} B ({card})")
    profile_batches(pred, queries[:2 * pred.batch], card)
    batch_card_vs_cpu(model, pred, q0, "[6b]")
    step_card_vs_cpu(data_dir, plain, caps, f"[6b] hops {tkinds}:")

    # two runs of 4 steps from one seed end at the same bits
    ends = []
    for _ in range(2):
        tr = make_trainer(data_dir, "cuda", cfg, steps=4)
        tr.train_epoch(0)
        assert int(tr.opt_state["count"]) == 4
        ends.append(tr._flat.clone())
    assert torch.equal(ends[0], ends[1]), "two runs of 4 steps differ"
    log(f"[6b] two runs of 4 train steps (dropout {cfg.dropout}): "
        f"parameters bit-equal")

    trainer = make_trainer(data_dir, "cuda", cfg,
                           steps=UMLS_TRAIN_STEPS)
    segment_sum_sorted_checked.launches = 0
    train_steps_check(trainer, UMLS_TRAIN_STEPS, "[6b]", card)
    train_launches = segment_sum_sorted_checked.launches
    assert train_launches == 2 * UMLS_TRAIN_STEPS * per_step, train_launches
    log(f"[6b] {train_launches} kernel launches over 2 x "
        f"{UMLS_TRAIN_STEPS} steps (= ({len(tkinds) - t_dense} sparse + "
        f"2 x {t_dense} dense) a step)")
    profile_steps(trainer, trainer.train_caps, card)
    return {"serve": serve_rows, "train": train_rows,
            "launches": launches, "launches_per_batch": per_batch,
            "train_launches": train_launches,
            "launches_per_step": per_step}


def phase_family_defaults(data_dir: str, card):
    """Phase 6c: the family-sized KG at the registry's defaults."""
    from redgnn_tpu_torch.models.redgnn import hop_plan

    kg, cfg, model, pred = build_slice(data_dir, "cuda", "family")
    assert (model.cfg.dedup_impl, model.cfg.segment_impl,
            model.cfg.dense_hops) == ("auto", "xla", True)
    kinds = hop_plan(model.cfg, pred.graph, pred.caps, pred.batch)
    assert "bitmap" in kinds, kinds
    log(f"[6c] family-sized KG at registry defaults: hops {kinds}")
    batch_card_vs_cpu(model, pred, serving_queries(kg, pred.batch), "[6c]")
    tr = make_trainer(data_dir, "cuda", cfg, steps=4)
    caps = exact_train_caps(tr)
    tkinds = hop_plan(tr.model_cfg, tr.kg.graph, caps, cfg.n_batch)
    # a bitmap hop past the first: the packed gather's backward runs
    assert "bitmap" in tkinds[1:], tkinds
    step_card_vs_cpu(data_dir, tr, caps, f"[6c] hops {tkinds}:",
                     SCAN_GRAD_RTOL, SCAN_GRAD_ATOL_REL)


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
        kg, _, model, pred = build_slice(tmp, "cuda", **KERNEL_SLICE)
        queries = serving_queries(kg, N_BATCHES * pred.batch)
        kernel = phase_kernel(pred, queries[:pred.batch], card)
        kernel["launches"] = phase_slice(kg, model, pred, queries, card)
        kernel["train_launches"], kernel["train_hops"] = phase_train(tmp,
                                                                     card)
        phase_family_defaults(tmp, card)
    with tempfile.TemporaryDirectory() as tmp:
        write_umls_sized_kg(tmp)
        phase_defaults(tmp, card)
        kernel["dense"] = phase_dense_kernel(tmp, card)
    kernel["max_abs_err"] = max(
        [kernel["max_abs_err"]]
        + [r["max_abs_err"] for r in kernel["train_hops"]]
        + [r["max_abs_err"] for k in ("serve", "train")
           for r in kernel["dense"][k]])
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
