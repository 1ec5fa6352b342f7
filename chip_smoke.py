#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (redgnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(time_kernel_variants.py times other builds of the kernel at the same
hop shapes.) ``python3 chip_smoke.py --phase 7g|7h|7i|7j [--tree DIR]``
runs phase 7g, 7h, 7i or 7j alone, with this tree's or DIR's script and
package.

Phases (any failure raises, and the script exits non-zero):
  1. device: the card's name and power limit; TF32 off.
  2. build: compile the nine CUDA kernels from csrc/ with nvcc (the
     sorted-segment sum, the range sum, the small-table scatter-add, the
     list sum, the slot owner, the two dense hop forward kernels and
     their two backward kernels), and the native graph walker
     (native/graphcore.cpp) with the host's C++ compiler, all ten at
     once; their seconds are printed.
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
         step's loss and gradients (with the packed gather's range-sum
         backward, the kernel on the card and the prefix-sum difference on
         the CPU, and without), against the CPU; 16 train steps; a
         whole-split evaluate("valid"). The plain segment sum is
         index_add_, which adds with float atomics on a CUDA device, so
         this configuration is held to tolerances and never to equal
         bits.
     6b. segment_impl='pallas': sort-dedup sparse hops through the
         kernel, then dense hops through the dense hop kernels, forward
         and backward (phases 7i and 7j), 1 segment kernel launch a train
         step. At every dense call's real inputs, serving and training,
         recorded through the old autograd route (2 sums a hop: the (E,
         b*d) messages and the (E, b) live counts by the tail-sorted
         table's ids), the kernel against its plain version, forward and
         backward, with device times, byte bound and index_add_ (each
         with L2 warm and flushed); one served batch and one train
         step against the CPU; launches per batch counted; two runs of 4
         steps bit-equal; ms per batch and step, idle share, peak memory.
     6c. the family-sized KG of phase 4 at registry defaults (sort, then
         bitmap hops): one served batch and one train step (range-sum
         backward of the packed gather) against the CPU.
  7. temporal RED-GNN on seeded id dirs of ICEWS14's sizes: 7a the
     ICEWS14_TeMP entry at its defaults (serving, one batch and one step
     against the CPU and a float64 reference, training, evaluation; the
     seeded classifier made nonnegative and scaled by 1e-6 so that the
     top-10 check compares ranks), 7b the same weights through the kernel,
     7c the ICEWS14_forecasting entry and its kernel path; 7c holds its
     default step's gradients (the packed gather's backward through the
     range-sum kernel) against the CPU's strict backward. In 7a and 7c
     the whole test split's exact per-query counts are walked by both
     host walkers (the scipy bitmap walk and the native walker), timed
     and held equal. 7g (in 7a and 7c): the gather primitives' backward
     kernels (range_sum, the packed gather's; take_rows_grad, take_rows'
     above the one-hot budget) counted over the trainer's 2 x 16 steps,
     then at the real inputs of one differentiated served batch and one
     training step: each call against float64 (rtol 1e-5 + 2(m-1)u
     sum|x|), bit-equal to the plain model of its summation order
     (range_sum_model, scatter_rows_add_model) and on a second call, its
     launch plan printed, timed with L2 warm and flushed beside its byte
     bound, its plain version (the prefix-sum difference; index_put_) and
     one library call (segment_reduce; index_add_, which take_rows_grad
     must not be slower than); the first train call of each kernel also at
     other shares (slots a warp of the share pass sums) and under
     torch.profiler (each pass's device time). 7h (in 7a and 7c, and at
     the family and umls cells): the hop's index kernels. slot_owner (the
     owner of each expansion slot) at every hop of a served batch and a
     train step of 7a and 7c and of a family served batch: bit-equal to
     its plain twin (searchsorted), to the JAX package's
     scatter-and-cummax route and to its partition's model
     (slot_owner_runs), timed beside its byte bound, the twin, the cummax
     route and torch.searchsorted (the ratio printed); counted over the
     served batches (1 a 7a batch, 3 a 7c or family batch) and the train
     steps. list_sum (the dense hop's packed-row gather backward) at 7a's
     three dense train calls (W = 672) and umls's (6b, W = 980): against
     float64, bit-equal to list_sum_model and twice, timed with L2 warm
     and flushed beside its byte bound, the plain twin (the sorted
     index_put_ autograd took) and index_add_ (the ratio printed; at 7a
     the kernel must not be slower); counted over the trainers' steps (3
     a 7a step). Each kernel split into its passes by torch.profiler at
     the widest owner fill and the first list sum of each cell, and
     list_sum there at other warp shares. ``--phase 7h [--tree DIR]``
     times 7a's step and 7c's served batch (with their profiles) through
     DIR's own functions, then runs the kernel checks where DIR has them;
     then the umls entry (served batches, train steps, list_sum at its
     dense calls) and the family entry (served batches, slot_owner at its
     hops); DIR's kernels split into passes by this script. 7i (in 6a,
     7a and 10b): the dense hop's forward kernels (dense_hop_static,
     dense_hop_temporal) at every dense call of one served batch: against
     the plain version (visited sets and counts equal) and a float64
     referee on the same inputs ((1e-5 + 2(m-1)u) sum|x| plus twice the
     plain version's own error), bit-equal twice, timed with L2 warm and
     flushed beside the bound (bytes or float32 work of the kept pairs),
     the plain version, the whole fused hop and the old (autograd) route;
     their launches counted: one a dense hop of every served batch (6a,
     6b, 7a, 7b, 10b in bf16 and float32) and of 7a's evaluation; the
     temporal kernel at widths 48 and 64 on 7a's last dense call, held
     to the same float64 bound and timed. 6b and 7b record their
     segment-kernel rows at the served dense calls through the autograd
     route (a served batch no longer sums there).
     ``--phase 7i [--tree DIR]`` times 7a's and umls's served batches and
     evaluations with their peak memory through DIR's own functions, and
     runs the kernel checks where DIR has them. 7j (in 6a and 7a): the
     dense hop's backward kernels (dense_hop_static_bwd,
     dense_hop_temporal_bwd) at every dense hop of one train step (umls's
     b = 20, d = 48, A = 5; 7a's b = 32, d = 20, A = 30, E = 152,780):
     their gradients (with the list and scatter sums they feed) against
     the float64 plain backward on the same inputs ((1e-5 + 2(m-1)u)
     sum|x| with every product's factors by absolute value, plus twice
     the plain float32's own error), bit-equal twice, the kernel timed
     with L2 warm and flushed beside the bound (bytes or float32 work of
     the kept pairs), the plain version and the old route's backward;
     launches counted over the trainers' two epochs (one a dense hop of
     every step); the kernel at widths 48 and 64 on the last call's
     table. ``--phase 7j [--tree DIR]`` times 7a's and umls's train steps
     with their peak memory through DIR's own functions, and runs the
     kernel checks where DIR has them.
  8. the xERTE and SimplE baselines on 7c's dir: 8a xERTE at full width
     (emb 256-128-64-32, 3 DP steps, K 15, 40 attended edges, batch 128,
     cap factor 4) with XErteTrainer's seeded init: 8 timed forward
     batches, a profile, one batch
     against the CPU with the same draws (kept sets equal but for ties at
     the cut, entity mass, visited, top-10); 8b one train step against the
     CPU (sampling 'first'), 2 x 16 steps through train_epoch, a 16-batch
     evaluate('valid'), a 2-step profile; 8c SimplETrainer (hidden 64,
     batch 256): one step against the CPU, two whole epochs,
     evaluate('valid'), a profile. Neither model reaches the kernel.
  9. the mesh on the one card (two ranks share it through gloo: the
     numbers read correctness, not multi-GPU speed): 9a mesh 1x2 of the
     family entry with the kernel (each rank sums half of every sparse
     hop's edges, then the ranks all-reduce the aggregates): one step's
     loss and gradients against the single-process step on the card,
     the kernel at each rank's real slices against its plain version,
     its launches per rank per step counted, 2 x 16 steps timed, a
     profile, evaluate('valid') against the single process on the same
     weights, query by query (a near-tie may rank either way in another
     summation order); 9b the same at 2x1, and TemporalTrainer at 2x1 on
     7c's forecasting-sized data (one step and the evaluation against the
     single process, its scores against a float64 run); 9c a 1x1 mesh
     through NCCL: one step bit-equal to mesh=None with the same flags;
     9d the CLI: one epoch of --mesh 1x1 --results_dir --sqlite
     --eval_splits writes its reports, and --mesh 2x1 on a one-GPU host
     exits non-zero with its reason.
  10. bfloat16 compute and the native walker: 10a the family-sized KG of
     phase 4 at the family entry with compute_dtype='bfloat16' and the
     kernel (sort hops): 8 served batches (3 launches a batch) and 2 x 16
     train steps (3 a step) timed in turns with float32 on the same
     weights (ms, peak memory, profiles with idle shares); one batch
     against the CPU's bf16 path (scores within 1e-3 of the row's
     largest, or off float32 by at most twice the CPU's bf16 error) and
     the card's float32 model (5e-2); one step's loss and
     gradients against the CPU (loss rtol 1e-4, gradients within 2e-2 of
     each parameter's largest); the kernel at the bf16 path's real sums
     against its plain version. 10b the umls-sized KG at the registry's
     defaults in bf16 (bitmap hops with the packed gather, then dense):
     hop schemes, one batch and one step against the CPU, 2 x 16 steps
     beside float32. 10c (in 10a, 10b and 7): the native walker's counts
     equal to the numpy edge walk on the static KGs and to the bitmap
     walk on the temporal splits, both timed.
The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed. Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
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
# the same with scan_src_backward=True: on the CPU the packed gather's
# backward takes differences of a float32 prefix sum over all edges of a
# hop, which adds O(total magnitude * eps) noise (the card's range-sum
# kernel adds each range's own terms)
SCAN_GRAD_RTOL, SCAN_GRAD_ATOL_REL = 1e-3, 1e-4
# phase 7: a temporal step's gradients, card vs CPU. The default path adds
# ~10^6 messages per hop with float atomics in a new order on every run,
# and terms that cancel (the time embedding's cos / sin at tens of
# radians)
TEMPORAL_GRAD_RTOL, TEMPORAL_GRAD_ATOL_REL = 1e-3, 2e-3
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
        segment_impl=cfg.segment_impl, compute_dtype=cfg.compute_dtype,
        dedup_impl=cfg.dedup_impl, scan_src_backward=cfg.scan_src_backward,
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


def flushed_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device time of one call of ``fn`` with its inputs evicted from
    L2: ``device_ms`` of (read a 256 MB buffer, call) minus ``device_ms``
    of the read alone. A read leaves L2 clean, so the call pays for its
    own misses and not for writing back the flush."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                     device="cuda")

    def both():
        buf.amax()
        fn()

    return (device_ms(both, calls, reps)
            - device_ms(lambda: buf.amax(), calls, reps))


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
    """Build the CUDA kernels (`_build.KERNELS`) and the native walker at
    once (one compiler process each); returns the walker's build
    seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from redgnn_tpu_torch import _build

    names = _build.KERNELS
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host_job = pool.submit(_build.build_host, "graphcore")
        results = list(pool.map(_build.build, names))
        host = host_job.result()
    for name, res in zip(names, results):
        log(f"[build] {name}.cu -> {os.path.relpath(res['path'])} in "
            f"{res['seconds']:.2f} s (nvcc, sm_90a)")
        log_ptxas(res["log"])
    log(f"[build] native/graphcore.cpp -> {os.path.relpath(host['path'])} "
        f"in {host['seconds']:.2f} s ({_build._host_cxx()} "
        f"{' '.join(_build.HOST_FLAGS)}); all {len(names) + 1} builds at "
        f"once {time.perf_counter() - t0:.2f} s")
    return host["seconds"]


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


def profile_calls(fn, n_units: int, unit: str, card):
    """torch.profiler over one call of ``fn``, which runs ``n_units``
    batches or steps, after one warm call: idle share and the largest
    kernels (`profile_report`, whose events it returns)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_report(prof, wall_us, n_units, unit, card)


def profile_batches(pred, queries, card):
    """Device busy share and the largest kernels over a few served
    batches (torch.profiler)."""
    b = pred.batch

    def serve():
        for k in range(0, len(queries), b):
            q = queries[k:k + b]
            pred.predict(q[:, 0], q[:, 1], q[:, 3] if pred.temporal
                         else None)

    profile_calls(serve, -(-len(queries) // b), "batch", card)


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
    from redgnn_tpu_torch.ops.frontier import slot_owner
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

    segment_sum_sorted_checked.launches = slot_owner.launches = 0
    times, out_s, out_e = [], [], []
    for k in range(N_BATCHES):
        q = queries[k * b:(k + 1) * b]
        t0 = time.perf_counter()
        s, e = pred.predict(q[:, 0], q[:, 1])  # raises on overflow
        times.append((time.perf_counter() - t0) * 1e3)
        out_s.append(s)
        out_e.append(e)
    launches = segment_sum_sorted_checked.launches
    owner_launches = slot_owner.launches
    peak = torch.cuda.max_memory_allocated()

    assert launches == model.cfg.n_layer * N_BATCHES, launches
    assert owner_launches == model.cfg.n_layer * N_BATCHES, owner_launches
    s_all = np.concatenate(out_s)
    assert s_all.shape == (N_BATCHES * b, 10) and np.isfinite(s_all).all()
    ents = np.concatenate(out_e)
    assert ((ents >= 0) & (ents < kg.n_ent)).all()
    log(f"[slice] served {N_BATCHES} batches of {b}: per-batch ms "
        f"{[round(t, 3) for t in times]}; mean {np.mean(times):.3f} ms; "
        f"{N_BATCHES * b / (sum(times) / 1e3):.1f} queries/s; "
        f"max_memory_allocated {peak} B; launches {launches}, slot_owner "
        f"{owner_launches} (each = {model.cfg.n_layer} hops x {N_BATCHES}) "
        f"({card})")

    profile_batches(pred, queries[:2 * b], card)

    batch_card_vs_cpu(model, pred, queries[:b], "[slice]")
    # phase 7h at the family cell: the owner fill at every hop of a batch
    owners, _ = hop_index_calls(
        lambda: pred.predict(queries[:b, 0], queries[:b, 1]))
    assert len(owners) == model.cfg.n_layer, len(owners)
    rows = [slot_owner_call_check(*c, "[slice] 7h serve", card)
            for c in owners]
    hop_pass_profiles(owners, [], "[slice] 7h serve", card)
    return launches, rows


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
                     atol_rel: float = GRAD_ATOL_REL,
                     loss_rtol: float = 1e-5):
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
    assert abs(l_g - l_c) <= loss_rtol * abs(l_c), (l_g, l_c)
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
        f"{l_c:.6f} (rtol {loss_rtol}); aux counts equal, num_edges "
        f"{aux_c['num_edges'].tolist()}; {len(g_c)} parameter gradients "
        f"within rtol {rtol} + {atol_rel} * max|grad|, worst "
        f"max|diff| / max|grad| {worst:.3g}")
    return int(aux_c["num_edges"].sum())


def profile_steps(trainer, caps, card):
    """torch.profiler over 2 steps: idle share, largest kernels, and the
    device time of the kernels launched inside each of the trainer's
    record_function ranges (forward / backward / optimizer)."""
    from torch.autograd import DeviceType

    batches = torch.stack([torch.stack(
        [t.to(torch.int32) for t in step_tensors(trainer, k)])
        for k in range(2)])
    events = profile_calls(lambda: trainer._run_chunk(batches, caps), 2,
                           "step", card)
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
    """Per-batch host ms of ``n_batches`` served batches of ``queries``
    ((head, rel) rows, or quadruples for a temporal Predictor), and the
    peak memory over them."""
    b = pred.batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for k in range(n_batches):
        q = queries[k * b:(k + 1) * b]
        t0 = time.perf_counter()
        s, e = pred.predict(q[:, 0], q[:, 1], q[:, 3] if pred.temporal
                            else None)  # raises on overflow
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
    reset_dense_hop_launches()
    t0 = time.perf_counter()
    m = trainer.evaluate("valid")
    seconds = time.perf_counter() - t0
    launches = dense_hop_launches()
    assert m["n"] == n_answers, (m["n"], n_answers)
    assert all(0.0 <= m[k] <= 1.0 for k in ("mrr", "h1", "h3", "h10")), m
    assert m["h1"] <= m["h3"] <= m["h10"]
    log(f"{tag} evaluate('valid'): {len(spec.queries)} grouped queries, "
        f"{n_answers} answers ranked, MRR {m['mrr']:.4f} H@1 {m['h1']:.4f} "
        f"H@10 {m['h10']:.4f} (random weights after a few steps); "
        f"{seconds:.3f} s, {len(spec.queries) / seconds:.1f} queries/s; "
        f"{launches} dense hop kernel launches ({card})")
    return launches


def phase_defaults(data_dir: str, card):
    """Phase 6a: the umls-sized KG at the registry's defaults."""
    from redgnn_tpu_torch.models.redgnn import hop_plan
    from redgnn_tpu_torch.ops.dense_hop import dense_hop_static_bwd
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
    # the main path of the static dense hop's kernel: the served batches
    reset_dense_hop_launches()
    times, peak = timed_batches(pred, queries, N_BATCHES)
    launches = dense_hop_launches()
    n_dense = kinds.count("dense")
    assert launches == n_dense * N_BATCHES, (launches, n_dense)
    log(f"[6a] served {N_BATCHES} batches of {pred.batch} at registry "
        f"defaults: per-batch ms {[round(t, 3) for t in times]}; mean "
        f"{np.mean(times):.3f} ms; max_memory_allocated {peak} B; "
        f"dense_hop_static launches {launches} (= {n_dense} dense hops x "
        f"{N_BATCHES}) ({card})")
    batch_card_vs_cpu(model, pred, queries[:pred.batch], "[6a]")
    rows = dense_hop_check(pred, queries[:pred.batch], "[6a]", card)

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
    tkinds = hop_plan(trainer.model_cfg, trainer.kg.graph,
                      trainer.train_caps, cfg.n_batch)
    # the main path of the static dense hop's backward kernel: the
    # trainer's two epochs, counted
    dense_hop_static_bwd.launches = 0
    step_ms, train_peak = train_steps_check(trainer, UMLS_TRAIN_STEPS,
                                            "[6a]", card)
    bwd_launches = dense_hop_static_bwd.launches
    assert bwd_launches == tkinds.count("dense") * 2 * UMLS_TRAIN_STEPS \
        > 0, (bwd_launches, tkinds)
    log(f"[6a] dense_hop_static_bwd launches {bwd_launches} over 2 x "
        f"{UMLS_TRAIN_STEPS} train steps (= {tkinds.count('dense')} dense "
        f"hops a step, hops {tkinds})")
    bwd_rows = dense_bwd_check(static_step_fn(trainer), trainer.kg.graph,
                               "[6a] 7j", card)
    eval_launches = eval_check(trainer, "[6a]", card)
    # each dense hop of each evaluation batch is one launch
    spec = trainer.kg.eval_spec("valid")
    n_eval = -(-len(spec.queries) // trainer.n_tbatch)
    ekinds = hop_plan(trainer.model_cfg, spec.graph,
                      trainer.eval_caps["valid"], trainer.n_tbatch)
    assert eval_launches == ekinds.count("dense") * n_eval > 0, (
        eval_launches, ekinds, n_eval)
    return {"serve": rows, "launches": launches,
            "serve_ms": float(np.mean(times)), "serve_peak": peak,
            "eval_launches": eval_launches, "bwd": bwd_rows,
            "bwd_launches": bwd_launches, "step_ms": step_ms,
            "train_peak": train_peak}


class old_dense_route:
    """Within the block the models' dense hops take the old autograd route
    (``RelAttnLayer.dense_autograd``, ``TRedGNN._dense_hop_autograd``),
    whose sums go through `segment_sum`: the segment kernel's checks
    record their dense-call inputs there. No model path takes it
    otherwise."""

    def __enter__(self):
        from redgnn_tpu_torch.models import layers, temporal

        def static(mod, h, vis, q_rel, tsrc, trel, ttail, rowptr_t,
                   dense_agg="sorted_scatter", order=None, rowptr=None,
                   items=None):
            return mod.dense_autograd(h, vis, q_rel, tsrc, trel, ttail,
                                      rowptr_t, dense_agg, order, rowptr)

        def temporal_hop(mod, state, rela, a1, a2, rels, times, tsrc, trel,
                         ttime, ttail, rowptr_t, order, rowptr, excl,
                         drop_gen, edrop_gen, *_):
            return mod._dense_hop_autograd(state, rela, a1, a2, rels, times,
                                           tsrc, trel, ttime, ttail,
                                           rowptr_t, order, rowptr, excl,
                                           drop_gen, edrop_gen)

        self.saved = [(layers.RelAttnLayer, "dense",
                       layers.RelAttnLayer.dense),
                      (temporal.TRedGNN, "_dense_hop",
                       temporal.TRedGNN._dense_hop)]
        layers.RelAttnLayer.dense = static
        temporal.TRedGNN._dense_hop = temporal_hop
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)
        return False


def record_segment_sums(run, module=None):
    """[data, ids, n, grad] of every `segment_sum` call that ``module``
    (default: the static layers) makes while ``run()`` executes, in order;
    ``grad`` is the gradient that reached the call's output when ``run()``
    differentiates through it, else None."""
    from redgnn_tpu_torch.models import layers

    module = module or layers
    calls, orig = [], module.segment_sum

    def recording(data, ids, num_segments, **kw):
        out = orig(data, ids, num_segments, **kw)
        call = [data.detach().clone(), ids, num_segments, None]
        calls.append(call)
        if out.requires_grad:
            out.register_hook(
                lambda g, call=call: call.__setitem__(3, g.detach().clone()))
        return out

    module.segment_sum = recording
    try:
        run()
    finally:
        module.segment_sum = orig
    return calls


def dense_kernel_check(calls, n_ent, tag: str, card, sum_bound=False):
    """The kernel at a path's recorded calls, at their real inputs: forward
    against the plain version (KERNEL_TOL), backward against autograd of
    the plain version (bit for bit) at the call's recorded output gradient
    (a seeded random one where none was recorded), and device times.
    ``n_ent`` (when not None) says the calls are dense ones, summing by
    the tail-sorted table into ``n_ent`` rows. ``sum_bound`` widens the
    forward's tolerance by the rounding bound of the sums themselves:
    float32 sums of m terms in two orders differ by at most
    2 (m - 1) u sum|x| (u = 2^-24, recursive summation), which is what
    separates the two where the terms are large and the sum is not (the
    temporal model's random weights make messages of 1e3-1e6). Returns one
    row per call."""
    from redgnn_tpu_torch.ops.segment_sorted import (
        _launch_plan,
        segment_sum_sorted,
        segment_sum_sorted_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for data, ids, n, g in calls:
        e, d = data.shape
        assert n_ent in (None, n) and bool((ids[1:] >= ids[:-1]).all())
        if g is None:
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
        err = float((outs[0] - outs[1]).abs().max())
        shown = (f"max |diff| {err:.3g} (rtol {KERNEL_TOL['rtol']}, atol "
                 f"{KERNEL_TOL['atol']}")
        if sum_bound:
            s_abs = segment_sum_sorted_reference(data.abs(), ids, n)[0]
            m = torch.bincount(ids[ids < n].long(), minlength=n)
            slack = 2.0 * torch.clamp(m - 1, min=0)[:, None] * 2.0 ** -24 \
                * s_abs
            diff = (outs[0] - outs[1]).abs()
            limit = (KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * outs[1].abs()
                     + slack)
            assert bool((diff <= limit).all()), (err, float(
                (diff - limit).max()))
            ratio = float((diff / torch.clamp(s_abs, min=1e-30)).max())
            shown += (f", + 2 (m-1) u sum|x|; at most {ratio:.3g} of "
                      f"sum|x|")
        else:
            torch.testing.assert_close(outs[0], outs[1], **KERNEL_TOL)
        shown += ")"
        assert torch.equal(outs[0], again), "two calls gave different bits"
        assert torch.equal(grads[0], grads[1]), "backward differs"
        n_valid = int((ids < n).sum())  # padding ids lie past the end
        idx = ids.long()
        if n_valid < e:  # index_add_ raises on them: they go to a spare row
            idx = torch.clamp(idx, max=n)
        t_k = device_ms(lambda: segment_sum_sorted(data, ids, n))
        t_f = flushed_ms(lambda: segment_sum_sorted(data, ids, n))
        t_p = device_ms(lambda: segment_sum_sorted_reference(data, ids, n))
        def library():
            return torch.zeros(n + (n_valid < e), d,
                               device="cuda").index_add_(0, idx, data)

        # index_add_ under both L2 states too: compare like with like
        t_l, t_lf = device_ms(library), flushed_ms(library)
        # every row of an id in range read once (the rows of dead dense
        # edges are zeros, but rows all the same), ids read once, output
        # written once
        b_ms = (n_valid * d * 4 + e * 4 + n * d * 4) / HBM_BYTES_PER_S * 1e3
        plan = _launch_plan(n, d, data.data_ptr())
        kind = "dense call" if n_ent is not None else "call"
        log(f"{tag} {kind} E={e} D={d} N={n} ({e * d * 4 / 1e6:.1f} MB "
            f"of rows; vec={plan.vec}): kernel == plain, {shown}, same bits "
            f"twice, backward == plain autograd bit for bit; kernel "
            f"{t_k:.4f} ms back to back, {t_f:.4f} ms with L2 flushed; "
            f"byte bound {b_ms * 1e3:.2f} us = {b_ms / t_k:.1%} of the "
            f"kernel's time; plain {t_p:.4f} ms, index_add_ {t_l:.4f} ms "
            f"back to back, {t_lf:.4f} ms with L2 flushed (device, CUDA "
            f"graph) ({card})")
        rows.append({"E": e, "D": d, "N": n, "max_abs_err": err, "ms": t_k,
                     "ms_l2_flushed": t_f, "bound_ms": b_ms, "plain_ms": t_p,
                     "library_ms": t_l, "library_ms_l2_flushed": t_lf})
    return rows


def phase_dense_kernel(data_dir: str, card):
    """Phase 6b: the umls-sized KG with the kernel on every hop. Returns
    the kernel's rows at the dense calls and its launches per batch and
    step."""
    from redgnn_tpu_torch.models.redgnn import hop_plan
    from redgnn_tpu_torch.ops.gather import list_sum
    from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted_checked
    from redgnn_tpu_torch.train.loop import softmax_ce_loss

    over = dict(segment_impl="pallas", scan_chunk=UMLS_TRAIN_STEPS)
    kg, cfg, model, pred = build_slice(data_dir, "cuda", "umls", **over)
    kinds = hop_plan(model.cfg, pred.graph, pred.caps, pred.batch)
    n_dense = kinds.count("dense")
    assert n_dense >= 1 and set(kinds) <= {"sort", "dense"}, kinds
    # the old autograd route's sums: 1 a sparse hop, 2 a dense one
    per_batch = len(kinds) + n_dense
    queries = serving_queries(kg, N_BATCHES * pred.batch)
    q0 = queries[:pred.batch]

    # the dense calls' real inputs, serving and training. The dense hops
    # take the dense hop kernels, forward and backward, and no segment sum:
    # their sums are recorded through the old autograd route (the same
    # inputs, gradients on)
    with old_dense_route():
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
    # a train step's segment kernel launches: its sparse hops (the dense
    # hops take the dense hop kernels); the old route's sums: 2 a dense hop
    per_step = len(tkinds) - t_dense
    assert t_dense >= 1 and set(tkinds) <= {"sort", "dense"}, tkinds

    def one_forward():
        subs, rels, objs, qmask = step_tensors(plain, 0)
        scores, _ = plain.model(plain.kg.graph, subs, rels, qmask, caps)
        softmax_ce_loss(scores, objs, qmask)

    with old_dense_route():
        calls = record_segment_sums(one_forward)
    assert len(calls) == per_step + 2 * t_dense, (len(calls), per_step)
    train_rows = dense_kernel_check(calls[-2 * t_dense:], kg.n_ent,
                                    "[6b] training", card)
    del calls

    def one_step():
        subs, rels, objs, qmask = step_tensors(plain, 0)
        scores, _ = plain.model(plain.kg.graph, subs, rels, qmask, caps)
        softmax_ce_loss(scores, objs, qmask).backward()

    # phase 7h at the umls cell: the dense hops' packed-row gather backward
    _, lists = hop_index_calls(one_step)
    plain.model.zero_grad(set_to_none=True)
    assert len(lists) == t_dense, (len(lists), t_dense)
    list_rows = [list_sum_call_check(*c, "[6b] 7h training", card)
                 for c in lists]
    hop_pass_profiles([], lists, "[6b] 7h training", card)
    del lists
    log(f"[6b] hops: serving (batch {pred.batch}) {kinds}, caps edge "
        f"{pred.caps.edge_caps}; training (batch {cfg.n_batch}) {tkinds}, "
        f"caps edge {caps.edge_caps}")

    # the main path of this phase: 8 served batches, counted (the dense
    # hops take the dense hop kernel)
    timed_batches(pred, queries, 1)  # warm-up, not counted
    segment_sum_sorted_checked.launches = 0
    reset_dense_hop_launches()
    times, peak = timed_batches(pred, queries, N_BATCHES)
    launches = segment_sum_sorted_checked.launches
    dense_launches = dense_hop_launches()
    assert launches == (len(kinds) - n_dense) * N_BATCHES, launches
    assert dense_launches == n_dense * N_BATCHES, dense_launches
    log(f"[6b] served {N_BATCHES} batches of {pred.batch} through the "
        f"kernel: per-batch ms {[round(t, 3) for t in times]}; mean "
        f"{np.mean(times):.3f} ms; {launches} kernel launches (= "
        f"{len(kinds) - n_dense} sparse hops x {N_BATCHES}), "
        f"dense_hop_static {dense_launches} (= {n_dense} dense hops x "
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
    segment_sum_sorted_checked.launches = list_sum.launches = 0
    train_steps_check(trainer, UMLS_TRAIN_STEPS, "[6b]", card)
    train_launches = segment_sum_sorted_checked.launches
    list_launches = list_sum.launches
    assert train_launches == 2 * UMLS_TRAIN_STEPS * per_step, train_launches
    assert list_launches == 2 * UMLS_TRAIN_STEPS * t_dense, list_launches
    log(f"[6b] {train_launches} kernel launches over 2 x "
        f"{UMLS_TRAIN_STEPS} steps (= {per_step} sparse hops a step; the "
        f"{t_dense} dense hops take the dense hop kernels); list_sum "
        f"{list_launches} (= {t_dense} dense hops a step)")
    profile_steps(trainer, trainer.train_caps, card)
    return {"serve": serve_rows, "train": train_rows,
            "launches": launches, "launches_per_batch": len(kinds) - n_dense,
            "train_launches": train_launches,
            "launches_per_step": per_step, "list_sum": list_rows,
            "list_launches": list_launches}


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


# --------------------------------------------- phase 7: temporal RED-GNN

ICEWS_ENT, ICEWS_REL, ICEWS_DAYS = 7_128, 230, 365
ICEWS_INTERP = (72_826, 8_941, 8_963)      # ICEWS14_TeMP train/valid/test
ICEWS_FORECAST = (63_685, 13_823, 13_222)  # ICEWS14_forecasting
T_TRAIN_STEPS = 16
T_EVAL_BATCHES = {"ICEWS14_TeMP": 32, "ICEWS14_forecasting": 16}
T_AUX = ("edge_overflow", "node_overflow", "num_nodes", "num_edges")


def write_icews14_sized(path: str, forecasting: bool,
                        seed: int = SEED) -> None:
    """An id-based temporal dir of ICEWS14's sizes: 7,128 entities, 230
    relations, 365 days, distinct (h, r, t, day) quadruples with Zipf(1)
    heads, tails and relations over permuted ids (so that, as on the real
    data, a whole-timeline frontier has seen about a quarter of the edges
    after two hops and saturates after three). Interpolation
    (ICEWS14_TeMP): 72,826 / 8,941 / 8,963 quadruples split at random,
    day stamps. Forecasting (ICEWS14_forecasting): 63,685 / 13,823 /
    13,222 in time order, hour stamps in steps of 24."""
    rng = np.random.default_rng(seed)
    splits = ICEWS_FORECAST if forecasting else ICEWS_INTERP
    w_ent = 1.0 / np.arange(1, ICEWS_ENT + 1)
    w_rel = 1.0 / np.arange(1, ICEWS_REL + 1)
    h_ids, t_ids = rng.permutation(ICEWS_ENT), rng.permutation(ICEWS_ENT)
    need = sum(splits)
    rows = np.empty((0, 4), np.int64)
    while len(rows) < need:
        n = 2 * (need - len(rows))
        h = h_ids[rng.choice(ICEWS_ENT, n, p=w_ent / w_ent.sum())]
        t = t_ids[rng.choice(ICEWS_ENT, n, p=w_ent / w_ent.sum())]
        r = rng.choice(ICEWS_REL, n, p=w_rel / w_rel.sum())
        day = rng.integers(0, ICEWS_DAYS, n)
        new = np.stack([h, r, t, day], 1)[h != t]
        rows = np.unique(np.concatenate([rows, new]), axis=0)
    rows = rows[rng.permutation(len(rows))[:need]]
    if forecasting:
        rows = rows[np.argsort(rows[:, 3], kind="stable")]
        rows[:, 3] *= 24
    with open(os.path.join(path, "entity2id.txt"), "w") as f:
        f.write("".join(f"e{i}\t{i}\n" for i in range(ICEWS_ENT)))
    with open(os.path.join(path, "relation2id.txt"), "w") as f:
        f.write("".join(f"r{i}\t{i}\n" for i in range(ICEWS_REL)))
    bounds = np.cumsum((0,) + splits)
    for name, lo, hi in zip(("train", "valid", "test"), bounds, bounds[1:]):
        with open(os.path.join(path, f"{name}.txt"), "w") as f:
            f.write("".join(f"{a}\t{b}\t{c}\t{d}\t0\n"
                            for a, b, c, d in rows[lo:hi]))


# comparisons of phase 7 that failed: each is printed where it happens and
# the script exits non-zero at the end, after the phases that do not
# depend on it have run
FAILED: list = []


def soft_check(tag: str, fn, *args):
    """``fn(*args)``; an AssertionError is printed and recorded in FAILED
    instead of ending the run."""
    try:
        return fn(*args)
    except AssertionError as err:
        FAILED.append(f"{tag} {fn.__name__}: {err!r}")
        log(f"{tag} FAILED {fn.__name__}: {err!r}")
        return None


def quad_tensors(quads: np.ndarray, device):
    """(subs, rels, objs, times, qmask) of a batch of quadruples."""
    cols = [torch.as_tensor(quads[:, j].astype(np.int32), device=device)
            for j in range(4)]
    return cols + [torch.ones(len(quads), dtype=torch.bool, device=device)]


def temporal_forward(model, kg, batch, caps, exclude=None):
    graph, etime, ekey, selfloop_slot, time_rowptr, dense = kg.model_args()
    subs, rels, _, times, qmask = batch
    return model(graph, etime, subs, rels, times, qmask, caps, exclude,
                 False, ekey, selfloop_slot, time_rowptr, dense)


def cpu_twin(model, **over):
    """``model``'s weights on the CPU, its config with ``over`` set."""
    from redgnn_tpu_torch.models.temporal import TRedGNN

    cpu = TRedGNN(dataclasses.replace(model.cfg, **over), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def reference_scores(model, kg_cpu, quads, caps, exclude=None,
                     device: str = "cpu"):
    """The scores of ``model``'s weights on ``quads``, computed in float64
    (weights and every state; the default dtype is float64 during the
    call) on ``device`` (``kg_cpu``'s), with plain sums (segment_impl
    'xla') and the plain src gather (scan_src_backward off), which change
    no value of the forward: the reference that the card's and the CPU's
    float32 scores are held to. Returned on the CPU."""
    import dataclasses

    from redgnn_tpu_torch.models.temporal import TRedGNN

    cfg = dataclasses.replace(model.cfg, segment_impl="xla",
                              scan_src_backward=False)
    ref = TRedGNN(cfg, device=device).double()
    ref.load_state_dict({k: v.to(device, torch.float64)
                         for k, v in model.state_dict().items()})
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with torch.inference_mode():
            scores, _ = temporal_forward(ref, kg_cpu,
                                         quad_tensors(quads, device), caps,
                                         exclude)
    finally:
        torch.set_default_dtype(default)
    assert scores.dtype == torch.float64, scores.dtype
    return scores.cpu()


def temporal_scores_agree(s_gpu, s_cpu, s_ref):
    """The card's float32 scores against the float64 reference ``s_ref``,
    relative to the largest |score| of the query's row (at least 1):
    within 1e-4, or within twice the CPU's own float32 error on that row
    where that is larger. With random weights a row's largest score can be
    a sum whose terms cancel to ~1/1000 of their size; float32 then puts
    ~1e-4 of the row's scale on it, more or less as the batch's sums are
    conditioned, in an order that differs between the devices, so card
    and CPU differ by up to the sum of their errors. Returns (max |card -
    CPU|, the card's and the CPU's max |diff| / row scale against the
    reference, the (B, 1) per-row bound)."""
    scale = torch.clamp(s_ref.abs().amax(1, keepdim=True), min=1.0)
    err_cpu = ((s_cpu.double() - s_ref).abs() / scale).amax(1, keepdim=True)
    err_gpu = ((s_gpu.double() - s_ref).abs() / scale).amax(1, keepdim=True)
    tol = torch.clamp(2.0 * err_cpu, min=1e-4)
    assert bool((err_gpu <= tol).all()), (
        float(err_gpu.max()), float(err_cpu.max()),
        float((err_gpu - tol).max()))
    return (float((s_gpu - s_cpu).abs().max()), float(err_gpu.max()),
            float(err_cpu.max()), tol * scale)


def temporal_batch_card_vs_cpu(model, kg, kg_cpu, caps, quads, tag: str):
    """One batch on the card vs the same weights on the CPU (plain path):
    scores as `temporal_scores_agree` holds them, aux counts (and frontier
    keys) equal, the frontier softmax within what the score differences allow
    (|dp| <= 2 p max|ds| + 1e-6 per query), the card's top-10 equal to the
    float64 reference's where untied (ties within the score bound)."""
    cpu = cpu_twin(model)
    with torch.inference_mode():
        s_gpu, aux = temporal_forward(model, kg, quad_tensors(quads, "cuda"),
                                      caps)
        s_cpu, aux_cpu = temporal_forward(cpu, kg_cpu,
                                          quad_tensors(quads, "cpu"), caps)
    s_ref = reference_scores(model, kg_cpu, quads, caps)
    for k in T_AUX + (("frontier_keys",) if "frontier_keys" in aux else ()):
        assert torch.equal(aux[k].cpu(), aux_cpu[k]), k
    s_gpu = s_gpu.cpu()
    assert bool(torch.isfinite(s_gpu).all()) and float(s_cpu.abs().max()) > 0
    diff, rel, rel_cpu, bound = temporal_scores_agree(s_gpu, s_cpu, s_ref)
    extra = ""
    if "frontier_softmax" in aux:
        keys = aux_cpu["frontier_keys"].long()
        live = keys != 2 ** 31 - 1
        ds = (s_gpu - s_cpu).abs().amax(1)        # per query
        q = torch.where(live, keys // kg.n_ent, 0)
        p = aux_cpu["frontier_softmax"]
        dp = (aux["frontier_softmax"].cpu() - p).abs()
        assert bool((dp <= 2.0 * p * ds[q] + 1e-6).all()), float(dp.max())
        extra = f"; frontier softmax max |diff| {float(dp.max()):.3g}"
    tg, tr = torch.topk(s_gpu, 11), torch.topk(s_ref, 11)
    n_cmp = topk_untied_agree(tg.values.numpy(), tg.indices.numpy(),
                              tr.values.numpy(), tr.indices.numpy(),
                              bound.numpy())
    log(f"{tag} card vs CPU, one batch of {len(quads)}: max |score diff| "
        f"{diff:.3g}; against the float64 reference card {rel:.3g} and CPU "
        f"{rel_cpu:.3g} of the row's largest |score| (bound: 1e-4 or twice "
        f"the CPU's; largest |score| {float(s_ref.abs().max()):.4g})"
        f"{extra}; aux equal, "
        f"num_nodes {aux_cpu['num_nodes'].tolist()} num_edges "
        f"{aux_cpu['num_edges'].tolist()}; card top-10 equal to the "
        f"reference's at {n_cmp} untied ranks")


def train_sample(kg, b: int, seed: int = SEED):
    """``b`` seeded training quadruples and their graph rows."""
    rows = np.random.default_rng(seed).permutation(len(kg.splits["train"]))
    return kg.splits["train"][rows[:b]], rows[:b]


def temporal_step_card_vs_cpu(model, kg, kg_cpu, cfg, tag: str, rtol: float,
                              atol_rel: float, check_grads: bool = True,
                              cpu_strict: bool = False):
    """One training step's loss, aux counts and every parameter's
    gradient, card vs CPU: the same weights and batch (with leave-one-out
    in interpolation), no dropout; with ``cpu_strict`` the CPU takes the
    strict backward (scan_src_backward=False: a plain src gather, the
    same forward). The scores are held to the float64
    reference as in `temporal_scores_agree`, and the loss to 1e-5 relative plus twice the
    largest score difference (the NLL moves by at most that much). The
    gradients are held to ``rtol`` + ``atol_rel`` * max|grad| when
    ``check_grads``, else only their largest difference is printed."""
    from redgnn_tpu_torch.train.temporal_loop import (
        exact_caps,
        nll_softmax_loss,
    )

    quads, rows = train_sample(kg, cfg.batch_size)
    caps = exact_caps(kg, cfg, quads, cfg.batch_size)
    excl = (kg.exclusion_slots(rows).astype(np.int32)
            if cfg.mode == "interpolation" else None)
    out = {}
    cpu = (cpu_twin(model, scan_src_backward=False) if cpu_strict
           else cpu_twin(model))
    for name, m, g in (("cpu", cpu, kg_cpu), ("cuda", model, kg)):
        dev = "cpu" if name == "cpu" else "cuda"
        batch = quad_tensors(quads, dev)
        scores, aux = temporal_forward(
            m, g, batch, caps,
            None if excl is None else torch.as_tensor(excl, device=dev))
        loss = nll_softmax_loss(scores, batch[2], batch[4])
        params = list(m.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[name] = (float(loss.detach()),
                     {k: aux[k].cpu() for k in T_AUX},
                     [torch.zeros(p.shape) if x is None else x.cpu()
                      for x, p in zip(grads, params)],
                     scores.detach().cpu())
    (l_c, aux_c, g_c, s_c), (l_g, aux_g, g_g, s_g) = out["cpu"], out["cuda"]
    s_ref = reference_scores(model, kg_cpu, quads, caps,
                             None if excl is None else torch.as_tensor(excl))
    ds, rel, rel_cpu, _ = temporal_scores_agree(s_g, s_c, s_ref)
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c) + 2 * ds, (l_g, l_c, ds)
    for k in aux_c:
        assert torch.equal(aux_g[k], aux_c[k]), k
    worst, nonzero = 0.0, 0
    for (name, _), a, b in zip(model.named_parameters(), g_g, g_c):
        scale = float(b.abs().max())
        err = float(((a - b).abs() - rtol * b.abs()).max())
        assert err <= atol_rel * scale or not check_grads, (name, err, scale)
        if scale > 0:
            nonzero += 1
            worst = max(worst, float((a - b).abs().max()) / scale)
    assert nonzero >= len(g_c) - 2, nonzero  # now/future: extrapolation
    log(f"{tag} one step, card vs CPU (dropout 0): loss {l_g:.6f} vs "
        f"{l_c:.6f} (rtol 1e-5 + 2 x max|score diff| {ds:.3g}; against "
        f"the float64 reference, scores of the card within {rel:.3g} and of "
        f"the CPU within {rel_cpu:.3g} of their row's largest, bound 1e-4 "
        f"or twice the CPU's); aux counts equal, "
        f"num_edges "
        f"{aux_c['num_edges'].tolist()}; {len(g_c)} parameter gradients "
        + (f"within rtol {rtol} + {atol_rel} * max|grad|" if check_grads
           else "not held") + f", worst max|diff| / max|grad| {worst:.3g}")


def temporal_train_check(trainer, tag: str, card):
    """Two epochs of ``max_train_batches`` steps through train_epoch (the
    second one timed): every update applied, finite loss, parameters
    moved, one host read per chunk. Returns ms per step."""
    cfg = trainer.cfg
    steps = cfg.max_train_batches
    flat0 = trainer._flat.clone()
    loss = trainer.train_epoch(0)
    assert int(trainer.opt_state["count"]) == steps
    assert np.isfinite(loss) and loss > 0, loss
    assert not torch.equal(trainer._flat, flat0)
    trainer.timer.enabled = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs0 = trainer.host_syncs
    loss2 = trainer.train_epoch(1)
    seconds = trainer.timer.buckets["train"]["device"]
    stage = trainer.timer.buckets["train"]["stage"]
    peak = torch.cuda.max_memory_allocated()
    trainer.timer.enabled = False
    assert int(trainer.opt_state["count"]) == 2 * steps
    assert np.isfinite(loss2)
    assert bool(torch.isfinite(trainer._flat).all())
    assert trainer.host_syncs - syncs0 == -(-steps // cfg.scan_chunk)
    log(f"{tag} {steps} steps through train_epoch (dropout {cfg.dropout}, "
        f"lr {cfg.lr}, {cfg.optimizer}): {steps} updates applied, loss sum "
        f"{loss:.2f}; a second epoch {seconds / steps * 1e3:.3f} ms per "
        f"step (chunk loop; staging and the exact-cap walk {stage:.3f} s), "
        f"loss sum {loss2:.2f}, {trainer.host_syncs - syncs0} host reads, "
        f"max_memory_allocated {peak} B ({card})")
    return seconds / steps * 1e3, peak


def temporal_profile_steps(trainer, card):
    """torch.profiler over 2 train steps of the trainer (defaults)."""
    from redgnn_tpu_torch.train.temporal_loop import exact_caps

    cfg, kg = trainer.cfg, trainer.kg
    b = cfg.batch_size
    quads, rows = train_sample(kg, 2 * b, seed=SEED + 1)
    excl = (kg.exclusion_slots(rows) if cfg.mode == "interpolation"
            else np.zeros(2 * b, np.int64))
    batches = torch.stack(trainer._stage(quads, b, excl), 1)
    caps = trainer.caps["train"].union(exact_caps(kg, cfg, quads, b))
    snap = trainer._snapshot()
    profile_calls(lambda: trainer._run_chunk(batches, caps), 2, "step",
                  card)
    trainer._rollback(snap)


def temporal_eval_check(trainer, tag: str, card):
    """A timed evaluate('valid') (after a warm-up): metrics in range, its
    dense hops each one launch of the dense hop kernel. Returns (queries
    a second, dense hop launches, peak memory)."""
    from redgnn_tpu_torch.models.temporal import temporal_hop_plan

    trainer.evaluate("valid")  # warm-up (the split's caps are exact)
    reset_dense_hop_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = trainer.evaluate("valid")
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dense_hop_launches()
    cfg = trainer.cfg
    n_q = min(len(trainer.kg.splits["valid"]),
              cfg.max_eval_batches * cfg.eval_batch_size)
    assert m["n"] == n_q, (m["n"], n_q)
    b = trainer._cap_b(cfg.eval_batch_size)
    kinds = temporal_hop_plan(trainer.model_cfg, trainer.kg.graph.n_edges,
                              trainer.caps["eval_valid"], b, True)
    n_batches = -(-n_q // cfg.eval_batch_size)
    assert launches == kinds.count("dense") * n_batches, (
        launches, kinds, n_batches)
    names = (("raw_", "fil_", "fil_t_") if cfg.mode == "extrapolation"
             else ("",))
    for pre in names:
        vals = [m[f"{pre}{k}"] for k in ("mrr", "h1", "h3", "h10")]
        assert all(0.0 <= v <= 1.0 for v in vals), m
        assert vals[1] <= vals[2] <= vals[3], m
    assert np.isfinite(m["loss"])
    shown = " ".join(f"{pre}MRR {m[pre + 'mrr']:.4f}" for pre in names)
    if cfg.mode == "extrapolation":
        assert m["fil_mrr"] >= m["raw_mrr"] - 1e-9
        shown += f" found {m['found_rate']:.3f}"
    log(f"{tag} evaluate('valid'), first {cfg.max_eval_batches} batches of "
        f"{cfg.eval_batch_size}: {int(m['n'])} queries, {shown}, loss "
        f"{m['loss']:.4f} (random weights after {2 * cfg.max_train_batches} "
        f"steps); {seconds:.3f} s, {n_q / seconds:.1f} queries/s; peak "
        f"{peak} B; dense hop kernel launches {launches} (= "
        f"{kinds.count('dense')} dense hops x {n_batches} batches) ({card})")
    return n_q / seconds, launches, peak


def temporal_kernel_path(trainer, pred0, queries, kg_cpu, tag: str, card):
    """The kernel path: a Predictor over TRedGNN(dedup_impl='sort',
    segment_impl='pallas') with the trainer's weights and the serving caps
    of ``pred0``. The kernel at every call of one served batch and of one
    training forward + loss.backward() (its real output gradients),
    against its plain version; launches per batch and per step; one batch
    against the CPU; two forward + backward runs bit-equal; 8 served
    batches counted. Returns the kernel's rows and counts."""
    import dataclasses

    from redgnn_tpu_torch.models import temporal as tmod
    from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted_checked
    from redgnn_tpu_torch.serve import Predictor
    from redgnn_tpu_torch.train.temporal_loop import (
        exact_caps,
        nll_softmax_loss,
    )

    kg, cfg = trainer.kg, trainer.cfg
    mcfg = dataclasses.replace(trainer.model_cfg, dedup_impl="sort",
                               segment_impl="pallas")
    model = tmod.TRedGNN(mcfg, device="cuda")
    pred = Predictor(model, trainer.model.state_dict(), kg, cfg, top_k=10,
                     caps=pred0.caps)
    kinds = tmod.temporal_hop_plan(mcfg, kg.graph.n_edges, pred.caps,
                                   pred.batch, True)
    assert kinds[0] == "sort" and set(kinds) <= {"sort", "dense"}, kinds
    per_batch = len(kinds) + kinds.count("dense")  # dense: 2 calls a hop
    q0 = queries[:pred.batch]
    # the dense hops take the dense hop kernels, forward and backward: their
    # sums are recorded through the old autograd route (gradients on)
    with old_dense_route():
        calls = record_segment_sums(
            lambda: temporal_forward(model, kg, quad_tensors(q0, "cuda"),
                                     pred.caps), tmod)
    assert len(calls) == per_batch, (len(calls), per_batch)
    serve_rows = dense_kernel_check(calls, None, f"{tag} serving", card,
                                    sum_bound=True)
    del calls

    quads, rows = train_sample(kg, cfg.batch_size)
    caps = exact_caps(kg, cfg, quads, cfg.batch_size)
    tkinds = tmod.temporal_hop_plan(mcfg, kg.graph.n_edges, caps,
                                    cfg.batch_size, True)
    # a step's launches: its sparse hops (the dense hops take the dense
    # hop kernels); the old route's sums: 2 a dense hop
    per_step = len(tkinds) - tkinds.count("dense")
    excl = (torch.as_tensor(kg.exclusion_slots(rows).astype(np.int32),
                            device="cuda")
            if cfg.mode == "interpolation" else None)

    def step():
        model.zero_grad()
        batch = quad_tensors(quads, "cuda")
        scores, _ = temporal_forward(model, kg, batch, caps, excl)
        nll_softmax_loss(scores, batch[2], batch[4]).backward()
        return scores.detach(), [p.grad.clone() for p in model.parameters()
                                 if p.grad is not None]

    with old_dense_route():
        calls = record_segment_sums(step, tmod)
    assert len(calls) == per_step + 2 * tkinds.count("dense"), len(calls)
    segment_sum_sorted_checked.launches = 0
    step()
    step_launches = segment_sum_sorted_checked.launches
    assert step_launches == per_step, (step_launches, per_step)
    # every message sum saw its output gradient (the live counts have none)
    assert sum(c[3] is not None for c in calls) == len(tkinds), calls
    train_rows = dense_kernel_check(calls, None, f"{tag} training", card,
                                    sum_bound=True)
    del calls
    (s1, g1), (s2, g2) = step(), step()
    assert torch.equal(s1, s2) and len(g1) == len(g2) and all(
        torch.equal(a, b) for a, b in zip(g1, g2)), "two runs differ"
    log(f"{tag} two forward + backward runs through the kernel: scores and "
        f"{len(g1)} parameter gradients bit-equal; hops serving {kinds}, "
        f"training {tkinds}")

    # the main path of this phase: 8 served batches, counted (the dense
    # hops take the dense hop kernel)
    timed_batches(pred, queries, 1)  # warm-up, not counted
    segment_sum_sorted_checked.launches = 0
    reset_dense_hop_launches()
    times, peak = timed_batches(pred, queries, N_BATCHES)
    launches = segment_sum_sorted_checked.launches
    n_dense = kinds.count("dense")
    dense_launches = dense_hop_launches()
    assert launches == (len(kinds) - n_dense) * N_BATCHES, launches
    assert dense_launches == n_dense * N_BATCHES, dense_launches
    log(f"{tag} served {N_BATCHES} batches of {pred.batch} through the "
        f"kernel: per-batch ms {[round(t, 3) for t in times]}; mean "
        f"{np.mean(times):.3f} ms; {launches} kernel launches (= "
        f"{len(kinds) - n_dense} sparse hops x {N_BATCHES}), "
        f"dense_hop_temporal {dense_launches} (= {n_dense} dense hops x "
        f"{N_BATCHES}); {per_step} per train step; max_memory_allocated "
        f"{peak} B ({card})")
    profile_batches(pred, queries[:2 * pred.batch], card)
    soft_check(tag, temporal_batch_card_vs_cpu, model, kg, kg_cpu,
               pred.caps, q0, tag)
    return {"serve": serve_rows, "train": train_rows, "launches": launches,
            "launches_per_batch": len(kinds) - n_dense,
            "launches_per_step": per_step,
            "train_launches": step_launches}


# ---------------- phase 7g: the gather primitives' backwards on the card

# the two kernels that replace JAX custom VJPs (no Pallas kernel: XLA
# compositions in the JAX package)
GATHER_KERNELS = {
    "range_sum": {"source": "redgnn_tpu_torch/csrc/range_sum.cu",
                  "replaces": "redgnn_tpu/ops/gather.py:174"},
    "take_rows_grad": {"source": "redgnn_tpu_torch/csrc/take_rows_grad.cu",
                       "replaces": "redgnn_tpu/ops/gather.py:41"},
}
U32 = 2.0 ** -24  # float32 unit roundoff


def record_calls(targets, run):
    """{name: [args of each call]} of the functions ``targets`` ((module,
    name) pairs) that ``run()`` makes, in order, tensors cloned. Each
    function itself runs unchanged: a wrapper counts its launches on its
    own name, so the original is put back for the call."""
    calls = {name: [] for _, name in targets}

    def recording(module, name, orig):
        def rec(*args):
            calls[name].append([a.detach().clone() if torch.is_tensor(a)
                                else a for a in args])
            setattr(module, name, orig)
            try:
                return orig(*args)
            finally:
                setattr(module, name, rec)
        return rec

    origs = [(module, name, getattr(module, name))
             for module, name in targets]
    for module, name, orig in origs:
        setattr(module, name, recording(module, name, orig))
    try:
        run()
    finally:
        for module, name, orig in origs:
            setattr(module, name, orig)
    return calls


def record_gather_backwards(run):
    """[g, start, count] of every range sum (`gather_rows_packed`'s
    backward) and [g, idx, rows] of every scatter-add (`take_rows`'
    backward above the one-hot budget) that ``run()`` computes, in order."""
    from redgnn_tpu_torch.ops import gather

    calls = record_calls([(gather, "range_sum"),
                          (gather, "scatter_rows_add")], run)
    return calls["range_sum"], calls["scatter_rows_add"]


def sum_bound_check(got, want, s_abs, m):
    """|got - want| <= 1e-5 |want| + 2 (m - 1) u sum|x| per cell (``want``
    and ``s_abs`` float64; m terms in the cell's sum): the rounding bound
    of a float32 sum in any order, against an exact one. Returns
    max |got - want|."""
    m = m.to(torch.float64)[:, None]
    diff = (got.to(torch.float64) - want).abs()
    bound = 1e-5 * want.abs() + 2.0 * torch.clamp(m - 1, min=0) * U32 * s_abs
    assert bool((diff <= bound).all()), float((diff - bound).max())
    return float(diff.max()) if diff.numel() else 0.0


def range_sum_call_check(g, start, count, what: str, card, sweep=False):
    """The range-sum kernel at one recorded call: against the float64
    range sum, bit-equal to the plain model of its summation order
    (`range_sum_model`) and on a second call, its share plan, times (L2
    warm and flushed), the byte bound, the plain version (the prefix-sum
    difference) and segment_reduce. ``sweep`` also times the kernel at
    other shares than the plan's (`share_slots`)."""
    from redgnn_tpu_torch.ops import gather
    from redgnn_tpu_torch.ops.gather import (
        range_sum,
        range_sum_model,
        range_sum_reference,
        range_sum_scan,
    )

    got, again = range_sum(g, start, count), range_sum(g, start, count)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two calls gave different bits"
    assert torch.equal(got, range_sum_model(g, start, count)), \
        "the kernel left the order of its model"
    want = range_sum_reference(g, start, count)
    e, d = g.shape
    p = start.shape[0]
    plan = gather._range_plan(e, p, d)
    st, ct = start.long(), count.long()
    lo = torch.clamp(st, 0, e)
    m = torch.maximum(torch.clamp(st + torch.clamp(ct, min=0), max=e),
                      lo) - lo
    err = sum_bound_check(got, want, range_sum_reference(g.abs(), start,
                                                         count), m)
    plain = range_sum_scan(g, start, count)
    scale = float(want.abs().max())
    err_plain = float((plain.double() - want).abs().max())
    total = int(m.sum())
    t_k = device_ms(lambda: range_sum(g, start, count))
    t_f = flushed_ms(lambda: range_sum(g, start, count))
    t_p = call_ms(lambda: range_sum_scan(g, start, count), rounds=2,
                  iters=1, warmup=1)[0]
    # the one PyTorch call for the same sums needs ranges laid end to end
    # from slot 0 (the frontier's are)
    tiled = bool(lo[0] == 0) and bool((lo[1:] == lo[:-1] + m[:-1]).all())
    t_l = (call_ms(lambda: torch.segment_reduce(g[:total], "sum",
                                                lengths=m), rounds=3,
                   iters=5)[0] if tiled else None)
    b_ms = (total * d * 4 + p * d * 4 + p * 2 * start.element_size()) \
        / HBM_BYTES_PER_S * 1e3
    log(f"{what} range_sum E={e} D={d} P={p} ({total} slots in ranges, "
        f"longest {int(m.max())}; laid end to end: {tiled}; plan: "
        f"{plan.blocks} shares of {gather.SHARE_WARPS} x {plan.share} "
        f"slots, {plan.tiles} scan tiles): kernel within rtol 1e-5 + 2(m-1)u "
        f"sum|x| of the float64 range sum (max |diff| {err:.3g}; the "
        f"prefix-sum difference {err_plain:.3g}, largest |sum| "
        f"{scale:.3g}), bit-equal to its model and twice; kernel "
        f"{t_k:.4f} ms L2 warm, {t_f:.4f} ms flushed; byte bound "
        f"{b_ms * 1e3:.2f} us = {b_ms / t_k:.1%} of the warm time, "
        f"{b_ms / t_f:.1%} of the flushed; plain (prefix-sum difference) "
        f"{t_p:.4f} ms; "
        + (f"segment_reduce {t_l:.4f} ms (eager: it synchronises)"
           if t_l is not None else "segment_reduce not comparable")
        + f" ({card})")
    if sweep:
        log(f"{what} range_sum at other shares (slots a warp), ms L2 warm: "
            f"{share_sweep(lambda: range_sum(g, start, count))} ({card})")
        log(f"{what} range_sum's passes, 10 calls:")
        profile_calls(lambda: [range_sum(g, start, count) for _ in range(10)],
                      10, "call", card)
    return {"E": e, "D": d, "P": p, "longest": int(m.max()),
            "share": plan.share, "max_abs_err": err, "ms": t_k,
            "ms_l2_flushed": t_f, "bound_ms": b_ms, "plain_ms": t_p,
            "library_ms": t_l}


def share_sweep(call) -> dict:
    """ms L2 warm of ``call`` with the share pass's warps taking 64 to
    512 slots each (the plans' rule, `share_slots`, replaced for the
    call; every share gives the float32 sums in its own fixed order)."""
    from redgnn_tpu_torch.ops import gather

    orig = gather.share_slots
    times = {}
    try:
        for share in (64, 128, 256, 512):
            gather.share_slots = lambda n, share=share: share
            times[share] = round(device_ms(call), 4)
    finally:
        gather.share_slots = orig
    return times


def scatter_call_check(g, idx, rows, what: str, card, sweep=False):
    """The scatter-add kernel at one recorded call: against a float64
    index_add_, bit-equal to the plain model of its summation order
    (`scatter_rows_add_model`) and on a second call, its plan, times, the
    byte bound and the design's own floor, the plain version
    (index_put_(accumulate=True)) and index_add_. ``sweep`` also times
    the kernel at other shares than the plan's."""
    from redgnn_tpu_torch.ops import gather

    e, d = g.shape
    plan = gather._scatter_plan(e, rows, d)
    assert plan is not None, (rows, g.shape)  # every table of the paths
    got = gather.scatter_rows_add(g, idx, rows)
    again = gather.scatter_rows_add(g, idx, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two calls gave different bits"
    assert torch.equal(got, gather.scatter_rows_add_model(g, idx, rows)), \
        "the kernel left the order of its model"
    i64 = idx.long()
    want = torch.zeros(rows, d, dtype=torch.float64,
                       device="cuda").index_add_(0, i64, g.double())
    s_abs = torch.zeros(rows, d, dtype=torch.float64,
                        device="cuda").index_add_(0, i64, g.abs().double())
    m = torch.bincount(i64, minlength=rows)
    err = sum_bound_check(got, want, s_abs, m)
    t_k = device_ms(lambda: gather.scatter_rows_add(g, idx, rows))
    t_f = flushed_ms(lambda: gather.scatter_rows_add(g, idx, rows))
    t_p = call_ms(lambda: torch.zeros(rows, d, device="cuda").index_put_(
        (i64,), g, accumulate=True), rounds=2, iters=1, warmup=1)[0]
    t_l = device_ms(lambda: torch.zeros(rows, d, device="cuda").index_add_(
        0, idx, g))
    ib = idx.element_size()
    b_ms = (e * d * 4 + e * ib + rows * d * 4) / HBM_BYTES_PER_S * 1e3
    # the design moves g once, the ids twice, the sorted (slot, row) list
    # once each way and the table once
    design_ms = (e * (d * 4 + 2 * ib + 16) + rows * d * 4) \
        / HBM_BYTES_PER_S * 1e3
    runs = int((idx[1:] != idx[:-1]).sum()) + 1 if e else 0
    log(f"{what} take_rows_grad E={e} R={rows} D={d} ({runs} runs of "
        f"equal ids, largest row {int(m.max())} ids; plan: {plan.chunks} "
        f"sort chunks of {plan.chunk}, {plan.blocks} shares of "
        f"{gather.SHARE_WARPS} x {plan.share} slots, tile {plan.tile}): "
        f"kernel within rtol 1e-5 + 2(m-1)u sum|x| of the float64 "
        f"index_add_ (max |diff| {err:.3g}), bit-equal to its model and "
        f"twice; kernel "
        f"{t_k:.4f} ms L2 warm, {t_f:.4f} ms flushed; byte bound "
        f"{b_ms * 1e3:.2f} us = {b_ms / t_k:.1%} of the warm time "
        f"({design_ms * 1e3:.2f} us, {design_ms / t_k:.1%}, with the "
        f"design's sort traffic); plain (index_put_) {t_p:.4f} ms, "
        f"index_add_ {t_l:.4f} ms ({card})")
    assert t_k <= t_l, f"slower than index_add_: {t_k:.4f} > {t_l:.4f} ms"
    if sweep:
        times = share_sweep(lambda: gather.scatter_rows_add(g, idx, rows))
        log(f"{what} take_rows_grad at other shares (slots a warp), ms L2 "
            f"warm: {times} ({card})")
        log(f"{what} take_rows_grad's passes, 10 calls:")
        profile_calls(lambda: [gather.scatter_rows_add(g, idx, rows)
                               for _ in range(10)], 10, "call", card)
    return {"E": e, "R": rows, "D": d, "share": plan.share,
            "max_abs_err": err, "ms": t_k, "ms_l2_flushed": t_f,
            "bound_ms": b_ms, "design_ms": design_ms, "plain_ms": t_p,
            "library_ms": t_l}


def temporal_step_fn(trainer):
    """One training step's forward and backward at the trainer's caps
    (the split's, as in temporal_profile_steps) on a seeded batch, no
    dropout, as a function of no arguments."""
    from redgnn_tpu_torch.train.temporal_loop import (
        exact_caps,
        nll_softmax_loss,
    )

    kg, cfg, model = trainer.kg, trainer.cfg, trainer.model
    quads, rows = train_sample(kg, cfg.batch_size)
    caps = trainer.caps["train"].union(exact_caps(kg, cfg, quads,
                                                  cfg.batch_size))
    excl = (torch.as_tensor(kg.exclusion_slots(rows).astype(np.int32),
                            device="cuda")
            if cfg.mode == "interpolation" else None)

    def step():
        batch = quad_tensors(quads, "cuda")
        scores, _ = temporal_forward(model, kg, batch, caps, excl)
        nll_softmax_loss(scores, batch[2], batch[4]).backward()

    return step


def gather_kernels_check(trainer, pred, queries, main: dict, steps: int,
                         tag: str, card):
    """Phase 7g: both gather-backward kernels at the real inputs of one
    served batch (differentiated: its NLL at the batch's answers; serving
    itself runs no backward, so 0 launches a served batch) and of one
    training step at the trainer's caps (no dropout), held and timed call
    by call. ``main`` holds the launches counted over the trainer's
    ``steps`` steps. Returns the rows and counts of both kernels."""
    from redgnn_tpu_torch.ops.gather import range_sum, scatter_rows_add
    from redgnn_tpu_torch.train.temporal_loop import nll_softmax_loss

    kg, model = trainer.kg, trainer.model
    q0 = queries[:pred.batch]
    range_sum.launches = scatter_rows_add.launches = 0
    pred.predict(q0[:, 0], q0[:, 1], q0[:, 3])
    assert range_sum.launches == scatter_rows_add.launches == 0

    def served():
        batch = quad_tensors(q0, "cuda")
        scores, _ = temporal_forward(model, kg, batch, pred.caps)
        nll_softmax_loss(scores, batch[2], batch[4]).backward()

    step = temporal_step_fn(trainer)
    out = {}
    for part, run in (("serve", served), ("train", step)):
        range_sum.launches = scatter_rows_add.launches = 0
        sums, scatters = record_gather_backwards(run)
        model.zero_grad(set_to_none=True)
        assert range_sum.launches == len(sums), (range_sum.launches,
                                                 len(sums))
        assert scatter_rows_add.launches == len(scatters)
        what = f"{tag} {part}"
        out.setdefault("range_sum", {})
        out["range_sum"][part] = [
            range_sum_call_check(*c, what, card,
                                 sweep=part == "train" and i == 0)
            for i, c in enumerate(sums)]
        out.setdefault("take_rows_grad", {})[part] = [
            scatter_call_check(*c, what, card,
                               sweep=part == "train" and i == 0)
            for i, c in enumerate(scatters)]
        out["range_sum"][f"launches_per_{part}"] = len(sums)
        out["take_rows_grad"][f"launches_per_{part}"] = len(scatters)
        del sums, scatters
    for name in out:
        rows_ = out[name]["train"]
        out[name]["launches"] = main[name]
        log(f"{tag} {name}: {out[name]['launches_per_serve']} launches in "
            f"a differentiated served batch (0 a served batch), "
            f"{out[name]['launches_per_train']} a train step "
            f"({main[name]} over the {steps} steps of the trainer's "
            f"epochs); per train step kernel "
            f"{sum(r['ms'] for r in rows_):.4f} ms L2 warm, "
            f"{sum(r['ms_l2_flushed'] for r in rows_):.4f} ms flushed, "
            f"byte bound {sum(r['bound_ms'] for r in rows_):.4f} ms, plain "
            f"{sum(r['plain_ms'] for r in rows_):.4f} ms ({card})")
    return out


GATHER_ALONE_STEPS = 2  # train steps that count the launches in --phase 7g


def phase_gather_alone(mod, card):
    """Phase 7g alone (``--phase 7g``): 7a's and 7c's dirs, trainers and
    Predictors as phase 7 builds them, ``GATHER_ALONE_STEPS`` train steps
    through train_epoch (the launches' main path), then ``mod``'s
    gather_kernels_check at the same calls. ``mod`` is this script or, with
    ``--tree DIR``, DIR's chip_smoke.py running DIR's package: the parent
    tree's kernels at the same calls, on the same card. Returns the
    per-call times of both kernels."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.ops.gather import range_sum, scatter_rows_add
    from redgnn_tpu_torch.serve import Predictor
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer
    from redgnn_tpu_torch.utils.config import dataset_config

    out = {}
    for entry, forecasting, tag in (("ICEWS14_TeMP", False, "[7a]"),
                                    ("ICEWS14_forecasting", True, "[7c]")):
        with tempfile.TemporaryDirectory() as tmp:
            mod.write_icews14_sized(tmp, forecasting)
            cfg = dataset_config("temporal", entry,
                                 max_train_batches=GATHER_ALONE_STEPS,
                                 max_eval_batches=1)
            trainer = TemporalTrainer(load_temporal_kg(tmp, cfg, "cuda"), cfg)
            if not forecasting:  # as phase 7a scales it
                with torch.no_grad():
                    trainer.model.classifier_w.abs_().mul_(1e-6)
            pred = Predictor.from_trainer(trainer, split="test", top_k=10)
            queries = trainer.kg.splits["test"][:pred.batch]
            range_sum.launches = scatter_rows_add.launches = 0
            trainer.train_epoch(0)
            main = {"range_sum": range_sum.launches,
                    "take_rows_grad": scatter_rows_add.launches}
            res = mod.gather_kernels_check(trainer, pred, queries, main,
                                           GATHER_ALONE_STEPS, tag, card)
        out[entry] = {
            name: {part: [{k: r[k] for k in ("ms", "ms_l2_flushed",
                                               "bound_ms")}
                          for r in res[name][part]]
                   for part in ("serve", "train")}
            for name in res}
    return out


# ------------- phase 7h: the hop's index kernels (list_sum, slot_owner)

# two XLA compositions of the JAX package written as Hopper kernels: the
# dense hop's packed-row gather backward and the expansion's owner fill
HOP_INDEX_KERNELS = {
    "list_sum": {"source": "redgnn_tpu_torch/csrc/list_sum.cu",
                 "replaces": "redgnn_tpu/models/layers.py:176"},
    "slot_owner": {"source": "redgnn_tpu_torch/csrc/slot_owner.cu",
                   "replaces": "redgnn_tpu/ops/frontier.py:179"},
}
HOP_ALONE_STEPS = 8  # train steps an epoch in --phase 7h


def pass_profile(fn, what: str, card):
    """The device time of each pass (kernel or memset) of one call of
    ``fn``, from torch.profiler over 10 calls after a warm one: how a
    call splits into its launches."""
    log(f"{what}: passes of one call (torch.profiler, 10 calls):")
    profile_calls(lambda: [fn() for _ in range(10)], 10, "call", card)


def list_share_sweep(call, plan_share: int) -> dict:
    """ms L2 warm of ``call`` with the list-sum kernel's warps taking 2 to
    64 positions each and the plan's ``plan_share`` (the plan's rule,
    `list_share`, replaced for the call; every share gives float32 sums in
    its own fixed order)."""
    from redgnn_tpu_torch.ops import gather

    orig = gather.list_share
    times = {}
    try:
        for share in sorted({2, 4, 8, 16, 32, 48, 64, plan_share}):
            gather.list_share = lambda e, share=share: share
            times[share] = round(device_ms(call), 4)
    finally:
        gather.list_share = orig
    return times


def list_sum_call_check(g, order, off, what: str, card, faster=False):
    """The list-sum kernel at one recorded call (a dense hop's packed-row
    gather backward): against the float64 sum (rtol 1e-5 + 2(m-1)u
    sum|x|), bit-equal to the plain model of its order (`list_sum_model`)
    and on a second call, times with L2 warm and flushed, the byte bound,
    the plain twin (the ``index_put_(accumulate=True)`` over the gather's
    index that autograd took before) and ``index_add_``, with the
    kernel's ratio to it. ``faster``: the kernel must not be slower than
    ``index_add_`` here."""
    from redgnn_tpu_torch.ops import gather

    e, w = g.shape
    n = off.shape[0] - 1
    plan = gather._list_plan(e, n, w)
    got, again = gather.list_sum(g, order, off), gather.list_sum(g, order,
                                                                 off)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two calls gave different bits"
    assert torch.equal(got, gather.list_sum_model(g, order, off)), \
        "the kernel left the order of its model"
    m = torch.diff(off.long())
    err = sum_bound_check(got, gather.list_sum_reference(g, order, off),
                          gather.list_sum_reference(g.abs(), order, off), m)
    # the gather's own index (the tail-sorted table's sources): the list
    # names every slot once
    assert int(m.sum()) == e, (int(m.sum()), e)
    idx = torch.empty(e, dtype=torch.int64, device=g.device)
    idx[order.long()] = torch.repeat_interleave(
        torch.arange(n, device=g.device), m)
    t_k = device_ms(lambda: gather.list_sum(g, order, off))
    t_f = flushed_ms(lambda: gather.list_sum(g, order, off))
    t_p = call_ms(lambda: g.new_zeros(n, w).index_put_(
        (idx,), g, accumulate=True), rounds=2, iters=1, warmup=1)[0]
    t_l = device_ms(lambda: g.new_zeros(n, w).index_add_(0, idx, g))
    b_ms = (e * w * 4 + n * w * 4 + e * 4 + (n + 1) * 4) \
        / HBM_BYTES_PER_S * 1e3
    log(f"{what} list_sum E={e} N={n} W={w} (largest row {int(m.max())} "
        f"positions, {int((m == 0).sum())} empty rows; plan: {plan.blocks} "
        f"shares of {gather.SHARE_WARPS} x {plan.share} positions, "
        f"{-(-w // plan.tile)} column tiles of {plan.tile}): kernel within "
        f"rtol 1e-5 + 2(m-1)u sum|x| of the float64 sum (max |diff| "
        f"{err:.3g}), bit-equal to its model and twice; kernel {t_k:.4f} ms "
        f"L2 warm, {t_f:.4f} ms flushed; byte bound {b_ms * 1e3:.2f} us = "
        f"{b_ms / t_k:.1%} of the warm time, {b_ms / t_f:.1%} of the "
        f"flushed; plain (index_put_, sorted) {t_p:.4f} ms, index_add_ "
        f"{t_l:.4f} ms: kernel / index_add_ = {t_k / t_l:.3f} ({card})")
    if faster:
        assert t_k <= t_l, f"list_sum {t_k:.4f} ms, index_add_ {t_l:.4f} ms"
    return {"E": e, "N": n, "W": w, "largest": int(m.max()),
            "max_abs_err": err, "ms": t_k, "ms_l2_flushed": t_f,
            "bound_ms": b_ms, "plain_ms": t_p, "library_ms": t_l}


def slot_owner_call_check(cum, edge_cap: int, what: str, card):
    """The slot-owner kernel at one recorded call (a hop's expansion):
    bit-equal to its plain twin (`slot_owner_plain`, searchsorted), to
    the JAX package's scatter-and-cummax route and to the plain model of
    its partition (`slot_owner_runs`, where the tree has it), times beside
    the byte bound, the plain twin, the cummax route and one
    torch.searchsorted over the clamped slots, with the kernel's ratio to
    it."""
    from redgnn_tpu_torch.ops import frontier

    got = frontier.slot_owner(cum, edge_cap)
    torch.cuda.synchronize()
    assert torch.equal(got, frontier.slot_owner_plain(cum, edge_cap)), \
        "the kernel left its plain twin"
    assert torch.equal(got, frontier.slot_owner_cummax(cum, edge_cap)), \
        "the kernel left the cummax route"
    if hasattr(frontier, "slot_owner_runs"):
        assert torch.equal(got, frontier.slot_owner_runs(cum, edge_cap)[0]), \
            "the kernel left its partition's model"
    p = cum.shape[0]
    total = int(cum[-1])
    xs = torch.minimum(torch.arange(edge_cap, device=cum.device), cum[-1] - 1)
    t_k = device_ms(lambda: frontier.slot_owner(cum, edge_cap))
    t_f = flushed_ms(lambda: frontier.slot_owner(cum, edge_cap))
    t_p = device_ms(lambda: frontier.slot_owner_plain(cum, edge_cap))
    t_c = device_ms(lambda: frontier.slot_owner_cummax(cum, edge_cap))
    t_l = device_ms(lambda: torch.searchsorted(cum, xs, right=True))
    b_ms = (p * 8 + edge_cap * 8) / HBM_BYTES_PER_S * 1e3
    owners = int((torch.diff(cum, prepend=cum.new_zeros(1)) > 0).sum())
    log(f"{what} slot_owner P={p} edge_cap={edge_cap} ({total} edges, "
        f"{owners} nodes with edges): bit-equal to searchsorted and to the "
        f"cummax route; kernel {t_k:.4f} ms L2 warm, {t_f:.4f} ms flushed; "
        f"byte bound {b_ms * 1e3:.2f} us = {b_ms / t_k:.1%} of the warm "
        f"time; plain twin (searchsorted) {t_p:.4f} ms, the cummax route "
        f"{t_c:.4f} ms, torch.searchsorted alone {t_l:.4f} ms: kernel / "
        f"searchsorted = {t_k / t_l:.3f} ({card})")
    return {"P": p, "edge_cap": edge_cap, "max_abs_err": 0.0, "ms": t_k,
            "ms_l2_flushed": t_f, "bound_ms": b_ms, "plain_ms": t_p,
            "cummax_ms": t_c, "library_ms": t_l}


def hop_pass_profiles(owners, lists, tag: str, card):
    """Each pass's device time (`pass_profile`) at the widest of the
    recorded owner fills ``owners`` and the first of the recorded
    listed-gather backwards ``lists``, through whichever package is
    loaded (this tree's, or the parent's under ``--tree``), and the
    list-sum kernel there at other warp shares where the package picks
    them (`list_share`): each bit-equal to the model of its order."""
    from redgnn_tpu_torch.ops import frontier, gather

    if owners:
        cum, cap = max(owners, key=lambda c: c[1])
        pass_profile(lambda: frontier.slot_owner(cum, cap),
                     f"{tag} slot_owner edge_cap={cap}", card)
    if not lists:
        return
    g, order, off = lists[0]
    pass_profile(lambda: gather.list_sum(g, order, off),
                 f"{tag} list_sum E={g.shape[0]} W={g.shape[1]}", card)
    if not hasattr(gather, "list_share"):
        return
    orig = gather.list_share
    try:
        for share in (1, 64):  # the sweep's ends keep their model's bits
            gather.list_share = lambda e, share=share: share
            assert torch.equal(gather.list_sum(g, order, off),
                               gather.list_sum_model(g, order, off)), share
    finally:
        gather.list_share = orig
    share = gather._list_plan(g.shape[0], off.shape[0] - 1,
                              g.shape[1]).share
    log(f"{tag} list_sum E={g.shape[0]} W={g.shape[1]} at other warp "
        f"shares (positions a warp; the plan's {share}), ms L2 warm: "
        f"{list_share_sweep(lambda: gather.list_sum(g, order, off), share)} "
        f"({card})")


def hop_index_calls(run):
    """[cum, edge_cap] of every owner fill and [g, order, off] of every
    listed-gather backward that ``run()`` makes, in order."""
    from redgnn_tpu_torch.ops import frontier, gather

    calls = record_calls([(frontier, "slot_owner"), (gather, "list_sum")],
                         run)
    return calls["slot_owner"], calls["list_sum"]


def hop_index_check(trainer, pred, queries, main: dict, steps: int, tag: str,
                    card):
    """Phase 7h (in 7a and 7c): the slot-owner kernel at every hop of one
    served batch and of one training step, the list-sum kernel at every
    dense call of the step, each held and timed call by call. ``main``
    holds the launches counted over the trainer's ``steps`` steps and the
    served batches. Returns the rows and counts of both kernels."""
    q0 = queries[:pred.batch]
    out = {"slot_owner": {}, "list_sum": {}}
    for part, run in (("serve", lambda: pred.predict(q0[:, 0], q0[:, 1],
                                                    q0[:, 3])),
                      ("train", temporal_step_fn(trainer))):
        owners, lists = hop_index_calls(run)
        trainer.model.zero_grad(set_to_none=True)
        what = f"{tag} {part}"
        out["slot_owner"][part] = [slot_owner_call_check(*c, what, card)
                                   for c in owners]
        # a dense hop's backward sums the state's gradient by source (rows:
        # the entities) and, with a time term, the time term's by time id
        by_src = [int(c[2].shape[0]) == trainer.kg.n_ent + 1 for c in lists]
        if part == "train":
            n_src = sum(by_src)
            assert len(lists) == n_src * (
                1 + trainer.model_cfg.use_time), (len(lists), n_src)
            log(f"{what} list_sum: {n_src} calls by source, "
                f"{len(lists) - n_src} by time id")
        # 7a's train calls by source: the kernel must not be slower than
        # index_add_
        out["list_sum"][part] = [
            list_sum_call_check(*c, what, card,
                                faster=tag == "[7a]" and src)
            for c, src in zip(lists, by_src)]
        for name, calls in (("slot_owner", owners), ("list_sum", lists)):
            out[name][f"launches_per_{part}"] = len(calls)
        if part == "serve":
            hop_pass_profiles(owners, [], what, card)
        else:
            hop_pass_profiles([], lists, what, card)
        del owners, lists
    assert out["list_sum"]["launches_per_serve"] == 0  # no backward
    for name in out:
        rows = out[name]["train"]
        out[name]["launches"] = main[name]
        log(f"{tag} {name}: {out[name]['launches_per_serve']} launches a "
            f"served batch, {out[name]['launches_per_train']} a train step "
            f"({main[name]} over the {steps} steps of the trainer's "
            f"epochs); per train step kernel "
            f"{sum(r['ms'] for r in rows):.4f} ms L2 warm, byte bound "
            f"{sum(r['bound_ms'] for r in rows):.4f} ms, plain "
            f"{sum(r['plain_ms'] for r in rows):.4f} ms ({card})")
    return out


def phase_hop_alone(mod, card):
    """Phase 7h alone (``--phase 7h``): 7a's and 7c's dirs, trainers and
    Predictors as phase 7 builds them; ``N_BATCHES`` timed served batches
    and their profile, two epochs of ``HOP_ALONE_STEPS`` train steps and a
    2-step profile, through ``mod``'s own functions, then (where ``mod``
    has phase 7h) its kernel checks at the same calls; then the static
    cells (`hop_static_alone`). ``mod`` is this script or, with ``--tree
    DIR``, DIR's chip_smoke.py running DIR's package: the parent tree's
    steps and batches on the same card; this script's `hop_pass_profiles`
    splits DIR's kernels into their passes too. Returns ms per served
    batch and per step of every cell and the kernels' ms at its calls."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.ops import frontier, gather
    from redgnn_tpu_torch.serve import Predictor
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer
    from redgnn_tpu_torch.utils.config import dataset_config

    counted = [getattr(frontier, "slot_owner", None),
               getattr(gather, "list_sum", None)]
    counted = [f for f in counted if f is not None]
    out = {}
    for entry, forecasting, tag in (("ICEWS14_TeMP", False, "[7a]"),
                                    ("ICEWS14_forecasting", True, "[7c]")):
        with tempfile.TemporaryDirectory() as tmp:
            mod.write_icews14_sized(tmp, forecasting)
            cfg = dataset_config("temporal", entry,
                                 max_train_batches=HOP_ALONE_STEPS,
                                 max_eval_batches=1)
            trainer = TemporalTrainer(load_temporal_kg(tmp, cfg, "cuda"), cfg)
            if not forecasting:  # as phase 7a scales it
                with torch.no_grad():
                    trainer.model.classifier_w.abs_().mul_(1e-6)
            pred = Predictor.from_trainer(trainer, split="test", top_k=10)
            queries = trainer.kg.splits["test"][:N_BATCHES * pred.batch]
            mod.timed_batches(pred, queries, 1)  # warm-up
            for f in counted:
                f.launches = 0
            times, _ = mod.timed_batches(pred, queries, N_BATCHES)
            served = {f.__name__: f.launches for f in counted}
            log(f"{tag} served {N_BATCHES} batches of {pred.batch}: "
                f"per-batch ms {[round(t, 3) for t in times]}; mean "
                f"{np.mean(times):.3f} ms; launches {served} ({card})")
            mod.profile_batches(pred, queries[:2 * pred.batch], card)
            for f in counted:
                f.launches = 0
            step_ms, _ = mod.temporal_train_check(trainer, tag, card)
            main = {f.__name__: f.launches for f in counted}
            log(f"{tag} launches over {2 * HOP_ALONE_STEPS} train steps: "
                f"{main}")
            mod.temporal_profile_steps(trainer, card)
            res = (mod.hop_index_check(trainer, pred, queries, main,
                                       2 * HOP_ALONE_STEPS, tag, card)
                   if hasattr(mod, "hop_index_check") else {})
            if mod is not sys.modules[__name__]:
                q0 = queries[:pred.batch]
                owners, _ = hop_index_calls(lambda: pred.predict(
                    q0[:, 0], q0[:, 1], q0[:, 3]))
                _, lists = hop_index_calls(temporal_step_fn(trainer))
                trainer.model.zero_grad(set_to_none=True)
                hop_pass_profiles(owners, [], f"{tag} serve", card)
                hop_pass_profiles([], lists, f"{tag} train", card)
                del owners, lists
        out[entry] = {"serve_ms": float(np.mean(times)), "step_ms": step_ms,
                      "kernels": {name: {part: [r["ms"] for r in res[name][
                          part]] for part in ("serve", "train")}
                          for name in res}}
    out.update(hop_static_alone(mod, card))
    return out


def hop_static_alone(mod, card):
    """Phase 7h alone, the static cells, through ``mod``'s own functions:
    the umls entry at its registry defaults (``N_BATCHES`` served batches,
    two epochs of UMLS_TRAIN_STEPS train steps, the list-sum kernel at one
    train step's dense calls) and the family entry through the segment
    kernel (``N_BATCHES`` served batches, the slot-owner kernel at one
    served batch's hops), each kernel split into its passes. Returns ms
    per served batch (and per step) and the kernels' ms at those calls."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        mod.write_umls_sized_kg(tmp)
        kg, cfg, _, pred = mod.build_slice(tmp, "cuda", "umls",
                                           scan_chunk=UMLS_TRAIN_STEPS)
        queries = mod.serving_queries(kg, N_BATCHES * pred.batch)
        mod.timed_batches(pred, queries, 1)  # warm-up
        times, _ = mod.timed_batches(pred, queries, N_BATCHES)
        log(f"[umls] served {N_BATCHES} batches of {pred.batch} at registry "
            f"defaults: per-batch ms {[round(t, 3) for t in times]}; mean "
            f"{np.mean(times):.3f} ms ({card})")
        trainer = mod.make_trainer(tmp, "cuda", cfg, steps=UMLS_TRAIN_STEPS)
        step_ms, _ = mod.train_steps_check(trainer, UMLS_TRAIN_STEPS,
                                           "[umls]", card)
        caps = mod.exact_train_caps(trainer)

        def one_step():
            from redgnn_tpu_torch.train.loop import softmax_ce_loss

            subs, rels, objs, qmask = mod.step_tensors(trainer, 0)
            scores, _ = trainer.model(trainer.kg.graph, subs, rels, qmask,
                                      caps)
            softmax_ce_loss(scores, objs, qmask).backward()

        _, lists = hop_index_calls(one_step)
        trainer.model.zero_grad(set_to_none=True)
        assert lists, "the umls train step made no dense hop"
        rows = [mod.list_sum_call_check(*c, "[umls] 7h training", card)
                for c in lists]
        hop_pass_profiles([], lists, "[umls] 7h training", card)
        del lists
        out["umls"] = {"serve_ms": float(np.mean(times)),
                       "step_ms": step_ms,
                       "kernels": {"list_sum": {"train": [r["ms"]
                                                          for r in rows]}}}
    with tempfile.TemporaryDirectory() as tmp:
        mod.write_synthetic_kg(tmp)
        kg, _, _, pred = mod.build_slice(tmp, "cuda", **mod.KERNEL_SLICE)
        queries = mod.serving_queries(kg, N_BATCHES * pred.batch)
        mod.timed_batches(pred, queries, 1)  # warm-up
        times, _ = mod.timed_batches(pred, queries, N_BATCHES)
        log(f"[family] served {N_BATCHES} batches of {pred.batch} through "
            f"the segment kernel: per-batch ms "
            f"{[round(t, 3) for t in times]}; mean {np.mean(times):.3f} ms "
            f"({card})")
        q0 = queries[:pred.batch]
        owners, _ = hop_index_calls(lambda: pred.predict(q0[:, 0],
                                                         q0[:, 1]))
        rows = [mod.slot_owner_call_check(*c, "[family] 7h serve", card)
                for c in owners]
        hop_pass_profiles(owners, [], "[family] 7h serve", card)
        out["family"] = {"serve_ms": float(np.mean(times)),
                         "kernels": {"slot_owner": {"serve": [
                             r["ms"] for r in rows]}}}
    return out


# ---------------- phase 7i: the dense hop's forward as one kernel each

# the dense hop's forward, one hand-written kernel per model (XLA
# compositions in the JAX package, no Pallas kernel)
DENSE_HOP_KERNELS = {
    "dense_hop_static": {
        "source": "redgnn_tpu_torch/csrc/dense_hop_static.cu",
        "replaces": "redgnn_tpu/models/layers.py:159"},
    "dense_hop_temporal": {
        "source": "redgnn_tpu_torch/csrc/dense_hop_temporal.cu",
        "replaces": "redgnn_tpu/models/temporal.py:461"},
}
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
U32 = 2.0 ** -24


class Recorder:
    """A stand-in for a kernel wrapper of `ops/dense_hop.py` while a run is
    recorded: hands each call's arguments to ``sink``, then calls the
    wrapper. The wrappers count their launches on themselves by their
    module name, which names this object meanwhile, so ``launches``
    reads and writes the wrapper's own counter."""

    def __init__(self, fn, sink):
        self.fn, self.sink = fn, sink

    def __call__(self, *a):
        self.sink(a)
        return self.fn(*a)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


def dense_hop_calls(run):
    """[kind, (module, hop args), kernel args] of every fused dense hop
    that ``run()`` makes, in order: the hop's module and the arguments of
    RelAttnLayer.dense_fused / TRedGNN._dense_hop_fused ('static' /
    'temporal'), and those its kernel wrapper was called with."""
    from redgnn_tpu_torch.models import layers, temporal
    from redgnn_tpu_torch.ops import dense_hop as dh

    calls, saved = [], []
    for name in ("dense_hop_static", "dense_hop_temporal"):
        fn = getattr(dh, name)
        saved.append((dh, name, fn))
        setattr(dh, name, Recorder(
            fn, lambda a: calls[-1].__setitem__(2, a)))
    for kind, cls, name in (("static", layers.RelAttnLayer, "dense_fused"),
                            ("temporal", temporal.TRedGNN,
                             "_dense_hop_fused")):
        meth = getattr(cls, name)

        def hop(self, *a, _meth=meth, _kind=kind):
            calls.append([_kind, (self, a), None])
            return _meth(self, *a)

        saved.append((cls, name, meth))
        setattr(cls, name, hop)
    try:
        run()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return calls


def dense_hop_work(kind, args, kept: int):
    """(bytes, float32 FLOPs, the FLOPs under PR 13's count) the hop must
    spend: every input read once and every output written once, and the
    arithmetic that no hoisting removes (``kept`` from this run's counts).
    Per kept (edge, query): the hidden-state projections and the message's
    own terms. The temporal direction transform is linear and comes before
    the sum, so it is counted once per (tail, query, direction with a kept
    edge) (2d^2, or 2d for the bias form's sum of attention weights times
    B[dir]); PR 13's count took it per kept pair (2d^2, or d)."""
    if kind == "static":
        hidden, vis, rela, tsrc, trel, _, rowptr, wr, wq, ws = args[:10]
        n, b, d = hidden.shape
        a = ws.shape[0]
        flops = kept * (2 * d * a + 4 * a + 3 * d + 4)
        flops_pr13 = flops
    else:
        (hidden, vis, rela, tsrc, trel, ttime, ttail, rowptr, times, excl,
         ekeep, tt, ra, qa, a1s, a2, wdir, bdir, drop) = args[:19]
        n, b, d = hidden.shape
        a = 0 if ra is None else ra.shape[1]
        pair = ((2 * d * a + 4 * a + 4 if ra is not None else 0)
                + (d if tt is not None else 0) + d
                + (2 * d if ra is not None else d))
        flops_pr13 = kept * (pair + (2 * d * d if wdir is not None else d))
        keep = vis[tsrc.long()]
        if excl is not None:
            keep = keep & excl[:, None]
        if ekeep is not None:
            keep = keep & ekeep
        direction = torch.sign(ttime[:, None] - times[None, :]) + 1
        key = ((ttail.long()[:, None] * b
                + torch.arange(b, device=keep.device)) * 3 + direction)
        triples = int(torch.unique(key[keep]).numel())
        del keep, direction, key
        flops = kept * pair + triples * (2 * d * d if wdir is not None
                                         else 2 * d)
    moved = sum(t.numel() * t.element_size() for t in args
                if torch.is_tensor(t) and t is not args[5])  # ttail unread
    moved += n * b * d * 4 + n * b  # outputs
    return moved, flops, flops_pr13


def dense_hop_plan(args):
    """The work plan of the kernel at one call: (its chunk, EDGE_CHUNK;
    its items; warps launched a multiprocessor)."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    b = args[1].shape[1]
    items = int(args[-1][-1])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return dh.EDGE_CHUNK, items, items * -(-b // 32) / n_sm


def float64_check(kind, args, got, want):
    """The kernel's output ``got[0]`` against a float64 referee on the
    same inputs, within (1e-5 + 2 (m - 1) u) sum|x| per output plus twice
    the plain version's (``want[0]``) own error (tests/test_torch_cuda.py's
    bound: the terms' float32 rounding, a float32 sum of the tail's m
    edges in any order, and the cancellation inside a term that the plain
    float32 shares). Returns the largest shares of the bound, of its sum
    term alone, and of the sum term that the plain version reaches."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    def f64(x):
        return (x.double() if torch.is_tensor(x)
                and x.dtype == torch.float32 else x)

    ref = [f64(x) for x in args]
    hidden, ttail = args[0], args[5] if kind == "static" else args[6]
    n = hidden.shape[0]
    if kind == "static":
        msg, _ = dh.static_messages(*(ref[i] for i in (0, 1, 2, 3, 4, 7, 8,
                                                         9, 10, 11)))
        want64 = torch.zeros((n,) + msg.shape[1:], dtype=torch.float64,
                             device=hidden.device).index_add_(
                                 0, ttail.long(), msg)
        scale = 1.0
    else:
        msg, _ = dh.temporal_messages(*(ref[i] for i in (
            0, 1, 2, 3, 4, 5, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17)))
        want64 = dh.dense_hop_temporal_plain(*ref[:-1])[0]
        scale = 1.0 / (1.0 - args[19]) if args[18] is not None else 1.0
    s_abs = torch.zeros_like(want64).index_add_(0, ttail.long(), msg.abs())
    del msg
    s_abs = s_abs * scale + 4 * U32 * want64.abs()
    m = torch.bincount(ttail.long(), minlength=n).to(torch.float64)
    # a term that is itself a sum (the transform's, the attention's)
    # carries its own cancellation, which the plain version's float32
    # shares: twice its error is allowed besides
    sum_bound = (1e-5 + 2 * torch.clamp(m - 1, min=0)[:, None, None]
                 * U32) * s_abs
    plain_err = (want[0].double() - want64).abs()
    bound = sum_bound + 2 * plain_err
    diff = (got[0].double() - want64).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())
    ratio = float((diff / torch.clamp(bound, min=1e-300)).max())
    # the shares of the sum's bound alone, without the plain version's
    # error, that the kernel and the plain float32 version reach: above 1
    # where a term's own cancellation carries the check
    sum_bound = torch.clamp(sum_bound, min=1e-300)
    return (ratio, float((diff / sum_bound).max()),
            float((plain_err / sum_bound).max()))


def dense_hop_widths(args, tag: str, card):
    """The temporal kernel at hidden widths 48 and 64 (its run-time-flag
    instances, whose transform stays per edge) on one served dense call's
    table, visited set, time ids and masks, with seeded random state and
    weights (attention width 30, the call's transform form): visited set
    and counts equal to the plain version's, the output within the float64
    bound of `float64_check`, max |diff| to the plain version (which sums
    with index_add_'s float atomics, so it moves from run to run while the
    kernel's bits do not), and the kernel's device time with L2 warm.
    Returns {width: ms}."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    args = list(args)
    hidden, visited, rela, tt, wdir = args[0], args[1], args[2], args[11], \
        args[16]
    n, b, _ = hidden.shape
    r, a = rela.shape[0], 30
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for d in (48, 64):
        def rand(*s, scale=1.0):
            return torch.randn(*s, generator=gen, device="cuda") * scale

        run = list(args)
        run[0] = rand(n, b, d) * visited[..., None]
        run[2] = rand(r, d)
        run[11] = None if tt is None else rand(tt.shape[0], b, d, scale=0.1)
        run[12:16] = [rand(r, a, scale=0.3), rand(b, a, scale=0.3),
                      rand(d, a, scale=0.3), rand(a, 1, scale=0.3)]
        run[16] = rand(3, d, d, scale=0.3) if wdir is not None else None
        run[17] = None if wdir is not None else rand(3, d)
        run[18] = None  # no dropout mask
        got = dh.dense_hop_temporal(*run)
        want = dh.dense_hop_temporal_plain(*run[:-1])
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), d
        assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]], d
        err = float((got[0] - want[0]).abs().max())
        scale = float(want[0].abs().max())
        ratio = float64_check("temporal", run, got, want)[0]
        del want
        out[d] = device_ms(lambda: dh.dense_hop_temporal(*run))
        log(f"{tag} 7i temporal kernel at width {d} (A={a}, the run-time "
            f"flags, the transform per edge) on the call's table: "
            f"{int(got[3])} kept pairs; visited and counts equal to the "
            f"plain version's, max |diff| {err:.3g} (largest |value| "
            f"{scale:.3g}), at most {ratio:.3g} of the float64 bound; "
            f"kernel {out[d]:.4f} ms with L2 warm ({card})")
        del got, run
    return out


def dense_hop_call_check(kind, hop, args, graph, what: str, card):
    """The kernel at one dense hop's real inputs: against its plain version
    (new visited set and counts equal; max |diff| printed), against a
    float64 referee within `float64_check`'s bound, the same bits on a
    second call; device times with L2 warm (as in the path,
    where the state was written just before) and flushed, the plain
    version's; host-clock times of the whole fused hop (terms, kernel,
    W_h or the epilogue) and of the old route (the autograd route's
    tensor ops with gradients off; no single PyTorch call computes the
    hop); the bound, the larger of the bytes the hop must move and the
    float32 work per kept pair. Returns the row."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    kernel = getattr(dh, f"dense_hop_{kind}")
    plain = getattr(dh, f"dense_hop_{kind}_plain")
    plain_args = args[:-1]  # the plain versions take no work plan
    got, again = kernel(*args), kernel(*args)
    want = plain(*plain_args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "two calls gave different bits"
    assert torch.equal(got[1], want[1]), "new visited sets differ"
    counts = [int(c) for c in got[2:]]
    assert counts == [int(c) for c in want[2:]], (counts, want[2:])
    err = float((got[0] - want[0]).abs().max())
    ratio, ratio_sum, ratio_plain = float64_check(kind, args, got, want)
    hidden = args[0]

    t_k = device_ms(lambda: kernel(*args))
    t_f = flushed_ms(lambda: kernel(*args))
    t_p = device_ms(lambda: plain(*plain_args), calls=5, reps=4)
    module, hop_args = hop
    with torch.no_grad():
        if kind == "static":
            fused = lambda: module.dense_fused(*hop_args)  # noqa: E731
            old = lambda: module.dense_autograd(  # noqa: E731
                *hop_args[:8], graph.tsrc_order, graph.rowptr)
        else:
            fused = lambda: module._dense_hop_fused(*hop_args)  # noqa: E731
            old = lambda: module._dense_hop_autograd(  # noqa: E731
                *hop_args[:11], graph.tsrc_order, graph.rowptr,
                *hop_args[11:14])
        t_hop = call_ms(fused, rounds=3, iters=10)[0]
        t_old = call_ms(old, rounds=3, iters=5, warmup=2)[0]
    moved, flops, flops_pr13 = dense_hop_work(kind, args, counts[-1])
    b_bytes = moved / HBM_BYTES_PER_S * 1e3
    b_ops = flops / FP32_FLOPS_PER_S * 1e3
    b_ms, by = max((b_bytes, "bytes"), (b_ops, "operations"))
    b_pr13 = max(b_bytes, flops_pr13 / FP32_FLOPS_PER_S * 1e3)
    chunk, items, warps = dense_hop_plan(args)
    n_, b_, d_ = hidden.shape
    e_ = int(args[3].shape[0])
    log(f"{what} {kind} dense call plan: chunk {chunk}, {items} items x "
        f"{-(-b_ // 32)} query groups = "
        f"{warps:.1f} warps launched a multiprocessor; "
        f"{counts[-1] / max(1, e_ * b_):.1%} of the (edge, query) pairs "
        f"kept; bound {b_ms * 1e3:.2f} us ({b_ms / t_k:.1%} "
        f"reached), under PR 13's count {b_pr13 * 1e3:.2f} us "
        f"({b_pr13 / t_k:.1%}) ({card})")
    log(f"{what} {kind} dense call N={n_} b={b_} d={d_} "
        f"{str(hidden.dtype)[6:]} E={args[3].shape[0]}: {counts[-1]} kept "
        f"(edge, query) pairs; kernel == plain (visited, counts {counts}), "
        f"max |diff| {err:.3g}, at most {ratio:.3g} of the float64 bound "
        f"({ratio_sum:.3g} of its (1e-5 + 2(m-1)u) sum|x| term alone, "
        f"the plain version {ratio_plain:.3g}); "
        f"same bits twice; kernel {t_k:.4f} ms with L2 warm, {t_f:.4f} ms "
        f"flushed; plain {t_p:.4f} ms; whole fused hop {t_hop:.4f} ms, old "
        f"route {t_old:.4f} ms (host clock, eager, least of 3 rounds); "
        f"bound {b_ms * 1e3:.2f} us by {by} ({moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP) = {b_ms / t_k:.1%} of the kernel's time "
        f"({card})")
    return {"kind": kind, "N": n_, "b": b_, "d": d_,
            "E": int(args[3].shape[0]), "kept": counts[-1],
            "max_abs_err": err, "bound_share": ratio,
            "sum_bound_share": ratio_sum,
            "plain_sum_bound_share": ratio_plain, "ms": t_k,
            "ms_l2_flushed": t_f, "plain_ms": t_p, "hop_ms": t_hop,
            "old_route_ms": t_old, "bound_ms": b_ms, "bound_by": by,
            "bound_ms_pr13": b_pr13, "bytes": moved, "flops": flops,
            "chunk": chunk, "items": items, "warps_per_sm": warps,
            "kept_share": counts[-1] / max(1, e_ * b_)}


def dense_hop_check(pred, q0, tag: str, card):
    """Phase 7i at a cell: the dense hop kernel at every dense call of one
    served batch of ``q0`` (`dense_hop_call_check`). Returns the rows."""
    calls = dense_hop_calls(lambda: pred.predict(
        q0[:, 0], q0[:, 1], q0[:, 3] if pred.temporal else None))
    assert calls and all(c[2] is not None for c in calls), len(calls)
    with torch.no_grad():  # the recorded tensors are inference tensors
        rows = [dense_hop_call_check(kind, hop, args, pred.graph,
                                     f"{tag} 7i serving", card)
                for kind, hop, args in calls]
        if calls[-1][0] == "temporal":
            rows[-1]["widths_ms"] = dense_hop_widths(calls[-1][2], tag, card)
    del calls
    return rows


def dense_hop_launches():
    from redgnn_tpu_torch.ops import dense_hop as dh

    return dh.dense_hop_static.launches + dh.dense_hop_temporal.launches


def reset_dense_hop_launches():
    from redgnn_tpu_torch.ops import dense_hop as dh

    dh.dense_hop_static.launches = dh.dense_hop_temporal.launches = 0


DENSE_ALONE_STEPS = 4  # train steps of the trainers --phase 7i builds


def dense_rows_summary(rows) -> dict:
    """Phase 7i's numbers of a cell's dense calls, by call, for its JSON
    line (keys a row of an older tree lacks are left out)."""
    keys = ("ms", "ms_l2_flushed", "old_route_ms", "bound_ms",
            "bound_ms_pr13", "chunk", "items", "warps_per_sm", "kept_share")
    out = {f"kernel_{k}" if k in ("ms", "ms_l2_flushed") else k:
           [r[k] for r in rows] for k in keys if k in rows[0]}
    if "widths_ms" in rows[-1]:
        out["widths_ms"] = rows[-1]["widths_ms"]
    return out


def phase_dense_alone(mod, card):
    """Phase 7i alone (``--phase 7i``): through ``mod``'s own functions,
    7a's dir, trainer and Predictor as phase 7 builds them
    (``N_BATCHES`` timed served batches, their peak memory, a timed
    ``evaluate('valid')`` of its first T_EVAL_BATCHES batches and its
    peak), then the umls entry at its defaults (served batches and an
    evaluation, the same numbers); where ``mod`` has phase 7i, the
    kernels at one served batch's dense calls of each. ``mod`` is this
    script or, with ``--tree DIR``, DIR's chip_smoke.py running DIR's
    package: the parent tree's batches on the same card. Returns the
    numbers by cell."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.serve import Predictor
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer
    from redgnn_tpu_torch.utils.config import dataset_config

    out = {}

    def timed_eval(trainer, n_q):
        trainer.evaluate("valid")  # warm-up; the split's caps are exact
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.evaluate("valid")
        seconds = time.perf_counter() - t0
        return n_q / seconds, torch.cuda.max_memory_allocated()

    with tempfile.TemporaryDirectory() as tmp:
        mod.write_icews14_sized(tmp, False)
        cfg = dataset_config("temporal", "ICEWS14_TeMP",
                             max_train_batches=DENSE_ALONE_STEPS,
                             max_eval_batches=T_EVAL_BATCHES["ICEWS14_TeMP"])
        trainer = TemporalTrainer(load_temporal_kg(tmp, cfg, "cuda"), cfg)
        with torch.no_grad():  # as phase 7a scales it
            trainer.model.classifier_w.abs_().mul_(1e-6)
        pred = Predictor.from_trainer(trainer, split="test", top_k=10)
        queries = trainer.kg.splits["test"][:N_BATCHES * pred.batch]
        mod.timed_batches(pred, queries, 1)  # warm-up
        times, peak = mod.timed_batches(pred, queries, N_BATCHES)
        n_q = min(len(trainer.kg.splits["valid"]),
                  cfg.max_eval_batches * cfg.eval_batch_size)
        qps, eval_peak = timed_eval(trainer, n_q)
        log(f"[7a] 7i served {N_BATCHES} batches of {pred.batch}: per-batch "
            f"ms {[round(t, 3) for t in times]}; mean {np.mean(times):.3f} "
            f"ms; max_memory_allocated {peak} B; evaluate('valid') of "
            f"{n_q} queries {qps:.1f} queries/s, max_memory_allocated "
            f"{eval_peak} B ({card})")
        out["ICEWS14_TeMP"] = {"serve_ms": float(np.mean(times)),
                               "serve_peak": peak, "eval_qps": qps,
                               "eval_peak": eval_peak}
        if hasattr(mod, "dense_hop_check"):
            rows = mod.dense_hop_check(pred, queries[:pred.batch], "[7a]",
                                       card)
            out["ICEWS14_TeMP"].update(dense_rows_summary(rows))
        del trainer, pred
    with tempfile.TemporaryDirectory() as tmp:
        mod.write_umls_sized_kg(tmp)
        kg, cfg, _, pred = mod.build_slice(tmp, "cuda", "umls")
        queries = mod.serving_queries(kg, N_BATCHES * pred.batch)
        mod.timed_batches(pred, queries, 1)  # warm-up
        times, peak = mod.timed_batches(pred, queries, N_BATCHES)
        trainer = mod.make_trainer(tmp, "cuda", cfg,
                                   steps=DENSE_ALONE_STEPS)
        qps, eval_peak = timed_eval(trainer, len(
            trainer.kg.eval_spec("valid").queries))
        log(f"[umls] 7i served {N_BATCHES} batches of {pred.batch}: "
            f"per-batch ms {[round(t, 3) for t in times]}; mean "
            f"{np.mean(times):.3f} ms; max_memory_allocated {peak} B; "
            f"evaluate('valid') {qps:.1f} grouped queries/s, "
            f"max_memory_allocated {eval_peak} B ({card})")
        out["umls"] = {"serve_ms": float(np.mean(times)), "serve_peak": peak,
                       "eval_qps": qps, "eval_peak": eval_peak}
        if hasattr(mod, "dense_hop_check"):
            rows = mod.dense_hop_check(pred, queries[:pred.batch], "[umls]",
                                       card)
            out["umls"].update(dense_rows_summary(rows))
    return out


# ---------------- phase 7j: the dense hop's backward as one kernel each

# the dense hop's backward, one hand-written kernel per model (XLA autodiff
# of the compositions in the JAX package, no Pallas kernel)
DENSE_BWD_KERNELS = {
    "dense_hop_static_bwd": {
        "source": "redgnn_tpu_torch/csrc/dense_hop_static_bwd.cu",
        "replaces": "redgnn_tpu/models/layers.py:159"},
    "dense_hop_temporal_bwd": {
        "source": "redgnn_tpu_torch/csrc/dense_hop_temporal_bwd.cu",
        "replaces": "redgnn_tpu/models/temporal.py:461"},
}
# the backwards' arguments that their plain versions do not take (the work
# plan and the graph's lists)
BWD_PLAN_ARGS = {"static": (7, 8, 14, 15),
                 "temporal": (10, 11, 25, 26, 27, 28)}


def event_ms(fn, reps: int = 3) -> float:
    """Mean time of ``fn`` between CUDA events over ``reps`` calls after
    one warm-up: for functions of milliseconds (the plain versions, the
    old route), whose host gaps are a small share and whose intermediates
    would not fit a captured graph's pool."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dense_bwd_calls(run):
    """[kind, (module, hop args), backward args] of every fused dense hop
    that ``run()`` (a forward and backward) makes: the hop's module and
    the arguments of RelAttnLayer.dense_fused / TRedGNN._dense_hop_fused,
    and those its backward wrapper was called with (the backwards run in
    the reverse order of the hops)."""
    from redgnn_tpu_torch.models import layers, temporal
    from redgnn_tpu_torch.ops import dense_hop as dh

    hops, bwds, saved = [], [], []
    for name in ("dense_hop_static_bwd", "dense_hop_temporal_bwd"):
        fn = getattr(dh, name)
        saved.append((dh, name, fn))
        setattr(dh, name, Recorder(fn, bwds.append))
    for kind, cls, name in (("static", layers.RelAttnLayer, "dense_fused"),
                            ("temporal", temporal.TRedGNN,
                             "_dense_hop_fused")):
        meth = getattr(cls, name)

        def hop(self, *a, _meth=meth, _kind=kind):
            hops.append([_kind, (self, a)])
            return _meth(self, *a)

        saved.append((cls, name, meth))
        setattr(cls, name, hop)
    try:
        run()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    assert len(hops) == len(bwds), (len(hops), len(bwds))
    return [h + [b] for h, b in zip(hops, reversed(bwds))]


def dense_bwd_plain_args(kind, args):
    return [a for i, a in enumerate(args) if i not in BWD_PLAN_ARGS[kind]]


def dense_bwd_work(kind, args):
    """(bytes, float32 FLOPs, kept pairs) a backward call must spend:
    every input read once and every gradient written once, and the
    arithmetic that no hoisting removes. Per kept (edge, query): the
    attention's projection recomputed, its transpose for d_hs and the
    contraction d A1 (2 d A each), the attention's vectors (6 A), the
    message's terms (static: 4 d; temporal: 6 d with W G hoisted per
    tail); per (tail, query, direction with a kept edge): W G and M (x) G
    (4 d^2; the bias form 4 d)."""
    if kind == "static":
        g, hidden, vis, rela, tsrc, trel = args[:6]
        ws = args[11]
        n, b, d = hidden.shape
        a = ws.shape[0]
        keep = vis[tsrc.long()]
        kept = int(keep.sum())
        flops = kept * (6 * d * a + 6 * a + 4 * d)
        outs = n * b * d + rela.numel() + args[9].numel() \
            + args[10].numel() + ws.numel() + a + 1
    else:
        (g, h, nv, hidden, vis, rela, tsrc, trel, ttime, ttail, _, _, times,
         excl, ekeep, tt, ra, qa, a1s, a2, wdir, bdir) = args[:22]
        n, b, d = hidden.shape
        a = 0 if ra is None else ra.shape[1]
        keep = vis[tsrc.long()]
        if excl is not None:
            keep = keep & excl[:, None]
        if ekeep is not None:
            keep = keep & ekeep
        kept = int(keep.sum())
        direction = torch.sign(ttime[:, None] - times[None, :]) + 1
        key = ((ttail.long()[:, None] * b
                + torch.arange(b, device=keep.device)) * 3 + direction)
        triples = int(torch.unique(key[keep]).numel())
        del keep, direction, key
        flops = kept * ((6 * d * a + 6 * a) + 6 * d) + triples * (
            4 * d * d if wdir is not None else 4 * d)
        outs = sum(x.numel() for x in (hidden, rela, tt, ra, qa, a1s, a2,
                                       wdir, bdir) if x is not None)
    moved = sum(t.numel() * t.element_size() for t in args
                if torch.is_tensor(t)) + 4 * outs
    return moved, flops, kept


def old_route_bwd_ms(kind, hop, graph, g) -> float:
    """The old route's backward: autograd of RelAttnLayer.dense_autograd /
    TRedGNN._dense_hop_autograd on the hop's arguments (its forward built
    once, outside the timing), from a cotangent of its output (``g`` for
    the temporal hop's h; static: a seeded one of act(W_h agg), whose
    backward through W_h is a small share), to the state and the
    parameters."""
    module, hop_args = hop
    hop_args = list(hop_args)
    with torch.enable_grad():
        # the state as a leaf: the step's own graph behind it is freed
        if kind == "static":
            state = hop_args[0] = hop_args[0].detach().requires_grad_()
            out = module.dense_autograd(*hop_args[:8], graph.tsrc_order,
                                        graph.rowptr)[0]
            g = torch.randn(out.shape, device=out.device,
                            generator=torch.Generator(
                                device=out.device).manual_seed(SEED))
        else:
            state = hop_args[0][0].detach().requires_grad_()
            hop_args[0] = (state, hop_args[0][1])
            out = module._dense_hop_autograd(
                *hop_args[:11], graph.tsrc_order, graph.rowptr,
                *hop_args[11:14])[0][0]
        inputs = [state] + [p for p in module.parameters()]
        ms = event_ms(lambda: torch.autograd.grad(
            out, inputs, g, retain_graph=True, allow_unused=True))
        del out
    return ms


def bwd_float64_check(kind, args, got, what: str):
    """A backward call's gradients ``got`` against the float64 plain
    backward on the same inputs (``args``, the wrapper's), within
    `ops.dense_hop.bwd_bound` with its ``kinks`` term, the parameters'
    sums at the chain of additions of the wrapper's last launch (the one
    that gave ``got``) and at their scale; on failure the worst element of
    the worst gradient is logged. Returns (the bound's largest share, max
    |diff| to the float32 plain backward)."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    plan = getattr(dh, f"dense_hop_{kind}_bwd").plan

    plain = getattr(dh, f"dense_hop_{kind}_bwd_plain")
    pargs = dense_bwd_plain_args(kind, args)
    want32 = plain(*pargs)
    err = max(float((x - y).abs().max()) for x, y in zip(got, want32)
              if x is not None and x.numel())
    ref = [x.double() if torch.is_tensor(x) and x.dtype == torch.float32
           else x for x in pargs]
    want = plain(*ref)
    s_abs = plain(*ref, absolute=True)
    kinks = plain(*ref, kinks=True)
    if kind == "static":
        n, b, _ = args[1].shape
        m = dh.bwd_term_counts("static", args[4], args[5], None, b, n,
                               args[3].shape[0], None, plan)
    else:
        n, b, _ = args[3].shape
        m = dh.bwd_term_counts("temporal", args[6], args[7], args[8], b, n,
                               args[5].shape[0], None if args[15] is None
                               else args[15].shape[0], plan)
    shares = dh.bwd_shares(got, want, s_abs, m, want32, kinks)
    share = max(x for x in shares if x is not None)
    if share > 1.0:  # the worst element of the worst gradient, then fail
        i = max((k for k, x in enumerate(shares) if x is not None),
                key=lambda k: shares[k])
        x, w, sa, p = (t[i].double() for t in (got, want, s_abs, want32))
        j = int(((x - w).abs() / torch.clamp(sa, min=1e-300)).argmax())
        log(f"{what} 7j {kind} backward: gradient {i} fails, shares "
            f"{shares}; its worst element {j}: kernel {float(x.flatten()[j])}"
            f", float64 {float(w.flatten()[j])}, float32 plain "
            f"{float(p.flatten()[j])}, sum|x| {float(sa.flatten()[j])}")
    assert share <= 1.0, (what, shares)
    return share, err


def dense_bwd_call_check(kind, hop, args, graph, what: str, card):
    """Phase 7j at one dense hop's backward: the kernel's gradients (with
    the list and scatter sums it feeds) against the float64 plain
    backward on the same inputs within `bwd_bound` (with its ``kinks``
    term: the whole of every attention term whose relu mask float32 may
    flip; max |diff| to the float32 plain backward printed), the same
    bits on a second call; the
    kernel's device time with L2 warm and flushed, the whole backward
    wrapper's and the plain version's (CUDA events), the old route's
    backward (library_ms: no single PyTorch call computes it), beside the
    bound. Returns the row."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    wrapper = getattr(dh, f"dense_hop_{kind}_bwd")
    plain = getattr(dh, f"dense_hop_{kind}_bwd_plain")
    pargs = dense_bwd_plain_args(kind, args)
    got, again = wrapper(*args), wrapper(*args)
    torch.cuda.synchronize()
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again)), "two calls gave different bits"
    share, err = bwd_float64_check(kind, args, got, what)
    n, b, d = (args[1] if kind == "static" else args[3]).shape
    # the kernel alone: its C entry through the wrapper with the list and
    # scatter sums left out
    t_all = device_ms(lambda: wrapper(*args), calls=5, reps=4)
    t_k, t_f = kernel_only_ms(kind, args)
    t_p = event_ms(lambda: plain(*pargs))
    t_old = old_route_bwd_ms(kind, hop, graph, args[0])
    moved, flops, kept = dense_bwd_work(kind, args)
    b_bytes = moved / HBM_BYTES_PER_S * 1e3
    b_ops = flops / FP32_FLOPS_PER_S * 1e3
    b_ms, by = max((b_bytes, "bytes"), (b_ops, "operations"))
    e = int(args[4 if kind == "static" else 6].shape[0])
    log(f"{what} 7j {kind} backward N={n} b={b} d={d} E={e}: {kept} kept "
        f"(edge, query) pairs; gradients at most {share:.3g} of the float64 "
        f"bound, max |diff| to the float32 plain backward {err:.3g}; same "
        f"bits twice; kernel {t_k:.4f} ms with L2 warm, {t_f:.4f} ms "
        f"flushed; with its list and scatter sums {t_all:.4f} ms; plain "
        f"{t_p:.4f} ms; old route's backward {t_old:.4f} ms (CUDA events); "
        f"bound {b_ms * 1e3:.2f} us by {by} ({moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP) = {b_ms / t_k:.1%} of the kernel's time "
        f"({card})")
    return {"kind": kind, "N": n, "b": b, "d": d, "E": e, "kept": kept,
            "max_abs_err": err, "bound_share": share, "ms": t_k,
            "ms_l2_flushed": t_f, "with_sums_ms": t_all, "plain_ms": t_p,
            "old_route_ms": t_old, "bound_ms": b_ms, "bound_by": by,
            "bytes": moved, "flops": flops}


def kernel_only_ms(kind, args, flushed: bool = True):
    """(L2 warm, flushed or None) device time of the backward kernel's C
    entry alone at one call (the wrapper with `list_sum` and
    `scatter_rows_add` replaced by no-ops)."""
    from redgnn_tpu_torch.ops import dense_hop as dh
    from redgnn_tpu_torch.ops import gather

    wrapper = getattr(dh, f"dense_hop_{kind}_bwd")
    saved = gather.list_sum, gather.scatter_rows_add
    gather.list_sum = lambda g, order, off: g[:off.shape[0] - 1]
    gather.scatter_rows_add = lambda g, idx, rows: g[:rows]
    try:
        return (device_ms(lambda: wrapper(*args), calls=5, reps=4),
                flushed_ms(lambda: wrapper(*args), calls=5, reps=4)
                if flushed else None)
    finally:
        gather.list_sum, gather.scatter_rows_add = saved


def dense_bwd_widths(kind, args, tag: str, card):
    """The backward kernel at hidden widths 48 and 64 on one train call's
    table, visited set, time ids and masks, with seeded random state,
    weights (attention width 30 for the temporal hop, the call's for the
    static one) and cotangent (the temporal h and visited set from the
    forward kernel): within the float64 bound of `dense_bwd_call_check`,
    the same bits twice, and the kernel's device time with L2 warm.
    Returns {width: ms}."""
    from redgnn_tpu_torch.ops import dense_hop as dh

    args = list(args)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for d in (48, 64):
        def rand(*s, scale=1.0):
            return torch.randn(*s, generator=gen, device="cuda") * scale

        run = list(args)
        if kind == "static":
            hidden, vis, rela = args[1], args[2], args[3]
            n, b, _ = hidden.shape
            r, a = rela.shape[0], args[11].shape[0]
            run[0] = rand(n, b, d)
            run[1] = (rand(n, b, d) * vis[..., None]).to(hidden.dtype)
            run[3] = rand(r, d).to(rela.dtype)
            run[9:14] = [rand(r, a, scale=0.3), rand(b, a, scale=0.3),
                         rand(a, d, scale=0.3), rand(a), rand(1)]
        else:
            hidden, vis, rela, tt, wdir = args[3], args[4], args[5], \
                args[15], args[20]
            n, b, _ = hidden.shape
            r, a = rela.shape[0], 30
            run[3] = rand(n, b, d) * vis[..., None]
            run[5] = rand(r, d)
            run[15] = None if tt is None else rand(tt.shape[0], b, d,
                                                   scale=0.1)
            run[16:20] = [rand(r, a, scale=0.3), rand(b, a, scale=0.3),
                          rand(d, a, scale=0.3), rand(a, 1, scale=0.3)]
            run[20] = rand(3, d, d, scale=0.3) if wdir is not None else None
            run[21] = None if wdir is not None else rand(3, d)
            run[22] = None  # no dropout mask
            fwd = dh.dense_hop_temporal(
                run[3], run[4], run[5], run[6], run[7], run[8], run[9],
                run[10], run[12], run[13], run[14], run[15], run[16],
                run[17], run[18], run[19], run[20], run[21], None, 0.0,
                run[24], "sorted_scatter", run[11])
            run[0] = rand(n, b, d)
            run[1], run[2] = fwd[0], fwd[1]
        wrapper = getattr(dh, f"dense_hop_{kind}_bwd")
        got, again = wrapper(*run), wrapper(*run)
        torch.cuda.synchronize()
        assert all(x is None and y is None or torch.equal(x, y)
                   for x, y in zip(got, again)), d
        share = bwd_float64_check(kind, run, got, f"{tag} width {d}")[0]
        del got, again
        out[d] = kernel_only_ms(kind, run, flushed=False)[0]
        log(f"{tag} 7j {kind} backward at width {d} (A={a}) on the call's "
            f"table: at most {share:.3g} of the float64 bound, same bits "
            f"twice; kernel {out[d]:.4f} ms with L2 warm ({card})")
        del run
    return out


def dense_bwd_check(step, graph, tag: str, card):
    """Phase 7j at a cell: the backward kernel at every dense hop of one
    train step (``step``: forward and backward), `dense_bwd_call_check`,
    and at widths 48 and 64 on the last call's table. Returns the rows."""
    calls = dense_bwd_calls(step)
    assert calls, "no dense hop's backward ran"
    with torch.no_grad():  # the recorded parameters require gradients
        rows = [dense_bwd_call_check(kind, hop, args, graph,
                                     f"{tag} train", card)
                for kind, hop, args in calls]
        kind, _, args = calls[-1]
        rows[-1]["widths_ms"] = dense_bwd_widths(kind, args, tag, card)
    del calls
    return rows


def static_step_fn(trainer):
    """One training step's forward and backward at the trainer's exact
    train caps on its first batch, as a function of no arguments."""
    from redgnn_tpu_torch.train.loop import softmax_ce_loss

    caps = exact_train_caps(trainer)

    def step():
        subs, rels, objs, qmask = step_tensors(trainer, 0)
        scores, _ = trainer.model(trainer.kg.graph, subs, rels, qmask, caps)
        softmax_ce_loss(scores, objs, qmask).backward()
        trainer.model.zero_grad(set_to_none=True)

    return step


BWD_ALONE_STEPS = 8  # train steps an epoch in --phase 7j


def phase_bwd_alone(mod, card):
    """Phase 7j alone (``--phase 7j``): through ``mod``'s own functions,
    7a's dir and trainer as phase 7 builds them (two epochs of
    BWD_ALONE_STEPS steps, the second timed, and its peak memory), then
    the umls entry at its defaults (the same numbers); where ``mod`` has
    phase 7j, the backward kernels at one train step's dense hops of
    each. ``mod`` is this script or, with ``--tree DIR``, DIR's
    chip_smoke.py running DIR's package: the parent tree's steps on the
    same card. Returns the numbers by cell."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer
    from redgnn_tpu_torch.utils.config import dataset_config

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        mod.write_icews14_sized(tmp, False)
        cfg = dataset_config("temporal", "ICEWS14_TeMP",
                             max_train_batches=BWD_ALONE_STEPS,
                             max_eval_batches=1)
        trainer = TemporalTrainer(load_temporal_kg(tmp, cfg, "cuda"), cfg)
        with torch.no_grad():  # as phase 7a scales it
            trainer.model.classifier_w.abs_().mul_(1e-6)
        step_ms, peak = mod.temporal_train_check(trainer, "[7a] 7j", card)
        out["ICEWS14_TeMP"] = {"step_ms": step_ms, "train_peak": peak}
        if hasattr(mod, "dense_bwd_check"):
            rows = mod.dense_bwd_check(mod.temporal_step_fn(trainer),
                                       trainer.kg.graph, "[7a]", card)
            out["ICEWS14_TeMP"]["bwd"] = bwd_rows_summary(rows)
        del trainer
    with tempfile.TemporaryDirectory() as tmp:
        mod.write_umls_sized_kg(tmp)
        kg, cfg, _, _ = mod.build_slice(tmp, "cuda", "umls",
                                        scan_chunk=BWD_ALONE_STEPS)
        trainer = mod.make_trainer(tmp, "cuda", cfg, steps=BWD_ALONE_STEPS)
        step_ms, peak = mod.train_steps_check(trainer, BWD_ALONE_STEPS,
                                              "[umls] 7j", card)
        out["umls"] = {"step_ms": step_ms, "train_peak": peak}
        if hasattr(mod, "dense_bwd_check"):
            rows = mod.dense_bwd_check(mod.static_step_fn(trainer),
                                       trainer.kg.graph, "[umls]", card)
            out["umls"]["bwd"] = bwd_rows_summary(rows)
    return out


def bwd_rows_summary(rows) -> dict:
    keys = ("ms", "ms_l2_flushed", "with_sums_ms", "plain_ms",
            "old_route_ms", "bound_ms", "bound_share", "kept")
    out = {k: [r[k] for r in rows] for k in keys}
    out["widths_ms"] = rows[-1]["widths_ms"]
    return out


def phase_temporal(data_dir: str, name: str, tag: str, card):
    """Phase 7a / 7c: the registry entry ``name`` on an ICEWS14-sized dir
    (loaded as the CLI loads it) at its defaults, then (7b, and within 7c)
    the kernel path."""
    import dataclasses

    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.models.temporal import TRedGNN, temporal_hop_plan
    from redgnn_tpu_torch.ops.dense_hop import dense_hop_temporal_bwd
    from redgnn_tpu_torch.ops.frontier import slot_owner
    from redgnn_tpu_torch.ops.gather import (
        list_sum,
        range_sum,
        scatter_rows_add,
    )
    from redgnn_tpu_torch.serve import Predictor
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer
    from redgnn_tpu_torch.utils.config import dataset_config

    cfg = dataset_config("temporal", name, max_train_batches=T_TRAIN_STEPS,
                         max_eval_batches=T_EVAL_BATCHES[name])
    t0 = time.perf_counter()
    kg = load_temporal_kg(data_dir, cfg, "cuda")
    kg_cpu = load_temporal_kg(data_dir, cfg, "cpu")
    trainer = TemporalTrainer(kg, cfg)
    if cfg.mode == "interpolation":
        # random weights drive the hidden states to ~1e7 over 4 hops and
        # the seeded classifier scores every reached entity below the
        # unreached ones' 0, so no top-10 rank was untied: a nonnegative
        # classifier, scaled down, ranks reached entities by their states
        # with scores in the tens
        with torch.no_grad():
            trainer.model.classifier_w.abs_().mul_(1e-6)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = Predictor.from_trainer(trainer, split="test", top_k=10)
    walk_s = time.perf_counter() - t0
    kinds = temporal_hop_plan(trainer.model_cfg, kg.graph.n_edges, pred.caps,
                              pred.batch, True)
    n_test = len(kg.splits["test"])
    log(f"{tag} {name}: {kg.n_ent} entities, {kg.n_rel} relation rows, "
        f"{kg.n_time} times, {len(kg.splits['train'])} / "
        f"{len(kg.splits['valid'])} / {n_test} train / valid / test "
        f"queries (with inverses), {kg.graph.n_edges} edges; hidden "
        f"{cfg.hidden_dim}, attn {cfg.attn_dim}, L={cfg.n_layer}, "
        f"{cfg.act}, batch {cfg.batch_size} / {cfg.eval_batch_size}, "
        f"window {cfg.window}, dedup {trainer.model_cfg.dedup_impl}, "
        f"segment_impl {cfg.segment_impl}; loaded in {load_s:.2f} s; exact "
        f"caps of the whole test split ({n_test} queries) walked in "
        f"{walk_s:.2f} s: node {pred.caps.node_caps} edge "
        f"{pred.caps.edge_caps}; hop plan at batch {pred.batch}: {kinds}")
    if cfg.mode == "interpolation":
        assert "dense" in kinds and kinds[0] == "bitmap", kinds
    else:
        assert kinds == ["bitmap"] * cfg.n_layer, kinds
    walks = temporal_walks_check(kg, cfg, tag, card)
    # the caps are exact for the split's batches in its own order (the JAX
    # Predictor's profile), so the split is served in that order
    queries = kg.splits["test"][:N_BATCHES * pred.batch]
    timed_batches(pred, queries, 1)  # warm-up
    # the main path of the owner fill's kernel and of the temporal dense
    # hop's: the served batches, counted
    slot_owner.launches = list_sum.launches = 0
    reset_dense_hop_launches()
    times, peak = timed_batches(pred, queries, N_BATCHES)
    n_dense = kinds.count("dense")
    n_sparse = len(kinds) - n_dense
    served = {"slot_owner": slot_owner.launches,
              "list_sum": list_sum.launches,
              "dense_hop": dense_hop_launches()}
    assert served == {"slot_owner": n_sparse * N_BATCHES, "list_sum": 0,
                      "dense_hop": n_dense * N_BATCHES}, served
    log(f"{tag} served {N_BATCHES} batches of {pred.batch} at registry "
        f"defaults (Predictor.from_trainer): per-batch ms "
        f"{[round(t, 3) for t in times]}; mean {np.mean(times):.3f} ms; "
        f"max_memory_allocated {peak} B; slot_owner launches "
        f"{served['slot_owner']} (= {n_sparse} sparse hops x {N_BATCHES}), "
        f"dense_hop_temporal {served['dense_hop']} (= {n_dense} dense hops "
        f"x {N_BATCHES}) ({card})")
    dense_rows = (dense_hop_check(pred, queries[:pred.batch], tag, card)
                  if n_dense else [])
    profile_batches(pred, queries[:2 * pred.batch], card)
    soft_check(tag, temporal_batch_card_vs_cpu, trainer.model, kg, kg_cpu,
               pred.caps, queries[:pred.batch], tag)
    # at the defaults (scan_src_backward=True) every bitmap hop past the
    # first differentiates hidden[src] as a range sum of the gradient: on
    # the card the range-sum kernel (each range's own terms, in a fixed
    # order), on the CPU the JAX package's difference of a float32 prefix
    # sum over the hop's edges (noise of O(u * sum|g|) over ~10^6 rows).
    # So the forecasting cell, whose bitmap hops carry gradient, holds the
    # card's default step to the CPU's strict backward; the interpolation
    # cell's one bitmap hop starts from zero states, and its default step
    # is held to the CPU's default step. The strict backward is held on
    # both
    forecasting = cfg.mode == "extrapolation"
    soft_check(tag, temporal_step_card_vs_cpu, trainer.model, kg, kg_cpu,
               cfg, f"{tag} scan_src_backward=True" + (
                   " against the CPU's strict step:" if forecasting
                   else ":"), TEMPORAL_GRAD_RTOL, TEMPORAL_GRAD_ATOL_REL,
               True, forecasting)
    strict = TRedGNN(dataclasses.replace(trainer.model_cfg,
                                         scan_src_backward=False),
                     device="cuda")
    strict.load_state_dict(trainer.model.state_dict())
    soft_check(tag, temporal_step_card_vs_cpu, strict, kg, kg_cpu, cfg,
               f"{tag} scan_src_backward=False:", TEMPORAL_GRAD_RTOL,
               TEMPORAL_GRAD_ATOL_REL)
    del strict
    kernel = temporal_kernel_path(trainer, pred, queries, kg_cpu,
                                  "[7b]" if tag == "[7a]" else tag, card)
    # the main path of the gather backwards' kernels, of the dense hop's
    # list sums and of its backward kernel: the trainer's two epochs,
    # counted
    range_sum.launches = scatter_rows_add.launches = 0
    slot_owner.launches = list_sum.launches = 0
    dense_hop_temporal_bwd.launches = 0
    step_ms, train_peak = temporal_train_check(trainer, tag, card)
    main = {"range_sum": range_sum.launches,
            "take_rows_grad": scatter_rows_add.launches,
            "slot_owner": slot_owner.launches,
            "list_sum": list_sum.launches,
            "dense_hop_temporal_bwd": dense_hop_temporal_bwd.launches}
    steps = 2 * cfg.max_train_batches
    tkinds = temporal_hop_plan(trainer.model_cfg, kg.graph.n_edges,
                               trainer.caps["train"], cfg.batch_size, True)
    log(f"{tag} kernel launches over the {steps} train steps at the "
        f"defaults (hops {tkinds}): {main}")
    assert main["take_rows_grad"] > 0, main
    assert main["range_sum"] > 0 or not forecasting, main
    # a dense hop's backward: its kernel, then the state's gradient summed
    # by source and (with a time term) the time term's by time id
    t_dense = tkinds.count("dense")
    assert main["dense_hop_temporal_bwd"] == t_dense * steps, main
    assert main["list_sum"] == t_dense * steps * (
        1 + trainer.model_cfg.use_time), main
    assert main["slot_owner"] == (len(tkinds) - tkinds.count("dense")) \
        * steps, main
    assert main["list_sum"] > 0 or forecasting, main
    temporal_profile_steps(trainer, card)
    eval_qps, eval_launches, eval_peak = temporal_eval_check(trainer, tag,
                                                             card)
    kernel["gather"] = gather_kernels_check(trainer, pred, queries, main,
                                            steps, tag, card)
    kernel["hop_index"] = hop_index_check(trainer, pred, queries, main,
                                          steps, tag, card)
    kernel["hop_index"]["slot_owner"]["served"] = served["slot_owner"]
    kernel["dense_hop"] = {"serve": dense_rows,
                           "launches": served["dense_hop"],
                           "eval_launches": eval_launches}
    if t_dense:
        kernel["dense_bwd"] = {
            "train": dense_bwd_check(temporal_step_fn(trainer), kg.graph,
                                     f"{tag} 7j", card),
            "launches": main["dense_hop_temporal_bwd"]}
        trainer.model.zero_grad(set_to_none=True)
    kernel.update(serve_ms=float(np.mean(times)), step_ms=step_ms,
                  walk_s=walk_s, walks=walks, serve_peak=peak,
                  train_peak=train_peak, eval_qps=eval_qps,
                  eval_peak=eval_peak)
    return kernel


def temporal_walks_check(kg, cfg, tag: str, card):
    """10c, inside phase 7: the exact per-query counts of the whole test
    split through both host walkers, the scipy bitmap walk and the native
    walker (windowed in forecasting), timed on this host in turns
    (bitmap, native, native, bitmap): equal counts. Returns the least
    seconds of each walker."""
    from redgnn_tpu_torch.graph import calibrate as cal
    from redgnn_tpu_torch.train import temporal_loop

    data = kg.splits["test"]
    if cfg.mode == "extrapolation" and cfg.window is not None:
        args = (kg.ekey_np, kg.graph_np[2], kg.n_ent, kg.time_key_base,
                data[:, 0], data[:, 3], cfg.window, cfg.n_layer)
        walkers = {"bitmap": cal.per_query_counts_windowed,
                   "native": cal.per_query_counts_windowed_native}
    else:
        args = (kg.graph_np[0], kg.graph_np[2], kg.n_ent, data[:, 0],
                cfg.n_layer)
        walkers = {"bitmap": cal.per_query_counts_dense,
                   "native": cal.per_query_counts}
    out, runs = {}, {"bitmap": [], "native": []}
    for name in ("bitmap", "native", "native", "bitmap"):
        t0 = time.perf_counter()
        out[name] = walkers[name](*args)
        runs[name].append(time.perf_counter() - t0)
    for a, b in zip(out["bitmap"], out["native"]):
        assert np.array_equal(a, b), "the two walkers' counts differ"
    route = temporal_loop.query_counts(kg, cfg, data[:64])
    assert all(np.array_equal(a, b[:64])
               for a, b in zip(route, out["bitmap"]))
    log(f"{tag} 10c: exact per-query counts of the {len(data)} test "
        f"queries ({len(np.unique(data[:, 0]))} heads, "
        f"{len(np.unique(data[:, 3]))} times): bitmap walk "
        f"{runs['bitmap'][0]:.3f} / {runs['bitmap'][1]:.3f} s, native "
        f"walker {runs['native'][0]:.3f} / {runs['native'][1]:.3f} s (host "
        f"clock, in turns: bitmap, native, native, bitmap), counts equal "
        f"and equal to the trainer's route (query_counts: the bitmap walk) "
        f"({card})")
    return {name: min(t) for name, t in runs.items()}



# ------------------------------------------- phase 8: xERTE and SimplE

X_CAP_FACTOR = 4.0        # the banked round-5 run's (its .host.json)
X_BATCH = 128             # XErteTrainer's batch (the reference's)
X_SERVED = 8              # timed forward batches of test quadruples
X_STEPS = 16              # train steps per timed epoch, eval batches
X_TIE_RTOL = 1e-5         # k-th and (k+1)-th target scores this close: a tie
X_MASS_ATOL = 1e-5
SIMPLE_HIDDEN, SIMPLE_BATCH = 64, 256


def xerte_twin(model, cfg, device):
    from redgnn_tpu_torch.models.xerte import XErte

    twin = XErte(cfg, device=device)
    twin.load_state_dict(model.state_dict())
    return twin


def xerte_forward(model, arrs, tkb: int, quads: np.ndarray, seed: int,
                  draws=None):
    rowptr, rel, tail, ekey = arrs
    subs, rels, _, times, qmask = quad_tensors(quads, rowptr.device)
    return model(rowptr, rel, tail, ekey, tkb, subs, rels, times, qmask,
                 seed, draws)


def kept_sets_agree(aux_g, aux_c, cfg, b: int):
    """Per query and DP step, the multiset of kept target keys, card vs
    CPU. A query whose sets differ must have a tie at the cut on the CPU
    (its k-th and (k+1)-th target scores within X_TIE_RTOL); it is left
    out of the later comparisons. Returns (agreeing queries (b,) bool,
    ties, kept edges compared)."""
    from redgnn_tpu_torch.models.xerte import INVALID

    k, nkb = cfg.max_attended_edges, cfg.node_key_base
    agree = np.ones(b, bool)
    ties = compared = 0
    for step, (sg, sc) in enumerate(zip(aux_g["steps"], aux_c["steps"])):
        kg_, keep_g = sg["edge_keys"].cpu().numpy(), sg["keep"].cpu().numpy()
        kc, keep_c = sc["edge_keys"].numpy(), sc["keep"].numpy()
        score_c = sc["target_score"].detach().numpy()
        eg_g = np.where(kg_ != INVALID, kg_ // nkb, b)
        eg_c = np.where(kc != INVALID, kc // nkb, b)
        for q in np.nonzero(agree)[0]:
            a = np.sort(kg_[keep_g & (eg_g == q)])
            c = np.sort(kc[keep_c & (eg_c == q)])
            if np.array_equal(a, c):
                compared += len(c)
                continue
            top = np.sort(score_c[(kc != INVALID) & (eg_c == q)])[::-1]
            assert len(top) > k and abs(top[k - 1] - top[k]) <= \
                X_TIE_RTOL * abs(top[k - 1]), (step, int(q), top[k - 1:k + 1])
            ties += 1
            agree[q] = False
    return agree, ties, compared


def xerte_batch_card_vs_cpu(trainer, arrs_cpu, quads, tag: str):
    """One served batch (eval seed 0, the card's draws on both devices),
    card vs CPU: kept sets equal but for ties at the cut, then on the
    agreeing queries the entity mass within X_MASS_ATOL, `visited` equal
    and the top-10 equal where untied. Printed, not held: how far each
    float32 mass lies from a float64 CPU run of the same weights."""
    from redgnn_tpu_torch.models.xerte import sample_draws

    cfg, b = trainer.cfg, len(quads)
    cpu = xerte_twin(trainer.model, cfg, "cpu")
    ref = xerte_twin(trainer.model, cfg, "cpu").double()
    draws = sample_draws(cfg, b, 0, "cuda")
    tkb = trainer.kg.time_key_base
    with torch.inference_mode():
        m_g, aux_g = xerte_forward(trainer.model, trainer._kgarrs, tkb, quads,
                                   0, draws)
        m_c, aux_c = xerte_forward(cpu, arrs_cpu, tkb, quads, 0,
                                   [d.cpu() for d in draws])
        default = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            m_d, _ = xerte_forward(ref, arrs_cpu, tkb, quads, 0,
                                   [d.cpu() for d in draws])
        finally:
            torch.set_default_dtype(default)
    assert torch.equal(aux_g["node_overflow"].cpu(), aux_c["node_overflow"])
    agree, ties, compared = kept_sets_agree(aux_g, aux_c, cfg, b)
    m_g = m_g.cpu()
    assert bool(torch.isfinite(m_g).all())
    rows = torch.as_tensor(np.nonzero(agree)[0])
    diff = float((m_g[rows] - m_c[rows]).abs().max())
    assert diff <= X_MASS_ATOL, diff
    off64 = [float((m[rows].double() - m_d[rows]).abs().max())
             for m in (m_g, m_c)]
    assert torch.equal(aux_g["visited"].cpu()[rows], aux_c["visited"][rows])
    tg, tc = torch.topk(m_g[rows], 11), torch.topk(m_c[rows], 11)
    n_cmp = topk_untied_agree(tg.values.numpy(), tg.indices.numpy(),
                              tc.values.numpy(), tc.indices.numpy(),
                              X_MASS_ATOL)
    log(f"{tag} card vs CPU, one batch of {b} (the same draws): kept "
        f"target keys equal for {int(agree.sum())} of {b} queries "
        f"({compared} kept edges over {cfg.dp_steps} steps), {ties} "
        f"queries with a tie at the top-{cfg.max_attended_edges} cut "
        f"(rtol {X_TIE_RTOL}); on those queries entity mass max |diff| "
        f"{diff:.3g} (atol {X_MASS_ATOL}; off a float64 CPU run: card "
        f"{off64[0]:.3g}, CPU {off64[1]:.3g}), visited equal, top-10 equal "
        f"at {n_cmp} untied ranks; overflow flags "
        f"{aux_c['node_overflow'].tolist()}")


def xerte_step_card_vs_cpu(trainer, arrs_cpu, tag: str):
    """One training step's loss and gradients at sampling='first', card
    vs CPU, with the trainer's weights: loss rtol 1e-5, every parameter's
    gradient within TEMPORAL_GRAD_RTOL + TEMPORAL_GRAD_ATOL_REL *
    max|grad| (sums of ~10^5 messages in another order)."""
    import dataclasses

    from redgnn_tpu_torch.models.xerte import bce_loss

    cfg = dataclasses.replace(trainer.cfg, sampling="first")
    quads, _ = train_sample(trainer.kg, X_BATCH)
    tkb = trainer.kg.time_key_base
    out = {}
    for name, model, arrs in (
            ("cuda", xerte_twin(trainer.model, cfg, "cuda"), trainer._kgarrs),
            ("cpu", xerte_twin(trainer.model, cfg, "cpu"), arrs_cpu)):
        mass, aux = xerte_forward(model, arrs, tkb, quads, 1)
        batch = quad_tensors(quads, arrs[0].device)
        loss = bce_loss(mass, batch[2], batch[4])
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[name] = (float(loss.detach()), aux, [
            torch.zeros(p.shape) if g is None else g.cpu()
            for g, p in zip(grads, params)])
    (l_g, aux_g, g_g), (l_c, aux_c, g_c) = out["cuda"], out["cpu"]
    agree, ties, compared = kept_sets_agree(aux_g, aux_c, cfg, X_BATCH)
    assert ties == 0, f"{ties} queries tie at the cut: gradients not held"
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c), (l_g, l_c)
    worst = 0.0
    for (name, _), a, b in zip(trainer.model.named_parameters(), g_g, g_c):
        scale = float(b.abs().max())
        err = float(((a - b).abs() - TEMPORAL_GRAD_RTOL * b.abs()).max())
        assert err <= TEMPORAL_GRAD_ATOL_REL * scale, (name, err, scale)
        if scale > 0:
            worst = max(worst, float((a - b).abs().max()) / scale)
    log(f"{tag} one train step, card vs CPU (sampling 'first', batch "
        f"{X_BATCH}): loss {l_g:.7f} vs {l_c:.7f} (rtol 1e-5); kept target "
        f"keys equal ({compared} edges); {len(g_c)} parameter gradients "
        f"within rtol {TEMPORAL_GRAD_RTOL} + {TEMPORAL_GRAD_ATOL_REL} * "
        f"max|grad|, worst max|diff| / max|grad| {worst:.3g}")


def phase_xerte(data_dir: str, card):
    """8a / 8b: xERTE at the reference's full width (emb 256-128-64-32, 3
    DP steps, K 15, 40 attended edges, batch 128) from XErteTrainer's
    seeded init on the ICEWS14_forecasting-sized dir. The entity mass is
    L1-normalised per query, so the scores are bounded with any weights."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.models.xerte import XErteConfig
    from redgnn_tpu_torch.train.temporal_loop import stage_quads
    from redgnn_tpu_torch.train.xerte_loop import XErteTrainer
    from redgnn_tpu_torch.utils.config import dataset_config

    cfg = dataset_config("temporal", "ICEWS14_forecasting")
    kg = load_temporal_kg(data_dir, cfg, "cuda")
    kg_cpu = load_temporal_kg(data_dir, cfg, "cpu")
    arrs_cpu = (kg_cpu.graph.rowptr, kg_cpu.graph.rel, kg_cpu.graph.tail,
                kg_cpu.ekey)
    t0 = time.perf_counter()
    trainer = XErteTrainer(
        kg, XErteConfig(n_ent=kg.n_ent, n_rel=kg.idd_rel,
                        n_time=kg.n_time + 2, cap_factor=X_CAP_FACTOR),
        batch_size=X_BATCH, max_train_batches=X_STEPS,
        max_eval_batches=X_STEPS, seed=SEED, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"[8a] XErteTrainer(seed={SEED}, device='cuda') built in "
        f"{init_s:.2f} s: {n_params} parameters, emb {trainer.cfg.emb_dim}, "
        f"{trainer.cfg.dp_steps} DP steps, K {trainer.cfg.dp_num_edges}, "
        f"{trainer.cfg.max_attended_edges} attended edges, sampling "
        f"{trainer.cfg.sampling}, cap_factor {trainer.cfg.cap_factor}; "
        f"{kg.n_ent} entities, {kg.graph.n_edges} edges")

    # 8a: serving, eval seed 0
    test = kg.splits["test"][:(X_SERVED + 1) * X_BATCH]
    staged = stage_quads(test, X_BATCH, "cuda")

    def serve(i):
        subs, rels, _, times, qmask = staged[i]
        with torch.inference_mode():
            mass, aux = trainer._apply(subs, rels, times, qmask, 0)
        return mass, aux

    mass, aux = serve(0)  # warm; grows the caps as evaluate() would
    for _ in range(6):
        if not bool(aux["node_overflow"].any()):
            break
        trainer._grow_caps()
        mass, aux = serve(0)
    assert not bool(aux["node_overflow"].any())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1, X_SERVED + 1):
        t0 = time.perf_counter()
        mass, aux = serve(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        sums = mass.sum(1)
        assert bool(torch.isfinite(mass).all()) and bool(
            ((sums - 1).abs() < 1e-3).all()), sums
    peak = torch.cuda.max_memory_allocated()
    log(f"[8a] served {X_SERVED} batches of {X_BATCH} test quadruples "
        f"(forward, entity mass; eval seed 0; cap factor "
        f"{trainer.cfg.cap_factor}): per-batch ms "
        f"{[round(t, 3) for t in times]}; mean {np.mean(times):.3f} ms, "
        f"{X_BATCH / np.mean(times) * 1e3:.1f} queries/s; "
        f"max_memory_allocated {peak} B ({card})")
    profile_calls(lambda: [serve(i) for i in (1, 2)], 2, "batch", card)
    soft_check("[8a]", xerte_batch_card_vs_cpu, trainer, arrs_cpu,
               test[X_BATCH:2 * X_BATCH], "[8a]")

    # 8b: training
    soft_check("[8b]", xerte_step_card_vs_cpu, trainer, arrs_cpu, "[8b]")
    cap0, count0 = trainer.cfg.cap_factor, int(trainer.opt_state["count"])
    loss0 = trainer.train_epoch(0)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss1 = trainer.train_epoch(1)
    step_s = (time.perf_counter() - t0) / X_STEPS
    train_peak = torch.cuda.max_memory_allocated()
    replays = int(round(np.log2(trainer.cfg.cap_factor / cap0)))
    assert np.isfinite(loss0) and np.isfinite(loss1)
    assert int(trainer.opt_state["count"]) == count0 + 2 * X_STEPS
    log(f"[8b] 2 x {X_STEPS} steps through train_epoch (batch {X_BATCH}, "
        f"Adam 1e-3 behind a global-norm clip at 1.0): loss sums "
        f"{loss0:.4f}, {loss1:.4f}; the second epoch {step_s * 1e3:.3f} ms "
        f"per step, {replays} overflow replays (cap_factor "
        f"{trainer.cfg.cap_factor}); max_memory_allocated {train_peak} B "
        f"({card})")
    trainer.evaluate("valid")  # warm: stages the filters
    t0 = time.perf_counter()
    m = trainer.evaluate("valid")
    eval_s = time.perf_counter() - t0
    assert m["n"] == X_STEPS * X_BATCH, m["n"]
    for pre in ("raw_", "fil_", "fil_t_"):
        assert 0.0 <= m[pre + "mrr"] <= 1.0, m
    assert m["fil_mrr"] >= m["raw_mrr"] - 1e-9
    log(f"[8b] evaluate('valid'), first {X_STEPS} batches of {X_BATCH}: "
        f"fil-MRR {m['fil_mrr']:.4f} raw-MRR {m['raw_mrr']:.4f} "
        f"fil_t-MRR {m['fil_t_mrr']:.4f} found {m['found_rate']:.3f} "
        f"(printed, not held: synthetic data); {eval_s:.3f} s, "
        f"{m['n'] / eval_s:.1f} queries/s ({card})")

    quads, _ = train_sample(kg, 2 * X_BATCH, seed=SEED + 1)
    steps = stage_quads(quads, X_BATCH, "cuda")
    snap = (trainer._flat.clone(),
            {k: v.clone() for k, v in trainer.opt_state.items()})

    def two_steps():
        for i, (subs, rels, objs, times, qmask) in enumerate(steps):
            trainer._train_step(subs, rels, objs, times, qmask, i + 1)

    profile_calls(two_steps, 2, "step", card)
    trainer._flat.copy_(snap[0])
    for k, v in snap[1].items():
        trainer.opt_state[k].copy_(v)
    return {"serve_ms": float(np.mean(times)), "step_ms": step_s * 1e3,
            "serve_peak": peak, "train_peak": train_peak}


def simple_step_card_vs_cpu(trainer, kg_cpu, tag: str):
    """One SimplE step's loss and gradients, card vs CPU from the same
    weights: loss rtol 1e-5, gradients rtol 1e-4 + 1e-5 * max|grad|."""
    from redgnn_tpu_torch.train.simple_loop import SimplETrainer, simple_loss

    cpu = SimplETrainer(kg_cpu, hidden_dim=SIMPLE_HIDDEN,
                        batch_size=SIMPLE_BATCH, device="cpu")
    cpu.load_state(trainer.state())
    quads, _ = train_sample(trainer.kg, SIMPLE_BATCH)
    out = []
    for t in (trainer, cpu):
        subs, rels, objs, _, qmask = quad_tensors(quads, t.device)
        loss = simple_loss(t.model(subs, rels), objs, qmask)
        out.append((float(loss.detach()), [g.cpu() for g in torch.autograd.grad(
            loss, list(t.model.parameters()))]))
    (l_g, g_g), (l_c, g_c) = out
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c), (l_g, l_c)
    worst = 0.0
    for a, b in zip(g_g, g_c):
        scale = float(b.abs().max())
        assert float(((a - b).abs() - GRAD_RTOL * b.abs()).max()) <= \
            GRAD_ATOL_REL * scale
        worst = max(worst, float((a - b).abs().max()) / scale)
    log(f"{tag} one step, card vs CPU: loss {l_g:.6f} vs {l_c:.6f} (rtol "
        f"1e-5); 4 parameter gradients within rtol {GRAD_RTOL} + "
        f"{GRAD_ATOL_REL} * max|grad|, worst max|diff| / max|grad| "
        f"{worst:.3g}")


def phase_simple(data_dir: str, card):
    """8c: SimplETrainer (hidden 64, batch 256) on the same dir: one step
    against the CPU, whole training epochs and evaluate('valid')."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.train.simple_loop import SimplETrainer
    from redgnn_tpu_torch.utils.config import dataset_config

    cfg = dataset_config("temporal", "ICEWS14_forecasting")
    kg = load_temporal_kg(data_dir, cfg, "cuda")
    kg_cpu = load_temporal_kg(data_dir, cfg, "cpu")
    trainer = SimplETrainer(kg, hidden_dim=SIMPLE_HIDDEN,
                            batch_size=SIMPLE_BATCH, device="cuda")
    soft_check("[8c]", simple_step_card_vs_cpu, trainer, kg_cpu, "[8c]")
    n_steps = -(-len(kg.splits["train"]) // SIMPLE_BATCH)
    loss0 = trainer.train_epoch(0)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss1 = trainer.train_epoch(1)
    step_s = (time.perf_counter() - t0) / n_steps
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(loss0) and loss1 < loss0, (loss0, loss1)
    trainer.evaluate("valid")  # warm
    t0 = time.perf_counter()
    m = trainer.evaluate("valid")
    eval_s = time.perf_counter() - t0
    assert m["n"] == len(kg.splits["valid"])
    assert 0.0 <= m["mrr"] <= 1.0 and m["h1"] <= m["h3"] <= m["h10"], m
    log(f"[8c] SimplE (hidden {SIMPLE_HIDDEN}, batch {SIMPLE_BATCH}): 2 "
        f"epochs of {n_steps} steps through train_epoch, loss sums "
        f"{loss0:.2f}, {loss1:.2f}; the second {step_s * 1e3:.3f} ms per "
        f"step; max_memory_allocated {peak} B; evaluate('valid') "
        f"({int(m['n'])} queries) MRR {m['mrr']:.4f} in {eval_s:.3f} s, "
        f"{m['n'] / eval_s:.1f} queries/s ({card})")
    quads, _ = train_sample(kg, SIMPLE_BATCH, seed=SEED + 1)
    subs, rels, objs, _, qmask = quad_tensors(quads, "cuda")
    snap = (trainer._flat.clone(),
            {k: v.clone() for k, v in trainer.opt_state.items()})
    profile_calls(lambda: [trainer._train_step(subs, rels, objs, qmask)
                           for _ in range(4)], 4, "step", card)
    trainer._flat.copy_(snap[0])
    for k, v in snap[1].items():
        trainer.opt_state[k].copy_(v)
    return {"step_ms": step_s * 1e3, "peak": peak}


# ------------------------------------------------- phase 9: multi-GPU

MESH_STEPS = 16  # steps of each timed epoch under a mesh
# two ranks on one card go through gloo (NCCL refuses a GPU twice): the
# times below measure the path's correctness, not multi-GPU speed
SHARED_CARD = "two ranks share one card through gloo: correctness, not " \
    "multi-GPU speed"


def mesh_config(dropout: float = 0.0):
    """The family entry at full width with the kernel on every hop."""
    from redgnn_tpu_torch.utils.config import dataset_config

    return dataset_config("static_transductive", "family", **KERNEL_SLICE,
                          scan_chunk=MESH_STEPS, dropout=dropout)


def mesh_trainer(data_dir: str, cfg, mesh=None, device: str = "cuda"):
    """A StaticTrainer of ``cfg`` (under ``mesh``) on the first MESH_STEPS
    batches of the synthetic KG's training queries, with the exact caps
    of its shards."""
    from redgnn_tpu_torch.graph.kg import StaticKG
    from redgnn_tpu_torch.train.loop import StaticTrainer

    kg = StaticKG.load(data_dir, device=mesh.device if mesh else device)
    kg.train_data = kg.train_data[:MESH_STEPS * cfg.n_batch]
    tr = StaticTrainer(kg, cfg, mesh=mesh)
    caps = tr._recalibrate_exact(tr.train_caps, kg.graph_np, kg.train_data,
                                 cfg.n_batch // tr.n_data)
    return tr, caps


def mesh_static_rank(mesh, data_dir: str, tag: str, card):
    """One rank of 9a / 9b: one step's loss and summed gradient, the
    kernel's launches in it and the kernel at this rank's real hop inputs
    against its plain version (the ranks take turns on the card), 2 x 16
    steps through train_epoch, a profile of 2 steps on rank 0, and
    evaluate('valid') under the mesh."""
    from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted_checked
    from redgnn_tpu_torch.train import loop as train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"{tag} rank {mesh.rank} {tuple(mesh.coords.values())}"
    tr, caps = mesh_trainer(data_dir, mesh_config(), mesh)
    batch = step_tensors(tr, 0)  # the global batch; the rank takes its shard
    out = []
    segment_sum_sorted_checked.launches = 0
    calls = record_segment_sums(
        lambda: out.append(tr._loss_and_grads(*batch, caps)))
    torch.cuda.synchronize()
    launches = segment_sum_sorted_checked.launches
    loss, g, overflow, _ = out[0]
    assert not bool(overflow)
    assert launches == tr.cfg.n_layer, launches
    rows = []
    for turn in range(mesh.size()):
        if turn == mesh.rank:
            rows = dense_kernel_check(calls, None, tag, card)
        mesh.barrier()
    steps = len(tr.kg.train_data) // tr.cfg.n_batch
    tr.train_epoch(0)  # warm-up: allocator, cuBLAS, the caps walk
    tr.timer.enabled = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flat0 = tr._flat.clone()
    loss2 = tr.train_epoch(1)
    seconds = tr.timer.buckets["train"]["device"]
    peak = torch.cuda.max_memory_allocated()
    assert int(tr.opt_state["count"]) == 2 * steps
    assert np.isfinite(loss2) and not torch.equal(tr._flat, flat0)
    log(f"{tag}: {steps} steps through train_epoch {seconds / steps * 1e3:.3f}"
        f" ms per step (loss sum {loss2:.2f}); max_memory_allocated {peak} B"
        f" ({SHARED_CARD}; {card})")
    batches = torch.stack([torch.stack([t.to(torch.int32) for t in
                                        step_tensors(tr, k)])
                           for k in range(2)])
    snap = tr._snapshot()
    if mesh.rank == 0:
        profile_calls(lambda: tr._run_chunk(batches, caps), 2, "step", card)
    else:  # the same two calls, unprofiled: every collective is matched
        for _ in range(2):
            tr._run_chunk(batches, caps)
        torch.cuda.synchronize()
    tr._rollback(snap)
    tr.evaluate("valid")  # calibrates the split's caps, warms up
    t0 = time.perf_counter()
    tr.evaluate("valid")
    eval_s = time.perf_counter() - t0
    m, inputs = recorded_eval(lambda: tr.evaluate("valid"), train_loop,
                              STATIC_EVAL)
    return {"loss": float(loss), "g": g.cpu(), "launches": launches,
            "rows": rows, "ms_per_step": seconds / steps * 1e3,
            "peak": peak, "metrics": m, "eval_inputs": inputs,
            "eval_s": eval_s,
            "params": {k: v.cpu().clone() for k, v in tr.params.items()}}


def grads_agree(names, slices, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol_rel: float) -> float:
    """Every parameter's gradient within ``rtol`` * |want| + ``atol_rel`` *
    max|want|; returns the worst max|diff| / max|want|."""
    worst = 0.0
    for name, sl in zip(names, slices):
        a, b = got[sl], want[sl]
        scale = float(b.abs().max())
        err = float(((a - b).abs() - rtol * b.abs()).max())
        assert err <= atol_rel * scale, (name, err, scale)
        if scale > 0:
            worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def metrics_agree(got: dict, want: dict, keys) -> None:
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k],
                                                               want[k])


# A meshed eval sums its scores in another order than the single process
# (other batch shapes, gloo's sum of the edge ranks), so a candidate whose
# score lies within float noise of the answer's may rank on either side of
# it: one such flip at rank ~40 moves a 512-query MRR by ~1.5e-5 of itself.
# So the evaluation is held query by query: the scores close (below),
# answers, filters and visited sets equal, and the metrics the ones those
# inputs rank to. The static scores are held to the single process's
# within EVAL_TOL of the row's largest |score|. The forecasting model's
# sums cancel (phase 7c), so its float32 scores lie up to ~2.3e-4 of that
# scale off float64 in a 512-query eval, single process and mesh alike:
# they are held, as 7c holds the card to the CPU, to a float64 run of the
# same weights, within EVAL_TOL or twice the single process's own largest
# error over the eval, whichever is larger.
EVAL_TOL = 1e-4
# What the recorded arguments of each function are held to: "~" within
# EVAL_TOL of the row's largest |value|, "f" against the float64 scores
# as above, "=" equal, "." measured only (the frontier softmax, a function
# of the held scores and visited sets).
STATIC_EVAL = {"rank_metric_sums": "~=="}
TEMPORAL_EVAL = {"nll_softmax_loss": "f==",
                 "frontier_rank_metric_sums": ".====="}


def recorded_eval(evaluate, module, roles: dict):
    """(metrics, inputs) of ``evaluate()``; ``inputs[name]`` lists, batch
    by batch, host copies of the arguments of the function ``module.name``
    for each name of ``roles``. Call it on caps that ``evaluate`` has
    already calibrated (an overflow would record a batch twice; the
    comparisons see that)."""
    origs = {name: getattr(module, name) for name in roles}
    seen = {name: [] for name in roles}

    def recorder(name):
        def record(*args):
            seen[name].append(tuple(a.detach().cpu() for a in args))
            return origs[name](*args)
        return record

    try:
        for name in roles:
            setattr(module, name, recorder(name))
        return evaluate(), seen
    finally:
        for name, fn in origs.items():
            setattr(module, name, fn)


def f64_error(s: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's max |s - ref| over the row's largest |ref| (at least 1)."""
    scale = torch.clamp(ref.abs().amax(1, keepdim=True), min=1.0)
    return ((s.double() - ref).abs() / scale).amax(1)


def eval_inputs_agree(got, want, roles: dict, d: int, n_data: int,
                      worst: dict, refs=None) -> None:
    """A rank's recorded inputs (data index ``d``) against the single
    process's rows of the same batches, each argument as ``roles`` says
    (``refs``: the float64 scores of each batch, for "f", whose bound is
    ``worst["f64 bound"]``). ``worst`` keeps the largest |diff| / row max
    seen: (name, i) against the single process, "f64" against float64."""

    def keep(key, value):
        worst[key] = max(worst.get(key, 0.0), value)

    for name, role in roles.items():
        assert len(got[name]) == len(want[name]), name
        for k, (g, w) in enumerate(zip(got[name], want[name])):
            b = w[0].shape[0] // n_data
            rows = slice(d * b, (d + 1) * b)
            for i, (a, c, r) in enumerate(zip(g, w, role)):
                c = c[rows]
                assert a.shape == c.shape, (name, i, a.shape, c.shape)
                if r == "=":
                    assert torch.equal(a, c), (name, i)
                    continue
                scale = c.abs().amax(1, keepdim=True)
                err = (a - c).abs()
                ratio = float((err / scale.clamp_min(1e-30)).max())
                keep((name, i), ratio)
                if r == "~":
                    assert bool((err <= EVAL_TOL * scale).all()), \
                        (name, i, ratio)
                elif r == "f":
                    rel = float(f64_error(a, refs[k][rows]).max())
                    assert rel <= worst["f64 bound"], (name, i, rel, worst)
                    keep("f64", rel)


def metrics_from_inputs(inputs, fn, names, combine) -> dict:
    """The metrics that recorded ranking inputs (one list per data rank)
    rank to, through the ranking function ``fn`` on the host."""
    partials = []
    for rank_inputs in inputs:
        for args in rank_inputs:
            part = fn(*args)
            partials.append({k: float(part.get(k, 0.0)) for k in names})
    return combine(partials)


def mesh_eval_agrees(single, outs, n_data: int, n_edge: int, roles, fn,
                     names, combine, keys, refs=None) -> dict:
    """The meshed evaluations (``outs``) against the single process's
    recorded one (``single``: (metrics, inputs)): each rank's inputs
    against the single's rows (eval_inputs_agree), and every edge column's
    metrics, and the single's, equal to what their inputs rank to through
    the ranking function ``fn`` (rtol 1e-5). Returns the worst ratios."""
    m1, want = single
    rank = fn.__name__
    metrics_agree(metrics_from_inputs([want[rank]], fn, names, combine), m1,
                  keys)
    worst = {}
    for name, role in roles.items():
        if "f" in role:
            i = role.index("f")
            worst["f64 single"] = max(float(f64_error(w[i], ref).max())
                                      for w, ref in zip(want[name], refs))
            worst["f64 bound"] = max(EVAL_TOL, 2.0 * worst["f64 single"])
    for r, o in enumerate(outs):
        eval_inputs_agree(o["eval_inputs"], want, roles, r // n_edge, n_data,
                          worst, refs)
    for e in range(n_edge):
        column = [outs[d * n_edge + e] for d in range(n_data)]
        ranked = metrics_from_inputs([o["eval_inputs"][rank] for o in column],
                                     fn, names, combine)
        for o in column:
            metrics_agree(o["metrics"], ranked, keys)
    return worst


def phase_mesh_static(data_dir: str, n_data: int, n_edge: int, tag: str,
                      card):
    """9a (1x2, edge-parallel) / 9b (2x1, data-parallel): two ranks on
    cuda:0 over gloo, held against the single-process trainer on the card
    with the same weights: one step's loss (rtol 1e-5) and gradients
    (phase 5's tolerances), evaluate('valid') query by query
    (mesh_eval_agrees). Returns the kernel's rows and launches per rank
    per step."""
    from redgnn_tpu_torch.ops.ranking import rank_metric_sums
    from redgnn_tpu_torch.parallel.launch import run_mesh
    from redgnn_tpu_torch.train import loop as train_loop
    from redgnn_tpu_torch.train.loop import METRIC_SUMS
    from redgnn_tpu_torch.utils.metrics import combine_metric_sums

    single, _ = mesh_trainer(data_dir, mesh_config())
    caps1 = single._recalibrate_exact(
        single.train_caps, single.kg.graph_np, single.kg.train_data,
        single.cfg.n_batch)
    loss1, g1, _, _ = single._loss_and_grads(*step_tensors(single, 0), caps1)
    t0 = time.perf_counter()
    outs = run_mesh(mesh_static_rank, n_data, n_edge, ["cuda:0"] * 2,
                    backend="gloo", args=(data_dir, tag, card), timeout=600,
                    collective_timeout=180)
    wall = time.perf_counter() - t0
    names = list(single.params)
    for r, o in enumerate(outs):
        assert abs(o["loss"] - float(loss1)) <= 1e-5 * abs(float(loss1)), \
            (o["loss"], float(loss1))
        worst = grads_agree(names, single._slices, o["g"], g1.cpu(),
                            GRAD_RTOL, GRAD_ATOL_REL)
        log(f"{tag} rank {r}: one step vs the single-process step on the "
            f"card, same weights: loss {o['loss']:.6f} vs {float(loss1):.6f}"
            f" (rtol 1e-5); {len(names)} parameter gradients within rtol "
            f"{GRAD_RTOL} + {GRAD_ATOL_REL} * max|grad|, worst max|diff| / "
            f"max|grad| {worst:.3g}; {o['launches']} kernel launches in the "
            f"step ({n_edge}-way edge slices of {single.cfg.n_layer} hops)")
    for k in names:  # the replicated parameters stay bit-equal
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k
    single.load_state({"params": outs[0]["params"],
                       "opt_state": single.state()["opt_state"]})
    single.evaluate("valid")  # calibrates the split's caps
    m1, want = recorded_eval(lambda: single.evaluate("valid"), train_loop,
                             STATIC_EVAL)
    worst = mesh_eval_agrees((m1, want), outs, n_data, n_edge, STATIC_EVAL,
                             rank_metric_sums, METRIC_SUMS,
                             combine_metric_sums,
                             ("mrr", "h1", "h3", "h10", "n"))
    for o in outs:
        metrics_agree(o["metrics"], m1, ("n",))
    nq = len(single.kg.eval_spec("valid").queries)
    log(f"{tag} mesh {n_data}x{n_edge}: evaluate('valid') after 2 x "
        f"{MESH_STEPS} steps on the same weights as the single process: "
        f"{len(want['rank_metric_sums'])} batches, answers and filters "
        f"equal, scores within {EVAL_TOL} x the row's largest |score| "
        f"(worst {worst['rank_metric_sums', 0]:.3g}), "
        f"metrics those scores rank to (rtol 1e-5): MRR by rank "
        f"{[round(o['metrics']['mrr'], 6) for o in outs]}, the single "
        f"process's {m1['mrr']:.6f}; {outs[0]['eval_s']:.3f} s, "
        f"{nq / outs[0]['eval_s']:.1f} queries/s; ms per step by rank "
        f"{[round(o['ms_per_step'], 3) for o in outs]}; peak memory by rank "
        f"{[o['peak'] for o in outs]} B; the whole two-process run "
        f"{wall:.1f} s ({SHARED_CARD}; {card})")
    return {"mesh": f"{n_data}x{n_edge}",
            "launches_per_rank_step": [o["launches"] for o in outs],
            "rows": [r for o in outs for r in o["rows"]]}


def mesh_temporal_rank(mesh, data_dir: str, name: str, card):
    """One rank of 9b's temporal check: one step's loss and summed
    gradient, and evaluate('valid'), under a 2x1 mesh."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.train import temporal_loop
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = temporal_mesh_config(name)
    tr = TemporalTrainer(load_temporal_kg(data_dir, cfg, mesh.device), cfg,
                         mesh=mesh)
    loss, g, overflow = temporal_probe(tr)
    assert not bool(overflow)
    t0 = time.perf_counter()
    tr.evaluate("valid")
    eval_s = time.perf_counter() - t0
    m, inputs = recorded_eval(lambda: tr.evaluate("valid"), temporal_loop,
                              TEMPORAL_EVAL)
    return {"loss": float(loss), "g": g.cpu(), "metrics": m,
            "eval_inputs": inputs, "eval_s": eval_s,
            "cap0": tr.caps["train"].node_caps[0]}


def temporal_mesh_config(name: str):
    """The registry entry with the strict backward (a sharded step has
    it), the first T_EVAL_BATCHES batches of valid."""
    from redgnn_tpu_torch.utils.config import dataset_config

    return dataset_config("temporal", name, scan_src_backward=False,
                          max_eval_batches=T_EVAL_BATCHES[name])


def temporal_probe(tr):
    """(loss, flat gradient, overflow) of the first training batch."""
    b = tr.cfg.batch_size
    data = tr.kg.splits["train"][:b]
    caps = tr._get_caps("train", data, tr._cap_b(b))
    batch = quad_tensors(data, tr.device)
    excl = None
    if tr.cfg.mode == "interpolation":
        excl = torch.as_tensor(tr.kg.exclusion_slots(np.arange(b)).astype(
            np.int32), device=tr.device)
    return tr._loss_and_grads(*batch[:4], batch[4], excl, caps)


def phase_mesh_temporal(data_dir: str, name: str, card):
    """9b, temporal: TemporalTrainer at 2x1 (two ranks on cuda:0, gloo) on
    the forecasting-sized dir against the single-process trainer: one
    step's loss (rtol 1e-5) and gradients (phase 7's temporal
    tolerances), evaluate('valid') query by query (mesh_eval_agrees)."""
    from redgnn_tpu_torch.cli.train import load_temporal_kg
    from redgnn_tpu_torch.ops.ranking import frontier_rank_metric_sums
    from redgnn_tpu_torch.parallel.launch import run_mesh
    from redgnn_tpu_torch.train import temporal_loop
    from redgnn_tpu_torch.train.temporal_loop import EX_SUMS, TemporalTrainer

    cfg = temporal_mesh_config(name)
    single = TemporalTrainer(load_temporal_kg(data_dir, cfg, "cuda"), cfg)
    loss1, g1, _ = temporal_probe(single)
    single.evaluate("valid")  # calibrates the split's caps
    m1, want = recorded_eval(lambda: single.evaluate("valid"), temporal_loop,
                             TEMPORAL_EVAL)
    outs = run_mesh(mesh_temporal_rank, 2, 1, ["cuda:0"] * 2,
                    backend="gloo", args=(data_dir, name, card), timeout=600,
                    collective_timeout=180)
    b = cfg.eval_batch_size
    data = single.kg.splits["valid"][:cfg.max_eval_batches * b]
    assert len(data) % b == 0, len(data)
    refs = [reference_scores(single.model, single.kg, data[i:i + b],
                             single.caps["eval_valid"], device="cuda")
            for i in range(0, len(data), b)]
    worst_e = mesh_eval_agrees(
        (m1, want), outs, 2, 1, TEMPORAL_EVAL, frontier_rank_metric_sums,
        EX_SUMS, TemporalTrainer._combine,
        ("raw_mrr", "fil_mrr", "fil_t_mrr", "h1", "h10", "found_rate", "n"),
        refs)
    names = list(single.params)
    for r, o in enumerate(outs):
        assert o["cap0"] == cfg.batch_size // 2
        assert abs(o["loss"] - float(loss1)) <= 1e-5 * abs(float(loss1)), \
            (o["loss"], float(loss1))
        worst = grads_agree(names, single._slices, o["g"], g1.cpu(),
                            TEMPORAL_GRAD_RTOL, TEMPORAL_GRAD_ATOL_REL)
        metrics_agree(o["metrics"], m1, ("found_rate", "n"))
        log(f"[9b] {name} rank {r} of a 2x1 mesh: one step (batch "
            f"{cfg.batch_size}, {cfg.batch_size // 2} queries a rank) vs "
            f"the single process: loss {o['loss']:.6f} vs {float(loss1):.6f}"
            f" (rtol 1e-5), {len(names)} gradients within rtol "
            f"{TEMPORAL_GRAD_RTOL} + {TEMPORAL_GRAD_ATOL_REL} * max|grad| "
            f"(worst {worst:.3g}); evaluate('valid') of {int(m1['n'])} "
            f"queries in {len(want['nll_softmax_loss'])} batches: targets, "
            f"visited sets and filters equal; scores against a float64 run "
            f"on the card within {worst_e['f64']:.3g} of the row's largest "
            f"|score| (bound {EVAL_TOL} or twice the single process's "
            f"{worst_e['f64 single']:.3g}), "
            f"{worst_e['nll_softmax_loss', 0]:.3g} off the single "
            f"process's (the frontier softmax "
            f"{worst_e['frontier_rank_metric_sums', 0]:.3g} of the row's "
            f"largest, not held); metrics those rank to (rtol 1e-5): fil "
            f"MRR {o['metrics']['fil_mrr']:.6f} (raw "
            f"{o['metrics']['raw_mrr']:.6f}), the single process's "
            f"{m1['fil_mrr']:.6f} (raw {m1['raw_mrr']:.6f}); found and n "
            f"equal; {o['eval_s']:.3f} s ({SHARED_CARD}; {card})")


def phase_mesh_nccl(data_dir: str, card):
    """9c: a 1x1 mesh through NCCL. One NCCL all-reduce, then one train
    step of StaticTrainer(mesh=...) bit-equal to a mesh=None trainer with
    the same flags (plain gathers, strict backward): parameters, moments
    and loss."""
    import dataclasses

    import torch.distributed as dist

    from redgnn_tpu_torch.models.redgnn import RedGNN
    from redgnn_tpu_torch.parallel.mesh import destroy, make_mesh

    mesh = make_mesh(1, 1, devices=["cuda:0"], backend="nccl")
    try:
        x = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        assert dist.get_backend() == "nccl" and torch.equal(
            x, torch.arange(4, dtype=torch.float32, device="cuda"))
        cfg = mesh_config(dropout=0.29)
        meshed, caps = mesh_trainer(data_dir, cfg, mesh)
        plain, caps1 = mesh_trainer(data_dir, cfg)
        assert caps == caps1
        plain.model = RedGNN(
            dataclasses.replace(plain.model_cfg, mxu_gather_backward=False,
                                scan_src_backward=False), device="cuda",
            generator=torch.Generator().manual_seed(cfg.seed))
        plain._init_flat()
        plain.opt_state = plain.tx.init(plain._flat)
        assert torch.equal(plain._flat, meshed._flat)
        losses = [tr._train_step(*step_tensors(tr, 0), caps)[0]
                  for tr in (meshed, plain)]
        torch.cuda.synchronize()
        assert torch.equal(losses[0], losses[1]), losses
        assert torch.equal(meshed._flat, plain._flat)
        for k in ("mu", "nu", "count"):
            assert torch.equal(meshed.opt_state[k], plain.opt_state[k]), k
        log(f"[9c] NCCL at world size 1 ({dist.get_backend()}): an "
            f"all-reduce, then one step of StaticTrainer(mesh=1x1) with "
            f"dropout {cfg.dropout} bit-equal to mesh=None with the same "
            f"flags (plain gathers, strict backward): loss "
            f"{float(losses[0]):.6f}, {meshed._flat.numel()} parameters and "
            f"both Adam moments equal bit for bit ({card})")
    finally:
        destroy()


def phase_mesh_cli(card):
    """9d: the CLI on the card. One epoch of --mesh 1x1 with
    --results_dir, --sqlite and --eval_splits on a small synthetic KG
    writes its reports; --mesh 2x1 on a one-GPU host exits non-zero with
    its reason."""
    import sqlite3

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "kg")
        res = os.path.join(tmp, "res")
        os.makedirs(data)
        write_umls_sized_kg(data)
        base = [sys.executable, "-m", "redgnn_tpu_torch.cli.train", "--task",
                "transductive", "--data_path", data, "--epochs", "1",
                "--results_dir", res, "--set", "n_batch=100",
                "n_tbatch=100", "n_layer=3"]
        t0 = time.perf_counter()
        run = subprocess.run(
            base[:-4] + ["--mesh", "1x1", "--sqlite",
                         os.path.join(res, "x.db"), "--eval_splits",
                         "valid,test", "--ckpt_dir", os.path.join(tmp, "ck"),
                         "--set"] + base[-3:],
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        assert run.returncode == 0, run.stderr[-3000:]
        lines = run.stdout.strip().splitlines()
        assert lines[0].startswith("mesh: 1 data x 1 edge"), lines[0]
        assert any(ln.startswith("BEST ") for ln in lines)
        assert lines[-1].startswith("EVAL_SPLITS "), lines[-1]
        splits = json.loads(lines[-1][len("EVAL_SPLITS "):])
        assert set(splits) == {"valid", "test"}
        for kind in ("perf.txt", "metrics.jsonl", "mem.txt"):
            path = os.path.join(res, f"kg_{kind}")
            assert os.path.getsize(path) > 0, path
        mem = open(os.path.join(res, "kg_mem.txt")).read().strip()
        db = sqlite3.connect(os.path.join(res, "x.db"))
        n_runs = db.execute("SELECT COUNT(*) FROM runs").fetchone()[0]
        n_rows = db.execute("SELECT COUNT(*) FROM metrics").fetchone()[0]
        db.close()
        assert n_runs == 1 and n_rows >= 1, (n_runs, n_rows)
        log(f"[9d] CLI --mesh 1x1 (NCCL) --results_dir --sqlite "
            f"--eval_splits valid,test: one epoch in {seconds:.1f} s "
            f"(process included); perf, metrics JSONL and memory report "
            f"written, sqlite {n_runs} run / {n_rows} metric rows; valid MRR "
            f"{splits['valid']['mrr']:.4f}, test MRR "
            f"{splits['test']['mrr']:.4f} on the best checkpoint; {mem} "
            f"({card})")
        refused = subprocess.run(base[:-4] + ["--mesh", "2x1", "--set"]
                                 + base[-3:], capture_output=True, text=True,
                                 timeout=300)
        n_gpu = torch.cuda.device_count()
        if n_gpu < 2:
            assert refused.returncode != 0
            reason = refused.stderr.strip().splitlines()[-1]
            assert "needs 2 GPUs" in reason, reason
            log(f"[9d] --mesh 2x1 on a host with {n_gpu} GPU exits "
                f"{refused.returncode}: {reason}")


def phase_mesh(family_dir: str, card):
    """Phase 9a-9d; returns the kernel's rows of 9a / 9b."""
    out = []
    for n_data, n_edge, tag in ((1, 2, "[9a]"), (2, 1, "[9b]")):
        out.append(phase_mesh_static(family_dir, n_data, n_edge, tag, card))
    with tempfile.TemporaryDirectory() as tmp:
        write_icews14_sized(tmp, True)
        phase_mesh_temporal(tmp, "ICEWS14_forecasting", card)
    phase_mesh_nccl(family_dir, card)
    phase_mesh_cli(card)
    return out


# ------------------------------------------ phase 10: bfloat16, native

# bf16 against the CPU's bf16 path and against float32: the bounds that
# tests/test_torch_bf16.py states (scores within 1e-3 of the row's largest
# |score|; gradients within 2e-2 of each parameter's largest |grad|;
# against float32 atol and rtol 5e-2, the JAX package's own bf16 bound).
# A float32 difference of ~1e-7 in a hop's sums flips a bf16 rounding of
# the next hop's rows now and then; on the umls-sized KG's dense hops
# (index_add_, float atomics in a new order on every run) the card's bf16
# scores lay 3.95e-4 and 7.36e-4 of the row's largest off the CPU's in two
# runs. So a batch whose card-vs-CPU difference passes 1e-3 is held, as
# phase 7 holds its float32 scores to float64, by its error: the card's
# bf16 scores may lie off the same weights' float32 scores by at most
# twice as much as the CPU's bf16 scores do.
BF16_SCORE_TOL, BF16_GRAD_TOL, BF16_F32_TOL = 1e-3, 2e-2, 5e-2
BF16_STEPS = 16


def bf16_batch_check(model, pred, q, tag: str):
    """One bf16 batch on the card against the same model on the CPU (the
    plain path) and against the card's float32 model with the same
    weights: aux counts equal, scores within BF16_SCORE_TOL of the row's
    largest |score| (or, past it, off float32 by at most twice the CPU's
    bf16 scores' error) and within BF16_F32_TOL of float32."""
    from redgnn_tpu_torch.models.redgnn import RedGNN

    assert model.cfg.compute_dtype == "bfloat16"
    cpu = RedGNN(model.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    f32 = RedGNN(dataclasses.replace(model.cfg, compute_dtype="float32"),
                 device="cuda")
    f32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        s_gpu, aux = model(pred.graph, *batch_tensors(pred, q), pred.caps)
        s_f32, _ = f32(pred.graph, *batch_tensors(pred, q), pred.caps)
        s_cpu, aux_cpu = cpu(pred.graph.to("cpu"),
                             *(t.cpu() for t in batch_tensors(pred, q)),
                             pred.caps)
    for k in aux:
        assert torch.equal(aux[k].cpu(), aux_cpu[k]), k
    s_gpu, s_f32 = s_gpu.cpu(), s_f32.cpu()
    assert bool(torch.isfinite(s_gpu).all())
    scale = s_cpu.abs().amax(1, keepdim=True)
    assert float(scale.min()) > 0
    rel = float(((s_gpu - s_cpu).abs() / scale).max())
    err_gpu = float(((s_gpu - s_f32).abs() / scale).max())
    err_cpu = float(((s_cpu - s_f32).abs() / scale).max())
    assert rel <= BF16_SCORE_TOL or err_gpu <= 2 * err_cpu, \
        (rel, err_gpu, err_cpu)
    torch.testing.assert_close(s_gpu, s_f32, rtol=BF16_F32_TOL,
                               atol=BF16_F32_TOL)
    vs_f32 = float((s_gpu - s_f32).abs().max())
    assert vs_f32 > 0, "bf16 scores equal float32's: nothing was rounded"
    log(f"{tag} bf16 card vs CPU bf16, one batch: max |score diff| "
        f"{rel:.3g} of the row's largest |score| (bound "
        f"{BF16_SCORE_TOL}, or off float32 at most twice the CPU's: card "
        f"{err_gpu:.3g}, CPU {err_cpu:.3g} of the row's largest); aux "
        f"equal, num_edges {aux_cpu['num_edges'].tolist()}; vs the card's "
        f"float32 model max |diff| {vs_f32:.3g} (atol and rtol "
        f"{BF16_F32_TOL})")
    return rel


def bf16_walks_check(kg, n_layer: int, tag: str, card):
    """10c on a static KG: the native walker's per-query counts of the
    training queries and one batch's simulate_hops against the numpy edge
    walk (the plain reference), both timed on this host."""
    from redgnn_tpu_torch.graph import calibrate as cal

    rowptr, _, tail = kg.graph_np
    heads = kg.train_data[:, 0]
    secs, out = {}, []
    for name, fn in (("native", cal.per_query_counts),
                     ("numpy", cal.per_query_counts_numpy)):
        t0 = time.perf_counter()
        out.append(fn(rowptr, tail, kg.n_ent, heads, n_layer))
        secs[name] = time.perf_counter() - t0
    for a, b in zip(*out):
        assert np.array_equal(a, b), "native and numpy counts differ"
    nc, ec = cal._walk(rowptr, tail, kg.n_ent, heads[:50], n_layer)
    assert cal.simulate_hops(rowptr, tail, kg.n_ent, heads[:50],
                             n_layer) == (nc.sum(0).tolist(),
                                          ec.sum(0).tolist())
    log(f"{tag} 10c: per-query counts of {len(heads)} training queries "
        f"({len(np.unique(heads))} heads, L={n_layer}): native walker "
        f"{secs['native']:.4f} s, numpy edge walk {secs['numpy']:.4f} s "
        f"(host clock, one run each), equal; simulate_hops of one batch "
        f"of 50 equal ({card})")
    return secs


def bf16_kernel_calls(model, pred, q, trainer, caps, tag: str, card):
    """The kernel at the bf16 path's real segment sums, one served batch
    and one train step, against its plain version (`dense_kernel_check`:
    forward, backward bit for bit, times)."""
    from redgnn_tpu_torch.train.loop import softmax_ce_loss

    # no_grad, not inference_mode: the recorded ids go through autograd in
    # the backward check
    with torch.no_grad():
        calls = record_segment_sums(
            lambda: model(pred.graph, *batch_tensors(pred, q), pred.caps))
    rows = dense_kernel_check(calls, None, f"{tag} bf16 serving", card)

    def one_step():
        subs, rels, objs, qmask = step_tensors(trainer, 0)
        scores, _ = trainer.model(trainer.kg.graph, subs, rels, qmask, caps)
        softmax_ce_loss(scores, objs, qmask).backward()

    calls = record_segment_sums(one_step)
    trainer.model.zero_grad(set_to_none=True)
    return rows + dense_kernel_check(calls, None, f"{tag} bf16 training",
                                     card)


def bf16_serve_and_train(data_dir: str, dataset: str, tag: str, card,
                         **over):
    """Serving and training of the registry entry ``dataset`` with
    ``over`` in bf16 and in float32, timed in turns (float32, bf16) on the
    same weights and batches: ms per batch, ms per step, peak memory,
    kernel launches (each counter set to 0 just before the served
    batches and the steps). Returns the runs by dtype."""
    from redgnn_tpu_torch.ops.segment_sorted import segment_sum_sorted_checked

    out = {}
    for dtype in ("float32", "bfloat16"):
        kg, cfg, model, pred = build_slice(data_dir, "cuda", dataset,
                                           compute_dtype=dtype, **over)
        queries = serving_queries(kg, N_BATCHES * pred.batch)
        timed_batches(pred, queries, 1)  # warm-up, not counted
        segment_sum_sorted_checked.launches = 0
        reset_dense_hop_launches()
        times, peak = timed_batches(pred, queries, N_BATCHES)
        launches = segment_sum_sorted_checked.launches
        dense_launches = dense_hop_launches()
        trainer = make_trainer(data_dir, "cuda", dataclasses.replace(
            cfg, scan_chunk=BF16_STEPS), steps=BF16_STEPS)
        segment_sum_sorted_checked.launches = 0
        step_ms, step_peak = train_steps_check(trainer, BF16_STEPS,
                                               f"{tag} {dtype}", card)
        out[dtype] = dict(kg=kg, cfg=cfg, model=model, pred=pred,
                          queries=queries, trainer=trainer,
                          serve_ms=float(np.mean(times)), serve_peak=peak,
                          serve_launches=launches,
                          serve_dense_launches=dense_launches,
                          train_launches=segment_sum_sorted_checked.launches,
                          step_ms=step_ms, step_peak=step_peak)
    f, b = out["float32"], out["bfloat16"]
    log(f"{tag} {dataset} entry, {over}: served {N_BATCHES} batches of "
        f"{b['pred'].batch}: bf16 {b['serve_ms']:.3f} ms per batch, peak "
        f"{b['serve_peak']} B, {b['serve_launches']} kernel launches; "
        f"float32 {f['serve_ms']:.3f} ms, peak {f['serve_peak']} B, "
        f"{f['serve_launches']} launches. Train steps (2 x {BF16_STEPS}, "
        f"the second epoch timed): bf16 {b['step_ms']:.3f} ms per step, "
        f"peak {b['step_peak']} B, {b['train_launches']} launches; "
        f"float32 {f['step_ms']:.3f} ms, peak {f['step_peak']} B, "
        f"{f['train_launches']} launches ({card})")
    return out


def phase_bf16_family(data_dir: str, card):
    """10a: the family-sized KG of phase 4, family entry in bf16 with the
    kernel (sort dedup, so the hidden[src] gathers take gather_bf16):
    serving and training counted and timed beside float32, one batch and
    one step against the CPU, the kernel at the path's real sums, idle
    shares. Returns the kernel's bf16 rows and launches."""
    from redgnn_tpu_torch.models.redgnn import hop_plan

    out = bf16_serve_and_train(data_dir, "family", "[10a]", card,
                               **KERNEL_SLICE)
    b = out["bfloat16"]
    model, pred, trainer = b["model"], b["pred"], b["trainer"]
    n_layer = model.cfg.n_layer
    kinds = hop_plan(model.cfg, pred.graph, pred.caps, pred.batch)
    assert kinds == ["sort"] * n_layer, kinds
    for d in out.values():
        assert d["serve_launches"] == n_layer * N_BATCHES, d["serve_launches"]
        assert d["train_launches"] == 2 * BF16_STEPS * n_layer, \
            d["train_launches"]
    q0 = b["queries"][:pred.batch]
    bf16_batch_check(model, pred, q0, "[10a]")
    plain = make_trainer(data_dir, "cuda", dataclasses.replace(
        b["cfg"], dropout=0.0), steps=BF16_STEPS)
    caps = exact_train_caps(plain)
    step_card_vs_cpu(data_dir, plain, caps, f"[10a] bf16, hops {kinds}:",
                     0.0, BF16_GRAD_TOL, loss_rtol=1e-4)
    rows = bf16_kernel_calls(model, pred, q0, plain, caps, "[10a]", card)
    for dtype, d in out.items():
        log(f"[10a] {dtype}: profile of 2 served batches, then of 2 steps")
        profile_batches(d["pred"], d["queries"][:2 * pred.batch], card)
        profile_steps(d["trainer"], d["trainer"].train_caps, card)
    bf16_walks_check(b["kg"], n_layer, "[10a]", card)
    return {"rows": rows, "serve_launches": b["serve_launches"],
            "train_launches": b["train_launches"],
            "serve_ms": b["serve_ms"], "step_ms": b["step_ms"],
            "f32_serve_ms": out["float32"]["serve_ms"],
            "f32_step_ms": out["float32"]["step_ms"]}


def phase_bf16_umls(data_dir: str, card):
    """10b: the umls-sized KG at the registry's defaults in bf16 (bitmap
    hops with the packed gather, then dense hops): hop schemes, one batch
    and one step against the CPU, 2 x 16 steps timed beside float32."""
    from redgnn_tpu_torch.models.redgnn import hop_plan

    out = bf16_serve_and_train(data_dir, "umls", "[10b]", card)
    b = out["bfloat16"]
    model, pred = b["model"], b["pred"]
    kinds = hop_plan(model.cfg, pred.graph, pred.caps, pred.batch)
    assert "bitmap" in kinds and "dense" in kinds, kinds
    tr = make_trainer(data_dir, "cuda", b["cfg"], steps=BF16_STEPS)
    caps = exact_train_caps(tr)
    tkinds = hop_plan(tr.model_cfg, tr.kg.graph, caps, b["cfg"].n_batch)
    assert "bitmap" in tkinds and "dense" in tkinds, tkinds
    log(f"[10b] hops in bf16: serving (batch {pred.batch}) {kinds}, "
        f"training (batch {b['cfg'].n_batch}) {tkinds}")
    # the dense hops of the served batches launch the static dense hop
    # kernel, in bf16 as in float32
    for dtype, d in out.items():
        assert d["serve_dense_launches"] == kinds.count("dense") * N_BATCHES, \
            (dtype, d["serve_dense_launches"])
    log(f"[10b] dense_hop_static launches over {N_BATCHES} served batches: "
        f"bf16 {b['serve_dense_launches']}, float32 "
        f"{out['float32']['serve_dense_launches']} (= "
        f"{kinds.count('dense')} dense hops x {N_BATCHES})")
    rows = dense_hop_check(pred, b["queries"][:pred.batch], "[10b] bf16",
                           card)
    bf16_batch_check(model, pred, b["queries"][:pred.batch], "[10b]")
    step_card_vs_cpu(data_dir, tr, caps, f"[10b] bf16, hops {tkinds}:",
                     0.0, BF16_GRAD_TOL, loss_rtol=1e-4)
    bf16_walks_check(b["kg"], model.cfg.n_layer, "[10b]", card)
    return {"serve_ms": b["serve_ms"], "step_ms": b["step_ms"],
            "dense_rows": rows,
            "dense_launches": b["serve_dense_launches"],
            "f32_serve_ms": out["float32"]["serve_ms"],
            "f32_step_ms": out["float32"]["step_ms"]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["7g", "7h", "7i", "7j"],
                    help="run phase 7g, 7h, 7i or 7j alone (after phases "
                    "1-2); "
                    "prints its times as one JSON line, and no 'ok' line")
    ap.add_argument("--tree", help="with --phase: a checkout of another "
                    "commit (e.g. the parent, unpacked by git archive); its "
                    "own chip_smoke.py and package run the phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.phase:
        mod = sys.modules[__name__]
        if args.tree:
            import importlib

            sys.path.insert(0, os.path.abspath(args.tree))
            sys.modules.pop("chip_smoke", None)
            mod = importlib.import_module("chip_smoke")
            assert os.path.dirname(os.path.abspath(mod.__file__)) == \
                os.path.abspath(args.tree), mod.__file__
        _, smi = mod.phase_device()
        mod.phase_build()
        if args.phase == "7g":
            res = {"gather": phase_gather_alone(mod, smi)}
        elif args.phase == "7h":
            res = {"cells": phase_hop_alone(mod, smi)}
        elif args.phase == "7i":
            res = {"cells": phase_dense_alone(mod, smi)}
        else:
            res = {"cells": phase_bwd_alone(mod, smi)}
        log(json.dumps({"phase": args.phase, "tree": args.tree or ".",
                        "card": smi, **res}))
        return 0
    elif args.tree:
        ap.error("--tree needs --phase")
    t_start = time.perf_counter()
    last = [t_start]

    def took(what: str) -> None:
        now = time.perf_counter()
        log(f"[time] {what}: {now - last[0]:.1f} s (script so far "
            f"{now - t_start:.1f} s)")
        last[0] = now

    name, smi = phase_device()
    card = smi
    native_build_s = phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_kg(tmp)
        kg, _, model, pred = build_slice(tmp, "cuda", **KERNEL_SLICE)
        queries = serving_queries(kg, N_BATCHES * pred.batch)
        kernel = phase_kernel(pred, queries[:pred.batch], card)
        kernel["launches"], family_owner = phase_slice(kg, model, pred,
                                                       queries, card)
        kernel["train_launches"], kernel["train_hops"] = phase_train(tmp,
                                                                     card)
        phase_family_defaults(tmp, card)
    took("phases 1-5")
    with tempfile.TemporaryDirectory() as tmp:
        write_umls_sized_kg(tmp)
        umls = phase_defaults(tmp, card)
        kernel["dense"] = phase_dense_kernel(tmp, card)
    took("phase 6")
    kernel["temporal"] = {}
    for entry, forecasting, tag in (("ICEWS14_TeMP", False, "[7a]"),
                                    ("ICEWS14_forecasting", True, "[7c]")):
        with tempfile.TemporaryDirectory() as tmp:
            write_icews14_sized(tmp, forecasting)
            kernel["temporal"][entry] = phase_temporal(tmp, entry, tag, card)
            took(f"phase {tag[1:-1]}")
            if forecasting:  # phase 8 reuses 7c's dir
                phase_xerte(tmp, card)
                took("phase 8a-8b")
                phase_simple(tmp, card)
                took("phase 8c")
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_kg(tmp)
        kernel["mesh"] = phase_mesh(tmp, card)
    took("phase 9")
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_kg(tmp)
        kernel["bf16"] = phase_bf16_family(tmp, card)
        took("phase 10a")
    with tempfile.TemporaryDirectory() as tmp:
        write_umls_sized_kg(tmp)
        kernel["bf16"]["umls"] = phase_bf16_umls(tmp, card)
    kernel["bf16"]["native_build_s"] = native_build_s
    took("phase 10b")
    if FAILED:
        print("chip_smoke: failed checks:\n" + "\n".join(FAILED),
              file=sys.stderr)
        return 1
    kernel["max_abs_err"] = max(
        [kernel["max_abs_err"]]
        + [r["max_abs_err"] for r in kernel["train_hops"]]
        + [r["max_abs_err"] for part in [kernel["dense"]]
           + list(kernel["temporal"].values())
           for k in ("serve", "train") for r in part[k]]
        + [r["max_abs_err"] for part in kernel["mesh"] for r in part["rows"]]
        + [r["max_abs_err"] for r in kernel["bf16"]["rows"]])
    entries = [kernel]
    gathers = [part["gather"] for part in kernel["temporal"].values()]
    g7c = kernel["temporal"]["ICEWS14_forecasting"]["gather"]
    for kname, where in GATHER_KERNELS.items():
        rows = g7c[kname]["train"]  # one forecasting train step's calls

        def total(key, rows=rows):
            vals = [r[key] for r in rows]
            return None if None in vals else sum(vals)

        entries.append({
            "name": kname, "route": "cuda", **where,
            "launches": g7c[kname]["launches"],
            "max_abs_err": max([0.0] + [
                r["max_abs_err"] for part in gathers
                for k in ("serve", "train") for r in part[kname][k]]),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"), "bound_by": "bytes",
            "library_ms": total("library_ms")})
    # phase 7h's kernels: list_sum over one 7a train step's dense calls
    # (launches over the trainer's 2 x 16 steps), slot_owner over one 7c
    # served batch's hops (launches over the 8 served batches)
    hop = {e: kernel["temporal"][e]["hop_index"] for e in kernel["temporal"]}
    picks = {"list_sum": (hop["ICEWS14_TeMP"]["list_sum"]["train"],
                          hop["ICEWS14_TeMP"]["list_sum"]["launches"],
                          kernel["dense"]["list_sum"]),
             "slot_owner": (hop["ICEWS14_forecasting"]["slot_owner"]["serve"],
                            hop["ICEWS14_forecasting"]["slot_owner"]["served"],
                            family_owner)}
    for kname, where in HOP_INDEX_KERNELS.items():
        rows, launches, more = picks[kname]
        checked = more + [r for h in hop.values() for k in ("serve", "train")
                          for r in h[kname][k]]
        entries.append({
            "name": kname, "route": "cuda", **where, "launches": launches,
            "max_abs_err": max([0.0] + [r["max_abs_err"] for r in checked]),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in rows)})
    # phase 7i's kernels: each over one served batch's dense calls of its
    # main path (umls's defaults, 7a), launches over the N_BATCHES served
    # batches; library_ms is the old route's (the autograd route's tensor
    # ops with gradients off): no single PyTorch call computes the hop
    t7a = kernel["temporal"]["ICEWS14_TeMP"]["dense_hop"]
    picks = {"dense_hop_static": (umls["serve"], umls["launches"],
                                  kernel["bf16"]["umls"]["dense_rows"]),
             "dense_hop_temporal": (t7a["serve"], t7a["launches"], [])}
    for kname, where in DENSE_HOP_KERNELS.items():
        rows, launches, more = picks[kname]
        bound_by = max(("bytes", sum(r["bytes"] for r in rows)
                        / HBM_BYTES_PER_S),
                       ("operations", sum(r["flops"] for r in rows)
                        / FP32_FLOPS_PER_S), key=lambda x: x[1])[0]
        entries.append({
            "name": kname, "route": "cuda", **where, "launches": launches,
            "max_abs_err": max([0.0] + [r["max_abs_err"]
                                        for r in rows + more]),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": bound_by,
            "library_ms": sum(r["old_route_ms"] for r in rows)})
    # phase 7j's kernels: each over one train step's dense hops of its
    # main path (umls's defaults in 6a, 7a), launches over the trainer's
    # two epochs; library_ms is the old route's backward (autograd of its
    # tensor ops): no single PyTorch call computes it
    b7a = kernel["temporal"]["ICEWS14_TeMP"]["dense_bwd"]
    picks = {"dense_hop_static_bwd": (umls["bwd"], umls["bwd_launches"]),
             "dense_hop_temporal_bwd": (b7a["train"], b7a["launches"])}
    for kname, where in DENSE_BWD_KERNELS.items():
        rows, launches = picks[kname]
        bound_by = max(("bytes", sum(r["bytes"] for r in rows)
                        / HBM_BYTES_PER_S),
                       ("operations", sum(r["flops"] for r in rows)
                        / FP32_FLOPS_PER_S), key=lambda x: x[1])[0]
        entries.append({
            "name": kname, "route": "cuda", **where, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": bound_by,
            "library_ms": sum(r["old_route_ms"] for r in rows)})
    log(json.dumps({"kernels": entries}))
    assert name == torch.cuda.get_device_name(0), name
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
