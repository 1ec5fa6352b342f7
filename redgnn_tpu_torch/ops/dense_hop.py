"""The dense hop as one forward and one backward kernel per model.

A dense hop runs one propagation step over the whole tail-sorted edge
table, shared by a batch of ``b`` queries (the saturated-frontier regime
of `models/layers.py:RelAttnLayer.dense` and
`models/temporal.py:TRedGNN._dense_hop`). Its autograd route
(``dense_autograd``, ``_dense_hop_autograd``, kept only as a yardstick)
gathers the (N, b, d) state per edge and builds every (E, b, d)
intermediate in device memory. The models call the functions here
instead, gradients on or off:

* `dense_hop_static` (``csrc/dense_hop_static.cu``): the sum over each
  tail's kept edges of ``(hs + hr) * sigmoid(w_a . relu(Ws hs + WR[rel]
  + WQ[q]) + b_a)``, the new visited flags and the count of kept edges
  (float32 or bfloat16 tables);
* `dense_hop_temporal` (``csrc/dense_hop_temporal.cu``): the temporal
  message ``hs + hr + TT[t, q]`` through the past / now / future
  transform, scaled by attention, masked, summed per tail, then dropout
  (when a mask is given), ``act`` and the visited mask; the counts of new
  visited flags and kept edges.

On a CUDA tensor each launches its kernel (counted in ``.launches``) or
raises; on a CPU tensor it takes its plain version (`*_plain`), the same
function in the kernel's factoring. `dense_hop_static_fn` and
`dense_hop_temporal_fn` wrap them in a ``torch.autograd.Function`` whose
backward is `dense_hop_static_bwd` / `dense_hop_temporal_bwd`: on a CUDA
tensor ``csrc/dense_hop_static_bwd.cu`` / ``csrc/dense_hop_temporal_bwd.cu``
(shared walk ``csrc/dense_hop_bwd.cuh``), whose per-(edge, query) rows are
summed by `ops.gather.list_sum` (the state's by source, the time term's
by time id) and its per-edge rows by `ops.gather.scatter_rows_add` (by
relation), both called through the module (so that a recording of
either sees these calls); on a CPU tensor the plain backwards (`*_bwd_plain`), explicit
formulas in the kernel's factoring. The terms that depend on fewer
operands than (edge, query) are computed once, outside the (E, b) loop,
by `static_terms` and `temporal_terms` for both routes: the relation and
query projections and, in the temporal model, the time term per (time
id, query) (``n_time * b`` rows in place of ``E * b``). That is a
reassociation of the autograd route's sums, within float32 rounding.

The kernel sums each (tail, query) over the tail's edges in one fixed
order (chunks of `EDGE_CHUNK` edges, then the chunks in order: no float
atomics), so it gives the same bits on every run, whatever ``dense_agg``
says; ``dense_agg`` ('sorted_scatter' or 'cumsum') picks only the plain
version's summation. Counts are exact integers either way.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from redgnn_tpu_torch import _build
from redgnn_tpu_torch.ops import gather
from redgnn_tpu_torch.ops.segment import segment_sum

EDGE_CHUNK = 16       # edges of a tail a warp sums before the tail splits
MAX_ATTN = 64         # attention width both kernels take
MAX_WIDTH = 64        # hidden width both kernels take

# the temporal activations by the kernel's code (csrc/dense_hop_temporal.cu)
ACTS = {
    "relu": (0, torch.relu),
    "tanh": (1, torch.tanh),
    "sigmoid": (2, torch.sigmoid),
    "idd": (3, lambda x: x),
    "softplus": (4, F.softplus),
    "leakyrelu": (5, lambda x: F.leaky_relu(x, 0.01)),
}


def tail_items(tail_rowptr: torch.Tensor) -> torch.Tensor:
    """The kernels' work items: tail v's edges cut into
    ``max(1, ceil(deg / EDGE_CHUNK))`` chunks; returns (N + 1,) int32, the
    first item of each tail (the last entry is the count). A pure function
    of the graph: `graph.kg.DeviceGraph` keeps it as ``tail_items``."""
    deg = (tail_rowptr[1:] - tail_rowptr[:-1]).long()
    n = torch.clamp((deg + EDGE_CHUNK - 1) // EDGE_CHUNK, min=1)
    return torch.cat([n.new_zeros(1), torch.cumsum(n, 0)]).to(torch.int32)


def _walk_scratch(n_tail: int, b: int, d: int, n_edges: int, dev):
    """(items bound, partial sums, partial counts, the two counts followed
    by the arrival counters of each (query group of 32, tail)):
    sum_v max(1, ceil(deg_v / C)) <= N + E // C bounds the items, so the
    grid needs no host read of the plan."""
    items = n_tail + n_edges // EDGE_CHUNK
    groups = -(-b // 32)
    return (items,
            torch.empty((items, b, d), dtype=torch.float32, device=dev),
            torch.empty((items, b), dtype=torch.int32, device=dev),
            torch.zeros(2 + groups * n_tail, dtype=torch.int32, device=dev))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_common(name, hidden, visited, idx, tail_rowptr, item_ptr, a):
    n, b, d = hidden.shape if hidden.dim() == 3 else (0, 0, 0)
    dev = hidden.device
    _require(hidden.dim() == 3, f"{name}: hidden must be (N, b, d), got "
             f"{tuple(hidden.shape)}")
    _require(0 < d <= MAX_WIDTH,
             f"{name}: hidden width {d} is outside 1..{MAX_WIDTH}")
    _require(0 <= a <= MAX_ATTN,
             f"{name}: attention width {a} is outside 0..{MAX_ATTN}")
    _require(visited.shape == (n, b) and visited.dtype == torch.bool,
             f"{name}: visited must be ({n}, {b}) bool, got "
             f"{tuple(visited.shape)} {visited.dtype}")
    for what, t, shape in idx + [("tail_rowptr", tail_rowptr, (n + 1,)),
                                 ("item_ptr", item_ptr, (n + 1,))]:
        _require(t is not None and t.dtype == torch.int32
                 and tuple(t.shape) == shape,
                 f"{name}: {what} must be {shape} int32, got "
                 f"{None if t is None else (tuple(t.shape), t.dtype)}")
    return n, b, d, dev


def _check_tensors(name, dev, tensors):
    for what, t, dtype, shape in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, hidden on "
                             f"{dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {what} must be {dtype}, got "
                             f"{t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _segment_totals(message, keep, ttail, tail_rowptr, n, dense_agg):
    """(sum of ``message`` (E, b, d) per tail, any ``keep`` (E, b) per
    tail) by the plain route's ``dense_agg``."""
    e_all, b, d = message.shape
    if dense_agg == "cumsum":
        lo, hi = tail_rowptr[:-1].long(), tail_rowptr[1:].long()
        pref = torch.cat([message.new_zeros((1, b, d)),
                          torch.cumsum(message, 0)])
        cnt = torch.cat([
            torch.zeros((1, b), dtype=torch.int32, device=keep.device),
            torch.cumsum(keep, 0, dtype=torch.int32)])
        return pref[hi] - pref[lo], (cnt[hi] - cnt[lo]) > 0
    if dense_agg == "sorted_scatter":
        agg = segment_sum(message.reshape(e_all, b * d), ttail, n,
                          indices_are_sorted=True,
                          impl="xla").reshape(n, b, d)
        return agg, segment_sum(keep.to(message.dtype), ttail, n,
                                indices_are_sorted=True, impl="xla") > 0
    raise ValueError(f"unknown dense_agg {dense_agg!r}")


# ------------------------------------------------------------------ static

def static_terms(rela: torch.Tensor, q_rel: torch.Tensor,
                 wr: torch.Tensor, wqr: torch.Tensor, bqr: torch.Tensor):
    """The static hop's per-relation and per-query attention terms: WR =
    Wr rela (R, A) and WQ = Wqr rela[q_rel] + b_qr (b, A). ``rela`` is the
    table in the compute dtype; a bf16 table's rows are promoted to
    float32, as the projections of the autograd route promote them."""
    ct = torch.promote_types(rela.dtype, torch.float32)
    r = rela.to(ct)
    return F.linear(r, wr), F.linear(r[q_rel.long()], wqr, bqr)


def static_messages(hidden, visited, rela, tsrc, trel, wr, wq, ws, w_alpha,
                    b_alpha):
    """(message (E, b, d), live (E, b)): each (edge, query) term of the
    static hop, zero where the edge is not live. bf16 rows are promoted to
    float32, or to float64 with float64 weights (a referee)."""
    ct = torch.promote_types(torch.promote_types(hidden.dtype, torch.float32),
                             ws.dtype)
    src = tsrc.long()
    hs_c = hidden[src]                                  # (E, b, d)
    live = visited[src]                                 # (E, b)
    hr_c = rela[trel.long()]                            # (E, d)
    hs = hs_c.to(ct)
    pre = F.linear(hs, ws) + wr[trel.long()][:, None, :] + wq[None, :, :]
    alpha = torch.sigmoid(F.linear(torch.relu(pre), w_alpha[None], b_alpha))
    # one add in the table's dtype (a bf16 round), then float32
    message = (hs_c + hr_c[:, None, :]).to(ct) * alpha
    return torch.where(live[..., None], message, 0.0), live


def dense_hop_static_plain(hidden, visited, rela, tsrc, trel, ttail,
                           tail_rowptr, wr, wq, ws, w_alpha, b_alpha,
                           dense_agg: str = "sorted_scatter"):
    """`dense_hop_static` in plain PyTorch (any device, float64 too):
    `static_messages`, then the sums by ``dense_agg``."""
    message, live = static_messages(hidden, visited, rela, tsrc, trel, wr,
                                    wq, ws, w_alpha, b_alpha)
    agg, new_visited = _segment_totals(message, live, ttail, tail_rowptr,
                                       visited.shape[0], dense_agg)
    return agg, new_visited, torch.sum(live).to(torch.int32)


def check_static_inputs(hidden, visited, rela, tsrc, trel, tail_rowptr,
                        item_ptr, wr, wq, ws, w_alpha, b_alpha):
    """What `dense_hop_static`'s kernel takes (dtypes, shapes, one device,
    contiguity), on any device: returns (N, b, d, A) or raises
    ValueError."""
    name = "dense_hop_static"
    a = ws.shape[0]
    n, b, d, dev = _check_common(
        name, hidden, visited, [("tsrc", tsrc, tsrc.shape[:1]),
                                ("trel", trel, tsrc.shape[:1])],
        tail_rowptr, item_ptr, a)
    _require(hidden.dtype in (torch.float32, torch.bfloat16),
             f"{name}: hidden must be float32 or bfloat16, got "
             f"{hidden.dtype}")
    r = rela.shape[0]
    f32 = torch.float32
    _check_tensors(name, dev, [
        ("hidden", hidden, hidden.dtype, None),
        ("visited", visited, torch.bool, None),
        ("rela", rela, hidden.dtype, (r, d)),
        ("tsrc", tsrc, torch.int32, None), ("trel", trel, torch.int32, None),
        ("tail_rowptr", tail_rowptr, torch.int32, None),
        ("item_ptr", item_ptr, torch.int32, None),
        ("wr", wr, f32, (r, a)), ("wq", wq, f32, (b, a)),
        ("ws", ws, f32, (a, d)), ("w_alpha", w_alpha, f32, (a,)),
        ("b_alpha", b_alpha, f32, (1,))])
    _require(a > 0, f"{name}: the attention width must be positive")
    return n, b, d, a


def dense_hop_static(hidden, visited, rela, tsrc, trel, ttail, tail_rowptr,
                     wr, wq, ws, w_alpha, b_alpha, dense_agg: str,
                     item_ptr):
    """The static dense hop's sum (RelAttnLayer.dense before ``W_h``).

    hidden: (N, b, d) float32 or bfloat16 state; visited: (N, b) bool;
    rela: (R, d) relation table in hidden's dtype; tsrc, trel, ttail:
    (E,) int32 tail-sorted table; tail_rowptr: (N + 1,) int32; wr (R, A),
    wq (b, A): `static_terms`; ws: (A, d) ``Ws_attn.weight``; w_alpha:
    (A,); b_alpha: (1,); dense_agg: the plain version's summation;
    item_ptr: the graph's `tail_items` (the kernel's work plan). Returns
    (agg (N, b, d) float32, new_visited (N, b) bool, kept edges ()
    int32). A CUDA tensor launches
    ``csrc/dense_hop_static.cu`` (``dense_hop_static.launches``); a CPU
    tensor takes `dense_hop_static_plain`."""
    if hidden.device.type == "cpu":
        return dense_hop_static_plain(hidden, visited, rela, tsrc, trel,
                                      ttail, tail_rowptr, wr, wq, ws,
                                      w_alpha, b_alpha, dense_agg)
    n, b, d, a = check_static_inputs(hidden, visited, rela, tsrc, trel,
                                     tail_rowptr, item_ptr, wr, wq, ws,
                                     w_alpha, b_alpha)
    dev, f32 = hidden.device, torch.float32
    agg = torch.empty((n, b, d), dtype=f32, device=dev)
    new_visited = torch.empty((n, b), dtype=torch.bool, device=dev)
    if n == 0 or b == 0:
        return agg, new_visited, torch.zeros((), dtype=torch.int32,
                                             device=dev)
    items, partial, partial_kept, counts = _walk_scratch(
        n, b, d, tsrc.shape[0], dev)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.entry("dense_hop_static", "dense_hop_static",
                      [p, ctypes.c_int] + [p] * 16 + [i64] * 7 + [p])
    _build.launch(fn, (
        hidden.data_ptr(), int(hidden.dtype == torch.bfloat16),
        visited.data_ptr(), rela.data_ptr(), tsrc.data_ptr(),
        trel.data_ptr(), tail_rowptr.data_ptr(), item_ptr.data_ptr(),
        wr.data_ptr(), wq.data_ptr(), ws.data_ptr(), w_alpha.data_ptr(),
        b_alpha.data_ptr(), agg.data_ptr(), new_visited.data_ptr(),
        partial.data_ptr(), partial_kept.data_ptr(), counts.data_ptr(),
        n, b, d, a, EDGE_CHUNK, items, rela.shape[0]), hidden,
        f"dense_hop_static (N={n}, b={b}, d={d}, A={a}, "
        f"E={tsrc.shape[0]})")
    dense_hop_static.launches += 1
    return agg, new_visited, counts[0]


dense_hop_static.launches = 0


# ---------------------------------------------------------------- temporal

def temporal_terms(rela, a1, rels, times, n_time=None, time_freq=None,
                   time_w=None, time_b=None, time_abs=None,
                   use_attention: bool = True):
    """The temporal hop's terms that depend on fewer operands than (edge,
    query): (ra (R, A) = rela A1_r, qa (b, A) = rela[rels] A1_q; None
    without attention) and tt (n_time, b, d), the time term of every time
    id ``t`` in ``0..n_time-1`` (past every edge time) for every query:
    relu([cos z ‖ sin z] W_t + t_b) at z = 2π f (t − t_q) through the trig
    factoring of the JAX package (`temporal.py:502-520`), or the absolute
    table's row (``time_abs``, clamped ids); None when neither is
    given."""
    d = rela.shape[1]
    ra = qa = None
    if use_attention:
        ra = rela @ a1[d:2 * d]
        qa = rela[rels.long()] @ a1[2 * d:]
    tt = None
    if time_abs is not None or time_freq is not None:
        _require(n_time is not None,
                 "temporal_terms: a time term needs n_time, the graph's "
                 "count of time ids (TemporalKG builds its graph with it)")
        time_ids = torch.arange(n_time, device=rela.device)
    if time_abs is not None:
        t_idx = torch.clamp(time_ids, 0, time_abs.shape[0] - 1)
        tt = time_abs[t_idx][:, None, :].expand(
            -1, rels.shape[0], -1).contiguous()
    elif time_freq is not None:
        k = time_freq.shape[0]
        b = rels.shape[0]
        t_e = time_ids.to(torch.float32)
        t_q = times.to(torch.float32)
        z_e = 2.0 * math.pi * t_e[:, None] * time_freq[None, :]
        z_q = 2.0 * math.pi * t_q[:, None] * time_freq[None, :]
        ce, se = torch.cos(z_e), torch.sin(z_e)           # (T, K)
        cq, sq = torch.cos(z_q), torch.sin(z_q)           # (b, K)
        w_c, w_s = time_w[:k], time_w[k:]                 # (K, d)
        p = cq[:, :, None] * w_c[None] - sq[:, :, None] * w_s[None]
        q = sq[:, :, None] * w_c[None] + cq[:, :, None] * w_s[None]
        pq = torch.cat([p, q], 1).permute(1, 0, 2).reshape(2 * k, b * d)
        h_pre = (torch.cat([ce, se], 1) @ pq).view(-1, b, d)
        tt = torch.relu(h_pre + time_b)
    return ra, qa, tt


def temporal_messages(hidden, visited, rela, tsrc, trel, ttime, times,
                      excl_keep, edge_keep, tt, ra, qa, a1s, a2, wdir, bdir):
    """(message (E, b, d), keep (E, b)): each (edge, query) term of the
    temporal hop before its sum, zero where the edge is not kept."""
    src = tsrc.long()
    hs = hidden[src]                                     # (E, b, d)
    msg = hs + rela[trel.long()][:, None, :]
    if tt is not None:
        msg = msg + tt[ttime.long()]
    te, tq = ttime[:, None], times[None, :]
    if wdir is not None:
        out = torch.where((te > tq)[..., None], msg @ wdir[2],
                          torch.where((te < tq)[..., None], msg @ wdir[0],
                                      msg @ wdir[1]))
    else:
        out = msg + torch.where(
            (te > tq)[..., None], bdir[2],
            torch.where((te < tq)[..., None], bdir[0], bdir[1]))
    if ra is not None:
        pre = (hs @ a1s + ra[trel.long()][:, None, :] + qa[None, :, :])
        out = out * torch.sigmoid(torch.relu(pre) @ a2)
    keep = visited[src]
    if excl_keep is not None:
        keep = keep & excl_keep[:, None]
    if edge_keep is not None:
        keep = keep & edge_keep
    return torch.where(keep[..., None], out, 0.0), keep


def dense_hop_temporal_plain(hidden, visited, rela, tsrc, trel, ttime, ttail,
                             tail_rowptr, times, excl_keep, edge_keep, tt, ra,
                             qa, a1s, a2, wdir, bdir, drop_keep,
                             dropout: float, act: str,
                             dense_agg: str = "sorted_scatter"):
    """`dense_hop_temporal` in plain PyTorch (any device, float64 too):
    `temporal_messages`, the sums by ``dense_agg``, then the epilogue."""
    out, keep = temporal_messages(hidden, visited, rela, tsrc, trel, ttime,
                                  times, excl_keep, edge_keep, tt, ra, qa,
                                  a1s, a2, wdir, bdir)
    agg, new_visited = _segment_totals(out, keep, ttail, tail_rowptr,
                                       visited.shape[0], dense_agg)
    if drop_keep is not None:
        agg = torch.where(drop_keep, agg / (1.0 - dropout), 0.0)
    h = torch.where(new_visited[..., None], ACTS[act][1](agg), 0.0)
    return (h, new_visited, torch.sum(new_visited).to(torch.int32),
            torch.sum(keep).to(torch.int32))


def check_temporal_inputs(hidden, visited, rela, tsrc, trel, ttime,
                          tail_rowptr, item_ptr, times, excl_keep, edge_keep,
                          tt, ra, qa, a1s, a2, wdir, bdir, drop_keep):
    """What `dense_hop_temporal`'s kernel takes, on any device: returns
    (N, b, d, A) or raises ValueError."""
    name = "dense_hop_temporal"
    a = 0 if ra is None else ra.shape[1]
    e = tsrc.shape[:1]
    n, b, d, dev = _check_common(
        name, hidden, visited, [("tsrc", tsrc, e), ("trel", trel, e),
                                ("ttime", ttime, e)],
        tail_rowptr, item_ptr, a)
    f32, r = torch.float32, rela.shape[0]
    _check_tensors(name, dev, [
        ("hidden", hidden, f32, None), ("visited", visited, torch.bool, None),
        ("rela", rela, f32, (r, d)), ("tsrc", tsrc, torch.int32, None),
        ("trel", trel, torch.int32, None), ("ttime", ttime, torch.int32, None),
        ("tail_rowptr", tail_rowptr, torch.int32, None),
        ("item_ptr", item_ptr, torch.int32, None),
        ("times", times, torch.int32, (b,)),
        ("excl_keep", excl_keep, torch.bool, e),
        ("edge_keep", edge_keep, torch.bool, (e[0], b)),
        ("tt", tt, f32, None if tt is None else (tt.shape[0], b, d)),
        ("ra", ra, f32, (r, a)), ("qa", qa, f32, (b, a)),
        ("a1s", a1s if ra is not None else None, f32, (d, a)),
        ("a2", a2 if ra is not None else None, f32, (a, 1)),
        ("wdir", wdir, f32, (3, d, d)), ("bdir", bdir, f32, (3, d)),
        ("drop_keep", drop_keep, torch.bool, (n, b, d))])
    _require((ra is None) == (qa is None) and (ra is None or a > 0),
             f"{name}: attention needs ra and qa, of a positive width")
    return n, b, d, a


def dense_hop_temporal(hidden, visited, rela, tsrc, trel, ttime, ttail,
                       tail_rowptr, times, excl_keep, edge_keep, tt, ra, qa,
                       a1s, a2, wdir, bdir, drop_keep, dropout: float,
                       act: str, dense_agg: str, item_ptr):
    """One temporal dense hop (TRedGNN._dense_hop with the terms of
    `temporal_terms`).

    hidden: (N, b, d) float32; visited: (N, b) bool; rela: (R, d);
    tsrc, trel, ttime, ttail: (E,) int32 tail-sorted table; tail_rowptr:
    (N + 1,) int32; times: (b,) int32 query time ids; excl_keep: (E,) bool
    leave-one-out keep mask or None; edge_keep: (E, b) bool edge-dropout
    keep mask or None; tt: (T, b, d) time term (T past every ttime) or None
    (``use_time`` off); ra, qa, a1s = A1[:d] (d, A), a2 (A, 1): attention,
    or ra None (``use_attention`` off); wdir (3, d, d) past / now / future
    transforms, or bdir (3, d) biases; drop_keep: (N, b, d) bool dropout
    mask (kept values divided by ``1 - dropout``) or None; act: a key of
    `ACTS`; dense_agg and item_ptr as `dense_hop_static`'s. Returns (h
    (N, b, d), new_visited (N, b), new visited count,
    kept edges), the counts () int32. A CUDA tensor launches
    ``csrc/dense_hop_temporal.cu`` (``dense_hop_temporal.launches``); a CPU
    tensor takes `dense_hop_temporal_plain`."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if (wdir is None) == (bdir is None):
        raise ValueError("dense_hop_temporal takes one of wdir and bdir")
    if hidden.device.type == "cpu":
        return dense_hop_temporal_plain(
            hidden, visited, rela, tsrc, trel, ttime, ttail, tail_rowptr,
            times, excl_keep, edge_keep, tt, ra, qa, a1s, a2, wdir, bdir,
            drop_keep, dropout, act, dense_agg)
    n, b, d, a = check_temporal_inputs(
        hidden, visited, rela, tsrc, trel, ttime, tail_rowptr, item_ptr,
        times, excl_keep, edge_keep, tt, ra, qa, a1s, a2, wdir, bdir,
        drop_keep)
    dev, f32, e = hidden.device, torch.float32, tsrc.shape[:1]
    out = torch.empty((n, b, d), dtype=f32, device=dev)
    new_visited = torch.empty((n, b), dtype=torch.bool, device=dev)
    if n == 0 or b == 0:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return out, new_visited, zero, zero
    items, partial, partial_kept, counts = _walk_scratch(
        n, b, d, e[0], dev)
    p, i64, c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _build.entry("dense_hop_temporal", "dense_hop_temporal",
                      [p] * 19 + [ctypes.c_float, c_int] + [p] * 5
                      + [i64] * 7 + [c_int] * 3 + [p])
    _build.launch(fn, (
        hidden.data_ptr(), visited.data_ptr(), rela.data_ptr(),
        tsrc.data_ptr(), trel.data_ptr(), ttime.data_ptr(),
        tail_rowptr.data_ptr(), item_ptr.data_ptr(), times.data_ptr(),
        _ptr(excl_keep), _ptr(edge_keep), _ptr(tt), _ptr(ra), _ptr(qa),
        None if ra is None else a1s.data_ptr(),
        None if ra is None else a2.data_ptr(), _ptr(wdir), _ptr(bdir),
        _ptr(drop_keep), float(1.0 - dropout), ACTS[act][0],
        out.data_ptr(), new_visited.data_ptr(), partial.data_ptr(),
        partial_kept.data_ptr(), counts.data_ptr(), n, b, d, a, EDGE_CHUNK,
        items, rela.shape[0], int(tt is not None), int(ra is not None),
        int(wdir is not None)), hidden,
        f"dense_hop_temporal (N={n}, b={b}, d={d}, A={a}, E={e[0]})")
    dense_hop_temporal.launches += 1
    return out, new_visited, counts[1], counts[0]


dense_hop_temporal.launches = 0


# ---------------------------------------------------------------- backward

# act'(y) as a function of h = act(y) alone (csrc/dense_hop_bwd.cuh:
# act_grad): the backward needs the hop's output and no pre-activation
ACT_GRADS = {
    "relu": lambda h: (h > 0).to(h.dtype),
    "tanh": lambda h: 1.0 - h * h,
    "sigmoid": lambda h: h * (1.0 - h),
    "idd": torch.ones_like,
    "softplus": lambda h: -torch.expm1(-h),   # sigmoid(y) = 1 - e^-h
    "leakyrelu": lambda h: torch.where(h > 0, torch.ones_like(h),
                                       torch.full_like(h, 0.01)),
}


def _sum_by(x, idx, rows):
    """(rows,) + x.shape[1:] sums of ``x``'s rows by ``idx``."""
    return x.new_zeros((rows,) + x.shape[1:]).index_add_(0, idx.long(), x)


def temporal_cotangent(g_h, h, new_visited, drop_keep, dropout: float,
                       act: str):
    """G: the cotangent of the temporal hop's sum per (tail, query), from
    that of its output h = where(visited, act(dropout(sum)), 0)."""
    grad = torch.where(new_visited[..., None], g_h * ACT_GRADS[act](h), 0.0)
    if drop_keep is not None:
        grad = torch.where(drop_keep, grad / (1.0 - dropout), 0.0)
    return grad


def _abs_if(absolute: bool):
    return torch.abs if absolute else (lambda x: x)


# float32's least normal number: the absolute error that float32 may commit
# on a sigmoid near 0 (its exp overflows, or the value falls among the
# subnormals)
ETA32 = 2.0 ** -126


def _sigmoids(logit, absolute: bool):
    """(sigmoid(logit), sigmoid(-logit)); with ``absolute`` each raised by
    ETA32 / 1e-5, so that `bwd_bound`'s 1e-5 of a term covers float32's
    absolute error on a sigmoid that underflows (|logit| past ~87) as well
    as its relative rounding."""
    alpha, beta = torch.sigmoid(logit), torch.sigmoid(-logit)
    if absolute:
        alpha, beta = alpha + ETA32 / 1e-5, beta + ETA32 / 1e-5
    return alpha, beta


def dense_hop_static_bwd_plain(g, hidden, visited, rela, tsrc, trel, ttail,
                               wr, wq, ws, w_alpha, b_alpha,
                               absolute: bool = False, kinks: bool = False):
    """`dense_hop_static_bwd` in plain PyTorch (any device, float64 too),
    the kernel's factoring written out: per kept (edge, query) pair, with G
    the tail's cotangent row, d_m = G alpha, dlogit = (G . m) alpha (1 -
    alpha) (1 - alpha as sigmoid(-logit)), dpre = dlogit w_alpha
    [pre > 0], d_hs = d_m + Ws^T dpre; then the sums by source, relation
    and query and the contractions. The
    gradients are float32 (float64 with float64 weights) whatever the
    tables' dtype: no bf16 round enters them. ``absolute``: the same
    computation on the absolute values of every factor that enters a sum
    (alpha and the relu masks as they are): the sum|x| of `bwd_bound`.
    ``kinks``: the absolute values of the attention terms whose relu mask
    a float32 evaluation may flip (`_kink`), the rest 0."""
    ab = _abs_if(absolute or kinks)
    ct = torch.promote_types(torch.promote_types(hidden.dtype, torch.float32),
                             ws.dtype)
    src, rel = tsrc.long(), trel.long()
    hs_c = hidden[src]                                   # (E, b, d)
    kf = visited[src][..., None].to(ct)
    hs = hs_c.to(ct)
    pre = F.linear(hs, ws) + wr[rel][:, None, :] + wq[None, :, :]
    r = torch.relu(pre)
    logit = F.linear(r, w_alpha[None], b_alpha)
    # 1 - alpha as sigmoid(-logit): no cancellation where alpha nears 1
    alpha, beta = _sigmoids(logit, absolute or kinks)
    if absolute or kinks:
        m = hs.abs() + rela[rel][:, None, :].to(ct).abs()
    else:
        m = (hs_c + rela[rel][:, None, :]).to(ct)        # one bf16 add
    gt = ab(g[ttail.long()].to(ct))
    mask = pre > 0
    if kinks:
        mask = _kink(pre, F.linear(hs.abs(), ws.abs())
                     + wr[rel][:, None, :].abs() + wq[None, :, :].abs())
    hs, ws, w_alpha = ab(hs), ab(ws), ab(w_alpha)
    d_m = gt * alpha * kf * (not kinks)
    dl = (gt * m).sum(-1, keepdim=True) * alpha * beta * kf
    dpre = dl * w_alpha * mask
    d_hs = d_m + dpre @ ws
    if kinks:
        r, dl = torch.zeros_like(r), torch.zeros_like(dl)
    return (_sum_by(d_hs, src, hidden.shape[0]),
            _sum_by(d_m.sum(1), rel, rela.shape[0]),
            _sum_by(dpre.sum(1), rel, wr.shape[0]), dpre.sum(0),
            torch.einsum("eba,ebi->ai", dpre, hs),
            torch.einsum("eba,eb->a", r, dl[..., 0]), dl.sum().reshape(1))


def dense_hop_temporal_bwd_plain(g_h, h, new_visited, hidden, visited, rela,
                                 tsrc, trel, ttime, ttail, times, excl_keep,
                                 edge_keep, tt, ra, qa, a1s, a2, wdir, bdir,
                                 drop_keep, dropout: float, act: str,
                                 absolute: bool = False,
                                 kinks: bool = False):
    """`dense_hop_temporal_bwd` in plain PyTorch (any device, float64 too),
    the kernel's factoring written out: G = `temporal_cotangent`; per kept
    pair d_msg = alpha W[dir] G (or alpha G), dlogit = (G . out) alpha (1 -
    alpha) (G . out as msg . (W[dir] G) with the linear transform),
    dpre = dlogit a2 [pre > 0], d_hs = d_msg + A1s dpre; then the
    sums by source, relation, time id and query, the contraction d A1s,
    and d W[k] = sum over (tail, query) of M_k (x) G with M_k the sum of
    alpha msg over the tail's kept edges of direction k (d B[k] likewise
    with the sum of alpha). Returns (d_hidden, d_rela, d_tt, d_ra, d_qa,
    d_a1s, d_a2, d_wdir, d_bdir), None where the input is None.
    ``absolute``: the same computation on the absolute values of every
    factor that enters a sum (alpha and the relu masks as they are);
    ``kinks``: the absolute values of the attention terms whose relu mask
    a float32 evaluation may flip (`_kink`), the rest 0."""
    ab = _abs_if(absolute or kinks)
    n = hidden.shape[0]
    grad = ab(temporal_cotangent(g_h, h, new_visited, drop_keep, dropout,
                                 act))
    src, rel, te = tsrc.long(), trel.long(), ttime.long()
    keep = visited[src]
    if excl_keep is not None:
        keep = keep & excl_keep[:, None]
    if edge_keep is not None:
        keep = keep & edge_keep
    kf = keep[..., None].to(hidden.dtype)
    hs = hidden[src]                                     # (E, b, d)
    alpha = 1.0
    if ra is not None:
        pre = hs @ a1s + ra[rel][:, None, :] + qa[None, :, :]
        r = torch.relu(pre)
        logit = r @ a2                                   # (E, b, 1)
        # 1 - alpha as sigmoid(-logit): no cancellation near alpha = 1
        alpha, beta = _sigmoids(logit, absolute or kinks)
        mask = pre > 0
        if kinks:
            mask = _kink(pre, hs.abs() @ a1s.abs()
                         + ra[rel][:, None, :].abs() + qa[None, :, :].abs())
    hs, rela, tt, wdir, bdir, a1s, a2 = (
        None if x is None else ab(x)
        for x in (hs, rela, tt, wdir, bdir, a1s, a2))
    msg = hs + rela[rel][:, None, :]
    if tt is not None:
        msg = msg + tt[te]
    direction = torch.sign(ttime[:, None] - times[None, :]).long() + 1
    gt = grad[ttail.long()]
    if wdir is not None:
        # W[dir] G per pair: G . (msg W) = msg . (W G), as the kernel takes
        # it (W G once per tail, query and direction)
        wg = torch.zeros_like(msg)
        for k in range(3):
            wg = torch.where((direction == k)[..., None], gt @ wdir[k].T,
                             wg)
        g_out = (msg * wg).sum(-1, keepdim=True)
    else:
        wg = gt
        g_out = (gt * (msg + bdir[direction])).sum(-1, keepdim=True)
    d_msg = alpha * wg * kf * (not kinks)
    d_hs, d_ra, d_qa, d_a1s, d_a2 = d_msg, None, None, None, None
    if ra is not None:
        dl = g_out * alpha * beta * kf
        dpre = dl * a2[:, 0] * mask
        d_hs = d_msg + dpre @ a1s.T
        if kinks:
            r, dl = torch.zeros_like(r), torch.zeros_like(dl)
        d_ra = _sum_by(dpre.sum(1), rel, ra.shape[0])
        d_qa = dpre.sum(0)
        d_a1s = torch.einsum("ebi,eba->ia", hs, dpre)
        d_a2 = torch.einsum("eba,eb->a", r, dl[..., 0])[:, None]
    am = alpha * kf * (not kinks)
    per_dir = [torch.where((direction == k)[..., None],
                           am * msg if wdir is not None else am, 0.0)
               for k in range(3)]
    if wdir is not None:
        d_wdir = torch.stack([torch.einsum(
            "vbi,vbj->ij", _sum_by(x, ttail, n), grad) for x in per_dir])
        d_bdir = None
    else:
        d_wdir = None
        d_bdir = torch.stack([(_sum_by(x, ttail, n) * grad).sum((0, 1))
                              for x in per_dir])
    return (_sum_by(d_hs, src, n), _sum_by(d_msg.sum(1), rel, rela.shape[0]),
            None if tt is None else _sum_by(d_msg, te, tt.shape[0]), d_ra,
            d_qa, d_a1s, d_a2, d_wdir, d_bdir)


U32 = 2.0 ** -24  # float32's unit roundoff


def _kink(pre, pre_abs):
    """Where a float32 evaluation of ``pre`` (the attention's
    pre-activation, a sum of at most 66 products) may fall on the other
    side of 0 than the exact value: |pre| within 1e-5 of the sum of its
    terms' absolute values. There relu's derivative may flip, and a
    gradient's error is a whole term, not a rounding."""
    return pre.abs() <= 1e-5 * pre_abs


def bwd_term_counts(kind: str, tsrc, trel, ttime, b: int, n: int, r: int,
                    n_time: int | None, plan: dict | None = None):
    """m of `bwd_bound` for each gradient of the plain backward's tuple
    (temporal, or static's): the most (edge, query) terms that one of its
    elements sums (a count a row where the sum is by an index). The
    parameters' sums (each element over every pair, or every edge: a
    single count) take the ``plan``'s ``chain`` where a plan is given (the
    wrapper's ``.plan`` after the launch checked: the most additions their
    terms pass through in the kernel's order), else the count of their
    terms: the bound of a sum in any order."""
    e = tsrc.shape[0]
    by_src = torch.bincount(tsrc.long(), minlength=n)[:, None, None]
    by_rel = (torch.bincount(trel.long(), minlength=r) * b)[:, None]

    def whole(terms):
        if plan is not None:
            terms = min(terms, plan["chain"])
        return torch.tensor(terms, device=tsrc.device)

    pairs = whole(e * b)
    if kind == "static":
        return (by_src, by_rel, by_rel, whole(e), pairs, pairs, pairs)
    by_time = (None if n_time is None else
               torch.bincount(ttime.long(), minlength=n_time)[:, None, None])
    return (by_src, by_rel, by_time, by_rel, whole(e), pairs, pairs, pairs,
            pairs)


BWD_SCALE = 1e-4  # the parameters' sums: error a share of their largest


def bwd_shares(got, want, s_abs, m, plain, kinks=None) -> list:
    """The share of the float64 check's bound that each of a backward's
    gradients reaches (None where the gradient is None), the dense hop
    forward's rule per element: |got - want| <= (1e-5 + 2 (m - 1) u)
    sum|x| + 2 |plain - want|, ``want`` the plain backward in float64,
    ``s_abs`` its ``absolute`` run (every product's factors taken by
    absolute value: the a-priori bound of a float32 evaluation in any
    order), ``plain`` its float32 run on the same inputs, ``m``
    `bwd_term_counts`. The 1e-5 covers the rounding inside a pair's term
    (sums of at most 66 products through the attention and the
    transform), 2 (m - 1) u a float32 sum whose terms pass through at most
    m - 1 additions. ``kinks`` (the plain backward's ``kinks`` run in
    float64) adds the whole of every term whose relu mask a float32
    evaluation may flip. Below float32's normal range the relative terms
    mean nothing (a gradient of 3e-45 is 2 subnormal steps), so each of
    the m terms may also be off by ETA32, float32's least normal number.
    A parameters' sum (m a single count) is also held to its scale:
    |got - want| <= `BWD_SCALE` max|want| + 2 |plain - want| (+ kinks),
    since its terms cancel, and sum|x| lets a lost share of the terms
    through; its share is the larger of the two. Tests and the card's
    smoke run call it."""
    shares = []
    kinks = kinks if kinks is not None else [None] * len(got)
    for x, w, s, k, p, q in zip(got, want, s_abs, m, plain, kinks):
        if x is None:
            shares.append(None)
            continue
        slack = 2 * (p.double() - w).abs() + (0 if q is None else q)
        k = k.to(torch.float64)
        bound = ((1e-5 + 2 * torch.clamp(k - 1, min=0) * U32) * s + slack
                 + k * ETA32)
        diff = (x.double() - w).abs()
        if not diff.numel():
            shares.append(0.0)
            continue
        share = float((diff / torch.clamp(bound, min=1e-300)).max())
        if k.dim() == 0:
            scale = BWD_SCALE * w.abs().max() + slack
            share = max(share, float(
                (diff / torch.clamp(scale, min=1e-300)).max()))
        shares.append(share)
    return shares


def bwd_bound(got, want, s_abs, m, plain, kinks=None) -> float:
    """The largest of `bwd_shares`: at most 1 where every gradient holds."""
    return max([0.0] + [x for x in bwd_shares(got, want, s_abs, m, plain,
                                              kinks) if x is not None])


PLAN_KEYS = ("out", "partial", "scratch", "warps", "blocks_x", "chain")


def _bwd_plan(name: str, *shape) -> dict:
    """The backward kernel's launch plan for ``shape`` (the C entry
    ``<name>_plan``, csrc/dense_hop_bwd.cuh:make_plan, the one the launch
    itself follows): the floats of its parameters' sums, its blocks'
    partial sums and its warps' scratch, its warps a block and blocks a
    query group, and ``chain``, the most float32 additions that a term of
    a parameter sum passes through (`bwd_term_counts`)."""
    i64 = ctypes.c_longlong
    fn = _build.entry(name, f"{name}_plan",
                      [i64] * 6 + [ctypes.c_int] * (len(shape) - 6)
                      + [ctypes.POINTER(i64)])
    out = (i64 * len(PLAN_KEYS))()
    err = fn(*shape, out)
    if err != 0:
        raise RuntimeError(f"{name}: no launch plan for {shape}: cudaError "
                           f"{err}")
    return dict(zip(PLAN_KEYS, out))


def _bwd_buffers(e, b, d, a, dev, dmsg: bool, plan: dict):
    """The backward kernel's outputs and scratch: d_hs (E, b, d), d_msg
    (E, b, d) or None, the per-edge rows (groups, E, d + A), then the
    parameters' sums, the blocks' partial sums and the warps' global
    scratch, as many floats as ``plan`` says."""
    groups = -(-b // 32)
    f32 = torch.float32
    return (torch.empty((e, b, d), dtype=f32, device=dev),
            torch.empty((e, b, d), dtype=f32, device=dev) if dmsg else None,
            torch.empty((groups, e, d + a), dtype=f32, device=dev),
            *(torch.empty(max(1, plan[k]), dtype=f32, device=dev)
              for k in ("out", "partial", "scratch")))


def _edge_rows_by_relation(erow, trel, rows: int):
    """The per-edge rows of every query group summed by relation
    (`ops.gather.scatter_rows_add`: the take_rows_grad kernel)."""
    groups, e, w = erow.shape
    idx = trel if groups == 1 else trel.repeat(groups)
    return gather.scatter_rows_add(erow.view(groups * e, w), idx, rows)


def _need_lists(name, *lists):
    _require(all(t is not None for t in lists),
             f"{name} on a CUDA device needs the graph's lists (tsrc_order "
             f"and rowptr; the time list with a time term): build it with "
             f"DeviceGraph.from_csr or TemporalKG")


def dense_hop_static_bwd(g, hidden, visited, rela, tsrc, trel, ttail,
                         tail_rowptr, item_ptr, wr, wq, ws, w_alpha, b_alpha,
                         tsrc_order, rowptr):
    """The static dense hop's backward: from ``g`` (N, b, d), the
    cotangent of `dense_hop_static`'s sum, the gradients (d_hidden (N, b,
    d), d_rela (R, d), d_wr (R, A), d_wq (b, A), d_ws (A, d), d_w_alpha
    (A,), d_b_alpha (1,)) of its float inputs, float32 (hidden and rela as
    the forward takes them, float32 or bfloat16 tables). A CUDA tensor
    launches ``csrc/dense_hop_static_bwd.cu``
    (``dense_hop_static_bwd.launches``), then sums its per-pair rows by
    source (`list_sum` over ``tsrc_order`` and the CSR's ``rowptr``) and
    its per-edge rows by relation (`scatter_rows_add`); a CPU tensor takes
    `dense_hop_static_bwd_plain`."""
    if hidden.device.type == "cpu":
        return dense_hop_static_bwd_plain(g, hidden, visited, rela, tsrc,
                                          trel, ttail, wr, wq, ws, w_alpha,
                                          b_alpha)
    name = "dense_hop_static_bwd"
    n, b, d, a = check_static_inputs(hidden, visited, rela, tsrc, trel,
                                     tail_rowptr, item_ptr, wr, wq, ws,
                                     w_alpha, b_alpha)
    dev, e, r = hidden.device, tsrc.shape[0], rela.shape[0]
    _check_tensors(name, dev, [("g", g, torch.float32, (n, b, d))])
    _need_lists(name, tsrc_order, rowptr)
    if n == 0 or b == 0 or e == 0:
        dense_hop_static_bwd.plan = None
        z = torch.zeros
        return (z((n, b, d), device=dev), z((r, d), device=dev),
                z((r, a), device=dev), z((b, a), device=dev),
                z((a, d), device=dev), z(a, device=dev), z(1, device=dev))
    n_param, items = d * a + a + 1, n + e // EDGE_CHUNK
    plan = _bwd_plan(name, b, d, a, EDGE_CHUNK, items, r,
                     int(hidden.dtype == torch.bfloat16))
    _require(plan["out"] == n_param + b * a,
             f"{name}: the kernel's plan sums {plan['out']} floats, not "
             f"{n_param + b * a}")
    dhs, _, erow, out, partial, scratch = _bwd_buffers(e, b, d, a, dev,
                                                       False, plan)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.entry(name, name, [p, p, ctypes.c_int] + [p] * 16
                      + [i64] * 8 + [p])
    _build.launch(fn, (
        g.data_ptr(), hidden.data_ptr(), int(hidden.dtype == torch.bfloat16),
        visited.data_ptr(), rela.data_ptr(), tsrc.data_ptr(),
        trel.data_ptr(), tail_rowptr.data_ptr(), item_ptr.data_ptr(),
        wr.data_ptr(), wq.data_ptr(), ws.data_ptr(), w_alpha.data_ptr(),
        b_alpha.data_ptr(), dhs.data_ptr(), erow.data_ptr(),
        partial.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, b, d, a,
        EDGE_CHUNK, items, r, e), hidden,
        f"{name} (N={n}, b={b}, d={d}, A={a}, E={e})")
    dense_hop_static_bwd.launches += 1
    dense_hop_static_bwd.plan = plan
    d_hidden = gather.list_sum(dhs.view(e, b * d), tsrc_order, rowptr)
    er = _edge_rows_by_relation(erow, trel, r)
    return (d_hidden.view(-1, b, d), er[:, :d], er[:, d:],
            out[n_param:].view(b, a), out[:d * a].view(d, a).T,
            out[d * a:d * a + a], out[d * a + a:n_param])


dense_hop_static_bwd.launches = 0
dense_hop_static_bwd.plan = None  # the last call's `_bwd_plan`


def dense_hop_temporal_bwd(g_h, h, new_visited, hidden, visited, rela, tsrc,
                           trel, ttime, ttail, tail_rowptr, item_ptr, times,
                           excl_keep, edge_keep, tt, ra, qa, a1s, a2, wdir,
                           bdir, drop_keep, dropout: float, act: str,
                           tsrc_order, rowptr, time_order, time_off):
    """The temporal dense hop's backward: from ``g_h`` (N, b, d), the
    cotangent of `dense_hop_temporal`'s output ``h`` (with its
    ``new_visited``), the gradients (d_hidden, d_rela, d_tt, d_ra, d_qa,
    d_a1s, d_a2, d_wdir, d_bdir) of its float inputs, None where the input
    is None. A CUDA tensor launches ``csrc/dense_hop_temporal_bwd.cu``
    (``dense_hop_temporal_bwd.launches``), then sums its per-pair rows by
    source (`list_sum` over ``tsrc_order`` and ``rowptr``) and by time id
    (over ``time_order`` and ``time_off``, the graph's time list) and its
    per-edge rows by relation (`scatter_rows_add`); a CPU tensor takes
    `dense_hop_temporal_bwd_plain`."""
    if hidden.device.type == "cpu":
        return dense_hop_temporal_bwd_plain(
            g_h, h, new_visited, hidden, visited, rela, tsrc, trel, ttime,
            ttail, times, excl_keep, edge_keep, tt, ra, qa, a1s, a2, wdir,
            bdir, drop_keep, dropout, act)
    name = "dense_hop_temporal_bwd"
    n, b, d, a = check_temporal_inputs(
        hidden, visited, rela, tsrc, trel, ttime, tail_rowptr, item_ptr,
        times, excl_keep, edge_keep, tt, ra, qa, a1s, a2, wdir, bdir,
        drop_keep)
    dev, e, r = hidden.device, tsrc.shape[0], rela.shape[0]
    f32, boolean = torch.float32, torch.bool
    _check_tensors(name, dev, [("g_h", g_h, f32, (n, b, d)),
                               ("h", h, f32, (n, b, d)),
                               ("new_visited", new_visited, boolean, (n, b))])
    _need_lists(name, tsrc_order, rowptr,
                *((time_order, time_off) if tt is not None else ()))
    if tt is not None:
        _require(time_off.shape[0] == tt.shape[0] + 1,
                 f"{name}: the time list has {time_off.shape[0] - 1} time "
                 f"ids, tt {tt.shape[0]}")
    linear = wdir is not None
    if n == 0 or b == 0 or e == 0:
        dense_hop_temporal_bwd.plan = None
        zero = [None if x is None else torch.zeros_like(x) for x in (
            hidden, rela, tt, ra, qa, a1s, a2, wdir, bdir)]
        return tuple(zero)
    w_size = 3 * d * d if linear else 3 * d
    n_param, items = d * a + a + w_size, n + e // EDGE_CHUNK
    plan = _bwd_plan(name, b, d, a, EDGE_CHUNK, items, r, int(tt is not None),
                     int(ra is not None), int(linear))
    _require(plan["out"] == n_param + b * a,
             f"{name}: the kernel's plan sums {plan['out']} floats, not "
             f"{n_param + b * a}")
    dhs, dmsg, erow, out, partial, scratch = _bwd_buffers(
        e, b, d, a, dev, tt is not None, plan)
    p, i64, c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _build.entry(name, name, [p] * 28 + [ctypes.c_float, c_int]
                      + [i64] * 8 + [c_int] * 3 + [p])
    _build.launch(fn, (
        g_h.data_ptr(), h.data_ptr(), new_visited.data_ptr(),
        _ptr(drop_keep), hidden.data_ptr(), visited.data_ptr(),
        rela.data_ptr(), tsrc.data_ptr(), trel.data_ptr(), ttime.data_ptr(),
        tail_rowptr.data_ptr(), item_ptr.data_ptr(), times.data_ptr(),
        _ptr(excl_keep), _ptr(edge_keep), _ptr(tt), _ptr(ra), _ptr(qa),
        None if ra is None else a1s.data_ptr(),
        None if ra is None else a2.data_ptr(), _ptr(wdir), _ptr(bdir),
        dhs.data_ptr(), _ptr(dmsg), erow.data_ptr(), partial.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), float(1.0 - dropout),
        ACTS[act][0], n, b, d, a,
        EDGE_CHUNK, items, r, e, int(tt is not None),
        int(ra is not None), int(linear)), hidden,
        f"{name} (N={n}, b={b}, d={d}, A={a}, E={e})")
    dense_hop_temporal_bwd.launches += 1
    dense_hop_temporal_bwd.plan = plan
    d_hidden = gather.list_sum(dhs.view(e, b * d), tsrc_order, rowptr)
    d_tt = (None if tt is None else
            gather.list_sum(dmsg.view(e, b * d), time_order, time_off).view(
                tt.shape))
    er = _edge_rows_by_relation(erow, trel, r)
    w = out[d * a + a:n_param]
    return (d_hidden.view(-1, b, d), er[:, :d], d_tt,
            None if ra is None else er[:, d:],
            None if ra is None else out[n_param:].view(b, a),
            None if ra is None else out[:d * a].view(d, a),
            None if ra is None else out[d * a:d * a + a].view(a, 1),
            w.view(3, d, d) if linear else None,
            None if linear else w.view(3, d))


dense_hop_temporal_bwd.launches = 0
dense_hop_temporal_bwd.plan = None  # the last call's `_bwd_plan`


def _grad_flows(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _StaticHop(torch.autograd.Function):
    """`dense_hop_static` forward, `dense_hop_static_bwd` backward. The
    state and relation table come in float32 and are cast to the compute
    dtype here, so their gradients are the backward's float32 sums."""

    @staticmethod
    def forward(ctx, hidden, rela, wr, wq, ws, w_alpha, b_alpha, visited,
                tsrc, trel, ttail, tail_rowptr, item_ptr, tsrc_order, rowptr,
                dense_agg, dtype):
        agg, new_visited, n_live = dense_hop_static(
            hidden.to(dtype), visited, rela.to(dtype), tsrc, trel, ttail,
            tail_rowptr, wr, wq, ws, w_alpha, b_alpha, dense_agg, item_ptr)
        ctx.save_for_backward(hidden, rela, wr, wq, ws, w_alpha, b_alpha,
                              visited, tsrc, trel, ttail, tail_rowptr,
                              item_ptr, tsrc_order, rowptr)
        ctx.dtype = dtype
        ctx.mark_non_differentiable(new_visited, n_live)
        return agg, new_visited, n_live

    @staticmethod
    def backward(ctx, g, *_):
        (hidden, rela, wr, wq, ws, w_alpha, b_alpha, visited, tsrc, trel,
         ttail, tail_rowptr, item_ptr, tsrc_order,
         rowptr) = ctx.saved_tensors
        grads = dense_hop_static_bwd(
            g.contiguous(), hidden.to(ctx.dtype), visited, rela.to(ctx.dtype),
            tsrc, trel, ttail, tail_rowptr, item_ptr, wr, wq, ws, w_alpha,
            b_alpha, tsrc_order, rowptr)
        return ((grads[0].to(hidden.dtype), grads[1].to(rela.dtype))
                + tuple(grads[2:]) + (None,) * 10)


def dense_hop_static_fn(hidden, visited, rela, tsrc, trel, ttail,
                        tail_rowptr, wr, wq, ws, w_alpha, b_alpha,
                        dense_agg: str, item_ptr, tsrc_order=None,
                        rowptr=None, dtype=None):
    """`dense_hop_static` on ``hidden`` and ``rela`` cast to ``dtype``
    (None: rela's own), differentiable in hidden, rela, wr, wq, ws,
    w_alpha and b_alpha through `dense_hop_static_bwd` (which needs the
    graph's ``tsrc_order`` and ``rowptr`` on a CUDA device)."""
    if hidden.device.type != "cpu" and _grad_flows(
            hidden, rela, wr, wq, ws, w_alpha, b_alpha):
        _need_lists("dense_hop_static_fn", tsrc_order, rowptr)
    return _StaticHop.apply(hidden, rela, wr, wq, ws, w_alpha, b_alpha,
                            visited, tsrc, trel, ttail, tail_rowptr,
                            item_ptr, tsrc_order, rowptr, dense_agg,
                            rela.dtype if dtype is None else dtype)


class _TemporalHop(torch.autograd.Function):
    """`dense_hop_temporal` forward, `dense_hop_temporal_bwd` backward;
    the backward reads the forward's output h and visited set, saved
    here, and recomputes every per-pair term."""

    @staticmethod
    def forward(ctx, hidden, rela, tt, ra, qa, a1s, a2, wdir, bdir, visited,
                tsrc, trel, ttime, ttail, tail_rowptr, item_ptr, times,
                excl_keep, edge_keep, drop_keep, dropout, act, dense_agg,
                tsrc_order, rowptr, time_order, time_off):
        h, new_visited, n_nodes, n_edges = dense_hop_temporal(
            hidden, visited, rela, tsrc, trel, ttime, ttail, tail_rowptr,
            times, excl_keep, edge_keep, tt, ra, qa, a1s, a2, wdir, bdir,
            drop_keep, dropout, act, dense_agg, item_ptr)
        ctx.save_for_backward(hidden, rela, tt, ra, qa, a1s, a2, wdir, bdir,
                              visited, tsrc, trel, ttime, ttail, tail_rowptr,
                              item_ptr, times, excl_keep, edge_keep,
                              drop_keep, tsrc_order, rowptr, time_order,
                              time_off, h, new_visited)
        ctx.dropout, ctx.act = dropout, act
        ctx.mark_non_differentiable(new_visited, n_nodes, n_edges)
        return h, new_visited, n_nodes, n_edges

    @staticmethod
    def backward(ctx, g_h, *_):
        (hidden, rela, tt, ra, qa, a1s, a2, wdir, bdir, visited, tsrc, trel,
         ttime, ttail, tail_rowptr, item_ptr, times, excl_keep, edge_keep,
         drop_keep, tsrc_order, rowptr, time_order, time_off, h,
         new_visited) = ctx.saved_tensors
        grads = dense_hop_temporal_bwd(
            g_h.contiguous(), h, new_visited, hidden, visited, rela, tsrc,
            trel, ttime, ttail, tail_rowptr, item_ptr, times, excl_keep,
            edge_keep, tt, ra, qa, a1s, a2, wdir, bdir, drop_keep,
            ctx.dropout, ctx.act, tsrc_order, rowptr, time_order, time_off)
        return tuple(grads) + (None,) * 18


def dense_hop_temporal_fn(hidden, visited, rela, tsrc, trel, ttime, ttail,
                          tail_rowptr, times, excl_keep, edge_keep, tt, ra,
                          qa, a1s, a2, wdir, bdir, drop_keep, dropout: float,
                          act: str, dense_agg: str, item_ptr, tsrc_order=None,
                          rowptr=None, time_order=None, time_off=None):
    """`dense_hop_temporal` (same arguments), differentiable in hidden,
    rela, tt, ra, qa, a1s, a2, wdir and bdir through
    `dense_hop_temporal_bwd` (which needs the graph's ``tsrc_order`` and
    ``rowptr``, and with a time term its time list, on a CUDA
    device)."""
    if hidden.device.type != "cpu" and _grad_flows(
            hidden, rela, tt, ra, qa, a1s, a2, wdir, bdir):
        _need_lists("dense_hop_temporal_fn", tsrc_order, rowptr,
                    *((time_order, time_off) if tt is not None else ()))
    return _TemporalHop.apply(hidden, rela, tt, ra, qa, a1s, a2, wdir, bdir,
                              visited, tsrc, trel, ttime, ttail, tail_rowptr,
                              item_ptr, times, excl_keep, edge_keep,
                              drop_keep, dropout, act, dense_agg, tsrc_order,
                              rowptr, time_order, time_off)
