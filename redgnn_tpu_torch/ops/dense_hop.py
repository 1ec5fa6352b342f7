"""The dense hop's forward as one kernel per model.

A dense hop runs one propagation step over the whole tail-sorted edge
table, shared by a batch of ``b`` queries (the saturated-frontier regime
of `models/layers.py:RelAttnLayer.dense` and
`models/temporal.py:TRedGNN._dense_hop`). Its autograd route gathers the
(N, b, d) state per edge and builds every (E, b, d) intermediate in device
memory. With gradients off the models call the two functions here
instead:

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
function in the kernel's factoring. The terms that depend on fewer
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


def grad_free(*tensors: torch.Tensor) -> bool:
    """True when no gradient can flow: gradients are off, or none of
    ``tensors`` (a hop's inputs and parameters) requires one. The models
    take the fused function exactly then."""
    return not torch.is_grad_enabled() or not any(
        t is not None and t.requires_grad for t in tensors)


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
