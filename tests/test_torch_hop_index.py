"""The hop's two index primitives on the CPU, against the JAX package: the
owner of each expansion slot (`ops.frontier.slot_owner`) and the dense
hop's packed-row gather with its listed backward
(`ops.gather.gather_rows_listed`, `list_sum`).

Both have a hand-written kernel on a CUDA device (``csrc/slot_owner.cu``,
``csrc/list_sum.cu``; tests/test_torch_cuda.py holds them to their plain
twins there). Here the wrappers take their plain versions:
`slot_owner_plain` (``torch.searchsorted``) and ``index_put_``, so the
launch counters must not move.

What is held:
- `slot_owner_plain` bit-equal to the JAX package's scatter-and-cummax
  route (`slot_owner_cummax`) and to ``src`` of JAX's
  ``expand_frontier_ranges``: random degrees, all zero, a hub, overflow,
  ``extra_edge_slot``.
- `slot_owner_runs` (the kernel's partition: runs of 4 slots a thread,
  1,024 slots a block, a search a run and a bounded walk) equal to
  ``torch.searchsorted`` on those frontiers and on long runs of
  zero-degree nodes, where the walk runs out and searches again; the
  kernel's block count a function of edge_cap alone.
- `graph.kg.build_src_order` with the CSR's ``rowptr`` lists every edge in
  its source's row exactly once, for the static and temporal graphs.
- `list_sum_model` (the kernel's order) within rtol 1e-5 + 2(m-1)u·sum|x|
  of float64 (u = 2^-24, m terms in a cell: the rounding bound of a
  float32 sum in any order) at the 7a dense hop's width W = 672 with a
  hub row and empty rows, and at the umls dense hop's list and width
  (7,959 positions, W = 980) with empty rows at both ends; on multiples
  of 1/8, float64's bits. The launch plan (`_list_plan`) is a function
  of shapes alone, its blocks, warp shares and column tiles cover the
  list and the row exactly once, and a warp's ring fits its floats.
- `gather_rows_listed`'s CPU backward against JAX's VJP of
  ``packed[tsrc]`` within rtol 1e-5, float32 and bf16. The bf16 case is
  jitted with ``xla_allow_excess_precision`` off (tests/test_torch_bf16.py
  says why) and takes cotangents in multiples of 1/4 of at most 2, so
  that JAX's bf16 sums are exact and equal the port's float32 sums (on
  other inputs JAX's bf16 sums stall: tests/test_torch_bf16.py).
- One static dense hop (`RelAttnLayer.dense`) and one temporal model with
  a dense hop, forward and gradients against JAX on the same weights
  (params_from_flax): outputs atol 1e-5, gradients rtol 1e-4 +
  1e-5·max|grad|, the tolerances of tests/test_torch_model.py and
  tests/test_torch_temporal.py.

Time: about 20 s of one xdist worker (the JAX model's compile and its
gradient take most of it).
"""

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
from redgnn_tpu.ops import frontier as jfrontier
from redgnn_tpu_torch.graph import kg as tkg
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.models import layers as tlayers
from redgnn_tpu_torch.models import temporal as ttm
from redgnn_tpu_torch.ops import frontier as tfrontier
from redgnn_tpu_torch.ops import gather as tg
from redgnn_tpu_torch.ops.frontier import SENTINEL
from redgnn_tpu_torch.utils.port_params import params_from_flax

from test_torch_model import A, D, N_ENT, N_REL, make_csr
from test_torch_temporal import (  # noqa: F401 (vocab_dir is a fixture)
    B,
    _loss,
    jax_apply,
    model_case,
    port_apply,
    port_model,
    vocab_dir,
)

U = 2.0 ** -24


# ------------------------------------------------------------ slot owners

def _ranges_case(rng, kind):
    """(node_keys, row_start, deg, extra_edge_slot, edge_cap, n_ent,
    n_edges, B) of one expansion: a frontier of 24 slots with SENTINEL
    pads, each node a sub-range of a 4,000-edge table."""
    n_ent, b, prev_cap, n_edges = 50, 3, 24, 4_000
    n_valid = 17
    keys = np.sort(rng.choice(b * n_ent, n_valid, replace=False))
    node_keys = np.full(prev_cap, SENTINEL, np.int64)
    node_keys[:n_valid] = keys
    deg = np.zeros(prev_cap, np.int64)
    deg[:n_valid] = rng.integers(0, 7, n_valid)
    deg[:n_valid][rng.random(n_valid) < 0.3] = 0
    extra = None
    if kind == "zero":
        deg[:] = 0
    elif kind == "hub":
        deg[5] = 3_210
    elif kind == "extra":
        extra = rng.integers(0, n_edges, prev_cap)
    row_start = rng.integers(0, n_edges - 3_300, prev_cap)
    total = int(deg.sum()) + (n_valid if extra is not None else 0)
    edge_cap = {"overflow": max(total // 2, 1), "zero": 16}.get(
        kind, total + 9)
    return node_keys, row_start, deg, extra, edge_cap, n_ent, n_edges, b


@pytest.mark.parametrize("kind", ["random", "zero", "hub", "overflow",
                                  "extra"])
def test_slot_owner_matches_cummax_and_jax(rng, kind):
    """The owner of every slot, by search (`slot_owner_plain`, the CPU
    path of `slot_owner`), equals the scatter-and-cummax route and the
    ``src`` of JAX's ``expand_frontier_ranges`` (bitmap dedup keeps the
    expansion order), bit for bit, and so does the port's expansion."""
    (node_keys, row_start, deg, extra, edge_cap, n_ent, n_edges,
     b) = _ranges_case(rng, kind)
    erel = rng.integers(0, 5, n_edges)
    etail = rng.integers(0, n_ent, n_edges)
    valid = node_keys != SENTINEL
    deg_eff = deg + (valid if extra is not None else 0)
    cum = torch.from_numpy(np.cumsum(deg_eff).astype(np.int64))
    before = tfrontier.slot_owner.launches
    got = tfrontier.slot_owner(cum, edge_cap)
    assert got.dtype == torch.int64 and got.shape == (edge_cap,)
    assert torch.equal(got, tfrontier.slot_owner_plain(cum, edge_cap))
    assert torch.equal(got, tfrontier.slot_owner_cummax(cum, edge_cap))
    assert tfrontier.slot_owner.launches == before

    i32 = lambda a: jnp.asarray(np.asarray(a, np.int32))  # noqa: E731
    args = (n_ent, i32(node_keys), i32(row_start), i32(deg), edge_cap, 64)
    kw = dict(extra_edge_slot=None if extra is None else i32(extra),
              dedup_impl="bitmap", key_space=b * n_ent)
    want = jfrontier.expand_frontier_ranges(i32(erel), i32(etail), *args,
                                            **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.src))
    t64 = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    fr = tfrontier.expand_frontier_ranges(
        t64(erel), t64(etail), n_ent, t64(node_keys).int(), t64(row_start),
        t64(deg), edge_cap, 64,
        extra_edge_slot=None if extra is None else t64(extra),
        dedup_impl="bitmap", key_space=b * n_ent)
    np.testing.assert_array_equal(fr.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(fr.edge_valid.numpy(),
                                  np.asarray(want.edge_valid))


def _zero_run_cum(rng):
    """A 20,000-node frontier: Zipf degrees, zero-degree runs of 3,000 at
    the start and 5,000 in the middle, 4,000 SENTINEL pads at the end."""
    deg = np.minimum(rng.zipf(1.5, 20_000), 500)
    deg[:3_000] = 0
    deg[9_000:14_000] = 0
    deg[-4_000:] = 0
    return torch.from_numpy(np.cumsum(deg).astype(np.int64))


@pytest.mark.parametrize("kind", ["random", "zero", "hub", "overflow",
                                  "extra", "zero_run"])
def test_slot_owner_runs_match_searchsorted(rng, kind):
    """The kernel's partition in plain PyTorch (`slot_owner_runs`: a
    search a run of slots inside its block's bracket, then a walk of at
    most 8 steps before it searches again) gives searchsorted's owners on
    the expansion frontiers above and on long runs of zero-degree nodes
    (where walks run out: searched again) at several edge caps, ragged
    and odd among them; its blocks cover the slots once."""
    if kind == "zero_run":
        cum = _zero_run_cum(rng)
        total = int(cum[-1])
        caps = [total // 2 + 1, total, total + 4_097]
    else:
        _, _, deg, extra, edge_cap, *_ = _ranges_case(rng, kind)
        deg = deg + (extra is not None)
        cum = torch.from_numpy(np.cumsum(deg).astype(np.int64))
        caps = [edge_cap, 2 * edge_cap + 1]
    searched = 0
    for cap in caps:
        got, n_search = tfrontier.slot_owner_runs(cum, cap)
        assert torch.equal(got, tfrontier.slot_owner_plain(cum, cap)), cap
        searched += n_search
        blocks, block = tfrontier._owner_blocks(cap), tfrontier.OWNER_BLOCK
        assert (blocks - 1) * block < cap <= blocks * block
    if kind == "zero_run":
        assert searched > 0
    assert tfrontier.slot_owner_runs(cum, 0)[0].shape == (0,)
    one = torch.tensor([7], dtype=torch.int64)  # P = 1
    assert torch.equal(tfrontier.slot_owner_runs(one, 9)[0],
                       torch.zeros(9, dtype=torch.int64))


def test_slot_owner_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="int64"):
        tfrontier.slot_owner(torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="non-empty"):
        tfrontier.slot_owner(torch.zeros(0, dtype=torch.int64), 4)


# ---------------------------------------------------- the sources' order

def _assert_rows_list_sources(tsrc, order, rowptr):
    """order is a permutation of the edges; row v of it (rowptr) holds
    exactly the edges whose source is v, in table order."""
    tsrc, order, rowptr = (np.asarray(a) for a in (tsrc, order, rowptr))
    assert order.dtype == np.int32
    assert np.array_equal(np.sort(order), np.arange(tsrc.shape[0]))
    assert rowptr[0] == 0 and rowptr[-1] == tsrc.shape[0]
    rows = np.repeat(np.arange(rowptr.shape[0] - 1), np.diff(rowptr))
    np.testing.assert_array_equal(tsrc[order], rows)
    same = rows[1:] == rows[:-1]
    assert bool(np.all(order[1:][same] > order[:-1][same]))  # stable


def test_src_order_static(rng):
    """The static graph: ``from_csr`` sets ``tsrc_order`` to
    `build_src_order` of its tail-sorted sources, whose rows are the
    CSR's ``rowptr``; ``to()`` carries it."""
    w = 1.0 / np.arange(1, N_ENT + 1)  # Zipf(1) heads: a hub source
    h = rng.choice(N_ENT, 400, p=w / w.sum())
    tri = np.stack([h, rng.integers(0, 2 * N_REL, 400),
                    rng.integers(0, N_ENT, 400)], 1)
    csr = tkg.build_csr(tri, N_ENT)
    g = tkg.DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    np.testing.assert_array_equal(g.tsrc_order.numpy(),
                                  tkg.build_src_order(g.tsrc.numpy()))
    _assert_rows_list_sources(g.tsrc, g.tsrc_order, g.rowptr)
    assert torch.equal(g.to("cpu").tsrc_order, g.tsrc_order)


def test_src_order_temporal(vocab_dir):
    """The temporal graph: ``kg.graph.tsrc_order`` lists the dense
    table's sources (``dense_np[0]``, JAX's, unchanged) by the (head,
    time)-sorted CSR's ``rowptr``."""
    kg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
    jkg = JKG.load_vocab_dir(vocab_dir)
    for got, want in zip(kg.dense_np, jkg.dense_np):
        np.testing.assert_array_equal(got, want)
    _assert_rows_list_sources(kg.dense_np[0], kg.graph.tsrc_order,
                              kg.graph.rowptr)


# ------------------------------------------------------------- list sums

def _list_case(rng, e=12_000, n=300, w=672, hub=9_000):
    """(g, order, off): E positions in N rows, a third of them empty and
    the first and last three too, one hub of ``hub`` positions (past 16
    blocks: every level of the share pass's order), a random permutation
    as the list."""
    live = np.flatnonzero(rng.random(n) < 0.67)
    live = live[(live >= 3) & (live < n - 3)]
    cnt = np.bincount(rng.choice(live, e - hub), minlength=n)
    cnt[7] += hub
    off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    order = rng.permutation(e).astype(np.int32)
    g = rng.normal(size=(e, w)).astype(np.float32)
    return (torch.from_numpy(g), torch.from_numpy(order),
            torch.from_numpy(off))


def _bound(got, want, s_abs, m):
    """|got - want| <= 1e-5 |want| + 2 (m - 1) u sum|x| per cell."""
    m = m.to(torch.float64)[:, None]
    bound = 1e-5 * want.abs() + 2 * torch.clamp(m - 1, min=0) * U * s_abs
    diff = (got.double() - want).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())


def test_list_model_matches_float64(rng):
    """The kernel's order in plain PyTorch at W = 672 (`list_sum_model`:
    the listed rows in list order, warp shares of the plan's 8 positions,
    block and group fix-ups) within the rounding bound of float64; empty
    rows 0; on multiples of 1/8 float64's bits. The CPU path (`list_sum`:
    ``index_put_``) within the same bound, the counter still."""
    g, order, off = _list_case(rng)
    plan = tg._list_plan(g.shape[0], off.shape[0] - 1, g.shape[1])
    assert plan == (672, 8, 188, 1, 1, 2)
    m = torch.diff(off.long())
    got = tg.list_sum_model(g, order, off)
    assert got.dtype == torch.float32 and got.shape == (300, 672)
    want = tg.list_sum_reference(g, order, off)
    s_abs = tg.list_sum_reference(g.abs(), order, off)
    _bound(got, want, s_abs, m)
    assert bool((got[m == 0] == 0).all()) and int((m == 0).sum()) > 50
    before = tg.list_sum.launches
    _bound(tg.list_sum(g, order, off), want, s_abs, m)
    assert tg.list_sum.launches == before
    dyadic = torch.from_numpy(
        (rng.integers(-64, 64, size=tuple(g.shape)) / 8).astype(np.float32))
    assert torch.equal(tg.list_sum_model(dyadic, order, off).double(),
                       tg.list_sum_reference(dyadic, order, off))


def test_list_plan_depends_on_shapes_alone():
    """The plan reads (E, N, W) and nothing else; a block sums the dense
    hops' whole rows (one column tile at W = 672 and 980) through a ring
    of 2 rows a warp; 7a's list is one wave of 390 blocks of 49 positions
    a warp, umls's 125 blocks of 8 (the least share); the kernel's int32
    reach bounds it."""
    import inspect

    assert list(inspect.signature(tg._list_plan).parameters) == \
        ["e", "n", "w"]
    assert list(inspect.signature(tg.list_share).parameters) == ["e"]
    plan = tg._list_plan(152_780, 7_128, 672)
    assert plan == (672, 49, 390, 1, 1, 2)
    assert all(type(v) is int for v in plan)
    assert tg._list_plan(7_959, 135, 980) == (980, 8, 125, 1, 1, 2)
    assert tg._list_plan(2 ** 31, 5, 8) is None
    assert tg._list_plan(5, 2 ** 31, 8) is None


@pytest.mark.parametrize("e", [1, 3, 500, 7_959, 12_000, 152_780,
                               1_048_576, 2 ** 31 - 1])
@pytest.mark.parametrize("w", [1, 20, 33, 672, 980, 1_024, 2_450])
def test_list_plan_covers_the_list_once(e, w):
    """Blocks of SHARE_WARPS warps of ``share`` positions cover the E
    positions once (the last block ragged), tiles of ``tile`` columns
    cover the row once; the share is the fewest positions (at most
    LIST_MAX_SHARE) that cut the list into whole waves of
    LIST_WAVE_BLOCKS blocks, or LIST_MIN_SHARE; a warp's floats hold its
    head row and a ring of two stages or more."""
    plan = tg._list_plan(e, 9, w)
    block = tg.SHARE_WARPS * plan.share
    assert (plan.blocks - 1) * block < e <= plan.blocks * block
    assert (plan.tiles - 1) * plan.tile < w <= plan.tiles * plan.tile
    assert plan.tile <= tg.LIST_MAX_TILE
    assert plan.tiles == 1 or plan.tile % 4 == 0
    share, wave = plan.share, tg.LIST_WAVE_BLOCKS
    assert tg.LIST_MIN_SHARE <= share <= tg.LIST_MAX_SHARE
    waves = -(-plan.blocks // wave)
    assert waves == max(-(-e // (wave * tg.SHARE_WARPS * 64)), 1)
    assert share == tg.LIST_MIN_SHARE or \
        tg._blocks(e, share - 1) > waves * wave
    row = -(-plan.tile // 4) * 4
    assert 1 <= plan.stage_rows <= 32 and 2 <= plan.stages <= 8
    assert (plan.stages * plan.stage_rows + 1) * row <= \
        max(tg.LIST_RING_FLOATS, 3 * row)


def test_list_model_at_the_umls_plan(rng):
    """`list_sum_model` at the umls dense hop's list (7,959 positions into
    135 rows of W = 980, 2,000 of them in one hub, empty rows at both
    ends): the plan's 125 blocks of 8 positions a warp, 8 groups, within
    the rounding bound of float64; empty rows 0."""
    g, order, off = _list_case(rng, e=7_959, n=135, w=980, hub=2_000)
    m = torch.diff(off.long())
    assert int((m[:3] == 0).sum()) == 3 and int((m[-3:] == 0).sum()) == 3
    got = tg.list_sum_model(g, order, off)
    _bound(got, tg.list_sum_reference(g, order, off),
           tg.list_sum_reference(g.abs(), order, off), m)
    assert bool((got[m == 0] == 0).all())


def test_list_sum_refuses_what_it_does_not_take():
    g = torch.zeros(6, 3)
    with pytest.raises(ValueError, match="list sum"):
        tg.list_sum(g, torch.zeros(5, dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="list sum"):
        tg.list_sum(g, torch.zeros(6, dtype=torch.int32),
                    torch.zeros(0, dtype=torch.int32))
    # a CUDA-side call without the list raises (a meta tensor stands in)
    table = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="tsrc_order"):
        tg.gather_rows_listed(table, torch.zeros(5, dtype=torch.int64,
                                                 device="meta"), None, None)


# ------------------------------------------------ the listed gather's VJP

def _packed_case(rng, b=4, d=5):
    csr = make_csr(rng, n_edges=300)
    tsrc, _, _, _ = tkg.build_tail_sorted(*csr, N_ENT)
    packed = rng.normal(size=(N_ENT, b, d + 1)).astype(np.float32)
    return csr, tsrc, packed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_listed_gather_backward_matches_jax(rng, dtype):
    """``packed[tsrc]`` (bf16: rows of the bf16 copy) forward bit for bit
    and its CPU backward within rtol 1e-5 of JAX's VJP, the table's
    gradient float32; with and without the list (the CPU path does not
    read it)."""
    csr, tsrc, packed = _packed_case(rng)
    e = tsrc.shape[0]
    if dtype == "float32":
        w = rng.normal(size=(e,) + packed.shape[1:]).astype(np.float32)
    else:  # multiples of 1/4 up to 2: JAX's bf16 sums are exact
        w = (rng.integers(-8, 9, size=(e,) + packed.shape[1:]) / 4).astype(
            np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    idx = jnp.asarray(tsrc)

    def jgather_vjp(p, ct):
        rows, vjp = jax.vjp(lambda q: q.astype(jdt)[idx], p)
        return rows, vjp(ct)[0]

    want_rows, want = jax.jit(
        jgather_vjp, compiler_options={"xla_allow_excess_precision": False})(
        jnp.asarray(packed), jnp.asarray(w).astype(jdt))
    order = torch.from_numpy(tkg.build_src_order(tsrc))
    rowptr = torch.from_numpy(csr[0])
    tdt = getattr(torch, dtype)
    grads = []
    for lists in ((order, rowptr), (None, None)):
        t = torch.from_numpy(packed).requires_grad_()
        rows = tg.gather_rows_listed(t, torch.from_numpy(tsrc), *lists, tdt)
        assert rows.dtype == tdt
        np.testing.assert_array_equal(
            rows.detach().float().numpy(),
            np.asarray(want_rows.astype(jnp.float32)))
        rows.backward(torch.from_numpy(w).to(tdt))
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-5)
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


def test_listed_gather_keeps_a_float64_table(rng):
    """A float64 table (the CPU float64 referee's) is gathered and its
    gradient summed in float64, bit-equal to autograd of the plain
    gather, as before the listed gather: no float32 cast on the way."""
    csr, tsrc, packed = _packed_case(rng)
    w = torch.from_numpy(rng.normal(size=(tsrc.shape[0],) + packed.shape[1:]))
    got_t = torch.from_numpy(packed).double().requires_grad_()
    want_t = got_t.detach().clone().requires_grad_()
    rows = tg.gather_rows_listed(got_t, torch.from_numpy(tsrc),
                                 torch.from_numpy(tkg.build_src_order(tsrc)),
                                 torch.from_numpy(csr[0]))
    assert rows.dtype == torch.float64
    rows.backward(w)
    want_t[torch.from_numpy(tsrc).long()].backward(w)
    assert got_t.grad.dtype == torch.float64
    assert torch.equal(got_t.grad, want_t.grad)


# ------------------------------------------------------------ dense hops

def test_static_dense_hop_matches_jax(rng):
    """`RelAttnLayer.dense` in float32, through the listed gather, against
    JAX's on the same weights: output atol 1e-5, visited set and live
    count equal, gradients of the parameters and of the dense states
    within rtol 1e-4 + 1e-5·max|grad|."""
    csr = make_csr(rng)
    b = 3
    vis = rng.random((N_ENT, b)) < 0.4
    hd = (rng.normal(size=(N_ENT, b, D)) * vis[..., None]).astype(np.float32)
    q_rel = rng.integers(0, 2 * N_REL, b).astype(np.int32)
    w = rng.normal(size=(N_ENT, b, D)).astype(np.float32)
    jg = JGraph.from_csr(*csr, N_ENT)
    tg_ = tkg.DeviceGraph.from_csr(*csr, N_ENT, device="cpu")
    cfg = jmodel.ModelConfig(n_ent=N_ENT, n_rel=N_REL, hidden_dim=D,
                             attn_dim=A, n_layer=1, dropout=0.0,
                             dense_hops=False)
    z = jnp.zeros(4, jnp.int32)
    params = jax.jit(lambda k: jmodel.RedGNN(cfg).init(
        {"params": k, "dropout": k}, jg, z, z, z == 0,
        JCaps((4, 64), (256,)), False))(jax.random.PRNGKey(5))["params"]
    layer = jlayers.RelAttnLayer(hidden_dim=D, attn_dim=A, n_rel=N_REL)

    def jforward(p, h):
        return layer.apply({"params": p}, h, jnp.asarray(vis),
                           jnp.asarray(q_rel), jg.tsrc, jg.trel, jg.ttail,
                           jg.tail_rowptr, method=jlayers.RelAttnLayer.dense)

    want, want_vis, want_live = jax.jit(jforward)(params["layer_0"],
                                                  jnp.asarray(hd))
    gp, gh = jax.jit(jax.grad(lambda p, h: jnp.sum(jforward(p, h)[0] * w),
                              argnums=(0, 1)))(params["layer_0"],
                                               jnp.asarray(hd))
    tl = tlayers.RelAttnLayer(D, A, N_REL)
    sd = params_from_flax(jax.device_get(params))
    tl.load_state_dict({k[len("layer_0."):]: v for k, v in sd.items()
                        if k.startswith("layer_0.")})
    h = torch.from_numpy(hd).requires_grad_()
    got, got_vis, got_live = tl.dense(
        h, torch.from_numpy(vis), torch.from_numpy(q_rel), tg_.tsrc,
        tg_.trel, tg_.ttail, tg_.tail_rowptr, "sorted_scatter",
        tg_.tsrc_order, tg_.rowptr)
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
    assert int(got_live) == int(want_live) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    want_p = params_from_flax(jax.device_get({**params, "layer_0": gp}))
    pairs = [("h", h.grad, np.asarray(gh))] + [
        (k, p.grad, want_p[f"layer_0.{k}"].numpy())
        for k, p in tl.named_parameters()]
    for name, g, wnt in pairs:
        scale = float(np.abs(wnt).max())
        assert scale > 1e-6, name
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_temporal_dense_hop_matches_jax(vocab_dir, rng):
    """An interpolation TRedGNN whose second hop is dense (leave-one-out
    on), through the listed gather: scores atol 1e-5 and strict gradients
    within rtol 1e-4 + 1e-5·max|grad| of JAX's; the same bits from a
    graph without the list (the CPU path does not read it)."""
    kg = TemporalKG.load_vocab_dir(vocab_dir, device="cpu")
    jkg = JKG.load_vocab_dir(vocab_dir)
    cfg, batch, caps, excl = model_case(jkg, rng, "interpolation", loo=True,
                                        dense_switch=0.4)
    _, args, jmodel_ = jax_apply(jkg, cfg, batch, caps, excl, params={})
    # one jitted init (an eager flax init takes seconds)
    params = jax.jit(lambda: jmodel_.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        *args)["params"])()
    objs, qmask = batch[2], batch[4]

    def jloss(p):
        s, _ = jmodel_.apply({"params": p}, *args)
        return _loss(s, jnp.asarray(objs), jnp.asarray(qmask), jnp), s

    (want_loss, want_scores), want = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    want = params_from_flax(jax.device_get(want))
    model = port_model(cfg, params)
    from redgnn_tpu_torch.graph.calibrate import FrontierCaps

    plan = ttm.temporal_hop_plan(model.cfg, kg.graph.n_edges,
                                 FrontierCaps(*caps), B, True)
    assert plan[0] != "dense" and "dense" in plan, plan
    full = kg.graph
    bare = tkg.DeviceGraph(full.rowptr, full.rel, full.tail,
                           n_time=full.n_time)
    runs = []
    for graph in (full, bare):
        model.zero_grad(set_to_none=True)
        kg.graph = graph
        scores, _ = port_apply(model, kg, batch, caps, excl)
        loss = _loss(scores, torch.from_numpy(objs),
                     torch.from_numpy(qmask), torch)
        loss.backward()
        runs.append((scores.detach(), float(loss.detach()),
                     {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None}))
    assert bare.tsrc_order is None and full.tsrc_order is not None
    scores, loss, grads = runs[0]
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=1e-5)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for name, w in want.items():
        w = w.numpy()
        g = grads[name].numpy() if name in grads else np.zeros_like(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale + 1e-9,
                                   err_msg=name)
    assert torch.equal(runs[1][0], scores) and runs[1][1] == loss
    assert all(torch.equal(runs[1][2][k], g) for k, g in grads.items())
