"""Propagation building blocks: relation-conditioned attention + GRU gate.

Port of ``redgnn_tpu/models/layers.py``:
    message  m_e = h_src + h_rel
    alpha_e  = sigmoid(w_a . ReLU(W_s h_src + W_r h_rel + W_q h_qrel + b_q) + b_a)
    agg_v    = sum over edges e with dst(e)=v of alpha_e * m_e
    h'_v     = act(W_h agg_v)
The aggregation runs through `ops.segment.segment_sum`, which sends
``segment_impl='pallas'`` to the sorted-segment-sum kernel. A layer runs
one hop either over a sparse frontier (`RelAttnLayer.forward`) or over
the whole tail-sorted edge table, batch-shared (`RelAttnLayer.dense`);
both use one parameter set.

``compute_dtype="bfloat16"`` (the JAX package's field) computes as the
JAX package does: the gathered rows (``h_src``, the relation rows, the
dense hop's packed state) are bf16 copies; the attention projections
take them promoted back to float32 (flax's ``nn.Dense`` with float32
parameters and a bf16 input computes in float32; the weights are never
rounded); ``h_src + h_rel`` is one bf16 add; the message, its sum and
everything after are float32. One deliberate difference: the gradients of
those gathers are summed in float32 (`ops/gather.py`), where the JAX
package's sum in bf16 stalls on rows gathered hundreds of times.

Under a mesh with an edge axis (``edge_shards > 1``, the JAX package's
``edge_axis``) a sparse hop slices the padded edge list into
``edge_shards`` contiguous chunks, takes this rank's chunk, and sums the
partial aggregates over the mesh's edge group with a differentiable
all-reduce (`parallel/mesh.py:all_reduce_sum`).

Parameters are created on the CPU with the JAX package's init bounds,
drawn from the ``torch.Generator`` passed in (torch's default one if
None); the owning model moves them to its device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from redgnn_tpu_torch.ops.dense_hop import (
    dense_hop_static,
    grad_free,
    static_terms,
)
from redgnn_tpu_torch.ops.frontier import Frontier
from redgnn_tpu_torch.ops.gather import (
    gather_bf16,
    gather_rows_listed,
    take_rows,
)
from redgnn_tpu_torch.ops.segment import segment_sum
from redgnn_tpu_torch.parallel.mesh import all_reduce_sum

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

ACTIVATIONS: Dict[str, Callable] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "idd": lambda x: x,
}


def _uniform_init_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place — the torch
    nn.Linear/GRU default the JAX package's ``_uniform_init`` mirrors."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _linear(d_in: int, d_out: int, bias: bool,
            generator: torch.Generator | None) -> nn.Linear:
    lin = nn.Linear(d_in, d_out, bias=bias)
    _uniform_init_(lin.weight, d_in, generator)
    if bias:
        _uniform_init_(lin.bias, d_in, generator)
    return lin


class RelAttnLayer(nn.Module):
    """One hop of query-conditioned relational attention propagation."""

    def __init__(self, hidden_dim: int, attn_dim: int, n_rel: int,
                 act: str = "relu", segment_impl: str = "xla",
                 generator: torch.Generator | None = None,
                 mxu_gather_backward: bool = True,
                 edge_axis: str | None = None, edge_shards: int = 1,
                 mesh=None, compute_dtype: str = "float32"):
        """``mxu_gather_backward`` sends the relation-table lookups through
        `take_rows` (one-hot matmul backward); off, they are plain
        gathers. ``edge_axis`` names the ``mesh`` axis whose
        ``edge_shards`` ranks split each sparse hop's edges.
        ``compute_dtype`` is 'float32' or 'bfloat16' (the gathered rows;
        see the module's docstring)."""
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(COMPUTE_DTYPES)}, got "
                             f"{compute_dtype!r}")
        self.cdt = COMPUTE_DTYPES[compute_dtype]
        self.act = act
        self.segment_impl = segment_impl
        self.mxu_gather_backward = mxu_gather_backward
        self.edge_axis = edge_axis if edge_shards > 1 else None
        self.edge_shards = edge_shards
        if self.edge_axis is not None and (
                mesh is None or mesh.size(edge_axis) != edge_shards):
            raise ValueError(f"edge_shards={edge_shards} needs a mesh whose "
                             f"{edge_axis!r} axis has that many ranks")
        self.mesh = mesh
        # table holds 2*n_rel+1 rows: relations, inverses, self-loop
        self.rela_embed = nn.Parameter(torch.empty(2 * n_rel + 1, hidden_dim))
        with torch.no_grad():
            self.rela_embed.normal_(0.0, 1.0, generator=generator)
        self.Ws_attn = _linear(hidden_dim, attn_dim, False, generator)
        self.Wr_attn = _linear(hidden_dim, attn_dim, False, generator)
        self.Wqr_attn = _linear(hidden_dim, attn_dim, True, generator)
        self.w_alpha = _linear(attn_dim, 1, True, generator)
        self.W_h = _linear(hidden_dim, hidden_dim, False, generator)

    def _rows(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``table[idx]`` in the compute dtype: a plain gather in float32,
        the float32-accumulating `gather_bf16` in bf16."""
        if self.cdt == torch.float32:
            return table[idx.long()]
        return gather_bf16(table, idx)

    def forward(
        self,
        hidden_prev: torch.Tensor,  # (prev_cap, D)
        q_rel: torch.Tensor,        # (B,) query relation per batch element
        frontier: Frontier,
        node_cap: int,
        edges_sorted: bool = True,
    ) -> torch.Tensor:
        """``edges_sorted`` says that the frontier's edges are sorted by
        ``dst`` (sort dedup); bitmap-dedup frontiers are not, and only
        ``segment_impl='xla'`` takes them."""
        src, dst, rel, batch, valid = (
            frontier.src, frontier.dst, frontier.rel, frontier.batch,
            frontier.edge_valid,
        )
        sharded = self.edge_axis is not None
        if sharded:
            # this rank's contiguous chunk of the replicated edge list; a
            # chunk of a dst-sorted list is still sorted, and its valid
            # edges are still a prefix of it
            e = src.shape[0]
            if e % self.edge_shards:
                raise ValueError(f"edge cap {e} is not a multiple of "
                                 f"edge_shards={self.edge_shards}")
            chunk = e // self.edge_shards
            start = self.mesh.index(self.edge_axis) * chunk
            src, dst, rel, batch, valid = (
                x[start:start + chunk] for x in (src, dst, rel, batch, valid))
        if frontier.src_values is not None and not sharded:
            # h_src was fetched inside the frontier's metadata gather,
            # whose backward is a scatter-free range sum of the gradient
            # (ops/gather.gather_rows_packed: the exact kernel on a CUDA
            # device, a prefix-sum difference on the CPU)
            hs = frontier.src_values.to(self.cdt)          # (E, D)
        else:
            # The frontier gives every padding edge the last frontier slot
            # as src. Their messages are masked below, so the row they
            # read does not matter, but the gather's backward
            # (index_put_(accumulate=True): equal indices are added one
            # after another by one warp) would walk thousands of them in
            # a row. Spread them over the rows instead; nothing that
            # leaves the layer changes.
            spread = torch.arange(src.shape[0], device=src.device) \
                % hidden_prev.shape[0]
            src = torch.where(valid, src.long(), spread)
            hs = self._rows(hidden_prev, src)              # (E, D)
        # under the edge axis the JAX package takes plain gathers too
        if self.mxu_gather_backward and not sharded:
            rela_c = self.rela_embed.to(self.cdt)
            hr = take_rows(rela_c, rel)                    # (E, D)
            h_qr = take_rows(take_rows(rela_c, q_rel), batch)
        elif self.cdt == torch.float32:
            hr = self.rela_embed[rel.long()]
            h_qr = self.rela_embed[q_rel.long()][batch.long()]
        else:
            # rela_c[q_rel][batch] as one gather: the same rows, one sum
            hr = gather_bf16(self.rela_embed, rel)
            h_qr = gather_bf16(self.rela_embed, q_rel.long()[batch.long()])

        # the projections promote bf16 rows to float32 (a no-op in float32)
        f32 = torch.float32
        logits = self.w_alpha(torch.relu(
            self.Ws_attn(hs.to(f32)) + self.Wr_attn(hr.to(f32))
            + self.Wqr_attn(h_qr.to(f32))))
        alpha = torch.sigmoid(logits)
        # one add in the compute dtype; the message is float32
        message = (hs + hr).to(f32) * alpha
        message = torch.where(valid[:, None], message, 0.0)
        # The frontier gives all padding edges one dst (the first free slot,
        # or node_cap-1) and zero messages; send them past the end instead,
        # so the sum drops them rather than one segment walking them all.
        # In a dst-sorted list the valid edges form a prefix, so the ids
        # stay sorted; a bitmap frontier's list is unsorted either way.
        seg = torch.where(valid, dst, node_cap)

        agg = segment_sum(
            message,
            seg,
            num_segments=node_cap,
            indices_are_sorted=edges_sorted,
            impl=self.segment_impl,
        )
        if sharded:
            agg = all_reduce_sum(agg, self.mesh, self.edge_axis)
        return ACTIVATIONS[self.act](self.W_h(agg))

    def dense(self, hidden_dense: torch.Tensor, visited: torch.Tensor,
              q_rel: torch.Tensor, tsrc: torch.Tensor, trel: torch.Tensor,
              ttail: torch.Tensor, tail_rowptr: torch.Tensor,
              dense_agg: str = "sorted_scatter",
              tsrc_order: torch.Tensor | None = None,
              rowptr: torch.Tensor | None = None,
              tail_items: torch.Tensor | None = None):
        """One hop over the ENTIRE tail-sorted edge table, batch-shared
        (saturated-frontier regime).

        hidden_dense: (n_ent, b, d); visited: (n_ent, b) bool. Returns
        (act(W_h agg) (n_ent, b, d), new_visited (n_ent, b), live-edge
        count).

        When no gradient can flow (`ops.dense_hop.grad_free`: gradients
        off, or neither the state nor a parameter requires one) the sum
        before ``W_h`` is `ops.dense_hop.dense_hop_static`: one kernel on a
        CUDA device (``tail_items`` is the graph's work plan of it, which
        the kernel needs), its plain version on the CPU; ``dense_agg``
        picks only the plain version's summation. Otherwise it is
        `dense_autograd`, whose packed (state, visited) rows are gathered
        by `gather_rows_listed`, whose backward sums each source's edges
        through ``tsrc_order`` and the CSR's ``rowptr`` (the graph's): the
        list-sum kernel on a CUDA device, which needs both; the CPU does
        not. ``dense_agg='sorted_scatter'`` sums the (E, b*d) messages
        and the (E, b) live flags by ``ttail`` through `segment_sum` with
        the layer's ``segment_impl`` (``ttail`` is ascending, so 'pallas'
        is the sorted-segment-sum kernel); ``'cumsum'`` takes differences
        of a prefix sum at the static ``tail_rowptr`` ranges.

        This differs from the JAX package, whose dense hop always takes the
        plain scatter-add (``impl="xla"``, `redgnn_tpu/models/layers.py:206,209`)
        whatever ``segment_impl`` says: there the kernel never sees a dense
        hop. The sums are the same function either way; with
        ``segment_impl='xla'`` (the default) the two packages agree in route
        as well."""
        if grad_free(hidden_dense, *self.parameters()):
            return self.dense_fused(hidden_dense, visited, q_rel, tsrc, trel,
                                    ttail, tail_rowptr, dense_agg,
                                    tail_items)
        return self.dense_autograd(hidden_dense, visited, q_rel, tsrc, trel,
                                   ttail, tail_rowptr, dense_agg, tsrc_order,
                                   rowptr)

    def dense_fused(self, hidden_dense, visited, q_rel, tsrc, trel, ttail,
                    tail_rowptr, dense_agg="sorted_scatter", tail_items=None):
        """`dense` as `ops.dense_hop.dense_hop_static` (no gradient)."""
        # float32: the table's own dtype (a float64 referee stays so)
        rela_c = (self.rela_embed if self.cdt == torch.float32
                  else self.rela_embed.to(self.cdt))
        wr, wq = static_terms(rela_c, q_rel, self.Wr_attn.weight,
                              self.Wqr_attn.weight, self.Wqr_attn.bias)
        agg, new_visited, n_live = dense_hop_static(
            hidden_dense.to(rela_c.dtype), visited, rela_c, tsrc, trel,
            ttail, tail_rowptr, wr, wq, self.Ws_attn.weight,
            self.w_alpha.weight[0], self.w_alpha.bias, dense_agg, tail_items)
        return ACTIVATIONS[self.act](self.W_h(agg)), new_visited, n_live

    def dense_autograd(self, hidden_dense, visited, q_rel, tsrc, trel, ttail,
                       tail_rowptr, dense_agg="sorted_scatter",
                       tsrc_order=None, rowptr=None):
        """`dense` through autograd-able tensor ops (the route that
        training takes)."""
        d = self.rela_embed.shape[1]
        n, b = visited.shape
        e_all = tsrc.shape[0]

        # pack the visited bit: one row gather per edge serves the batch
        # (in bf16 the bit stays an exact 0 / 1)
        packed = torch.cat(
            [hidden_dense, visited[:, :, None].to(hidden_dense.dtype)], -1)
        # in float32 the table's own dtype, as `_rows` (a float64
        # referee's table stays float64)
        g = gather_rows_listed(
            packed, tsrc, tsrc_order, rowptr,
            None if self.cdt == torch.float32 else self.cdt)  # (E, b, d+1)
        hs = g[..., :d]
        live = g[..., d] > 0.5                        # (E, b)

        hr = (take_rows(self.rela_embed.to(self.cdt), trel)
              if self.mxu_gather_backward
              else self._rows(self.rela_embed, trel))  # (E, d)
        h_qr = self._rows(self.rela_embed, q_rel)     # (b, d)

        # the attention terms factor: the hr / h_qr projections are shared
        # over the batch / the edges; no (E, b, 3d) concat materializes.
        # The projections promote bf16 rows to float32.
        f32 = torch.float32
        logits = self.w_alpha(torch.relu(
            self.Ws_attn(hs.to(f32)) + self.Wr_attn(hr.to(f32))[:, None, :]
            + self.Wqr_attn(h_qr.to(f32))[None, :, :]))
        alpha = torch.sigmoid(logits)
        message = (hs + hr[:, None, :]).to(f32) * alpha
        message = torch.where(live[..., None], message, 0.0)

        if dense_agg == "cumsum":
            lo, hi = tail_rowptr[:-1].long(), tail_rowptr[1:].long()
            pref = torch.cat([message.new_zeros((1, b, d)),
                              torch.cumsum(message, 0)])
            agg = pref[hi] - pref[lo]
            cnt = torch.cat([
                torch.zeros((1, b), dtype=torch.int32, device=live.device),
                torch.cumsum(live, 0, dtype=torch.int32)])
            new_visited = (cnt[hi] - cnt[lo]) > 0
        elif dense_agg == "sorted_scatter":
            agg = segment_sum(message.reshape(e_all, b * d), ttail, n,
                              indices_are_sorted=True,
                              impl=self.segment_impl).reshape(n, b, d)
            new_visited = segment_sum(
                live.to(torch.float32), ttail, n, indices_are_sorted=True,
                impl=self.segment_impl) > 0
        else:
            raise ValueError(f"unknown dense_agg {dense_agg!r}")
        n_live = torch.sum(live).to(torch.int32)
        return ACTIVATIONS[self.act](self.W_h(agg)), new_visited, n_live


class GRUGate(nn.Module):
    """Single-step GRU carrying node state across hops (torch GRU gate
    equations, weights in torch's (3*D, D) layout, gates r|z|n):
        r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h
    """

    def __init__(self, hidden_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = hidden_dim
        self.weight_ih = nn.Parameter(torch.empty(3 * d, d))
        self.weight_hh = nn.Parameter(torch.empty(3 * d, d))
        self.bias_ih = nn.Parameter(torch.empty(3 * d))
        self.bias_hh = nn.Parameter(torch.empty(3 * d))
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            _uniform_init_(p, d, generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gi = x @ self.weight_ih.T + self.bias_ih
        gh = h @ self.weight_hh.T + self.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h
