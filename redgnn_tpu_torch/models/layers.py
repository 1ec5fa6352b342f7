"""Propagation building blocks: relation-conditioned attention + GRU gate.

Port of ``redgnn_tpu/models/layers.py`` (sparse hop and GRU gate):
    message  m_e = h_src + h_rel
    alpha_e  = sigmoid(w_a . ReLU(W_s h_src + W_r h_rel + W_q h_qrel + b_q) + b_a)
    agg_v    = sum over edges e with dst(e)=v of alpha_e * m_e
    h'_v     = act(W_h agg_v)
The aggregation runs through `ops.segment.segment_sum`, which sends
``segment_impl='pallas'`` to the sorted-segment-sum kernel.

Parameters are created on the CPU with the JAX package's init bounds,
drawn from the ``torch.Generator`` passed in (torch's default one if
None); the owning model moves them to its device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from redgnn_tpu_torch.ops.frontier import Frontier
from redgnn_tpu_torch.ops.gather import take_rows
from redgnn_tpu_torch.ops.segment import segment_sum

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
                 generator: torch.Generator | None = None):
        super().__init__()
        self.act = act
        self.segment_impl = segment_impl
        # table holds 2*n_rel+1 rows: relations, inverses, self-loop
        self.rela_embed = nn.Parameter(torch.empty(2 * n_rel + 1, hidden_dim))
        with torch.no_grad():
            self.rela_embed.normal_(0.0, 1.0, generator=generator)
        self.Ws_attn = _linear(hidden_dim, attn_dim, False, generator)
        self.Wr_attn = _linear(hidden_dim, attn_dim, False, generator)
        self.Wqr_attn = _linear(hidden_dim, attn_dim, True, generator)
        self.w_alpha = _linear(attn_dim, 1, True, generator)
        self.W_h = _linear(hidden_dim, hidden_dim, False, generator)

    def forward(
        self,
        hidden_prev: torch.Tensor,  # (prev_cap, D)
        q_rel: torch.Tensor,        # (B,) query relation per batch element
        frontier: Frontier,
        node_cap: int,
    ) -> torch.Tensor:
        src, dst, rel, batch, valid = (
            frontier.src, frontier.dst, frontier.rel, frontier.batch,
            frontier.edge_valid,
        )
        # The frontier gives every padding edge the last frontier slot as
        # src. Their messages are masked below, so the row they read does
        # not matter, but the gather's backward
        # (index_put_(accumulate=True): equal indices are added one after
        # another by one warp) would walk thousands of them in a row.
        # Spread them over the rows instead; nothing that leaves the layer
        # changes.
        spread = torch.arange(src.shape[0], device=src.device) \
            % hidden_prev.shape[0]
        src = torch.where(valid, src.long(), spread)
        hs = hidden_prev[src]                              # (E, D)
        hr = take_rows(self.rela_embed, rel)               # (E, D)
        h_qr = take_rows(take_rows(self.rela_embed, q_rel), batch)

        logits = self.w_alpha(torch.relu(
            self.Ws_attn(hs) + self.Wr_attn(hr) + self.Wqr_attn(h_qr)))
        alpha = torch.sigmoid(logits)
        message = (hs + hr) * alpha
        message = torch.where(valid[:, None], message, 0.0)
        # The frontier gives all padding edges one dst (the first free slot,
        # or node_cap-1) and zero messages; send them past the end instead,
        # so the sum drops them rather than one segment walking them all.
        # Valid edges form a prefix of the dst-sorted list, so the ids stay
        # sorted.
        seg = torch.where(valid, dst, node_cap)

        agg = segment_sum(
            message,
            seg,
            num_segments=node_cap,
            indices_are_sorted=True,  # sort-dedup frontiers only
            impl=self.segment_impl,
        )
        return ACTIVATIONS[self.act](self.W_h(agg))


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
