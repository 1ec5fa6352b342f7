"""Data-parallel queries x edge-parallel propagation: the sharded step.

Port of ``redgnn_tpu/parallel/shard.py``:

  * queries are sharded over the mesh axis ``data``: every rank runs the
    whole L-hop expansion for its contiguous slice of the global batch;
  * within a data shard, each sparse hop's edge list is sliced over axis
    ``edge`` (`models/layers.py:RelAttnLayer`): expansion indices are
    computed on every edge rank alike (cheap integer work), the D-wide
    attention and message math is sharded, and a sum all-reduce of the
    (node_cap, D) partial aggregates over the edge group reassembles them;
  * the graph and the parameters are replicated.

The JAX package differentiates outside ``shard_map`` and lets JAX
transpose the collectives. Here every rank differentiates its own part,
and the pieces give the same gradient: the loss is the sum over data
shards of `softmax_ce_loss`, then the mean over the edge group (the edge
ranks hold identical copies); so each rank differentiates its shard's
loss divided by ``n_edge``, the edge all-reduce's backward is the sum
all-reduce of the cotangents (its exact adjoint), and one all-reduce of
the flat gradient over the whole world (data x edge) sums the parts. The
replicated node-side math then counts ``n_edge`` times ``1 / n_edge``,
and each edge slice's math once. DDP would average over the world
instead of summing over data.

The same all-reduce carries the step's loss and overflow flag, so every
rank sees the same numbers and takes the same branch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.func import functional_call

from redgnn_tpu_torch.graph.calibrate import FrontierCaps
from redgnn_tpu_torch.models.redgnn import ModelConfig, RedGNN
from redgnn_tpu_torch.parallel.mesh import Mesh


def sharded_config(model_cfg, mesh: Mesh):
    """The per-rank model config under ``mesh``: the edge axis when it has
    more than one rank; plain gathers and the strict backward, as the JAX
    package's shard_map requires (`shard.py:53-59`)."""
    n_edge = mesh.size("edge")
    extra = ({"edge_axis": "edge" if n_edge > 1 else None,
              "edge_shards": n_edge}
             if hasattr(model_cfg, "edge_axis") else {})
    return dataclasses.replace(model_cfg, mxu_gather_backward=False,
                               scan_src_backward=False, **extra)


def data_shard(mesh: Mesh, b_global: int) -> slice:
    """This rank's rows of a global batch of ``b_global`` queries."""
    n = mesh.size("data")
    if b_global % n:
        raise ValueError(f"batch of {b_global} does not split over the "
                         f"mesh data axis ({n})")
    b = b_global // n
    i = mesh.index("data")
    return slice(i * b, (i + 1) * b)


def fold_seed(seed: int, index: int) -> int:
    """A generator seed per data shard (index 0 keeps ``seed``), as the
    JAX package folds the data index into the dropout key."""
    return (seed + index * 0x9E3779B97F4A7C15) % (2 ** 63)


def reduce_step(mesh: Mesh, grads: torch.Tensor, loss: torch.Tensor,
                overflow: torch.Tensor):
    """One world all-reduce of [flat gradient, loss term, overflow]:
    (summed gradient, summed loss, any overflow) — the same on every
    rank."""
    buf = torch.cat([grads.reshape(-1), loss.reshape(1).to(grads.dtype),
                     overflow.reshape(1).to(grads.dtype)])
    mesh.all_reduce(buf)
    return buf[:-2], buf[-2], buf[-1] > 0


def dp_loss(model: RedGNN, mesh: Mesh, graph, subs, rels, objs, qmask,
            caps: FrontierCaps, generator=None, params=None):
    """This rank's term of the global loss: the softmax-CE sum over its
    data shard of the global batch, divided by the edge group's size
    (differentiable), and its overflow flag. ``params`` (a state dict)
    replaces the model's parameters for this call when given."""
    from redgnn_tpu_torch.train.loop import softmax_ce_loss

    sl = data_shard(mesh, subs.shape[0])
    args = (graph, subs[sl], rels[sl], qmask[sl], caps)
    kwargs = {"train": True, "generator": generator}
    scores, aux = (model(*args, **kwargs) if params is None
                   else functional_call(model, params, args, kwargs))
    loss = softmax_ce_loss(scores, objs[sl], qmask[sl]) / mesh.size("edge")
    overflow = torch.any(aux["edge_overflow"]) | torch.any(
        aux["node_overflow"])
    return loss, overflow


def make_dp_loss_fn(model_cfg: ModelConfig, mesh: Mesh,
                    caps: FrontierCaps) -> Callable:
    """Sharded loss of a global batch.

    ``loss_fn(params, graph, subs, rels, objs, qmask, generator=None)``
    -> (objective, loss, overflow). ``params`` is a state dict of the
    model; the batch tensors are global and this rank takes its data
    shard. ``objective`` is this rank's differentiable term: the
    gradients of all ranks' terms, summed over the world, are the
    gradient of ``loss`` (the global loss, the same on every rank, with
    ``overflow`` any rank's overflow); the sums ride the step's one
    all-reduce (`reduce_step`), which this function makes for the value
    and the flag."""
    model = RedGNN(sharded_config(model_cfg, mesh), device=mesh.device,
                   mesh=mesh)

    def loss_fn(params, graph, subs, rels, objs, qmask, generator=None):
        objective, overflow = dp_loss(model, mesh, graph, subs, rels, objs,
                                      qmask, caps, generator, params)
        buf = torch.stack([objective.detach(), overflow.to(torch.float32)])
        mesh.all_reduce(buf)
        return objective, buf[0], buf[1] > 0

    return loss_fn


def make_dp_train_step(model_cfg: ModelConfig, tx, mesh: Mesh,
                       caps: FrontierCaps) -> Callable:
    """A multi-rank train step.

    ``step(params, opt_state, graph, subs, rels, objs, qmask,
    generator=None) -> (params, opt_state, loss, overflow)``: ``params``
    is a state dict (replicated), ``opt_state`` the state of ``tx`` (the
    flat optimizer of `train/loop.py:make_optimizer`) over the parameters
    laid end to end in the dict's order; the batch is global. Nothing is
    modified in place."""
    model = RedGNN(sharded_config(model_cfg, mesh), device=mesh.device,
                   mesh=mesh)

    def step(params: Dict[str, torch.Tensor], opt_state, graph, subs, rels,
             objs, qmask, generator=None):
        names = list(params)
        leaves = [params[n].detach().requires_grad_() for n in names]
        objective, overflow = dp_loss(
            model, mesh, graph, subs, rels, objs, qmask, caps, generator,
            dict(zip(names, leaves)))
        grads = torch.autograd.grad(objective, leaves, allow_unused=True)
        with torch.no_grad():
            g = torch.cat([(torch.zeros_like(p) if x is None else x)
                           .reshape(-1) for x, p in zip(grads, leaves)])
            g, loss, overflow = reduce_step(mesh, g, objective.detach(),
                                            overflow)
            flat = torch.cat([p.detach().reshape(-1) for p in leaves])
            updates, opt_state = tx.update(g, opt_state, flat)
            flat = flat + updates
            out, o = {}, 0
            for n, p in zip(names, leaves):
                out[n] = flat[o:o + p.numel()].view(p.shape)
                o += p.numel()
        return out, opt_state, loss, overflow

    return step


def agree_caps(mesh, caps: FrontierCaps) -> FrontierCaps:
    """The elementwise max of ``caps`` over every rank: all ranks then run
    tensors of one shape, as the JAX package's one program for all shards
    does (a rank with other shapes would make the edge all-reduce fail or
    hang)."""
    if mesh is None or mesh.size() == 1:
        return caps
    n = len(caps.node_caps)
    t = torch.tensor(list(caps.node_caps) + list(caps.edge_caps),
                     dtype=torch.int64, device=mesh.device)
    mesh.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    v = t.tolist()
    return FrontierCaps(tuple(v[:n]), tuple(v[n:]))
