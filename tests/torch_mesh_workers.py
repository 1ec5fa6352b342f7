"""Rank bodies of the port's multi-process tests (`test_torch_parallel.py`,
`test_torch_cuda.py`). They run in fresh worker processes started by
`redgnn_tpu_torch.parallel.launch.run_mesh`, which import this module and
nothing else of the tests: it imports neither JAX nor the JAX package, so
a worker starts in seconds."""

from __future__ import annotations

import numpy as np
import torch


def graph_of(arrays, device):
    from redgnn_tpu_torch.graph.kg import DeviceGraph

    return DeviceGraph(*(torch.as_tensor(a, device=device) for a in arrays))


def static_step(mesh, graph_arrays, cfg_kw, params, batch, caps, lr,
                steps_per_epoch=10):
    """One `make_dp_train_step` step from ``params`` (a state dict) with a
    fresh Adam: the updated parameters, loss and overflow flag."""
    from redgnn_tpu_torch.models.redgnn import ModelConfig
    from redgnn_tpu_torch.parallel.shard import make_dp_train_step
    from redgnn_tpu_torch.train.loop import make_optimizer
    from redgnn_tpu_torch.utils.config import TrainConfig

    dev = mesh.device
    graph = graph_of(graph_arrays, dev)
    tx = make_optimizer(TrainConfig(lr=lr, lamb=0.0), steps_per_epoch)
    params = {k: v.to(dev) for k, v in params.items()}
    opt_state = tx.init(torch.cat([v.reshape(-1) for v in params.values()]))
    step = make_dp_train_step(ModelConfig(**cfg_kw), tx, mesh, caps)
    subs, rels, objs, qmask = (torch.as_tensor(a, device=dev) for a in batch)
    new, _, loss, overflow = step(params, opt_state, graph, subs, rels, objs,
                                  qmask.bool())
    return {"params": {k: v.cpu() for k, v in new.items()},
            "loss": float(loss), "overflow": bool(overflow)}


def static_trainer(mesh, kg_dir, cfg_kw, state, splits=("valid",),
                   epochs=0):
    """A `StaticTrainer` under ``mesh`` from ``state`` (or its own init):
    ``epochs`` train epochs (their losses), then the metrics of
    ``splits`` and the final parameters."""
    from redgnn_tpu_torch.graph.kg import StaticKG
    from redgnn_tpu_torch.train.loop import StaticTrainer
    from redgnn_tpu_torch.utils.config import TrainConfig

    kg = StaticKG.load(kg_dir, device=mesh.device)
    tr = StaticTrainer(kg, TrainConfig(**cfg_kw), mesh=mesh)
    if state is not None:
        tr.load_state(state)
    losses = [tr.train_epoch(e) for e in range(epochs)]
    metrics = {s: tr.evaluate(s) for s in splits}
    return {"losses": losses, "metrics": metrics, "n_tbatch": tr.n_tbatch,
            "caps": tr.train_caps,
            "params": {k: v.cpu().clone() for k, v in tr.params.items()}}


def temporal_trainer(mesh, kg_dir, cfg_kw, state, batch_rows):
    """A `TemporalTrainer` under ``mesh`` from ``state``:
    ``evaluate('valid')``, then one train step on the training rows
    ``batch_rows`` (loss, overflow, parameters)."""
    from redgnn_tpu_torch.graph.temporal import TemporalKG
    from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer
    from redgnn_tpu_torch.utils.config import TemporalTrainConfig

    kg = TemporalKG.load_vocab_dir(kg_dir, device=mesh.device)
    cfg = TemporalTrainConfig(**cfg_kw)
    tr = TemporalTrainer(kg, cfg, mesh=mesh)
    tr.load_state(state)
    out = {"metrics": tr.evaluate("valid")}
    if batch_rows is not None:
        out.update(temporal_one_step(tr, batch_rows))
    return out


def temporal_one_step(tr, rows):
    """One `TemporalTrainer._train_step` on the training rows ``rows``."""
    kg, b = tr.kg, len(rows)
    data = kg.splits["train"][rows]
    caps = tr._get_caps("train", data, tr._cap_b(b))
    excl = (kg.exclusion_slots(rows) if tr.cfg.mode == "interpolation"
            else None)
    cols = [torch.as_tensor(data[:, j].astype(np.int32), device=tr.device)
            for j in range(4)]
    qmask = torch.ones(b, dtype=torch.bool, device=tr.device)
    ex = (None if excl is None else
          torch.as_tensor(excl.astype(np.int32), device=tr.device))
    loss, overflow, bad = tr._train_step(cols[0], cols[1], cols[2], cols[3],
                                         qmask, ex, caps)
    return {"loss": float(loss), "overflow": bool(overflow),
            "bad": bool(bad), "cap0": caps.node_caps[0],
            "params": {k: v.cpu().clone() for k, v in tr.params.items()}}


def grad_probe(mesh, graph_arrays, cfg_kw, params, batch, caps):
    """The gradient of `make_dp_loss_fn`'s loss (no update), summed over
    the mesh, as a state dict, and the loss and overflow flag."""
    from redgnn_tpu_torch.models.redgnn import ModelConfig
    from redgnn_tpu_torch.parallel.shard import make_dp_loss_fn

    dev = mesh.device
    graph = graph_of(graph_arrays, dev)
    loss_fn = make_dp_loss_fn(ModelConfig(**cfg_kw), mesh, caps)
    leaves = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    subs, rels, objs, qmask = (torch.as_tensor(a, device=dev) for a in batch)
    objective, loss, overflow = loss_fn(leaves, graph, subs, rels, objs,
                                        qmask.bool())
    grads = torch.autograd.grad(objective, list(leaves.values()),
                                allow_unused=True)
    out = {}
    for (k, p), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p) if g is None else g.clone()
        out[k] = mesh.all_reduce(g).cpu()
    return {"grads": out, "loss": float(loss), "overflow": bool(overflow)}


def all_reduce_grad(mesh, axis):
    """The differentiable all-reduce over ``axis`` and its backward: each
    rank contributes (rank + 1) * x and differentiates sum(w * out)."""
    from redgnn_tpu_torch.parallel.mesh import all_reduce_sum

    x = torch.arange(4, dtype=torch.float32, device=mesh.device) \
        .requires_grad_()
    out = all_reduce_sum((mesh.rank + 1) * x, mesh, axis)
    w = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    (g,) = torch.autograd.grad((w * out).sum(), x)
    return {"out": out.detach().cpu(), "grad": g.cpu(),
            "coords": dict(mesh.coords)}


def mesh_coords(mesh):
    return {"coords": dict(mesh.coords), "rank": mesh.rank}


def skip_collective(mesh):
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    import time

    if mesh.rank == 0:
        mesh.all_reduce(torch.ones(3, device=mesh.device))
    else:
        time.sleep(120)
