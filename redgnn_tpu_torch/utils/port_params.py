"""Carry the JAX package's parameters and optimizer state over to the port.

``params_from_flax`` maps a flax parameter tree (a nested dict of arrays)
onto the state dict of the port's model:

  * ``redgnn_tpu.models.redgnn.RedGNN``: flax ``Dense`` kernels are
    (in, out) and torch ``Linear`` weights (out, in), so kernels are
    transposed; the GRU gate's (D, 3D) matrices become torch's (3D, D)
    layout with the same r|z|n gate order;
  * ``redgnn_tpu.models.temporal.TRedGNN``: its parameters are plain
    arrays applied as ``x @ W`` on both sides, so names and layouts carry
    over as they are.

``opt_state_from_optax`` carries the static trainer's Adam moments and
update count. ``temporal_opt_state_from_optax`` carries the temporal
trainer's optimizer: ``inject_hyperparams`` over ``adamw`` or
``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``,
optionally behind ``clip_by_global_norm``, optionally wrapped by
``MultiSteps``, and the xERTE / SimplE trainers' plain ``adam`` (the
learning rate is then not in the state and comes from the caller). It reads the optax state as a state dict
(``flax.serialization.to_state_dict`` of the state, or the
``opt_state`` of a decoded ``.msgpack`` checkpoint), so it needs neither
optax nor flax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(x, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    return torch.tensor(a.T if transpose else a)  # a contiguous copy


def _dotted(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax tree -> torch state dict by name: ``a/b/kernel`` becomes
    ``a.b.weight`` (transposed), every other leaf keeps its name."""
    sd: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            sd.update(_dotted(v, f"{prefix}{k}."))
        elif k == "kernel":
            sd[f"{prefix}weight"] = _tensor(v, True)
        else:
            sd[f"{prefix}{k}"] = _tensor(v)
    return sd


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict (CPU float32 tensors) of the port's RedGNN, TRedGNN,
    XErte or SimplE from the matching flax parameter tree
    (``variables["params"]``)."""
    if "classifier_w" in tree:  # TRedGNN: one array per parameter
        return {k: _tensor(v) for k, v in tree.items()}
    if "transition_fn_0" in tree or "ent_embs_h" in tree:  # XErte, SimplE
        return _dotted(tree)
    t = _tensor
    sd: Dict[str, torch.Tensor] = {}
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    for name in layers:
        p = tree[name]
        sd[f"{name}.rela_embed"] = t(p["rela_embed"])
        for lin in ("Ws_attn", "Wr_attn", "W_h"):
            sd[f"{name}.{lin}.weight"] = t(p[lin]["kernel"], True)
        for lin in ("Wqr_attn", "w_alpha"):
            sd[f"{name}.{lin}.weight"] = t(p[lin]["kernel"], True)
            sd[f"{name}.{lin}.bias"] = t(p[lin]["bias"])
    g = tree["gate"]
    sd["gate.weight_ih"] = t(g["w_ih"], True)
    sd["gate.weight_hh"] = t(g["w_hh"], True)
    sd["gate.bias_ih"] = t(g["b_ih"])
    sd["gate.bias_hh"] = t(g["b_hh"])
    sd["W_final.weight"] = t(tree["W_final"]["kernel"], True)
    return sd


def opt_state_from_optax(mu: Mapping, nu: Mapping, count) -> Dict:
    """The port's optimizer state ``{"mu", "nu", "count"}`` from optax's
    ``ScaleByAdamState`` fields (``mu`` and ``nu`` as nested dicts of
    arrays, ``count`` the number of applied updates). The schedule's own
    count in the optax chain always equals it."""
    return {"mu": params_from_flax(mu), "nu": params_from_flax(nu),
            "count": torch.tensor(int(np.asarray(count)), dtype=torch.int64)}


def _find_adam(state):
    """The ``ScaleByAdamState`` (a dict with count, mu and nu) inside an
    optax chain's state dict; empty states are absent from it."""
    if isinstance(state, Mapping):
        if {"count", "mu", "nu"} <= state.keys():
            return state
        for v in state.values():
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def temporal_opt_state_from_optax(state: Mapping,
                                  lr: float | None = None) -> Dict:
    """The port's temporal optimizer state from an optax state dict:
    ``{"mu", "nu"}`` (state dicts of the parameters' shape), ``count``
    (updates applied to the moments), ``lr`` (the live learning rate of
    ``inject_hyperparams``, else the given ``lr``) and, under
    ``MultiSteps``, ``acc_grads``, ``mini_step`` and ``gradient_step``."""
    out: Dict = {}
    if "inner_opt_state" in state:  # MultiSteps
        out["acc_grads"] = params_from_flax(state["acc_grads"])
        out["mini_step"] = torch.tensor(int(np.asarray(state["mini_step"])),
                                        dtype=torch.int64)
        out["gradient_step"] = torch.tensor(
            int(np.asarray(state["gradient_step"])), dtype=torch.int64)
        state = state["inner_opt_state"]
    adam = _find_adam(state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    if "hyperparams" in state:
        lr = state["hyperparams"]["learning_rate"]
    elif lr is None:
        raise ValueError("the optax state holds no learning rate; pass lr")
    out["mu"] = params_from_flax(adam["mu"])
    out["nu"] = params_from_flax(adam["nu"])
    out["count"] = torch.tensor(int(np.asarray(adam["count"])),
                                dtype=torch.int64)
    out["lr"] = torch.tensor(np.asarray(lr, np.float32))
    return out
