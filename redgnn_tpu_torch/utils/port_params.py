"""Carry the JAX package's RedGNN parameters and Adam state over to the port.

``params_from_flax`` maps the flax parameter tree of
``redgnn_tpu.models.redgnn.RedGNN`` (a nested dict of arrays) onto the
state dict of ``redgnn_tpu_torch.models.redgnn.RedGNN``. Flax ``Dense``
kernels are (in, out) and torch ``Linear`` weights (out, in), so kernels
are transposed; the GRU gate's (D, 3D) matrices become torch's (3D, D)
layout with the same r|z|n gate order. ``opt_state_from_optax`` carries
the Adam moments (trees of the parameters' shape) and the update count
the same way, so both packages can continue from one optimizer state.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict (CPU float32 tensors) of the port's RedGNN from a flax
    RedGNN parameter tree (``variables["params"]``)."""

    def t(x, transpose=False):
        a = np.asarray(x, dtype=np.float32)
        return torch.tensor(a.T if transpose else a)  # a contiguous copy

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
