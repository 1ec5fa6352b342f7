"""Hyperparameter optimization harness.

Capability parity with the reference's HPO layer
(`Temporal/interpolation/hyperopt_train.py:167-175` TPE spaces;
`Temporal/extrapolation/ray_hpo.py:280-287` Ray Tune + ASHA): neither ray
nor hyperopt ships in this image, so the harness is self-contained —
log-uniform/choice sampling plus ASHA-style successive halving (trials
train in rungs; only the top 1/reduction_factor advance). Trials run
sequentially (one chip); the trial runner is a callable so multi-host
fleets can fan out later.

The search spaces below are the reference's.

Port of ``redgnn_tpu/utils/hpo.py``: the same spaces and the same
search, so one seed samples the same trials in both packages. Only the
trial-parallel mode differs: a worker thread runs its trial under
``torch.cuda.device`` of one local card where the JAX package uses
``jax.default_device``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Choice:
    options: Sequence[Any]

    def sample(self, rng):
        return self.options[rng.integers(len(self.options))]


@dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


# `Temporal/interpolation/hyperopt_train.py:167-175`
INTERPOLATION_SPACE = {
    "batch_size": Choice([16, 32, 64]),
    "lr": LogUniform(1e-3, 3e-2),
    "weight_decay": LogUniform(1e-4, 3e-2),
    "hidden_dim": Choice([16, 20, 32, 48]),
    "attn_dim": Choice([20, 30, 40]),
    "act": Choice(["leakyrelu", "relu", "tanh"]),
    "n_layer": Choice([3, 4, 5]),
    "dropout": Uniform(0.0, 0.3),
}

# `Static/*/train.py` tuned ranges
STATIC_SPACE = {
    "lr": LogUniform(3e-4, 1e-2),
    "lamb": LogUniform(1e-5, 5e-4),
    "hidden_dim": Choice([32, 48, 64]),
    "attn_dim": Choice([3, 5]),
    "n_layer": Choice([3, 4, 5]),
    "dropout": Uniform(0.0, 0.3),
    "act": Choice(["relu", "tanh", "idd"]),
}


@dataclass
class Trial:
    trial_id: int
    params: Dict[str, Any]
    metric: float = -math.inf
    epochs_done: int = 0
    history: List[float] = field(default_factory=list)
    status: str = "pending"


def asha_search(
    space: Dict[str, Any],
    run_trial: Callable[[Dict[str, Any], int, Optional[Any]],
                        Tuple[float, Any]],
    num_trials: int = 16,
    min_epochs: int = 1,
    max_epochs: int = 8,
    reduction_factor: int = 2,
    seed: int = 0,
    log_path: Optional[str] = None,
    n_workers: int = 1,
) -> Trial:
    """Successive-halving search.

    ``run_trial(params, epochs, resume_state) -> (metric, state)`` trains
    ``epochs`` more epochs (resuming from ``state`` if given) and returns
    the validation metric (higher is better).

    ``n_workers > 1`` runs a rung's trials concurrently, each thread
    with one local CUDA device current (``torch.cuda.device``; the
    reference's trial-parallel multi-GPU HPO, `hyperopt_train.py:22` /
    `ray_hpo.py` — here a thread pool over the local cards; kernel
    launches are asynchronous per device, so independent trials overlap).
    ``run_trial`` builds its trainer on ``torch.cuda.current_device()``;
    without a card the threads share the CPU.
    """
    rng = np.random.default_rng(seed)
    trials = [
        Trial(i, {k: v.sample(rng) for k, v in space.items()})
        for i in range(num_trials)
    ]
    states: Dict[int, Any] = {}

    rungs = []
    e = min_epochs
    while e <= max_epochs:
        rungs.append(e)
        e *= reduction_factor

    def advance(t: Trial, rung_epochs: int, device=None) -> None:
        add = rung_epochs - t.epochs_done
        if add <= 0:
            return
        if device is not None:
            import torch

            with torch.cuda.device(device):
                metric, state = run_trial(t.params, add,
                                          states.get(t.trial_id))
        else:
            metric, state = run_trial(t.params, add, states.get(t.trial_id))
        states[t.trial_id] = state
        t.metric = metric
        t.epochs_done = rung_epochs
        t.history.append(metric)
        t.status = "running"
        if log_path:
            with open(log_path, "a+") as f:
                f.write(json.dumps({
                    "trial": t.trial_id, "epochs": t.epochs_done,
                    "metric": metric, "params": t.params,
                    "t": time.time(),
                }) + "\n")

    alive = list(trials)
    for rung_epochs in rungs:
        if n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            import torch

            n_dev = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 0)
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                futs = [
                    pool.submit(advance, t, rung_epochs,
                                t.trial_id % n_dev if n_dev else None)
                    for t in alive
                ]
                for f in futs:
                    f.result()
        else:
            for t in alive:
                advance(t, rung_epochs)
        alive.sort(key=lambda t: t.metric, reverse=True)
        keep = max(1, len(alive) // reduction_factor)
        for t in alive[keep:]:
            t.status = "stopped"
            states.pop(t.trial_id, None)
        alive = alive[:keep]
    best = max(trials, key=lambda t: t.metric)
    best.status = "best"
    return best
