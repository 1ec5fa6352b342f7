"""Visualization: learning curves + attention heatmaps.

Capability parity with the reference's plotting layer
(`Temporal/interpolation/my_visual.py`, `draw_learning_curve*.py`,
`Temporal/extrapolation/draw_learning_cur_ex.py`), driven by this
framework's metrics JSONL instead of pickles dumped inside forward passes
(a documented non-goal, SURVEY.md §7).

Port of ``redgnn_tpu/utils/viz.py`` (numpy; matplotlib is imported by
the plotting functions alone). The attention statistics come from
`train/temporal_loop.py:TemporalTrainer.collect_attention`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def plot_learning_curves(
    jsonl_paths: Dict[str, str],
    metric: str = "valid_mrr",
    out_path: str = "learning_curve.png",
    title: Optional[str] = None,
) -> str:
    """Plot one metric across runs (reference: `draw_learning_curve.py`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, path in jsonl_paths.items():
        rows = [r for r in _load_jsonl(path) if metric in r]
        if not rows:
            continue
        ax.plot([r["step"] for r in rows], [r[metric] for r in rows],
                marker="o", markersize=3, label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.set_title(title or metric)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_attention_heatmap(
    attn: np.ndarray,
    row_labels: Optional[Sequence[str]] = None,
    col_labels: Optional[Sequence[str]] = None,
    out_path: str = "attention.png",
    title: str = "query-relation vs edge-relation attention",
) -> str:
    """Mean attention per (query relation, edge relation) pair
    (reference: `my_visual.py` heatmaps from attention_vis pickles)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(attn, aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax, shrink=0.8)
    if row_labels is not None and len(row_labels) <= 40:
        ax.set_yticks(range(len(row_labels)))
        ax.set_yticklabels(row_labels, fontsize=6)
    if col_labels is not None and len(col_labels) <= 40:
        ax.set_xticks(range(len(col_labels)))
        ax.set_xticklabels(col_labels, fontsize=6, rotation=90)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def collect_attention_stats(
    alphas: np.ndarray,      # (E,) per-edge attention
    edge_rels: np.ndarray,   # (E,)
    query_rels: np.ndarray,  # (E,) query relation per edge
    valid: np.ndarray,
    n_rel: int,
) -> np.ndarray:
    """(n_rel, n_rel, 2) accumulator of [attention sum, count] keyed by
    (query relation, edge relation) — the reference's attention_vis
    bookkeeping (`model_cuda_new_embdding.py:117-125,169-172`) done in one
    vectorized pass instead of a python loop inside forward."""
    acc = np.zeros((n_rel, n_rel, 2))
    np.add.at(acc, (query_rels[valid], edge_rels[valid], 0), alphas[valid])
    np.add.at(acc, (query_rels[valid], edge_rels[valid], 1), 1.0)
    return acc
