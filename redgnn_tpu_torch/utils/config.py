"""Config-as-data: per-dataset hyperparameters.

A copy of ``redgnn_tpu/utils/config.py`` (the port imports nothing from
the JAX package): the static registries and the temporal one, with the
JAX package's comments on why values differ from the reference. The
values are the reference's tuned settings
(`Static/transductive/train.py:46-111`, `Static/inductive/train.py:46-168`,
`Temporal/interpolation/main*.py:40-52`,
`Temporal/extrapolation/main.py:111-155`) so results reproduce.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class TrainConfig:
    # model
    hidden_dim: int = 48
    attn_dim: int = 5
    n_layer: int = 3
    dropout: float = 0.29
    act: str = "relu"
    # optimization (torch-Adam-style coupled weight decay, `base_model.py:27`)
    lr: float = 0.0036
    decay_rate: float = 0.999  # per-epoch exponential LR decay
    lamb: float = 0.000017     # weight decay
    n_batch: int = 20          # train batch size
    n_tbatch: int = 50         # eval batch size
    epochs: int = 50
    seed: int = 1234
    # per-epoch train-query reshuffle (see the JAX package's config)
    shuffle_train: bool = True
    # implementation choices, same names and defaults as the JAX package
    segment_impl: str = "xla"
    compute_dtype: str = "float32"
    dedup_impl: str = "auto"  # 'sort' | 'bitmap' | 'auto' (models/redgnn.py)
    # range-sum hidden[src] backward of bitmap hops: the exact kernel on a
    # CUDA device, a prefix-sum difference (O(total * eps) noise) on the CPU
    scan_src_backward: bool = True
    dense_hops: bool = True    # batch-shared hops once frontiers saturate
    dense_switch: float = 0.25
    cap_headroom: float = 1.2
    scan_chunk: int = 256

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or "
                             f"'bfloat16', got {self.compute_dtype!r}")


# `Static/transductive/train.py:46-111`
_STATIC_TRANS = {
    "family": TrainConfig(lr=0.0036, decay_rate=0.999, lamb=0.000017,
                          hidden_dim=48, attn_dim=5, n_layer=3, dropout=0.29,
                          act="relu", n_batch=20, n_tbatch=50),
    "umls": TrainConfig(lr=0.0012, decay_rate=0.9917, lamb=0.000115,
                        hidden_dim=48, attn_dim=5, n_layer=4, dropout=0.0024,
                        act="relu", n_batch=20, n_tbatch=50),
    "WN18RR": TrainConfig(lr=0.0021, decay_rate=0.9962, lamb=0.000037,
                          hidden_dim=48, attn_dim=5, n_layer=5, dropout=0.0067,
                          act="tanh", n_batch=100, n_tbatch=50),
    "fb15k-237": TrainConfig(lr=0.0009, decay_rate=0.9938, lamb=0.000080,
                             hidden_dim=48, attn_dim=5, n_layer=4,
                             dropout=0.0391, act="relu", n_batch=5, n_tbatch=1),
    "nell": TrainConfig(lr=0.0011, decay_rate=0.9938, lamb=0.000089,
                        hidden_dim=48, attn_dim=5, n_layer=5, dropout=0.2593,
                        act="relu", n_batch=5, n_tbatch=1),
    # the JAX package's YAGO deviations (dense hops off, scan_chunk=1,
    # larger batches) are kept so the two packages run the same config
    "YAGO": TrainConfig(lr=0.0003, decay_rate=0.997, lamb=0.000111,
                        hidden_dim=48, attn_dim=5, n_layer=3, dropout=0.2131,
                        act="relu", n_batch=20, n_tbatch=25,
                        dense_hops=False, scan_chunk=1),
}

# `Static/inductive/train.py:46-168`
_STATIC_INDUC = {
    "WN18RR_v1": TrainConfig(lr=0.005, decay_rate=0.991, lamb=0.0002,
                             hidden_dim=64, attn_dim=5, n_layer=5,
                             dropout=0.21, act="idd", n_batch=100, n_tbatch=50),
    "WN18RR_v2": TrainConfig(lr=0.0016, decay_rate=0.994, lamb=0.0004,
                             hidden_dim=48, attn_dim=3, n_layer=5,
                             dropout=0.02, act="relu", n_batch=20, n_tbatch=50),
    "WN18RR_v3": TrainConfig(lr=0.0014, decay_rate=0.991, lamb=0.000034,
                             hidden_dim=64, attn_dim=5, n_layer=5,
                             dropout=0.28, act="tanh", n_batch=20, n_tbatch=50),
    "WN18RR_v4": TrainConfig(lr=0.006, decay_rate=0.991, lamb=0.000132,
                             hidden_dim=32, attn_dim=5, n_layer=5,
                             dropout=0.11, act="relu", n_batch=10, n_tbatch=50),
    "fb237_v1": TrainConfig(lr=0.0092, decay_rate=0.994, lamb=0.0003,
                            hidden_dim=32, attn_dim=5, n_layer=3,
                            dropout=0.23, act="relu", n_batch=20, n_tbatch=50),
    "fb237_v2": TrainConfig(lr=0.0077, decay_rate=0.993, lamb=0.0002,
                            hidden_dim=48, attn_dim=5, n_layer=3,
                            dropout=0.3, act="relu", n_batch=10, n_tbatch=50),
    "fb237_v3": TrainConfig(lr=0.0006, decay_rate=0.994, lamb=0.000023,
                            hidden_dim=48, attn_dim=3, n_layer=3,
                            dropout=0.27, act="relu", n_batch=20, n_tbatch=50),
    "fb237_v4": TrainConfig(lr=0.0052, decay_rate=0.999, lamb=0.000018,
                            hidden_dim=48, attn_dim=5, n_layer=5,
                            dropout=0.07, act="idd", n_batch=20, n_tbatch=50),
    "nell_v1": TrainConfig(lr=0.0021, decay_rate=0.9937, lamb=0.000189,
                           hidden_dim=48, attn_dim=5, n_layer=5,
                           dropout=0.2460, act="relu", n_batch=10, n_tbatch=50),
    "nell_v2": TrainConfig(lr=0.0075, decay_rate=0.9996, lamb=0.000066,
                           hidden_dim=48, attn_dim=5, n_layer=3,
                           dropout=0.2881, act="relu", n_batch=100, n_tbatch=50),
    "nell_v3": TrainConfig(lr=0.0008, decay_rate=0.995, lamb=0.0004,
                           hidden_dim=16, attn_dim=3, n_layer=3,
                           dropout=0.06, act="relu", n_batch=10, n_tbatch=50),
    "nell_v4": TrainConfig(lr=0.0005, decay_rate=1.0, lamb=0.000398,
                           hidden_dim=16, attn_dim=5, n_layer=5,
                           dropout=0.1472, act="tanh", n_batch=20, n_tbatch=50),
}


@dataclass(frozen=True)
class TemporalTrainConfig:
    # model (`Temporal/interpolation/main.py:40-52`;
    #  `Temporal/extrapolation/main.py:147-152`)
    hidden_dim: int = 20
    attn_dim: int = 30
    n_layer: int = 4
    dropout: float = 0.1
    act: str = "leakyrelu"
    mode: str = "interpolation"
    window: Optional[int] = None       # granularity units (extrapolation: 120)
    time_granularity: int = 1
    n_frequencies: int = 48
    # optimization
    lr: float = 1e-2
    weight_decay: float = 1e-2         # AdamW, decoupled
    optimizer: str = "adamw"           # icews05-15 uses plain Adam
    patience: int = 3                  # ReduceLROnPlateau on valid loss
    plateau_factor: float = 0.1
    grad_clip: Optional[float] = None
    grad_accum_steps: int = 1  # `extrapolation/main.py:140` gradient_iters_per_update
    max_train_batches: Optional[int] = None  # cap steps/epoch (smoke runs)
    max_eval_batches: Optional[int] = None   # cap eval batches (subset MRR)
    batch_size: int = 32
    eval_batch_size: int = 32
    epochs: int = 50
    seed: int = 1234
    # implementation choices, same names and defaults as the JAX package
    segment_impl: str = "xla"
    # range-sum hidden[src] backward: the exact kernel on a CUDA device, a
    # prefix-sum difference (O(total * eps) noise) on the CPU
    scan_src_backward: bool = True
    dense_hops: bool = True    # batch-shared hops once frontiers saturate
    dense_switch: float = 0.25
    cap_headroom: float = 1.2
    scan_chunk: int = 16  # steps between two host reads of the loss
    # ablations (`Temporal/interpolation/model_cuda_aba.py:14,189,353`) —
    # CLI-reachable via --set, e.g. `--set use_time=false`
    use_time: bool = True               # False => T_RED_GNN_wo_tau
    use_attention: bool = True          # False => T_RED_GNN_wo_Attn
    direction_transform: str = "linear"  # "bias" => T_RED_GNN_W
    time_embedding: str = "periodic"     # "absolute" => per-timestamp table
    edge_dropout: float = 0.0            # prototype's random edge drop


_TEMPORAL = {
    # `Temporal/interpolation/main.py:40-52`
    "icews14_aug": TemporalTrainConfig(
        batch_size=32, lr=1e-2, patience=3, epochs=50, weight_decay=1e-2,
        hidden_dim=20, attn_dim=30, n_layer=4, dropout=0.1, act="leakyrelu",
    ),
    # `Temporal/interpolation/main_icews05-15.py`
    "icews05-15_aug": TemporalTrainConfig(
        batch_size=4, lr=1e-2, patience=3, epochs=50, weight_decay=1e-2,
        hidden_dim=20, attn_dim=30, n_layer=4, dropout=0.1, act="sigmoid",
        optimizer="adam",
    ),
    # `Temporal/interpolation/main_wikidata11k.py`
    "wikidata11k_aug": TemporalTrainConfig(
        batch_size=20, lr=1e-2, patience=3, epochs=50, weight_decay=1e-2,
        hidden_dim=20, attn_dim=30, n_layer=4, dropout=0.1, act="leakyrelu",
    ),
    # icews14_aug protocol on the committed id-based ICEWS14 split
    # (the reference's data/preprocess.sh-fetched icews14_aug train file
    # is not committed; ICEWS14_TeMP is the same 72826-quad split).
    # bs32 matches the reference recipe directly (`main.py:40-52`) —
    # affordable since round-2's dense-mode hops (125 q/s train / 318 q/s
    # eval on the v5e vs round-1's 20.7 q/s at bs8 x accum4).
    # dense_switch 0.2 (not the 0.25 default): the EXACT hop-1 edge caps
    # sit at 0.98-1.04x the 0.25*b*|E| threshold across epoch permutations
    # and eval splits — at 0.25 the hop-1 dense/sparse decision would
    # flip per split/permutation (sparse hop-1 at ~1.25M padded slots is
    # the slow path AND what overflowed in round 2); 0.2 pins hops 1-3
    # dense everywhere.
    "ICEWS14_TeMP": TemporalTrainConfig(
        batch_size=32, grad_accum_steps=1, lr=1e-2, patience=3, epochs=20,
        weight_decay=1e-2, hidden_dim=20, attn_dim=30, n_layer=4,
        dropout=0.1, act="leakyrelu", eval_batch_size=32, scan_chunk=32,
        dense_switch=0.2,
    ),
    # `Temporal/extrapolation/main.py:111-155,202-209`
    # The reference's reproduction command trains with batch_size **2**
    # (`Temporal/README.md:27-37`) and Adam + weight_decay 1e-3
    # (`main.py:217`) — NOT the argparse default of 128. A 20-epoch run
    # at effective batch 128 (bs16 x 8 accum) plateaued at test fil-MRR
    # 0.362 vs the reference curve's 0.449: 64x fewer optimizer updates.
    # bs16 keeps the per-dispatch program at the profile proven stable
    # for hours on this TPU worker; accum=1 recovers 8x more updates
    # (effective batch 16 — the closest TPU-efficient point to bs2).
    "ICEWS14_forecasting": TemporalTrainConfig(
        mode="extrapolation", window=120, time_granularity=24,
        batch_size=16, grad_accum_steps=1, eval_batch_size=32,
        optimizer="adam", weight_decay=1e-3,
        lr=1e-3, epochs=20, hidden_dim=30, attn_dim=30, n_layer=3,
        dropout=0.1, act="leakyrelu", patience=3, scan_chunk=64,
    ),
    # same README recipe as ICEWS14_forecasting (`Temporal/README.md:40-49`:
    # bs2, Adam) — bs16 is the TPU-efficient stand-in, see above
    "YAGO_forecasting": TemporalTrainConfig(
        mode="extrapolation", window=120, time_granularity=1,
        batch_size=16, eval_batch_size=32, optimizer="adam",
        weight_decay=1e-3, lr=1e-3, epochs=20, hidden_dim=30, attn_dim=30,
        n_layer=3, dropout=0.1, act="leakyrelu", patience=3, scan_chunk=64,
    ),
}

DATASET_CONFIGS = {
    "static_transductive": _STATIC_TRANS,
    "static_inductive": _STATIC_INDUC,
    "temporal": _TEMPORAL,
}


def dataset_config(task: str, dataset: str, **overrides):
    """The registry entry for ``dataset`` under ``task`` ('static_transductive',
    'static_inductive' or 'temporal'), the task's defaults if the name is
    unknown, with ``overrides`` applied."""
    default = TemporalTrainConfig() if task == "temporal" else TrainConfig()
    base = DATASET_CONFIGS.get(task, {}).get(dataset, default)
    if overrides:
        base = replace(base, **overrides)
    return base
