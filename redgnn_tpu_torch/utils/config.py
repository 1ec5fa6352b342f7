"""Config-as-data: per-dataset hyperparameters of the static tasks.

A copy of the static part of ``redgnn_tpu/utils/config.py`` (the port
imports nothing from the JAX package). The values are the reference's
tuned settings (`Static/transductive/train.py:46-111`,
`Static/inductive/train.py:46-168`) so results reproduce.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


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
    scan_src_backward: bool = True
    dense_hops: bool = True    # batch-shared hops once frontiers saturate
    dense_switch: float = 0.25
    cap_headroom: float = 1.2
    scan_chunk: int = 256


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

DATASET_CONFIGS = {
    "static_transductive": _STATIC_TRANS,
    "static_inductive": _STATIC_INDUC,
}


def dataset_config(task: str, dataset: str, **overrides) -> TrainConfig:
    """The registry entry for ``dataset`` (defaults if unknown), with
    ``overrides`` applied. Temporal configs are not ported yet."""
    if task == "temporal":
        raise NotImplementedError("temporal configs are not ported yet")
    base = DATASET_CONFIGS.get(task, {}).get(dataset, TrainConfig())
    if overrides:
        base = replace(base, **overrides)
    return base
