"""Training CLI of the port.

    python -m redgnn_tpu_torch.cli.train --task transductive \
        --data_path <dir with entities.txt, relations.txt, facts.txt, ...>
    python -m redgnn_tpu_torch.cli.train --task inductive \
        --data_path <DIR; reads DIR and DIR_ind, each with entities.txt,
                     relations.txt, train.txt, valid.txt, test.txt>
    python -m redgnn_tpu_torch.cli.train --task interpolation \
        --data_path <id dir (entity2id.txt, relation2id.txt, train.txt, ...)
                     or name dir (train.txt, valid.txt, test.txt as TSV)>
    python -m redgnn_tpu_torch.cli.train --task extrapolation \
        --data_path <id dir, e.g. ICEWS14_forecasting>
    python -m redgnn_tpu_torch.cli.train --task extrapolation \
        --model xerte|simple --data_path <id dir>

Port of ``redgnn_tpu/cli/train.py``. Per-dataset tuned hyperparameters
load from the config registry (`redgnn_tpu_torch.utils.config`, keyed by
the directory's name; an extrapolation dir ``X`` also finds the
``X_forecasting`` entry); any field can be overridden with
``--set field=value``; with ``--model xerte`` a key that the temporal
config lacks goes to ``XErteConfig`` (``sampling=uniform``,
``dp_steps=2``, ...), and ``lr``, ``batch_size`` and ``grad_clip`` reach
the xERTE trainer only when they are set explicitly (its defaults are the
reference's: 1e-3, 128, 1.0). ``--model xerte|simple`` needs a temporal
task. The run happens on ``--device`` (default ``cuda``,
which raises without a card; ``--device cpu`` trains on the host). The
first line printed is the resolved config as JSON, the last one
``BEST {...}``. ``--load_checkpoint`` reads the port's ``.pt`` files and,
for the temporal tasks and models, the JAX package's ``.msgpack``
checkpoints with their ``.host.json``.

Not ported yet (each exits with a message): ``--mesh``,
``--distributed``, ``--hpo``, ``--eval_splits``, ``--sqlite`` /
``--results_dir`` logging and ``--attention_stats``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def parse_overrides(pairs, cfg):
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        if not hasattr(cfg, key):
            raise SystemExit(f"unknown config field: {key}")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        elif cur is None:
            # Optional fields: infer numeric types from the literal
            if raw.lower() in ("none", "null"):
                val = None
            else:
                try:
                    val = int(raw)
                except ValueError:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
        else:
            val = raw
        cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


def _refuse_unported(args) -> None:
    unported = {
        "--mesh": args.mesh is not None,
        "--distributed": args.distributed,
        "--hpo": args.hpo is not None,
        "--eval_splits": args.eval_splits is not None,
        "--sqlite": args.sqlite is not None,
        "--results_dir": args.results_dir is not None,
        "--attention_stats": args.attention_stats is not None,
    }
    asked = [name for name, given in unported.items() if given]
    if asked:
        raise SystemExit(f"{', '.join(asked)}: not ported yet (the PyTorch "
                         "port trains on one device; use "
                         "redgnn_tpu.cli.train for the rest)")


def load_temporal_kg(data_path: str, cfg, device):
    """The temporal KG of ``data_path`` as the reference protocol of
    ``cfg.mode`` loads it: an id dir with inverse relations, the graph of
    all splits and the first 48 hours of training queries dropped in
    extrapolation (`Temporal/extrapolation/main.py:134`); a name dir
    otherwise."""
    from redgnn_tpu_torch.graph.temporal import TemporalKG

    if os.path.exists(os.path.join(data_path, "entity2id.txt")):
        ex = cfg.mode == "extrapolation"
        return TemporalKG.load_id_dir(
            data_path, add_inverse=True,
            time_granularity=cfg.time_granularity,
            graph_from_all_splits=ex, warm_start_time=48 if ex else 0,
            device=device)
    return TemporalKG.load_vocab_dir(data_path, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="redgnn_tpu_torch trainer")
    p.add_argument("--task", required=True,
                   choices=["transductive", "inductive", "interpolation",
                            "extrapolation"])
    p.add_argument("--model", default="redgnn",
                   choices=["redgnn", "xerte", "simple"])
    p.add_argument("--data_path", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--load_checkpoint", default=None)
    p.add_argument("--resume_latest", action="store_true",
                   help="resume from <ckpt_dir>/latest.pt if present")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--set", nargs="*", metavar="FIELD=VALUE",
                   help="override any config field")
    p.add_argument("--timer", action="store_true",
                   help="per-epoch phase wall-clock buckets")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda; cpu trains "
                        "on the host)")
    for flag in ("--results_dir", "--eval_splits", "--sqlite", "--mesh",
                 "--attention_stats"):
        p.add_argument(flag, default=None, help="not ported yet")
    p.add_argument("--hpo", type=int, default=None, help="not ported yet")
    p.add_argument("--distributed", action="store_true",
                   help="not ported yet")
    args = p.parse_args(argv)
    _refuse_unported(args)

    import torch

    from redgnn_tpu_torch.utils.checkpoint import EXT, load_latest
    from redgnn_tpu_torch.utils.config import DATASET_CONFIGS, dataset_config

    # the port's arithmetic is fp32 throughout (see ops/gather.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dataset = os.path.basename(args.data_path.rstrip("/"))
    if args.task in ("transductive", "inductive"):
        if args.model != "redgnn":
            raise SystemExit(f"--model {args.model} needs a temporal task "
                             "(--task interpolation or extrapolation)")
        from redgnn_tpu_torch.train.loop import StaticTrainer

        cfg = dataset_config(f"static_{args.task}", dataset)
        if args.seed is not None:
            cfg = dataclasses.replace(cfg, seed=args.seed)
        cfg = parse_overrides(args.set, cfg)
        if args.task == "transductive":
            from redgnn_tpu_torch.graph.kg import StaticKG

            kg = StaticKG.load(args.data_path, device=args.device)
        else:
            from redgnn_tpu_torch.graph.inductive import InductiveKG

            kg = InductiveKG.load(args.data_path, device=args.device)
        trainer = StaticTrainer(kg, cfg)
    else:
        from redgnn_tpu_torch.train.temporal_loop import TemporalTrainer

        # an extrapolation dir named after the plain dataset resolves to
        # its `<name>_forecasting` entry
        cfg_key = dataset
        if (args.task == "extrapolation"
                and cfg_key not in DATASET_CONFIGS["temporal"]
                and f"{cfg_key}_forecasting" in DATASET_CONFIGS["temporal"]):
            cfg_key = f"{cfg_key}_forecasting"
        cfg = dataset_config("temporal", cfg_key)
        if args.task == "extrapolation" and cfg.mode != "extrapolation":
            cfg = dataclasses.replace(cfg, mode="extrapolation", window=120)
        if args.seed is not None:
            cfg = dataclasses.replace(cfg, seed=args.seed)
        set_pairs = list(args.set or [])
        xerte_pairs = []
        if args.model == "xerte":
            # --set keys split between the trainer config and XErteConfig
            xerte_pairs = [p for p in set_pairs
                           if not hasattr(cfg, p.partition("=")[0])]
            set_pairs = [p for p in set_pairs
                         if hasattr(cfg, p.partition("=")[0])]
        explicit_keys = {p.partition("=")[0] for p in set_pairs}
        cfg = parse_overrides(set_pairs, cfg)
        kg = load_temporal_kg(args.data_path, cfg, args.device)
        if args.model == "xerte":
            from redgnn_tpu_torch.models.xerte import XErteConfig
            from redgnn_tpu_torch.train.xerte_loop import XErteTrainer

            xcfg = parse_overrides(xerte_pairs, XErteConfig(
                n_ent=kg.n_ent, n_rel=kg.idd_rel, n_time=kg.n_time + 2))
            # the trainer's knobs keep the reference xERTE values unless
            # set explicitly (by key, not by comparing values)
            kwargs = {f: getattr(cfg, f) for f in ("lr", "batch_size",
                                                   "grad_clip")
                      if f in explicit_keys}
            trainer = XErteTrainer(kg, xcfg, seed=cfg.seed,
                                   grad_accum_steps=cfg.grad_accum_steps,
                                   epochs=cfg.epochs,
                                   max_train_batches=cfg.max_train_batches,
                                   max_eval_batches=cfg.max_eval_batches,
                                   device=args.device, **kwargs)
        elif args.model == "simple":
            from redgnn_tpu_torch.train.simple_loop import SimplETrainer

            trainer = SimplETrainer(kg, seed=cfg.seed, epochs=cfg.epochs,
                                    device=args.device)
        else:
            trainer = TemporalTrainer(kg, cfg)
    print(json.dumps(dataclasses.asdict(cfg)))
    if hasattr(trainer, "timer"):
        trainer.timer.enabled = args.timer
    elif args.timer:
        raise SystemExit("--timer supports the redgnn trainers only")

    def apply_lr_override():
        # a temporal restore brings back the checkpoint's live lr; an
        # explicit --set lr=... wins over it
        if hasattr(trainer, "force_lr") and "lr" in {
                p.partition("=")[0] for p in args.set or []}:
            trainer.force_lr(cfg.lr)
            print(f"lr override after restore: {cfg.lr}")

    start_epoch = 0
    if args.load_checkpoint:
        epoch = trainer.restore(args.load_checkpoint)
        print(f"restored checkpoint from epoch {epoch}")
        apply_lr_override()
    elif args.resume_latest and args.ckpt_dir:
        try:
            latest = load_latest(args.ckpt_dir, trainer.state())
        except ValueError as e:  # e.g. a checkpoint of another model shape
            print(f"latest checkpoint incompatible ({e}); starting fresh")
            latest = None
        if latest is not None:
            state, start_epoch, _ = latest
            trainer.load_state(state)
            # host state (re-split rng; temporal: lr, plateau, rngs)
            trainer.restore_host(os.path.join(args.ckpt_dir, "latest" + EXT))
            print(f"resuming from latest checkpoint at epoch {start_epoch}")
            apply_lr_override()

    if args.eval_only:
        vm = trainer.evaluate("valid")
        tm = trainer.evaluate("test")
        print(json.dumps({"valid": vm, "test": tm}, default=float))
        return

    best = trainer.fit(epochs=args.epochs, ckpt_dir=args.ckpt_dir,
                       start_epoch=start_epoch)
    print("BEST", json.dumps(best, default=float))


if __name__ == "__main__":
    main()
