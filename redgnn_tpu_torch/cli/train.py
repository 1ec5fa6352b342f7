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
checkpoints with their ``.host.json``. Each run writes its perf lines,
metrics JSONL and memory report under ``--results_dir`` (default
``results``), and a run row into ``--sqlite`` when given.

Multi-GPU (the redgnn model): ``--mesh D[xE]`` shards the run over
``D`` data-parallel ranks, each with ``E`` edge-parallel ranks (static
tasks only). Alone it starts ``D*E`` local worker processes, one per GPU
(with ``--device cpu``: on the CPU, over gloo); with ``--distributed``
the ranks come from torchrun's environment instead, one process each:

    torchrun --nproc_per_node 8 -m redgnn_tpu_torch.cli.train \
        --distributed --mesh 4x2 --task transductive --data_path <dir>

Only rank 0 prints, logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys


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


# the mesh's collective timeout in a CLI run: long host phases of one
# rank (an exact-cap walk of a large split) must not trip it
MESH_TIMEOUT_S = 600.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="redgnn_tpu_torch trainer")
    p.add_argument("--task", required=True,
                   choices=["transductive", "inductive", "interpolation",
                            "extrapolation"])
    p.add_argument("--model", default="redgnn",
                   choices=["redgnn", "xerte", "simple"])
    p.add_argument("--data_path", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--results_dir", default="results")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--load_checkpoint", default=None)
    p.add_argument("--resume_latest", action="store_true",
                   help="resume from <ckpt_dir>/latest.pt if present")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--eval_splits", default=None,
                   help="comma-separated extra eval splits evaluated on "
                        "the best checkpoint after training (seen/unseen "
                        "entity protocol of `extrapolation/main.py:121`)")
    p.add_argument("--sqlite", default=None,
                   help="path to a sqlite experiment db")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--set", nargs="*", metavar="FIELD=VALUE",
                   help="override any config field")
    p.add_argument("--timer", action="store_true",
                   help="per-epoch phase wall-clock buckets")
    p.add_argument("--hpo", type=int, default=None, metavar="N",
                   help="run an N-trial ASHA hyperparameter search over "
                        "the task's reference space instead of one fit")
    p.add_argument("--hpo_workers", type=int, default=1,
                   help="concurrent trials per ASHA rung (one local GPU "
                        "each; temporal tasks)")
    p.add_argument("--attention_stats", default=None, metavar="PATH.npz",
                   help="after training, dump (query-rel x edge-rel) "
                        "attention sum/count statistics (temporal redgnn)")
    p.add_argument("--mesh", default=None, metavar="D[xE]",
                   help="shard the run over D data-parallel ranks, each x "
                        "E edge-parallel ranks (static tasks only); "
                        "without --distributed it starts D*E local "
                        "workers, one per GPU")
    p.add_argument("--distributed", action="store_true",
                   help="take the ranks from torchrun's environment (RANK,"
                        " WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT); warns "
                        "and runs single-process without it")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda; cpu trains "
                        "on the host)")
    return p


def parse_mesh(spec: str, args):
    """(n_data, n_edge) of ``--mesh D[xE]``, refusing what the JAX package
    refuses."""
    parts = spec.lower().split("x")
    n_data = int(parts[0])
    n_edge = int(parts[1]) if len(parts) > 1 else 1
    if args.model != "redgnn":
        raise SystemExit("--mesh supports the redgnn model only")
    if args.task not in ("transductive", "inductive") and n_edge > 1:
        raise SystemExit("temporal tasks shard the data axis only; "
                         "use --mesh D")
    return n_data, n_edge


def mesh_devices(device: str, n: int) -> list:
    """The devices of ``n`` local ranks: one GPU each, or the CPU."""
    import torch

    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise SystemExit(f"--mesh needs {n} GPUs (one per rank), this host "
                         f"has {have}")
    return [f"cuda:{i}" for i in range(n)]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    mesh = None
    if args.distributed:
        from redgnn_tpu_torch.parallel.runtime import initialize_distributed

        info = initialize_distributed(device=args.device,
                                      timeout=MESH_TIMEOUT_S)
        if info["process_index"] == 0:
            print(f"distributed runtime: process {info['process_index']}/"
                  f"{info['process_count']}, {info['local_devices']} local "
                  f"/ {info['global_devices']} global devices")
        if args.mesh is None and info["process_count"] > 1:
            raise SystemExit(f"--distributed over {info['process_count']} "
                             "ranks needs --mesh D[xE] with D*E ranks")
    if args.mesh:
        n_data, n_edge = parse_mesh(args.mesh, args)
        devices = mesh_devices(args.device, n_data * n_edge) \
            if not args.distributed else None
        if args.distributed or n_data * n_edge == 1:
            from redgnn_tpu_torch.parallel.mesh import default_devices, make_mesh

            if devices is None:
                import torch

                world = n_data * n_edge
                devices = (["cpu"] * world
                           if torch.device(args.device).type == "cpu"
                           else default_devices())
            mesh = make_mesh(n_data, n_edge, devices=devices,
                             timeout=MESH_TIMEOUT_S)
        else:
            from redgnn_tpu_torch.parallel.launch import run_mesh

            run_mesh(cli_rank, n_data, n_edge, devices, args=(argv,),
                     timeout=None, collective_timeout=MESH_TIMEOUT_S)
            return
    try:
        run(args, mesh)
    finally:
        if mesh is not None:
            from redgnn_tpu_torch.parallel.mesh import destroy

            destroy()


def cli_rank(mesh, argv):
    """One rank of a ``--mesh`` run started by `main`."""
    run(build_parser().parse_args(argv), mesh)


def run(args, mesh=None):
    """The run of ``args`` on this process: alone (``mesh`` None) or as one
    rank of ``mesh``, where only rank 0 prints, logs and writes."""
    import numpy as np
    import torch

    from redgnn_tpu_torch.utils.checkpoint import (
        EXT,
        best_checkpoint,
        load_latest,
    )
    from redgnn_tpu_torch.utils.config import DATASET_CONFIGS, dataset_config
    from redgnn_tpu_torch.utils.memory import (
        PeakRSSMonitor,
        write_memory_report,
    )
    from redgnn_tpu_torch.utils.reporting import ExperimentLogger

    main_rank = mesh is None or mesh.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    device = mesh.device if mesh is not None else args.device
    if mesh is not None:
        say(f"mesh: {mesh.size('data')} data x {mesh.size('edge')} edge "
            f"over {mesh.size()} ranks ({mesh.backend}, rank 0 on "
            f"{mesh.device})")

    # the port's arithmetic is fp32 throughout (see ops/gather.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dataset = os.path.basename(args.data_path.rstrip("/"))
    build_trainer = None
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

            kg = StaticKG.load(args.data_path, device=device)
        else:
            from redgnn_tpu_torch.graph.inductive import InductiveKG

            kg = InductiveKG.load(args.data_path, device=device)
        build_trainer = lambda c: StaticTrainer(kg, c, mesh=mesh)
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
        kg = load_temporal_kg(args.data_path, cfg, device)
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
                                   device=device, **kwargs)
        elif args.model == "simple":
            from redgnn_tpu_torch.train.simple_loop import SimplETrainer

            trainer = SimplETrainer(kg, seed=cfg.seed, epochs=cfg.epochs,
                                    device=device)
        else:
            kgs = {}

            def build_trainer(c):
                # an HPO worker thread trains on its current card
                k = kg
                if args.hpo_workers > 1 and torch.device(
                        device).type == "cuda":
                    dev = torch.cuda.current_device()
                    if dev not in kgs:
                        kgs[dev] = load_temporal_kg(args.data_path, cfg,
                                                    f"cuda:{dev}")
                    k = kgs[dev]
                return TemporalTrainer(k, c, mesh=mesh)
    if build_trainer is not None:
        trainer = None if args.hpo else build_trainer(cfg)

    logger = (ExperimentLogger(args.results_dir, dataset, cfg,
                               sqlite_path=args.sqlite)
              if main_rank else None)
    say(json.dumps(dataclasses.asdict(cfg)))

    if args.timer:
        if trainer is None or not hasattr(trainer, "timer"):
            raise SystemExit("--timer supports the redgnn trainers only "
                             "(and not --hpo)")
        trainer.timer.enabled = True

    if args.hpo:
        if args.model != "redgnn":
            raise SystemExit("--hpo supports the redgnn model only")
        from redgnn_tpu_torch.utils.hpo import (
            INTERPOLATION_SPACE,
            STATIC_SPACE,
            asha_search,
        )

        static = args.task in ("transductive", "inductive")
        space = STATIC_SPACE if static else INTERPOLATION_SPACE
        if args.hpo_workers > 1 and (static or mesh is not None):
            # static trials resplit the shared KG every epoch, which races
            # across threads; a mesh's ranks must run one trial at a time
            raise SystemExit("--hpo_workers > 1 supports temporal tasks "
                             "without --mesh only (static trials re-split "
                             "a shared graph)")

        def run_trial(params_d, epochs, state):
            if state is None:
                tr, done = build_trainer(dataclasses.replace(cfg,
                                                             **params_d)), 0
            else:
                tr, done = state
            metric = -1.0
            for e in range(done, done + epochs):
                tr.train_epoch(e)
                metric = tr.evaluate("valid")["mrr"]
                if hasattr(tr.kg, "resplit"):
                    # per-epoch 3:1 facts/train re-split, as in fit()
                    tr.kg.resplit(tr._np_rng)
            return float(metric), (tr, done + epochs)

        best = asha_search(
            space, run_trial, num_trials=args.hpo,
            max_epochs=args.epochs or 8, seed=cfg.seed,
            n_workers=args.hpo_workers,
            log_path=(os.path.join(args.results_dir, f"{dataset}_hpo.jsonl")
                      if main_rank else None))
        line = "HPO_BEST " + json.dumps(
            {"params": best.params, "valid_mrr": best.metric,
             "epochs": best.epochs_done}, default=float)
        if logger is not None:
            logger.write_perf(line)
            logger.close()
        say(line)
        return

    def apply_lr_override():
        # a temporal restore brings back the checkpoint's live lr; an
        # explicit --set lr=... wins over it
        if hasattr(trainer, "force_lr") and "lr" in {
                p.partition("=")[0] for p in args.set or []}:
            trainer.force_lr(cfg.lr)
            say(f"lr override after restore: {cfg.lr}")

    start_epoch = 0
    if args.load_checkpoint:
        epoch = trainer.restore(args.load_checkpoint)
        say(f"restored checkpoint from epoch {epoch}")
        apply_lr_override()
    elif args.resume_latest and args.ckpt_dir:
        try:
            latest = load_latest(args.ckpt_dir, trainer.state())
        except ValueError as e:  # e.g. a checkpoint of another model shape
            say(f"latest checkpoint incompatible ({e}); starting fresh")
            latest = None
        if latest is not None:
            state, start_epoch, _ = latest
            trainer.load_state(state)
            # host state (re-split rng; temporal: lr, plateau, rngs)
            trainer.restore_host(os.path.join(args.ckpt_dir, "latest" + EXT))
            say(f"resuming from latest checkpoint at epoch {start_epoch}")
            apply_lr_override()

    def dump_attention_stats():
        if not args.attention_stats:
            return
        if not hasattr(trainer, "collect_attention"):
            say("--attention_stats supports temporal redgnn only")
            return
        acc = trainer.collect_attention("valid")
        if main_rank:
            np.savez(args.attention_stats, stats=acc)
        say(f"attention stats (sum/count by query-rel x edge-rel) -> "
            f"{args.attention_stats}")

    def eval_extra_splits():
        if not args.eval_splits:
            return
        # a temporal KG's named splits; a static KG's valid and test
        known = getattr(trainer.kg, "splits", None)
        if known is None and hasattr(trainer.kg, "eval_spec"):
            known = ("valid", "test")
        out = {}
        for split in args.eval_splits.split(","):
            split = split.strip()
            if known is None or split not in known:
                say(f"eval split '{split}' not available; skipping")
                continue
            out[split] = trainer.evaluate(split)
        line = "EVAL_SPLITS " + json.dumps(out, default=float)
        if logger is not None:
            logger.write_perf(line)
        say(line)

    if args.eval_only:
        vm = trainer.evaluate("valid")
        tm = trainer.evaluate("test")
        say(json.dumps({"valid": vm, "test": tm}, default=float))
        eval_extra_splits()
        dump_attention_stats()
        if logger is not None:
            logger.close()
        return

    from redgnn_tpu_torch.utils.linetrace import maybe_trace_from_env

    trace = maybe_trace_from_env() if main_rank else contextlib.nullcontext()
    with PeakRSSMonitor() as mon, trace:
        best = trainer.fit(epochs=args.epochs, log=say, logger=logger,
                           ckpt_dir=args.ckpt_dir if main_rank else None,
                           start_epoch=start_epoch)
    if logger is not None:
        say(write_memory_report(logger.mem_path, "run", mon.peak_rss_bytes))
        logger.write_perf("BEST " + json.dumps(best, default=float))
    say("BEST", json.dumps(best, default=float))
    if args.eval_splits:
        # the seen/unseen protocol runs on the best-valid checkpoint
        if args.ckpt_dir:
            if mesh is not None:
                mesh.barrier()  # rank 0 has written it
            bp = best_checkpoint(args.ckpt_dir)
            if bp:
                trainer.restore(bp)
                say(f"eval_splits: restored best checkpoint {bp}")
        eval_extra_splits()
    dump_attention_stats()
    if logger is not None:
        logger.close()


if __name__ == "__main__":
    main()
