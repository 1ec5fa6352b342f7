"""The port's utilities against the JAX package's on the CPU: the
experiment logger (perf text, metrics JSONL, sqlite), the memory report,
the ASHA search (one seed, the same trials), the line tracer, the
attention statistics (`TRedGNN(collect_alpha=True)`,
`TemporalTrainer.collect_attention`) and the plots, the timestamped
checkpoint directory, and `fit(logger=...)` of the four trainers through
the CLI's --results_dir / --attention_stats."""

import json
import os
import re
import sqlite3

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from redgnn_tpu.graph.temporal import TemporalKG as JKG
from redgnn_tpu.train import temporal_loop as jloop
from redgnn_tpu.utils import checkpoint as jckpt
from redgnn_tpu.utils import hpo as jhpo
from redgnn_tpu.utils import memory as jmemory
from redgnn_tpu.utils import reporting as jreporting
from redgnn_tpu.utils import viz as jviz
from redgnn_tpu.utils.config import TemporalTrainConfig as JConfig
from redgnn_tpu_torch.cli.train import main as cli_main
from redgnn_tpu_torch.graph.temporal import TemporalKG
from redgnn_tpu_torch.train import temporal_loop as tloop
from redgnn_tpu_torch.utils import checkpoint as ckpt
from redgnn_tpu_torch.utils import hpo, linetrace, memory, reporting, viz
from redgnn_tpu_torch.utils.config import TemporalTrainConfig, TrainConfig
from redgnn_tpu_torch.utils.port_params import (
    params_from_flax,
    temporal_opt_state_from_optax,
)

from test_temporal import write_temporal_dir
from test_torch_temporal import write_id_dir
from test_train_loop import write_kg

INTERP = dict(hidden_dim=8, attn_dim=6, n_layer=2, dropout=0.0, lr=5e-3,
              batch_size=8, eval_batch_size=8, dense_switch=0.4,
              scan_src_backward=False)


def _drive_logger(mod, root, sqlite):
    cfg = TrainConfig(hidden_dim=16)
    lg = mod.ExperimentLogger(str(root), "run", cfg,
                              sqlite_path=str(root / "x.db") if sqlite
                              else None)
    lg.write_perf("hello")
    lg.log_scalars(3, {"loss": 1.5, "lr": np.float32(0.25)})
    line = lg.epoch_line(0, {"mrr": 0.5, "h1": 0.25, "h10": 0.75},
                         {"mrr": 0.4, "h1": 0.2, "h10": 0.6}, 1.0, 2.0)
    lg.close()
    return line


@pytest.mark.parametrize("sqlite", [False, True])
def test_experiment_logger_matches_jax(tmp_path, sqlite):
    """The same calls write the same perf text, the same JSONL records
    (but for the clock) and the same sqlite rows in both packages."""
    out = {}
    for name, mod in (("jax", jreporting), ("port", reporting)):
        root = tmp_path / name
        line = _drive_logger(mod, root, sqlite)
        perf = (root / "run_perf.txt").read_text()
        recs = [json.loads(x) for x in
                (root / "run_metrics.jsonl").read_text().splitlines()]
        for r in recs:
            assert r.pop("t") >= 0
        rows = None
        if sqlite:
            db = sqlite3.connect(str(root / "x.db"))
            rows = (db.execute("SELECT name, config FROM runs").fetchall(),
                    [(s, t, {k: v for k, v in json.loads(p).items()
                             if k != "t"}) for s, t, p in db.execute(
                        "SELECT step, tag, payload FROM metrics")])
            db.close()
        out[name] = (line, perf, recs, rows)
    assert out["port"] == out["jax"]
    assert out["port"][1].splitlines()[1] == "hello"
    assert out["port"][0].startswith("[VALID] MRR:0.5000")


def test_memory_report(tmp_path):
    """Without a card the device figures are 0; the peak RSS sampler sees
    this process; the report line has the JAX package's shape."""
    assert memory.device_memory_stats() == {"bytes_in_use": 0,
                                            "peak_bytes_in_use": 0}
    with memory.PeakRSSMonitor(interval_sec=0.01) as mon:
        np.ones(4_000_000).sum()
    assert mon.peak_rss_bytes > 0
    path = str(tmp_path / "m" / "mem.txt")
    line = memory.write_memory_report(path, "run", mon.peak_rss_bytes)
    want = jmemory.write_memory_report(None, "run", mon.peak_rss_bytes)
    strip = lambda s: re.sub(r"HBM_\w+=[^,]+,|\"hbm_\w+\": \d+, ", "", s)
    assert strip(line) == strip(want)
    payload = json.loads(line.split("json=", 1)[1])
    assert payload["cpu_rss_peak_bytes"] == mon.peak_rss_bytes
    assert open(path).read().strip() == line
    assert memory._format_bytes(1536) == jmemory._format_bytes(1536)


def _trial_metric(p):
    return float(np.log(p["lr"]) + p["n_layer"] + 0.1 * p["hidden_dim"]
                 - p["dropout"])


@pytest.mark.parametrize("space", ["STATIC_SPACE", "INTERPOLATION_SPACE"])
def test_asha_search_matches_jax(tmp_path, space):
    """One seed: the same trials sampled, the same rungs, the same
    survivors and the same best trial, sequentially and with 2 worker
    threads."""
    def run(mod, workers, log):
        seen = []

        def run_trial(params, epochs, state):
            done = (state or 0) + epochs
            seen.append((json.dumps(params, sort_keys=True, default=float),
                         done))
            return _trial_metric(params) + done, done

        best = mod.asha_search(getattr(mod, space), run_trial, num_trials=8,
                               max_epochs=4, seed=11, log_path=log,
                               n_workers=workers)
        return best, sorted(seen)

    jbest, jseen = run(jhpo, 1, str(tmp_path / "j.jsonl"))
    for workers in (1, 2):
        log = str(tmp_path / f"p{workers}.jsonl")
        best, seen = run(hpo, workers, log)
        assert seen == jseen
        assert (best.trial_id, best.params, best.metric, best.epochs_done,
                best.history) == (jbest.trial_id, jbest.params, jbest.metric,
                                  jbest.epochs_done, jbest.history)
        lines = [json.loads(x) for x in open(log).read().splitlines()]
        assert len(lines) == len(jseen) == 8 + 4 + 2


def test_line_tracer(tmp_path, monkeypatch):
    """The tracer brackets the traced code; on the CPU the census is 0, so
    no line is recorded; REDGNN_LINE_TRACE turns it on."""
    path = str(tmp_path / "trace.txt")
    with linetrace.LineMemoryTracer(path, module_filter="test_torch_utils"):
        sum(range(10))
    text = open(path).read().splitlines()
    assert text[0].startswith("=== line trace start") and \
        text[-1] == "=== line trace end ==="
    assert linetrace._live_bytes() == 0
    monkeypatch.delenv("REDGNN_LINE_TRACE", raising=False)
    assert not isinstance(linetrace.maybe_trace_from_env(),
                          linetrace.LineMemoryTracer)
    monkeypatch.setenv("REDGNN_LINE_TRACE", path)
    tracer = linetrace.maybe_trace_from_env()
    assert isinstance(tracer, linetrace.LineMemoryTracer)
    assert tracer.module_filter == "redgnn_tpu_torch"


def test_viz_stats_and_plots(tmp_path, rng):
    """collect_attention_stats equals the JAX package's; the plots write
    their PNGs."""
    e, n_rel = 200, 7
    args = (rng.random(e), rng.integers(0, n_rel, e),
            rng.integers(0, n_rel, e), rng.random(e) < 0.8, n_rel)
    np.testing.assert_array_equal(viz.collect_attention_stats(*args),
                                  jviz.collect_attention_stats(*args))
    jsonl = tmp_path / "m.jsonl"
    jsonl.write_text("".join(json.dumps({"step": i, "valid_mrr": 0.1 * i})
                             + "\n" for i in range(4)))
    curve = viz.plot_learning_curves({"a": str(jsonl)},
                                     out_path=str(tmp_path / "c.png"))
    heat = viz.plot_attention_heatmap(rng.random((5, 6)),
                                      out_path=str(tmp_path / "h.png"))
    for p in (curve, heat):
        assert os.path.getsize(p) > 0


def test_collect_attention_matches_jax(tmp_path, rng):
    """TemporalTrainer.collect_attention through TRedGNN(collect_alpha=True)
    on the same weights: the same (query rel, edge rel) counts, and sums
    within 1e-5."""
    d = str(write_temporal_dir(tmp_path, rng))
    jt = jloop.TemporalTrainer(JKG.load_vocab_dir(d), JConfig(**INTERP))
    pt = tloop.TemporalTrainer(TemporalKG.load_vocab_dir(d, device="cpu"),
                               TemporalTrainConfig(**INTERP))
    pt.load_state({
        "params": params_from_flax(jax.device_get(jt.params)),
        "opt_state": temporal_opt_state_from_optax(
            serialization.to_state_dict(jax.device_get(jt.opt_state)))})
    want = jt.collect_attention("valid", max_batches=3)
    got = pt.collect_attention("valid", max_batches=3)
    assert got.shape == want.shape == (pt.model_cfg.n_rel_vocab,) * 2 + (2,)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    assert want[..., 1].sum() > 0
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=1e-5,
                               atol=1e-5)


def test_new_checkpoint_dir(tmp_path):
    """A timestamped directory named as the JAX package names it."""
    path = ckpt.new_checkpoint_dir(str(tmp_path), prefix="run")
    assert os.path.isdir(path)
    name = os.path.basename(path)
    assert re.fullmatch(r"run_\d{4}(_\d{2}){5}", name), name
    want = os.path.basename(jckpt.new_checkpoint_dir(str(tmp_path / "j"),
                                                     prefix="run"))
    assert len(want) == len(name) and want[:8] == name[:8]


@pytest.mark.parametrize("model", ["static", "temporal", "xerte", "simple"])
def test_fit_logger_through_cli(tmp_path, rng, capsys, model):
    """fit(logger=...) of each trainer, reached through the CLI's
    --results_dir: the JSONL gets each epoch's metrics row (after the
    best/test update), the perf file the config echo and the BEST line,
    the memory report its line."""
    if model == "static":
        (tmp_path / "kg").mkdir()
        data = str(write_kg(tmp_path / "kg", rng))
        argv = ["--task", "transductive", "--set", "hidden_dim=16",
                "n_layer=2", "n_batch=16", "n_tbatch=16"]
    else:
        data = write_id_dir(tmp_path / "toy_forecasting", rng)
        argv = ["--task", "extrapolation"]
        if model == "temporal":
            argv += ["--set", "hidden_dim=8", "attn_dim=6", "n_layer=2",
                     "batch_size=16", "eval_batch_size=16",
                     "max_train_batches=2", "max_eval_batches=2", "window=6"]
        elif model == "xerte":
            argv += ["--model", "xerte", "--set", "batch_size=16",
                     "max_train_batches=2", "max_eval_batches=2",
                     "dp_steps=2", "dp_num_edges=4", "max_attended_edges=6"]
        else:
            argv += ["--model", "simple"]
    res = tmp_path / "res"
    cli_main(["--data_path", data, "--device", "cpu", "--epochs", "2",
              "--results_dir", str(res)] + argv)
    name = os.path.basename(data)
    recs = [json.loads(x) for x in
            (res / f"{name}_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(r["tag"] == "eval" and 0.0 <= r["valid_mrr"] <= 1.0
               for r in recs)
    perf = (res / f"{name}_perf.txt").read_text().splitlines()
    assert json.loads(perf[0])  # the config
    assert perf[-1].startswith("BEST ")
    if model == "static":
        assert sum(ln.startswith("[VALID] MRR:") for ln in perf) == 2
    elif model != "simple":  # SimplE logs before its best/test update
        # a best epoch's row carries its test metrics
        best = json.loads(perf[-1][5:])
        assert any(r["epoch"] == best["epoch"] and any(
            k.startswith("test_") for k in r) for r in recs)
    assert "cpu_rss_peak_bytes" in (res / f"{name}_mem.txt").read_text()


def test_cli_attention_stats(tmp_path, rng, capsys):
    """--attention_stats writes the (n_rel, n_rel, 2) statistics of the
    temporal model after training; counts are whole numbers."""
    d = str(write_temporal_dir(tmp_path, rng))
    out = str(tmp_path / "a.npz")
    cli_main(["--task", "interpolation", "--data_path", d, "--device",
              "cpu", "--epochs", "1", "--results_dir", str(tmp_path / "r"),
              "--attention_stats", out, "--set", "hidden_dim=8",
              "attn_dim=6", "n_layer=2", "batch_size=16",
              "eval_batch_size=16", "max_train_batches=2"])
    assert "attention stats" in capsys.readouterr().out.splitlines()[-1]
    stats = np.load(out)["stats"]
    n = TemporalKG.load_vocab_dir(d, device="cpu").n_rel + 1
    assert stats.shape == (n, n, 2)
    assert stats[..., 1].sum() > 0
    np.testing.assert_array_equal(stats[..., 1], np.round(stats[..., 1]))
    assert (stats[..., 0] <= stats[..., 1] + 1e-9).all()  # sigmoid <= 1
