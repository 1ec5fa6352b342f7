"""Experiment reporting: perf files, JSONL metrics, sqlite run tracking.

Port of ``redgnn_tpu/utils/reporting.py`` (the same code: it needs only
the standard library).

Capability parity with the reference's observability surface:
  * append-only perf text files (`Static/transductive/base_model.py:151`,
    `train.py:117-126`),
  * JSON result dumps (`Temporal/interpolation/util.py:152-168`),
  * the experiment database (`Temporal/extrapolation/database_op.py` —
    sqlite only; the hard-coded MongoDB credentials at
    `database_op.py:69` are a documented non-goal),
  * scalar time-series (TensorBoard replaced by JSONL, which needs no
    dependency and greps/plots trivially).
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from dataclasses import asdict, is_dataclass
from typing import Any, Dict, Optional


class ExperimentLogger:
    """Writes per-run perf text + metrics JSONL; optionally sqlite."""

    def __init__(self, results_dir: str, run_name: str,
                 config: Any = None, sqlite_path: Optional[str] = None):
        os.makedirs(results_dir, exist_ok=True)
        self.results_dir = results_dir
        self.run_name = run_name
        self.git_hash = self._git_hash()  # `extrapolation/utils.py:588-592`
        self.perf_path = os.path.join(results_dir, f"{run_name}_perf.txt")
        self.mem_path = os.path.join(results_dir, f"{run_name}_mem.txt")
        self.jsonl_path = os.path.join(results_dir, f"{run_name}_metrics.jsonl")
        self.t0 = time.time()
        self._db = None
        self._run_id = None
        if config is not None:
            cfg = asdict(config) if is_dataclass(config) else dict(config)
            self.write_perf(json.dumps(cfg))
        if sqlite_path:
            self._open_db(sqlite_path, config)

    @staticmethod
    def _git_hash() -> str:
        try:
            import subprocess

            return subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip()
        except Exception:
            return ""

    # -- text + jsonl ---------------------------------------------------
    def write_perf(self, line: str) -> None:
        with open(self.perf_path, "a+") as f:
            f.write(line.rstrip("\n") + "\n")

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    tag: str = "train") -> None:
        rec = {"t": round(time.time() - self.t0, 3), "step": step,
               "tag": tag, **{k: float(v) for k, v in scalars.items()}}
        with open(self.jsonl_path, "a+") as f:
            f.write(json.dumps(rec) + "\n")
        if self._db is not None:
            self._db.execute(
                "INSERT INTO metrics(run_id, step, tag, payload) "
                "VALUES (?,?,?,?)",
                (self._run_id, step, tag, json.dumps(rec)),
            )
            self._db.commit()

    def epoch_line(self, epoch: int, valid: Dict[str, float],
                   test: Dict[str, float], train_time: float,
                   infer_time: float) -> str:
        """The reference's canonical perf line (`base_model.py:151`)."""
        line = (
            "[VALID] MRR:%.4f H@1:%.4f H@10:%.4f\t "
            "[TEST] MRR:%.4f H@1:%.4f H@10:%.4f \t"
            "[TIME] train:%.4f inference:%.4f" % (
                valid["mrr"], valid["h1"], valid["h10"],
                test["mrr"], test["h1"], test["h10"],
                train_time, infer_time,
            )
        )
        self.write_perf(line)
        self.log_scalars(epoch, {
            "valid_mrr": valid["mrr"], "valid_h1": valid["h1"],
            "valid_h10": valid["h10"], "test_mrr": test["mrr"],
            "test_h1": test["h1"], "test_h10": test["h10"],
        }, tag="eval")
        return line

    # -- sqlite run tracking -------------------------------------------
    def _open_db(self, path: str, config: Any) -> None:
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS runs("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT, "
            "started REAL, config TEXT)"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS metrics("
            "run_id INTEGER, step INTEGER, tag TEXT, payload TEXT)"
        )
        cfg = asdict(config) if is_dataclass(config) else dict(config or {})
        cur = self._db.execute(
            "INSERT INTO runs(name, started, config) VALUES (?,?,?)",
            (self.run_name, time.time(), json.dumps(cfg)),
        )
        self._run_id = cur.lastrowid
        self._db.commit()

    def close(self):
        if self._db is not None:
            self._db.close()
            self._db = None
