"""Phase timers — the `time_cost` buckets of the reference
(`Temporal/extrapolation/main.py:39-52`, `train.py:26-39`): nested
wall-clock accounting behind a flag. A phase that ends on a CUDA device
should synchronise before it closes; the trainer's phases end in a
device-to-host copy, which does."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class PhaseTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.buckets: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))

    @contextmanager
    def phase(self, group: str, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            self.buckets[group][name] += time.time() - t0

    def reset(self):
        self.buckets.clear()

    def __str__(self) -> str:
        parts = []
        for group in sorted(self.buckets):
            inner = ", ".join(f"{k}: {v:.3f}s" for k, v in
                              sorted(self.buckets[group].items()))
            parts.append(f"[{group}] {inner}")
        return " | ".join(parts) or "(no timings)"
