"""Memory accounting: host RSS peaks + device memory stats.

Capability parity with the reference's two meters
(`Static/transductive/utils.py:67-159` PeakRSSMonitor sampling thread;
`Static/inductive/utils.py:74-159` PeakMemoryMeter poll-on-update).

Port of ``redgnn_tpu/utils/memory.py``: the device figures come from
``torch.cuda.memory_stats()`` (``allocated_bytes.all.current`` /
``.peak`` of the current card) where the JAX package reads
``device.memory_stats()``; without a card they are 0. The report keeps
the JAX package's field names (``hbm_*``): the H100's memory is HBM too.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

try:
    import psutil
except Exception:  # pragma: no cover
    psutil = None


def _format_bytes(num: Optional[int]) -> str:
    if num is None:
        return "N/A"
    x = float(num)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if x < 1024.0 or unit == "TB":
            return f"{x:.2f}{unit}"
        x /= 1024.0
    return f"{num}B"


def device_memory_stats() -> Dict[str, int]:
    """Peak/current memory allocated by PyTorch on the current CUDA
    device (0s without one)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0}
    stats = torch.cuda.memory_stats()
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
    }


class PeakRSSMonitor:
    """Background sampler for per-section host RSS peaks."""

    def __init__(self, interval_sec: float = 0.1):
        self.interval_sec = interval_sec
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.peak_rss_bytes = 0

    def _run(self):
        proc = psutil.Process(os.getpid())
        peak = 0
        while not self._stop.is_set():
            try:
                peak = max(peak, proc.memory_info().rss)
            except Exception:
                pass
            time.sleep(self.interval_sec)
        self.peak_rss_bytes = max(self.peak_rss_bytes, peak)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def start(self):
        self.peak_rss_bytes = 0
        self._stop.clear()
        if psutil is None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


def write_memory_report(path: str, tag: str, rss_peak_bytes: int) -> str:
    """Append a human + JSON memory line (reference report shape,
    `Static/transductive/utils.py:145-159`)."""
    dev = device_memory_stats()
    payload = {
        "tag": tag,
        "hbm_bytes_in_use": dev["bytes_in_use"],
        "hbm_peak_bytes_in_use": dev["peak_bytes_in_use"],
        "cpu_rss_peak_bytes": int(rss_peak_bytes),
    }
    line = (
        f"[{tag}] HBM_in_use={_format_bytes(dev['bytes_in_use'])}, "
        f"HBM_peak={_format_bytes(dev['peak_bytes_in_use'])}, "
        f"CPU_peak_RSS={_format_bytes(rss_peak_bytes)} "
        f"| json={json.dumps(payload)}\n"
    )
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a+", encoding="utf-8") as f:
            f.write(line)
    return line.strip()
