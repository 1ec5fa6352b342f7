"""Line-level device-memory tracer — counterpart of the reference's
`sys.settrace` + py3nvml profiler
(`Temporal/extrapolation/gpu_profile.py:17-113`).

Port of ``redgnn_tpu/utils/linetrace.py``. The reference hooks every
Python line and records the GPU memory delta via nvml, plus a
live-tensor census through `gc`. Here the same `sys.settrace` mechanism
records the delta of the bytes PyTorch has allocated on the current CUDA
device (``torch.cuda.memory_allocated()``, 0 on the CPU), where the JAX
package counts ``jax.live_arrays()``, and writes `file:line  +delta
total` records for any line whose delta exceeds a threshold.

Enable with the ``REDGNN_LINE_TRACE`` env var (output path) or the context
manager:

    with LineMemoryTracer("linetrace.txt", module_filter="redgnn_tpu_torch"):
        trainer.train_epoch(0)

Tracing every line is slow (that is true of the reference too) — this is a
debugging tool, never enabled in production paths.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, TextIO


def _live_bytes() -> int:
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


class LineMemoryTracer:
    """sys.settrace hook writing per-line device-memory deltas."""

    def __init__(self, path: str, module_filter: str = "redgnn_tpu_torch",
                 min_delta_bytes: int = 1 << 12):
        self.path = path
        self.module_filter = module_filter
        self.min_delta = min_delta_bytes
        self._out: Optional[TextIO] = None
        self._last = 0
        self._prev_trace = None
        # The line that executed between the previous event and this one.
        # sys.settrace 'line' events fire BEFORE a line runs, so a delta
        # observed now belongs to the PREVIOUS recorded line.
        self._pending: Optional[tuple] = None

    def _flush(self):
        now = _live_bytes()
        delta = now - self._last
        if (self._pending is not None and abs(delta) >= self.min_delta
                and self._out is not None):
            fname, lineno, func = self._pending
            self._out.write(
                f"{fname}:{lineno} ({func}) {delta / 1e6:+.3f}MB "
                f"total={now / 1e6:.3f}MB\n")
        self._last = now

    def _trace(self, frame, event, arg):
        if event == "call":
            fname = frame.f_code.co_filename
            if self.module_filter and self.module_filter not in fname:
                # foreign module: attribute anything it allocates to the
                # traced line that called into it (still pending), but
                # don't trace its lines
                return None
            return self._trace
        if event == "line" or event == "return":
            self._flush()
            code = frame.f_code
            self._pending = (
                (code.co_filename, frame.f_lineno, code.co_name)
                if event == "line" else None)
        return self._trace

    def __enter__(self):
        self._out = open(self.path, "a")
        self._out.write(f"=== line trace start (pid {os.getpid()}) ===\n")
        self._last = _live_bytes()
        self._prev_trace = sys.gettrace()
        sys.settrace(self._trace)
        return self

    def __exit__(self, *exc):
        sys.settrace(self._prev_trace)
        if self._out is not None:
            self._out.write("=== line trace end ===\n")
            self._out.close()
            self._out = None
        return False


def maybe_trace_from_env():
    """Context factory honoring REDGNN_LINE_TRACE, mirroring the
    reference's GPU_DEBUG env toggle (`gpu_profile.py`)."""
    path = os.environ.get("REDGNN_LINE_TRACE")
    if not path:
        from contextlib import nullcontext

        return nullcontext()
    return LineMemoryTracer(path)
