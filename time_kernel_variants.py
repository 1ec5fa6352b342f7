#!/usr/bin/env python3
"""Time builds of the sorted-segment-sum kernel beside the tree's, on one
NVIDIA GPU, at the hop shapes of chip_smoke.py's slice.

Run from the repository root:

    python3 time_kernel_variants.py --variant [FILE][:NAME=VALUE,...] ...

A variant is FILE, a .cu with the kernel's C entry point
``segment_sum_sorted_f32`` (default: the tree's
``redgnn_tpu_torch/csrc/segment_sum_sorted.cu``), with each named
``constexpr int NAME = ...;`` of it set to VALUE in a copy, e.g.
``--variant :kSegs=32`` for 32 segments per block. All variants are
compiled at once with the kernel's nvcc flags, one nvcc each. At each hop
of one served batch (batch 50, L=3, D=48), every variant is checked
against the plain version and its device time (CUDA graph, inputs in L2,
as chip_smoke.py times the kernel) is printed beside the tree kernel's,
timed before and after the variants in the same process. The last line
is a JSON object of the times.
Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from chip_smoke import (
    KERNEL_TOL,
    N_BATCHES,
    build_slice,
    device_ms,
    kernel_hops,
    log,
    log_ptxas,
    phase_build,
    phase_device,
    serving_queries,
    write_synthetic_kg,
)


def variant_source(spec: str, tmp: str, i: int) -> str:
    """Path of the source of ``FILE[:NAME=VALUE,...]``: FILE itself, or a
    copy in ``tmp`` with each named constant set."""
    from redgnn_tpu_torch import _build

    path, _, sets = spec.partition(":")
    path = path or os.path.join(_build.CSRC_DIR, "segment_sum_sorted.cu")
    if not sets:
        return path
    src = open(path).read()
    for item in sets.split(","):
        name, _, value = item.partition("=")
        if not value:
            raise ValueError(f"{spec}: {item!r} is not NAME=VALUE")
        src, hits = re.subn(rf"(constexpr int {name} = )[^;]+;",
                            rf"\g<1>{value};", src)
        if hits != 1:
            raise ValueError(f"{spec}: {hits} definitions of {name} in "
                             f"{path}")
    out = os.path.join(tmp, f"variant{i}.cu")
    with open(out, "w") as f:
        f.write(src)
    return out


def build_variants(specs, tmp: str):
    """[(spec, ctypes function)] of each variant, all compiled at once
    with the kernel's own nvcc flags."""
    from redgnn_tpu_torch import _build

    procs = []
    for i, spec in enumerate(specs):
        lib = os.path.join(tmp, f"libvariant{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
               variant_source(spec, tmp, i)]
        procs.append((spec, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    t0 = time.perf_counter()
    out = []
    for spec, lib, proc in procs:
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {spec}:\n{text}")
        log(f"[build] variant {spec!r}:")
        log_ptxas(text)
        fn = ctypes.CDLL(lib).segment_sum_sorted_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out.append((spec, fn))
    log(f"[build] {len(specs)} variants in {time.perf_counter() - t0:.2f} s")
    return out


def raw_sum(fn, data, seg, n):
    """One launch of a build ``fn`` of the C entry point on the current
    stream, with the wrapper's launch plan; not counted as a launch of
    the wrapper."""
    from redgnn_tpu_torch.ops.segment_sorted import BN, _launch_plan

    e, d = data.shape
    out = torch.empty(n, d, device=data.device)
    err = fn(data.data_ptr(), seg.data_ptr(), None, out.data_ptr(), e, d, n,
             BN, int(_launch_plan(n, d, data.data_ptr()).vec),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"cudaError {err}"
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True,
                    metavar="[FILE][:NAME=VALUE,...]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernel_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    from redgnn_tpu_torch.ops.segment_sorted import (
        segment_sum_sorted,
        segment_sum_sorted_reference,
    )

    _, card = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        variants = build_variants(args.variant, tmp)
        write_synthetic_kg(tmp)
        kg, _, _, pred = build_slice(tmp, "cuda")
    queries = serving_queries(kg, N_BATCHES * pred.batch)[:pred.batch]

    rows = []
    for i, (msg, seg, _, n_valid, n) in enumerate(kernel_hops(pred, queries)):
        want = segment_sum_sorted_reference(msg, seg, n)[0]
        t_tree = [device_ms(lambda: segment_sum_sorted(msg, seg, n))]
        times = {}
        for spec, fn in variants:
            torch.testing.assert_close(raw_sum(fn, msg, seg, n), want,
                                       **KERNEL_TOL)
            times[spec] = device_ms(lambda: raw_sum(fn, msg, seg, n))
        t_tree.append(device_ms(lambda: segment_sum_sorted(msg, seg, n)))
        log(f"[variants] hop {i}: E={msg.shape[0]} ({n_valid} valid) "
            f"D={msg.shape[1]} N={n}: tree kernel "
            f"{t_tree[0]:.4f} / {t_tree[1]:.4f} ms (before / after); "
            + "; ".join(f"{spec!r} {t:.4f} ms" for spec, t in times.items())
            + f" (device, CUDA graph, inputs in L2; {card})")
        rows.append({"E": msg.shape[0], "valid": n_valid, "N": n,
                     "tree_ms": t_tree, "variant_ms": times})
    print(json.dumps({"card": card, "hops": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
