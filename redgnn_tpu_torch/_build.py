"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into a shared library under ``redgnn_tpu_torch/_build/``
(git-ignored), then loaded with ``ctypes``. The file name carries a hash
of the source, so an edited kernel is rebuilt and never confused with a
stale one; the library is compiled to a temporary name and moved into
place with ``os.replace`` (dlopen caches by inode, and a half-written file
is never loaded).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (PATH or CUDA_HOME)")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built to (hash of its source)."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` if its library is not built yet.

    Returns ``{"path", "seconds", "log"}``: seconds spent in nvcc (0.0
    when the library was already there) and nvcc's output, which holds
    the ``-Xptxas -v`` register and shared-memory report."""
    path = library_path(name)
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"path": path, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": log}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(build(name)["path"])
