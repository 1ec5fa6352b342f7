"""Build the port's native libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into a shared library under ``redgnn_tpu_torch/_build/``
(git-ignored), then loaded with ``ctypes``. The host-side graph walker
``native/<name>.cpp`` is built the same way by the host's C++ compiler
(``g++``, else ``c++``; ``nvcc`` needs one too). A library's file name
carries a hash of its source and the headers beside it (``*.cuh``), so
an edited source is rebuilt and never confused with a stale library; it
is compiled to a temporary name that holds the process id and moved into
place with ``os.replace`` (dlopen caches by inode, a half-written file is
never loaded, and processes that build at once do not clash).
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
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# every csrc/<name>.cu the port launches
KERNELS = ("segment_sum_sorted", "range_sum", "take_rows_grad", "list_sum",
           "slot_owner", "dense_hop_static", "dense_hop_temporal",
           "dense_hop_static_bwd", "dense_hop_temporal_bwd")


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


def _host_cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the "
                       "native graph walker is built with one")


def _library_path(src: str, name: str) -> str:
    # the hash covers the headers beside the source (csrc/*.cuh) too
    h = hashlib.sha1()
    folder = os.path.dirname(src)
    for path in [src] + sorted(os.path.join(folder, f)
                               for f in os.listdir(folder)
                               if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built to (hash of its source and the
    headers beside it)."""
    return _library_path(os.path.join(CSRC_DIR, f"{name}.cu"), name)


def _compile(path: str, command, what: str) -> dict:
    """Run ``command(tmp)`` to build the library ``path`` unless it is
    there. Returns ``{"path", "seconds", "log"}``: seconds spent compiling
    (0.0 when the library was already built) and the compiler's output."""
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"path": path, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run(command(tmp), capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (rc {proc.returncode}):\n{log}")
    with open(f"{log_path}.tmp{os.getpid()}", "w") as f:
        f.write(log)
    os.replace(f"{log_path}.tmp{os.getpid()}", log_path)
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": log}


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` with nvcc if its library is not built
    yet; nvcc's output holds the ``-Xptxas -v`` register and
    shared-memory report."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return _compile(library_path(name),
                    lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    f"nvcc for {name}.cu")


def build_host(name: str) -> dict:
    """Compile ``native/<name>.cpp`` with the host's C++ compiler if its
    library is not built yet."""
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    return _compile(_library_path(src, name),
                    lambda tmp: [_host_cxx(), *HOST_FLAGS, src, "-o", tmp],
                    f"the host compiler for {name}.cpp")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(build(name)["path"])


_ENTRIES: dict = {}


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` as a ctypes
    function returning int, its library built and loaded at first use."""
    if (name, symbol) not in _ENTRIES:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name, symbol] = fn
    return _ENTRIES[name, symbol]


def launch(fn, args, tensor, what: str) -> None:
    """Call ``fn(*args, stream)`` with the current stream of ``tensor``'s
    CUDA device, that device current (a kernel launches on the current
    device). Raises when the entry point returns a CUDA error: a failed
    launch, or arguments it refuses."""
    import torch

    index = tensor.get_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed or was refused: "
                           f"cudaError {err}")
