"""ctypes bindings of the port's host-side graph walker, ``graphcore.cpp``.

Port of ``redgnn_tpu/native/__init__.py``: the same functions with the
same arguments and returns (``build_csr_temporal`` is bound here too).
The library is built at first use by the host's C++ compiler into
``redgnn_tpu_torch/_build/`` (`_build.build_host`). Unlike the JAX
package's bindings, which return None and let their callers fall back to
numpy when the build fails, these raise: a failed build raises
RuntimeError with the compiler's output, and a nonzero return code (the
library's answer to a head outside ``[0, n_ent)``) raises ValueError.
Inputs the library does not check itself (the CSR arrays, the walks'
heads, times and window) are checked here before the call, so that no
call reads out of bounds. The library is single-threaded, as the JAX
package's is.

Inputs are converted to the contiguous int32 / int64 arrays the C
functions take, whatever the caller's integer dtype.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

_LIB = None


def library() -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    global _LIB
    if _LIB is None:
        from redgnn_tpu_torch import _build

        lib = ctypes.CDLL(_build.build_host("graphcore")["path"])
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        n = ctypes.c_int64
        lib.build_csr.argtypes = [i64p, n, n, i32p, i32p, i32p]
        lib.build_csr_temporal.argtypes = [i64p, n, n] + [i32p] * 5
        lib.simulate_hops.argtypes = [i32p, i32p, n, i64p, n, n, i64p, i64p]
        lib.per_query_hop_counts.argtypes = lib.simulate_hops.argtypes
        lib.simulate_hops_windowed.argtypes = [
            i32p, i32p, n, n, n, i64p, i64p, n, n, n, i64p, i64p]
        lib.per_query_hop_counts_windowed.argtypes = \
            lib.simulate_hops_windowed.argtypes
        for fn in (lib.build_csr, lib.build_csr_temporal, lib.simulate_hops,
                   lib.per_query_hop_counts, lib.simulate_hops_windowed,
                   lib.per_query_hop_counts_windowed):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _call(name: str, *args) -> None:
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise ValueError(f"graphcore.{name} returned {rc}: an input is out "
                         "of range")


def _ids(a, dtype, what: str, lo: int, hi: int) -> np.ndarray:
    """``a`` as a contiguous ``dtype`` array whose values lie in
    [lo, hi)."""
    a = np.ascontiguousarray(a, dtype)
    if a.size and (int(a.min()) < lo or int(a.max()) >= hi):
        raise ValueError(f"{what} out of range [{lo}, {hi}): "
                         f"[{int(a.min())}, {int(a.max())}]")
    return a


def _csr(rowptr, tail, n_ent: int) -> Tuple[np.ndarray, np.ndarray]:
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    tail = _ids(tail, np.int32, "tail", 0, n_ent)
    if rowptr.shape != (n_ent + 1,) or (n_ent and (
            rowptr[0] != 0 or rowptr[-1] != len(tail)
            or np.any(np.diff(rowptr) < 0))):
        raise ValueError(f"rowptr is not a CSR row index of {n_ent} rows "
                         f"over {len(tail)} edges")
    return rowptr, tail


def _window_keys(ekey, tail, n_ent: int, key_base: int, window: int):
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if n_ent * key_base >= 2 ** 31:
        raise ValueError(f"n_ent * key_base = {n_ent * key_base} does not "
                         "fit the walker's int32 keys")
    ekey = _ids(ekey, np.int32, "ekey", 0, n_ent * key_base)
    tail = _ids(tail, np.int32, "tail", 0, n_ent)
    if ekey.shape != tail.shape or np.any(np.diff(ekey) < 0):
        raise ValueError("ekey must be sorted and as long as tail")
    return ekey, tail


def build_csr(triples: np.ndarray, n_ent: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rowptr (n_ent+1,), rel (E,), tail (E,)) int32 of (E, 3) triples,
    rows = head, stable in the triples' order."""
    triples = np.ascontiguousarray(triples, np.int64).reshape(-1, 3)
    n = len(triples)
    rowptr = np.zeros(n_ent + 1, np.int32)
    rel = np.zeros(n, np.int32)
    tail = np.zeros(n, np.int32)
    _call("build_csr", triples, n, n_ent, rowptr, rel, tail)
    return rowptr, rel, tail


def build_csr_temporal(quads: np.ndarray, n_ent: int):
    """(rowptr, rel, tail, time, perm) int32 of (E, 4) quadruples sorted
    by (head, time), stable; ``perm[i]`` is the CSR slot of row ``i``."""
    quads = np.ascontiguousarray(quads, np.int64).reshape(-1, 4)
    n = len(quads)
    rowptr = np.zeros(n_ent + 1, np.int32)
    out = [np.zeros(n, np.int32) for _ in range(4)]
    _call("build_csr_temporal", quads, n, n_ent, rowptr, *out)
    return (rowptr, *out)


def simulate_hops(rowptr: np.ndarray, tail: np.ndarray, n_ent: int,
                  heads: np.ndarray, n_layer: int
                  ) -> Tuple[List[int], List[int]]:
    """Exact node (n_layer+1) and edge (n_layer) counts per hop of one
    batch of query ``heads``."""
    rowptr, tail = _csr(rowptr, tail, n_ent)
    heads = _ids(heads, np.int64, "head", 0, n_ent)
    nc = np.zeros(n_layer + 1, np.int64)
    ec = np.zeros(n_layer, np.int64)
    _call("simulate_hops", rowptr, tail, n_ent, heads, len(heads), n_layer,
          nc, ec)
    return nc.tolist(), ec.tolist()


def per_query_hop_counts(rowptr: np.ndarray, tail: np.ndarray, n_ent: int,
                         heads: np.ndarray, n_layer: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(n, n_layer+1) node counts and (n, n_layer) edge counts per query
    (int64)."""
    rowptr, tail = _csr(rowptr, tail, n_ent)
    heads = np.ascontiguousarray(heads, np.int64)
    n = len(heads)
    nc = np.zeros((n, n_layer + 1), np.int64)
    ec = np.zeros((n, n_layer), np.int64)
    _call("per_query_hop_counts", rowptr, tail, n_ent, heads, n, n_layer,
          nc, ec)
    return nc, ec


def per_query_hop_counts_windowed(
        ekey: np.ndarray, tail: np.ndarray, n_ent: int, key_base: int,
        heads: np.ndarray, times: np.ndarray, window: int, n_layer: int
        ) -> Tuple[np.ndarray, np.ndarray]:
    """`per_query_hop_counts` of the time-windowed expansion: a node of a
    query at time t expands its edges with time in [t - window, t) plus
    its self-loop. ``ekey`` holds head * key_base + time per CSR slot,
    sorted."""
    ekey, tail = _window_keys(ekey, tail, n_ent, key_base, window)
    heads = np.ascontiguousarray(heads, np.int64)
    times = _ids(times, np.int64, "time", 0, key_base)
    n = len(heads)
    if len(times) != n:
        raise ValueError(f"{n} heads, {len(times)} times")
    nc = np.zeros((n, n_layer + 1), np.int64)
    ec = np.zeros((n, n_layer), np.int64)
    _call("per_query_hop_counts_windowed", ekey, tail, len(ekey), n_ent,
          key_base, heads, times, n, window, n_layer, nc, ec)
    return nc, ec


def simulate_hops_windowed(ekey: np.ndarray, tail: np.ndarray, n_ent: int,
                           key_base: int, heads: np.ndarray,
                           times: np.ndarray, window: int, n_layer: int
                           ) -> Tuple[List[int], List[int]]:
    """`simulate_hops` of the time-windowed expansion (one batch)."""
    ekey, tail = _window_keys(ekey, tail, n_ent, key_base, window)
    heads = _ids(heads, np.int64, "head", 0, n_ent)
    times = _ids(times, np.int64, "time", 0, key_base)
    if len(times) != len(heads):
        raise ValueError(f"{len(heads)} heads, {len(times)} times")
    nc = np.zeros(n_layer + 1, np.int64)
    ec = np.zeros(n_layer, np.int64)
    _call("simulate_hops_windowed", ekey, tail, len(ekey), n_ent, key_base,
          heads, times, len(heads), window, n_layer, nc, ec)
    return nc.tolist(), ec.tolist()
