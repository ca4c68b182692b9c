"""ctypes loader of the native planner-table kernels (port of
`overcooked_ai_tpu.planning._native`).

The library is `native/libplanner_tables.so` at the root of the repo,
outside the package, built from `native/planner_tables.cpp` by
`native/Makefile` with the host C++ compiler on first use. Its functions
compute all-pairs shortest paths for the host planners (`planning/joint.py`).

Where the library cannot be built or loaded, `available()` is false and the
callers compute the same tables in pure Python. That is a choice between two
host implementations of a planner table, made before anything reaches the
card; it is not a device fallback, and no kernel of the port is replaced by
it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libplanner_tables.so")
_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                           timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.all_pairs_shortest.argtypes = [
            i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p,
        ]
        lib.all_pairs_shortest.restype = None
        lib.all_pairs_bfs.argtypes = [i32p, i32p, ctypes.c_int32, ctypes.c_int32, i32p]
        lib.all_pairs_bfs.restype = None
        _lib = lib
    except Exception:  # noqa: BLE001 - no toolchain or a bad library: the Python tables
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def all_pairs_shortest(indptr, indices, costs, inf: int):
    """All-pairs shortest paths over a CSR graph with small integer edge
    costs: (n, n) int32, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    costs = np.ascontiguousarray(costs, np.int32)
    n = indptr.shape[0] - 1
    max_cost = int(costs.max()) if costs.size else 1
    if not 0 < max_cost <= 15:
        raise ValueError("the Dial buckets take integer edge costs of 1 to 15")
    out = np.empty((n, n), np.int32)
    lib.all_pairs_shortest(indptr, indices, costs, n, max_cost, int(inf), out)
    return out


def all_pairs_bfs(indptr, indices, inf: int):
    """Unit-cost all-pairs BFS over a CSR graph: (n, n) int32, or None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    n = indptr.shape[0] - 1
    out = np.empty((n, n), np.int32)
    lib.all_pairs_bfs(indptr, indices, n, int(inf), out)
    return out
