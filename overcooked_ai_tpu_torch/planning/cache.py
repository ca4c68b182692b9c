"""Disk cache of the planner tables (port of `overcooked_ai_tpu.planning.cache`).

An `.npz` per table set, keyed by a hash of everything the build reads (the
terrain's bytes and the counter goals), so a changed layout never loads a
stale file.

The port's cache directory is its own: by default
`overcooked_ai_tpu_torch/data/planners` (listed in `.gitignore`), or the
directory that `OVERCOOKED_TORCH_PLANNER_CACHE` or `cache_dir` names. It
never reads or writes the JAX package's directory (`OVERCOOKED_PLANNER_CACHE`,
`overcooked_ai_tpu/data/planners`), so the two packages' caches cannot
collide. `force_compute=True` rebuilds and rewrites the file.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from overcooked_ai_tpu_torch.planning.tables import MotionTables, build_motion_tables

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "planners")


def _cache_dir(cache_dir=None):
    return cache_dir or os.environ.get("OVERCOOKED_TORCH_PLANNER_CACHE") or _DEFAULT_DIR


def _key(terrain: np.ndarray, counter_goals) -> str:
    h = hashlib.sha1()
    t = np.ascontiguousarray(np.asarray(terrain, np.int32))
    h.update(t.shape[0].to_bytes(4, "little"))
    h.update(t.shape[1].to_bytes(4, "little"))
    h.update(t.tobytes())
    for x, y in sorted(tuple(p) for p in counter_goals):
        h.update(int(x).to_bytes(2, "little"))
        h.update(int(y).to_bytes(2, "little"))
    return h.hexdigest()[:16]


def cached_motion_tables(terrain, counter_goals=(), cache_dir=None,
                         force_compute: bool = False) -> MotionTables:
    """`build_motion_tables` behind the .npz cache. A file that cannot be
    read is rebuilt and rewritten."""
    d = _cache_dir(cache_dir)
    path = os.path.join(d, f"mt_{_key(terrain, counter_goals)}.npz")
    if not force_compute and os.path.exists(path):
        try:
            with np.load(path) as z:
                return MotionTables(feature_cost=z["feature_cost"], point_dist=z["point_dist"])
        except Exception:  # noqa: BLE001 - corrupt or partial: rebuild
            pass
    tables = build_motion_tables(np.asarray(terrain), counter_goals)
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:  # a file handle: savez appends no .npz
        np.savez_compressed(f, feature_cost=tables.feature_cost, point_dist=tables.point_dist)
    os.replace(tmp, path)
    return tables
