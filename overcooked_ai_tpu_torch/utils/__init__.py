"""Core utilities, paralleling the reference `overcooked_ai_py/utils.py`
(port of `overcooked_ai_tpu.utils`).

Covers the pieces of the reference utils that are part of the public
surface (reference utils.py:31-239): pickle/json IO, layout-dict reading
(without `eval` -- see core/layout.py), distance helpers, mean/stderr, dict
tools, a profiling decorator, and a device trace (`device_trace`, a
`torch.profiler` context). The JAX package's `utils/platform.py` has no
counterpart: the port's entry points take `--device` / `device=`.
"""

from __future__ import annotations

import cProfile
import functools
import io
import json
import pickle
import pstats
import time
from collections import defaultdict

import numpy as np


class OvercookedException(Exception):
    """Mirror of reference utils.py:14."""


# ---------------------------------------------------------------------------
# IO (reference utils.py:17-58)
# ---------------------------------------------------------------------------


def save_pickle(data, filename):
    path = str(filename)
    if not path.endswith(".pickle"):
        path += ".pickle"
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_pickle(filename):
    path = str(filename)
    if not path.endswith(".pickle"):
        path += ".pickle"
    with open(path, "rb") as f:
        return pickle.load(f)


def load_dict_from_file(filepath):
    """Read a `.layout`-style python-literal dict WITHOUT eval.

    The reference eval()s layout files (utils.py:31-33, 223-226); here they
    are parsed with ast.literal_eval (core/layout.py does the same).
    """
    import ast

    with open(filepath, "r") as f:
        return ast.literal_eval(f.read())


def save_as_json(data, filename):
    path = str(filename)
    if not path.endswith(".json"):
        path += ".json"
    with open(path, "w") as f:
        json.dump(data, f, default=_np_default)
    return path


def load_from_json(filename):
    path = str(filename)
    if not path.endswith(".json"):
        path += ".json"
    with open(path, "r") as f:
        return json.load(f)


def _np_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


# ---------------------------------------------------------------------------
# Stats / distances (reference utils.py:95-130, 160-204)
# ---------------------------------------------------------------------------


def mean_and_std_err(lst):
    """(mean, standard error) -- reference utils.py:95-100."""
    arr = np.asarray(lst, np.float64)
    mu = float(arr.mean())
    return mu, float(arr.std() / np.sqrt(arr.size))


def manhattan_distance(pos1, pos2) -> int:
    return int(abs(pos1[0] - pos2[0]) + abs(pos1[1] - pos2[1]))


def pos_distance(pos0, pos1):
    return tuple(np.array(pos0) - np.array(pos1))


# ---------------------------------------------------------------------------
# Dict tools (reference utils.py:132-158)
# ---------------------------------------------------------------------------


def append_dictionaries(dictionaries):
    """List of dicts (same keys) -> dict of lists."""
    keys = set(dictionaries[0].keys())
    assert all(
        set(d.keys()) == keys for d in dictionaries
    ), "All key sets must match"
    out = defaultdict(list)
    for d in dictionaries:
        for k, v in d.items():
            out[k].append(v)
    return dict(out)


def merge_dictionaries(dictionaries):
    """List of dicts of lists (same keys) -> dict of concatenated lists."""
    keys = set(dictionaries[0].keys())
    assert all(
        set(d.keys()) == keys for d in dictionaries
    ), "All key sets must match"
    out = defaultdict(list)
    for d in dictionaries:
        for k, v in d.items():
            out[k].extend(v)
    return dict(out)


def take_indexes_from_dict(d, indices, keys=None):
    keys = set(d.keys()) if keys is None else keys
    return {
        k: [v[i] for i in indices] if k in keys else v for k, v in d.items()
    }


# ---------------------------------------------------------------------------
# Profiling (reference utils.py:206-220)
# ---------------------------------------------------------------------------


def profile(fnc):
    """Decorator: cProfile the call and print cumulative-time stats."""

    @functools.wraps(fnc)
    def inner(*args, **kwargs):
        pr = cProfile.Profile()
        pr.enable()
        retval = fnc(*args, **kwargs)
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats()
        print(s.getvalue())
        return retval

    return inner


class timeit:
    """Lightweight wall-clock context manager: `with timeit("phase"):`."""

    def __init__(self, label=""):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.t0
        if self.label:
            print(f"{self.label}: {self.dt:.3f}s")
        return False


def classproperty(func):
    """Reference utils.py:229-238."""

    class _ClassPropertyDescriptor:
        def __init__(self, fget):
            self.fget = fget

        def __get__(self, obj, klass=None):
            return self.fget(klass if klass is not None else type(obj))

    return _ClassPropertyDescriptor(func)

def device_trace(log_dir):
    """Context manager: profile the host and the card (when there is one)
    and write a Chrome trace, `trace.json` in `log_dir`, viewable in
    Perfetto or chrome://tracing (the reference has only the cProfile
    decorator above, utils.py:206-220).

    Usage:
        with device_trace("/tmp/torch-trace"):
            train_iteration(ts)
    """
    import contextlib
    import os

    import torch

    @contextlib.contextmanager
    def _ctx():
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(str(log_dir), exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))

    return _ctx()


def remove_indices_and_renormalize(probs, indices, eps=0.0):
    """Zero (to eps) the given action indices and renormalize the
    distribution(s) -- reference Action.remove_indices_and_renormalize
    (actions.py:104-117). Accepts a 1-D distribution or a (B, A) batch;
    always returns a numpy array.
    """
    probs = np.array(probs, dtype=float, copy=True)
    if probs.ndim > 1:
        probs[:, list(indices)] = eps
        return probs / probs.sum(axis=1, keepdims=True)
    probs[list(indices)] = eps
    return probs / probs.sum()
