"""The harness's data: what `BENCHMARK.json` names, found by name.

A cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`) and its traffic mix (`traffic/<traffic>.json`, a
data file of parameters that names the driver which generates it,
`drivers/<driver>.py`), and gives the limits of the numbers its check
compares. A per-layer metric
`<name>` is read by `metrics/<name>.py`, or, for a name with a dot, by the
family reader `metrics/<name before the dot>.py`, which takes the part
after the dot. Adding a cell, a configuration or a metric therefore adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may hold: JAX, its libraries and the
# JAX package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "overcooked_ai_tpu")


class BenchmarkError(Exception):
    """A cell, configuration, driver or metric that the files do not give."""


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BenchmarkError(f"no file {os.path.relpath(path, ROOT)}") from None


def benchmark_spec(root=ROOT) -> dict:
    """`BENCHMARK.json` at the root of the checkout."""
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def find_workload(name: str, bench_dir=BENCH_DIR) -> dict:
    """`workloads/<name>.json`, with its name."""
    cell = _read_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    if cell.get("name", name) != name:
        raise BenchmarkError(f"workloads/{name}.json names itself {cell['name']!r}")
    return dict(cell, name=name)


def find_config(name: str, bench_dir=BENCH_DIR) -> dict:
    """`configs/<name>.json`, with its name."""
    return dict(_read_json(os.path.join(bench_dir, "configs", f"{name}.json")), name=name)


def find_traffic(name: str, bench_dir=BENCH_DIR) -> dict:
    """`traffic/<name>.json`: the parameters its `driver` reads."""
    return dict(_read_json(os.path.join(bench_dir, "traffic", f"{name}.json")), name=name)


def list_workloads(bench_dir=BENCH_DIR) -> list:
    """The names of the cells that have a workload file."""
    folder = os.path.join(bench_dir, "workloads")
    return sorted(f[:-5] for f in os.listdir(folder) if f.endswith(".json"))


def load_module(kind: str, name: str, bench_dir=BENCH_DIR):
    """`<kind>/<name>.py` under the benchmark's folder, imported by path."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise BenchmarkError(f"no {kind[:-1]} {name!r} ({os.path.relpath(path, ROOT)})")
    key = f"_bench_{kind}_{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir=BENCH_DIR):
    """(read function, the part of the name after the family's) of a
    per-layer metric: `metrics/<name>.py`, else the family reader."""
    if os.path.isfile(os.path.join(bench_dir, "metrics", f"{name}.py")):
        return load_module("metrics", name, bench_dir).read, ""
    family, _, rest = name.partition(".")
    return load_module("metrics", family, bench_dir).read, rest


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that cell `cell` reports:
    those whose `workloads` list it, and those with no such list."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN_MODULES))


class Check:
    """The numbers a run's output check compares, each with its limit. A
    cell that names a number with the limit null does not compare it (its
    readings could only fail sound runs); a number with no entry fails."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values = {}

    def add(self, name: str, value: float):
        """Record a number (the worst of the values given under one name)."""
        if name in self.limits and self.limits[name] is None:
            return
        value = float(value)
        if value != value:  # NaN: the comparison failed outright
            value = float("inf")
        self.values[name] = max(value, self.values.get(name, float("-inf")))

    def correct(self) -> bool:
        return bool(self.values) and all(
            name in self.limits and v <= self.limits[name] for name, v in self.values.items())

    def table(self) -> dict:
        return {name: {"value": v, "limit": self.limits.get(name)}
                for name, v in self.values.items()}
