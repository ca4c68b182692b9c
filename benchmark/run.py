"""The benchmark of `overcooked_ai_tpu_torch` on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in `benchmark/workloads/`, its configuration in
`benchmark/configs/` and its traffic in `benchmark/traffic/`, whose
`driver` names the module under `benchmark/drivers/` that sets up, warms
up, measures for `--seconds` and checks the output against the plain
reference under `benchmark/reference/`. It prints, as the last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics, each read by `benchmark/metrics/`), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number beside its limit,
which also end standard error.

Without the CUDA cards the cell asks for it exits 1 and prints no result;
nothing falls back to the CPU. It exits 1, with no result, if JAX, one of
its libraries or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for path in (BENCH_DIR, ROOT):  # the harness, the reference and the port
    if path not in sys.path:
        sys.path.insert(0, path)

from harness import core  # noqa: E402

CHECK_ITERATIONS = 3  # training iterations the reference follows, unless the traffic says


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_context(args, device="cuda", control=None, traffic_overrides=None,
                 check_iterations=None):
    """Everything a driver reads: the cell, its configuration and traffic
    (`traffic_overrides` shrinks them for the CPU tests), the run's
    arguments, and the process's start."""
    bench = core.benchmark_spec()
    cell = core.find_workload(args.workload)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        raise core.BenchmarkError(f"BENCHMARK.json names no cell {args.workload!r}")
    if any(entry[k] != cell[k] for k in ("config", "traffic", "chips")):
        raise core.BenchmarkError(f"BENCHMARK.json and workloads/{args.workload}.json differ")
    traffic = dict(core.find_traffic(cell["traffic"]), **(traffic_overrides or {}))
    return types.SimpleNamespace(
        bench=bench, cell=cell, config=core.find_config(cell["config"]), traffic=traffic,
        limits=cell["limits"], seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, control=control,
        check_iterations=check_iterations or traffic.get("check_iterations", CHECK_ITERATIONS),
        t0=T0)


def execute(ctx):
    """Run the cell's driver and assemble the result line."""
    driver = core.load_module("drivers", ctx.traffic["driver"])
    out = driver.run(ctx)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        sys.exit(1)
    check = out["check"]
    if ctx.trace:
        metrics = {}
        for m in core.cell_metrics(ctx.bench, ctx.cell["name"], "per_layer"):
            read, rest = core.metric_reader(m["name"])
            value = read(out["layer"], rest)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in core.cell_metrics(ctx.bench, ctx.cell["name"], "end_to_end")}
    device = out["device"]
    result = {"correct": check.correct(), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace and out.get("trace") is not None:
        trace = out["trace"]
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["checks"] = check.table()
    return result


def main(argv=None):
    args = parse(argv)
    ctx = make_context(args)
    from harness.device import card_label, require_cards

    require_cards(ctx.cell["chips"])
    result = execute(ctx)
    print(f"card: {card_label()}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
