"""The readings that the limits of a cell's check are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --variant <v>[,<v>...]
        [--seconds S] [--override key=value ...]

Runs the cell once per variant and seed in one process (the kernels built
once) and prints, per run, one JSON line with the numbers the check
compared. The variant `sound` runs the program as it is; `tf32` is the control of a
float32 cell (the program with TF32 on); `no_reset` the control of random
play (the reference without its auto-reset in the program's place); the
others plant a fault of `tests/faults.py` underneath the timed path. The
benchmark's own runs never run these.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(BENCH_DIR, "tests"))
import run  # noqa: E402

CONTROLS = ("tf32", "no_reset")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="sound")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--override", action="append", default=[],
                   help="key=JSON value of the traffic, for a sweep (not a cell's run)")
    a = p.parse_args(argv)
    import faults
    from harness.device import require_cards

    for variant, seed in ((v, s) for v in a.variant.split(",") for s in a.seeds.split(",")):
        undo = None  # planted anew for each seed: a fault may count its calls
        if variant not in ("sound",) + CONTROLS:
            undo = faults.PLANT[variant]()
        args = run.parse(["--workload", a.workload, "--seed", seed, "--seconds",
                          str(a.seconds), "--trace", "0"])
        overrides = {k: json.loads(v) for k, v in (o.split("=", 1) for o in a.override)}
        ctx = run.make_context(args, control=variant if variant in CONTROLS else None,
                               traffic_overrides=overrides)
        require_cards(ctx.cell["chips"])
        out = run.execute(ctx)
        print(json.dumps({"workload": a.workload, "variant": variant, "seed": int(seed),
                          "overrides": overrides,
                          "correct": out["correct"], "metrics": out["metrics"],
                          "checks": {k: v["value"] for k, v in out["checks"].items()}}),
              flush=True)
        if undo:
            undo()


if __name__ == "__main__":
    main()
