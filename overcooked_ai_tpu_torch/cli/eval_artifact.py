"""The evaluation artifact's pairwise matrix on the torch port (counterpart
of the JAX package's `scripts/make_eval_artifact.py` loop; reference
human_aware_rl/ppo/evaluate.py:100-189).

On each layout, every ordered pair of {PPO_SP, PPO_BC, BC, greedy} (both
seat orders) plays `--games` games of `--horizon` steps from seed 0, and
the mean and std of the per-game sparse return go into a JSON file in the
schema of the JAX package's `eval_matrix_results.json`, each cell with its
wall and B1 launches beside them. The PPO agents are the JAX package's runs
converted by `convert_jax_checkpoints.py` (`artifacts_torch/eval_artifact`,
or `_old` with `--old-dynamics`); the BC proxies are read where the JAX
package wrote them (`runs/eval_artifact`, or `_old`). `--compare` holds each
cell against a JAX table: its mean must lie within three combined standard
errors, sqrt(s_J^2 / n_J + s_P^2 / n_P), of the table's; a cell where both
stds are 0 is reported and not gated.

    python -m overcooked_ai_tpu_torch.cli.eval_artifact --games 10 \\
        --compare eval_matrix_results.json
    python -m overcooked_ai_tpu_torch.cli.eval_artifact --games 10 --old-dynamics \\
        --compare eval_matrix_results_old_dynamics.json

The games run on the card (`--device cuda`, the default); `--device cpu`
runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
LAYOUTS = ["cramped_room", "asymmetric_advantages", "coordination_ring",
           "forced_coordination", "counter_circuit_o_1order"]
KINDS = ["PPO_SP", "PPO_BC", "BC", "greedy"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--games", type=int, default=10)
    ap.add_argument("--horizon", type=int, default=400)
    ap.add_argument("--layouts", nargs="+", default=LAYOUTS)
    ap.add_argument("--cells", nargs="+", default=None,
                    help="pairs to play, as A+B (default: all 16 of each layout)")
    ap.add_argument("--old-dynamics", action="store_true")
    ap.add_argument("--art-dir", default=None,
                    help="converted PPO runs (default artifacts_torch/eval_artifact[_old])")
    ap.add_argument("--out", default=None,
                    help="default runs_torch/eval_matrix_results[_old_dynamics].json")
    ap.add_argument("--compare", default=None, help="a JAX results JSON to hold the cells against")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    return ap.parse_args(argv)


def agent_kinds(layout_name, art_dir, bc_dir) -> dict:
    return {"PPO_SP": f"ppo:{art_dir}/ppo_sp_{layout_name}",
            "PPO_BC": f"ppo:{art_dir}/ppo_bc_{layout_name}",
            "BC": f"bc:{bc_dir}/bc_proxy_{layout_name}",
            "greedy": "greedy"}


def compare(results: dict, reference: dict) -> list:
    """Each cell of `results` against the same cell of a JAX results JSON:
    [(layout, cell, port mean, JAX mean, combined standard error, within 3
    of it, or None when both stds are 0)]."""
    ref, n_ref = reference["results"], reference["games_per_pair"]
    rows = []
    for layout, cells in results.items():
        for cell, mine in cells.items():
            want = ref[layout][cell]
            se = math.sqrt(want["std"] ** 2 / n_ref + mine["std"] ** 2 / mine["games"])
            within = None if se == 0 else abs(mine["mean"] - want["mean"]) <= 3 * se
            rows.append((layout, cell, mine["mean"], want["mean"], se, within))
    return rows


def main(argv=None):
    args = parse_args(argv)
    from overcooked_ai_tpu_torch.agents.evaluation import run_agent_pair
    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.cli.train_ppo import check_device
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.ops import fused_train
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

    device = check_device(args.device)
    suffix = "_old" if args.old_dynamics else ""
    art_dir = args.art_dir or os.path.join(ROOT, "artifacts_torch", f"eval_artifact{suffix}")
    bc_dir = os.path.join(ROOT, "runs", f"eval_artifact{suffix}")
    out = args.out or os.path.join(
        "runs_torch", f"eval_matrix_results{'_old_dynamics' if args.old_dynamics else ''}.json")
    overrides = {"old_dynamics": True} if args.old_dynamics else {}
    cells = args.cells or [f"{a}+{b}" for a in KINDS for b in KINDS]
    results = {}
    for layout_name in args.layouts:
        spec = from_layout_name(layout_name, **overrides)
        tables = build_motion_tables(spec.layout.terrain)
        kinds = agent_kinds(layout_name, art_dir, bc_dir)
        needed = {k for cell in cells for k in cell.split("+")}
        agents = {k: build_agent(v, spec, tables, device) for k, v in kinds.items()
                  if k in needed}
        lay_res = {}
        for cell in cells:
            a, b = cell.split("+")
            fused_train.launches = 0
            t0 = time.perf_counter()
            traj = run_agent_pair(spec, [agents[a], agents[b]], num_games=args.games,
                                  horizon=args.horizon, seed=0, greedy_carry=True,
                                  device=device)
            per_game = traj["sparse"].sum(axis=(0, 1))
            lay_res[cell] = {"mean": float(per_game.mean()), "std": float(per_game.std()),
                             "games": int(per_game.shape[0]),
                             "wall_s": time.perf_counter() - t0,
                             "b1_launches": fused_train.launches}
            print(f"{layout_name} {cell}: {lay_res[cell]['mean']:.1f} +- "
                  f"{lay_res[cell]['std']:.1f} ({lay_res[cell]['wall_s']:.3f}s, B1 launches "
                  f"{lay_res[cell]['b1_launches']})", flush=True)
        results[layout_name] = lay_res
    summary = {
        "protocol": "reference evaluate.py:100-189 analogue: mean per-game sparse reward, "
                    "horizon 400, both seat orders (A+B and B+A rows)",
        "dynamics": "old" if args.old_dynamics else "new",
        "games_per_pair": args.games,
        "device": str(device),
        "results": results,
    }
    if args.compare:
        with open(args.compare) as f:
            rows = compare(results, json.load(f))
        outside = [r for r in rows if r[5] is False]
        for layout, cell, mine, want, se, within in rows:
            if within is not True:
                print(f"{'not gated' if within is None else 'OUTSIDE'}: {layout} {cell} port "
                      f"{mine:.2f} JAX {want:.2f} combined se {se:.3f}")
        summary["comparison"] = {"reference": os.path.basename(args.compare),
                                 "cells": len(rows),
                                 "within_3se": sum(r[5] is True for r in rows),
                                 "outside_3se": [f"{r[0]}:{r[1]}" for r in outside],
                                 "not_gated": [f"{r[0]}:{r[1]}" for r in rows if r[5] is None]}
        print("comparison " + json.dumps(summary["comparison"]))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {out}")
    return summary


if __name__ == "__main__":
    main()
