"""Pairwise agent evaluation matrix of the torch port (port of
`overcooked_ai_tpu.cli.eval_matrix`; reference ppo/evaluate.py).

Evaluates every ordered pair of agent kinds {greedy, boltzmann, random,
stay, ppo:<ckpt_dir>} on each layout for N games and writes a JSON table of
mean and std sparse returns to --out.

    python -m overcooked_ai_tpu_torch.cli.eval_matrix --layouts cramped_room \\
        --agents greedy random --games 8

The games run on the card (`--device cuda`, the default): the agents as
PyTorch ops, each env step one launch of the B1 kernel. `--device cpu` runs
the plain versions; a run on `cuda` without a card stops.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layouts", nargs="+", default=["cramped_room"])
    ap.add_argument("--agents", nargs="+", default=["greedy", "random"],
                    help="agent kinds: greedy | boltzmann | random | stay | ppo:<dir>")
    ap.add_argument("--games", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=400)
    ap.add_argument("--out", default="runs_torch/eval_matrix.json")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from overcooked_ai_tpu_torch.agents.evaluation import run_agent_pair
    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.cli.train_ppo import check_device
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

    device = check_device(args.device)
    results = {}
    for layout_name in args.layouts:
        spec = from_layout_name(layout_name)
        tables = build_motion_tables(spec.layout.terrain)
        agents = {}
        for kind in args.agents:
            try:
                agents[kind] = build_agent(kind, spec, tables, device)
            except (ValueError, OSError) as e:  # an unsupported kind, a missing directory
                print(f"skip {kind} on {layout_name}: {e}")
        for a, b in itertools.product(agents, repeat=2):
            traj = run_agent_pair(spec, [agents[a], agents[b]], num_games=args.games,
                                  horizon=args.horizon, device=device)
            returns = traj["sparse"].sum(axis=(0, 1))
            key = f"{layout_name}:{a}+{b}"
            results[key] = {"mean": float(returns.mean()), "std": float(returns.std()),
                            "games": args.games}
            print(f"{key}: {returns.mean():.1f} +- {returns.std():.1f}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
