"""Held-out pool evaluation of a variable-MDP checkpoint (port of
`overcooked_ai_tpu.cli.eval_pool`).

Evaluates a torch checkpoint from `cli.train_ppo_from_params` against
yardstick partners on a held-out generated pool (a fresh generator seed, the
training generation parameters):

    ppo+ppo                   self-play on unseen layouts (the headline)
    ppo+greedy / greedy+ppo   cross-play with the scripted model
    greedy+greedy             the scripted pair's yardstick

    python -m overcooked_ai_tpu_torch.cli.eval_pool --ckpt runs_torch/from_params \\
        --pool-size 32 --games 4

The games run on the card (`--device cuda`, the default), each env step one
launch of the B1 kernel; `--device cpu` runs the plain versions. The summary
goes to stdout and, with the per-layout returns, to --out.
"""

from __future__ import annotations

import argparse
import json
import os

PAIRS = ("ppo+ppo", "ppo+greedy", "greedy+ppo", "greedy+greedy")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a torch checkpoint directory")
    ap.add_argument("--outer-shape", default="5,4", help="width,height")
    ap.add_argument("--pool-size", type=int, default=32)
    ap.add_argument("--prop-empty", type=float, default=0.95)
    ap.add_argument("--prop-feats", type=float, default=0.1)
    ap.add_argument("--games", type=int, default=4, help="per pair per layout")
    ap.add_argument("--horizon", type=int, default=400)
    ap.add_argument("--seed", type=int, default=1000,
                    help="generator seed; keep it != the training seed (0) so the pool "
                    "is held out")
    ap.add_argument("--out", default="runs_torch/eval_pool.json")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from overcooked_ai_tpu_torch.agents.evaluation import run_agent_pair
    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.cli.train_ppo import check_device
    from overcooked_ai_tpu_torch.core.layout_generator import LayoutGenerator
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

    device = check_device(args.device)
    w, h = (int(x) for x in args.outer_shape.split(","))
    gen = LayoutGenerator(outer_shape=(w, h), prop_empty=args.prop_empty,
                          prop_feats=args.prop_feats, rng=np.random.RandomState(args.seed))
    specs = [gen.generate_spec(name=f"heldout_{i}") for i in range(args.pool_size)]
    per_layout = {p: [] for p in PAIRS}
    for i, spec in enumerate(specs):
        tables = build_motion_tables(spec.layout.terrain)
        agents = {"ppo": build_agent(f"ppo:{args.ckpt}", spec, tables, device),
                  "greedy": build_agent("greedy", spec, tables, device)}
        for p in PAIRS:
            n0, n1 = p.split("+")
            traj = run_agent_pair(spec, [agents[n0], agents[n1]], num_games=args.games,
                                  horizon=args.horizon, seed=args.seed + i, device=device)
            per_layout[p].append(float(traj["sparse"].sum(axis=(0, 1)).mean()))
        print(f"[{i + 1}/{len(specs)}] "
              + " ".join(f"{p}={per_layout[p][-1]:.0f}" for p in PAIRS), flush=True)
    summary = {
        "ckpt": args.ckpt,
        "pool": f"{args.pool_size} held-out layouts, seed {args.seed}, outer {w}x{h}, "
                f"prop_empty {args.prop_empty}, prop_feats {args.prop_feats}",
        "games_per_pair_per_layout": args.games,
        "horizon": args.horizon,
        "results": {p: {"mean": float(np.mean(per_layout[p])),
                        "std": float(np.std(per_layout[p]))} for p in PAIRS},
    }
    print(json.dumps(summary, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({**summary, "per_layout": per_layout}, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
