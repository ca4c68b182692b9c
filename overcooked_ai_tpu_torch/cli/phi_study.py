"""Seed-variance study of phi-shaped PPO at the reference's own CI scale, on
the torch port (counterpart of the JAX package's `scripts/phi_study.py`).

The same three configs as the JAX study, on `cramped_room`: train batch
num_envs x 400, minibatch 800 env steps, 8 SGD epochs, entropy 0, 30
iterations (reference ppo_rllib_test.py:172-225):

  * `phi_ci_lr5e-3`: phi, 4 envs, lr 5e-3, the reference's phi CI config
    (its floor: average total reward >= 13);
  * `phi_prod_lr5e-5`: phi, 4 envs, the production lr 5e-5 (no floor);
  * `nophi_ci`: event shaping, 2 envs, lr 5e-3 (floor >= 5).

Each seed trains with `training.ppo.train` (phi from
`core/potential.make_potential_fn`) and reports the mean of its last 5
iterations' `episode_total_reward` and sparse reward; each config its mean,
std, min and max, in `<out>/results.json` (the JAX study's schema,
merged across runs so that an interrupted study resumes per config).
`<out>/comparison.json` holds, per config, whether every seed clears its
floor and where its mean lies against the JAX study's
(`runs/phi_study/results.json`, read as data) in units of the two tables'
combined standard error, sqrt(s_J^2 / n_J + s_P^2 / n_P). The RNG streams
differ from JAX's, so the comparison is statistical.

    python -m overcooked_ai_tpu_torch.cli.phi_study [--seeds 5] [--out runs_torch/phi_study]

Runs on the card by default (`--device cpu` runs the plain versions). It
never writes the JAX study's `runs/phi_study/` or `PHI_STUDY.md`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
JAX_RESULTS = os.path.join(ROOT, "runs", "phi_study", "results.json")
ITERATIONS = 30  # a seed's training iterations, as in the JAX study


def configs():
    """(name, PPOConfig, reference floor on the average total reward, source)."""
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig

    def ci_cfg(use_phi, lr, num_envs):
        return PPOConfig(num_envs=num_envs, horizon=400, sgd_minibatch_size=800, num_sgd_iter=8,
                         entropy_coeff_start=0.0, entropy_coeff_end=0.0, lr=lr, use_phi=use_phi)

    return [
        ("phi_ci_lr5e-3", ci_cfg(True, 5e-3, 4), 13.0,
         "ppo_rllib_test.py:203-225 (the reference's own phi CI config)"),
        ("phi_prod_lr5e-5", ci_cfg(True, 5e-5, 4), None,
         "phi + the production default lr (ppo_rllib_client.py:126) at CI scale -- the "
         "dead-config check"),
        ("nophi_ci", ci_cfg(False, 5e-3, 2), 5.0,
         "ppo_rllib_test.py:172-194 shape (batch 800); lr 5e-3 as in tests/test_ppo.py (see "
         "PHI_STUDY.md note on worker semantics)"),
    ]


def compare(results: dict, reference: dict) -> dict:
    """Per config of `results` also in `reference`: each seed against the
    floor, and the mean's distance from the reference's in combined
    standard errors (None where both stds are 0)."""
    out = {}
    for name, mine in results.items():
        floor = mine["reference_threshold"]
        row = {"mean": mine["mean"], "std": mine["std"],
               "seeds_below_floor": [] if floor is None else [
                   s["seed"] for s in mine["seeds"] if s["avg_total_reward_last5"] < floor]}
        if name in reference:
            ref = reference[name]
            se = math.sqrt(ref["std"] ** 2 / len(ref["seeds"])
                           + mine["std"] ** 2 / len(mine["seeds"]))
            row.update(jax_mean=ref["mean"], jax_std=ref["std"], combined_se=se,
                       distance_in_se=None if se == 0 else (mine["mean"] - ref["mean"]) / se)
        out[name] = row
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("runs_torch", "phi_study"))
    ap.add_argument("--only", nargs="*", default=None, help="run only these config names")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)
    from overcooked_ai_tpu_torch.cli.train_ppo import check_device

    device = check_device(args.device)
    if os.path.abspath(args.out) == os.path.dirname(JAX_RESULTS):
        raise SystemExit(f"--out {args.out} is the JAX study's directory")

    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.core.potential import make_potential_fn
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
    from overcooked_ai_tpu_torch.training.ppo import train

    spec = from_layout_name("cramped_room")
    phi = make_potential_fn(spec, build_motion_tables(spec.layout.terrain).feature_cost)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "results.json")
    results = {}
    if os.path.exists(path):  # merge across interrupted runs
        with open(path) as f:
            results = json.load(f)
    for name, cfg, threshold, source in configs():
        if args.only is not None and name not in args.only:
            continue
        rows = []
        for seed in range(args.seeds):
            t0 = time.time()
            _, hist = train(spec, cfg, num_iterations=ITERATIONS, seed=seed,
                            potential_fn=phi if cfg.use_phi else None, device=device)
            total = float(np.mean([float(m.episode_total_reward) for m in hist[-5:]]))
            sparse = float(np.mean([float(m.episode_sparse_reward) for m in hist[-5:]]))
            rows.append({
                "seed": seed,
                "avg_total_reward_last5": round(total, 2),
                "avg_sparse_last5": round(sparse, 2),
                "curve_total_reward": [round(float(m.episode_total_reward), 2) for m in hist],
                "wall_s": round(time.time() - t0, 1),
            })
            print(f"{name} seed={seed}: total={total:.1f} sparse={sparse:.1f} "
                  f"({rows[-1]['wall_s']}s on {device})", flush=True)
        vals = [r["avg_total_reward_last5"] for r in rows]
        results[name] = {
            "source": source,
            "reference_threshold": threshold,
            "config": {"num_envs": cfg.num_envs, "horizon": cfg.horizon, "lr": cfg.lr,
                       "use_phi": cfg.use_phi, "sgd_minibatch_size": cfg.sgd_minibatch_size,
                       "num_sgd_iter": cfg.num_sgd_iter},
            "seeds": rows,
            "mean": round(float(np.mean(vals)), 2),
            "std": round(float(np.std(vals)), 2),
            "min": round(float(np.min(vals)), 2),
            "max": round(float(np.max(vals)), 2),
        }
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
    with open(JAX_RESULTS) as f:
        comparison = compare(results, json.load(f))
    with open(os.path.join(args.out, "comparison.json"), "w") as f:
        json.dump({"device": str(device), "reference": os.path.relpath(JAX_RESULTS, ROOT),
                   "configs": comparison}, f, indent=1)
    print(json.dumps(comparison, indent=1))
    return results


if __name__ == "__main__":
    main()
