"""Variable-MDP PPO training CLI of the torch port (port of
`overcooked_ai_tpu.cli.train_ppo_from_params`).

Generates a pool of procedural layouts (LayoutGenerator) and trains PPO
self-play over them: every iteration each env lane draws a layout of the
pool, the vectorized equivalent of the reference's per-reset MDP
regeneration (num_mdp=inf). With `--regen-every N` the host regenerates the
whole pool every N iterations, so no layout repeats across the run.
`--use-phi` shapes with each lane's potential phi
(`core/potential.make_potential_fn_pool`), whose tables belong to the
fixed pool: it refuses `--regen-every`. `--use-lstm` trains the recurrent
learner (`training/ppo_lstm.py`) on a fixed pool, without phi, as the JAX
CLI does.

Examples:
    python -m overcooked_ai_tpu_torch.cli.train_ppo_from_params --iters 400 --pool-size 64
    python -m overcooked_ai_tpu_torch.cli.train_ppo_from_params --local-testing --device cpu
    python -m overcooked_ai_tpu_torch.cli.train_ppo_from_params --use-lstm --local-testing
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from overcooked_ai_tpu_torch.cli.train_ppo import check_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outer-shape", default="5,4", help="width,height")
    ap.add_argument("--pool-size", type=int, default=64)
    ap.add_argument("--prop-empty", type=float, default=0.95)
    ap.add_argument("--prop-feats", type=float, default=0.1)
    ap.add_argument("--iters", type=int, default=400)
    # reference from-params config: train batch 100000, minibatch 25000,
    # lr 5e-3, entropy 0.02 -> 5e-5, shaping horizon 1e6
    ap.add_argument("--num-envs", type=int, default=250)  # x400 = 100k batch
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--shaping-horizon", type=float, default=1e6,
                    help="reward-shaping anneal horizon in env steps. The reference's 1e6 "
                    "anneals to zero within 10 iterations at the production batch; "
                    "~2e7 (half a 400-iter run) gives a from-params run that learns")
    ap.add_argument("--entropy-horizon", type=float, default=3e5)
    ap.add_argument("--entropy-start", type=float, default=0.02,
                    help="entropy coefficient start (reference from-params 0.02)")
    ap.add_argument("--entropy-end", type=float, default=5e-5,
                    help="entropy coefficient floor (reference from-params 5e-5)")
    ap.add_argument("--regen-every", type=int, default=0,
                    help="regenerate the whole layout pool on the host every N iterations "
                    "(0 = a fixed pool)")
    ap.add_argument("--use-phi", action="store_true",
                    help="dense reward = phi(s') - phi(s) per lane (a fixed pool only)")
    ap.add_argument("--use-lstm", action="store_true",
                    help="the recurrent learner (a fixed pool, no phi)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="run directory (default runs_torch/ppo_from_params)")
    ap.add_argument("--save-freq", type=int, default=100)
    ap.add_argument("--local-testing", action="store_true",
                    help="CI scale: 6 envs, minibatch 800")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)
    if args.regen_every and (args.use_phi or args.use_lstm):
        ap.error("--regen-every requires plain PPO (phi/lstm pool tables are precomputed for a "
                 "fixed pool)")
    if args.use_lstm and args.use_phi:
        ap.error("lstm+phi combination not wired yet")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = check_device(args.device)

    from overcooked_ai_tpu_torch.core.layout_generator import LayoutGenerator, stack_layouts
    from overcooked_ai_tpu_torch.training.checkpoint import (
        MetricsLogger,
        restore_checkpoint,
        save_checkpoint,
    )
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig, make_ppo

    w, h = (int(x) for x in args.outer_shape.split(","))
    gen = LayoutGenerator(outer_shape=(w, h), prop_empty=args.prop_empty,
                          prop_feats=args.prop_feats, rng=np.random.RandomState(args.seed))
    specs = [gen.generate_spec(name=f"gen_{i}") for i in range(args.pool_size)]
    print(f"generated pool of {len(specs)} {w}x{h} layouts", flush=True)

    common = dict(entropy_coeff_start=args.entropy_start, entropy_coeff_end=args.entropy_end,
                  entropy_coeff_horizon=args.entropy_horizon, lr=args.lr,
                  reward_shaping_horizon=args.shaping_horizon, use_phi=args.use_phi)
    if args.local_testing:  # x400 = 2400, the reference's CI from-params batch
        config = PPOConfig(num_envs=6, sgd_minibatch_size=800, num_sgd_iter=8, **common)
    else:  # x2 agents = 25000 samples a minibatch
        config = PPOConfig(num_envs=args.num_envs, sgd_minibatch_size=12500, **common)

    out_dir = args.out or "runs_torch/ppo_from_params"
    os.makedirs(out_dir, exist_ok=True)
    log = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    potential_fn = None
    if args.use_phi:
        from overcooked_ai_tpu_torch.core.potential import make_potential_fn_pool

        potential_fn = make_potential_fn_pool(specs)
    if args.use_lstm:
        from overcooked_ai_tpu_torch.training.ppo_lstm import make_ppo_lstm

        init_fn, train_it = make_ppo_lstm(specs, config, device=device)
    else:
        init_fn, train_it = make_ppo(specs, config, potential_fn, device=device)
    ts = init_fn(args.seed)
    start_iter = 0
    if args.resume:
        ts, start_iter = restore_checkpoint(out_dir, ts)
        print(f"resumed from step {start_iter}", flush=True)
    last_iter = start_iter + args.iters

    t_start = time.time()
    fresh_pool = None
    try:
        for it in range(start_iter + 1, last_iter + 1):
            t0 = time.time()
            if args.regen_every and (it - start_iter - 1) % args.regen_every == 0:
                fresh_pool = stack_layouts([gen.generate_spec(name=f"gen_{it}_{i}")
                                            for i in range(args.pool_size)])
            ts, m = train_it(ts) if fresh_pool is None else train_it(ts, pool=fresh_pool)
            log.log(it, m)
            if it % 10 == 0 or it == start_iter + 1:
                print(f"iter {it}: sparse={m.episode_sparse_reward.item():.1f} "
                      f"shaped={m.episode_shaped_reward.item():.1f} kl={m.kl.item():.4f} "
                      f"ent={m.entropy.item():.3f} ({time.time() - t0:.2f}s/iter)", flush=True)
            if it % args.save_freq == 0 or it == last_iter:
                save_checkpoint(out_dir, ts, config, step=it, extra={"use_lstm": args.use_lstm})
    finally:
        log.close()
    print(f"done in {time.time() - t_start:.0f}s -> {out_dir}", flush=True)


if __name__ == "__main__":
    main()
