"""PPO self-play training CLI of the torch port (port of
`overcooked_ai_tpu.cli.train_ppo`).

Examples:
    python -m overcooked_ai_tpu_torch.cli.train_ppo --layout cramped_room --iters 420
    python -m overcooked_ai_tpu_torch.cli.train_ppo --local-testing --device cpu

Defaults mirror the reference production config: 30 envs x 400-step
episodes (train batch 12000), lr 5e-5, entropy 0.2 -> 0.1 over 3e5 steps,
8 SGD epochs, minibatch 2000 env steps. The env step runs on the card's
kernel (`--device cuda`, the default) or on its plain version on the CPU
(`--device cpu`); a run on `cuda` without a card stops, it never falls
back to the CPU. Writes metrics.jsonl and checkpoints under `--out`.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", default="cramped_room")
    ap.add_argument("--iters", type=int, default=420)
    ap.add_argument("--num-envs", type=int, default=30,
                    help="parallel envs (reference: 30 workers x 400 = batch 12000)")
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--entropy-end", type=float, default=None,
                    help="entropy coefficient floor (reference entropy_coeff_end=0.1)")
    ap.add_argument("--entropy-horizon", type=float, default=None,
                    help="entropy anneal horizon in env steps (reference 3e5)")
    ap.add_argument("--shaping-horizon", type=float, default=None,
                    help="reward-shaping-factor anneal horizon in env steps (default inf)")
    ap.add_argument("--sgd-minibatch", type=int, default=None,
                    help="SGD minibatch size in env steps (reference 2000)")
    ap.add_argument("--num-sgd-iter", type=int, default=None,
                    help="SGD epochs per iteration (reference 8)")
    ap.add_argument("--old-dynamics", action="store_true")
    ap.add_argument("--out", default=None,
                    help="run directory (default runs_torch/ppo_<layout>_shaped)")
    ap.add_argument("--save-freq", type=int, default=100)
    ap.add_argument("--local-testing", action="store_true",
                    help="CI scale: 2 envs, minibatch 800, no entropy bonus")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --out")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="every N iters, run shaping-free eval games and log "
                    "eval_sparse_reward")
    ap.add_argument("--eval-games", type=int, default=8)
    ap.add_argument("--target-eval", type=float, default=None,
                    help="stop once eval_sparse_reward reaches this value, checkpoint, "
                    "and log the wall-clock; needs --eval-interval")
    args = ap.parse_args(argv)
    if args.target_eval is not None and not args.eval_interval:
        ap.error("--target-eval requires --eval-interval")
    return args


def check_device(device: str) -> torch.device:
    """The device to run on; a CUDA device without a card stops the run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA card (torch.cuda.is_available() is "
                         "false); pass --device cpu to run on the CPU")
    return device


def main(argv=None):
    args = parse_args(argv)
    device = check_device(args.device)

    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.training.checkpoint import (
        MetricsLogger,
        restore_checkpoint,
        save_checkpoint,
    )
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig, make_ppo, make_ppo_eval

    overrides = {"old_dynamics": True} if args.old_dynamics else {}
    spec = from_layout_name(args.layout, **overrides)

    sched = {}
    if args.entropy_end is not None:
        sched["entropy_coeff_end"] = args.entropy_end
    if args.entropy_horizon is not None:
        sched["entropy_coeff_horizon"] = args.entropy_horizon
    if args.shaping_horizon is not None:
        sched["reward_shaping_horizon"] = args.shaping_horizon
    if args.sgd_minibatch is not None:
        sched["sgd_minibatch_size"] = args.sgd_minibatch
    if args.num_sgd_iter is not None:
        sched["num_sgd_iter"] = args.num_sgd_iter
    if args.local_testing:
        config = PPOConfig(
            num_envs=2,
            sgd_minibatch_size=sched.pop("sgd_minibatch_size", 800),
            num_sgd_iter=sched.pop("num_sgd_iter", 8),
            entropy_coeff_start=0.0,
            entropy_coeff_end=0.0,
            lr=args.lr,
            **sched,
        )
    else:
        config = PPOConfig(num_envs=args.num_envs, lr=args.lr, **sched)

    out_dir = args.out or f"runs_torch/ppo_{args.layout}_shaped"
    os.makedirs(out_dir, exist_ok=True)
    log = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    init_fn, train_it = make_ppo(spec, config, device)
    ts = init_fn(args.seed)
    start_iter = 0
    if args.resume:
        ts, start_iter = restore_checkpoint(out_dir, ts)
        print(f"resumed from step {start_iter}", flush=True)
    last_iter = start_iter + args.iters
    print(f"training {args.layout} (shaped) on {device} for {args.iters} iters x "
          f"{config.train_batch_size} env steps", flush=True)
    eval_fn = None
    if args.eval_interval:
        eval_fn = make_ppo_eval(spec, num_games=args.eval_games, device=device)
    extra = {"use_lstm": False, "layout": args.layout}

    t_start = time.time()
    t_post_compile = None  # set after iter 1 (the first call builds the kernels)
    try:
        for it in range(start_iter + 1, last_iter + 1):
            t0 = time.time()
            ts, m = train_it(ts)
            log.log(it, m)
            if t_post_compile is None:
                t_post_compile = time.time()
                log.log(it, {"compile_s": round(t_post_compile - t_start, 2)})
            if eval_fn and it % args.eval_interval == 0:
                # the eval draws from a generator of its own, so the training
                # stream is the same with and without it
                ev = eval_fn(ts.net, torch.Generator(device=device).manual_seed(it))
                log.log(it, {"eval_sparse_reward": ev,
                             "elapsed_s": round(time.time() - t_start, 2),
                             "train_s": round(time.time() - t_post_compile, 2)})
                print(f"iter {it}: eval_sparse={ev:.1f} ({time.time() - t_start:.0f}s total, "
                      f"{time.time() - t_post_compile:.0f}s after the first iter)", flush=True)
                if args.target_eval is not None and ev >= args.target_eval:
                    save_checkpoint(out_dir, ts, config, step=it, extra=extra)
                    log.log(it, {
                        "speedrun_target": args.target_eval,
                        "speedrun_reached": ev,
                        "speedrun_total_s": round(time.time() - t_start, 2),
                        "speedrun_train_s": round(time.time() - t_post_compile, 2),
                        "speedrun_env_steps": it * config.train_batch_size,
                    })
                    print(f"SPEEDRUN: eval {ev:.1f} >= {args.target_eval} at iter {it} "
                          f"({it * config.train_batch_size} env steps) in "
                          f"{time.time() - t_start:.1f}s total", flush=True)
                    return
            if it % 10 == 0 or it == start_iter + 1:
                print(f"iter {it}: sparse={m.episode_sparse_reward.item():.1f} "
                      f"shaped={m.episode_shaped_reward.item():.1f} kl={m.kl.item():.4f} "
                      f"ent={m.entropy.item():.3f} ({time.time() - t0:.2f}s/iter, "
                      f"{time.time() - t_start:.0f}s total)", flush=True)
            if it % args.save_freq == 0 or it == last_iter:
                save_checkpoint(out_dir, ts, config, step=it, extra=extra)
    finally:
        log.close()
    print(f"done in {time.time() - t_start:.0f}s -> {out_dir}", flush=True)


if __name__ == "__main__":
    main()
