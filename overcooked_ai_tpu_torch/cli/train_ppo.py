"""PPO self-play training CLI of the torch port (port of
`overcooked_ai_tpu.cli.train_ppo`).

Examples:
    python -m overcooked_ai_tpu_torch.cli.train_ppo --layout cramped_room --iters 420
    python -m overcooked_ai_tpu_torch.cli.train_ppo --local-testing --device cpu
    python -m overcooked_ai_tpu_torch.cli.train_ppo --bc-model runs/r4_bc/bc_proxy_cramped_room \
        --bc-schedule 0:0.5 --use-phi --phi-event-mix
    python -m overcooked_ai_tpu_torch.cli.train_ppo --use-lstm --local-testing --device cpu

Defaults mirror the reference production config: 30 envs x 400-step
episodes (train batch 12000), lr 5e-5, entropy 0.2 -> 0.1 over 3e5 steps,
8 SGD epochs, minibatch 2000 env steps. The env step runs on the card's
kernel (`--device cuda`, the default) or on its plain version on the CPU
(`--device cpu`); a run on `cuda` without a card stops, it never falls
back to the CPU. Writes metrics.jsonl and checkpoints under `--out`.

PPO_BC: `--bc-model <dir>` (the port's BC directory or the JAX package's)
is the partner, scheduled by `--bc-schedule`; it also plays seat 1 of the
periodic evaluation. `--use-phi` shapes with the potential phi, plus the
event shaping under `--phi-event-mix`.

`--use-lstm` trains the recurrent learner (`training/ppo_lstm.py`), whose
phi reward has no event mix and whose evaluation has no BC seat, as in the
JAX package; its checkpoints say `use_lstm` in config.json.
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
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default 5e-5, or 5e-4 with --use-phi: phi's dense "
                    "reward is small, and 5e-5 does not lift off in the JAX package's runs)")
    ap.add_argument("--use-phi", action="store_true",
                    help="dense reward = phi(s') - phi(s), the potential-based shaping")
    ap.add_argument("--phi-event-mix", action="store_true",
                    help="with --use-phi, add the event shaping to the potential difference")
    ap.add_argument("--bc-model", default=None,
                    help="BC model directory of the partner (PPO_BC)")
    ap.add_argument("--bc-schedule", default=None,
                    help="piecewise-linear BC-partner probability 't:v,t:v,...' in env steps, "
                    "e.g. '0:1,4e6:0'; needs --bc-model")
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
    ap.add_argument("--use-lstm", action="store_true",
                    help="the recurrent learner (LSTMPPONet, truncated BPTT over 20-step chunks)")
    ap.add_argument("--old-dynamics", action="store_true")
    ap.add_argument("--out", default=None,
                    help="run directory (default runs_torch/ppo_<layout>_shaped, or _phi)")
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
    if args.bc_schedule and not args.bc_model:
        ap.error("--bc-schedule requires --bc-model")
    if args.lr is None:
        args.lr = 5e-4 if args.use_phi else 5e-5
    return args


def parse_bc_schedule(text):
    """'t:v,t:v,...' -> ((t, v), ..., (inf, last v)); None -> no partner."""
    if not text:
        return ((0, 0.0), (float("inf"), 0.0))
    pts = [tuple(float(x) for x in part.split(":")) for part in text.split(",")]
    return tuple(pts) + ((float("inf"), pts[-1][1]),)


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
    sched.update(use_phi=args.use_phi, phi_event_mix=args.phi_event_mix,
                 bc_schedule=parse_bc_schedule(args.bc_schedule))
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

    tables = None
    if args.bc_model or args.use_phi:
        from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

        tables = build_motion_tables(spec.layout.terrain)
    bc_policy = None
    if args.bc_model:
        from overcooked_ai_tpu_torch.training.bc import bc_policy_batch, load_bc_model

        bc_params, bc_cfg = load_bc_model(args.bc_model)
        bc_policy = bc_policy_batch(spec, tables.feature_cost, bc_params, bc_cfg)
    potential_fn = None
    if args.use_phi:
        from overcooked_ai_tpu_torch.core.potential import make_potential_fn

        potential_fn = make_potential_fn(spec, tables.feature_cost)

    shaping = "phi" if args.use_phi else "shaped"
    out_dir = args.out or f"runs_torch/ppo_{args.layout}_{shaping}"
    os.makedirs(out_dir, exist_ok=True)
    log = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    if args.use_lstm:
        from overcooked_ai_tpu_torch.training.ppo_lstm import make_ppo_lstm, make_ppo_lstm_eval

        init_fn, train_it = make_ppo_lstm(spec, config, bc_policy, potential_fn, device=device)
    else:
        init_fn, train_it = make_ppo(spec, config, potential_fn, bc_policy, device=device)
    ts = init_fn(args.seed)
    start_iter = 0
    if args.resume:
        ts, start_iter = restore_checkpoint(out_dir, ts)
        print(f"resumed from step {start_iter}", flush=True)
    last_iter = start_iter + args.iters
    print(f"training {args.layout} ({shaping}) on {device} for {args.iters} iters x "
          f"{config.train_batch_size} env steps", flush=True)
    eval_fn = None
    if args.eval_interval and args.use_lstm:
        eval_fn = make_ppo_lstm_eval(spec, config.net, num_games=args.eval_games, device=device)
    elif args.eval_interval:
        eval_fn = make_ppo_eval(spec, num_games=args.eval_games, device=device,
                                bc_policy=bc_policy)
    extra = {"use_lstm": args.use_lstm, "layout": args.layout}

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
