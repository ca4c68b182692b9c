#!/usr/bin/env python3
"""Convert the JAX package's PPO checkpoints into the torch port's format.

    python convert_jax_checkpoints.py                  # the committed runs
    python convert_jax_checkpoints.py RUN_DIR [...] --out DIR

Runs on a CPU host with JAX, flax and orbax installed; it is a tool beside
the two packages, the one place where both are imported. For each run
directory (a JAX `config.json` with `latest_step`, `use_lstm` and `layout`,
and an orbax `step_{n}` tree) it:

  1. rebuilds the JAX template as `overcooked_ai_tpu.agents.loading` does:
     `PPOConfig(num_envs=2, net=NetConfig(**saved["net"]))`, then
     `make_ppo`, or `make_ppo_lstm` when `use_lstm` is set;
  2. restores the latest step with `training/checkpoint.restore_checkpoint`;
  3. converts it with the port's `training/convert.train_state_from_jax`
     into a `TrainState` from the port's own `make_ppo` / `make_ppo_lstm`
     init;
  4. writes it with the port's `save_checkpoint`: `config.json` (the run's
     config, `latest_step`, `use_lstm`, `layout`) and `step_{n}.pt`.

With no run given it converts the runs behind `EVAL_MATRIX.md`,
`EVAL_MATRIX_OLD_DYNAMICS.md` and the recurrent run (`RUNS`) into
`artifacts_torch/`, keeping their paths under `runs/`. The BC proxies
beside them need no conversion: the port reads their `params.msgpack`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "artifacts_torch")
LAYOUTS = ["cramped_room", "asymmetric_advantages", "coordination_ring",
           "forced_coordination", "counter_circuit_o_1order"]
RUNS = ([f"runs/{art}/ppo_{kind}_{layout}" for art in ("eval_artifact", "eval_artifact_old")
         for kind in ("sp", "bc") for layout in LAYOUTS] + ["runs/r4_lstm_cramped"])


def restore_jax(run_dir):
    """(meta, the JAX TrainState as numpy leaves) of a run's latest step."""
    import jax

    from overcooked_ai_tpu.core.layout import from_layout_name
    from overcooked_ai_tpu.training.checkpoint import restore_checkpoint
    from overcooked_ai_tpu.training.networks import NetConfig
    from overcooked_ai_tpu.training.ppo import PPOConfig, make_ppo
    from overcooked_ai_tpu.training.ppo_lstm import make_ppo_lstm

    with open(os.path.join(run_dir, "config.json")) as f:
        meta = json.load(f)
    spec = from_layout_name(meta["layout"])
    cfg = PPOConfig(num_envs=2, net=NetConfig(**meta["config"]["net"]))
    init_fn, _ = (make_ppo_lstm if meta.get("use_lstm") else make_ppo)(spec, cfg)
    ts, step = restore_checkpoint(run_dir, init_fn(jax.random.PRNGKey(0)))
    if step != meta["latest_step"]:
        raise ValueError(f"{run_dir}: restored step {step}, config.json says "
                         f"{meta['latest_step']}")
    return meta, jax.device_get(ts)


def port_config(saved: dict):
    """The port's PPOConfig of a JAX run's saved config (the fields the port
    has; the JAX learner's `fused` switches have no counterpart)."""
    from overcooked_ai_tpu_torch.training.networks import NetConfig
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig

    names = {f.name for f in dataclasses.fields(PPOConfig)} - {"net", "bc_schedule"}
    kw = {k: v for k, v in saved.items() if k in names}
    return PPOConfig(**kw, bc_schedule=tuple(tuple(p) for p in saved["bc_schedule"]),
                     net=NetConfig(**saved["net"]))


def convert_run(run_dir, out_dir):
    """Convert one JAX run into `out_dir`; returns (out_dir, step)."""
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.training.checkpoint import save_checkpoint
    from overcooked_ai_tpu_torch.training.convert import train_state_from_jax
    from overcooked_ai_tpu_torch.training.networks import NetConfig
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig, make_ppo
    from overcooked_ai_tpu_torch.training.ppo_lstm import make_ppo_lstm

    meta, jts = restore_jax(run_dir)
    use_lstm = bool(meta.get("use_lstm"))
    spec = from_layout_name(meta["layout"])
    template = PPOConfig(num_envs=2, net=NetConfig(**meta["config"]["net"]))
    init_fn, _ = (make_ppo_lstm if use_lstm else make_ppo)(spec, template, device="cpu")
    ts = train_state_from_jax(jts, init_fn(0))
    step = meta["latest_step"]
    save_checkpoint(out_dir, ts, port_config(meta["config"]), step,
                    extra={"use_lstm": use_lstm, "layout": meta["layout"]})
    return out_dir, step


def out_dir_of(run_dir, out_root=OUT_DIR):
    """runs/<a>/<b> -> <out_root>/<a>/<b>; any other path -> <out_root>/<basename>."""
    rel = os.path.relpath(os.path.abspath(run_dir), os.path.join(ROOT, "runs"))
    if rel.startswith(".."):
        rel = os.path.basename(os.path.normpath(run_dir))
    return os.path.join(out_root, rel)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", help="JAX run directories (default: the committed runs)")
    ap.add_argument("--out", default=OUT_DIR, help="output root")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from overcooked_ai_tpu.utils.platform import force_platform

    force_platform("cpu")
    import torch

    torch.set_num_threads(1)
    runs = args.runs or [os.path.join(ROOT, r) for r in RUNS]
    for run in runs:
        out, step = convert_run(run, out_dir_of(run, args.out))
        size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        print(f"{os.path.relpath(run, ROOT)} step {step} -> {os.path.relpath(out, ROOT)} "
              f"({size} bytes)", flush=True)


if __name__ == "__main__":
    main()
