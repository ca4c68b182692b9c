"""Checkpoint / resume and metrics logging (port of
`overcooked_ai_tpu.training.checkpoint`).

A checkpoint is `step_{step}.pt` beside a `config.json` laid out as the JAX
package's: {"config": the PPOConfig, "latest_step": step, **extra}. The `.pt`
file holds tensors and plain numbers only (the net's and Adam's state
dicts, the generator's state, the counters), so `torch.load` reads it with
`weights_only=True`. Metrics go to a JSONL file, one row per `log` call,
with the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from overcooked_ai_tpu_torch.training.ppo import PPOConfig, TrainState


def save_checkpoint(ckpt_dir, ts: TrainState, config: PPOConfig, step: int, extra=None):
    """Save the learner state as `step_{step}.pt` and the config as JSON.
    `extra` merges more JSON metadata into config.json."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({
        "net": ts.net.state_dict(),
        "opt": ts.opt.state_dict(),
        "generator": ts.generator.get_state(),
        "env_steps": ts.env_steps.item(),
        "kl_coeff": ts.kl_coeff.item(),
    }, os.path.join(ckpt_dir, f"step_{step}.pt"))
    cfg = dataclasses.asdict(config)
    cfg["net"] = dataclasses.asdict(config.net)
    cfg["bc_schedule"] = [list(p) for p in config.bc_schedule]
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump({"config": cfg, "latest_step": step, **(extra or {})}, f, indent=1,
                  default=str)


def latest_step(ckpt_dir):
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return json.load(f)["latest_step"]


def load_policy_net(ckpt_dir, height: int, width: int, device="cuda"):
    """The policy net of a checkpoint's latest step alone, in eval mode on
    `device`, for a layout of `height` x `width` (an agent; no optimiser):
    an `LSTMPPONet` when config.json says `use_lstm`, else a `PPONet`. A
    directory without the port's `step_{n}.pt` (a JAX orbax checkpoint, say)
    raises ValueError, and so does a net that is not of the kind config.json
    names."""
    from overcooked_ai_tpu_torch.training.networks import LSTMPPONet, NetConfig, PPONet

    ckpt_dir = os.path.abspath(ckpt_dir)
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        meta = json.load(f)
    step = meta["latest_step"]
    path = os.path.join(ckpt_dir, f"step_{step}.pt")
    if not os.path.exists(path):
        raise ValueError(f"{ckpt_dir} holds no torch checkpoint step_{step}.pt (a JAX orbax "
                         "checkpoint? convert it on a host with JAX: python "
                         "convert_jax_checkpoints.py <run dir>)")
    kind = LSTMPPONet if meta.get("use_lstm") else PPONet
    net = kind(NetConfig(**meta["config"]["net"]), height, width)
    saved = torch.load(path, map_location="cpu", weights_only=True)["net"]
    if saved.keys() != net.state_dict().keys():
        raise ValueError(f"{path} does not hold {kind.__name__} params (config.json "
                         f"has use_lstm={bool(meta.get('use_lstm'))})")
    net.load_state_dict(saved)
    return net.to(device).eval()


def restore_checkpoint(ckpt_dir, ts_template: TrainState, step=None):
    """Load a checkpoint of save_checkpoint into `ts_template` (a TrainState
    from make_ppo's or make_ppo_lstm's init_fn for the same layout and
    config: its net, its Adam and its generator take the saved state).
    Returns (ts, step)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    saved = torch.load(os.path.join(ckpt_dir, f"step_{step}.pt"), map_location="cpu",
                       weights_only=True)
    ts_template.net.load_state_dict(saved["net"])
    ts_template.opt.load_state_dict(saved["opt"])
    ts_template.generator.set_state(saved["generator"])
    device = ts_template.env_steps.device
    return ts_template._replace(
        env_steps=torch.tensor(saved["env_steps"], dtype=torch.float32, device=device),
        kl_coeff=torch.tensor(saved["kl_coeff"], dtype=torch.float32, device=device),
    ), step


class MetricsLogger:
    """Append-only JSONL metrics log: {"step": step, name: value, ...} a row."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def log(self, step, metrics):
        row = {"step": step}
        for k, v in (metrics._asdict() if hasattr(metrics, "_asdict") else metrics).items():
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            row[k] = v.item() if v.size == 1 else v.tolist()
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
