"""Headline benchmark of the torch port on one card: the port of `bench.py`.

    python3 bench_torch.py

Prints ONE JSON line, the last line of its output, with `bench.py`'s
field names (each a measurement of the port on the card), one field beyond
them, `ppo_bc_phi_iter_wall_s`, and the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them.
It builds the kernels from `overcooked_ai_tpu_torch/csrc/` first if no
library of these sources exists (`ops/_build.py`). Without a CUDA card it
exits non-zero and prints no result. Any failed launch raises and the run
exits non-zero: no field holds a failure string, and nothing falls back to
another path.

Measured paths (`cramped_room` unless the field says otherwise):
  * `value` / `sweep`: B2 (`ops/fused_rollout`), `BATCH` envs x `NUM_STEPS`
    steps of murmur3 uniform-random play in one launch, auto-reset at 400;
    swept over the kernel's threads a block (`fused_rollout_random(..., threads=)`),
    `value` the best of the sweep. Host wall from a
    `torch.cuda.synchronize()` to the next, the median of `REPS` timed calls
    after `WARMUP` untimed ones.
  * `dispatch_overhead_ms` / `marginal_steps_per_sec`: the best block at S
    and 2S steps; fixed = t_S - (t_2S - t_S) (bench.py's marginal-rate
    split).
  * `train_path_value`: B1 (`ops/fused_train.train_rollout_random`), one
    launch a step with events, shaped rewards and the encoding, `BATCH` x
    `NUM_STEPS_TRAIN`.
  * `train_iter_*`: one `make_ppo` `train_iteration` (rollout on B1, GAE,
    minibatch SGD) at 2048 envs x 400 steps, minibatch 32768 env steps, 8
    epochs; and at the reference production config, 30 envs and minibatch
    2000 (`train_iter_ref_config_*`). `ITER_WARMUP` untimed iterations, then
    the median of `ITER_REPS`, as each config string says.
  * `pool_rollout_steps_per_sec`: B4 (`ops/fused_pool.fused_pool_rollout_random`)
    on `bench.py`'s 64-layout generated pool, `BATCH` x `NUM_STEPS`.
  * `ppo_bc_phi_iter_wall_s`: the train iteration's shape with the committed
    BC proxy `runs/r4_bc/bc_proxy_cramped_room` as the partner (bc_schedule
    0.5), `use_phi` and `phi_event_mix`: the paper's method, the port's
    slowest iteration (`ppo_bc_phi_config`, which `chip_smoke.py` phase 14
    imports).
The learners run in full float32 (TF32 off), as in `chip_smoke.py`.

Not ported from `bench.py`:
  * `train_path_sweep`: the JAX function takes a tile per call (`block_b`);
    B1's launch sizes its own tile (`fused_train.tile_plan`), so there is
    nothing to sweep through the public entry.
  * `_bench_pool` (`pool_xla_rollout_steps_per_sec`): it times JAX's XLA
    formulation of the pool path. The port's counterpart would be a plain
    version, which is no yardstick and never runs on a measured path.
  * `_bench_xla` and its fallback: a fallback that hides the kernel.
  * the per-config failure strings (`_fail`): a failure stops the run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_STEPS_PER_SEC = 50e6  # bench.py's baseline (BASELINE.md)
BATCH = 16384
NUM_STEPS = 20000  # steps a timed B2 / B4 call
NUM_STEPS_TRAIN = 4000  # steps (B1 launches) a timed train-path call
SWEEP_THREADS = (32, 64, 128, 256)  # B2's threads a block
REPS = 5
WARMUP = 3
TRAIN_ITER_ENVS = 2048  # x 400 steps = 819200 env steps an iteration
TRAIN_ITER_HORIZON = 400
TRAIN_ITER_MINIBATCH = 32768  # env steps an SGD minibatch (x 2 players)
REF_ENVS, REF_MINIBATCH = 30, 2000  # the reference production config
ITER_WARMUP = 1
ITER_REPS = 3
BC_PROXY = os.path.join(ROOT, "runs", "r4_bc", "bc_proxy_cramped_room")
BC_SCHEDULE_HALF = ((0, 0.5), (float("inf"), 0.5))  # the partner in half the episodes
SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
FIELDS = (
    "metric", "value", "unit", "vs_baseline", "sweep", "train_path_value",
    "train_path_unit", "train_path_vs_baseline", "dispatch_overhead_ms",
    "marginal_steps_per_sec", "train_iter_steps_per_sec", "train_iter_wall_s",
    "train_iter_config", "train_iter_ref_config_steps_per_sec",
    "train_iter_ref_config_wall_s", "train_iter_ref_config", "pool_rollout_steps_per_sec",
    "ppo_bc_phi_iter_wall_s", "ppo_bc_phi_iter_config", "device", "build_s", "wall_s",
)


def _fence(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _median_time(fn, state, device, warmup=None, reps=None):
    """fn(state, k) -> state, `warmup` times untimed, then `reps` times
    timed; returns (median seconds, state). Each timed call runs from one
    synchronize of the card to the next."""
    warmup = WARMUP if warmup is None else warmup
    reps = REPS if reps is None else reps
    for w in range(warmup):
        state = fn(state, w)
    times = []
    for r in range(reps):
        _fence(device)
        t0 = time.perf_counter()
        state = fn(state, warmup + r)
        _fence(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), state


def _spec():
    from overcooked_ai_tpu_torch.core.layout import from_layout_name

    return from_layout_name("cramped_room")


def _bench_rollout(layout, state, threads, num_steps=None, device="cuda"):
    """B2 (`fused_rollout_random`): `num_steps` steps of every env in one
    call, the kernel in blocks of `threads` (the plain version on the CPU).
    Returns (env-steps/s, median seconds, final state)."""
    from overcooked_ai_tpu_torch.ops import fused_rollout

    num_steps = NUM_STEPS if num_steps is None else num_steps
    batch = state.held.shape[1]

    def run(st, seed):
        return fused_rollout.fused_rollout_random(layout, st, seed, num_steps,
                                                  threads=threads)[0]

    dt, state = _median_time(run, state, device)
    return batch * num_steps / dt, dt, state


def _bench_train_path(layout, state, device="cuda"):
    """B1 under uniform-random play (`train_rollout_random`): one launch a
    step. Returns (env-steps/s, final state)."""
    import torch

    from overcooked_ai_tpu_torch.ops import fused_train

    batch = state.held.shape[1]

    def run(st, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return fused_train.train_rollout_random(layout, st, NUM_STEPS_TRAIN, generator=gen)[0]

    dt, state = _median_time(run, state, device)
    return batch * NUM_STEPS_TRAIN / dt, state


def _iter_config(num_envs, minibatch):
    return (f"{num_envs} envs x {TRAIN_ITER_HORIZON} steps, minibatch {minibatch} env-steps "
            f"x 8 epochs, B1 rollout, TF32 off; {ITER_WARMUP} untimed iteration(s), median of "
            f"{ITER_REPS} timed")


def _time_iterations(init_fn, train_it, device):
    ts = init_fn(0)

    def run(ts, _k):
        return train_it(ts)[0]

    dt, _ = _median_time(run, ts, device, ITER_WARMUP, ITER_REPS)
    return dt


def train_iter_config(num_envs=None, minibatch=None):
    """The train iteration's `PPOConfig` (8 epochs, PPOConfig's default);
    `chip_smoke.py` phase 12 times the same one."""
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig

    return PPOConfig(num_envs=num_envs or TRAIN_ITER_ENVS, horizon=TRAIN_ITER_HORIZON,
                     sgd_minibatch_size=minibatch or TRAIN_ITER_MINIBATCH)


def ppo_bc_phi_config():
    """The train iteration's shape as PPO_BC + phi: the partner with
    probability 0.5 an episode, phi with the event shaping; `chip_smoke.py`
    phase 14 times the same one."""
    return dataclasses.replace(train_iter_config(), bc_schedule=BC_SCHEDULE_HALF,
                               use_phi=True, phi_event_mix=True, lr=5e-4)


def _bench_train_iter(num_envs=None, minibatch=None, device="cuda"):
    """A full `make_ppo` train_iteration (rollout + encode + GAE + SGD);
    returns (env-steps/s, median seconds)."""
    from overcooked_ai_tpu_torch.training.ppo import make_ppo

    config = train_iter_config(num_envs, minibatch)
    dt = _time_iterations(*make_ppo(_spec(), config, device=device), device)
    return config.train_batch_size / dt, dt


def _bench_ppo_bc_phi(device="cuda"):
    """`ppo_bc_phi_config` with the committed proxy as the partner. Returns
    median seconds."""
    from overcooked_ai_tpu_torch.core.potential import make_potential_fn
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
    from overcooked_ai_tpu_torch.training.bc import bc_policy_batch, load_bc_model
    from overcooked_ai_tpu_torch.training.ppo import make_ppo

    spec = _spec()
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    partner = bc_policy_batch(spec, fc, *load_bc_model(BC_PROXY))
    return _time_iterations(*make_ppo(spec, ppo_bc_phi_config(), make_potential_fn(spec, fc),
                                      partner, device=device), device)


def _make_pool():
    """bench.py's pool: 64 layouts of one generator seeded 0 (5x4 outer
    shape); returns (specs, the stacked pool)."""
    import numpy as np

    from overcooked_ai_tpu_torch.core.layout_generator import LayoutGenerator, stack_layouts

    gen = LayoutGenerator(outer_shape=(5, 4), prop_empty=0.95, prop_feats=0.1,
                          rng=np.random.RandomState(0))
    specs = [gen.generate_spec(name=f"bench_{i}") for i in range(64)]
    return specs, stack_layouts(specs)


def _bench_pool_fused(seed=7, device="cuda"):
    """B4: per-lane layouts drawn from the pool, whole horizon in one launch
    through the public entry (which packs the pool each call)."""
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import layout_on
    from overcooked_ai_tpu_torch.core.layout_generator import gather_lanes
    from overcooked_ai_tpu_torch.ops.fused_pool import (
        check_pool_uniform,
        fused_pool_rollout_random,
    )

    specs, pool = _make_pool()
    spec0 = check_pool_uniform(specs)
    idx = torch.randint(len(specs), (BATCH,), device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    lay = gather_lanes(layout_on(pool, device), idx)

    def run(st, s):
        return fused_pool_rollout_random(spec0, lay, st, s, NUM_STEPS)[0]

    dt, _ = _median_time(run, batch_reset(lay, BATCH, device), device)
    return BATCH * NUM_STEPS / dt


def measure(device="cuda") -> dict:
    """Every field of the line but the device record and the walls."""
    from overcooked_ai_tpu_torch.core.env import batch_reset

    layout = _spec().layout
    state = batch_reset(layout, BATCH, device)
    sweep = {}
    for threads in SWEEP_THREADS:
        sweep[threads], _, state = _bench_rollout(layout, state, threads, device=device)
    best = max(sweep, key=sweep.get)
    value = sweep[best]
    train_value, state = _bench_train_path(layout, state, device)
    _, t1, state = _bench_rollout(layout, state, best, NUM_STEPS, device)
    _, t2, state = _bench_rollout(layout, state, best, 2 * NUM_STEPS, device)
    ti_rate, ti_dt = _bench_train_iter(device=device)
    ref_rate, ref_dt = _bench_train_iter(REF_ENVS, REF_MINIBATCH, device)
    return {
        "metric": "env_steps_per_sec_16k_envs_1chip",
        "value": round(value),
        "unit": "env-steps/s",
        "vs_baseline": round(value / BASELINE_STEPS_PER_SEC, 3),
        "sweep": {f"threads={k}": round(v) for k, v in sweep.items()},
        "train_path_value": round(train_value),
        "train_path_unit": "env-steps/s (events+shaped+encode emitted)",
        "train_path_vs_baseline": round(train_value / BASELINE_STEPS_PER_SEC, 3),
        "dispatch_overhead_ms": round((t1 - (t2 - t1)) * 1e3, 3),
        "marginal_steps_per_sec": round(BATCH * NUM_STEPS / max(t2 - t1, 1e-9)),
        "train_iter_steps_per_sec": round(ti_rate),
        "train_iter_wall_s": round(ti_dt, 3),
        "train_iter_config": _iter_config(TRAIN_ITER_ENVS, TRAIN_ITER_MINIBATCH),
        "train_iter_ref_config_steps_per_sec": round(ref_rate),
        "train_iter_ref_config_wall_s": round(ref_dt, 3),
        "train_iter_ref_config": _iter_config(REF_ENVS, REF_MINIBATCH),
        "pool_rollout_steps_per_sec": round(_bench_pool_fused(device=device)),
        "ppo_bc_phi_iter_wall_s": round(_bench_ppo_bc_phi(device), 3),
        "ppo_bc_phi_iter_config": _iter_config(TRAIN_ITER_ENVS, TRAIN_ITER_MINIBATCH)
        + "; the committed BC proxy as partner (bc_schedule 0.5), use_phi, phi_event_mix",
    }


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from overcooked_ai_tpu_torch.ops import _build

    name, power = (s.strip() for s in subprocess.run(
        SMI, capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].split(","))
    torch.backends.cuda.matmul.allow_tf32 = False  # the learners in full float32
    torch.backends.cudnn.allow_tf32 = False
    _, built, build_s = _build.build()
    line = measure(torch.device("cuda", 0))
    line["device"] = {"name": name, "power_limit": power, "torch": torch.__version__,
                      "cuda": torch.version.cuda}
    line["build_s"] = f"{build_s:.2f} {'cold' if built else 'warm'}"
    line["wall_s"] = round(time.perf_counter() - t_start, 1)
    print(json.dumps({k: line[k] for k in FIELDS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
