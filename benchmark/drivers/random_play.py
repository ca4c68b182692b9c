"""Random-play traffic: the public `fused_pool_rollout_random` (B4) back to back.

The traffic file names a layout pool under `benchmark/layouts/`, the env
count, the murmur3 steps a call and the auto-reset horizon. Each env lane
draws its layout from the pool by the seed; each call continues from the
last call's state with its own murmur3 seed, derived from the run's seed
and the call's index. Set-up makes one call (the kernels load, the pool is
packed); the window makes whole calls until `--seconds` have passed, and
its rate is all their env steps over all its time.

The check keeps one call of the window, drawn from the seed by reservoir
sampling, and replays it in the plain reference on every lane: its final
state and each lane's return must match exactly. The control (`no_reset`)
puts the reference without its auto-reset in the program's place.
"""

from __future__ import annotations

import json
import os
import random
import time

from harness.core import BENCH_DIR, Check
from harness.device import Profiler, device_record
from harness.weights import derive_seed, generator

PROFILED_SECONDS = 1.0  # the traced run's profiled part of the window


def _pool_configs(name):
    with open(os.path.join(BENCH_DIR, "layouts", f"{name}.json")) as f:
        return json.load(f)["layouts"]


def call_seed(seed, k):
    """The murmur3 seed of call k (a 32-bit value, as the kernel takes it)."""
    return derive_seed(seed, "call", k) & 0xFFFFFFFF


def run(ctx):
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import build_layout, layout_on
    from overcooked_ai_tpu_torch.core.layout_generator import gather_lanes, stack_layouts
    from overcooked_ai_tpu_torch.ops.fused_pool import check_pool_uniform, fused_pool_rollout_random

    dev, tr = ctx.device, ctx.traffic
    B, S, horizon = tr["num_envs"], tr["steps_per_call"], tr["horizon"]
    configs = _pool_configs(tr["pool"])
    specs = [build_layout(f"{tr['pool']}_{i}", c) for i, c in enumerate(configs)]
    spec0 = check_pool_uniform(specs)
    lanes = torch.randint(len(specs), (B,), generator=generator(ctx.seed, "lanes", device=dev),
                          device=dev)
    lay = gather_lanes(layout_on(stack_layouts(specs), dev), lanes)
    st = batch_reset(lay, B, dev)
    st, _ = fused_pool_rollout_random(spec0, lay, st, call_seed(ctx.seed, 0), S, horizon)
    if dev == "cuda":
        torch.cuda.synchronize()

    pick = random.Random(derive_seed(ctx.seed, "sample"))
    kept = None
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    calls, prof, stopped = 0, None, False
    k = 1
    while calls == 0 or time.perf_counter() - t_start < ctx.seconds:
        if ctx.trace and prof is None and time.perf_counter() - t_start >= ctx.seconds / 2:
            prof = Profiler()
            prof.start()
            t_prof = time.perf_counter()
        seed_k = call_seed(ctx.seed, k)
        out, ret = fused_pool_rollout_random(spec0, lay, st, seed_k, S, horizon)
        calls += 1
        if pick.random() < 1.0 / calls:  # a uniform draw of one call of the window
            kept = (st, seed_k, out, ret)
        st = out
        k += 1
        if prof is not None and not stopped and time.perf_counter() - t_prof >= PROFILED_SECONDS:
            prof.stop()
            stopped = True
    if prof is not None and not stopped:
        prof.stop()
    if dev == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    device = device_record(1) if dev == "cuda" else None
    trace = prof.read() if prof is not None else None

    check = Check(ctx.limits)
    _reference_check(ctx, check, configs, lanes, kept, horizon, S)
    return {"attempted": calls, "failed": 0, "device": device, "check": check, "trace": trace,
            "e2e": {tr["metric"]: calls * B * S / window_s}, "setup_s": setup_s,
            "layer": {"trace": trace, "traffic": tr, "config": ctx.config}}


def reference_rollout(lay, state, seed, num_steps, horizon):
    """The plain reference of a call: (final state, each lane's return)."""
    import torch

    from reference.env import clamp_stamps, env_step, murmur3_actions

    P, B = state.held.shape
    lanes = torch.arange(B, device=state.t.device)
    ret = torch.zeros(B, dtype=torch.int32, device=state.t.device)
    for k in range(num_steps):
        step = env_step(lay, state, murmur3_actions(seed, k, P, lanes), horizon)
        state = step.obs_state
        ret += step.reward
    return clamp_stamps(state), ret


def _reference_check(ctx, check, configs, lanes, kept, horizon, num_steps):
    from reference.layout import build_layout, layout_on
    from reference.pool import gather_lanes, stack_layouts
    from reference.state import State

    dev = ctx.device
    specs = [build_layout(f"pool_{i}", c) for i, c in enumerate(configs)]
    lay = gather_lanes(layout_on(stack_layouts(specs), dev), lanes)
    st_in, seed_k, out, ret = kept
    st_in = State(*st_in)
    if ctx.control == "no_reset":  # the reference without its auto-reset, as the program
        out, ret = reference_rollout(lay, st_in, seed_k, num_steps, 1 << 30)
    ref_out, ref_ret = reference_rollout(lay, st_in, seed_k, num_steps, horizon)
    mismatch = sum(int((a != b).sum()) for a, b in zip(out, ref_out)) + int((ret != ref_ret).sum())
    check.add("env_mismatch", mismatch)
