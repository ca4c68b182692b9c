#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (overcooked_ai_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: the CUDA kernels from csrc/ (cold or warm), and ptxas's
     registers and spills for B2 and B4 at 1-4 players;
  3. B2 parity: the whole-horizon rollout kernel against its plain PyTorch
     version, bit for bit, explicit actions and the murmur3 stream;
  4. B1 parity: the fused train-step kernel against its plain version, bit
     for bit on state, obs, rewards and events, step by step: the main
     path's 2048 envs, `train_rollout_random`'s 16384 and the eval's 8,
     ragged batches, old dynamics and
     `corridor` (HW = 126), a generated 16x8 layout (HW = 128, where the
     tile halves to 16 envs) and the state and actions as contiguous views
     at a 4-byte offset (the kernel's 4-byte staging copies);
  5. the policy path at full width: `collect_rollout` (2048 envs x 400
     steps, PPONet at NetConfig() widths, random weights from a seed) and
     `make_ppo_eval`, counting B1 launches; B1's time per launch at 2048
     and at 8 envs, and a sweep of its tile (envs and threads a block);
  6. env throughput: `rollout_random` at 16384 envs x 4000 steps on B2,
     then B2 held against its plain version at 16384 envs x 450 steps, and
     B2's device time at 16384 x 450 and 16384 x 4000;
  7. B4 parity: the pool whole-horizon kernel against its plain version on
     per-lane layouts, bit for bit: the main path's 16384 envs over 450
     steps, a ragged batch, the 7x5 outer shape, an old-dynamics pool and 1,
     3 and 4 players;
  8. B3 parity: the pool train-step kernel against its plain version, every
     step: 2048 envs, a ragged batch, 7x5, an old-dynamics pool, a pool
     whose lanes mix recipe values, cook times, shaping rewards and old
     dynamics, and a 16x8 pool (HW = 128, the halved tile);
  9. the pool policy path at full width: `collect_rollout` over a 64-layout
     generated pool (2048 envs x 400 steps), counting B3 launches, a traced
     short pool rollout, and B3's time per launch;
 10. pool env throughput: `fused_pool_rollout_random` at 16384 envs x 4000
     steps in one B4 launch, then `fused_pool_rollout_random_tiles` on the
     pool packed once, with each entry's wall outside the kernel; B4's
     device time at 16384 x 4000; a sweep of the threads a block of B2 and
     B4 at 16384 x 450;
 11. soups off the pots: B2 and B4 held against their plain versions on
     crafted `cramped_room` states with cooking soups on counters, idle full
     soups on counters under old dynamics, and a cooking soup carried from
     one counter to another by explicit actions;
 12. the learner at full width: `make_ppo`'s `train_iteration` at the JAX
     bench.py's train-iteration shape (2048 envs x 400 steps, minibatch
     32768 env steps, 8 epochs) on `cramped_room`, after a 32-step warm-up
     at its minibatch shape, its wall and its split into rollout, GAE and
     SGD by CUDA events, and a
     profiled one of 16 steps and 2 epochs at the same widths; one pool
     iteration (one epoch) on a regenerated 64-layout pool;
     a small iteration on the card against the CPU learner; the two
     training CLIs in process, into a temporary directory;
 13. agent-pair evaluation: `run_agent_pair` greedy vs greedy at 1024 games
     x 400 steps on `cramped_room` and x 200 on `counter_circuit_o_1order`
     (each step one B1 launch), its wall, games/s and B1 launches, the first 8 games
     held bit for bit over their first 200 steps against the same games on
     the CPU with the card's draws, the wall of one pair at the eval CLIs' default 4 games, and a
     traced 50-step run's device split; PPO (`PPONet` at
     NetConfig() widths, random weights from a seed, saved as a checkpoint
     and loaded through `build_agent("ppo:<dir>")`) vs greedy and
     Boltzmann vs stay at 1024 games x 200; the reference trajectory format and
     `check_trajectories` on 4 games; the two eval CLIs in process;
 14. human-aware PPO: featurize, phi and the committed BC proxy
     (`runs/r4_bc/bc_proxy_cramped_room`, read by the port's msgpack reader)
     on the card against the CPU on 2048-env states after 100 B1 steps of
     `cramped_room` and `counter_circuit_o_1order`; one PPO_BC + phi
     `train_iteration` at the phase 12 shape (bc_schedule 0.5 against the
     proxy, use_phi, phi_event_mix), its wall, its split by CUDA events, a
     traced 16-step rollout's device idle share and the eval with the BC
     seat at 8 x 200; one pool iteration (200 steps, one epoch) with the pool partner
     and the pool phi; a small PPO_BC + phi iteration on the card against the CPU; the
     `train_bc_proxy`, `train_ppo --bc-model --use-phi` and `eval_matrix`
     (a `bc:` agent) CLIs in process;
 15. the recurrent learner: `LSTMPPONet` (NetConfig() widths, cell 256) on
     the card against the CPU over a 20-step chunk of phase 5's obs from a
     nonzero carry; one `make_ppo_lstm` `train_iteration` at the phase 12
     shape (25 minibatches of 3276 chunks of 20 steps, 8 epochs), its wall
     and its split by CUDA events, B1 400 launches, and a profiled one of
     20 steps and 2 epochs at the same widths; one pool iteration
     (one epoch, B3 400 launches); a 32 x 40 iteration on the card against
     the CPU learner; `make_ppo_lstm_eval` at 8 x 400; `train_ppo
     --use-lstm` (then `--resume`), `train_ppo_from_params --use-lstm` (one
     iteration) and
     `eval_matrix` with the LSTM checkpoint as a `ppo:` agent, in process.
 16. the JAX package's trained agents and the interactive edge: (a) the 21
     runs converted by convert_jax_checkpoints.py (`artifacts_torch/`)
     loaded by `build_agent` on the card, their logits held against the
     CPU's on B1's obs; (b) `eval_artifact` cells at 100 games x 400 on the
     card (cramped_room PPO_SP+PPO_SP, PPO_BC+BC, greedy+PPO_SP; old-dynamics
     counter_circuit_o_1order PPO_SP+PPO_SP), each mean within three
     combined standard errors of the JAX table's, their walls and B1
     launches; (c) the converted recurrent run in self-play at 8 x 400, its
     first 50 steps held bit for bit against the CPU with the card's draws;
     (d) a `DemoGame` of 400 ticks, a scripted human seat against the
     `artifact:ppo_bc` NPC, the NPC's latency a tick against the 1/6 s tick,
     B1 at one env (400 launches and its time a launch), the rows replayed
     through the env on the CPU; (e) the demo server on an ephemeral port
     answering create, action, state, join, leave and the index page.
 17. data parallelism and `core.env.rollout`: (a) `make_ppo(mesh=...)` on a
     one-rank NCCL mesh in a rank process (`parallel/dryrun.py`), 32 x 50,
     against the meshless iteration of the same seed: the rollout's
     integers bit for bit, the params within 1e-5; (b) two gloo ranks on
     the one card at phase 12's width (2048 envs, 1024 a rank, x 400 steps,
     one epoch) on cramped_room (B1 400 launches a rank) and on 12b's pool
     (B3 400 a rank): each rank's wall split into rollout, GAE, SGD and
     all-reduce by CUDA events, the ranks' params bit for bit, and near
     the one-process iteration: within 3 times the drift of that iteration
     with its minibatches' rows reversed, or 1e-5 (two ranks on one card
     measure function, not scaling); (c) `core.env.rollout` under a seeded
     PPONet at 2048 x 400 (B1 400 launches), a 64 x 120 run across an
     auto-reset held bit for bit against the CPU's replay of its actions,
     and B1's refusals of 1 player and of a horizon past its stamp bound.
The kernel-against-plain holds of phases 3, 4, 6, 7, 8 and 11, and the CPU
replays of phases 13, 16c and 17c, and [cert] (every certificate of the
49-layout dynamics replay, `cli/certify_layouts`, on the card: B1 a step
on the 2-player layouts, B2 on every layout, both dynamics; its line
follows phase 4's), are parity jobs: worker processes (one
torch thread each, the plain versions on the CPU except at 16384 envs)
started together after the build and collected before the first timed
phase; 16a runs meanwhile. Phase 17's rank processes start once the
parity jobs are collected and prepare behind phases 5-16, then wait for
phase 17's go. Each phase line gives its longest job's seconds.
Phase 5 also times `train_rollout_random` (B1 under uniform-random play) at
the JAX bench.py's 16384 envs x 4000 steps.
B1's and B3's times are the profiler's device time (a timing whose session
records no launch of its kernel is made again, and fails the run after four
sessions with none); B2's and B4's are CUDA events' around one launch of
the kernel alone, queued behind untimed launches.
The smoke's wall is on a line of its own (`[wall]`); the line before the
last is the kernel table as JSON; the last line is the device record. Any
failure exits non-zero. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# INT32 outside the tensor cores: the data sheet's 67e12 float32 FLOP/s is
# 128 lanes an SM, an FMA counted as two; a Hopper SM has 64 INT32 lanes,
# one operation each a clock, so a quarter of it
H100_INT32_OPS_PER_S = 67e12 / 4
# the operation bound as the parent tree's smoke counted it (twice the rate
# above, and B4's cook pass over every cell): printed beside the bound so
# that the parent's and this tree's times divide the same work
OLD_INT32_OPS_PER_S = 33.5e12
PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]  # interact-heavy random play
# a pool whose lanes differ in recipe value, shaping rewards, and old
# dynamics with another cook time (B3 reads each lane's tables)
MIXED = [{}, {"delivery_reward": 37},
         {"rew_shaping_params": {"PLACEMENT_IN_POT_REW": 7, "DISH_PICKUP_REWARD": 1,
                                 "SOUP_PICKUP_REWARD": 11}},
         {"old_dynamics": True, "cook_time": 5}]


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, want) -> int:
    """Largest |difference| over matching integer tensors (0 = bit-exact)."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def cpu_max_err(got, want) -> int:
    """`max_err` with `got` on any device and `want` on the CPU."""
    return max_err([g.cpu() for g in got], want)


# ---- the parity jobs. Each holds kernels against their plain versions (or
# the card against the CPU) in a worker process with one torch thread; all
# start together after the build (phase 2), across the host's cores, and are
# collected before the first timed phase, so that no timed phase shares the
# host with one. The plain version runs on the CPU, where one thread runs it
# about as fast as the card's host dispatches it, except at 16384 envs
# (`PLAIN_ON_CARD`), where it runs on the card as in the kernels' tests.
PLAIN_ON_CARD = 16384  # envs from which a job's plain version runs on the card
WORKERS = 7  # the chip host's 8 cores, less the main process


_INIT_S = None  # a worker's seconds to start: torch, the card's context, the modules


def _worker_init():
    """One torch thread; the card's context and the port's modules loaded
    before the first job (the kernels' library loads at its first launch,
    after the main process built it)."""
    global _INIT_S
    t0 = time.perf_counter()
    import torch

    torch.set_num_threads(1)
    torch.ones(1, device=_card()).sum().item()
    from overcooked_ai_tpu_torch.agents import evaluation, loading  # noqa: F401
    from overcooked_ai_tpu_torch.ops import fused_pool  # noqa: F401

    _INIT_S = time.perf_counter() - t0


def _started():
    return _INIT_S


def _card():
    import torch

    return torch.device("cuda", 0)


def _plain_device(batch):
    import torch

    return _card() if batch >= PLAIN_ON_CARD else torch.device("cpu")


def _on(state, device):
    from overcooked_ai_tpu_torch.core.state import State

    return State(*(x.to(device) for x in state))


def shifted(x):
    """x as a contiguous view that starts 4 bytes past a 16-byte boundary."""
    import torch

    return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(
        x.shape).copy_(x)


def layout_gen(outer_shape, seed, num_players=2):  # as the JAX bench.py's pools
    import numpy as np

    from overcooked_ai_tpu_torch.core.layout_generator import LayoutGenerator

    return LayoutGenerator(outer_shape=outer_shape, prop_empty=0.95, prop_feats=0.1,
                           num_players=num_players, rng=np.random.RandomState(seed))


def make_pool(n, seed=0, outer_shape=(5, 4), cfgs=None, **kw):
    """n generated layouts; `cfgs`, one per layout, mixes their tables."""
    from overcooked_ai_tpu_torch.ops import fused_pool

    gen_ = layout_gen(outer_shape, seed, kw.pop("num_players", 2))
    specs = [gen_.generate_spec(name=f"bench_{i}", **(cfgs[i] if cfgs else kw))
             for i in range(n)]
    check = fused_pool.check_pool_shape if cfgs else fused_pool.check_pool_uniform
    return check(specs), specs


def lanes_of(specs, B, seed, dev):
    """A per-lane layout of B lanes drawn from `specs` by a generator on `dev`."""
    import torch

    from overcooked_ai_tpu_torch.core.layout import layout_on
    from overcooked_ai_tpu_torch.core.layout_generator import gather_lanes, stack_layouts

    idx = torch.randint(len(specs), (B,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(seed))
    return gather_lanes(layout_on(stack_layouts(specs), dev), idx)


def _b2_spec(case):
    from overcooked_ai_tpu_torch.core.layout import (
        build_layout,
        from_layout_name,
        read_layout_config,
    )

    if case in ("cramped_room", "corridor"):
        return from_layout_name(case)
    if case == "p1":
        return from_layout_name("old_dynamics_cook_test", old_dynamics=True)
    cfg = read_layout_config("multiplayer_schelling")
    if case == "p3":
        cfg["grid"] = cfg["grid"].replace("4", " ")
        return build_layout("schelling_3p", cfg)
    return from_layout_name("multiplayer_schelling")


def job_b2(case):
    """Phase 3: B2 against its plain version, explicit actions and the
    murmur3 stream: cramped_room and corridor at 256 envs x 60 steps
    (horizon 50), the 1-, 3- and 4-player layouts at 250 x 55."""
    import numpy as np
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import layout_on
    from overcooked_ai_tpu_torch.ops import fused_rollout

    spec = _b2_spec(case)
    lay, P = spec.layout, spec.num_players
    B, T = (256, 60) if case in ("cramped_room", "corridor") else (250, 55)
    seed = 7 if P == 2 else 3
    cpu = torch.device("cpu")
    state = batch_reset(lay, B, _card())
    acts = np.random.RandomState(0 if P == 2 else P).choice(6, size=(T, P, B), p=PROB)
    acts = torch.from_numpy(acts.astype(np.int32))
    got = fused_rollout.fused_rollout_actions(lay, state, acts.to(_card()), horizon=50)
    want = fused_rollout.plain_rollout(layout_on(lay, cpu), _on(state, cpu), 0, acts, T, 50)
    err = cpu_max_err((*got[0], got[1]), (*want[0], want[1]))
    got = fused_rollout.fused_rollout_random(lay, state, seed, T, horizon=50)
    want = fused_rollout.plain_rollout(layout_on(lay, cpu), _on(state, cpu), seed, None, T, 50)
    return {"err": max(err, cpu_max_err((*got[0], got[1]), (*want[0], want[1])))}


def _b1_case(k):
    from overcooked_ai_tpu_torch.core.layout import from_layout_name

    cramped = from_layout_name("cramped_room").layout
    return [
        # urgency from step 30 of 70, an auto-reset at 50
        (cramped, 256, 60, 70, 50, False),
        (from_layout_name("coordination_ring", old_dynamics=True).layout, 256, 60, 70, 50,
         False),
        (cramped, 2048, 60, 400, 400, False),  # the main path's shape
        (cramped, 16384, 20, 400, 400, False),  # train_rollout_random's width
        (cramped, 8, 70, 80, 60, False),  # the eval's 8 envs, urgency and a reset
        (cramped, 37, 60, 400, 400, False),  # a ragged last tile
        (cramped, 2048, 20, 400, 400, True),  # views at an offset: 4-byte staging copies
        # HW = 126, the largest shipped layout; urgency from step 30
        (from_layout_name("corridor").layout, 250, 60, 70, 50, False),
        # a generated 16x8 layout, HW = 128: the halved tile, E = 16
        (layout_gen((16, 8), 2).generate_spec(name="big").layout, 256, 60, 70, 50, False),
    ][k]


B1_CASES = 9


def job_b1(k):
    """Phase 4: B1 against its plain version, every step, in case k."""
    import numpy as np
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import layout_on
    from overcooked_ai_tpu_torch.core.state import State
    from overcooked_ai_tpu_torch.ops import fused_train

    dev = _card()
    lay, B, T, horizon, reset, offset = _b1_case(k)
    pdev = _plain_device(B)
    lay_p = layout_on(lay, pdev)
    rng = np.random.RandomState(1)
    sk = batch_reset(lay, B, dev)
    sp = _on(sk, pdev)
    if offset:
        sk = State(*(shifted(x) for x in sk))
    err = 0
    for _t in range(T):
        a = torch.from_numpy(rng.choice(6, size=(2, B), p=PROB).astype(np.int32))
        ak = shifted(a.to(dev)) if offset else a.to(dev)
        if offset and fused_train.stage_wide(fused_train.tile_plan(20, B), B, (*sk, ak)):
            raise SystemExit("B1 would stage misaligned rows in 16-byte copies")
        kk = fused_train.fused_train_step_tiles(lay, sk, ak, horizon=horizon,
                                                reset_horizon=reset)
        pp = fused_train.plain_train_step(lay_p, sp, a.to(pdev), horizon, reset)
        err = max(err, max_err([g.to(pdev) for g in (*kk[0], *kk[1:])], (*pp[0], *pp[1:])))
        sk, sp = kk[0], pp[0]
    return {"err": err}


def job_b2_main():
    """Phase 6: B2 against its plain version at the main path's 16384 envs
    over 450 steps (one auto-reset at 400), the plain version on the card,
    and its wall."""
    import time as _time

    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import from_layout_name, layout_on
    from overcooked_ai_tpu_torch.ops import fused_rollout

    dev = _card()
    lay = from_layout_name("cramped_room").layout
    state = batch_reset(lay, 16384, dev)
    got = fused_rollout.launch_kernel(lay, state, 1, None, 450, 400)
    torch.cuda.synchronize()
    t0 = _time.perf_counter()
    want = fused_rollout.plain_rollout(layout_on(lay, dev), state, 1, None, 450, 400)
    torch.cuda.synchronize()
    return {"err": max_err((*got[0], got[1]), (*want[0], want[1])),
            "plain_s": _time.perf_counter() - t0}


def job_b4_main():
    """Phase 7: B4 against its plain version on the 64-layout pool at the main
    path's 16384 envs over 450 steps, the plain version on the card, and its
    wall."""
    import time as _time

    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.ops import fused_pool

    dev = _card()
    spec_pool, specs64 = make_pool(64)
    lay = lanes_of(specs64, 16384, 1, dev)
    state = batch_reset(lay, 16384, dev)
    got = fused_pool.launch_rollout_kernel(fused_pool.pool_data(spec_pool, lay, dev), state, 1,
                                           None, 450, 400)
    torch.cuda.synchronize()
    t0 = _time.perf_counter()
    want = fused_pool.plain_pool_rollout(lay, state, 1, None, 450, 400)
    torch.cuda.synchronize()
    return {"err": max_err((*got[0], got[1]), (*want[0], want[1])),
            "plain_s": _time.perf_counter() - t0, "return": int(got[1].sum())}


B4_CASES = ["5x4 ragged", "7x5", "5x4 old dynamics", "1 player", "3 players", "4 players"]


def _b4_pool(k):
    if k == 0:
        return make_pool(64)
    return [None, make_pool(16, 1, (7, 5)), make_pool(16, 5, old_dynamics=True),
            make_pool(16, 1, (7, 5), num_players=1), make_pool(16, 3, (7, 5), num_players=3),
            make_pool(16, 4, (7, 5), num_players=4)][k]


def job_b4(k):
    """Phase 7: B4 against its plain version on pool case k, 250 envs (a
    ragged last block) x 55 steps (resets at 50), actions and murmur3."""
    import numpy as np
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import layout_on
    from overcooked_ai_tpu_torch.ops import fused_pool

    dev, cpu = _card(), torch.device("cpu")
    spec0, specs = _b4_pool(k)
    B, T, P = 250, 55, spec0.num_players
    lay = lanes_of(specs, B, k, dev)
    lay_h = layout_on(lay, cpu)
    state = batch_reset(lay, B, dev)
    acts = torch.from_numpy(np.random.RandomState(k).choice(6, size=(T, P, B), p=PROB)
                            .astype(np.int32))
    got = fused_pool.fused_pool_rollout_actions(spec0, lay, state, acts.to(dev), horizon=50)
    want = fused_pool.plain_pool_rollout(lay_h, _on(state, cpu), 0, acts, T, 50)
    err = cpu_max_err((*got[0], got[1]), (*want[0], want[1]))
    got = fused_pool.fused_pool_rollout_random(spec0, lay, state, 3, T, horizon=50)
    want = fused_pool.plain_pool_rollout(lay_h, _on(state, cpu), 3, None, T, 50)
    return {"err": max(err, cpu_max_err((*got[0], got[1]), (*want[0], want[1])))}


B3_CASES = ["5x4 B=2048", "5x4 B=37", "7x5 B=256", "old dynamics B=256", "mixed B=256",
            "16x8 B=250"]


def job_b3(k):
    """Phase 8: B3 against its plain version, every step, on pool case k
    (auto-resets at 50; urgency from step 30 of 70)."""
    import numpy as np
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import layout_on
    from overcooked_ai_tpu_torch.ops import fused_pool

    dev, cpu = _card(), torch.device("cpu")
    (spec0, specs), B = [
        (make_pool(64), 2048),  # the main path's shape
        (make_pool(64), 37),  # fewer envs than a block
        (make_pool(16, 1, (7, 5)), 256),
        (make_pool(16, 5, old_dynamics=True), 256),
        (make_pool(4, 5, cfgs=MIXED), 256),
        (make_pool(16, 2, (16, 8)), 250),  # HW = 128: E = 16
    ][k]
    lay = lanes_of(specs, B, 10 + k, dev)
    pool = fused_pool.pool_data(spec0, lay, dev)
    lay_h = layout_on(pool.layout, cpu)
    rng = np.random.RandomState(k)
    sk = batch_reset(lay, B, dev)
    sp = _on(sk, cpu)
    err = sparse = shaped = 0
    for _t in range(60):
        a = torch.from_numpy(rng.choice(6, size=(2, B), p=PROB).astype(np.int32))
        kk = fused_pool.fused_pool_train_step_tiles(spec0, pool, sk, a.to(dev), horizon=70,
                                                    reset_horizon=50)
        pp = fused_pool.plain_pool_train_step(lay_h, sp, a, 70, 50)
        err = max(err, cpu_max_err((*kk[0], *kk[1:]), (*pp[0], *pp[1:])))
        sparse += int(kk[2].sum())
        shaped += int(kk[3].sum())
        sk, sp = kk[0], pp[0]
    return {"err": err, "rows": pool.table_rows.shape[0], "sparse": sparse, "shaped": shaped}


SOUPS = {  # case -> {(x, y): (slots, tick)}
    "cooking": {(0, 0): ((1, 1, 1), 5), (4, 2): ((1, 2, 0), 0), (3, 0): ((2, 2, 2), 18),
                (2, 0): ((1, 1, 1), 3), (1, 0): ((1, 0, 0), -1)},
    "old_idle": {(0, 0): ((1, 1, 1), -1), (0, 2): ((2, 2, 2), -1), (4, 2): ((1, 2, 0), -1)},
    "carried": {(2, 3): ((1, 1, 1), 5)},
}


def job_soups(case):
    """Phase 11: B2 and B4 against their plain versions on a crafted
    `cramped_room` state whose live cells are not only the pots (as in
    tests/test_torch_rollout_soups.py), explicit actions, 70 envs (a ragged
    last block): 20 steps keep the crafted soups, 30 cross an auto-reset at
    25."""
    import numpy as np
    import torch

    from overcooked_ai_tpu_torch.core.constants import OBJ_SOUP
    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import from_layout_name, layout_on
    from overcooked_ai_tpu_torch.ops import fused_pool, fused_rollout

    dev, cpu = _card(), torch.device("cpu")
    B = 70
    spec_s = from_layout_name("cramped_room", old_dynamics=case == "old_idle")
    specs_s = [spec_s, from_layout_name("cramped_room", old_dynamics=case == "old_idle")]
    st = batch_reset(spec_s.layout, B, dev)
    for k, ((x, y), (slots, tick)) in enumerate(SOUPS[case].items()):
        st.obj[y, x] = OBJ_SOUP
        st.soup_ing[y, x] = torch.tensor(slots, dtype=torch.int32, device=dev)[:, None]
        st.soup_tick[y, x] = tick
        st.obj_seq[y, x] = k + 1
    acts = torch.from_numpy(
        np.random.RandomState(11).choice(6, size=(30, 2, B), p=PROB).astype(np.int32))
    if case == "carried":  # player 0 faces the soup, picks it up, carries it east, drops it
        st.pos[0, 0], st.pos[0, 1], st.orient[0] = 2, 2, 1
        acts[:4, 0] = torch.tensor([5, 2, 2, 5], dtype=torch.int32)[:, None]
        acts[:4, 1] = 4
    lay_s = lanes_of(specs_s, B, 7, dev)
    spec0_s = fused_pool.check_pool_uniform(specs_s)
    err = 0
    for steps, horizon in ((20, 400), (30, 25)):
        a = acts[:steps]
        got = fused_rollout.fused_rollout_actions(spec_s.layout, st, a.to(dev), horizon)
        got4 = fused_pool.fused_pool_rollout_actions(spec0_s, lay_s, st, a.to(dev), horizon)
        want = fused_rollout.plain_rollout(layout_on(spec_s.layout, cpu), _on(st, cpu), 0, a,
                                           steps, horizon)
        want4 = fused_pool.plain_pool_rollout(layout_on(lay_s, cpu), _on(st, cpu), 0, a, steps,
                                              horizon)
        err = max(err, cpu_max_err((*got[0], got[1]), (*want[0], want[1])),
                  cpu_max_err((*got4[0], got4[1]), (*want4[0], want4[1])))
    return {"err": err}


class Recorded:
    """The card's draws (a torch.Generator's), kept for the CPU's replay."""

    def __init__(self, inner):
        self.inner, self.log = inner, {}

    def at(self, t, player):
        from overcooked_ai_tpu_torch.agents.agents import StepDraws

        return StepDraws(self, t, player)

    def uniform(self, t, player, name):
        u = self.log[(t, player, name)] = self.inner.uniform(t, player, name)
        return u

    def gumbel(self, t, player, name, shape):
        g = self.log[(t, player, name)] = self.inner.gumbel(t, player, name, shape)
        return g


class Replayed(Recorded):
    """The first `n` games' draws of a recorded run, on the CPU."""

    def __init__(self, log, n):
        self.log, self.n = log, n

    def uniform(self, t, player, name):
        return self.log[(t, player, name)][..., :self.n].cpu()

    def gumbel(self, t, player, name, shape):
        return self.log[(t, player, name)][..., :self.n].cpu()


def traj_err(card, cpu, n):
    """Largest difference between the card's first `n` games and the CPU's,
    over the CPU's steps (the card's first ones)."""
    import numpy as np
    import torch

    def fields(t):
        return (*t["state"], t["actions"], t["sparse"], t["shaped"], t["events"])
    steps = cpu["actions"].shape[0]
    return max_err([torch.from_numpy(np.ascontiguousarray(x[:steps, ..., :n]))
                    for x in fields(card)], [torch.from_numpy(x) for x in fields(cpu)])


N_CPU = 8  # games the CPU replays of a card's run of agent pairs


def _pair(kind, spec, device):
    """An agent pair of phase 13 (greedy, boltzmann) or 16 (the converted
    recurrent run) on `device`."""
    from overcooked_ai_tpu_torch.agents import agents as agents_mod
    from overcooked_ai_tpu_torch.agents.evaluation import greedy_agent_fn
    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.planning.greedy_tables import build_greedy_tables
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

    if kind == "greedy":
        agent = greedy_agent_fn(agents_mod.make_greedy_human_model(
            spec, build_greedy_tables(spec, device=device)))
        return [agent, agent]
    if kind == "boltzmann":
        tables = build_motion_tables(spec.layout.terrain)
        return [build_agent(k, spec, tables, device) for k in ("boltzmann", "stay")]
    agent = build_agent(f"ppo:{os.path.join(ROOT, 'artifacts_torch', 'r4_lstm_cramped')}", spec,
                        None, device)
    return [agent, agent]


def job_pair_replay(kind, name, games, seed, steps):
    """The first `steps` steps of the card's run of an agent pair at `games`
    games (a generator seeded `seed` on the card, as the timed run of its
    phase draws) against the CPU's replay of its first N_CPU games with the
    card's recorded draws; with the card's actions in those games, which
    the timed run's must equal."""
    import torch

    from overcooked_ai_tpu_torch.agents import agents as agents_mod
    from overcooked_ai_tpu_torch.agents.evaluation import run_agent_pair
    from overcooked_ai_tpu_torch.core.layout import from_layout_name

    dev = _card()
    spec = from_layout_name(name)
    draws = Recorded(agents_mod.GeneratorDraws(torch.Generator(device=dev).manual_seed(seed),
                                               games))
    card = run_agent_pair(spec, _pair(kind, spec, dev), num_games=games, horizon=steps,
                          device=dev, draws=draws)
    cpu = run_agent_pair(spec, _pair(kind, spec, "cpu"), num_games=N_CPU, horizon=steps,
                         device="cpu", draws=Replayed(draws.log, N_CPU))
    return {"err": traj_err(card, cpu, N_CPU), "actions": card["actions"][..., :N_CPU]}


ARTIFACT_LAYOUTS = ["cramped_room", "asymmetric_advantages", "coordination_ring",
                    "forced_coordination", "counter_circuit_o_1order"]
# the JAX package's trained runs, converted by convert_jax_checkpoints.py
ARTIFACT_RUNS = ([f"{art}/ppo_{kind}_{layout}" for art in ("eval_artifact", "eval_artifact_old")
                  for kind in ("sp", "bc") for layout in ARTIFACT_LAYOUTS]
                 + ["r4_lstm_cramped"])


def artifact_logits(dev):
    """Phase 16a: every converted agent through `build_agent` on the card and
    on the CPU, its logits on a batch of B1's obs (256 envs after 60 steps of
    interact-heavy random play on its layout, at its dynamics; a recurrent
    agent over two steps from a zero carry): [(run, max |card - CPU|,
    largest |logit|)] and the seconds taken."""
    import numpy as np
    import torch

    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.core.state import State
    from overcooked_ai_tpu_torch.ops import fused_train

    t0 = time.perf_counter()
    cpu, B = torch.device("cpu"), 256
    batches, rows = {}, []
    for run in ARTIFACT_RUNS:
        path = os.path.join(ROOT, "artifacts_torch", run)
        with open(os.path.join(path, "config.json")) as f:
            layout = json.load(f)["layout"]
        old = run.startswith("eval_artifact_old/")
        spec = from_layout_name(layout, old_dynamics=old)
        if (layout, old) not in batches:
            state = batch_reset(spec.layout, B, dev)
            rng = np.random.RandomState(16)
            for _ in range(60):
                a = torch.from_numpy(rng.choice(6, size=(2, B), p=PROB).astype(np.int32))
                state, obs = fused_train.fused_train_step_tiles(spec.layout, state, a.to(dev),
                                                                horizon=400)[:2]
            batches[(layout, old)] = (state, obs)
        state, obs = batches[(layout, old)]
        state_h, obs_h = State(*(x.cpu() for x in state)), obs.cpu()
        out = []
        for d, st, ob in ((dev, state, obs), (cpu, state_h, obs_h)):
            policy = build_agent(f"ppo:{path}", spec, None, d).policy
            with torch.no_grad():
                if hasattr(policy, "init_carry"):
                    carry, logits = policy.init_carry(B, d), []
                    for seat in (0, 1):
                        lg, _, carry = policy.net.step(policy.net_input(st, ob, seat), carry)
                        logits.append(lg)
                    out.append(torch.cat(logits).cpu())
                else:
                    out.append(torch.cat([policy.logits(st, ob, seat) for seat in (0, 1)]).cpu())
        rows.append((run, float((out[0] - out[1]).abs().max()), float(out[1].abs().max())))
    return rows, time.perf_counter() - t0


def ppo_policy(net, layout, horizon, log=None):
    """A `core.env.rollout` policy: `net`'s Gumbel-max actions from the
    generator on the state's encoding (`layout` on the state's device);
    `log` keeps each step's actions."""
    import torch

    from overcooked_ai_tpu_torch.core.encoding import encode_nhwc
    from overcooked_ai_tpu_torch.training.ppo import gumbel_sample

    def policy(gen, _layout, state):
        logits, _ = net(encode_nhwc(layout, state, horizon))
        act = gumbel_sample(logits, gen).to(torch.int32).view(2, -1)
        if log is not None:
            log.append(act)
        return act

    return policy


def job_env_rollout():
    """17c's hold: `core.env.rollout` on the card, 64 envs x 120 steps of
    cramped_room at horizon 100 (crossing an auto-reset) under a seeded
    PPONet, against the CPU's plain rollout replaying the card's actions, on
    every `Timestep` leaf."""
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset, rollout
    from overcooked_ai_tpu_torch.core.layout import from_layout_name, layout_on
    from overcooked_ai_tpu_torch.ops import fused_train
    from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet

    dev, B, T, horizon = _card(), 64, 120, 100
    spec = from_layout_name("cramped_room")
    net = PPONet(NetConfig(), spec.height, spec.width,
                 generator=torch.Generator().manual_seed(17)).to(dev)
    acts = []
    fused_train.launches = 0
    with torch.no_grad():
        _, card = rollout(spec.layout, batch_reset(spec.layout, B, dev),
                          torch.Generator(device=dev).manual_seed(17), T,
                          ppo_policy(net, layout_on(spec.layout, dev), horizon, acts), horizon)
    launches = fused_train.launches
    replay = iter([a.cpu() for a in acts])
    _, cpu = rollout(spec.layout, batch_reset(spec.layout, B, "cpu"), None, T,
                     lambda *_: next(replay), horizon)

    def leaves(tr):
        return [*tr.state, *tr.obs_state, *tr[2:]]

    return {"err": cpu_max_err(leaves(card), leaves(cpu)), "launches": launches,
            "resets": int(cpu.done.sum()), "events": int(cpu.events.sum())}


def job_cert(old_dynamics):
    """[cert]: every certificate of the 49-layout dynamics replay
    (`cli/certify_layouts`) on the card: 400 biased-random steps of one env
    on each supported layout, B1 a step on the 2-player ones (every field),
    B2 in one launch on every one (the final state's sha256 and the sparse
    total); the unsupported ones refused."""
    from overcooked_ai_tpu_torch.cli import certify_layouts
    from overcooked_ai_tpu_torch.ops import fused_rollout, fused_train

    fused_train.launches = fused_rollout.launches = 0
    try:
        counts = certify_layouts.check_all(old_dynamics, _card(), log=lambda _: None)
    except SystemExit as e:
        return {"err": 1, "msg": str(e)}
    return {"err": 0, **counts, "b1": fused_train.launches, "b2": fused_rollout.launches}


# phase 17's data-parallel cases (`parallel/dryrun.py`): a one-rank NCCL
# mesh at 12c's shape; two gloo ranks on the one card at phase 12's width,
# one epoch, on cramped_room and on 12b's pool and regenerated pool
DP_ONE = [dict(name="one_rank", layout="cramped_room", seed=3, keep_rollout=True,
               config=dict(num_envs=32, horizon=50, num_sgd_iter=2, sgd_minibatch_size=400))]
DP_CONFIG = dict(num_envs=2048, horizon=400, sgd_minibatch_size=32768, num_sgd_iter=1)
POOL_GEN = {"outer_shape": [5, 4], "prop_empty": 0.95, "prop_feats": 0.1}  # as layout_gen's
DP_TWO = [dict(name="fixed", layout="cramped_room", seed=0, config=DP_CONFIG),
          dict(name="pool", pool={"n": 64, "seed": 0, "prefix": "bench_", "generator": POOL_GEN},
               regen={"n": 64, "seed": 1, "prefix": "regen_", "generator": POOL_GEN}, seed=0,
               config=DP_CONFIG)]
DP_TIMEOUT = 300  # seconds for the two ranks' iterations after the go
DP_FLOOR = 3  # 17b's bound on the ranks' drift, in drifts of a reordering (below)


def start_ranks(tmp):
    """Phase 17's rank processes: 17a's one NCCL rank and 17b's two gloo
    ranks join, build their meshes and prepare their cases, then each waits
    for its go. Returns {phase: (processes, directory, go file)}."""
    from overcooked_ai_tpu_torch.parallel import dryrun

    out = {}
    for phase, cases, nproc, backend in (("17a", DP_ONE, 1, None), ("17b", DP_TWO, 2, "gloo")):
        wdir, go = os.path.join(tmp, phase), os.path.join(tmp, f"go{phase}")
        out[phase] = (dryrun.launch(cases, nproc, wdir, backend, "cuda", go), wdir, go)
    return out


def parity_jobs():
    """(label, function, args) of every parity job, the longest first."""
    return ([("17c env.rollout cramped_room", job_env_rollout, ()),
             ("cert new dynamics", job_cert, (False,)), ("cert old dynamics", job_cert, (True,)),
             ("6 B2 16384x450", job_b2_main, ()), ("7 B4 16384x450", job_b4_main, ()),
             ("13 greedy cramped_room", job_pair_replay,
              ("greedy", "cramped_room", 1024, 13, 200)),
             ("13 boltzmann+stay cramped_room", job_pair_replay,
              ("boltzmann", "cramped_room", 1024, 2, 200)),
             ("13 greedy counter_circuit_o_1order", job_pair_replay,
              ("greedy", "counter_circuit_o_1order", 1024, 13, 200)),
             ("16c LSTM agent cramped_room", job_pair_replay,
              ("lstm", "cramped_room", 8, 16, 50))]
            + [(f"4 B1 case {k}", job_b1, (k,)) for k in range(B1_CASES)]
            + [(f"8 B3 {c}", job_b3, (k,)) for k, c in enumerate(B3_CASES)]
            + [(f"7 B4 {c}", job_b4, (k,)) for k, c in enumerate(B4_CASES)]
            + [(f"3 B2 {c}", job_b2, (c,)) for c in ("cramped_room", "corridor", "p1", "p3",
                                                     "p4")]
            + [(f"11 soups {c}", job_soups, (c,)) for c in SOUPS])


def _timed_job(fn, args):
    """fn(*args) in a worker, with the worker's wall for it."""
    t0 = time.perf_counter()
    out = fn(*args)
    out["secs"] = time.perf_counter() - t0
    return out


def start_workers():
    """A pool of WORKERS spawned processes, each started now (its
    `_worker_init`, while the main process builds the kernels); returns
    (executor, futures of each worker's start seconds)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ex = ProcessPoolExecutor(WORKERS, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_worker_init)
    return ex, [ex.submit(_started) for _ in range(WORKERS)]


def submit_parity_jobs(ex):
    """Every parity job, on the pool; {label: future}."""
    return {label: ex.submit(_timed_job, fn, args) for label, fn, args in parity_jobs()}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import numpy as np

    import bench_torch
    from overcooked_ai_tpu_torch.agents import agents as agents_mod
    from overcooked_ai_tpu_torch.agents.evaluation import (
        check_trajectories,
        run_agent_pair,
        stateless,
        trajectories_to_reference_format,
    )
    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.cli import (
        eval_artifact,
        eval_matrix,
        eval_pool,
        train_bc_proxy,
        train_ppo,
        train_ppo_from_params,
    )
    from overcooked_ai_tpu_torch.core.constants import OBJ_SOUP, TERRAIN_COUNTER, TERRAIN_POT
    from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS
    from overcooked_ai_tpu_torch.core.env import batch_reset, rollout, rollout_random
    from overcooked_ai_tpu_torch.core.featurize import featurize_batch
    from overcooked_ai_tpu_torch.core.layout import from_layout_name, layout_on
    from overcooked_ai_tpu_torch.core.layout_generator import stack_layouts
    from overcooked_ai_tpu_torch.core.potential import make_potential_fn, make_potential_fn_pool
    from overcooked_ai_tpu_torch.core.state import State
    from overcooked_ai_tpu_torch.demo.game import DemoGame, npc_from_kind
    from overcooked_ai_tpu_torch.interop.single_env import OvercookedEnv
    from overcooked_ai_tpu_torch.ops import _build, fused_pool, fused_rollout, fused_train
    from overcooked_ai_tpu_torch.parallel import dryrun
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
    from overcooked_ai_tpu_torch.training.bc import (
        bc_policy_batch,
        bc_policy_batch_pool,
        load_bc_model,
    )
    from overcooked_ai_tpu_torch.training.checkpoint import save_checkpoint
    from overcooked_ai_tpu_torch.training.networks import LSTMPPONet, NetConfig, PPONet
    from overcooked_ai_tpu_torch.training.ppo import (
        PPOConfig,
        collect_rollout,
        make_ppo,
        make_ppo_eval,
    )
    from overcooked_ai_tpu_torch.training.ppo_lstm import (
        MAX_SEQ_LEN,
        make_ppo_lstm,
        make_ppo_lstm_eval,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the net in full float32
    torch.backends.cudnn.allow_tf32 = False

    # the parity jobs' worker processes start now, beside phases 1 and 2
    executor, started = start_workers()

    # ---- 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {time.perf_counter() - t0:.2f}s torch {torch.__version__} "
        f"cuda {torch.version.cuda} count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build
    path, built, secs = _build.build()
    _build.load()
    log(f"[2 build] {secs:.2f}s {'cold' if built else 'warm'} -> {path}")
    # ptxas's report per kernel, "rollout_kernel<NP,POOL,RNG>": [registers,
    # spill-store bytes]; the spill line comes before the register line
    ptxas, name = {}, None
    with open(path[:-3] + ".log") as f:
        for line in f:
            m = re.search(r"entry function '_Z\d+(\w+?)I(\w+?)EEv", line)
            if m:
                name = f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"
                ptxas[name] = [None, None]
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                ptxas[name][1] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                ptxas[name][0] = int(m.group(1))
    rollout_regs = {k: v for k, v in sorted(ptxas.items()) if k.startswith("rollout")}
    log("[2 ptxas] registers, spill-store bytes " + json.dumps(rollout_regs))

    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # ---- 3, 4, 6-8, 11, 13, 16c: the parity jobs, in worker processes, all
    # started now; phase 16a's card-against-CPU logits meanwhile (not timed)
    t_pool = time.perf_counter()
    try:
        futures = submit_parity_jobs(executor)
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the workers have the other cores
        agents16 = artifact_logits(dev)
        torch.set_num_threads(n_threads)
        jobs = {label: fut.result() for label, fut in futures.items()}
        start_s = [fut.result() for fut in started]
    finally:
        executor.shutdown(cancel_futures=True)
    pool_wall = time.perf_counter() - t_pool
    log(f"[parity jobs] {pool_wall:.2f}s after the build, {len(jobs)} jobs "
        f"({sum(v['secs'] for v in jobs.values()):.1f}s of work) on {WORKERS} worker processes "
        f"(one torch thread each, started beside phases 1-2 in "
        f"{max(x for x in start_s if x is not None):.2f}s at most), seconds each: "
        + json.dumps({k: round(v["secs"], 2) for k, v in jobs.items()}))

    # phase 17's ranks start now: their imports, the card's contexts and
    # their cases' preparation run on the cores the parity jobs left, behind
    # phases 5-16, and their iterations wait for phase 17's go. Any rank left
    # at exit is killed
    dp_tmp = tempfile.TemporaryDirectory()
    ranks17 = start_ranks(dp_tmp.name)

    def stop_ranks():
        for procs, _, _ in ranks17.values():
            dryrun.stop(procs)
        dp_tmp.cleanup()

    atexit.register(stop_ranks)

    def jobs_of(prefix):
        return {k: v for k, v in jobs.items() if k.startswith(prefix)}

    b2_err = max(v["err"] for v in jobs_of("3 ").values())
    log(f"[3 B2 parity] {max(v['secs'] for v in jobs_of('3 ').values()):.2f}s (longest job) "
        f"cramped_room+corridor B=256 T=60, 1/3/4-player layouts B=250 T=55, actions+murmur3 "
        f"max_abs_err={b2_err}")
    if b2_err:
        raise SystemExit("B2 kernel disagrees with its plain version")
    b1_err = max(v["err"] for v in jobs_of("4 ").values())
    log(f"[4 B1 parity] {max(v['secs'] for v in jobs_of('4 ').values()):.2f}s (longest job) "
        f"cramped_room,coordination_ring(old) "
        f"B=256 T=60, cramped_room B=2048 T=60, B=16384 T=20, B=8 T=70, B=37 T=60 and "
        f"offset views "
        f"B=2048 T=20, corridor B=250 T=60, 16x8 B=256 T=60 "
        f"(tile {fused_train.tile_plan(128, 256).envs} envs), max_abs_err={b1_err}")
    if b1_err:
        raise SystemExit("B1 kernel disagrees with its plain version")
    cert = {k[5:8]: v for k, v in jobs_of("cert ").items()}
    log(f"[cert] {max(v['secs'] for v in cert.values()):.2f}s (longest job) the 49-layout "
        f"dynamics certificates, one env x 400 steps each, on the card: "
        + "; ".join(f"{dyn} dynamics " + (v["msg"] if v["err"] else
                    f"{v['layouts']} layouts matched (B1 {v.get('B1', 0)} layouts, "
                    f"{v['b1']} launches; B2 {v['B2']} layouts, {v['b2']} launches), "
                    f"{v['refused']} refused") for dyn, v in cert.items()))
    want_cert = {"new": (49, 45, 49, 0), "old": (34, 30, 34, 15)}
    if any(v["err"] or (v["layouts"], v.get("B1", 0), v["B2"], v["refused"]) != want_cert[dyn]
           or v["b1"] != 400 * v.get("B1", 0) or v["b2"] != v["B2"] for dyn, v in cert.items()):
        raise SystemExit("the card disagrees with a layout certificate")
    cert_launches = [sum(v["b1"] for v in cert.values()), sum(v["b2"] for v in cert.values())]

    # ---- 5. the policy path at full width
    spec = from_layout_name("cramped_room")
    lay = spec.layout
    torch.manual_seed(0)
    net = PPONet(NetConfig(), spec.height, spec.width).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = PPOConfig(num_envs=2048, horizon=400)
    collect_rollout(spec, net, PPOConfig(num_envs=2048, horizon=4), gen, dev)  # warm-up
    evaluate = make_ppo_eval(spec, num_games=8, horizon=400, device=dev)
    fused_train.launches = fused_rollout.launches = 0
    ro, t_collect = synced(lambda: collect_rollout(spec, net, cfg, gen, dev))
    b1_collect = fused_train.launches
    mean_return, t_eval = synced(lambda: evaluate(net, gen))
    b1_launches, b2_main5 = fused_train.launches, fused_rollout.launches
    if (b1_collect, b1_launches) != (cfg.horizon, cfg.horizon + 400):
        raise SystemExit(f"B1 launched {b1_collect} times in the rollout and "
                         f"{b1_launches - b1_collect} in the eval, want 400 each")
    ok = (ro.obs.shape == (400, 4096, spec.height, spec.width, NUM_LAYERS)
          and bool(torch.isfinite(ro.logp).all()) and bool(torch.isfinite(ro.value).all())
          and int(ro.events.ne(0).sum()) > 0 and mean_return >= 0)
    if not ok:
        raise SystemExit("collect_rollout / make_ppo_eval output is malformed")
    lstm_obs = ro.obs[:MAX_SEQ_LEN].transpose(0, 1).clone()  # phase 15a's 20-step chunk
    log(f"[5 policy path] {t_collect + t_eval:.2f}s collect 2048x400 {t_collect:.3f}s = "
        f"{2048 * 400 / t_collect:.0f} env-steps/s; eval 8x400 {t_eval:.3f}s "
        f"mean_sparse={mean_return}; B1 launches={b1_launches} (400+400) B2={b2_main5}; "
        f"shaped={int(ro.shaped.sum())} events={int(ro.events.ne(0).sum())}")

    # where a policy step's time goes: device time by kernel over a short
    # profiled rollout at the same width, against its wall. Only the rows of
    # device events count: a CPU op's row (aten::cudnn_convolution) carries
    # the device time of the kernels it launched, which have rows of their own
    def dev_time(e):
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            return 0
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    redone = []  # kernels whose timing took more than one profiler session

    def kernel_ms(name, fn):
        """fn's result and the mean device ms of one launch of the kernel
        whose name holds `name`, over the profiler's records of fn's
        launches. The profiler drops a device record whose time stamp falls
        outside its capture window (counted as "Out-of-range" in its log at
        KINETO_LOG_LEVEL=1): now and then a few of 50 short launches, or a
        session's only launch. So fn runs 20 ms inside the window's ends, the
        mean is over the records, not the launches made, and a session with
        no record is made again; four without one fail the run."""
        for _ in range(4):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                time.sleep(0.02)
                out = fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
            mine = [e for e in p.key_averages() if dev_time(e) > 0 and name in e.key]
            seen = sum(e.count for e in mine)
            if seen:
                return out, sum(dev_time(e) for e in mine) / 1e3 / seen
            redone.append(name)
        raise SystemExit(f"the profiler recorded no launch of {name} in four sessions")

    def card_ms(fn):
        """fn's result and the device ms of its one kernel launch: CUDA
        events around fn, queued behind three untimed calls of it, so that
        the card is busy while the host queues the timed launch; the median
        of three. fn launches the kernel alone. For B2 and B4, whose launches
        take from a few tenths of a ms: after the run's second trace (phase
        9) the profiler drops most of their records as outside its capture
        window, whatever the padding (PERF.md)."""
        times = []
        for _ in range(3):
            for _ in range(3):
                fn()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return out, sorted(times)[1]

    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    # device events only: with the host's ops the profiler takes seconds to
    # sum the records, and its host overhead would stretch the wall
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_prof = synced(lambda: collect_rollout(spec, net, PPOConfig(num_envs=2048, horizon=32),
                                                   gen, dev))
    by_kernel = sorted(((dev_time(e), e.key) for e in prof.key_averages() if dev_time(e) > 0),
                       reverse=True)
    busy_us = sum(us for us, _ in by_kernel)
    b1_us = sum(us for us, k in by_kernel if "train_step_kernel<false>" in k)
    top = "; ".join(f"{k[:40]} {us / 1e3:.2f}ms" for us, k in by_kernel[:4])
    log(f"[5 policy trace] 2048x32 wall {t_prof * 1e3:.1f}ms device busy {busy_us / 1e3:.1f}ms "
        f"(idle {1 - busy_us / 1e6 / t_prof:.1%}), B1 {b1_us / 1e3:.2f}ms; top: {top}")

    # B1 time per launch at the main path's shapes, the rollout's 2048 envs,
    # the eval's 8 and the agent pairs' 1024, device time from the profiler; the plain
    # version's wall per step; the byte bound: the state in and out, the
    # actions, the obs, the rewards and events
    HW, P = spec.height * spec.width, 2
    state_bytes = (8 * P + 6 * HW + 1) * 4
    env_bytes = 2 * state_bytes + 4 * P + NUM_LAYERS * P * HW + 12 * P
    lay_dev = layout_on(lay, dev)
    b1_time = {}
    for B in (2048, 8, 1024):
        state = batch_reset(lay, B, dev)
        act = torch.randint(0, 6, (2, B), dtype=torch.int32, device=dev, generator=gen)
        n = 50
        _, ms = kernel_ms("train_step_kernel<false>", lambda: [
            fused_train.fused_train_step_tiles(lay, state, act, horizon=400) for _ in range(n)])
        _, secs = synced(lambda: [fused_train.plain_train_step(lay_dev, state, act, 400, 400)
                                  for _ in range(10)])
        b1_time[B] = (ms, secs * 1e3 / 10, B * env_bytes / H100_BYTES_PER_S * 1e3)
    b1_ms, b1_plain_ms, b1_bound_ms = b1_time[2048]
    log(f"[5 B1 timing] B=2048 {b1_ms:.4f} ms/launch (profiler) plain {b1_plain_ms:.3f} ms "
        f"bound {b1_bound_ms:.5f} ms ({2048 * env_bytes} bytes); B=8 {b1_time[8][0]:.4f} "
        f"ms/launch plain {b1_time[8][1]:.3f} ms bound {b1_time[8][2]:.7f} ms; B=1024 "
        f"{b1_time[1024][0]:.4f} ms/launch plain {b1_time[1024][1]:.3f} ms bound "
        f"{b1_time[1024][2]:.6f} ms; "
        f"tile {fused_train.tile_plan(HW, 2048)}")

    # the tile sweep at the main path's 2048 envs: ms per launch for each
    # envs x threads a block (128 threads a block were the slowest at every
    # tile on the H100, and at the eval's 8 envs every tile took the same
    # time within 2%, PERF.md)
    sweep = {}
    for B in (2048,):
        state = batch_reset(lay, B, dev)
        act = torch.randint(0, 6, (2, B), dtype=torch.int32, device=dev, generator=gen)
        for envs in (8, 16, 32):
            for threads in (256, 512):
                plan = fused_train.tile_plan(HW, B, envs=envs, threads=threads)
                n = 30
                _, sweep[f"B{B}_E{envs}_T{threads}"] = kernel_ms(
                    "train_step_kernel<false>", lambda: [
                        fused_train.launch_kernel(lay, state, act, 400, 400, plan)
                        for _ in range(n)])
    log("[5 B1 tile sweep] ms/launch " + json.dumps({k: round(v, 5) for k, v in sweep.items()}))

    # the train path's env throughput: train_rollout_random (one B1 launch a
    # step, uniform-random actions, totals on the card) at the JAX bench.py's
    # BATCH x NUM_STEPS_TRAIN, after a short warm-up
    B, T = 16384, 4000
    state = batch_reset(lay, B, dev)
    fused_train.train_rollout_random(lay, state, 20, generator=gen)
    fused_train.launches = 0
    (final, totals), t_trr = synced(lambda: fused_train.train_rollout_random(
        lay, state, T, generator=gen))
    trr_launches = fused_train.launches
    totals = {k: v.tolist() for k, v in totals.items()}
    if trr_launches != T or not (totals["sparse"] > 0 and totals["obs_checksum"] > 0
                                 and bool(final.t.eq(T % 400).all())):
        raise SystemExit(f"train_rollout_random: {trr_launches} B1 launches, totals {totals}")
    log(f"[5 train_rollout_random] {B}x{T}: wall {t_trr:.3f}s = {B * T / t_trr:.0f} env-steps/s "
        f"on {smi}; B1 launches={trr_launches}; sparse={totals['sparse']} "
        f"shaped={totals['shaped']} obs_checksum={totals['obs_checksum']}")

    # ---- 6. env throughput on B2: the main path's run, then the kernel held
    # against its plain version at the same 16384 envs over 450 steps (one
    # auto-reset), which also gives the time, plain time and bound of the
    # kernel table; the plain version at 4000 steps would take most of a
    # minute. The kernel's device time at both lengths
    B, T, T_CMP = 16384, 4000, 450
    state = batch_reset(lay, B, dev)
    lay_b2, state_b2 = lay, state
    # a short warm-up: the main process launches B2 here first (its parity
    # cases run in the jobs), and a first launch carries one-time costs
    rollout_random(lay, state, 1, 8, horizon=400)
    fused_train.launches = fused_rollout.launches = 0
    (final, total), t_b2 = synced(lambda: rollout_random(lay, state, 1, T, horizon=400))
    b2_launches, b1_main6 = fused_rollout.launches, fused_train.launches
    if b2_launches != 1:
        raise SystemExit(f"rollout_random launched B2 {b2_launches} times, want 1")
    if not (bool(final.t.eq(T % 400).all()) and int(total) > 0):  # ten whole episodes
        raise SystemExit("rollout_random: wrong final timestep or no delivery at all")
    _, b2_ms = card_ms(lambda: fused_rollout.launch_kernel(lay, state, 1, None, T_CMP, 400))
    _, b2_main_ms = card_ms(lambda: fused_rollout.launch_kernel(lay, state, 1, None, T, 400))
    # the kernel against its plain version (on the card) at 16384 x 450: a
    # parity job's, with the plain version's wall there
    t_plain = jobs["6 B2 16384x450"]["plain_s"]
    b2_err = max(b2_err, jobs["6 B2 16384x450"]["err"])
    if b2_err:
        raise SystemExit("B2 kernel disagrees with its plain version at 16384 envs")
    # integer operations of one env step, counted by hand from
    # csrc/overcooked_step.cuh: about 105 per player (action hash, facing
    # cell decode, branch predicates, held and cell updates, move), 15 per
    # pot / start-soup cell (cook tick), 15 for collision, reset and return
    n_effect = int(((lay.terrain == TERRAIN_POT) | (lay.start_state.obj == OBJ_SOUP)).sum())
    ops_per_env_step = 105 * P + 15 * n_effect + 15
    b2_bytes = B * (2 * state_bytes + 4)

    def b2_bound(steps, rate=H100_INT32_OPS_PER_S):
        return max(B * steps * ops_per_env_step / rate, b2_bytes / H100_BYTES_PER_S) * 1e3

    b2_bound_ms, b2_main_bound_ms = b2_bound(T_CMP), b2_bound(T)
    b2_old_bounds = {T_CMP: b2_bound(T_CMP, OLD_INT32_OPS_PER_S), T: b2_bound(T, OLD_INT32_OPS_PER_S)}
    log(f"[6 B2 throughput] rollout_random {B}x{T}: wall "
        f"{t_b2 * 1e3:.3f} ms = {B * T / t_b2:.0f} env-steps/s, return={int(total)}; "
        f"B2 launches={b2_launches} B1={b1_main6}; kernel (events) {b2_main_ms:.4f} ms, "
        f"bound {b2_main_bound_ms:.4f} ms (old count {b2_old_bounds[T]:.4f}); {B}x{T_CMP}: kernel "
        f"{b2_ms:.4f} ms, plain {t_plain * 1e3:.1f} ms (a parity job), bound {b2_bound_ms:.4f} ms (old count "
        f"{b2_old_bounds[T_CMP]:.4f}), max_abs_err={b2_err}")

    # ---- the layout-pool path (B3, B4): pools as the JAX bench.py makes them
    def reset_counts():
        fused_train.launches = fused_rollout.launches = 0
        fused_pool.train_launches = fused_pool.rollout_launches = 0

    def counts():
        return (fused_train.launches, fused_rollout.launches, fused_pool.train_launches,
                fused_pool.rollout_launches)

    spec_pool, specs64 = make_pool(64)  # bench.py _make_pool: 64 layouts of 5x4

    # ---- 7. B4 parity, kernel vs plain, on per-lane layouts (the parity
    # jobs), and the kernel's time at the main path's 16384 envs over 450
    # steps (crossing the auto-reset at 400)
    B, T_CMP = 16384, 450
    lay_b4 = lanes_of(specs64, B, 1, dev)
    state_b4 = batch_reset(lay_b4, B, dev)
    pool_b4 = fused_pool.pool_data(spec_pool, lay_b4, dev)
    _, b4_cmp_ms = card_ms(lambda: fused_pool.launch_rollout_kernel(
        pool_b4, state_b4, 1, None, T_CMP, 400))
    b4_plain_s = jobs["7 B4 16384x450"]["plain_s"]
    b4_cmp_return = jobs["7 B4 16384x450"]["return"]
    b4_err = max(v["err"] for v in jobs_of("7 ").values())
    log(f"[7 B4 parity] {max(v['secs'] for v in jobs_of('7 ').values()):.2f}s (longest job) "
        f"64-layout pool B=16384 T={T_CMP} murmur3 (return={b4_cmp_return}); B=250 T=55 "
        f"actions+murmur3: {', '.join(B4_CASES)}; max_abs_err={b4_err}")
    if b4_err:
        raise SystemExit("B4 kernel disagrees with its plain version")

    # ---- 8. B3 parity, kernel vs plain, every step (the parity jobs)
    b3_err = max(v["err"] for v in jobs_of("8 ").values())
    mixed = jobs["8 B3 mixed B=256"]
    mixed_rows, mixed_sparse, mixed_shaped = mixed["rows"], mixed["sparse"], mixed["shaped"]
    log(f"[8 B3 parity] {max(v['secs'] for v in jobs_of('8 ').values()):.2f}s (longest job) "
        f"5x4 B=2048 T=60 and B=37 T=60, "
        f"7x5 B=256 T=60, old dynamics B=256 T=60, mixed tables B=256 T=60 "
        f"({mixed_rows} distinct rows, shaped={mixed_shaped} sparse={mixed_sparse}), 16x8 "
        f"B=250 T=60 (tile {fused_train.tile_plan(128, 250, pool=True).envs} envs), "
        f"max_abs_err={b3_err}")
    if mixed_rows != 4 or not mixed_shaped:
        raise SystemExit("the mixed pool's lanes did not run under four tables with shaping")
    if b3_err:
        raise SystemExit("B3 kernel disagrees with its plain version")

    # ---- 9. the pool policy path at full width
    net_pool = PPONet(NetConfig(), spec_pool.height, spec_pool.width).to(dev)
    collect_rollout(specs64, net_pool, PPOConfig(num_envs=2048, horizon=4), gen, dev)  # warm-up
    reset_counts()
    ro, t_pool = synced(lambda: collect_rollout(specs64, net_pool, cfg, gen, dev))
    pool_counts = counts()
    b3_launches = pool_counts[2]
    if pool_counts != (0, 0, cfg.horizon, 0):
        raise SystemExit(f"pool collect_rollout launched B1/B2/B3/B4 {pool_counts} times, "
                         f"want B3 {cfg.horizon} times and nothing else")
    ok = (ro.obs.shape == (400, 4096, spec_pool.height, spec_pool.width, NUM_LAYERS)
          and ro.pool_idx.shape == (2048,) and len(set(ro.pool_idx.tolist())) == 64
          and bool(torch.isfinite(ro.logp).all()) and bool(torch.isfinite(ro.value).all())
          and int(ro.events.ne(0).sum()) > 0)
    if not ok:
        raise SystemExit("pool collect_rollout output is malformed")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_prof = synced(lambda: collect_rollout(
            specs64, net_pool, PPOConfig(num_envs=2048, horizon=32), gen, dev))
    by_kernel = sorted(((dev_time(e), e.key) for e in prof.key_averages() if dev_time(e) > 0),
                       reverse=True)
    busy_us = sum(us for us, _ in by_kernel)
    b3_us = sum(us for us, k in by_kernel if "train_step_kernel<true>" in k)
    log(f"[9 pool policy path] collect 64-layout pool 2048x400 {t_pool:.3f}s = "
        f"{2048 * 400 / t_pool:.0f} env-steps/s; B1/B2/B3/B4 launches={pool_counts}; "
        f"shaped={int(ro.shaped.sum())} events={int(ro.events.ne(0).sum())}; trace 2048x32 "
        f"wall {t_prof * 1e3:.1f}ms device busy {busy_us / 1e3:.1f}ms "
        f"(idle {1 - busy_us / 1e6 / t_prof:.1%}), B3 {b3_us / 1e3:.2f}ms")

    # B3 time per launch at the main path's shape, from the profiler
    B, n = 2048, 50
    lay = lanes_of(specs64, B, 2, dev)
    pool = fused_pool.pool_data(spec_pool, lay, dev)
    state = batch_reset(lay, B, dev)
    act = torch.randint(0, 6, (2, B), dtype=torch.int32, device=dev, generator=gen)
    _, b3_ms = kernel_ms("train_step_kernel<true>", lambda: [
        fused_pool.fused_pool_train_step_tiles(spec_pool, pool, state, act, horizon=400)
        for _ in range(n)])
    _, secs = synced(lambda: [fused_pool.plain_pool_train_step(pool.layout, state, act, 400, 400)
                              for _ in range(10)])
    b3_plain_ms = secs * 1e3 / 10
    # B1's bytes (state in and out, actions, obs, rewards and events), each
    # lane's reset words and table index, and the pool's table rows once;
    # no lane resets here, so no start players
    HW, P = spec_pool.height * spec_pool.width, 2
    state_bytes = (8 * P + 6 * HW + 1) * 4
    b3_bytes = (B * (2 * state_bytes + 4 * P + NUM_LAYERS * P * HW + 12 * P + 4 * HW + 4)
                + 4 * pool.table_rows.numel())
    b3_bound_ms = b3_bytes / H100_BYTES_PER_S * 1e3
    log(f"[9 B3 timing] {b3_ms:.4f} ms/launch (profiler) plain {b3_plain_ms:.3f} ms "
        f"bound {b3_bound_ms:.5f} ms ({b3_bytes} bytes) B={B}")

    # ---- 10. pool env throughput on B4: the main path's run, one launch,
    # through the public entry (which packs the pool) and through the _tiles
    # entry on the pool packed once, each entry's wall against the kernel's
    B, T = 16384, 4000
    reset_counts()
    (final, ret), t_b4 = synced(lambda: fused_pool.fused_pool_rollout_random(
        spec_pool, lay_b4, state_b4, 1, T, horizon=400))
    b4_counts = counts()
    b4_launches = b4_counts[3]
    if b4_counts != (0, 0, 0, 1):
        raise SystemExit(f"fused_pool_rollout_random launched B1/B2/B3/B4 {b4_counts} times, "
                         f"want B4 once")
    if not (bool(final.t.eq(T % 400).all()) and int((ret >= 0).sum()) == B):
        raise SystemExit("fused_pool_rollout_random: wrong final timestep or a negative return")
    pool_b4, t_pack = synced(lambda: fused_pool.pool_data(spec_pool, lay_b4, dev))
    tiles_out, t_b4_tiles = synced(lambda: fused_pool.fused_pool_rollout_random_tiles(
        spec_pool, pool_b4, state_b4, 1, T, horizon=400))
    if max_err((*tiles_out[0], tiles_out[1]), (*final, ret)):
        raise SystemExit("fused_pool_rollout_random_tiles disagrees with the public entry")
    _, b4_main_ms = card_ms(lambda: fused_pool.launch_rollout_kernel(
        pool_b4, state_b4, 1, None, T, 400))
    b4_outside_ms = {"public": t_b4 * 1e3 - b4_main_ms, "tiles": t_b4_tiles * 1e3 - b4_main_ms}
    # integer operations of one env step: B2's count (the step is B2's under
    # POOL too), with each lane's pot and start-soup cells; and, for the
    # comparison with the parent, the parent's count: 110 per player, 4 per
    # cell for a cook pass over every cell, 11 more per pot cell, 15
    n_live = int(((lay_b4.terrain == TERRAIN_POT) | (lay_b4.start_state.obj == OBJ_SOUP)).sum())
    ops_per_step = B * (105 * P + 15) + 15 * n_live
    pots = int((lay_b4.terrain == TERRAIN_POT).sum())
    old_ops_per_step = B * (110 * P + 4 * HW + 15) + 11 * pots

    def b4_bound(steps, ops=ops_per_step, rate=H100_INT32_OPS_PER_S):
        """the operations of `steps` steps; the state in and out, the return,
        the reset words at load and at each auto-reset, the start players at
        each auto-reset"""
        resets = steps // 400
        b4_bytes = B * (2 * state_bytes + 4 + 4 * HW * (1 + resets) + 32 * P * resets)
        return max(ops * steps / rate, b4_bytes / H100_BYTES_PER_S) * 1e3

    b4_ops = ops_per_step * T_CMP
    b4_bound_ms, b4_main_bound_ms = b4_bound(T_CMP), b4_bound(T)
    b4_old_bounds = {steps: b4_bound(steps, old_ops_per_step, OLD_INT32_OPS_PER_S)
                     for steps in (T_CMP, T)}
    log(f"[10 pool throughput] fused_pool_rollout_random {B}x{T}: wall {t_b4 * 1e3:.3f} ms, "
        f"kernel {b4_main_ms:.4f} ms (events) = {B * T / b4_main_ms * 1e3:.0f} env-steps/s, "
        f"bound {b4_main_bound_ms:.4f} ms (old count {b4_old_bounds[T]:.4f}), "
        f"return={int(ret.sum())}; B1/B2/B3/B4 "
        f"launches={b4_counts}; packed once ({t_pack * 1e3:.3f} ms), "
        f"fused_pool_rollout_random_tiles wall {t_b4_tiles * 1e3:.3f} ms; wall outside the "
        f"kernel: public {b4_outside_ms['public']:.3f} ms, tiles {b4_outside_ms['tiles']:.3f} "
        f"ms; {B}x{T_CMP}: kernel {b4_cmp_ms:.4f} ms, plain {b4_plain_s * 1e3:.1f} ms, bound "
        f"{b4_bound_ms:.4f} ms ({b4_ops} ops; old count {b4_old_bounds[T_CMP]:.4f}), "
        f"max_abs_err={b4_err}")

    # the threads a block of B2 and B4, at the main path's 16384 envs over
    # 450 steps (ROLLOUT_THREADS is the constant)
    rollout_sweep = {}
    for threads in (32, 64, 128, 256):
        _, rollout_sweep[f"B2_T{threads}"] = card_ms(lambda: fused_rollout.launch_kernel(
            lay_b2, state_b2, 1, None, T_CMP, 400, threads))
        _, rollout_sweep[f"B4_T{threads}"] = card_ms(lambda: fused_pool.launch_rollout_kernel(
            pool_b4, state_b4, 1, None, T_CMP, 400, threads))
    log("[10 rollout sweep] ms at 16384x450 by threads a block "
        + json.dumps({k: round(v, 5) for k, v in rollout_sweep.items()}))

    # ---- 11. soups off the pots, kernel vs plain: crafted `cramped_room`
    # states whose live cells are not only the pots, on B2 and on B4 (the
    # parity jobs)
    soups_err = max(v["err"] for v in jobs_of("11 ").values())
    b2_err, b4_err = max(b2_err, soups_err), max(b4_err, soups_err)
    log(f"[11 soups off the pots] {max(v['secs'] for v in jobs_of('11 ').values()):.2f}s "
        f"(longest job) cooking, old_idle, carried: B=70, explicit actions, 20 steps and 30 "
        f"across an auto-reset, B2 and B4 max_abs_err={soups_err}")
    if soups_err:
        raise SystemExit("B2 or B4 disagrees with its plain version on soups off the pots")

    # ---- 12. the learner on the card at full width: make_ppo's
    # train_iteration at the JAX bench.py's train-iteration shape (2048 envs x
    # 400 steps, minibatch 32768 env steps, 8 epochs: 200 Adam steps), on
    # cramped_room (B1) and on the 64-layout pool with a regenerated pool
    # passed in (B3); a small iteration on the card against the CPU learner;
    # the two training CLIs in process, writing to a temporary directory
    t0 = time.perf_counter()
    cfg_it = bench_torch.train_iter_config()
    init_fn, train_it = make_ppo(spec, cfg_it, device=dev)
    ts = init_fn(0)
    # warm-up at the timed iteration's minibatch shape (a first iteration takes
    # about 0.5 s longer, PERF.md): 32 steps, one epoch of 2 minibatches
    make_ppo(spec, dataclasses.replace(cfg_it, horizon=32, num_sgd_iter=1), device=dev)[1](ts)
    kl_before, steps_before = ts.kl_coeff.item(), ts.env_steps.item()
    # the timed iteration, with CUDA events at its phase boundaries for the
    # split. From the rollout's end on (GAE, the SGD loop, the KL update), a
    # host sync that PyTorch's sync debug mode detects raises and fails the run
    marks = {name: torch.cuda.Event(enable_timing=True)
             for name in ("start", "rollout", "advantages", "end")}

    def mark(name, _out):
        marks[name].record()
        if name == "rollout":
            torch.cuda.set_sync_debug_mode("error")

    def timed_iteration(train, ts):
        marks["start"].record()
        try:
            out = train(ts, on_phase=mark)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        marks["end"].record()
        return out

    reset_counts()
    (ts, m), t_iter = synced(lambda: timed_iteration(train_it, ts))
    iter_counts = counts()
    b1_iter_launches = iter_counts[0]
    if iter_counts != (cfg_it.horizon, 0, 0, 0):
        raise SystemExit(f"train_iteration launched B1/B2/B3/B4 {iter_counts} times, want B1 "
                         f"{cfg_it.horizon} times and nothing else")
    metrics = {k: v.item() for k, v in m._asdict().items()}
    steps_after = ts.env_steps.item()
    if not all(np.isfinite(v) for v in metrics.values()) or steps_after != (
            steps_before + 2048 * 400):
        raise SystemExit(f"train_iteration metrics not finite or env_steps wrong: {metrics}")
    split = {"rollout": marks["start"].elapsed_time(marks["rollout"]),
             "gae_std": marks["rollout"].elapsed_time(marks["advantages"]),
             "sgd": marks["advantages"].elapsed_time(marks["end"])}
    n_samples = 2 * 2048 * 400
    mb = min(2 * cfg_it.sgd_minibatch_size, n_samples)
    log(f"[12a learner] {time.perf_counter() - t0:.2f}s train_iteration cramped_room 2048x400, "
        f"{n_samples // mb} minibatches of {mb} x {cfg_it.num_sgd_iter} epochs: wall "
        f"{t_iter:.3f}s = {2048 * 400 / t_iter:.0f} env-steps/s; split (events, no host "
        f"sync after the rollout) ms "
        + json.dumps({k: round(v, 1) for k, v in split.items()})
        + f"; B1/B2/B3/B4 launches={iter_counts}; kl_coeff {kl_before} -> "
        f"{metrics['kl_coeff']} (changed: {kl_before != metrics['kl_coeff']}), env_steps "
        f"{steps_after:.0f}; metrics " + json.dumps({k: round(v, 6) for k, v in
                                                     metrics.items()}))

    # and on the device: device time by kernel against the wall, over a
    # profiled iteration at the same widths but 16 steps and 2 epochs (2
    # minibatches of 32,768 samples an epoch: 4 Adam steps); the profiler
    # takes 15-20 s to sum the records of 40 steps and 8 epochs. It may drop
    # some (phase 9's note above), so the line says how many of the 16 B1
    # launches it recorded
    t0 = time.perf_counter()
    T_TR = 16
    cfg_tr = PPOConfig(num_envs=2048, horizon=T_TR, num_sgd_iter=2, sgd_minibatch_size=16384)
    init_tr, train_tr = make_ppo(spec, cfg_tr, device=dev)
    ts_tr, _ = train_tr(init_tr(0))  # its GAE and gathers at this T, once untraced
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_traced = synced(lambda: train_tr(ts_tr))
    by_kernel = sorted(((dev_time(e), e.count, e.key) for e in prof.key_averages()
                        if dev_time(e) > 0), reverse=True)
    busy_us = sum(us for us, _, _ in by_kernel)
    b1_seen = sum(n for _, n, k in by_kernel if "train_step_kernel<false>" in k)
    top = "; ".join(f"{k[:48]} x{n} {us / 1e3:.1f}ms" for us, n, k in by_kernel[:8])
    log(f"[12a learner trace] {time.perf_counter() - t0:.2f}s one iteration 2048x{T_TR}, 4 Adam "
        f"steps of 32768 samples: wall {t_traced * 1e3:.1f}ms device busy "
        f"{busy_us / 1e3:.1f}ms (idle {1 - busy_us / 1e6 / t_traced:.1%}), B1 records "
        f"{b1_seen}/{T_TR}; top: {top}")

    # the pool iteration: one SGD epoch, since the rollout is what differs
    # from 12a (its SGD is 12a's work on the same shapes)
    t0 = time.perf_counter()
    init_pool, train_pool = make_ppo(specs64, dataclasses.replace(cfg_it, num_sgd_iter=1),
                                     device=dev)
    ts_pool = init_pool(0)
    regen = layout_gen((5, 4), 1)  # one generator: 64 fresh layouts
    fresh = stack_layouts([regen.generate_spec(name=f"regen_{i}") for i in range(64)])
    reset_counts()
    (ts_pool, m_pool), t_pool_iter = synced(lambda: train_pool(ts_pool, pool=fresh))
    pool_iter_counts = counts()
    b3_iter_launches = pool_iter_counts[2]
    pool_one = {k: v.cpu() for k, v in ts_pool.net.state_dict().items()}  # 17b's reference
    if pool_iter_counts != (0, 0, cfg_it.horizon, 0):
        raise SystemExit(f"pool train_iteration launched B1/B2/B3/B4 {pool_iter_counts} times, "
                         f"want B3 {cfg_it.horizon} times and nothing else")
    if not all(np.isfinite(v.item()) for v in m_pool):
        raise SystemExit("pool train_iteration metrics not finite")
    log(f"[12b pool learner] {time.perf_counter() - t0:.2f}s train_iteration 64-layout pool "
        f"(regenerated) 2048x400, 1 epoch: wall {t_pool_iter:.3f}s = "
        f"{2048 * 400 / t_pool_iter:.0f} env-steps/s (first call, no warm-up); B1/B2/B3/B4 "
        f"launches={pool_iter_counts}; "
        f"shaped={m_pool.episode_shaped_reward.item():.3f} kl={m_pool.kl.item():.3g}")

    # a small iteration on the card and on the CPU from the same params, with
    # the same actions and permutations: the rollout's integer outputs bit for
    # bit, the losses within rtol 1e-4 / atol 1e-6 and the params within 1e-5,
    # the tolerances the CPU learner is held to against JAX
    # (tests/test_torch_ppo_learner.py)
    t0 = time.perf_counter()
    cfg_s = PPOConfig(num_envs=32, horizon=50, num_sgd_iter=2, sgd_minibatch_size=400)
    small_acts = np.random.RandomState(12).choice(6, size=(50, 64), p=PROB)
    small_perms = [np.random.RandomState(100 + e).permutation(2 * 32 * 50) for e in range(2)]
    small = {}
    for d in (dev, torch.device("cpu")):
        init_s, train_s = make_ppo(spec, cfg_s, device=d)
        kept = {}
        ts_s, m_s = train_s(init_s(3),
                            sample_fn=lambda _logits, t, d=d: torch.from_numpy(small_acts[t]).to(d),
                            perm_fn=lambda e, d=d: torch.from_numpy(small_perms[e]).to(d),
                            on_phase=kept.setdefault)
        small[d.type] = (ts_s, m_s, kept["rollout"])
    (ts_c, m_c, ro_c), (ts_h, m_h, ro_h) = small["cuda"], small["cpu"]
    small_int_err = max_err([getattr(ro_c, f).cpu() for f in ("obs", "action", "sparse",
                                                              "shaped", "events")],
                            [getattr(ro_h, f) for f in ("obs", "action", "sparse", "shaped",
                                                        "events")])
    losses = [(getattr(m_c, f).item(), getattr(m_h, f).item())
              for f in ("policy_loss", "vf_loss", "kl", "entropy", "episode_total_reward")]
    small_loss_ok = all(abs(a - b) <= 1e-6 + 1e-4 * abs(b) for a, b in losses)
    small_loss_err = max(abs(a - b) for a, b in losses)
    small_param_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        ts_c.net.state_dict().values(), ts_h.net.state_dict().values()))
    log(f"[12c card vs CPU] {time.perf_counter() - t0:.2f}s train_iteration 32x50, 2 epochs of "
        f"4 minibatches, same params, actions and permutations: rollout integers "
        f"max_abs_err={small_int_err}, losses max_abs_err {small_loss_err:.3g}, "
        f"params max_abs_err {small_param_err:.3g}; shaped={m_c.episode_shaped_reward.item()}")
    if small_int_err or not small_loss_ok or small_param_err > 1e-5:
        raise SystemExit("the learner on the card disagrees with the CPU learner")

    # the two training CLIs, in process, on the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()) as out:
        run = os.path.join(tmp, "run")
        cli = ["--device", "cuda", "--local-testing", "--out", run]
        train_ppo.main(cli + ["--iters", "2", "--eval-interval", "2"])
        train_ppo.main(cli + ["--iters", "1", "--resume"])
        with open(os.path.join(run, "config.json")) as f:
            cli_latest = json.load(f)["latest_step"]
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        cli_iters = [r["step"] for r in rows if "kl" in r]
        cli_eval = [r["eval_sparse_reward"] for r in rows if "eval_sparse_reward" in r]
        pool_run = os.path.join(tmp, "pool")
        train_ppo_from_params.main(["--device", "cuda", "--local-testing", "--regen-every",
                                    "1", "--iters", "1", "--out", pool_run])
        with open(os.path.join(pool_run, "config.json")) as f:
            pool_latest = json.load(f)["latest_step"]
    cli_lines = len(out.getvalue().splitlines())
    log(f"[12d CLIs] {time.perf_counter() - t0:.2f}s train_ppo --local-testing 2 iters then "
        f"--resume 1: latest_step={cli_latest}, iteration rows {cli_iters}, eval {cli_eval}; "
        f"train_ppo_from_params --regen-every 1: latest_step={pool_latest}; {cli_lines} lines "
        f"of their output")
    if (cli_latest, cli_iters, len(cli_eval), pool_latest) != (3, [1, 2, 3], 1, 1):
        raise SystemExit("the training CLIs did not train, checkpoint, resume and log")

    # ---- 13. agent-pair evaluation: greedy vs greedy at 1024 games x 400
    # steps on two layouts (each step one B1 launch); the first 8 games held
    # bit for bit against the same games on the CPU, with the card's draws
    t13 = time.perf_counter()

    def greedy_pair(spec_g, device):
        return _pair("greedy", spec_g, device)

    # the CPU's replays of the first T_CPU steps of the card's first N_CPU
    # games, with the card's draws, are parity jobs: the card's run there is
    # this one, the same generator's draws
    G, T13, T_CPU, G_CLI = 1024, 400, 200, 4
    T13B = 200  # 13b's pairs, cut to the CPU replay's steps (the smoke's time budget)
    pair_lines, pair_err, greedy_traj = [], 0, None
    # the second layout at 200 steps (the smoke's time budget)
    for name, T_pair in (("cramped_room", T13), ("counter_circuit_o_1order", 200)):
        spec_g = from_layout_name(name)
        pair = greedy_pair(spec_g, dev)
        run_agent_pair(spec_g, pair, num_games=G, horizon=8, device=dev)  # warm-up
        draws = agents_mod.GeneratorDraws(torch.Generator(device=dev).manual_seed(13), G)
        reset_counts()
        traj, t_pair = synced(lambda: run_agent_pair(spec_g, pair, num_games=G, horizon=T_pair,
                                                     device=dev, draws=draws))
        pair_counts = counts()
        if pair_counts != (T_pair, 0, 0, 0):
            raise SystemExit(f"run_agent_pair launched B1/B2/B3/B4 {pair_counts} times, want "
                             f"B1 {T_pair} times and nothing else")
        replay = jobs[f"13 greedy {name}"]
        err = replay["err"]
        pair_err = max(pair_err, err)
        returns = traj["sparse"].sum(axis=(0, 1))
        if not np.array_equal(traj["actions"][:T_CPU, ..., :N_CPU], replay["actions"]):
            raise SystemExit(f"the card's greedy pair on {name} acted otherwise in its parity "
                             "job")
        pair_lines.append(f"{name} {G}x{T_pair} wall {t_pair:.3f}s = {G / t_pair:.1f} games/s = "
                          f"{G * T_pair / t_pair:.0f} env-steps/s, B1 launches={pair_counts[0]}, "
                          f"mean return {returns.mean():.2f}, card vs CPU (first {N_CPU} games, "
                          f"{min(T_pair, T_CPU)} steps) "
                          f"max_abs_err={err}")
        if name == "cramped_room":
            greedy_traj, spec_cr, pair_launches = traj, spec_g, pair_counts[0]
            if returns.mean() <= 0:
                raise SystemExit("the greedy pair delivered nothing on cramped_room")
            # one pair at the eval CLIs' default --games 4: the wall a user waits for
            reset_counts()
            _, t_cli = synced(lambda: run_agent_pair(spec_g, pair, num_games=G_CLI,
                                                     horizon=T13, device=dev))
            if counts() != (T13, 0, 0, 0):
                raise SystemExit(f"run_agent_pair at {G_CLI} games launched B1/B2/B3/B4 "
                                 f"{counts()} times")
            pair_lines.append(f"{name} {G_CLI}x{T13} (the eval CLIs' default --games) wall "
                              f"{t_cli:.3f}s = {G_CLI / t_cli:.2f} games/s")
    log(f"[13a agent pairs] {time.perf_counter() - t13:.2f}s greedy+greedy: "
        + "; ".join(pair_lines))
    if pair_err:
        raise SystemExit("run_agent_pair on the card disagrees with the CPU")

    # where a step's time goes: a traced 50-step greedy pair at 1024 games
    pair = greedy_pair(spec_cr, dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_traced = synced(lambda: run_agent_pair(spec_cr, pair, num_games=G, horizon=50,
                                                    device=dev))
    by_kernel = sorted(((dev_time(e), e.key) for e in prof.key_averages() if dev_time(e) > 0),
                       reverse=True)
    busy_us = sum(us for us, _ in by_kernel)
    b1_us = sum(us for us, k in by_kernel if "train_step_kernel<false>" in k)
    copy_us = sum(us for us, k in by_kernel if "Memcpy" in k)
    top = "; ".join(f"{k[:40]} {us / 1e3:.2f}ms" for us, k in by_kernel[:4])
    # the host wall without the agents' work: a stay pair, B1 and the loop
    stay = stateless(agents_mod.stay_agent)
    _, t_stay = synced(lambda: run_agent_pair(spec_cr, [stay, stay], num_games=G, horizon=T13,
                                              device=dev))
    log(f"[13a pair trace] cramped_room {G}x50 wall {t_traced * 1e3:.1f}ms device busy "
        f"{busy_us / 1e3:.1f}ms (idle {1 - busy_us / 1e6 / t_traced:.1%}): B1 "
        f"{b1_us / 1e3:.2f}ms, copies to the host {copy_us / 1e3:.2f}ms, the agents' ops "
        f"{(busy_us - b1_us - copy_us) / 1e3:.2f}ms; top: {top}; stay+stay {G}x{T13} wall "
        f"{t_stay:.3f}s (B1, the loop and the copy, without the agents)")

    # PPO (full-width net, weights from a seed, through a checkpoint) vs
    # greedy, and Boltzmann vs stay
    t0 = time.perf_counter()
    tables_cr = build_motion_tables(spec_cr.layout.terrain)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ppo")
        cfg_ck = PPOConfig(num_envs=2)
        init_ck, _ = make_ppo(spec_cr, cfg_ck, device=dev)
        save_checkpoint(ckpt, init_ck(9), cfg_ck, step=1, extra={"use_lstm": False})
        ppo = build_agent(f"ppo:{ckpt}", spec_cr, tables_cr, dev)
        greedy = build_agent("greedy", spec_cr, tables_cr, dev)
        reset_counts()
        traj_pg, t_pg = synced(lambda: run_agent_pair(spec_cr, [ppo, greedy], num_games=G,
                                                      horizon=T13B, seed=1, device=dev))
        pg_counts = counts()
        # Boltzmann vs stay, its first games held against the CPU's with the
        # card's Gumbel draws (the goal and low-level argmaxes)
        def boltzmann_pair(device):
            return [build_agent(k, spec_cr, tables_cr, device) for k in ("boltzmann", "stay")]

        pair = boltzmann_pair(dev)
        draws = agents_mod.GeneratorDraws(torch.Generator(device=dev).manual_seed(2), G)
        traj_bs, t_bs = synced(lambda: run_agent_pair(spec_cr, pair, num_games=G, horizon=T13B,
                                                      device=dev, draws=draws))
        replay = jobs["13 boltzmann+stay cramped_room"]
        bs_err = replay["err"]
        pair_err = max(pair_err, bs_err)
        if not np.array_equal(traj_bs["actions"][:T_CPU, ..., :N_CPU], replay["actions"]):
            raise SystemExit("the card's Boltzmann pair acted otherwise in its parity job")
        log(f"[13b ppo, boltzmann] {time.perf_counter() - t0:.2f}s ppo+greedy {G}x{T13B} wall "
            f"{t_pg:.3f}s = {G / t_pg:.1f} games/s, B1 launches={pg_counts[0]}, mean return "
            f"{traj_pg['sparse'].sum(axis=(0, 1)).mean():.2f}; boltzmann+stay {G}x{T13B} wall "
            f"{t_bs:.3f}s = {G / t_bs:.1f} games/s, mean return "
            f"{traj_bs['sparse'].sum(axis=(0, 1)).mean():.2f}, card vs CPU (first {N_CPU} "
            f"games, {T_CPU} steps) max_abs_err={bs_err}")
        if pg_counts != (T13B, 0, 0, 0) or not all(
                ((t["actions"] >= 0) & (t["actions"] < 6)).all() for t in (traj_pg, traj_bs)):
            raise SystemExit("the PPO or Boltzmann pair is malformed")
        if bs_err:
            raise SystemExit("the Boltzmann pair on the card disagrees with the CPU")

        # the reference format and the replay check on 4 greedy games
        t0 = time.perf_counter()
        four = {k: v[..., :4] for k, v in greedy_traj.items() if k != "state"}
        four["state"] = State(*(x[..., :4] for x in greedy_traj["state"]))
        ref = trajectories_to_reference_format(spec_cr, four, horizon=T13)
        check_trajectories(ref, spec_cr, device=dev)
        log(f"[13c trajectories] {time.perf_counter() - t0:.2f}s reference format of 4 games x "
            f"{T13} steps, returns {ref['ep_returns']}; check_trajectories passed (one B1 launch "
            f"of {4 * (T13 - 1)} envs)")

        # the two eval CLIs in process, into the temporary directory
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            matrix = eval_matrix.main(["--device", "cuda", "--layouts", "cramped_room",
                                       "--agents", "greedy", f"ppo:{ckpt}", "--games", "2",
                                       "--horizon", "50", "--out",
                                       os.path.join(tmp, "matrix.json")])
            pool_summary = eval_pool.main(["--device", "cuda", "--ckpt", ckpt, "--pool-size", "4",
                                           "--games", "2", "--horizon", "50", "--out",
                                           os.path.join(tmp, "pool.json")])
        log(f"[13d eval CLIs] {time.perf_counter() - t0:.2f}s eval_matrix (greedy, ppo; 2 "
            f"games x 50 steps) {len(matrix)} pairs; eval_pool (4 layouts, 2 games x 50 steps) "
            + json.dumps(pool_summary["results"]))
        if len(matrix) != 4 or len(pool_summary["results"]) != 4:
            raise SystemExit("the eval CLIs did not evaluate every pair")
    log(f"[13 agent-pair evaluation] {time.perf_counter() - t13:.2f}s")

    # ---- 14. human-aware PPO: featurize, phi and the committed BC proxy on
    # the card against the CPU; one PPO_BC + phi train_iteration at full width
    # (B1) and one on the 64-layout pool (B3); a small iteration on the card
    # against the CPU learner; the three human-aware CLIs in process
    t14 = time.perf_counter()
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    proxy = bench_torch.BC_PROXY
    bc_params, bc_cfg = load_bc_model(proxy)  # the JAX package's msgpack, read by the port
    feat_err, phi_err, logit_err, logit_max, n_states = 0.0, 0.0, 0.0, 0.0, 0
    # torch.argmin keeps the first of equal minima on the card too
    ties = torch.zeros((40, 2048), dtype=torch.int32, device=dev)
    ties[7:] = -1
    argmin_first = int(torch.argmin(ties, 0).max()) == 7 and int(torch.argmin(ties, 0).min()) == 7
    for name in ("cramped_room", "counter_circuit_o_1order"):
        spec_f = from_layout_name(name)
        terrain = spec_f.layout.terrain
        goals = [(x, y) for y, x in zip(*np.nonzero(terrain == TERRAIN_COUNTER))]
        state = batch_reset(spec_f.layout, 2048, dev)
        rng = np.random.RandomState(14)
        for _t in range(100):
            a = torch.from_numpy(rng.choice(6, size=(2, 2048), p=PROB).astype(np.int32)).to(dev)
            state = fused_train.fused_train_step_tiles(spec_f.layout, state, a, horizon=400,
                                                       reset_horizon=401)[0]
        state_h = State(*(x.cpu() for x in state))
        for counters in ((), goals):  # counter goals: counter objects reachable, stamps rank
            fc = build_motion_tables(terrain, counter_goals=counters).feature_cost
            f_card = featurize_batch(layout_on(spec_f.layout, dev), torch.as_tensor(fc).to(dev),
                                     state)
            f_cpu = featurize_batch(spec_f.layout, fc, state_h)
            feat_err = max(feat_err, float((f_card.cpu() - f_cpu).abs().max()))
        fc = build_motion_tables(terrain).feature_cost
        phi_fn = make_potential_fn(spec_f, fc)
        p_card = phi_fn(layout_on(spec_f.layout, dev), state).cpu()
        p_cpu = phi_fn(spec_f.layout, state_h)
        if not torch.allclose(p_card, p_cpu, rtol=1e-5, atol=1e-4):
            phi_err = float("inf")
        phi_err = max(phi_err, float((p_card - p_cpu).abs().max()))
        partner = bc_policy_batch(spec_f, fc, bc_params, bc_cfg)
        with torch.no_grad():
            l_card = partner.logits(layout_on(spec_f.layout, dev), state).cpu()
            l_cpu = partner.logits(spec_f.layout, state_h)
        logit_err = max(logit_err, float((l_card - l_cpu).abs().max()))
        logit_max = max(logit_max, float(l_cpu.abs().max()))
        n_states += 2048
    log(f"[14a featurize, phi, proxy] {time.perf_counter() - t0:.2f}s {n_states} states after "
        f"100 B1 steps (cramped_room, counter_circuit_o_1order), card vs CPU: features "
        f"max_abs_err={feat_err} (with and without counter goals), phi max_abs_err {phi_err:.3g} "
        f"(rtol 1e-5, atol 1e-4), proxy logits max_abs_err {logit_err:.3g} (1e-6 of the largest "
        f"|logit|, {logit_max:.3g}: float32 products summed in another order); argmin takes "
        f"the first minimum on the card: {argmin_first}")
    if feat_err or phi_err > 1e-3 or logit_err > 1e-6 * max(1.0, logit_max) or not argmin_first:
        raise SystemExit("featurize, phi or the BC proxy on the card disagrees with the CPU")

    # one PPO_BC + phi iteration at the train-iteration shape: the proxy is
    # the partner with probability 0.5 an episode, phi shapes the reward with
    # the event shaping; its wall, the split by CUDA events, B1's launches
    t0 = time.perf_counter()
    fc_cr = build_motion_tables(spec.layout.terrain).feature_cost
    partner = bc_policy_batch(spec, fc_cr, bc_params, bc_cfg)
    phi_cr = make_potential_fn(spec, fc_cr)
    half = bench_torch.BC_SCHEDULE_HALF
    cfg_bc = bench_torch.ppo_bc_phi_config()
    collect_rollout(spec, net, PPOConfig(num_envs=2048, horizon=4, use_phi=True), gen, dev,
                    potential_fn=phi_cr, bc_policy=partner, bc_factor=0.5)  # warm-up
    init_bc, train_bc = make_ppo(spec, cfg_bc, phi_cr, partner, device=dev)
    ts_bc = init_bc(0)
    reset_counts()
    (ts_bc, m_bc), t_bc = synced(lambda: timed_iteration(train_bc, ts_bc))
    bc_counts = counts()
    bc_split = {"rollout": marks["start"].elapsed_time(marks["rollout"]),
                "gae_std": marks["rollout"].elapsed_time(marks["advantages"]),
                "sgd": marks["advantages"].elapsed_time(marks["end"])}
    bc_metrics = {k: v.item() for k, v in m_bc._asdict().items()}
    b1_bc_launches = bc_counts[0]
    if bc_counts != (cfg_bc.horizon, 0, 0, 0) or not all(
            np.isfinite(v) for v in bc_metrics.values()) or not (
            0.2 < bc_metrics["bc_sample_fraction"] < 0.3):
        raise SystemExit(f"the PPO_BC + phi iteration: B1/B2/B3/B4 launches {bc_counts}, "
                         f"metrics {bc_metrics}")
    # where its rollout's time goes: the device's busy time over a traced
    # 16-step rollout at the same width (device events only: with the host's
    # ops the profiler takes seconds to sum the records)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_bc_prof = synced(lambda: collect_rollout(
            spec, net, PPOConfig(num_envs=2048, horizon=16, use_phi=True, phi_event_mix=True),
            gen, dev, potential_fn=phi_cr, bc_policy=partner, bc_factor=0.5))
    busy_bc = sum(dev_time(e) for e in prof.key_averages())
    # the eval with the partner in seat 1, 8 games x 200 (B1 at 8 envs; cut
    # from 400 steps for the smoke's time budget)
    eval_bc = make_ppo_eval(spec, num_games=8, horizon=200, device=dev, bc_policy=partner)
    reset_counts()
    mean_bc, t_eval_bc = synced(lambda: eval_bc(ts_bc.net, gen))
    b1_eval_bc = counts()[0]
    if b1_eval_bc != 200:
        raise SystemExit(f"make_ppo_eval with the BC seat launched B1 {b1_eval_bc} times")
    log(f"[14b PPO_BC + phi] {time.perf_counter() - t0:.2f}s train_iteration cramped_room "
        f"2048x400, minibatch 65536 samples x 8 epochs, bc_schedule 0.5 (the committed proxy), "
        f"use_phi + phi_event_mix: wall {t_bc:.3f}s = {2048 * 400 / t_bc:.0f} env-steps/s; split "
        f"(events, no host sync after the rollout) ms "
        + json.dumps({k: round(v, 1) for k, v in bc_split.items()})
        + f"; B1/B2/B3/B4 launches={bc_counts}; bc_sample_fraction "
        f"{bc_metrics['bc_sample_fraction']:.4f}; episode_total_reward "
        f"{bc_metrics['episode_total_reward']:.3f}; traced rollout 2048x16 wall "
        f"{t_bc_prof * 1e3:.1f}ms device busy {busy_bc / 1e3:.1f}ms (idle "
        f"{1 - busy_bc / 1e6 / t_bc_prof:.1%}); eval with the BC seat 8x200 {t_eval_bc:.3f}s "
        f"mean_sparse={mean_bc}, B1 launches={b1_eval_bc}")

    # the pool: the pool partner (each lane featurizes on its own layout) and
    # the pool phi on the 64-layout pool (fixed: their tables are per entry);
    # one SGD epoch, since the rollout is what differs from phase 12b, and
    # 200 steps (the smoke's time budget)
    t0 = time.perf_counter()
    fcs64 = [build_motion_tables(s.layout.terrain).feature_cost for s in specs64]
    init_pbc, train_pbc = make_ppo(
        specs64, dataclasses.replace(cfg_bc, horizon=200, num_sgd_iter=1),
        make_potential_fn_pool(specs64), bc_policy_batch_pool(specs64, fcs64, bc_params, bc_cfg),
        device=dev)
    reset_counts()
    (_, m_pbc), t_pbc = synced(lambda: train_pbc(init_pbc(0)))
    pbc_counts = counts()
    b3_bc_launches = pbc_counts[2]
    if pbc_counts != (0, 0, 200, 0) or not all(np.isfinite(v.item()) for v in m_pbc):
        raise SystemExit(f"the pool PPO_BC + phi iteration launched B1/B2/B3/B4 {pbc_counts} "
                         "times or its metrics are not finite")
    log(f"[14c pool PPO_BC + phi] {time.perf_counter() - t0:.2f}s train_iteration 64-layout "
        f"pool 2048x200, 1 epoch, with bc_policy_batch_pool and the pool phi: wall {t_pbc:.3f}s = "
        f"{2048 * 200 / t_pbc:.0f} env-steps/s; B1/B2/B3/B4 launches={pbc_counts}; "
        f"bc_sample_fraction {m_pbc.bc_sample_fraction.item():.4f}")

    # a small PPO_BC + phi iteration on the card and on the CPU from the same
    # params, actions, partner draws (Gumbel noise from numpy), seats and
    # permutations: integers bit for bit, losses within rtol 1e-4 / atol 1e-6,
    # params within 1e-5, as phase 12c
    t0 = time.perf_counter()
    cfg_sbc = PPOConfig(num_envs=32, horizon=50, num_sgd_iter=2, sgd_minibatch_size=400,
                        bc_schedule=half, use_phi=True, phi_event_mix=True)
    noise = np.random.RandomState(15).gumbel(size=(50, 64, 6)).astype(np.float32)
    seats = (torch.from_numpy(np.random.RandomState(16).rand(32).astype(np.float32)),
             torch.from_numpy(np.random.RandomState(17).randint(0, 2, 32)))
    small = {}
    for d in (dev, cpu):
        init_s, train_s = make_ppo(spec, cfg_sbc, phi_cr, partner, device=d)
        kept = {}
        ts_s, m_s = train_s(
            init_s(3), sample_fn=lambda _lg, t, d=d: torch.from_numpy(small_acts[t]).to(d),
            perm_fn=lambda e, d=d: torch.from_numpy(small_perms[e]).to(d),
            bc_sample_fn=lambda lg, t: torch.argmax(lg + torch.from_numpy(noise[t]).to(lg.device),
                                                    -1),
            bc_draws=tuple(x.to(d) for x in seats), on_phase=kept.setdefault)
        small[d.type] = (ts_s, m_s, kept["rollout"])
    (ts_c, m_c, ro_c), (ts_h, m_h, ro_h) = small["cuda"], small["cpu"]
    fields = ("obs", "action", "sparse", "shaped", "events", "mask")
    sbc_int_err = max_err([getattr(ro_c, f).cpu() for f in fields],
                          [getattr(ro_h, f) for f in fields])
    sbc_reward_err = float((ro_c.reward.cpu() - ro_h.reward).abs().max())
    losses = [(getattr(m_c, f).item(), getattr(m_h, f).item())
              for f in ("policy_loss", "vf_loss", "kl", "entropy")]
    sbc_loss_ok = all(abs(a - b) <= 1e-6 + 1e-4 * abs(b) for a, b in losses)
    sbc_param_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        ts_c.net.state_dict().values(), ts_h.net.state_dict().values()))
    log(f"[14d card vs CPU] {time.perf_counter() - t0:.2f}s PPO_BC + phi train_iteration "
        f"32x50, 2 epochs: rollout integers and mask max_abs_err={sbc_int_err}, rewards "
        f"max_abs_err {sbc_reward_err:.3g}, losses max_abs_err "
        f"{max(abs(a - b) for a, b in losses):.3g}, params max_abs_err {sbc_param_err:.3g}; "
        f"bc_sample_fraction {m_c.bc_sample_fraction.item():.3f}")
    if sbc_int_err or sbc_reward_err > 1e-3 or not sbc_loss_ok or sbc_param_err > 1e-5:
        raise SystemExit("the PPO_BC + phi learner on the card disagrees with the CPU learner")

    # the human-aware CLIs in process, tiny, on the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()) as out:
        (proxy_dir,) = train_bc_proxy.main(["--device", "cuda", "--layouts", "cramped_room",
                                            "--num-games", "2", "--horizon", "30", "--epochs",
                                            "2", "--out", tmp])
        run = os.path.join(tmp, "ppo_bc")
        train_ppo.main(["--device", "cuda", "--local-testing", "--iters", "1", "--out", run,
                        "--num-sgd-iter", "1", "--bc-model", proxy_dir, "--bc-schedule",
                        "0:0.5", "--use-phi", "--phi-event-mix"])
        with open(os.path.join(run, "metrics.jsonl")) as f:
            bc_rows = [json.loads(line) for line in f if '"kl"' in line]
        matrix_bc = eval_matrix.main(["--device", "cuda", "--layouts", "cramped_room",
                                      "--agents", f"bc:{proxy}", "greedy", "--games", "2",
                                      "--horizon", "30", "--out",
                                      os.path.join(tmp, "matrix.json")])
    log(f"[14e CLIs] {time.perf_counter() - t0:.2f}s train_bc_proxy (2 games x 30 steps, 2 "
        f"epochs) -> {os.path.basename(proxy_dir)}; train_ppo --bc-model --bc-schedule 0:0.5 "
        f"--use-phi --phi-event-mix: {len(bc_rows)} iteration row, bc_factor "
        f"{bc_rows[0]['bc_factor'] if bc_rows else None}; eval_matrix (30 steps) bc:{proxy} + "
        f"greedy: "
        f"{len(matrix_bc)} pairs; {len(out.getvalue().splitlines())} lines of their output")
    if len(bc_rows) != 1 or bc_rows[0]["bc_factor"] != 0.5 or len(matrix_bc) != 4:
        raise SystemExit("the human-aware CLIs did not train, clone or evaluate")
    log(f"[14 human-aware PPO] {time.perf_counter() - t14:.2f}s")

    # ---- 15. the recurrent learner: LSTMPPONet on the card against the CPU;
    # one make_ppo_lstm train_iteration at full width (B1) and one on the
    # 64-layout pool (B3); a small one on the card against the CPU learner;
    # make_ppo_lstm_eval; the --use-lstm CLIs and an LSTM agent in process
    t15 = time.perf_counter()
    t0 = time.perf_counter()
    lstm = LSTMPPONet(NetConfig(), spec.height, spec.width,
                      generator=torch.Generator().manual_seed(15))
    lstm_cpu = LSTMPPONet(NetConfig(), spec.height, spec.width)
    lstm_cpu.load_state_dict(lstm.state_dict())
    lstm = lstm.to(dev)
    seq = lstm_obs  # phase 5's cramped_room rollout, 2048 envs: (4096, 20, H, W, 26)
    carry_gen = torch.Generator().manual_seed(16)
    carry0 = (torch.randn((seq.shape[0], 256), generator=carry_gen),
              torch.tanh(torch.randn((seq.shape[0], 256), generator=carry_gen)))
    with torch.no_grad():
        out_card = lstm(seq, tuple(x.to(dev) for x in carry0))
        out_cpu = lstm_cpu(seq.cpu(), carry0)
    net_errs = {}
    for name, a, b in zip(("logits", "value", "c", "h"), (out_card[0], out_card[1], *out_card[2]),
                          (out_cpu[0], out_cpu[1], *out_cpu[2])):
        net_errs[name] = (float((a.cpu() - b).abs().max()), float(b.abs().max()))
    net_ok = all(err <= 1e-5 * max(1.0, big) for err, big in net_errs.values())
    log(f"[15a LSTMPPONet] {time.perf_counter() - t0:.2f}s NetConfig() (cell 256), "
        f"{seq.shape[0]} sequences x {MAX_SEQ_LEN} steps of phase 5's obs from a nonzero "
        f"carry, card vs CPU max_abs_err (largest |value|), within 1e-5 of the largest: "
        + json.dumps({k: [float(f"{e:.3g}"), round(m, 3)] for k, (e, m) in net_errs.items()}))
    if not net_ok:
        raise SystemExit("LSTMPPONet on the card disagrees with the CPU")

    # one full-width iteration (2048 x 400, minibatch 32768 env steps: 25
    # minibatches of 3276 chunks x 8 epochs), split by CUDA events with no host
    # sync after the rollout; no warm-up of its own (phase 12 warmed the torso)
    t0 = time.perf_counter()
    cfg_l = PPOConfig(num_envs=2048, sgd_minibatch_size=32768)
    init_l, train_l = make_ppo_lstm(spec, cfg_l, device=dev)
    ts_l = init_l(0)
    reset_counts()
    (ts_l, m_l), t_l = synced(lambda: timed_iteration(train_l, ts_l))
    l_counts = counts()
    b1_lstm_launches = l_counts[0]
    l_split = {"rollout": marks["start"].elapsed_time(marks["rollout"]),
               "gae_std": marks["rollout"].elapsed_time(marks["advantages"]),
               "sgd": marks["advantages"].elapsed_time(marks["end"])}
    l_metrics = {k: v.item() for k, v in m_l._asdict().items()}
    if l_counts != (cfg_l.horizon, 0, 0, 0) or not all(
            np.isfinite(v) for v in l_metrics.values()) or ts_l.env_steps.item() != 2048 * 400:
        raise SystemExit(f"the LSTM iteration: B1/B2/B3/B4 launches {l_counts}, metrics "
                         f"{l_metrics}")
    n_chunks = 2 * 2048 * 400 // MAX_SEQ_LEN
    mb_chunks = 2 * cfg_l.sgd_minibatch_size // MAX_SEQ_LEN
    log(f"[15b LSTM learner] {time.perf_counter() - t0:.2f}s make_ppo_lstm train_iteration "
        f"cramped_room 2048x400, {n_chunks // mb_chunks} minibatches of {mb_chunks} chunks "
        f"x {cfg_l.num_sgd_iter} epochs (first call): wall {t_l:.3f}s = "
        f"{2048 * 400 / t_l:.0f} env-steps/s on {smi}; split (events, no host sync after the "
        f"rollout) ms " + json.dumps({k: round(v, 1) for k, v in l_split.items()})
        + f"; B1/B2/B3/B4 launches={l_counts}; metrics "
        + json.dumps({k: round(v, 6) for k, v in l_metrics.items()}))

    # and on the device: a profiled iteration at the same widths, 20 steps and
    # 2 epochs of one minibatch of 3276 chunks (the timed iteration's shape,
    # the tail of 820 chunks dropped): 2 Adam steps
    t0 = time.perf_counter()
    init_lt, train_lt = make_ppo_lstm(spec, PPOConfig(num_envs=2048, horizon=MAX_SEQ_LEN,
                                                      num_sgd_iter=2, sgd_minibatch_size=32768),
                                      device=dev)
    ts_lt = init_lt(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_lt = synced(lambda: train_lt(ts_lt))
    by_kernel = sorted(((dev_time(e), e.count, e.key) for e in prof.key_averages()
                        if dev_time(e) > 0), reverse=True)
    busy_us = sum(us for us, _, _ in by_kernel)
    top = "; ".join(f"{k[:48]} x{n} {us / 1e3:.1f}ms" for us, n, k in by_kernel[:8])
    log(f"[15b LSTM trace] {time.perf_counter() - t0:.2f}s one iteration 2048x{MAX_SEQ_LEN}, 2 "
        f"Adam steps of {mb_chunks} chunks: wall {t_lt * 1e3:.1f}ms device busy "
        f"{busy_us / 1e3:.1f}ms (idle {1 - busy_us / 1e6 / t_lt:.1%}); top: {top}")

    t0 = time.perf_counter()
    init_lp, train_lp = make_ppo_lstm(
        specs64, PPOConfig(num_envs=2048, sgd_minibatch_size=32768, num_sgd_iter=1), device=dev)
    reset_counts()
    (_, m_lp), t_lp = synced(lambda: train_lp(init_lp(0)))
    lp_counts = counts()
    b3_lstm_launches = lp_counts[2]
    if lp_counts != (0, 0, 400, 0) or not all(np.isfinite(v.item()) for v in m_lp):
        raise SystemExit(f"the pool LSTM iteration launched B1/B2/B3/B4 {lp_counts} times or "
                         "its metrics are not finite")
    log(f"[15c pool LSTM learner] {time.perf_counter() - t0:.2f}s train_iteration 64-layout "
        f"pool 2048x400, 1 epoch: wall {t_lp:.3f}s = {2048 * 400 / t_lp:.0f} env-steps/s; "
        f"B1/B2/B3/B4 launches={lp_counts}; shaped={m_lp.episode_shaped_reward.item():.3f}")

    # a small iteration on the card and on the CPU from the same params, with
    # the same actions and chunk permutations: the rollout's integers bit for
    # bit, losses within rtol 1e-4 / atol 1e-6 and params within 1e-5, the
    # tolerances the CPU learner is held to against JAX
    t0 = time.perf_counter()
    cfg_sl = PPOConfig(num_envs=32, horizon=40, num_sgd_iter=2, sgd_minibatch_size=640)
    sl_acts = np.random.RandomState(18).choice(6, size=(40, 64), p=PROB)
    sl_perms = [np.random.RandomState(200 + e).permutation(2 * 32 * 40 // MAX_SEQ_LEN)
                for e in range(2)]
    small = {}
    for d in (dev, cpu):
        init_s, train_s = make_ppo_lstm(spec, cfg_sl, device=d)
        kept = {}
        ts_s, m_s = train_s(init_s(3),
                            sample_fn=lambda _lg, t, d=d: torch.from_numpy(sl_acts[t]).to(d),
                            perm_fn=lambda e, d=d: torch.from_numpy(sl_perms[e]).to(d),
                            on_phase=kept.setdefault)
        small[d.type] = (ts_s, m_s, kept["rollout"])
    (ts_c, m_c, ro_c), (ts_h, m_h, ro_h) = small["cuda"], small["cpu"]
    fields = ("obs", "action", "sparse", "shaped", "events")
    sl_int_err = max_err([getattr(ro_c, f).cpu() for f in fields],
                         [getattr(ro_h, f) for f in fields])
    losses = [(getattr(m_c, f).item(), getattr(m_h, f).item())
              for f in ("policy_loss", "vf_loss", "kl", "entropy", "episode_total_reward")]
    sl_loss_ok = all(abs(a - b) <= 1e-6 + 1e-4 * abs(b) for a, b in losses)
    sl_param_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        ts_c.net.state_dict().values(), ts_h.net.state_dict().values()))
    log(f"[15d card vs CPU] {time.perf_counter() - t0:.2f}s LSTM train_iteration 32x40, 2 "
        f"epochs of 2 minibatches of 64 chunks, same params, actions and permutations: rollout "
        f"integers max_abs_err={sl_int_err}, losses max_abs_err "
        f"{max(abs(a - b) for a, b in losses):.3g}, params max_abs_err {sl_param_err:.3g}; "
        f"shaped={m_c.episode_shaped_reward.item()}")
    if sl_int_err or not sl_loss_ok or sl_param_err > 1e-5:
        raise SystemExit("the LSTM learner on the card disagrees with the CPU learner")

    # the eval, 8 games x 400 (B1 at 8 envs), the carry through the episode
    t0 = time.perf_counter()
    eval_l = make_ppo_lstm_eval(spec, NetConfig(), num_games=8, horizon=400, device=dev)
    reset_counts()
    mean_l, t_eval_l = synced(lambda: eval_l(ts_l.net, gen))
    b1_eval_lstm = counts()[0]
    if b1_eval_lstm != 400 or not mean_l >= 0:
        raise SystemExit(f"make_ppo_lstm_eval launched B1 {b1_eval_lstm} times, mean {mean_l}")
    log(f"[15e LSTM eval] {time.perf_counter() - t0:.2f}s make_ppo_lstm_eval 8x400: "
        f"{t_eval_l:.3f}s mean_sparse={mean_l}, B1 launches={b1_eval_lstm}")

    # the --use-lstm CLIs in process, and the LSTM checkpoint as a ppo: agent
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()) as out:
        run = os.path.join(tmp, "lstm")
        cli = ["--device", "cuda", "--local-testing", "--use-lstm", "--num-sgd-iter", "1",
               "--out", run]
        train_ppo.main(cli + ["--iters", "1"])
        train_ppo.main(cli + ["--iters", "1", "--resume"])
        with open(os.path.join(run, "config.json")) as f:
            lstm_meta = json.load(f)
        pool_run = os.path.join(tmp, "lstm_pool")
        train_ppo_from_params.main(["--device", "cuda", "--local-testing", "--use-lstm",
                                    "--iters", "1", "--out", pool_run])
        with open(os.path.join(pool_run, "config.json")) as f:
            lstm_pool_meta = json.load(f)
        matrix_l = eval_matrix.main(["--device", "cuda", "--layouts", "cramped_room",
                                     "--agents", f"ppo:{run}", "greedy", "--games", "2",
                                     "--horizon", "50", "--out", os.path.join(tmp, "m.json")])
    log(f"[15f CLIs] {time.perf_counter() - t0:.2f}s train_ppo --use-lstm --local-testing 1 "
        f"iter then --resume 1: latest_step={lstm_meta['latest_step']}, use_lstm="
        f"{lstm_meta['use_lstm']}; train_ppo_from_params --use-lstm 1 iter: latest_step="
        f"{lstm_pool_meta['latest_step']}; eval_matrix ppo:<the LSTM run> + greedy (2 games x "
        f"50 steps): {len(matrix_l)} pairs; {len(out.getvalue().splitlines())} lines of their "
        f"output")
    if (lstm_meta["latest_step"], lstm_meta["use_lstm"], lstm_pool_meta["latest_step"],
            lstm_pool_meta["use_lstm"], len(matrix_l)) != (2, True, 1, True, 4):
        raise SystemExit("the --use-lstm CLIs did not train, resume, checkpoint or evaluate")
    log(f"[15 recurrent learner] {time.perf_counter() - t15:.2f}s")

    # ---- 16. the JAX package's trained agents on the card, and the
    # interactive edge: the converted agents (16a, computed while the parity
    # jobs ran), eval_artifact cells at 100 games (16b), the recurrent run in
    # self-play (16c), a demo game of 400 ticks against a trained NPC (16d)
    # and the demo server (16e)
    t16 = time.perf_counter()
    # within 1e-5 of the largest |logit|, phase 15a's tolerance for the
    # recurrent net: the torsos' float32 convolutions sum in another order on
    # the card (on an H100, 1.1e-6 of the largest at most for the PPONets,
    # 1.6e-6 for the recurrent run over two steps)
    rows16, secs16a = agents16
    worst = sorted(rows16, key=lambda r: -r[1] / max(1.0, r[2]))[:3]
    log(f"[16a converted agents] {secs16a:.2f}s (while the parity jobs ran) {len(rows16)} runs "
        f"of artifacts_torch/ loaded by build_agent on the card and on the CPU, logits on 256 "
        f"envs of B1's obs x 2 seats (the recurrent run: 2 steps from a zero carry), card vs "
        f"CPU within 1e-5 of the largest |logit|; the worst three, max_abs_err at the largest: "
        + "; ".join(f"{run} {e:.3g} at {big:.3g}" for run, e, big in worst))
    if len(rows16) != 21 or any(e > 1e-5 * max(1.0, big) for _, e, big in rows16):
        raise SystemExit("a converted agent's logits on the card disagree with the CPU's")

    # 16b: eval_artifact cells, 100 games x 400 each (B1 at 100 envs), each
    # held against the JAX table's mean by three combined standard errors
    t0 = time.perf_counter()
    G16 = 100
    cells16, cmp16, walls16 = {}, [], []
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        for old, layout16, cells in ((False, "cramped_room",
                                      ["PPO_SP+PPO_SP", "PPO_BC+BC", "greedy+PPO_SP"]),
                                     (True, "counter_circuit_o_1order", ["PPO_SP+PPO_SP"])):
            reset_counts()
            summary = eval_artifact.main(
                ["--device", "cuda", "--games", str(G16), "--layouts", layout16, "--cells",
                 *cells, "--out", os.path.join(tmp, "cells.json")] + (
                    ["--old-dynamics"] if old else []))
            if counts()[1:] != (0, 0, 0):
                raise SystemExit(f"eval_artifact launched B1/B2/B3/B4 {counts()} times")
            ref_name = ("eval_matrix_results_old_dynamics.json" if old
                        else "eval_matrix_results.json")
            with open(os.path.join(ROOT, ref_name)) as f:
                cmp16 += [(old, *row) for row in eval_artifact.compare(summary["results"],
                                                                      json.load(f))]
            for cell, res in summary["results"][layout16].items():
                cells16[f"{'old ' if old else ''}{layout16} {cell}"] = res
    cell_txt = "; ".join(
        f"{k}: {v['mean']:.2f} +- {v['std']:.2f} (JAX {want:.1f}, 3 se {3 * se:.2f}, "
        f"{'not gated' if ok is None else ('within' if ok else 'OUTSIDE')}), wall "
        f"{v['wall_s']:.3f}s, B1 launches {v['b1_launches']}"
        for (k, v), (_, _, _, _, want, se, ok) in zip(cells16.items(), cmp16))
    log(f"[16b eval_artifact] {time.perf_counter() - t0:.2f}s {G16} games x 400 a cell: "
        + cell_txt)
    if any(v["b1_launches"] != 400 or v["games"] != G16 for v in cells16.values()):
        raise SystemExit("an eval_artifact cell did not launch B1 400 times")
    if any(ok is False for *_, ok in cmp16):
        raise SystemExit("an eval_artifact cell on the card lies outside three combined "
                         "standard errors of the JAX table")

    # 16c: the converted recurrent run in self-play, 8 games x 400 (B1 at 8
    # envs), a generator seeded 16; its first 8 games' first 50 steps held
    # bit for bit against the CPU's with the card's draws (a parity job)
    t0 = time.perf_counter()
    pair16 = _pair("lstm", spec, dev)
    reset_counts()
    traj16, t_l16 = synced(lambda: run_agent_pair(
        spec, pair16, num_games=8, horizon=400, device=dev,
        draws=agents_mod.GeneratorDraws(torch.Generator(device=dev).manual_seed(16), 8)))
    l16_counts = counts()
    replay = jobs["16c LSTM agent cramped_room"]
    mean16 = float(traj16["sparse"].sum(axis=(0, 1)).mean())
    log(f"[16c LSTM agent] {time.perf_counter() - t0:.2f}s artifacts_torch/r4_lstm_cramped in "
        f"self-play 8x400: wall {t_l16:.3f}s, B1/B2/B3/B4 launches={l16_counts}, mean return "
        f"{mean16:.2f}; card vs CPU (8 games, 50 steps, the card's draws) "
        f"max_abs_err={replay['err']}")
    if l16_counts != (400, 0, 0, 0) or replay["err"] or not np.array_equal(
            traj16["actions"][:50], replay["actions"]):
        raise SystemExit("the recurrent agent on the card disagrees with the CPU or its run")

    # 16d: a demo game on cramped_room, a scripted human seat against the
    # committed PPO_BC agent, 400 ticks by tick(): the NPC's latency a tick
    # against the 1/6 s tick, B1 at one env a tick; the recorded rows replayed
    # through the env on the CPU
    t0 = time.perf_counter()
    npc = npc_from_kind("artifact:ppo_bc", "cramped_room", device=dev)
    game = DemoGame("cramped_room", npc_policies={1: npc}, game_time=None, device=dev)
    npc_ms, act = [], npc.act

    def timed_act(env, seat):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = act(env, seat)  # int(): waits for the card
        npc_ms.append((time.perf_counter() - t) * 1e3)
        return out

    npc.act = timed_act
    human = np.random.RandomState(17).choice(6, size=400, p=PROB)
    game.activate()
    tick_ms = []
    reset_counts()
    for a in human:
        game.enqueue_action(0, int(a))
        t = time.perf_counter()
        game.tick()
        tick_ms.append((time.perf_counter() - t) * 1e3)
    demo_counts = counts()
    rows = game.get_data()
    replay_env = OvercookedEnv.from_layout_name("cramped_room", 400, device="cpu")
    demo_err = 0
    for r in rows:
        demo_err += r["state"] != json.dumps(replay_env.state_dict())
        demo_err += replay_env.step(json.loads(r["joint_action"]))[1] != r["reward"]
    state = batch_reset(spec.layout, 1, dev)  # cramped_room, as the game's
    act1 = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    _, b1_one_ms = kernel_ms("train_step_kernel<false>", lambda: [
        fused_train.fused_train_step_tiles(spec.layout, state, act1, horizon=400,
                                           reset_horizon=401)
        for _ in range(50)])
    _, secs = synced(lambda: [fused_train.plain_train_step(lay_dev, state, act1, 400, 401)
                              for _ in range(10)])
    b1_one_plain_ms, b1_one_bound_ms = secs * 1e3 / 10, env_bytes / H100_BYTES_PER_S * 1e3
    p50, p99 = np.percentile(npc_ms, [50, 99])
    log(f"[16d demo game] {time.perf_counter() - t0:.2f}s cramped_room 400 ticks, artifact:ppo_bc "
        f"NPC: latency a tick p50 {p50:.3f} ms p99 {p99:.3f} ms (the tick at TICK_FPS 6: "
        f"{1e3 / 6:.1f} ms), whole tick p50 {np.percentile(tick_ms, 50):.3f} ms p99 "
        f"{np.percentile(tick_ms, 99):.3f} ms; B1/B2/B3/B4 launches={demo_counts}, B1 at 1 env "
        f"{b1_one_ms:.4f} ms/launch (profiler) plain {b1_one_plain_ms:.3f} ms bound "
        f"{b1_one_bound_ms:.7f} ms; score {game.score}, done {game.is_over()}; the {len(rows)} "
        f"rows replayed through the env on the CPU: {demo_err} differ")
    if demo_counts != (400, 0, 0, 0) or len(rows) != 400 or not game.is_over() or demo_err:
        raise SystemExit("the demo game on the card is malformed or disagrees with the CPU")

    # 16e: the port's server on an ephemeral port, its games on the card
    t0 = time.perf_counter()
    from overcooked_ai_tpu_torch.demo import server as demo_server
    import urllib.request

    httpd = demo_server.serve(port=0, device="cuda", host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body=None):
        req = urllib.request.Request(base + path, method="GET" if body is None else "POST",
                                     data=None if body is None else json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read()
        return raw.decode() if path == "/" else json.loads(raw)

    try:
        answers = []
        gid = call("/api/create", {"layout": "cramped_room", "npc": "artifact:ppo_bc",
                                   "game_time": 60})["game_id"]
        answers.append("create")
        answers += ["action"] if call("/api/action", {"game_id": gid, "seat": 0,
                                                      "action": 5})["ok"] else []
        deadline, st = time.time() + 30, call(f"/api/state?game_id={gid}")
        while st["state"]["timestep"] < 3 and time.time() < deadline:
            time.sleep(0.2)
            st = call(f"/api/state?game_id={gid}")
        answers += ["state"] if st["state"]["timestep"] >= 3 else []
        hid = call("/api/create", {"layout": "cramped_room", "npc": "human"})["game_id"]
        answers += ["join"] if call("/api/join", {"game_id": hid})["seat"] == 1 else []
        answers += ["leave"] if all(call("/api/leave", {"game_id": g})["ok"]
                                    for g in (gid, hid)) else []
        answers += ["index"] if "canvas" in call("/") else []
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"[16e demo server] {time.perf_counter() - t0:.2f}s on port {httpd.server_address[1]}, "
        f"games on the card: answered {answers}; the NPC game reached timestep "
        f"{st['state']['timestep']}")
    if answers != ["create", "action", "state", "join", "leave", "index"]:
        raise SystemExit("the demo server did not answer every request")
    log(f"[16 trained agents and the interactive edge] {time.perf_counter() - t16:.2f}s")

    # ---- 17. data parallelism (`make_ppo(mesh=...)` through
    # parallel/dryrun.py's ranks, started after the parity jobs) and
    # `core.env.rollout`
    t17 = time.perf_counter()
    # this process's references first: 17a's meshless iteration, then 17b's
    # one-process iteration of the same seed and shape (12b's for the pool)
    # and the drift of a mere reordering of its sums, the same iteration with
    # each minibatch's rows reversed. 17a's rank runs meanwhile (nothing is
    # timed here); 17b's ranks after, alone on the card
    init_m, train_m = make_ppo(spec, PPOConfig(**DP_ONE[0]["config"]), device=dev)
    kept = {}
    ts_m, _ = train_m(init_m(DP_ONE[0]["seed"]), on_phase=kept.setdefault)
    procs_a, wdir_a, go_a = ranks17["17a"]
    open(go_a, "w").close()
    init_f, train_f = make_ppo(spec, PPOConfig(**DP_CONFIG), device=dev)
    ts_f, _ = train_f(init_f(0))
    ts_r = init_f(0)
    n17, mb17 = 2 * DP_CONFIG["num_envs"] * 400, 2 * DP_CONFIG["sgd_minibatch_size"]

    def reversed_rows(perm):  # the generator's permutation, each minibatch reversed
        k = n17 // mb17 * mb17
        return torch.cat([perm[:k].view(-1, mb17).flip(1).reshape(-1), perm[k:]])

    ts_r, _ = train_f(ts_r, perm_fn=lambda _e: reversed_rows(
        torch.randperm(n17, generator=ts_r.generator, device=dev)))

    # 17a: the one-rank NCCL mesh against the meshless iteration: the
    # rollout's integers bit for bit, the params within 12c's 1e-5 (cuDNN's
    # weight gradient may sum in another order in another process)
    one = dryrun.wait(procs_a, wdir_a, DP_TIMEOUT)[0]["one_rank"]
    t_refs = time.perf_counter() - t17
    one_int_err = cpu_max_err([getattr(kept["rollout"], f) for f in dryrun.ROLLOUT_INTS],
                              [one["rollout"][f] for f in dryrun.ROLLOUT_INTS])
    one_param_err = max(float((one["params"][k] - v.cpu()).abs().max())
                        for k, v in ts_m.net.state_dict().items())
    log(f"[17a one-rank NCCL mesh] {t_refs:.2f}s with 17b's references "
        f"make_ppo(mesh=make_mesh()) 32x50, 2 epochs, in a rank process (NCCL, "
        f"{one['all_reduces']} all-reduces) against the meshless iteration of seed 3 here: "
        f"rollout integers max_abs_err={one_int_err}, params max_abs_err {one_param_err:.3g}; "
        f"B1/B2/B3/B4 launches={one['launches']}")
    if one_int_err or one_param_err > 1e-5 or one["launches"] != [50, 0, 0, 0]:
        raise SystemExit("the one-rank mesh disagrees with the meshless iteration")

    # 17b: two gloo ranks on the one card at phase 12's width, one epoch each
    # on cramped_room and on 12b's pool. The ranks sum in another order than
    # one process (their halves of each minibatch, the rollout's forward at
    # 2048 rows, the advantages' partial sums), so they are held within
    # DP_FLOOR times the reordering's drift, or 1e-5 if that is larger
    # (PERF.md §6: at this shape reversing the rows alone moved the
    # params by 1.62e-5, the ranks by 1.0e-5-2.4e-5)
    t0 = time.perf_counter()
    procs, wdir, go = ranks17["17b"]
    open(go, "w").close()
    two = dryrun.wait(procs, wdir, DP_TIMEOUT)
    t_ranks = time.perf_counter() - t0
    refs = {"fixed": {k: v.cpu() for k, v in ts_f.net.state_dict().items()}, "pool": pool_one}
    dp_err = {name: max(float((two[0][name]["params"][k] - v).abs().max())
                        for k, v in ref.items()) for name, ref in refs.items()}
    floor = max(float((v.cpu() - refs["fixed"][k]).abs().max())
                for k, v in ts_r.net.state_dict().items())
    dp_tol = max(1e-5, DP_FLOOR * floor)
    rank_diff = dryrun.disagreement(two)
    want_launches = {"fixed": [400, 0, 0, 0], "pool": [0, 0, 400, 0]}
    rank_txt = "; ".join(
        f"{name} rank {r} envs {res[name]['envs']}: wall {res[name]['wall_s']:.3f}s split ms "
        + json.dumps({k: round(v, 1) for k, v in res[name]["split_ms"].items()})
        + f" ({res[name]['all_reduces']} all-reduces), B1/B2/B3/B4 launches="
        f"{res[name]['launches']}, max memory {res[name]['max_memory_bytes'] / 2**30:.2f} GiB"
        for name in want_launches for r, res in enumerate(two))
    log(f"[17b two gloo ranks] {t_ranks:.2f}s after the go make_ppo(mesh=...) 2048x400, "
        f"minibatch 32768 env steps, 1 epoch, over gloo on one card (two ranks on one card "
        f"measure function, not scaling): {rank_txt}; flat gradient buffer "
        f"{two[0]['fixed']['grad_bytes']} bytes; ranks' params and kl_coeff max |diff| "
        f"{json.dumps(rank_diff)}; rank 0 against the one-process iteration (fixed here, pool "
        f"12b's) params max_abs_err "
        + json.dumps({k: float(f"{v:.3g}") for k, v in dp_err.items()})
        + f", the one-process iteration with its minibatches' rows reversed {floor:.3g} "
        f"(held within {dp_tol:.3g})")
    if any(v for v in rank_diff.values()) or any(v > dp_tol for v in dp_err.values()) or any(
            res[name]["launches"] != want for res in two for name, want in want_launches.items()):
        raise SystemExit("the data-parallel ranks disagree, or with the one-process iteration")

    # 17c: core.env.rollout under a seeded PPONet with Gumbel actions, 2048
    # envs x 400 steps (one B1 launch a step); a 64 x 120 run across an
    # auto-reset held against the CPU's replay (a parity job); and B1's
    # refusals of what it cannot step
    t0 = time.perf_counter()
    lay17, h_max = spec.layout, fused_train.max_horizon(spec.height * spec.width)
    net17 = PPONet(NetConfig(), spec.height, spec.width,
                   generator=torch.Generator().manual_seed(17)).to(dev)
    gen17 = torch.Generator(device=dev).manual_seed(17)
    reset_counts()
    with torch.no_grad():
        (final17, traj17), t_roll = synced(lambda: rollout(
            lay17, batch_reset(lay17, 2048, dev), gen17, 400, ppo_policy(net17, lay_dev, 400),
            400))
    roll_counts = counts()
    refused = 0
    for bad_spec, bad_horizon in ((spec, h_max + 1),
                                  (from_layout_name("cramped_room_single"), 400)):
        try:
            rollout(bad_spec.layout, batch_reset(bad_spec.layout, 8, dev), gen17, 1,
                    lambda *_: None, bad_horizon)
        except ValueError:
            refused += 1
    job17 = jobs["17c env.rollout cramped_room"]
    ok17 = (roll_counts == (400, 0, 0, 0) and traj17.state.obj.shape[0] == 400
            and bool(traj17.done[-1].all()) and not bool(traj17.done[:-1].any())
            and int(final17.t.max()) == 0 and int(traj17.events.sum()) > 0 and refused == 2
            and job17["launches"] == 120 and job17["resets"] == 64)
    log(f"[17c env.rollout] {time.perf_counter() - t0:.2f}s cramped_room 2048x400 under a "
        f"seeded PPONet: wall {t_roll:.3f}s = {2048 * 400 / t_roll:.0f} env-steps/s, "
        f"B1/B2/B3/B4 launches={roll_counts}, events {int(traj17.events.sum())}, sparse "
        f"{int(traj17.sparse_reward.sum())}; 64x120 at horizon 100 (an auto-reset) card vs "
        f"CPU replay of its actions ({job17['secs']:.2f}s, a parity job, B1 "
        f"{job17['launches']} launches, {job17['resets']} resets) every Timestep leaf "
        f"max_abs_err={job17['err']}; refused a horizon past {h_max} and "
        f"1 player: {refused}/2")
    if not ok17 or job17["err"]:
        raise SystemExit("core.env.rollout on the card is malformed or disagrees with the CPU")
    # the ranks closed meanwhile: each must have ended cleanly
    codes17 = {phase: dryrun.stop(procs, grace=60) for phase, (procs, _, _) in ranks17.items()}
    if any(c for codes in codes17.values() for c in codes):
        raise SystemExit(f"a rank of phase 17 ended with a failure: exit codes {codes17}")
    log(f"[17 data parallelism and env.rollout] {time.perf_counter() - t17:.2f}s")

    table = {"kernels": [
        {"name": "fused_train_step (B1)", "route": "cuda",
         "source": "overcooked_ai_tpu_torch/csrc/fused_train.cu",
         "replaces": "overcooked_ai_tpu/ops/fused_train.py:83", "launches": b1_iter_launches,
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain_ms,
         "bound_ms": b1_bound_ms, "bound_by": "bytes", "library_ms": None,
         "collect_launches": b1_collect, "eval_launches": b1_launches - b1_collect,
         "agent_pair_launches": pair_launches, "agent_pair_ms": b1_time[1024][0],
         "agent_pair_plain_ms": b1_time[1024][1], "agent_pair_bound_ms": b1_time[1024][2],
         "train_rollout_random_launches": trr_launches,
         "ppo_bc_phi_launches": b1_bc_launches, "bc_eval_launches": b1_eval_bc,
         "lstm_launches": b1_lstm_launches, "lstm_eval_launches": b1_eval_lstm,
         "dp_rank_launches": two[0]["fixed"]["launches"][0],
         "env_rollout_launches": roll_counts[0], "cert_launches": cert_launches[0],
         "eval_artifact_launches": 400, "single_env_launches": demo_counts[0],
         "single_env_ms": b1_one_ms, "single_env_plain_ms": b1_one_plain_ms,
         "single_env_bound_ms": b1_one_bound_ms,
         "eval_ms": b1_time[8][0],
         "eval_plain_ms": b1_time[8][1], "eval_bound_ms": b1_time[8][2],
         "tile_envs": fused_train.TILE_ENVS, "block_threads": fused_train.BLOCK_THREADS,
         "tile_sweep_ms": sweep},
        {"name": "fused_rollout (B2)", "route": "cuda",
         "source": "overcooked_ai_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "overcooked_ai_tpu/ops/fused_rollout.py:693", "launches": b2_launches,
         "max_abs_err": b2_err, "ms": b2_ms, "plain_ms": t_plain * 1e3,
         "bound_ms": b2_bound_ms, "bound_by": "operations", "library_ms": None,
         "cert_launches": cert_launches[1], "steps": T_CMP, "main_steps": T,
         "main_ms": b2_main_ms,
         "main_bound_ms": b2_main_bound_ms, "old_count_bound_ms": b2_old_bounds[T_CMP],
         "old_count_main_bound_ms": b2_old_bounds[T], "threads": fused_rollout.ROLLOUT_THREADS,
         "threads_sweep_ms": {k: v for k, v in rollout_sweep.items() if k.startswith("B2")},
         "registers_spills": {k: v for k, v in rollout_regs.items() if ",0," in k}},
        {"name": "fused_pool_train_step (B3)", "route": "cuda",
         "source": "overcooked_ai_tpu_torch/csrc/fused_pool_train.cu",
         "replaces": "overcooked_ai_tpu/ops/fused_pool.py:513", "launches": b3_iter_launches,
         "max_abs_err": b3_err, "ms": b3_ms, "plain_ms": b3_plain_ms,
         "bound_ms": b3_bound_ms, "bound_by": "bytes", "library_ms": None,
         "collect_launches": b3_launches, "ppo_bc_phi_launches": b3_bc_launches,
         "lstm_launches": b3_lstm_launches, "dp_rank_launches": two[0]["pool"]["launches"][2]},
        {"name": "fused_pool_rollout (B4)", "route": "cuda",
         "source": "overcooked_ai_tpu_torch/csrc/fused_pool_rollout.cu",
         "replaces": "overcooked_ai_tpu/ops/fused_pool.py:286", "launches": b4_launches,
         "max_abs_err": b4_err, "ms": b4_cmp_ms, "plain_ms": b4_plain_s * 1e3,
         "bound_ms": b4_bound_ms, "bound_by": "operations", "library_ms": None,
         "steps": T_CMP, "main_steps": T, "main_ms": b4_main_ms,
         "main_bound_ms": b4_main_bound_ms, "old_count_bound_ms": b4_old_bounds[T_CMP],
         "old_count_main_bound_ms": b4_old_bounds[T], "threads": fused_rollout.ROLLOUT_THREADS,
         "threads_sweep_ms": {k: v for k, v in rollout_sweep.items() if k.startswith("B4")},
         "registers_spills": {k: v for k, v in rollout_regs.items() if ",1," in k},
         "entry_outside_ms": b4_outside_ms},
    ]}
    log(f"[done] profiler sessions made again for want of a record: {len(redone)} "
        f"{sorted(set(redone))}")
    log(f"[wall] {time.perf_counter() - t_start:.1f}s")
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
