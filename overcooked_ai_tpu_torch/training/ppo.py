"""PPO self-play on the card (port of `overcooked_ai_tpu.training.ppo`).

`collect_rollout` mirrors the JAX learner's fused rollout (`rollout_fused`)
for one fixed layout: the initial obs comes from the plain encoding, then
each of the T steps runs the policy net, samples the joint action and takes
one fused env step (`ops/fused_train.py`, the B1 kernel on a CUDA tensor)
with `reset_horizon = T + 1`, so the rollout is exactly one episode from
the start state and never auto-resets. It returns what GAE needs.

Given a list of specs it runs in pool mode, the JAX learner's variable-MDP
mode: each env lane draws a layout of the pool (`pool_idx`), starts from
that layout's start state, and every step is one launch of the pool kernel
(`ops/fused_pool.py`, B3) on the lanes' packed layouts. The pool's layouts
share grid shape and player count; their recipe tables, shaping rewards
and old-dynamics flags may differ, lane by lane.

`make_ppo` is the JAX `make_ppo`: one `train_iteration` anneals the
shaping and entropy coefficients by env steps, collects one rollout, runs
GAE (terminal at the horizon, no bootstrap), standardises the advantages,
and takes `num_sgd_iter` epochs of minibatch SGD on the clipped-surrogate
loss with value clipping and a KL(old || new) penalty, each step clipped by
the global gradient norm (optax's rule) and taken by Adam; then it updates
the adaptive KL coefficient from the last minibatch's KL. GAE, the loss
and Adam are plain PyTorch, as they are plain XLA in the JAX learner.

Human-aware PPO, as in the JAX learner. With a BC partner (`bc_policy`,
`training/bc.bc_policy_batch`, and a nonzero `bc_schedule`) each lane flips
a coin per episode with p = the scheduled bc_factor, and on heads one seat,
drawn uniformly, is the partner's (`bc_seat_mask`): the partner's actions
replace the policy's there, and those samples are masked out of the PPO
loss (`Rollout.mask`). With `use_phi` (and a `potential_fn`,
`core/potential.make_potential_fn`) the dense reward is phi(s') - phi(s)
for both players, plus the event shaping under `phi_event_mix`; phi(s') is
taken on the post-step state, which never resets within the rollout. In
pool mode the partner and phi read each lane's layout and tables.

`make_ppo_eval` is the JAX `make_ppo_eval`: the mean sparse return of
`num_games` self-play games (seat 1 the BC partner's, given one), with its
env step on B1 too.

Actions are sampled by the Gumbel-max trick and minibatches permuted from
an explicit `torch.Generator`; JAX's draws differ, so the tests feed both
sides the same actions through `sample_fn`, the same lanes through
`pool_idx`, the same permutations through `perm_fn`, the same BC seats
through `bc_draws` and the same partner actions through `bc_sample_fn`.

Data parallelism (`make_ppo(mesh=...)`, `parallel/mesh.py`; the JAX
learner's `shard_map` over its fused step): each of the mesh's n ranks
steps envs [rank * B/n, (rank + 1) * B/n) with its own B1 or B3 launches,
and every random tensor is drawn at its global shape from the same
generator stream on every rank, each rank taking its own rows. So the
sharded iteration is the one-process iteration: each epoch permutes all
2 * B * T samples, a minibatch is a slice of that permutation, each rank
sums the loss over its members of it divided by the minibatch's global
mask count, and the gradients are all-reduced before the global-norm clip
and Adam; the advantage standardisation, the last minibatch's loss terms
(and so the KL update) and the metrics are global sums.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS, encode_nhwc
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import Layout, layout_on
from overcooked_ai_tpu_torch.core.layout_generator import gather_lanes, stack_layouts
from overcooked_ai_tpu_torch.ops.fused_pool import (
    check_pool_shape,
    fused_pool_train_step_tiles,
    pool_data,
)
from overcooked_ai_tpu_torch.ops.fused_train import fused_train_step_tiles, obs_tiles_to_nhwc
from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Defaults = the JAX learner's (the reference production config).

    The JAX learner's `fused` / `fused_block_b` switches have no
    counterpart: on a CUDA tensor the env step is always the B1 kernel.
    """

    num_envs: int = 30  # train_batch_size / rollout length
    horizon: int = 400
    lr: float = 5e-5
    grad_clip: float = 0.1
    gamma: float = 0.99
    lmbda: float = 0.98
    vf_loss_coeff: float = 1e-4
    vf_clip_param: float = 10.0
    entropy_coeff_start: float = 0.2
    entropy_coeff_end: float = 0.1
    entropy_coeff_horizon: float = 3e5
    kl_coeff: float = 0.2
    kl_target: float = 0.01
    clip_param: float = 0.05
    num_sgd_iter: int = 8
    sgd_minibatch_size: int = 2000  # in env steps (x2 agents = samples)
    reward_shaping_factor: float = 1.0
    reward_shaping_horizon: float = float("inf")
    use_phi: bool = False
    phi_event_mix: bool = False
    bc_schedule: tuple = ((0, 0.0), (float("inf"), 0.0))
    net: NetConfig = NetConfig()

    @property
    def train_batch_size(self):
        return self.num_envs * self.horizon


class Rollout(NamedTuple):
    """One rollout of T steps over B envs; samples are player-major (P * B).
    With a mesh, B is the rank's envs, and `bc_seats` covers all of them."""

    obs: torch.Tensor  # (T, P*B, H, W, 26) int8, the obs each action saw
    action: torch.Tensor  # (T, P*B) int64
    logp: torch.Tensor  # (T, P*B) float32
    value: torch.Tensor  # (T, P*B) float32
    sparse: torch.Tensor  # (T, P, B) int32 per-player sparse reward
    shaped: torch.Tensor  # (T, P, B) int32 per-player shaped reward
    events: torch.Tensor  # (T, P, B) int32 event bitmasks
    pool_idx: Optional[torch.Tensor] = None  # (B,) int64 pool entry of each lane, pool mode
    logits: Optional[torch.Tensor] = None  # (T, P*B, A) float32, for KL(old || new)
    # (T, P*B) float32: the summed sparse reward + shaping_factor x the
    # player's shaped reward
    reward: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None  # (T, P*B) float32, 1 for a sample PPO trains on
    bc_seats: Optional[torch.Tensor] = None  # (P, B) bool the BC partner's seats, given one


class Shard(NamedTuple):
    """A rank's envs [lo, hi) of a mesh's `num_envs`, and how it reads a
    draw over all of them."""

    lo: int
    hi: int
    num_envs: int

    def lanes(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's part of the last (env) axis."""
        return x[..., self.lo:self.hi]

    def rows(self, x: torch.Tensor, env_major: bool = False) -> torch.Tensor:
        """The rank's rows of a (P * B, ...) player-major tensor (the
        policy's), or of a (B * P, ...) env-major one (the BC partner's)."""
        if env_major:
            return x.unflatten(0, (self.num_envs, -1))[self.lo:self.hi].flatten(0, 1)
        return x.unflatten(0, (-1, self.num_envs))[:, self.lo:self.hi].flatten(0, 1)


def mesh_shard(mesh, num_envs: int) -> Shard:
    """The envs of `mesh`'s rank: the rank-th of its size's equal parts."""
    if num_envs % mesh.size:
        raise ValueError(f"num_envs {num_envs} does not divide over the mesh's {mesh.size} "
                         "ranks: each rank steps an equal shard with its kernel")
    k = num_envs // mesh.size
    return Shard(mesh.rank * k, (mesh.rank + 1) * k, num_envs)


def gumbel_sample(logits: torch.Tensor, generator: Optional[torch.Generator],
                  shard: Optional[Shard] = None, env_major: bool = False) -> torch.Tensor:
    """One categorical draw per row of `logits` (Gumbel-max). With a
    `shard`, `logits` are a rank's rows (`Shard.rows`): the uniform noise is
    drawn for every env's rows and the rank takes its own, so that it draws
    what the one-process run draws."""
    if shard is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
    else:
        n = logits.shape[0] // (shard.hi - shard.lo) * shard.num_envs
        u = shard.rows(torch.rand((n, logits.shape[1]), generator=generator,
                                  device=logits.device), env_major)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


SampleFn = Callable[[torch.Tensor, int], torch.Tensor]  # (logits, step) -> (N,) actions


def bc_seat_mask(bc_factor, num_players: int, batch: int,
                 generator: Optional[torch.Generator] = None, draws=None) -> torch.Tensor:
    """Per-episode BC-partner seats, (P, B) bool with at most one True a
    column: each lane flips a coin (p = bc_factor) for whether one seat,
    chosen uniformly, is the partner's (reference _populate_agents).
    draws: (u (B,) uniform in [0, 1), seat (B,) int) replacing the
    generator's draws (JAX's `uniform(k_bc)` and `randint(k_seat)`)."""
    if draws is None:
        dev = generator.device if generator is not None else "cpu"
        draws = (torch.rand((batch,), generator=generator, device=dev),
                 torch.randint(num_players, (batch,), generator=generator, device=dev))
    u, seat = draws
    seats = torch.arange(num_players, device=seat.device)[:, None]
    return (seats == seat[None]) & (u < bc_factor)[None]


def _sampler(sample_fn, t: int, generator, shard=None, env_major=False):
    """The (N, A) logits -> (N,) actions of step t: the hook's, else Gumbel-max."""
    if sample_fn is not None:
        return lambda logits: sample_fn(logits, t)
    return lambda logits: gumbel_sample(logits, generator, shard, env_major)


@torch.no_grad()
def collect_rollout(spec, net, config: PPOConfig,
                    generator: Optional[torch.Generator] = None, device="cuda",
                    sample_fn: Optional[SampleFn] = None, pool: Optional[Layout] = None,
                    pool_idx: Optional[torch.Tensor] = None,
                    shaping_factor=1.0, potential_fn=None, bc_policy=None, bc_factor=0.0,
                    bc_draws=None, bc_sample_fn: Optional[SampleFn] = None,
                    mesh=None) -> Rollout:
    """Self-play one episode of `config.horizon` steps in `config.num_envs`
    envs under `net`: a `PPONet`, or any callable (N, H, W, 26) obs ->
    (logits, value) with the net's `cfg` (the recurrent learner's, which
    threads its carry).

    shaping_factor: a float or a 0-d float32 tensor, the weight of the
    dense reward in `Rollout.reward`: the event shaping, or with
    `config.use_phi` phi(s') - phi(s) from `potential_fn(layout, state)`
    (pool mode: `potential_fn(pool_idx, lane_layouts, state)`), plus the
    event shaping under `config.phi_event_mix`.

    bc_policy: the BC partner, `bc_policy(sample, layout, state)` -> (P, B)
    actions of every seat (pool mode: `(sample, lane_layouts, state,
    pool_idx)`); the seats of `bc_seat_mask(bc_factor, ...)` take its
    actions, from `bc_draws` if given. `bc_sample_fn(logits, t)` replaces
    its draws as `sample_fn` replaces the policy's.

    spec: one LayoutSpec, or a list of them for pool mode. In pool mode
    `pool` may replace the stacked specs with a regenerated pool of the same
    leaf shapes, and `pool_idx` (B,) gives each lane's pool entry; by
    default it is drawn uniformly from `generator`.

    mesh: a `parallel.mesh.Mesh`; the rollout steps the rank's envs only
    (`mesh_shard`), and the Rollout holds them (its `pool_idx` their
    lanes'). `pool_idx`, `bc_draws` and the generator's draws stay global
    ((B,) for all B envs), and the rank takes its part; `sample_fn` and
    `bc_sample_fn` get the rank's rows of the logits (`Shard.rows`).
    """
    pool_mode = isinstance(spec, (list, tuple))
    if pool_mode:
        specs = list(spec)
        spec = check_pool_shape(specs)
    P, B, T = spec.num_players, config.num_envs, config.horizon
    if P != 2:
        raise ValueError("PPO self-play is 2-player")
    B_all, shard = B, None
    if mesh is not None:
        shard = mesh_shard(mesh, B_all)
        B = shard.hi - shard.lo
    H, W = spec.height, spec.width
    sample = sample_fn or (lambda logits, t: gumbel_sample(logits, generator, shard))
    if config.use_phi and potential_fn is None:
        raise ValueError("use_phi requires a potential_fn")

    if pool_mode:
        src = stack_layouts(specs) if pool is None else pool
        if src.terrain.shape[-1] != len(specs):
            raise ValueError(f"a pool of {src.terrain.shape[-1]} layouts for {len(specs)} specs")
        if pool_idx is None:
            pool_idx = torch.randint(len(specs), (B_all,), generator=generator, device=device)
        pool_idx = torch.as_tensor(pool_idx, device=device).long()
        if shard is not None:
            pool_idx = shard.lanes(pool_idx)
        layout = gather_lanes(layout_on(src, device), pool_idx)
        lanes = pool_data(spec, layout, device)  # checks the lanes, packs them once

        def env_step(state, act):
            return fused_pool_train_step_tiles(spec, lanes, state, act, horizon=T,
                                               reset_horizon=T + 1)

        def phi(state):
            return potential_fn(pool_idx, layout, state)

        def partner(sample, state):
            return bc_policy(sample, layout, state, pool_idx)
    else:
        if pool is not None or pool_idx is not None:
            raise ValueError("pool and pool_idx belong to pool mode: pass a list of specs")
        layout = spec.layout
        on_layout = layout_on(layout, device)  # the partner's and phi's reads, copied once

        def env_step(state, act):
            return fused_train_step_tiles(layout, state, act, horizon=T, reset_horizon=T + 1)

        def phi(state):
            return potential_fn(on_layout, state)

        def partner(sample, state):
            return bc_policy(sample, on_layout, state)

    bc_seats = None
    if bc_policy is not None:
        bc_seats = bc_mask = bc_seat_mask(bc_factor, P, B_all, generator, bc_draws)
        if shard is not None:
            bc_mask = shard.lanes(bc_seats)
    state = batch_reset(layout, B, device)
    phi_s = phi(state) if config.use_phi else None
    obs = torch.empty((T, P * B, H, W, NUM_LAYERS), dtype=torch.int8, device=device)
    obs[0] = encode_nhwc(layout, state, T)
    action = torch.empty((T, P * B), dtype=torch.int64, device=device)
    logp = torch.empty((T, P * B), dtype=torch.float32, device=device)
    value, reward = torch.empty_like(logp), torch.empty_like(logp)
    logits_all = torch.empty((T, P * B, net.cfg.num_actions), dtype=torch.float32,
                             device=device)
    sparse, shaped, events = (
        torch.empty((T, P, B), dtype=torch.int32, device=device) for _ in range(3)
    )
    for t in range(T):
        logits_all[t], value[t] = net(obs[t])
        logits = logits_all[t]
        action[t] = sample(logits, t)
        logp[t] = F.log_softmax(logits, -1).gather(1, action[t][:, None])[:, 0]
        act = action[t].to(torch.int32).reshape(P, B)
        if bc_policy is not None:  # the partner acts for every seat; its seats take it
            act = torch.where(bc_mask, partner(
                _sampler(bc_sample_fn, t, generator, shard, env_major=True), state), act)
        state, obs_t, sparse[t], shaped[t], events[t] = env_step(state, act)
        dense = shaped[t].float()
        if config.use_phi:  # phi(s') of the post-step state (nothing resets)
            phi_sp = phi(state)
            delta = (phi_sp - phi_s)[None].expand(P, B)
            dense = delta + dense if config.phi_event_mix else delta
            phi_s = phi_sp
        reward[t] = (sparse[t].sum(0, dtype=torch.int32)[None].float()
                     + shaping_factor * dense).reshape(P * B)
        if t + 1 < T:  # (P, 26, HW, B) -> (P, B, H, W, 26)
            obs[t + 1].view(P, B, H, W, NUM_LAYERS).copy_(
                obs_t.view(P, NUM_LAYERS, H, W, B).permute(0, 4, 2, 3, 1)
            )
    mask = torch.ones_like(logp)
    if bc_policy is not None:  # the partner's samples are not trained on
        mask[:] = (~bc_mask).reshape(P * B).float()
    return Rollout(obs, action, logp, value, sparse, shaped, events, pool_idx, logits_all,
                   reward, mask, bc_seats)


def make_ppo_eval(spec, num_games: int = 8, horizon: int = 400, device="cuda",
                  bc_policy=None):
    """Evaluation of a policy by self-play, free of reward shaping; with
    `bc_policy` (as in `collect_rollout`), seat 1 is the BC partner's in
    every game.

    Returns evaluate(net, generator=None, sample_fn=None, bc_sample_fn=None)
    -> mean sparse return per game (a Python float).
    """
    layout = spec.layout
    on_layout = layout_on(layout, device)
    P, B = spec.num_players, num_games

    @torch.no_grad()
    def evaluate(net: PPONet, generator: Optional[torch.Generator] = None,
                 sample_fn: Optional[SampleFn] = None,
                 bc_sample_fn: Optional[SampleFn] = None) -> float:
        sample = sample_fn or (lambda logits, t: gumbel_sample(logits, generator))
        state = batch_reset(layout, B, device)
        obs = encode_nhwc(layout, state, horizon)
        total = torch.zeros((), dtype=torch.int64, device=device)
        for t in range(horizon):
            logits, _ = net(obs)
            act = sample(logits, t).to(torch.int32).reshape(P, B)
            if bc_policy is not None:
                act[1] = bc_policy(_sampler(bc_sample_fn, t, generator), on_layout, state)[1]
            state, obs_t, sparse, _, _ = fused_train_step_tiles(
                layout, state, act, horizon=horizon, reset_horizon=horizon + 1
            )
            obs = obs_tiles_to_nhwc(layout, obs_t)
            total += sparse.sum()
        return total.item() / B

    return evaluate


class TrainState(NamedTuple):
    """The learner's state. `train_iteration` updates the net, the optimiser
    and the generator in place and returns the state with its new counters."""

    net: PPONet
    opt: torch.optim.Adam
    generator: torch.Generator  # on the device: actions, pool lanes, permutations
    env_steps: torch.Tensor  # () float32 total env steps sampled
    kl_coeff: torch.Tensor  # () float32 adaptive KL coefficient


class IterMetrics(NamedTuple):
    """The JAX `IterMetrics`, field for field, as 0-d float32 tensors."""

    episode_sparse_reward: torch.Tensor  # mean per-episode summed sparse reward
    episode_shaped_reward: torch.Tensor  # mean per-episode summed shaped reward
    # mean per-episode mixed reward summed over both agents (rllib's
    # episode_reward_mean, the metric of the reference's CI thresholds)
    episode_total_reward: torch.Tensor
    policy_loss: torch.Tensor
    vf_loss: torch.Tensor
    kl: torch.Tensor
    entropy: torch.Tensor
    kl_coeff: torch.Tensor
    reward_shaping_factor: torch.Tensor
    entropy_coeff: torch.Tensor
    bc_factor: torch.Tensor  # scheduled BC-partner probability this iteration
    bc_sample_fraction: torch.Tensor  # fraction of samples masked out as BC


def _anneal(start_v, curr_t, end_t, end_v=0.0, start_t=0.0):
    """Linear anneal from start_v at start_t to end_v at end_t, in float32
    (reference OvercookedMultiAgent._anneal)."""
    curr_t = torch.as_tensor(curr_t, dtype=torch.float32)
    if end_t == 0 or end_t == float("inf"):
        return torch.full((), start_v, dtype=torch.float32, device=curr_t.device)
    frac = torch.clamp(1.0 - (curr_t - start_t) / (end_t - start_t), min=0.0)
    return frac * start_v + (1.0 - frac) * end_v


def _bc_factor_at(schedule, t):
    """Piecewise-linear bc_factor of a ((t, value), ...) schedule, in float32
    (reference anneal_bc_factor)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    factor = torch.full((), schedule[0][1], dtype=torch.float32, device=t.device)
    for (t0, v0), (t1, v1) in zip(schedule[:-1], schedule[1:]):
        if t1 == float("inf"):
            seg = torch.full((), v0, dtype=torch.float32, device=t.device)
        else:
            frac = torch.clamp((t - t0) / max(t1 - t0, 1e-9), 0.0, 1.0)
            seg = (1 - frac) * v0 + frac * v1
        factor = torch.where(t >= t0, seg, factor)
    return factor


def schedules(config: PPOConfig, env_steps):
    """The iteration's (shaping factor, entropy coefficient, bc_factor), each
    annealed by the env steps taken so far."""
    return (_anneal(config.reward_shaping_factor, env_steps, config.reward_shaping_horizon),
            _anneal(config.entropy_coeff_start, env_steps, config.entropy_coeff_horizon,
                    config.entropy_coeff_end),
            _bc_factor_at(config.bc_schedule, env_steps))


def gae(reward: torch.Tensor, value: torch.Tensor, gamma: float, lmbda: float):
    """GAE(lambda) over (T, N) with the episode terminal at the horizon (no
    bootstrap). Returns (advantages, value targets)."""
    adv = torch.empty_like(value)
    next_adv = next_value = torch.zeros_like(value[0])
    for t in range(value.shape[0] - 1, -1, -1):
        delta = reward[t] + gamma * next_value - value[t]
        next_adv = adv[t] = delta + gamma * lmbda * next_adv
        next_value = value[t]
    return adv, adv + value


def standardize(adv: torch.Tensor, mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Advantages standardised over the trained samples (population std);
    with a mesh, over every rank's (two all-reduces: the sums, then the
    squared deviations)."""
    sums = torch.stack([mask.sum(), (adv * mask).sum()])
    if mesh is not None:
        mesh.all_reduce(sums)
    m_sum = torch.clamp(sums[0], min=1.0)
    mean = sums[1] / m_sum
    sq = ((adv - mean).square() * mask).sum()[None]
    if mesh is not None:
        mesh.all_reduce(sq)
    std = torch.sqrt(sq[0] / m_sum)
    return (adv - mean) / (std + 1e-8)


def ppo_loss(logits, value, batch, kl_coeff, entropy_coeff, config: PPOConfig,
             mask_count=None):
    """The PPO loss of one minibatch from the net's (n, A) logits and (n,)
    values on it: clipped surrogate, KL(old || new) from the stored logits,
    entropy bonus, clipped value loss, all masked means. `batch` is
    (action, logp_old, logits_old, value_old, adv, vt, mask). `mask_count`
    replaces the means' divisor, the batch's mask sum (a rank's part of a
    minibatch divides by the whole minibatch's).
    Returns (total, (policy_loss, vf_loss, kl, entropy))."""
    action, logp_old, logits_old, value_old, adv, vt, mask = batch
    m_sum = torch.clamp(mask.sum() if mask_count is None else mask_count, min=1.0)

    def wmean(x):
        return (x * mask).sum() / m_sum

    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(1, action[:, None])[:, 0]
    ratio = torch.exp(logp - logp_old)
    surr = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - config.clip_param, 1 + config.clip_param) * adv
    )
    policy_loss = -wmean(surr)
    p_old = F.softmax(logits_old, -1)
    kl = wmean((p_old * (F.log_softmax(logits_old, -1) - logp_all)).sum(-1))
    entropy = -wmean((F.softmax(logits, -1) * logp_all).sum(-1))
    vf_loss1 = (value - vt).square()
    v_clipped = value_old + torch.clamp(value - value_old, -config.vf_clip_param,
                                        config.vf_clip_param)
    vf_loss2 = (v_clipped - vt).square()
    vf_loss = wmean(torch.maximum(vf_loss1, vf_loss2))
    total = (policy_loss + kl_coeff * kl + config.vf_loss_coeff * vf_loss
             - entropy_coeff * entropy)
    return total, (policy_loss, vf_loss, kl, entropy)


def loss_fn(net: PPONet, batch, kl_coeff, entropy_coeff, config: PPOConfig,
            mask_count=None):
    """`ppo_loss` of the feed-forward net on a minibatch (obs, action,
    logp_old, logits_old, value_old, adv, vt, mask)."""
    logits, value = net(batch[0])
    return ppo_loss(logits, value, batch[1:], kl_coeff, entropy_coeff, config, mask_count)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm`, in place and without a host sync: when
    the global norm g of `grads` reaches max_norm, each becomes
    (grad / g) * max_norm; below it they stay as they are. (torch's
    `clip_grad_norm_` scales by max_norm / (g + 1e-6), always.) Returns g."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = g_norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, g_norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return g_norm


def sgd_step(ts, total: torch.Tensor, params, config: PPOConfig) -> None:
    """One Adam step on `total`, its gradient clipped by the global norm."""
    ts.opt.zero_grad(set_to_none=True)
    total.backward()
    clip_by_global_norm_([p.grad for p in params], config.grad_clip)
    ts.opt.step()


def finish_iteration(ts, ro: Rollout, aux, config: PPOConfig, shaping_factor, entropy_coeff,
                     bc_factor, mesh=None):
    """The adaptive KL coefficient (rllib update_kl, from the last
    minibatch's KL) and the iteration's metrics: (ts with the new counters,
    IterMetrics). With a mesh, `aux` is the rank's part of the loss terms,
    and they and the rollout's sums are all-reduced in one buffer."""
    policy_loss, vf_loss, kl, entropy = (a.detach() for a in aux)
    sparse, shaped, total = ro.sparse.sum(), ro.shaped.sum(), ro.reward.sum()
    if mesh is None:
        bc_fraction = (1.0 - ro.mask).mean()
    else:
        sums = mesh.all_reduce(torch.stack([
            sparse.float(), shaped.float(), total, (1.0 - ro.mask).sum(), policy_loss, vf_loss,
            kl, entropy]))
        sparse, shaped, total, bc_fraction, policy_loss, vf_loss, kl, entropy = sums.unbind()
        bc_fraction = bc_fraction / (ro.mask.numel() * mesh.size)
    kl_coeff = torch.where(
        kl > 2.0 * config.kl_target, ts.kl_coeff * 1.5,
        torch.where(kl < 0.5 * config.kl_target, ts.kl_coeff * 0.5, ts.kl_coeff),
    )
    B = config.num_envs
    metrics = IterMetrics(
        episode_sparse_reward=sparse / B,
        episode_shaped_reward=shaped / B,
        episode_total_reward=total / B,
        policy_loss=policy_loss,
        vf_loss=vf_loss,
        kl=kl,
        entropy=entropy,
        kl_coeff=kl_coeff,
        reward_shaping_factor=shaping_factor,
        entropy_coeff=entropy_coeff,
        bc_factor=bc_factor,
        bc_sample_fraction=bc_fraction,
    )
    return ts._replace(env_steps=ts.env_steps + B * config.horizon, kl_coeff=kl_coeff), metrics


PhaseFn = Callable[[str, object], None]  # (phase, its output) after each phase


def _members(idx: torch.Tensor, shard: Shard, num_players: int):
    """For each minibatch (a row of `idx`, global sample indices of the
    time-major (T, P * B) rollout, whose sample s is env s % B's), the
    rank's members in the permutation's order, as indices of its own
    (T, P * B/n) samples. One host sync: their counts."""
    B, lo, hi = shard.num_envs, shard.lo, shard.hi
    mine = (idx % B >= lo) & (idx % B < hi)
    counts = mine.sum(1).tolist()
    first = torch.gather(idx, 1, torch.argsort((~mine).to(torch.int32), dim=1, stable=True))
    pb, n = num_players * B, hi - lo
    local = first // pb * (num_players * n) + first % pb // B * n + first % B - lo
    return [local[i, :c] for i, c in enumerate(counts)]


def _sharded_epoch(ts, params, data, idx, ro: Rollout, shard: Shard, entropy_coeff,
                   config: PPOConfig, mesh):
    """A rank's SGD epoch over the minibatches `idx` (n_minibatches,
    mb_size) of the global permutation: on each, the loss of its members
    over the minibatch's global mask count (which every rank computes from
    the global BC seats), the gradients all-reduced as one flat buffer, then
    the clip by their global norm and Adam, as one process takes them.
    Returns the rank's part of the last minibatch's loss terms."""
    P = ro.sparse.shape[1]
    pb = P * shard.num_envs
    seats = (torch.ones(pb, device=idx.device) if ro.bc_seats is None
             else (~ro.bc_seats).reshape(pb).float())
    counts = seats[idx % pb].sum(1)
    sizes = [p.numel() for p in params]
    for rows, count in zip(_members(idx, shard, P), counts):
        if rows.numel():
            total, aux = loss_fn(ts.net, tuple(d[rows] for d in data), ts.kl_coeff,
                                 entropy_coeff, config, count)
            ts.opt.zero_grad(set_to_none=True)
            total.backward()
            flat = torch.cat([p.grad.reshape(-1) for p in params])
        else:  # no member: no forward, but a part (zeros) in the all-reduce
            aux = torch.zeros(4, device=idx.device).unbind()
            flat = torch.zeros(sum(sizes), device=idx.device)
        mesh.all_reduce(flat)
        for p, g in zip(params, flat.split(sizes)):
            p.grad = g.view_as(p)
        clip_by_global_norm_([p.grad for p in params], config.grad_clip)
        ts.opt.step()
    return aux


def make_ppo(spec, config: PPOConfig, potential_fn=None, bc_policy=None, mesh=None,
             device="cuda"):
    """Build (init_fn, train_iteration) for a layout spec, or for a list of
    same-shape specs (pool mode: each iteration every lane draws a layout
    of the pool, the reference's num_mdp=inf).

    potential_fn: phi for `config.use_phi` (required then), and bc_policy
    the BC partner, used while `config.bc_schedule` is nonzero; their
    signatures are `collect_rollout`'s.

    init_fn(seed) -> TrainState: the net drawn from a CPU generator seeded
    `seed` (the same weights on every device), Adam (optax's `adam`: eps
    outside the square root), and a generator on `device` seeded `seed`.

    train_iteration(ts, pool=None, sample_fn=None, pool_idx=None,
    perm_fn=None, on_phase=None, bc_draws=None, bc_sample_fn=None) -> (ts,
    IterMetrics). `pool` (pool mode) is a regenerated pool of the same leaf
    shapes; phi's and the partner's tables belong to the pool `make_ppo` was
    given, so a regenerated pool with either raises. The hooks replace the
    generator's draws: `sample_fn` the actions, `pool_idx` the lanes,
    `bc_draws` the BC seats and `bc_sample_fn` the partner's actions (as in
    `collect_rollout`), `perm_fn(epoch)` the (n_samples,) permutation of an
    epoch. `on_phase(name, out)` is called after the "rollout" (the
    `Rollout`) and after the "advantages" ((advantages, value targets)).
    After the rollout (whose set-up copies do), nothing in an iteration
    waits for the card: GAE, the SGD loop and the KL update stay on the
    device.

    mesh: a `parallel.mesh.Mesh`, data parallelism over its ranks (see the
    module's docstring); its device replaces `device`, and each rank calls
    `train_iteration` on its own TrainState (`parallel.mesh.replicated`
    makes them equal). Its size must divide `config.num_envs`. The hooks
    keep their global meaning: `pool_idx`, `bc_draws` and `perm_fn`'s
    permutation cover all B envs and 2 * B * T samples, and `sample_fn` /
    `bc_sample_fn` get the rank's rows of the logits (`Shard.rows`). The
    rollout and the "rollout" phase hold the rank's envs; after the rollout
    each epoch waits for the card once (its members' counts).
    """
    if config.use_phi and potential_fn is None:
        raise ValueError("use_phi requires a potential_fn")
    pool_mode = isinstance(spec, (list, tuple))
    spec0 = check_pool_shape(list(spec)) if pool_mode else spec
    if spec0.num_players != 2:
        raise ValueError("PPO self-play is 2-player")
    B, T = config.num_envs, config.horizon
    if mesh is None:
        device, shard = torch.device(device), None
    else:
        if torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} for a mesh on {mesh.device}")
        device, shard = mesh.device, mesh_shard(mesh, B)
    n_samples = 2 * B * T
    mb_size = min(2 * config.sgd_minibatch_size, n_samples)
    n_minibatches = n_samples // mb_size  # the tail of each permutation is dropped
    if not any(v for _, v in config.bc_schedule):
        bc_policy = None  # the partner never plays

    def init_fn(seed: int) -> TrainState:
        net = PPONet(config.net, spec0.height, spec0.width,
                     generator=torch.Generator().manual_seed(seed)).to(device)
        opt = torch.optim.Adam(net.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(
            net, opt, torch.Generator(device=device).manual_seed(seed),
            torch.zeros((), dtype=torch.float32, device=device),
            torch.tensor(config.kl_coeff, dtype=torch.float32, device=device),
        )

    def train_iteration(ts: TrainState, pool: Optional[Layout] = None,
                        sample_fn: Optional[SampleFn] = None,
                        pool_idx: Optional[torch.Tensor] = None,
                        perm_fn: Optional[Callable[[int], torch.Tensor]] = None,
                        on_phase: Optional[PhaseFn] = None, bc_draws=None,
                        bc_sample_fn: Optional[SampleFn] = None):
        if pool is not None and (config.use_phi or bc_policy is not None):
            raise ValueError("a regenerated pool with use_phi or a BC partner: their per-lane "
                             "tables are built for the pool make_ppo was given")
        shaping_factor, entropy_coeff, bc_factor = schedules(config, ts.env_steps)
        ro = collect_rollout(spec, ts.net, config, ts.generator, device, sample_fn, pool,
                             pool_idx, shaping_factor, potential_fn, bc_policy, bc_factor,
                             bc_draws, bc_sample_fn, mesh)
        if on_phase:
            on_phase("rollout", ro)
        adv, value_targets = gae(ro.reward, ro.value, config.gamma, config.lmbda)
        adv = standardize(adv, ro.mask, mesh)
        if on_phase:
            on_phase("advantages", (adv, value_targets))

        def flat(x):  # time-major (T, P*B, ...) -> (n_samples, ...), the rank's with a mesh
            return x.reshape((-1,) + x.shape[2:])

        data = tuple(flat(x) for x in (ro.obs, ro.action, ro.logp, ro.logits, ro.value, adv,
                                       value_targets, ro.mask))
        params = list(ts.net.parameters())
        for epoch in range(config.num_sgd_iter):
            if perm_fn is None:
                perm = torch.randperm(n_samples, generator=ts.generator, device=device)
            else:
                perm = torch.as_tensor(perm_fn(epoch), device=device)
            if shard is not None:
                aux = _sharded_epoch(ts, params, data,
                                     perm[:n_minibatches * mb_size].view(n_minibatches, mb_size),
                                     ro, shard, entropy_coeff, config, mesh)
                continue
            for i in range(n_minibatches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                total, aux = loss_fn(ts.net, tuple(d[idx] for d in data), ts.kl_coeff,
                                     entropy_coeff, config)
                sgd_step(ts, total, params, config)
        return finish_iteration(ts, ro, aux, config, shaping_factor, entropy_coeff, bc_factor,
                                mesh)

    return init_fn, train_iteration


def train(spec, config: PPOConfig, num_iterations: int, seed: int = 0, potential_fn=None,
          bc_policy=None, log_every: int = 0, device="cuda"):
    """Convenience loop; returns (final TrainState, list of IterMetrics)."""
    init_fn, train_iteration = make_ppo(spec, config, potential_fn, bc_policy, device=device)
    ts = init_fn(seed)
    history = []
    for it in range(num_iterations):
        ts, m = train_iteration(ts)
        history.append(m)
        if log_every and (it + 1) % log_every == 0:
            print(f"iter {it + 1}: sparse_r={m.episode_sparse_reward.item():.2f} "
                  f"shaped_r={m.episode_shaped_reward.item():.2f} "
                  f"kl={m.kl.item():.4f} entropy={m.entropy.item():.3f}")
    return ts, history
