"""Recurrent PPO self-play on the card (port of
`overcooked_ai_tpu.training.ppo_lstm`).

The reference's RllibLSTMPPOModel learner: the rollout threads the LSTM
carry (c, h) of `LSTMPPONet` through the episode, each step one launch of
B1 (`ops/fused_train.py`, one layout) or B3 (`ops/fused_pool.py`, pool
mode) through `training/ppo.collect_rollout`, with `reset_horizon = T + 1`.
Learning is truncated BPTT over `MAX_SEQ_LEN`-step chunks (rllib's
max_seq_len): chunk n * (T / 20) + k is steps [20k, 20k + 20) of sample
sequence n, run from the carry the rollout had at its first step, with no
gradient across chunks. An epoch permutes the (T / 20) * 2B chunks and
drops the tail that fills no minibatch of
`max(min(2 * sgd_minibatch_size // 20, n_chunks), 1)` chunks. The loss,
the optimiser rule, GAE, the schedules, the BC partner and the KL update
are the feed-forward learner's (`training/ppo.py`).

As in the JAX recurrent learner, `use_phi`'s dense reward is phi(s') -
phi(s) alone: `phi_event_mix` is not read here.

The rollout keeps the carry only at the chunk starts (T / 20 of T steps),
not at every step.

`train_iteration` opens `make_ppo`'s spans (`utils/trace.py`) under the
same names: `ppo.iteration`, `ppo.advantages`, `ppo.sgd` and, a minibatch,
`sgd.forward` around the gather, the forward and the loss; `LSTMPPONet`
adds `lstm.torso`, `lstm.recurrence` and `lstm.step` inside them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from overcooked_ai_tpu_torch.ops.fused_pool import check_pool_shape
from overcooked_ai_tpu_torch.training.networks import LSTMPPONet, NetConfig
from overcooked_ai_tpu_torch.training.ppo import (
    PhaseFn,
    PPOConfig,
    SampleFn,
    TrainState,
    collect_rollout,
    finish_iteration,
    gae,
    make_ppo_eval,
    ppo_loss,
    schedules,
    sgd_step,
    standardize,
)
from overcooked_ai_tpu_torch.utils.trace import span

MAX_SEQ_LEN = 20  # rllib's default


class _Recurrent:
    """An `LSTMPPONet` as a feed-forward policy, obs (N, H, W, 26) ->
    (logits, value), that threads its carry from zeros, one call a step.
    With `horizon` it keeps the carry of every `MAX_SEQ_LEN`-th step in
    `c0` and `h0`, (horizon // MAX_SEQ_LEN, N, cell_size) each."""

    def __init__(self, net: LSTMPPONet, n: int, device, horizon: int = 0):
        self.net, self.cfg = net, net.cfg
        self.carry = net.initial_carry(n, device)
        shape = (horizon // MAX_SEQ_LEN, n, net.cfg.cell_size)
        self.c0 = torch.empty(shape, dtype=torch.float32, device=device)
        self.h0 = torch.empty_like(self.c0)
        self.t = 0

    def __call__(self, obs: torch.Tensor):
        k, r = divmod(self.t, MAX_SEQ_LEN)
        if r == 0 and k < self.c0.shape[0]:
            self.c0[k], self.h0[k] = self.carry
        logits, value, self.carry = self.net.step(obs, self.carry)
        self.t += 1
        return logits, value


def make_ppo_lstm(spec, config: PPOConfig, bc_policy=None, potential_fn=None, device="cuda"):
    """Build (init_fn, train_iteration) of the recurrent learner for a layout
    spec, or for a list of same-shape specs (pool mode: each iteration every
    lane draws a layout of the pool). `bc_policy` and `potential_fn` are
    `make_ppo`'s.

    init_fn(seed) -> TrainState with an `LSTMPPONet` drawn from a CPU
    generator seeded `seed`, Adam, and a generator on `device`.

    train_iteration(ts, sample_fn=None, pool_idx=None, perm_fn=None,
    on_phase=None, bc_draws=None, bc_sample_fn=None) -> (ts, IterMetrics):
    the hooks are `make_ppo`'s, and `perm_fn(epoch)` gives the
    (n_chunks,) permutation of the chunks.
    """
    if config.use_phi and potential_fn is None:
        raise ValueError("use_phi requires a potential_fn")
    pool_mode = isinstance(spec, (list, tuple))
    spec0 = check_pool_shape(list(spec)) if pool_mode else spec
    if spec0.num_players != 2:
        raise ValueError("PPO self-play is 2-player")
    B, T = config.num_envs, config.horizon
    if T % MAX_SEQ_LEN:
        raise ValueError(f"the horizon {T} is not a multiple of MAX_SEQ_LEN {MAX_SEQ_LEN}")
    device = torch.device(device)
    N = 2 * B  # sample sequences
    n_chunks_t = T // MAX_SEQ_LEN
    n_chunks = n_chunks_t * N
    mb_chunks = max(min(2 * config.sgd_minibatch_size // MAX_SEQ_LEN, n_chunks), 1)
    n_minibatches = max(n_chunks // mb_chunks, 1)
    if not any(v for _, v in config.bc_schedule):
        bc_policy = None  # the partner never plays
    rollout_config = dataclasses.replace(config, phi_event_mix=False)

    def init_fn(seed: int) -> TrainState:
        net = LSTMPPONet(config.net, spec0.height, spec0.width,
                         generator=torch.Generator().manual_seed(seed)).to(device)
        opt = torch.optim.Adam(net.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(
            net, opt, torch.Generator(device=device).manual_seed(seed),
            torch.zeros((), dtype=torch.float32, device=device),
            torch.tensor(config.kl_coeff, dtype=torch.float32, device=device),
        )

    def chunk(x):  # (T, N, ...) -> (n_chunks, MAX_SEQ_LEN, ...)
        x = x.reshape((n_chunks_t, MAX_SEQ_LEN, N) + x.shape[2:]).movedim(2, 0)
        return x.reshape((n_chunks, MAX_SEQ_LEN) + x.shape[3:])

    def chunk_first(x):  # (n_chunks_t, N, C) -> (n_chunks, C)
        return x.transpose(0, 1).reshape(n_chunks, -1)

    def train_iteration(ts: TrainState, sample_fn: Optional[SampleFn] = None,
                        pool_idx: Optional[torch.Tensor] = None,
                        perm_fn: Optional[Callable[[int], torch.Tensor]] = None,
                        on_phase: Optional[PhaseFn] = None, bc_draws=None,
                        bc_sample_fn: Optional[SampleFn] = None):
        with span("ppo.iteration", device=True):
            shaping_factor, entropy_coeff, bc_factor = schedules(config, ts.env_steps)
            policy = _Recurrent(ts.net, N, device, T)
            ro = collect_rollout(spec, policy, rollout_config, ts.generator, device, sample_fn,
                                 None, pool_idx, shaping_factor, potential_fn, bc_policy,
                                 bc_factor, bc_draws, bc_sample_fn)
            if on_phase:
                on_phase("rollout", ro)
            with span("ppo.advantages", device=True):
                adv, value_targets = gae(ro.reward, ro.value, config.gamma, config.lmbda)
                adv = standardize(adv, ro.mask)
                if on_phase:
                    on_phase("advantages", (adv, value_targets))

            obs, *rest = (chunk(x) for x in (ro.obs, ro.action, ro.logp, ro.logits, ro.value,
                                             adv, value_targets, ro.mask))
            c0, h0 = chunk_first(policy.c0), chunk_first(policy.h0)
            with span("ppo.sgd", device=True):
                params = list(ts.net.parameters())
                for epoch in range(config.num_sgd_iter):
                    if perm_fn is None:
                        perm = torch.randperm(n_chunks, generator=ts.generator, device=device)
                    else:
                        perm = torch.as_tensor(perm_fn(epoch), device=device)
                    for i in range(n_minibatches):
                        with span("sgd.forward", device=True):
                            idx = perm[i * mb_chunks:(i + 1) * mb_chunks]
                            logits, value, _ = ts.net(obs[idx], (c0[idx], h0[idx]))
                            total, aux = ppo_loss(logits.flatten(0, 1), value.flatten(),
                                                  tuple(x[idx].flatten(0, 1) for x in rest),
                                                  ts.kl_coeff, entropy_coeff, config)
                        sgd_step(ts, total, params, config)
            return finish_iteration(ts, ro, aux, config, shaping_factor, entropy_coeff,
                                    bc_factor)

    return init_fn, train_iteration


def make_ppo_lstm_eval(spec, net_config: Optional[NetConfig] = None, num_games: int = 8,
                       horizon: int = 400, device="cuda"):
    """Shaping-free self-play evaluation of a recurrent policy, its carry
    threaded through the episode; each step one B1 launch, as in
    `make_ppo_eval`.

    Returns evaluate(net, generator=None, sample_fn=None) -> mean sparse
    return per game; a net whose config is not `net_config` (when given)
    raises ValueError.
    """
    evaluate_steps = make_ppo_eval(spec, num_games, horizon, device)
    n = spec.num_players * num_games

    def evaluate(net: LSTMPPONet, generator: Optional[torch.Generator] = None,
                 sample_fn: Optional[SampleFn] = None) -> float:
        if net_config is not None and net.cfg != net_config:
            raise ValueError(f"a net of {net.cfg}, not of {net_config}")
        return evaluate_steps(_Recurrent(net, n, device), generator, sample_fn)

    return evaluate
