"""The plain reference of the recurrent learner: the LSTM cell, the recurrent
policy over a sequence, the rollout that threads its carry, the chunking of
truncated BPTT and an iteration's epochs, written from their published
definitions in plain PyTorch (float32), with nothing of the port. The loss,
GAE, the standardisation, the clip, Adam and the anneals are `learner.py`'s.

The net (Carroll et al. 2019, `human_aware_rl/ppo/ppo_rllib.py`
RllibLSTMPPOModel): at every timestep a 5x5 SAME convolution, 3x3 SAME
ones, the last 3x3 VALID, the features flattened in (H, W, C) order, dense
layers, each activation TF's `leaky_relu` (alpha 0.2); then an LSTM of
CELL_SIZE with carry (c, h) and gates i, f, g, o,

    gates = x @ W_i + h @ W_h + b
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')

then the logits and the value, each a dense layer of h. The parameters are
a dict of tensors named as the program's state dict names them: the input
kernels `lstm.weight_ih` (4C, F) without a bias, the hidden ones
`lstm.weight_hh` (4C, C) with `lstm.bias` (4C), the gates stacked in the
order (i, f, g, o), as flax's `OptimizedLSTMCell` splits them.

Learning (rllib's recurrent PPO, `max_seq_len` 20): the rollout runs each
seat's episode as one sequence from a zero carry and records the carry at
the start of every 20th step. Chunk n * (T / 20) + k is steps [20k, 20k +
20) of sequence n, run from its recorded carry, with no gradient across
chunks. Each epoch permutes the chunks and takes minibatches of
`max(min(2 * sgd_minibatch_size // 20, n_chunks), 1)` chunks, the tail that
fills no minibatch dropped.

Departures from the published description:
- Keras's LSTM holds one bias beside its two kernels; here it sits with the
  hidden kernels (flax's split), which is the same sum.
- The weights are given (the benchmark draws Glorot-uniform kernels and
  zero biases from its seed), not Keras's orthogonal recurrent kernels and
  unit forget bias.
- Every episode lasts exactly T steps, a multiple of 20, so no chunk is
  padded and no sequence is cut by a reset: rllib's padding and masking of
  short sequences never apply.
- A minibatch counts both seats' samples, 2 * sgd_minibatch_size env steps
  (the repo's feed-forward learner's rule), and drops the permutation's
  tail where rllib would keep a short last minibatch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import learner as L
from .encoding import encode_nhwc
from .env import batch_reset, clamp_stamps, env_step, pack_events

MAX_SEQ_LEN = 20  # rllib's default max_seq_len
NUM_LAYERS = 26  # of the lossless encoding


def cell(params: dict, x_proj: torch.Tensor, carry):
    """One step of the cell from the input projection x @ W_i (N, 4C)."""
    c, h = carry
    gates = x_proj + h @ params["lstm.weight_hh"].T + params["lstm.bias"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def torso(params: dict, obs: torch.Tensor, num_convs: int, num_dense: int) -> torch.Tensor:
    """obs (M, H, W, C) int8 -> the features (M, F) the cell takes."""
    x = obs.float().permute(0, 3, 1, 2)
    for i in range(num_convs):
        w, b = params[f"convs.{i}.weight"], params[f"convs.{i}.bias"]
        valid = i > 0 and i == num_convs - 1
        x = F.leaky_relu(F.conv2d(x, w, b, padding=0 if valid else w.shape[-1] // 2), 0.2)
    x = x.permute(0, 2, 3, 1).flatten(1)
    for i in range(num_dense):
        x = F.leaky_relu(x @ params[f"dense.{i}.weight"].T + params[f"dense.{i}.bias"], 0.2)
    return x


def heads(params: dict, h: torch.Tensor):
    """h (..., C) -> (logits (..., A), value (...))."""
    logits = h @ params["logits.weight"].T + params["logits.bias"]
    return logits, (h @ params["values.weight"].T + params["values.bias"])[..., 0]


def step(params: dict, obs: torch.Tensor, carry, num_convs: int, num_dense: int):
    """One timestep: obs (N, H, W, C) -> (logits (N, A), value (N,), the next carry)."""
    x = torso(params, obs, num_convs, num_dense)
    carry = cell(params, x @ params["lstm.weight_ih"].T, carry)
    return heads(params, carry[1]) + (carry,)


def forward(params: dict, obs_seq: torch.Tensor, carry, num_convs: int, num_dense: int):
    """Sequences obs_seq (N, T, H, W, C) from `carry` -> (logits (N, T, A),
    values (N, T), the final carry)."""
    n, t = obs_seq.shape[:2]
    x = torso(params, obs_seq.reshape((n * t,) + obs_seq.shape[2:]), num_convs, num_dense)
    x_proj = (x @ params["lstm.weight_ih"].T).view(n, t, -1)
    hs = []
    for k in range(t):
        carry = cell(params, x_proj[:, k], carry)
        hs.append(carry[1])
    logits, values = heads(params, torch.stack(hs, 1))
    return logits, values, carry


def chunks(x: torch.Tensor) -> torch.Tensor:
    """Time-major (T, N, ...) -> (n_chunks, MAX_SEQ_LEN, ...), chunk
    n * (T / 20) + k holding steps [20k, 20k + 20) of sequence n."""
    t, n = x.shape[:2]
    x = x.reshape((t // MAX_SEQ_LEN, MAX_SEQ_LEN, n) + x.shape[2:]).movedim(2, 0)
    return x.reshape((n * (t // MAX_SEQ_LEN), MAX_SEQ_LEN) + x.shape[3:])


def chunk_carries(x: torch.Tensor) -> torch.Tensor:
    """The carries recorded at the chunks' starts (T / 20, N, C) -> (n_chunks, C)."""
    return x.transpose(0, 1).reshape(-1, x.shape[-1])


def minibatch_chunks(sgd_minibatch_size: int, n_chunks: int) -> int:
    return max(min(2 * sgd_minibatch_size // MAX_SEQ_LEN, n_chunks), 1)


def minibatches(perm: torch.Tensor, mb_chunks: int) -> list:
    """An epoch's permutation of the chunks -> its minibatches' chunk
    indices, the tail that fills none dropped."""
    return [perm[j * mb_chunks:(j + 1) * mb_chunks] for j in range(len(perm) // mb_chunks)]


class Rollout(NamedTuple):
    """One iteration's episode, time-major over the 2B sequences (seat-major)."""

    obs: torch.Tensor  # (T, N, H, W, 26) int8
    logits: torch.Tensor  # (T, N, A)
    value: torch.Tensor  # (T, N)
    logp: torch.Tensor  # (T, N) of the actions taken
    reward: torch.Tensor  # (T, N)
    sparse: torch.Tensor  # (T, P, B) int32
    shaped: torch.Tensor  # (T, P, B) int32
    events: torch.Tensor  # (T, P, B) int32 bitmasks
    c0: torch.Tensor  # (T / 20, N, C): the carry at each chunk's start
    h0: torch.Tensor


def rollout(lay, params: dict, choose, horizon: int, num_envs: int, shaping_factor: float,
            num_convs: int, num_dense: int, device) -> Rollout:
    """Self-play one episode of `horizon` steps in `num_envs` envs from the
    start state, the recurrent policy's carry threaded from zeros; `choose(t,
    logits)` gives step t's (2B,) actions. The reward of each seat is the
    team's sparse reward plus `shaping_factor` times its shaped reward."""
    T, B = horizon, num_envs
    state = batch_reset(lay, B, device)
    P = state.held.shape[0]
    N, C = P * B, params["lstm.weight_hh"].shape[1]
    zeros = torch.zeros((N, C), device=device)
    carry = (zeros, zeros.clone())
    c0, h0 = (torch.empty((T // MAX_SEQ_LEN, N, C), device=device) for _ in range(2))
    obs = None
    out = {k: [] for k in ("obs", "logits", "value", "logp", "reward", "sparse", "shaped",
                           "events")}
    for t in range(T):
        if t % MAX_SEQ_LEN == 0:
            c0[t // MAX_SEQ_LEN], h0[t // MAX_SEQ_LEN] = carry
        obs = encode_nhwc(lay, state, T)
        logits, value, carry = step(params, obs, carry, num_convs, num_dense)
        action = choose(t, logits)
        logp = torch.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
        st = env_step(lay, state, action.to(torch.int32).reshape(P, B), T + 1)
        state = clamp_stamps(st.obs_state)
        reward = (st.sparse_reward.sum(0, dtype=torch.int32)[None].float()
                  + shaping_factor * st.shaped_reward.float()).reshape(N)
        for k, v in (("obs", obs), ("logits", logits), ("value", value), ("logp", logp),
                     ("reward", reward), ("sparse", st.sparse_reward),
                     ("shaped", st.shaped_reward), ("events", pack_events(st.events))):
            out[k].append(v)
    return Rollout(**{k: torch.stack(v) for k, v in out.items()}, c0=c0, h0=h0)


def epochs(params: dict, adam: L.Adam, ro: Rollout, action: torch.Tensor, adv: torch.Tensor,
           value_targets: torch.Tensor, perms, kl_coeff: float, entropy_coeff: float, hp: dict,
           num_convs: int, num_dense: int, on_grad=None):
    """The iteration's SGD: for each epoch's permutation of the chunks, each
    minibatch's loss from its chunks' recorded carries, its gradient
    clipped by the global norm, an Adam step on `params` (in place). The
    samples are the rollout's, with the `action`s taken; `on_grad(grads)`
    sees each clipped gradient. Returns the last minibatch's (policy_loss,
    vf_loss, kl, entropy) and total."""
    keys = list(params)
    obs = chunks(ro.obs)
    rest = [chunks(x) for x in (action, ro.logp, ro.logits, ro.value, adv, value_targets)]
    c0, h0 = chunk_carries(ro.c0), chunk_carries(ro.h0)
    mb_chunks = minibatch_chunks(hp["sgd_minibatch_size"], obs.shape[0])
    mask = torch.ones(mb_chunks * MAX_SEQ_LEN, device=adv.device)  # no seat is a partner's
    for perm in perms:
        for idx in minibatches(perm, mb_chunks):
            leaves = {n: params[n].detach().requires_grad_(True) for n in keys}
            logits, value, _ = forward(leaves, obs[idx], (c0[idx], h0[idx]), num_convs,
                                       num_dense)
            a, lp, lo, vo, ad, vt = (x[idx].flatten(0, 1) for x in rest)
            terms = L.ppo_terms(logits.flatten(0, 1), value.flatten(), a, lp, lo, vo, ad, vt,
                                mask, hp)
            total = (terms[0] + kl_coeff * terms[2] + hp["vf_loss_coeff"] * terms[1]
                     - entropy_coeff * terms[3])
            grads = dict(zip(keys, torch.autograd.grad(total, [leaves[n] for n in keys])))
            grads = L.clip_global_norm(grads, hp["grad_clip"])
            if on_grad is not None:
                on_grad(grads)
            adam.step(params, grads)
    return tuple(t.detach() for t in terms), total.detach()
