"""Behavior cloning (port of `overcooked_ai_tpu.training.bc`).

The reference's TF2 BC: an MLP (2 x 64, ReLU) over the 96-dim hand-crafted
featurization (`core/featurize.py`) -> 6 action logits, trained with
softmax cross-entropy, Adam(1e-3), batch 64, a 0.15 validation split,
early stopping on the validation loss and optional class weights. The
trained net is an Overcooked agent too: the PPO+BC partner
(`bc_policy_batch`, `bc_policy_batch_pool`) and the human proxy of the eval
matrix (`bc_policy_fn`).

A model directory holds `metadata.json` (the config, `obs_dim` and what the
trainer adds) beside the weights: the port writes `params.pt`, a state dict
that `torch.load` reads with `weights_only=True`; `load_bc_model` also
reads the JAX package's `params.msgpack` (`training/_msgpack.py`), so the
committed proxies under `runs/` load as they are.

The recurrent BC net (`BCLSTMNet`: the MLP torso per timestep, an LSTM of
`cell_size`, the logits) trains on padded per-agent sequences
(`train_bc_lstm`); `train_bc_model` and `load_bc_model` refuse
`use_lstm`, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from overcooked_ai_tpu_torch.core.featurize import cost_rows, featurize_batch
from overcooked_ai_tpu_torch.training.networks import LSTMCell, lecun_dense


@dataclasses.dataclass(frozen=True)
class BCConfig:
    """The reference DEFAULT_MLP_PARAMS / DEFAULT_TRAINING_PARAMS."""

    net_arch: Sequence[int] = (64, 64)
    num_actions: int = 6
    epochs: int = 100
    validation_split: float = 0.15
    batch_size: int = 64
    learning_rate: float = 1e-3
    use_class_weights: bool = False
    early_stopping_patience: int = 20  # keras EarlyStopping(patience=20)
    use_lstm: bool = False
    cell_size: int = 256


class BCNet(nn.Module):
    """Linear + ReLU per `net_arch` entry, then a Linear to the logits. The
    weights are drawn on the CPU from `generator`: LeCun-normal (flax's
    Dense default), zero biases."""

    def __init__(self, cfg: BCConfig, obs_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        generator = generator or torch.Generator().manual_seed(0)
        dims = [obs_dim, *cfg.net_arch]
        self.hidden = nn.ModuleList(lecun_dense(a, b, generator)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.logits = lecun_dense(dims[-1], cfg.num_actions, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.hidden:
            x = F.relu(layer(x))
        return self.logits(x)


class BCLSTMNet(nn.Module):
    """The recurrent BC net (reference _build_lstm_model): Linear + ReLU per
    `net_arch` entry on each timestep, an LSTM of `cfg.cell_size`
    (`networks.LSTMCell`, carry (c, h)), then a Linear to the logits. Init
    as flax's (LeCun-normal dense kernels; the cell's), drawn on the CPU
    from `generator`."""

    def __init__(self, cfg: BCConfig, obs_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        generator = generator or torch.Generator().manual_seed(0)
        dims = [obs_dim, *cfg.net_arch]
        self.hidden = nn.ModuleList(lecun_dense(a, b, generator)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.lstm = LSTMCell(dims[-1], cfg.cell_size, generator)
        self.logits = lecun_dense(cfg.cell_size, cfg.num_actions, generator)

    def forward(self, x_seq: torch.Tensor, carry=None):
        """x_seq (N, T, F) -> (logits (N, T, A), the final carry); `carry`
        None starts from zeros."""
        x = x_seq
        for layer in self.hidden:
            x = F.relu(layer(x))
        if carry is None:
            carry = self.lstm.initial_carry(x.shape[0], x.device)
        hs, carry = self.lstm(x, carry)
        return self.logits(hs), carry


def _obs_dim(params: dict) -> int:
    for first in ("hidden.0.weight", "lstm.weight_ih", "logits.weight"):
        if first in params:
            return int(params[first].shape[1])
    raise ValueError(f"not the params of a BC net: {sorted(params)}")


def bc_net(params: dict, cfg: BCConfig, device="cuda") -> BCNet:
    """A BCNet holding `params` (a state dict), in eval mode on `device`."""
    net = BCNet(cfg, _obs_dim(params))
    net.load_state_dict(params)
    return net.to(device).eval()


def train_bc_model(obs: np.ndarray, actions: np.ndarray, cfg: BCConfig = BCConfig(),
                   seed: int = 0, verbose: bool = False, init_params: Optional[dict] = None,
                   device="cuda"):
    """Train a BC model on (obs (N, F), actions (N,)). Returns (the params of
    the epoch with the best validation loss, as a CPU state dict; history).

    The split, the class weights and each epoch's permutation come from
    `np.random.RandomState(seed)` in the JAX trainer's order; the net starts
    from `init_params` (a state dict) or from a generator seeded `seed`.
    Early stopping: an epoch improves when its validation loss is below the
    best by more than 1e-5; training stops after `early_stopping_patience`
    epochs without one.
    """
    if cfg.use_lstm:
        raise ValueError("LSTM BC: use train_bc_lstm")
    n = obs.shape[0]
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    obs, actions = obs[perm], actions[perm]
    n_val = int(n * cfg.validation_split)
    tr_act = actions[n_val:]
    class_weights = np.ones(cfg.num_actions, np.float32)
    if cfg.use_class_weights:
        counts = np.bincount(tr_act, minlength=cfg.num_actions).astype(np.float64)
        class_weights = (len(tr_act) / (cfg.num_actions * np.maximum(counts, 1))).astype(
            np.float32)

    device = torch.device(device)
    x = torch.as_tensor(np.asarray(obs, np.float32), device=device)
    y = torch.as_tensor(np.asarray(actions), device=device).long()
    val_x, val_y, tr_x, tr_y = x[:n_val], y[:n_val], x[n_val:], y[n_val:]
    cw = torch.as_tensor(class_weights, device=device)
    net = BCNet(cfg, obs.shape[1], torch.Generator().manual_seed(seed))
    if init_params is not None:
        net.load_state_dict(init_params)
    net = net.to(device)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def snapshot():
        return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}

    n_train = len(tr_x)
    steps = max(n_train // cfg.batch_size, 1)
    best_val, best_params, patience = np.inf, snapshot(), 0
    history = {"loss": [], "val_loss": [], "val_acc": []}
    for epoch in range(cfg.epochs):
        eperm = torch.as_tensor(rng.permutation(n_train), device=device)
        losses = []
        for s in range(steps):
            idx = eperm[s * cfg.batch_size:(s + 1) * cfg.batch_size]
            bo, ba = tr_x[idx], tr_y[idx]
            loss = (F.cross_entropy(net(bo), ba, reduction="none") * cw[ba]).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        ep_loss = float(torch.stack(losses).double().sum().item()) / steps
        if n_val:
            with torch.no_grad():
                logits = net(val_x)
                v_loss = float(F.cross_entropy(logits, val_y).item())
                v_acc = float((logits.argmax(-1) == val_y).float().mean().item())
        else:
            v_loss, v_acc = ep_loss, 0.0
        history["loss"].append(ep_loss)
        history["val_loss"].append(v_loss)
        history["val_acc"].append(v_acc)
        if verbose:
            print(f"epoch {epoch}: loss {ep_loss:.4f} val {v_loss:.4f} acc {v_acc:.3f}")
        if v_loss < best_val - 1e-5:
            best_val, best_params, patience = v_loss, snapshot(), 0
        else:
            patience += 1
            if patience >= cfg.early_stopping_patience:
                break
    return best_params, history


def train_bc_lstm(sequences, cfg: BCConfig = BCConfig(use_lstm=True), seed: int = 0,
                  verbose: bool = False, init_params: Optional[dict] = None, device="cuda"):
    """Train the recurrent BC net on variable-length per-agent sequences,
    a list of (obs (T_i, F) float32, actions (T_i,) int). Returns (the last
    params, as a CPU state dict; {"loss": the mean minibatch loss of each
    epoch}).

    The sequences are padded with zeros to the longest, and the padding is
    masked out of the cross-entropy (the sum over real steps over their
    count). `cfg.epochs` epochs of Adam steps over minibatches of
    `min(cfg.batch_size, n)` sequences, each epoch's order from
    `np.random.RandomState(seed)`, the last minibatch possibly short. The
    net starts from `init_params` (a state dict) or from a generator
    seeded `seed`.
    """
    if not sequences:
        raise ValueError("train_bc_lstm needs at least one sequence")
    max_len = max(o.shape[0] for o, _ in sequences)
    feat = sequences[0][0].shape[1]
    n = len(sequences)
    obs = np.zeros((n, max_len, feat), np.float32)
    act = np.zeros((n, max_len), np.int64)
    mask = np.zeros((n, max_len), np.float32)
    for i, (o, a) in enumerate(sequences):
        obs[i, :len(a)] = o
        act[i, :len(a)] = a
        mask[i, :len(a)] = 1.0

    device = torch.device(device)
    x, y, m = (torch.as_tensor(v, device=device) for v in (obs, act, mask))
    net = BCLSTMNet(cfg, feat, torch.Generator().manual_seed(seed))
    if init_params is not None:
        net.load_state_dict(init_params)
    net = net.to(device)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.RandomState(seed)
    bs = max(min(cfg.batch_size, n), 1)
    history = {"loss": []}
    for epoch in range(cfg.epochs):
        perm = torch.as_tensor(rng.permutation(n), device=device)
        losses = []
        for s in range(0, n, bs):
            idx = perm[s:s + bs]
            logits, _ = net(x[idx])
            ce = F.cross_entropy(logits.flatten(0, 1), y[idx].flatten(), reduction="none")
            bm = m[idx].flatten()
            loss = (ce * bm).sum() / torch.clamp(bm.sum(), min=1.0)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        history["loss"].append(float(torch.stack(losses).double().sum().item()) / len(losses))
        if verbose:
            print(f"epoch {epoch}: loss {history['loss'][-1]:.4f}")
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}, history


def save_bc_model(model_dir, params: dict, cfg: BCConfig, metadata=None):
    """Write `params.pt` (the state dict) and `metadata.json` (the config,
    `obs_dim`, and `metadata`)."""
    os.makedirs(model_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               os.path.join(model_dir, "params.pt"))
    meta = dict(dataclasses.asdict(cfg))
    meta["net_arch"] = list(meta["net_arch"])
    meta["obs_dim"] = _obs_dim(params)
    meta.update(metadata or {})
    with open(os.path.join(model_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_bc_model(model_dir):
    """(params as a CPU state dict, BCConfig) of a BC model directory: the
    port's (`params.pt`) or the JAX package's (`params.msgpack`)."""
    with open(os.path.join(model_dir, "metadata.json")) as f:
        meta = json.load(f)
    names = {f.name for f in dataclasses.fields(BCConfig)}
    cfg = BCConfig(**{k: (tuple(v) if k == "net_arch" else v) for k, v in meta.items()
                      if k in names})
    if cfg.use_lstm:
        raise ValueError(f"{model_dir}: a recurrent BC model (use_lstm) has no loader, as in "
                         "the JAX package; train_bc_lstm returns its params")
    pt = os.path.join(model_dir, "params.pt")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True), cfg
    from overcooked_ai_tpu_torch.training._msgpack import read_msgpack
    from overcooked_ai_tpu_torch.training.convert import bc_params_from_jax

    with open(os.path.join(model_dir, "params.msgpack"), "rb") as f:
        return bc_params_from_jax(read_msgpack(f.read())), cfg


class _BCPolicyBase:
    """The net and the motion costs, copied to a device at the first call
    there; pickled without the copies."""

    def __init__(self, params: dict, cfg: BCConfig, feature_cost, stochastic: bool):
        self.params, self.cfg, self.stochastic = params, cfg, stochastic
        self.feature_cost = np.asarray(feature_cost)
        self._on = {}

    def on(self, device):
        if device not in self._on:
            self._on[device] = (bc_net(self.params, self.cfg, device),
                                cost_rows(self.feature_cost).to(device))
        return self._on[device]

    def __getstate__(self):
        return {**self.__dict__, "_on": {}}

    @torch.no_grad()
    def logits(self, layout, state, pool_idx=None) -> torch.Tensor:
        """(B * P, A) logits, row b * P + p for player p of env b."""
        net, rows = self.on(state.obj.device)
        feats = featurize_batch(layout, rows, state, pool_idx=pool_idx)  # (B, P, F)
        return net(feats.reshape(-1, feats.shape[-1]))

    def act(self, sample, logits) -> torch.Tensor:
        """Actions of `logits`: `sample(logits)` if stochastic, else the argmax."""
        return sample(logits) if self.stochastic else torch.argmax(logits, -1)


class BCAgentPolicy(_BCPolicyBase):
    """A BC net as an agent of `run_agent_pair`: (draws, layout, state,
    agent_index) -> (B,) int32, drawing Gumbel noise "policy" (JAX's
    `categorical`) when stochastic."""

    def __call__(self, draws, layout, state, agent_index):
        P = state.pos.shape[0]
        logits = self.logits(layout, state).view(-1, P, self.cfg.num_actions)[:, agent_index]
        return self.act(lambda lg: torch.argmax(lg + draws.gumbel("policy", (lg.shape[1],)).T, -1),
                        logits).to(torch.int32)


Sampler = Callable[[torch.Tensor], torch.Tensor]  # (N, A) logits -> (N,) actions


class BCBatchPolicy(_BCPolicyBase):
    """A BC net acting for every seat of a batch: (sample, layout, state) ->
    (P, B) int32, or (sample, lane_layouts, state, pool_idx) for a pool
    (then `feature_cost` is the pool's (N, 4, H, W, H, W) stack). `sample`
    draws one action per row of the (B * P, A) logits, as JAX's
    `categorical` of the step's BC key does."""

    def __call__(self, sample: Sampler, layout, state, pool_idx=None):
        B = state.obj.shape[-1]
        act = self.act(sample, self.logits(layout, state, pool_idx))
        return act.reshape(B, -1).T.to(torch.int32)


def bc_policy_fn(spec, feature_cost, params: dict, cfg: BCConfig, stochastic=True):
    """A BC model as a stateless agent fn (`agents.evaluation.stateless`)."""
    return BCAgentPolicy(params, cfg, feature_cost, stochastic)


def bc_policy_batch(spec, feature_cost, params: dict, cfg: BCConfig, stochastic=True):
    """A BC model as the every-seat partner of `make_ppo(bc_policy=...)`."""
    return BCBatchPolicy(params, cfg, feature_cost, stochastic)


def bc_policy_batch_pool(specs, feature_costs, params: dict, cfg: BCConfig, stochastic=True):
    """The pool-mode partner: each lane featurizes on its own layout and
    that layout's motion costs (`feature_costs`, one table per spec, the
    same grid shape); one shared net, since the features are egocentric."""
    return BCBatchPolicy(params, cfg, np.stack([np.asarray(f) for f in feature_costs]),
                         stochastic)
