"""JAX's random draws through the torch port's `Draws` interface
(`overcooked_ai_tpu_torch.agents.agents`), so that the port's agents take
exactly the noise the JAX agents take from their keys.

The JAX agents read: the greedy model `split(key, 3)` -> (hl, ll, unstuck),
a Gumbel vector for each Boltzmann draw and a uniform for the unstuck pick;
`random_agent` and `make_sample_agent` a uniform of their own key
(`jax.random.choice`); a PPO agent a Gumbel vector of its own key
(`jax.random.categorical`).
"""

import jax
import numpy as np
import torch

from overcooked_ai_tpu_torch.agents.agents import StepDraws

_GREEDY = ("hl", "ll", "unstuck")


def _draw(kind, shape):
    if kind == "uniform":
        return lambda k: jax.random.uniform(k)
    return lambda k: jax.random.gumbel(k, shape)


def _subkeys(keys, name):
    """The key a draw of `name` reads, from the agent's keys (..., 2)."""
    if name not in _GREEDY:
        return keys
    def split(k):
        return jax.random.split(k, 3)

    for _ in range(keys.ndim - 1):
        split = jax.vmap(split)
    return split(keys)[..., _GREEDY.index(name), :]


class KeyDraws:
    """One agent call over a batch of games, game b drawing from keys[b]."""

    def __init__(self, keys):
        self.keys = keys  # (B, 2) raw JAX keys

    def _batch(self, name, kind, shape=()):
        vals = jax.vmap(_draw(kind, shape))(_subkeys(self.keys, name))  # (B, *shape)
        return torch.from_numpy(np.moveaxis(np.asarray(vals), 0, -1).copy())

    def uniform(self, name):
        return self._batch(name, "uniform")

    def gumbel(self, name, shape):
        return self._batch(name, "gumbel", tuple(shape))


class JaxKeyDraws:
    """`run_agent_pair`'s key tree: split(PRNGKey(seed), horizon) -> per
    step split(key_t, B) -> per game split(key, P) -> the player's key."""

    def __init__(self, seed, horizon, batch, players=2):
        keys = jax.random.split(jax.random.PRNGKey(seed), horizon)
        per_game = jax.vmap(lambda k: jax.random.split(k, batch))(keys)
        self.keys = jax.vmap(jax.vmap(lambda k: jax.random.split(k, players)))(per_game)
        self._cache = {}  # (name, kind, shape) -> (T, P, *shape, B) numpy

    def at(self, t, player):
        return StepDraws(self, t, player)

    def _all(self, name, kind, shape):
        k = (name, kind, shape)
        if k not in self._cache:
            fn = jax.jit(jax.vmap(jax.vmap(jax.vmap(_draw(kind, shape)))))
            vals = np.asarray(fn(_subkeys(self.keys, name)))  # (T, B, P, *shape)
            self._cache[k] = np.moveaxis(vals, 1, -1)  # (T, P, *shape, B)
        return self._cache[k]

    def uniform(self, t, player, name):
        return torch.from_numpy(self._all(name, "uniform", ())[t, player].copy())

    def gumbel(self, t, player, name, shape):
        return torch.from_numpy(self._all(name, "gumbel", tuple(shape))[t, player].copy())
