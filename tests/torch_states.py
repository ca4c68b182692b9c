"""Batches of env states for the torch port's featurize, potential and BC
tests: the states of an interact-heavy random rollout on the port's plain
step (bit for bit the JAX step, `tests/test_torch_step_env.py`), and crafted
states with objects on every kind of counter, soups idle, cooking and ready
in the pots and on counters, held objects of every kind, and counter
objects whose placement stamps tie."""

import numpy as np
import torch

import jax.numpy as jnp

from overcooked_ai_tpu.core.state import State as JState
from overcooked_ai_tpu_torch.core.constants import (
    OBJ_DISH,
    OBJ_ONION,
    OBJ_SOUP,
    OBJ_TOMATO,
    TERRAIN_COUNTER,
    TERRAIN_EMPTY,
    TERRAIN_POT,
)
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.core.step import step

PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]  # interact-heavy: soups cook, objects land


def rollout_states(layout, batch, steps, seed=0, num_players=2):
    """{t: the batch-last state after step t} for t in `steps`."""
    state = batch_reset(layout, batch, "cpu")
    rng = np.random.RandomState(seed)
    out = {}
    for t in range(max(steps) + 1):
        a = rng.choice(6, size=(num_players, batch), p=PROB).astype(np.int32)
        state, _ = step(layout, state, torch.from_numpy(a))
        if t in steps:
            out[t] = state
    return out


def _slots(rng, n=None):
    n = rng.randint(1, 4) if n is None else n
    s = np.zeros(3, np.int32)
    s[:n] = rng.choice([OBJ_ONION, OBJ_TOMATO], size=n)
    return s


def crafted_states(spec, batch, seed=0):
    """A batch-last State of `batch` crafted states of `spec`'s layout.

    Every counter holds an object with probability 0.6; each pot holds
    nothing, an idle soup of 1-3 items, a cooking or a ready soup. A third
    of the envs give all their counter objects one stamp (B1 clamps stamps
    at 2047 - HW), the rest distinct stamps in a random order.
    """
    rng = np.random.RandomState(seed)
    terrain = np.asarray(spec.layout.terrain)
    H, W = terrain.shape
    P = spec.num_players
    time_np = np.asarray(spec.time_np)
    empties = [(x, y) for y in range(H) for x in range(W) if terrain[y, x] == TERRAIN_EMPTY]
    cols = []
    for b in range(batch):
        pos = np.zeros((P, 2), np.int32)
        for i, k in enumerate(rng.choice(len(empties), size=P, replace=False)):
            pos[i] = empties[k]
        orient = rng.randint(0, 4, size=P).astype(np.int32)
        held = rng.choice([0, OBJ_ONION, OBJ_TOMATO, OBJ_DISH, OBJ_SOUP], size=P).astype(np.int32)
        held_soup = np.zeros((P, 3), np.int32)
        held_tick = np.full(P, -1, np.int32)
        for i in range(P):
            if held[i] == OBJ_SOUP:
                held_soup[i] = _slots(rng)
                held_tick[i] = rng.randint(0, 30)
        obj = np.zeros((H, W), np.int32)
        ing = np.zeros((H, W, 3), np.int32)
        tick = np.full((H, W), -1, np.int32)
        seq = np.zeros((H, W), np.int32)
        stamps = rng.permutation(np.arange(1, 800))
        same = b % 3 == 0
        for y in range(H):
            for x in range(W):
                if terrain[y, x] == TERRAIN_COUNTER and rng.rand() < 0.6:
                    code = rng.choice([OBJ_ONION, OBJ_TOMATO, OBJ_DISH, OBJ_SOUP])
                    obj[y, x] = code
                    seq[y, x] = 2047 - H * W if same else stamps[y * W + x]
                    if code == OBJ_SOUP:
                        ing[y, x] = _slots(rng)
                        tick[y, x] = rng.randint(0, 30)
                elif terrain[y, x] == TERRAIN_POT:
                    kind = rng.randint(0, 4)  # empty, idle, cooking, ready
                    if kind:
                        obj[y, x] = OBJ_SOUP
                        ing[y, x] = _slots(rng, None if kind == 1 else 3)
                        n_o = int((ing[y, x] == OBJ_ONION).sum())
                        cook = int(time_np[n_o, 3 - n_o]) if kind > 1 else 0
                        tick[y, x] = (-1 if kind == 1 else rng.randint(0, max(cook, 1))
                                      if kind == 2 else cook + rng.randint(0, 3))
        cols.append(State(pos, orient, held, held_soup, held_tick, obj, ing, tick, seq,
                          np.int32(rng.randint(0, 400))))
    return State(*(torch.from_numpy(np.stack(leaves, axis=-1)) for leaves in zip(*cols)))


def to_jax(state: State) -> JState:
    """A port State (tensors or numpy) -> the JAX package's State of jnp arrays."""
    return JState(*(jnp.asarray(np.asarray(x)) for x in state))
