"""The torch port's layout-pool path against the JAX package on the CPU.

The per-lane plain step and encoding against `jax.vmap` of the JAX
`core.step.step` and `lossless_encode` over the same per-lane layouts; B4's
entries (`fused_pool_rollout_actions`, `fused_pool_rollout_random`) against
the JAX pool kernel in Pallas interpret mode (B=8, block_b=4, as
tests/test_fused_pool.py runs it), across per-lane auto-resets, for both
outer shapes and for a uniform old-dynamics pool. Every output is an integer
and must match bit for bit. A pool whose recipe tables, shaping rewards or
old-dynamics flags differ runs in the B3 entries and pool-mode
`collect_rollout`, which read each lane's tables, and raises ValueError
from `check_pool_uniform` and the B4 entries, under `python -O` too; its
packed table rows give every lane its own. B3 is in
tests/test_torch_fused_pool_train.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core.encoding import lossless_encode as jencode
from overcooked_ai_tpu.core.step import step as jstep
from overcooked_ai_tpu.ops import fused_pool as jpool
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.encoding import lossless_encode
from overcooked_ai_tpu_torch.core.env import batch_reset, env_step
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build, fused_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, BLOCK_B = 8, 4
PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]
# lanes that differ in recipe value, shaping rewards, and old dynamics with
# another cook time
MIXED = [{}, {"delivery_reward": 37},
         {"rew_shaping_params": {"PLACEMENT_IN_POT_REW": 7, "DISH_PICKUP_REWARD": 1,
                                 "SOUP_PICKUP_REWARD": 11}},
         {"old_dynamics": True, "cook_time": 5}]


def make_pools(n=6, seed=0, outer_shape=(5, 4), **cfg):
    """The same generated pool for the JAX package and the port."""
    kw = dict(outer_shape=outer_shape, prop_empty=0.95, prop_feats=0.1)
    g = gen.LayoutGenerator(rng=np.random.RandomState(seed), **kw)
    jg = jgen.LayoutGenerator(rng=np.random.RandomState(seed), **kw)
    return ([g.generate_spec(name=f"pool_{i}", **cfg) for i in range(n)],
            [jg.generate_spec(name=f"pool_{i}", **cfg) for i in range(n)])


def lanes(specs, jspecs, idx):
    jlay = jax.tree.map(lambda leaf: jnp.asarray(leaf)[..., idx], jgen.stack_layouts(jspecs))
    return gen.gather_lanes(gen.stack_layouts(specs), idx), jlay


def assert_state(got, want, msg=""):
    for name, g, w in zip(State._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {msg}")


@pytest.mark.parametrize("outer_shape", [(5, 4), (7, 5)])
def test_plain_step_and_encoding_match_vmapped_jax(outer_shape):
    """Per-lane `env_step` and `lossless_encode` against the JAX functions
    vmapped over the per-lane layout, across two auto-resets."""
    specs, jspecs = make_pools(outer_shape=outer_shape)
    lay, jlay = lanes(specs, jspecs, np.arange(B) % len(specs))
    assert len({tuple(np.asarray(lay.terrain[..., b]).ravel()) for b in range(6)}) == 6
    horizon = 20
    bstep = jax.jit(jax.vmap(jstep, in_axes=(-1, -1, -1), out_axes=-1))
    enc = jax.jit(jax.vmap(lambda lo, s: jencode(lo, s, horizon=horizon),
                           in_axes=(-1, -1), out_axes=-1))
    jstate, state = jlay.start_state, batch_reset(lay, B, "cpu")
    rng = np.random.RandomState(7)
    n_events = 0
    for t in range(2 * horizon + 5):
        a = rng.choice(6, size=(2, B), p=PROB).astype(np.int32)
        ns, info = bstep(jlay, jstate, jnp.asarray(a))
        done = ns.t >= horizon
        jstate = jax.tree.map(lambda fresh, cur: jnp.where(done, fresh, cur), jlay.start_state, ns)
        ts = env_step(lay, state, torch.from_numpy(a), horizon)
        state = ts.obs_state
        assert_state(state, jstate, f"t={t}")
        np.testing.assert_array_equal(ts.sparse_reward.numpy(), np.asarray(info.sparse_reward))
        np.testing.assert_array_equal(ts.shaped_reward.numpy(), np.asarray(info.shaped_reward))
        np.testing.assert_array_equal(ts.events.numpy(), np.asarray(info.events))
        np.testing.assert_array_equal(lossless_encode(lay, state, horizon).numpy(),
                                      np.asarray(enc(jlay, jstate)), err_msg=f"obs t={t}")
        n_events += int(ts.events.sum())
    assert n_events > 0


@pytest.mark.parametrize("outer_shape", [(5, 4), (7, 5)])
def test_pool_rollout_actions_matches_jax_kernel(outer_shape):
    """(7, 5) has 35 cells: the JAX kernel's floor mask spans two chunks."""
    specs, jspecs = make_pools(outer_shape=outer_shape)
    spec0, jspec0 = fused_pool.check_pool_uniform(specs), jpool.check_pool_uniform(jspecs)
    lay, jlay = lanes(specs, jspecs, np.arange(B) % len(specs))
    T, horizon = 90, 40  # two auto-resets
    actions = np.random.RandomState(5).choice(6, size=(T, 2, B), p=PROB).astype(np.int32)
    jfinal, jret = jpool.fused_pool_rollout_actions(
        jspec0, jlay, jlay.start_state, jnp.asarray(actions), horizon=horizon, block_b=BLOCK_B,
        interpret=True,
    )
    _build.launches.clear()
    start = batch_reset(lay, B, "cpu")
    final, ret = fused_pool.fused_pool_rollout_actions(
        spec0, lay, start, torch.from_numpy(actions), horizon=horizon
    )
    assert not _build.launches  # CPU tensors: the plain version ran
    assert_state(final, jfinal)
    np.testing.assert_array_equal(ret.numpy(), np.asarray(jret))
    assert not torch.equal(final.pos, start.pos)


def test_pool_rollout_random_matches_jax_kernel():
    """The murmur3 stream on per-lane layouts, keyed on the env index."""
    specs, jspecs = make_pools(n=4, seed=1)
    spec0, jspec0 = fused_pool.check_pool_uniform(specs), jpool.check_pool_uniform(jspecs)
    lay, jlay = lanes(specs, jspecs, np.arange(B) % len(specs))
    jfinal, jret = jpool.fused_pool_rollout_random(
        jspec0, jlay, jlay.start_state, seed=9, num_steps=50, horizon=25, block_b=BLOCK_B,
        interpret=True,
    )
    final, ret = fused_pool.fused_pool_rollout_random(
        spec0, lay, batch_reset(lay, B, "cpu"), 9, 50, horizon=25
    )
    assert_state(final, jfinal)
    np.testing.assert_array_equal(ret.numpy(), np.asarray(jret))
    assert not final.t.any()  # two horizon wraps in 50 steps


def test_old_dynamics_pool_matches_jax():
    """A uniform old-dynamics pool: soups auto-start at three items and
    INTERACT starts no cook. Against the JAX pool kernel and the vmapped
    JAX step, with a delivery inside the window."""
    specs, jspecs = make_pools(n=4, seed=5, old_dynamics=True)
    spec0, jspec0 = fused_pool.check_pool_uniform(specs), jpool.check_pool_uniform(jspecs)
    lay, jlay = lanes(specs, jspecs, np.arange(B) % len(specs))
    T, horizon = 400, 200
    actions = np.random.RandomState(11).choice(6, size=(T, 2, B), p=PROB).astype(np.int32)
    jfinal, jret = jpool.fused_pool_rollout_actions(
        jspec0, jlay, jlay.start_state, jnp.asarray(actions), horizon=horizon, block_b=BLOCK_B,
        interpret=True,
    )
    final, ret = fused_pool.fused_pool_rollout_actions(
        spec0, lay, batch_reset(lay, B, "cpu"), torch.from_numpy(actions), horizon=horizon
    )
    assert_state(final, jfinal)
    np.testing.assert_array_equal(ret.numpy(), np.asarray(jret))
    assert int(ret.sum()) > 0  # soups were cooked and delivered

    bstep = jax.jit(jax.vmap(jstep, in_axes=(-1, -1, -1), out_axes=-1))
    jstate, total = jlay.start_state, 0
    for a in actions:
        ns, info = bstep(jlay, jstate, jnp.asarray(a))
        done = ns.t >= horizon
        jstate = jax.tree.map(lambda fresh, cur: jnp.where(done, fresh, cur), jlay.start_state, ns)
        total = total + np.asarray(info.sparse_reward).sum(0)
    assert_state(final, jstate)  # 400 steps keep every stamp under the kernels' clamp
    np.testing.assert_array_equal(ret.numpy(), total)


def test_packed_table_rows_give_each_lane_its_own():
    g = gen.LayoutGenerator(rng=np.random.RandomState(5))
    specs = [g.generate_spec(name=f"m{i}", **cfg) for i, cfg in enumerate(MIXED)]
    idx = np.array([3, 0, 1, 1, 2, 3, 0, 2, 2])
    pool = fused_pool.pool_data(specs[0], gen.gather_lanes(gen.stack_layouts(specs), idx), "cpu")
    assert pool.table_rows.shape == (len(MIXED), _build.TABLE_WORDS)
    assert pool.table_rows.dtype == pool.table_idx.dtype == torch.int32
    assert not pool.uniform
    for b, i in enumerate(idx):
        want = _build.table_words(specs[i].layout)
        assert torch.equal(pool.table_rows[pool.table_idx[b]], want), b
        # the row is the RecipeTables part of the lane's own LayoutData block
        h = _build.HEADER_WORDS
        np.testing.assert_array_equal(_build.layout_words(specs[i].layout)[h:h + 52],
                                      want.numpy())
    same = fused_pool.pool_data(specs[0], gen.gather_lanes(gen.stack_layouts(specs), idx * 0),
                                "cpu")
    assert same.uniform and same.table_rows.shape[0] == 1 and not same.table_idx.any()
    # the kernels' entries refuse lane data that is not as pool_data packs it
    state = batch_reset(pool.layout, len(idx), "cpu")
    assert fused_pool._lane_pointers(pool, state)
    shifted = torch.zeros(pool.table_rows.numel() + 1, dtype=torch.int32)[1:]
    for bad in (pool._replace(table_rows=shifted.view(pool.table_rows.shape)),
                pool._replace(table_idx=pool.table_idx.long()),
                pool._replace(table_rows=pool.table_rows[:, :48]),
                pool._replace(reset_words=pool.reset_words.t().contiguous().t())):
        with pytest.raises(ValueError):
            fused_pool._lane_pointers(bad, state)


_MIXED_POOL = """
import numpy as np, torch
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.ops import fused_pool as fp
from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet
from overcooked_ai_tpu_torch.training.ppo import PPOConfig, collect_rollout

g = gen.LayoutGenerator(outer_shape=(5, 4), rng=np.random.RandomState(3))
specs = [g.generate_spec(name="a"), g.generate_spec(name="b", delivery_reward=37),
         g.generate_spec(name="c", rew_shaping_params={
             "PLACEMENT_IN_POT_REW": 7, "DISH_PICKUP_REWARD": 1, "SOUP_PICKUP_REWARD": 11}),
         g.generate_spec(name="d", old_dynamics=True)]
lay = gen.gather_lanes(gen.stack_layouts(specs), np.array([0, 1, 2, 3]))
state = batch_reset(lay, 4, "cpu")
act = torch.zeros((2, 4), dtype=torch.int32)
calls = {
    "check_pool_uniform": lambda: fp.check_pool_uniform(specs),
    "pool_data": lambda: fp.pool_data(specs[0], lay, "cpu"),
    "fused_pool_train_step": lambda: fp.fused_pool_train_step(specs[0], lay, state, act),
    "fused_pool_train_step_tiles": lambda: fp.fused_pool_train_step_tiles(
        specs[0], fp.pool_data(specs[0], lay, "cpu"), state, act),
    "fused_pool_rollout_random": lambda: fp.fused_pool_rollout_random(
        specs[0], lay, state, 0, 5),
    "fused_pool_rollout_actions": lambda: fp.fused_pool_rollout_actions(
        specs[0], lay, state, torch.zeros((5, 2, 4), dtype=torch.int32)),
    "collect_rollout": lambda: collect_rollout(
        specs, PPONet(NetConfig(), 4, 5), PPOConfig(num_envs=4, horizon=3), device="cpu"),
}
for name, call in calls.items():
    try:
        call()
    except ValueError as e:
        print(name, "ValueError", e)
    else:
        print(name, "ran")
print("asserts", "on" if __debug__ else "off")
"""


@pytest.mark.parametrize("flags", [[], ["-O"]], ids=["asserts", "no-asserts"])
def test_mixed_recipe_pool_raises_in_every_entry(flags):
    """A pool mixing recipe value, shaping rewards and old dynamics: B4's
    entries and `check_pool_uniform` refuse it (B4 reads one set of tables
    for every lane), with and without asserts; `pool_data`, the B3 entries
    and pool-mode `collect_rollout` run it, each lane under its own tables."""
    out = subprocess.run(
        [sys.executable, *flags, "-c", _MIXED_POOL], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    refused = {ln.split()[0] for ln in lines if " ValueError " in ln}
    ran = {ln.split()[0] for ln in lines if ln.endswith(" ran")}
    assert refused == {"check_pool_uniform", "fused_pool_rollout_random",
                       "fused_pool_rollout_actions"}, out.stdout
    assert ran == {"pool_data", "fused_pool_train_step", "fused_pool_train_step_tiles",
                   "collect_rollout"}, out.stdout
    assert lines[-1] == ("asserts off" if flags else "asserts on")


@pytest.mark.parametrize("entry", ["random", "actions"])
def test_tiles_entries_take_a_packed_pool(entry):
    """`fused_pool_rollout_*_tiles` on a pool packed once equal the public
    entries, which pack on every call, bit for bit; they refuse a pool
    packed for another spec, a bare layout, a mixed pool, and a state on a
    device without a kernel."""
    specs, _ = make_pools(n=4, seed=1)
    spec0 = fused_pool.check_pool_uniform(specs)
    lay = gen.gather_lanes(gen.stack_layouts(specs), np.arange(B) % len(specs))
    state = batch_reset(lay, B, "cpu")
    T, horizon = 60, 25
    acts = torch.from_numpy(
        np.random.RandomState(2).choice(6, size=(T, 2, B), p=PROB).astype(np.int32))

    def tiles(spec, pool, st=state):
        if entry == "random":
            return fused_pool.fused_pool_rollout_random_tiles(spec, pool, st, 9, T, horizon=horizon)
        return fused_pool.fused_pool_rollout_actions_tiles(spec, pool, st, acts, horizon=horizon)

    if entry == "random":
        want = fused_pool.fused_pool_rollout_random(spec0, lay, state, 9, T, horizon=horizon)
    else:
        want = fused_pool.fused_pool_rollout_actions(spec0, lay, state, acts, horizon=horizon)
    pool = fused_pool.pool_data(spec0, lay, "cpu")
    _build.launches.clear()
    got = tiles(spec0, pool)
    assert not _build.launches  # CPU tensors: the plain version ran
    assert_state(got[0], [w.numpy() for w in want[0]])
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert int(got[1].sum()) >= 0 and not got[0].t.eq(state.t).all()

    other = make_pools(n=4, seed=1)[0][0]  # the same layout, another spec object
    for bad_spec, bad_pool in ((other, pool), (spec0, lay)):
        with pytest.raises(ValueError, match="pool_data"):
            tiles(bad_spec, bad_pool)
    g = gen.LayoutGenerator(rng=np.random.RandomState(5))
    mixed = [g.generate_spec(name=f"m{i}", **cfg) for i, cfg in enumerate(MIXED)]
    mixed_lay = gen.gather_lanes(gen.stack_layouts(mixed), np.arange(B) % len(mixed))
    with pytest.raises(ValueError, match="recipe tables"):
        tiles(mixed[0], fused_pool.pool_data(mixed[0], mixed_lay, "cpu"),
              batch_reset(mixed_lay, B, "cpu"))
    meta = State(*(x.to("meta") for x in state))
    with pytest.raises(ValueError, match="no pool rollout kernel"):
        tiles(spec0, pool, meta)
