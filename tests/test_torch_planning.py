"""The planner tables of the torch port against the JAX package's: motion,
first-action and per-goal tables, the greedy tables on a device, the disk
cache, the medium-level action manager and the joint tables (native library
and pure Python), equal array for array on layouts with counters between
the players."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.planning import cache as jcache
from overcooked_ai_tpu.planning import greedy_tables as jgreedy_tables
from overcooked_ai_tpu.planning import joint as jjoint
from overcooked_ai_tpu.planning import mlam as jmlam
from overcooked_ai_tpu.planning import tables as jtables
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.core.state import State, state_to_dict
from overcooked_ai_tpu_torch.core.step import step
from overcooked_ai_tpu_torch.planning import _native, cache, greedy_tables, joint, mlam, tables

LAYOUTS = ["cramped_room", "counter_circuit_o_1order", "forced_coordination"]


def _terrain(name):
    return np.asarray(from_layout_name(name).layout.terrain)


def _counters(terrain, n=3):
    """A few counter cells, as counter goals."""
    ys, xs = np.nonzero(terrain == 1)
    return [(int(x), int(y)) for x, y in zip(xs, ys)][1:1 + n]


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("with_counters", [False, True])
def test_motion_and_first_action_tables_match_jax(name, with_counters):
    terrain = _terrain(name)
    goals = _counters(terrain) if with_counters else ()
    mine, want = tables.build_motion_tables(terrain, goals), jtables.build_motion_tables(
        terrain, goals)
    np.testing.assert_array_equal(mine.feature_cost, want.feature_cost)
    np.testing.assert_array_equal(mine.point_dist, want.point_dist)
    assert mine.feature_cost.dtype == np.int32 and tables.INF_COST == jtables.INF_COST
    np.testing.assert_array_equal(greedy_tables.build_first_action_table(terrain, goals),
                                  jgreedy_tables.build_first_action_table(terrain, goals))
    assert tables.terrain_to_chars(terrain) == jtables.terrain_to_chars(terrain)


@pytest.mark.parametrize("name", ["cramped_room", "counter_circuit_o_1order"])
def test_goal_tables_match_jax(name):
    terrain = _terrain(name)
    for goals in ((), _counters(terrain, 2)):
        for mine, want in zip(greedy_tables.build_goal_tables(terrain, goals),
                              jgreedy_tables.build_goal_tables(terrain, goals)):
            np.testing.assert_array_equal(mine, want)
            assert mine.dtype == want.dtype


def test_greedy_tables_on_a_device_match_jax():
    spec, jspec = from_layout_name("forced_coordination"), jfrom_layout_name("forced_coordination")
    goals = _counters(np.asarray(spec.layout.terrain), 2)
    mine = greedy_tables.build_greedy_tables(spec, goals, device="cpu")
    want = jgreedy_tables.build_greedy_tables(jspec, goals)
    for got, ref in zip(mine, want):
        assert torch.is_tensor(got) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert isinstance(want.feature_cost, jnp.ndarray)


def test_cache_roundtrip_and_its_own_directory(tmp_path, monkeypatch):
    """Builds once, then loads the .npz; another counter-goal set is another
    file; a corrupt file is rebuilt; the default directory is the port's,
    never the JAX package's, and the port reads its own variable only."""
    terrain = _terrain("cramped_room")
    want = jtables.build_motion_tables(terrain)
    t1 = cache.cached_motion_tables(terrain, cache_dir=str(tmp_path))
    files = list(tmp_path.glob("mt_*.npz"))
    assert len(files) == 1 and files[0].name == f"mt_{jcache._key(terrain, ())}.npz"
    t2 = cache.cached_motion_tables(terrain, cache_dir=str(tmp_path))
    for got in (t1, t2):
        np.testing.assert_array_equal(got.feature_cost, want.feature_cost)
        np.testing.assert_array_equal(got.point_dist, want.point_dist)
    cache.cached_motion_tables(terrain, counter_goals=[(2, 0)], cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("mt_*.npz"))) == 2
    files[0].write_bytes(b"garbage")
    t3 = cache.cached_motion_tables(terrain, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(t3.feature_cost, want.feature_cost)
    t4 = cache.cached_motion_tables(terrain, cache_dir=str(tmp_path), force_compute=True)
    np.testing.assert_array_equal(t4.point_dist, want.point_dist)

    assert os.path.realpath(cache._DEFAULT_DIR) != os.path.realpath(jcache._DEFAULT_DIR)
    monkeypatch.setenv("OVERCOOKED_PLANNER_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("OVERCOOKED_TORCH_PLANNER_CACHE", str(tmp_path / "torch"))
    cache.cached_motion_tables(terrain)
    assert (tmp_path / "torch").is_dir() and not (tmp_path / "jax").exists()


def _rollout_state_dicts(spec, n_steps=40, batch=6, seed=0):
    """State dicts of a random, interact-heavy rollout (objects on counters)."""
    state = batch_reset(spec.layout, batch, "cpu")
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        a = rng.choice(6, size=(2, batch), p=[0.13, 0.13, 0.13, 0.13, 0.08, 0.4])
        state, _ = step(spec.layout, state, torch.from_numpy(a.astype(np.int32)))
        out += [state_to_dict(State(*(x[..., b] for x in state)), spec) for b in range(batch)]
    return out


@pytest.mark.parametrize("name", ["cramped_room", "counter_circuit_o_1order"])
def test_mlam_matches_jax(name):
    spec, jspec = from_layout_name(name), jfrom_layout_name(name)
    counters = _counters(np.asarray(spec.layout.terrain), 4)
    params = dict(mlam.NO_COUNTERS_PARAMS, counter_drop=counters, counter_pickup=counters,
                  wait_allowed=True)
    assert mlam.NO_COUNTERS_PARAMS == jmlam.NO_COUNTERS_PARAMS
    for p in (mlam.NO_COUNTERS_PARAMS, params):
        mine, want = mlam.MediumLevelActionManager(spec, p), jmlam.MediumLevelActionManager(jspec,
                                                                                          p)
        n_held = 0
        for d in _rollout_state_dicts(spec)[::7]:
            n_held += sum(pl["held_object"] is not None for pl in d["players"])
            for i in range(2):
                assert mine.get_medium_level_actions(d, i) == want.get_medium_level_actions(d, i)
        assert n_held > 0


def test_joint_tables_match_jax_native_and_python(monkeypatch):
    terrain = _terrain("cramped_room")
    assert _native.available()
    mine, want = joint.JointMotionTables(terrain), jjoint.JointMotionTables(terrain)
    np.testing.assert_array_equal(mine.dist, want.dist)
    assert mine.pairs == want.pairs
    rng = np.random.RandomState(0)
    cells = mine.cells
    for _ in range(30):
        i, j, k, m = rng.choice(len(cells), 4, replace=False)
        starts, goals = (cells[i], cells[j]), (cells[k], cells[m])
        assert mine.joint_distance(starts, goals) == want.joint_distance(starts, goals)
        assert mine.joint_plan(starts, goals) == want.joint_plan(starts, goals)
        assert joint.positions_are_joint_connected(mine, starts, goals)
    # the pure-Python tables, when the library is missing, are the same
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_load_failed", True)
    assert not _native.available() and _native.all_pairs_bfs(None, None, 1) is None
    np.testing.assert_array_equal(joint.JointMotionTables(terrain).dist, want.dist)


def test_native_bfs_matches_python_bfs():
    """all_pairs_bfs over the motion graph of a layout equals the BFS that
    `tables._bfs_from` runs from every node."""
    terrain = _terrain("forced_coordination")
    g = greedy_tables._Graph(terrain)
    n = len(g.radj)
    adj = [[] for _ in range(n)]
    for v, us in enumerate(g.radj):
        for u in us:
            adj[u].append(v)
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum([len(a) for a in adj])
    indices = np.asarray([v for a in adj for v in a], np.int32)
    got = _native.all_pairs_bfs(indptr, indices, tables.INF_COST)
    for src in range(0, n, 7):
        np.testing.assert_array_equal(got[src], tables._bfs_from(adj, src))
