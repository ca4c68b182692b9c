"""The single-env driver and the gym adapter of the torch port against the
JAX package's, on the CPU (twins of `tests/test_interop.py`).

A 400-step `cramped_room` episode under numpy-seeded interact-heavy actions
gives, at every step, the same state dict, reward, done flag and env info
(events and, at the end, the episode's game stats) as JAX's
`OvercookedEnv`; so does a 3-player layout, which the port steps only on
the CPU. The gym adapter's seats, observations and steps equal JAX's under
the same seed. On the card the env steps with B1, so it refuses another
player count and a horizon past the placement-stamp bound, which is exact:
B1's plain version keeps the last stamp of an episode at the bound and
clamps it one step further.
"""

import numpy as np
import pytest
import torch

from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.interop.gym_env import Overcooked as JOvercooked
from overcooked_ai_tpu.interop.single_env import OvercookedEnv as JOvercookedEnv
from overcooked_ai_tpu_torch.core import layout
from overcooked_ai_tpu_torch.core.constants import OBJ_ONION, TERRAIN_COUNTER
from overcooked_ai_tpu_torch.core.env import env_step
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.interop.gym_env import Overcooked
from overcooked_ai_tpu_torch.interop.single_env import OvercookedEnv, max_horizon
from overcooked_ai_tpu_torch.ops import fused_train

PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]  # interact-heavy random play


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canon(x):
    """Nested dicts, lists, tuples and numpy values as plain comparable data."""
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return _canon(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _play_both(env, jenv, steps, seed):
    rng = np.random.RandomState(seed)
    P = env.spec.num_players
    assert _canon(env.state_dict()) == _canon(jenv.state_dict())
    rewards = 0
    for t in range(steps):
        joint = rng.choice(6, size=P, p=PROB).tolist()
        _, r, done, info = env.step(joint)
        _, jr, jdone, jinfo = jenv.step(joint)
        assert (r, done) == (jr, jdone), t
        assert _canon(info) == _canon(jinfo), t
        assert _canon(env.state_dict()) == _canon(jenv.state_dict()), t
        assert env.is_done() == jenv.is_done()
        rewards += sum(info["shaped_r_by_agent"])
    return info, rewards


def test_a_400_step_episode_matches_jax():
    env = OvercookedEnv.from_layout_name("cramped_room", horizon=400, device="cpu")
    jenv = JOvercookedEnv.from_layout_name("cramped_room", horizon=400)
    info, shaped = _play_both(env, jenv, 400, seed=0)
    assert info["episode"]["ep_length"] == 400 and shaped > 0
    assert any(info["episode"]["ep_game_stats"]["potting_onion"])
    with pytest.raises(RuntimeError):
        env.step([4, 4])
    env.reset()
    assert env.t == 0 and int(env.state.t) == 0


def test_a_3_player_layout_on_the_cpu_matches_jax():
    cfg = layout.read_layout_config("multiplayer_schelling")
    cfg["grid"] = cfg["grid"].replace("4", " ")
    spec = layout.build_layout("schelling_3p", cfg)
    jspec = jlayout.build_layout("schelling_3p", dict(cfg))
    assert spec.num_players == 3
    env, jenv = OvercookedEnv(spec, horizon=60, device="cpu"), JOvercookedEnv(jspec, horizon=60)
    info, _ = _play_both(env, jenv, 60, seed=1)
    assert info["episode"]["ep_length"] == 60
    with pytest.raises(ValueError, match="B1"):
        OvercookedEnv(spec, horizon=60, device="cuda")


def test_the_encoding_is_the_envs_obs():
    """The obs the demo's NPCs read: the current state's encoding at the
    env's horizon, (P, 26, HW, 1), equal to B1's plain version's."""
    env = OvercookedEnv.from_layout_name("cramped_room", horizon=30, device="cpu")
    rng = np.random.RandomState(2)
    for _ in range(25):
        joint = rng.choice(6, size=2, p=PROB).tolist()
        before = env.state
        env.step(joint)
        want = fused_train.plain_train_step(env._layout, before, torch.tensor(
            joint, dtype=torch.int32)[:, None], 30, 31)
        assert torch.equal(env.obs, want[1])
        assert torch.equal(env.encode(), want[1][..., 0].reshape(2, 26, 4, 5))


def test_gym_adapter_matches_jax():
    env = Overcooked(OvercookedEnv.from_layout_name("cramped_room", horizon=8, device="cpu"),
                     seed=0)
    jenv = JOvercooked(JOvercookedEnv.from_layout_name("cramped_room", horizon=8), seed=0)
    assert env.observation_space == jenv.observation_space
    assert env.action_space == jenv.action_space
    rng = np.random.RandomState(3)
    for episode in range(3):
        obs, jobs = env.reset(), jenv.reset()
        for t in range(9):
            assert env.agent_idx == jenv.agent_idx
            assert obs["other_agent_env_idx"] == jobs["other_agent_env_idx"]
            assert _canon(obs["overcooked_state"]) == _canon(jobs["overcooked_state"])
            for a, b in zip(obs["both_agent_obs"], jobs["both_agent_obs"]):
                assert a.shape == (5, 4, 26) and a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            if t == 8:
                break
            act = rng.choice(6, size=2, p=PROB).tolist()
            obs, r, done, info = env.step(act)
            jobs, jr, jdone, jinfo = jenv.step(act)
            assert (r, done) == (jr, jdone) and _canon(info) == _canon(jinfo)
        assert done and info["policy_agent_idx"] == env.agent_idx


def test_card_refuses_a_horizon_past_the_stamp_bound():
    spec = layout.from_layout_name("cramped_room")
    bound = max_horizon(spec)
    assert bound == (2047 - 20) // 2
    with pytest.raises(ValueError, match="placement stamps"):
        OvercookedEnv(spec, horizon=bound + 1, device="cuda")
    OvercookedEnv(spec, horizon=bound + 1, device="cpu")  # the plain step keeps stamps whole


@pytest.mark.parametrize("over", [0, 1])
def test_the_stamp_bound_is_exact(over):
    """Player 1 drops an onion on a counter at the last step of an episode of
    `max_horizon + over` steps: its stamp, 2 * horizon, is B1's (through its
    plain version) and the plain step's alike up to the bound, and clamped
    one step past it."""
    spec = layout.from_layout_name("cramped_room")
    lay = layout.layout_on(spec.layout, "cpu")
    horizon = max_horizon(spec) + over
    start = State(*(torch.as_tensor(np.asarray(x))[..., None].clone()
                    for x in spec.layout.start_state))
    x, y = (int(v) for v in start.pos[1, :, 0])
    assert spec.layout.terrain[y - 1, x] == TERRAIN_COUNTER
    state = start._replace(orient=torch.tensor([[0], [0]], dtype=torch.int32),
                           held=torch.tensor([[0], [OBJ_ONION]], dtype=torch.int32),
                           t=torch.tensor([horizon - 1], dtype=torch.int32))
    acts = torch.tensor([[4], [5]], dtype=torch.int32)
    plain = env_step(lay, state, acts, horizon + 1).state
    b1 = fused_train.plain_train_step(lay, state, acts, horizon, horizon + 1)[0]
    assert int(plain.obj_seq[y - 1, x, 0]) == 2 * horizon
    assert int(b1.obj_seq[y - 1, x, 0]) == (2 * horizon if not over else 2047 - 20)
