"""Agent-pair evaluation of the torch port against the JAX package, on the
CPU: `run_agent_pair` (greedy vs greedy, PPO vs greedy, Boltzmann vs
random) with JAX's draws replayed from its own key tree
(`tests/torch_draws.py`): states, actions, sparse and shaped rewards and
events bit for bit, PPO logits within 1e-5; the reference trajectory format,
`check_trajectories` (a corrupted step raises), trajectory save/load and the
statistics helpers; `VariableMDPEvaluator`; `build_agent` for every kind,
those that raise included; and both eval CLIs with `--device cpu`."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.agents import agents as jagents
from overcooked_ai_tpu.agents import evaluation as jevaluation
from overcooked_ai_tpu.core.encoding import lossless_encode as jencode
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.planning.greedy_tables import build_goal_tables as jbuild_goal_tables
from overcooked_ai_tpu.planning.greedy_tables import build_greedy_tables as jbuild_greedy_tables
from overcooked_ai_tpu.training import networks as jnetworks
from overcooked_ai_tpu_torch.agents import agents, evaluation, loading
from overcooked_ai_tpu_torch.cli import eval_matrix, eval_pool
from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS, lossless_encode
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build
from overcooked_ai_tpu_torch.planning.greedy_tables import build_goal_tables, build_greedy_tables
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import checkpoint, convert, networks, ppo

from .torch_draws import JaxKeyDraws

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: intra-op threads only oversubscribe the workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _greedy_pair(spec, jspec, **kw):
    jkw = dict(kw)
    if kw:
        kw["goal_tables"] = build_goal_tables(spec.layout.terrain)
        jkw["goal_tables"] = jbuild_goal_tables(jspec.layout.terrain)
    mine = evaluation.greedy_agent_fn(agents.make_greedy_human_model(
        spec, build_greedy_tables(spec, device="cpu"), **kw))
    want = jevaluation.greedy_agent_fn(jagents.make_greedy_human_model(
        jspec, jbuild_greedy_tables(jspec), **jkw))
    return mine, want


def _assert_same_traj(got, want):
    for name, a, b in zip(State._fields, got["state"], want["state"]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"state.{name}")
    for k in ("actions", "sparse", "shaped", "events"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].shape == np.asarray(want[k]).shape


def _run_both(name, pair, jpair, games, horizon, seed):
    spec, jspec = from_layout_name(name), jfrom_layout_name(name)
    _build.launches.clear()
    got = evaluation.run_agent_pair(spec, pair, num_games=games, horizon=horizon, seed=seed,
                                    device="cpu", draws=JaxKeyDraws(seed, horizon, games))
    assert not _build.launches  # CPU tensors: B1's plain version
    want = jevaluation.run_agent_pair(jspec, jpair, num_games=games, horizon=horizon,
                                      seed=seed)
    _assert_same_traj(got, want)
    return spec, jspec, got, want


_PAIR_RUNS = {}


def _greedy_run(name):
    """A greedy pair's run on both sides (3 games x 80 steps), once a module."""
    if name not in _PAIR_RUNS:
        spec, jspec = from_layout_name(name), jfrom_layout_name(name)
        mine, want = _greedy_pair(spec, jspec)
        _PAIR_RUNS[name] = _run_both(name, [mine, mine], [want, want], 3, 80, 5)
    return _PAIR_RUNS[name]


@pytest.mark.parametrize("name", ["cramped_room", "counter_circuit_o_1order"])
def test_greedy_pair_matches_jax(name):
    *_, got, _ = _greedy_run(name)
    assert got["sparse"].sum() > 0 or name != "cramped_room"
    assert got["events"].dtype == bool and got["state"].t[-1].tolist() == [80] * 3


def test_boltzmann_vs_random_matches_jax():
    name = "counter_circuit_o_1order"
    spec, jspec = from_layout_name(name), jfrom_layout_name(name)
    mine, want = _greedy_pair(spec, jspec, hl_boltzmann_rational=True,
                              ll_boltzmann_rational=True)
    _run_both(name, [mine, evaluation.stateless(agents.random_agent)],
              [want, jevaluation.stateless(jagents.random_agent)], 3, 50, 2)


def test_ppo_vs_greedy_matches_jax():
    """The same params on both sides (`params_from_jax`); the PPO agent
    encodes at a horizon of 60 in a 50-step run, so its urgency layer is
    rewritten from B1's (run horizon) encoding."""
    name, enc_h, T, G = "cramped_room", 60, 50, 2
    spec, jspec = from_layout_name(name), jfrom_layout_name(name)
    jnet = jnetworks.PPONet(jnetworks.NetConfig())
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 5, NUM_LAYERS), jnp.int32))
    net = networks.PPONet(networks.NetConfig(), 4, 5)
    net.load_state_dict(convert.params_from_jax(jax.device_get(params)))

    def jpolicy(key, layout, state, idx):
        x = jnp.transpose(jencode(layout, state, horizon=enc_h)[idx], (1, 2, 0))[None]
        return jax.random.categorical(key, jnet.apply(params, x)[0][0]).astype(jnp.int32)

    mine_g, want_g = _greedy_pair(spec, jspec)
    mine_p = loading.ppo_agent_fn(net, enc_h)
    *_, got, _ = _run_both(name, [mine_p, mine_g], [jevaluation.stateless(jpolicy), want_g],
                           G, T, 11)
    # logits on the run's states: the port's from its encoding at the run's
    # horizon, rewritten; JAX's encoded at enc_h
    states = State(*(torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, 0, -2).reshape(x.shape[1:-1] + (-1,)))) for x in got["state"]))
    obs = lossless_encode(spec.layout, states, T, torch.int8).reshape(2, NUM_LAYERS, 20, -1)
    with torch.no_grad():
        mine_logits = mine_p.policy.logits(states, obs, 0).numpy()
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jstates = State(*(jnp.asarray(x.numpy()) for x in states))
    enc = jax.vmap(lambda s: jencode(jlay, s, horizon=enc_h)[0], in_axes=-1)(jstates)
    want_logits = np.asarray(jnet.apply(params, jnp.transpose(enc, (0, 2, 3, 1)))[0])
    np.testing.assert_allclose(mine_logits, want_logits, rtol=0, atol=TOL)
    urgent = states.t.numpy() >= enc_h - 40
    assert urgent.any() and (~urgent).any()


def test_stateful_agent_threads_its_carry():
    class Counter:
        def __call__(self, draws, layout, state, idx, carry, obs=None):
            return (carry % 5).to(torch.int32), carry + 1

    agent = evaluation.AgentFn(policy=Counter(), stateful=True,
                               init_carry=lambda b, d: torch.zeros((b,), dtype=torch.int64))
    stay = evaluation.stateless(agents.stay_agent)
    traj = evaluation.run_agent_pair(from_layout_name("cramped_room"), [agent, stay],
                                     num_games=2, horizon=12, device="cpu")
    np.testing.assert_array_equal(traj["actions"][:, 0], np.arange(12)[:, None].repeat(2, 1) % 5)
    assert (traj["actions"][:, 1] == 4).all()


def test_reference_format_check_and_helpers_match_jax(tmp_path):
    T, G = 80, 3
    spec, jspec, got, jtraj = _greedy_run("cramped_room")
    ref = evaluation.trajectories_to_reference_format(spec, got, horizon=T)
    jref = jevaluation.trajectories_to_reference_format(jspec, jtraj, horizon=T)
    assert json.loads(json.dumps(ref)) == json.loads(json.dumps(jref, default=list))
    assert ref["ep_states"][0][5]["timestep"] == 5 and len(ref["ep_actions"][0]) == T
    evaluation.check_trajectories(ref, spec, device="cpu")

    # a corrupted state or reward raises
    bad = json.loads(json.dumps(ref))
    bad["ep_states"][1][10]["players"][0]["position"] = [1, 1]
    with pytest.raises(AssertionError, match="episode 1 step 9"):
        evaluation.check_trajectories(bad, spec, device="cpu")
    bad = json.loads(json.dumps(ref))
    bad["ep_rewards"][0][3] += 20
    with pytest.raises(AssertionError, match="reward"):
        evaluation.check_trajectories(bad, spec, device="cpu")
    with pytest.raises(AssertionError, match="missing"):
        evaluation.check_trajectories({"ep_states": []}, spec, device="cpu")

    path = str(tmp_path / "traj.json")
    evaluation.save_trajectories(ref, path)
    loaded = evaluation.load_trajectories(path)
    evaluation.check_trajectories(loaded, spec, device="cpu")
    assert loaded == json.loads(json.dumps(ref))

    for b in range(G):
        mine_stats = evaluation.game_stats_from_traj(got, b)
        want_stats = jevaluation.game_stats_from_traj(jax.device_get(jtraj), b)
        assert mine_stats.keys() == want_stats.keys()
        for k in mine_stats:
            np.testing.assert_equal(mine_stats[k], want_stats[k])
    for fn in ("append_trajectories",):
        assert getattr(evaluation, fn)(ref, ref) == getattr(jevaluation, fn)(ref, ref)
    assert evaluation.append_trajectories({}, {}) == {}
    assert len(evaluation.append_trajectories(None, ref)["ep_returns"]) == G
    assert evaluation.get_empty_trajectory() == jevaluation.get_empty_trajectory()
    np.testing.assert_array_equal(evaluation.get_discounted_rewards(ref, 0.9),
                                  jevaluation.get_discounted_rewards(ref, 0.9))
    for i in range(2):
        assert (evaluation.proportion_stuck_time(ref, i, 3)
                == jevaluation.proportion_stuck_time(jref, i, 3))
    assert evaluation.DEFAULT_TRAJ_KEYS == jevaluation.DEFAULT_TRAJ_KEYS


def _greedy_factory(spec):
    agent = loading.build_agent("greedy", spec, build_motion_tables(spec.layout.terrain), "cpu")
    return [agent, agent]


def test_variable_mdp_evaluator():
    """The evaluators pick the JAX evaluators' layouts, and each game is the
    run_agent_pair of its layout with seed + game."""
    from overcooked_ai_tpu.core.layout import from_layout_name as jfl

    names = ["cramped_room", "forced_coordination", "counter_circuit_o_1order"]
    freq = [0.2, 0.5, 0.3]
    cases = [
        (evaluation.VariableMDPEvaluator.from_mdp_lst([from_layout_name(n) for n in names], freq),
         jevaluation.VariableMDPEvaluator.from_mdp_lst([jfl(n) for n in names], freq)),
        (evaluation.VariableMDPEvaluator.from_mdp_params_finite(3, {"prop_feats": 0.2}, seed=4),
         jevaluation.VariableMDPEvaluator.from_mdp_params_finite(3, {"prop_feats": 0.2}, seed=4)),
        (evaluation.VariableMDPEvaluator.from_mdp_params_infinite(seed=6),
         jevaluation.VariableMDPEvaluator.from_mdp_params_infinite(seed=6)),
    ]
    for mine, want in cases:
        rng_a, rng_b = np.random.RandomState(1), np.random.RandomState(1)
        for g in range(4):
            a, b = mine._spec_fn(g, rng_a), want._spec_fn(g, rng_b)
            assert a.name == b.name and a.terrain_chars == b.terrain_chars
    out = cases[0][0].evaluate(_greedy_factory, num_games=2, horizon=30, seed=3, device="cpu")
    rng = np.random.RandomState(3)
    for g, game in enumerate(out):
        spec = from_layout_name(names[rng.choice(3, p=freq)])
        assert game["spec"].name == spec.name
        traj = evaluation.run_agent_pair(spec, _greedy_factory(spec), horizon=30, seed=3 + g,
                                         device="cpu")
        np.testing.assert_array_equal(game["traj"]["actions"], traj["actions"])
        assert game["ep_return"] == int(traj["sparse"].sum())
    gen = cases[2][0].evaluate(_greedy_factory, num_games=2, horizon=10, device="cpu")
    assert gen[0]["spec"].name != gen[1]["spec"].name
    with pytest.raises(ValueError):
        evaluation.VariableMDPEvaluator.from_mdp_lst(names, [0.5, 0.5])
    with pytest.raises(ValueError):
        evaluation.VariableMDPEvaluator.from_mdp_params_finite(float("inf"))


def _ppo_checkpoint(path, spec, horizon=200):
    cfg = ppo.PPOConfig(num_envs=2, horizon=horizon)
    init_fn, _ = ppo.make_ppo(spec, cfg, device="cpu")
    ts = init_fn(5)
    checkpoint.save_checkpoint(path, ts, cfg, step=3, extra={"use_lstm": False})
    return ts


@pytest.mark.parametrize("kind", ["greedy", "boltzmann", "random", "stay", "ppo"])
def test_build_agent_kinds(kind, tmp_path):
    spec = from_layout_name("cramped_room")
    tables = build_motion_tables(spec.layout.terrain)
    if kind == "ppo":
        ts = _ppo_checkpoint(tmp_path, spec)
        kind = f"ppo:{tmp_path}"
    agent = loading.build_agent(kind, spec, tables, "cpu")
    if kind.startswith("ppo:"):
        assert agent.needs_obs and agent.policy.horizon == 200
        for a, b in zip(agent.policy.net.state_dict().values(), ts.net.state_dict().values()):
            assert torch.equal(a, b)
    traj = evaluation.run_agent_pair(spec, [agent, agent], num_games=2, horizon=25,
                                     device="cpu")
    assert traj["actions"].shape == (25, 2, 2)
    assert ((traj["actions"] >= 0) & (traj["actions"] < 6)).all()
    if kind == "stay":
        assert (traj["actions"] == 4).all()


def test_build_agent_kinds_that_raise(tmp_path):
    spec = from_layout_name("cramped_room")
    tables = build_motion_tables(spec.layout.terrain)
    with pytest.raises(FileNotFoundError, match="some/dir"):  # a missing BC directory
        loading.build_agent("bc:some/dir", spec, tables, "cpu")
    with pytest.raises(ValueError, match="unknown agent kind"):
        loading.build_agent("scripted", spec, tables, "cpu")
    with pytest.raises(ValueError, match="3-onion"):
        loading.build_agent("greedy", from_layout_name("counter_circuit"), tables, "cpu")
    lstm, orbax = tmp_path / "lstm", tmp_path / "orbax"
    _ppo_checkpoint(lstm, spec)
    meta = json.loads((lstm / "config.json").read_text())
    (lstm / "config.json").write_text(json.dumps(dict(meta, use_lstm=True)))
    with pytest.raises(ValueError, match="does not hold LSTMPPONet params"):
        loading.build_agent(f"ppo:{lstm}", spec, tables, "cpu")  # a PPONet labelled use_lstm
    orbax.mkdir()  # config.json beside no step_{n}.pt, as in a JAX run directory
    (orbax / "config.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="orbax"):
        loading.build_agent(f"ppo:{orbax}", spec, tables, "cpu")


def test_eval_clis_on_the_cpu(tmp_path, capsys):
    spec = from_layout_name("cramped_room")
    ckpt = tmp_path / "ckpt"
    _ppo_checkpoint(ckpt, spec)
    out = tmp_path / "matrix.json"
    eval_matrix.main(["--device", "cpu", "--layouts", "cramped_room", "--agents", "greedy",
                      "stay", "bc:x", "--games", "2", "--horizon", "30", "--out", str(out)])
    results = json.loads(out.read_text())
    assert sorted(results) == sorted(f"cramped_room:{a}+{b}" for a in ("greedy", "stay")
                                     for b in ("greedy", "stay"))
    assert results["cramped_room:stay+stay"] == {"mean": 0.0, "std": 0.0, "games": 2}
    assert "skip bc:x" in capsys.readouterr().out
    pool_out = tmp_path / "pool" / "pool.json"
    summary = eval_pool.main(["--device", "cpu", "--ckpt", str(ckpt), "--pool-size", "2",
                              "--games", "1", "--horizon", "20", "--out", str(pool_out)])
    saved = json.loads(pool_out.read_text())
    assert set(saved["results"]) == set(eval_pool.PAIRS) == set(summary["results"])
    assert all(len(v) == 2 for v in saved["per_layout"].values())
    assert eval_matrix.parse_args([]).out.startswith("runs_torch" + os.sep)
    assert eval_pool.parse_args(["--ckpt", "x"]).device == "cuda"
