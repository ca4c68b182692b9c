"""Behavior cloning in the torch port (`training/bc.py`, `training/_msgpack.py`,
`human_data/`) against the JAX package, on the CPU.

- The msgpack reader equals flax's on the five committed BC proxies, leaf
  for leaf and bit for bit; `bc_params_from_jax` gives logits within 1e-6.
- `train_bc_model` from JAX's init, on the same data and seed: the same
  epochs run (early stopping included), the losses within 1e-5 relative
  and the params within 1e-5 (float32 sums in another order).
- The save/load round trip, and `load_bc_model` on the JAX directories.
- The partners (`bc_policy_batch`, `_pool`) and the agent (`bc_policy_fn`)
  take JAX's actions under JAX's draws replayed: JAX's `categorical` is
  the argmax of the logits plus Gumbel noise from the key.
- The human-data pipeline and compat on `tests/fixtures/human_data/`, and
  `rollout_to_bc_trajectories` / `featurize_trajectories`, equal to JAX's.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest
import torch
from flax.serialization import from_bytes, msgpack_restore

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.human_data import compat as jcompat
from overcooked_ai_tpu.human_data import pipeline as jpipe
from overcooked_ai_tpu.training import bc as jbc
from overcooked_ai_tpu_torch.agents.evaluation import run_agent_pair, stateless
from overcooked_ai_tpu_torch.agents.agents import random_agent
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.featurize import featurize_batch
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.human_data import compat, pipeline
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import bc
from overcooked_ai_tpu_torch.training._msgpack import read_msgpack
from overcooked_ai_tpu_torch.training.convert import bc_params_from_jax

from .torch_draws import KeyDraws
from .torch_states import crafted_states, rollout_states, to_jax

PROXIES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "runs", "r4_bc", "*")))
CRAMPED = [d for d in PROXIES if d.endswith("bc_proxy_cramped_room")][0]
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "human_data")
CSV_2020 = os.path.join(FIXTURES, "synthetic_2020_hh_trials.csv")
PICKLE_2019 = os.path.join(FIXTURES, "synthetic_2019_hh_trials_all.pickle")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops, which intra-op threads do not speed up beside
    pytest-xdist's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def test_msgpack_reader_equals_flax_on_every_committed_proxy():
    assert len(PROXIES) == 5
    for d in PROXIES:
        with open(os.path.join(d, "params.msgpack"), "rb") as f:
            data = f.read()
        got, want = _flat(read_msgpack(data)), _flat(msgpack_restore(data))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, (d, path)
            assert g.tobytes() == np.asarray(w).tobytes(), (d, path)


def _proxy_states(name="cramped_room"):
    spec = from_layout_name(name)
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    states = list(rollout_states(spec.layout, 16, (20, 150), seed=2).values())
    return spec, fc, states + [crafted_states(spec, 16, seed=3)]


def test_converted_logits_match_jax_on_the_proxy_and_a_fresh_init():
    jparams, jcfg = jbc.load_bc_model(CRAMPED)
    params, cfg = bc.load_bc_model(CRAMPED)
    assert cfg == bc.BCConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    spec, fc, states = _proxy_states()
    fresh = jbc.BCNet(jcfg).init(jax.random.PRNGKey(4), jnp.zeros((1, 96)))
    for jp in (jparams, fresh):
        net = bc.bc_net(bc_params_from_jax(jax.device_get(jp)), cfg, "cpu")
        for state in states:
            x = featurize_batch(spec.layout, fc, state).reshape(-1, 96)
            with torch.no_grad():
                got = net(x).numpy()
            want = np.asarray(jbc.BCNet(jcfg).apply(jp, jnp.asarray(x.numpy())))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _bc_data(n=700, seed=0, noisy_labels=False):
    """Featurized cramped_room states with greedy-ish labels: the closest
    onion's direction, or random labels (the validation loss then rises
    early, and early stopping ends the run)."""
    spec, fc, _ = _proxy_states()
    state = rollout_states(spec.layout, n // 2, (90,), seed=seed)[90]
    obs = featurize_batch(spec.layout, fc, state).reshape(-1, 96).numpy()
    rng = np.random.RandomState(seed)
    if noisy_labels:
        act = rng.randint(0, 6, size=len(obs))
    else:
        act = np.where(obs[:, 8] > 0, 2, np.where(obs[:, 8] < 0, 3, np.where(
            obs[:, 9] > 0, 1, np.where(obs[:, 9] < 0, 0, 5))))
    return obs.astype(np.float32), act.astype(np.int32)


@pytest.mark.parametrize("kind,epochs,patience,weights", [
    ("two_epochs", 2, 20, False), ("class_weights", 2, 20, True),
    ("early_stop", 40, 2, False)])
def test_train_bc_model_matches_jax(kind, epochs, patience, weights):
    obs, act = _bc_data(noisy_labels=kind == "early_stop")
    cfg = bc.BCConfig(epochs=epochs, early_stopping_patience=patience,
                      use_class_weights=weights)
    jcfg = jbc.BCConfig(epochs=epochs, early_stopping_patience=patience,
                        use_class_weights=weights)
    jparams, jhist = jbc.train_bc_model(obs, act, jcfg, seed=5)
    jinit = jbc.BCNet(jcfg).init(jax.random.PRNGKey(5), jnp.zeros((1, obs.shape[1])))
    params, hist = bc.train_bc_model(obs, act, cfg, seed=5, device="cpu",
                                     init_params=bc_params_from_jax(jax.device_get(jinit)))
    assert len(hist["loss"]) == len(jhist["loss"])
    if kind == "early_stop":
        assert len(hist["loss"]) < epochs
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-5, err_msg=key)
    want = bc_params_from_jax(jax.device_get(jparams))
    assert params.keys() == want.keys()
    assert max(float((params[k] - want[k]).abs().max()) for k in want) <= 1e-5


def test_save_load_round_trip_and_the_lstm_refusal(tmp_path):
    params, cfg = bc.load_bc_model(CRAMPED)
    bc.save_bc_model(tmp_path / "m", params, cfg, metadata={"layout": "cramped_room"})
    back, cfg2 = bc.load_bc_model(tmp_path / "m")
    assert cfg2 == cfg and back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)
    assert not os.path.exists(tmp_path / "m" / "params.msgpack")
    with open(os.path.join(CRAMPED, "params.msgpack"), "rb") as f:
        jparams = from_bytes(jbc.BCNet(jbc.BCConfig()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 96))), f.read())
    want = bc_params_from_jax(jax.device_get(jparams))
    assert all(torch.equal(params[k], want[k]) for k in want)
    # the MLP net no longer refuses the flag; the MLP trainer and the loader
    # do, as JAX's (train_bc_lstm trains the recurrent net)
    assert bc.BCNet(bc.BCConfig(use_lstm=True), 96).logits.in_features == 64
    with pytest.raises(ValueError, match="use train_bc_lstm"):
        bc.train_bc_model(np.zeros((4, 96), np.float32), np.zeros(4, np.int32),
                          bc.BCConfig(use_lstm=True), device="cpu")
    bc.save_bc_model(tmp_path / "r", params, bc.BCConfig(use_lstm=True))
    with pytest.raises(ValueError, match="use_lstm"):
        bc.load_bc_model(tmp_path / "r")


def _gumbel_sample(key):
    """JAX's `categorical(key, logits)` on the port's logits."""
    def sample(logits):
        g = np.asarray(jax.random.gumbel(key, tuple(logits.shape)))
        return torch.argmax(logits + torch.from_numpy(g), -1)
    return sample


def test_partner_actions_match_jax_under_replayed_draws():
    jparams, jcfg = jbc.load_bc_model(CRAMPED)
    params, cfg = bc.load_bc_model(CRAMPED)
    spec, fc, states = _proxy_states()
    jspec = jfrom_layout_name("cramped_room")
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    for stochastic in (True, False):
        mine = bc.bc_policy_batch(spec, fc, params, cfg, stochastic)
        jpol = jax.jit(jbc.bc_policy_batch(jspec, fc, jparams, jcfg, stochastic))
        for k, state in enumerate(states):
            key = jax.random.PRNGKey(10 + k)
            got = mine(_gumbel_sample(key), spec.layout, state)
            want = np.asarray(jpol(key, jlay, to_jax(state)))
            assert got.dtype == torch.int32 and got.shape == (2, state.obj.shape[-1])
            np.testing.assert_array_equal(got.numpy(), want)


def test_pool_partner_actions_match_jax():
    jparams, jcfg = jbc.load_bc_model(CRAMPED)
    params, cfg = bc.load_bc_model(CRAMPED)
    g, jg = (m.LayoutGenerator(rng=np.random.RandomState(2)) for m in (gen, jgen))
    specs = [g.generate_spec(name=f"g{i}") for i in range(4)]
    jspecs = [jg.generate_spec(name=f"g{i}") for i in range(4)]
    fcs = [build_motion_tables(s.layout.terrain).feature_cost for s in specs]
    B = 24
    idx = np.random.RandomState(1).randint(0, 4, size=B)
    lanes = gen.gather_lanes(gen.stack_layouts(specs), idx)
    jlanes = jax.tree.map(lambda x: jnp.asarray(x)[..., idx], jgen.stack_layouts(jspecs))
    mine = bc.bc_policy_batch_pool(specs, fcs, params, cfg)
    jpol = jax.jit(jbc.bc_policy_batch_pool(jspecs, fcs, jparams, jcfg))
    for k, state in enumerate(rollout_states(lanes, B, (10, 80), seed=3).values()):
        key = jax.random.PRNGKey(30 + k)
        got = mine(_gumbel_sample(key), lanes, state, torch.from_numpy(idx))
        want = np.asarray(jpol(key, jlanes, to_jax(state), jnp.asarray(idx)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_agent_actions_match_jax_per_game():
    """`bc_policy_fn` as an agent: game b draws from keys[b], as
    `run_agent_pair`'s vmapped JAX agent does."""
    jparams, jcfg = jbc.load_bc_model(CRAMPED)
    params, cfg = bc.load_bc_model(CRAMPED)
    spec, fc, states = _proxy_states()
    jspec = jfrom_layout_name("cramped_room")
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jfn = jbc.bc_policy_fn(jspec, fc, jparams, jcfg)
    mine = bc.bc_policy_fn(spec, fc, params, cfg)
    per_game = [jax.jit(jax.vmap(lambda kk, s, i=i: jfn(kk, jlay, s, i), in_axes=(0, -1)))
                for i in (0, 1)]
    for k, state in enumerate(states):
        keys = jax.random.split(jax.random.PRNGKey(50 + k), state.obj.shape[-1])
        for i in (0, 1):
            got = mine(KeyDraws(keys), spec.layout, state, i)
            want = per_game[i](keys, to_jax(state))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _frames_equal(a, b):
    pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True))


def test_pipeline_and_compat_match_jax_on_the_fixtures(tmp_path):
    df = pipeline.load_trials(CSV_2020)
    _frames_equal(pipeline.format_trials_df(df), jpipe.format_trials_df(df))
    _frames_equal(pipeline.format_trials_df(df, clip_400=True),
                  jpipe.format_trials_df(df, clip_400=True))
    formatted = jpipe.format_trials_df(df)
    _frames_equal(pipeline.filter_trials(formatted, 0.5), jpipe.filter_trials(formatted, 0.5))
    for thr in (0.0, 0.5):
        (tmp_path / str(thr)).mkdir()
        got = pipeline.csv_to_df_pickle(CSV_2020, str(tmp_path / str(thr)), "t", thr,
                                        perform_train_test_split=False)
        want = jpipe.csv_to_df_pickle(CSV_2020, str(tmp_path), "j", thr,
                                      perform_train_test_split=False)
        _frames_equal(got, want)
    doubled = pd.concat([formatted, formatted.assign(trial_id=formatted["trial_id"].astype(str)
                                                     + "_b")])
    got, want = (m.train_test_split_trials(doubled, 0.5, seed=3) for m in (pipeline, jpipe))
    assert sorted(got) == sorted(want)
    for layout in want:
        for part in ("train", "test"):
            _frames_equal(got[layout][part], want[layout][part])
    for ja in ('[[0, -1], "interact"]', "[[1, 0], [0, 0]]", '["INTERACT", [0, 1]]',
               "[(0, -1), 'interact']"):
        assert pipeline.parse_joint_action(ja) == jpipe.parse_joint_action(ja)

    old = pd.read_pickle(PICKLE_2019)
    rows = old.to_dict("records")
    repaired = compat.repair_old_dynamics_rows(rows)
    assert len(repaired) > len(rows) and repaired == jcompat.repair_old_dynamics_rows(rows)
    # the 2019 schema: worker ids and leader flags, no trial or player ids
    raw = old.drop(columns=["trial_id", "player_0_is_human", "player_1_is_human"]).assign(
        workerid_num=old["trial_id"].factorize()[0] // 2,
        is_leader=np.arange(len(old)) % 5 != 0)
    for human_ai in (False, True):
        _frames_equal(compat.forward_port_2019_dataframe(raw, human_ai),
                      jcompat.forward_port_2019_dataframe(raw, human_ai))

    for name in sorted(set(df["layout_name"])):
        spec, jspec = from_layout_name(name), jfrom_layout_name(name)
        fc = build_motion_tables(spec.layout.terrain).feature_cost
        trajs = pipeline.trials_to_trajectories(df, spec)
        jtrajs = jpipe.trials_to_trajectories(df, jspec)
        assert [t["trial_id"] for t in trajs] == [t["trial_id"] for t in jtrajs]
        for t, jt in zip(trajs, jtrajs):
            assert t["score"] == jt["score"]
            np.testing.assert_array_equal(t["actions"], jt["actions"])
            for s, js in zip(t["states"], jt["states"]):
                assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(s, js))
        got = pipeline.get_human_human_data(spec, fc, CSV_2020, device="cpu")
        want = jpipe.get_human_human_data(jspec, fc, CSV_2020)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_rollout_to_bc_trajectories_and_featurize_match_jax():
    spec, jspec = from_layout_name("cramped_room"), jfrom_layout_name("cramped_room")
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    rand = stateless(random_agent)
    traj = run_agent_pair(spec, [rand, rand], num_games=3, horizon=30, seed=2, device="cpu")
    for seats in (None, [1]):
        trajs = pipeline.rollout_to_bc_trajectories(spec, traj, 3, 30, seats)
        jtrajs = jpipe.rollout_to_bc_trajectories(
            jspec, dict(traj, state=to_jax(traj["state"])), 3, 30, seats)
        assert len(trajs) == len(jtrajs) == 3
        for t, jt in zip(trajs, jtrajs):
            assert t.get("seats") == jt.get("seats")
            np.testing.assert_array_equal(t["actions"], jt["actions"])
            for s, js in zip(t["states"], jt["states"]):
                assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(s, js))
        got = pipeline.featurize_trajectories(spec, fc, trajs, device="cpu", chunk=40)
        want = jpipe.featurize_trajectories(jspec, fc, jtrajs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_bc_net_defaults_to_the_card():
    """`bc_net`'s device defaults to "cuda", as every entry point's does:
    without a card the default raises, it never falls back to the CPU."""
    params, cfg = bc.load_bc_model(CRAMPED)
    assert bc.bc_net(params, cfg, "cpu").logits.weight.device.type == "cpu"
    if torch.cuda.is_available():
        assert bc.bc_net(params, cfg).logits.weight.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            bc.bc_net(params, cfg)
