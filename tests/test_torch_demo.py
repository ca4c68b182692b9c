"""The torch port's web demo on the CPU (twins of `tests/test_demo.py`, on
the port's server with its games at `device="cpu"`), and the port's
`DemoGame` against the JAX package's: the same human action stream records
the same trajectory rows, with the committed `artifact:ppo_bc` agent (the
converted run) as the NPC picking JAX's NPC's actions under JAX's draws
replayed (`tests/torch_draws.py`).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from overcooked_ai_tpu.demo.game import DemoGame as JDemoGame
from overcooked_ai_tpu.demo.game import npc_from_kind as jnpc_from_kind
from overcooked_ai_tpu_torch.demo import server as demo_server
from overcooked_ai_tpu_torch.demo.game import DemoGame, TutorialAI, TutorialGame, npc_from_kind

from .torch_draws import KeyDraws


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demo():
    httpd = demo_server.serve(port=0, device="cpu", host="127.0.0.1")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(base, path, body):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(), method="POST")
    try:
        return json.loads(urllib.request.urlopen(req).read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def _get(base, path):
    return json.loads(urllib.request.urlopen(f"{base}{path}").read())


def _wait_ticks(base, gid, n, deadline_s=60):
    deadline = time.time() + deadline_s
    state = _get(base, f"/api/state?game_id={gid}")
    while state["state"]["timestep"] <= n and time.time() < deadline:
        time.sleep(0.5)
        state = _get(base, f"/api/state?game_id={gid}")
    return state


def test_demo_game_round_trip(demo):
    out = _post(demo, "/api/create", {"layout": "cramped_room", "game_time": 300})
    gid = out["game_id"]
    assert out["seat"] == 0
    assert _post(demo, "/api/action", {"game_id": gid, "seat": 0, "action": 0})["ok"]
    assert "error" in _post(demo, "/api/action", {"game_id": gid, "seat": 0, "action": 99})
    assert "error" in _post(demo, "/api/action", {"game_id": gid, "seat": 1, "action": 0})
    state = _wait_ticks(demo, gid, 5)
    assert state["state"]["timestep"] > 5
    data = _get(demo, f"/api/data?game_id={gid}")
    assert len(data["trajectory"]) >= state["state"]["timestep"]
    assert {"state", "joint_action", "reward", "score"} <= set(data["trajectory"][0])
    # the greedy NPC moved or picked something up
    npc = [json.loads(r["state"])["players"][1] for r in data["trajectory"]] + [
        state["state"]["players"][1]]
    assert any(tuple(p["position"]) != (3, 1) or p["held_object"] for p in npc)
    page = urllib.request.urlopen(f"{demo}/").read().decode()
    assert "canvas" in page
    assert _post(demo, "/api/leave", {"game_id": gid})["ok"]


def test_tutorial_phases():
    game = TutorialGame(device="cpu")
    game.activate()
    assert game.curr_phase == 0 and game.env.device.type == "cpu"
    assert game.tick()["phase"] == 0
    payload = game.get_state_payload()
    assert payload["tutorial"] and payload["phase"] == 0
    for _ in range(40):
        game.tick()
    assert game.score <= 0  # the AI's deliveries do not count
    game.score = 20  # the human scores in phase 0 -> phase 1 and its layout
    game.tick()
    assert game.curr_phase == 1 and game.layout_name == "tutorial_1" and game.score == 0
    ai = TutorialAI()
    ai.reset()
    assert [ai.action() for _ in TutorialAI.COOK_SOUP_LOOP] == TutorialAI.COOK_SOUP_LOOP
    ai.reset()
    assert ai.action() == 4
    ai.reset()
    assert ai.action() == TutorialAI.COOK_SOUP_COOP_LOOP[0]


def test_tutorial_via_server(demo):
    gid = _post(demo, "/api/create", {"tutorial": True})["game_id"]
    time.sleep(0.6)
    payload = _get(demo, f"/api/state?game_id={gid}")
    assert payload["tutorial"] is True and payload["phase"] == 0
    _post(demo, "/api/leave", {"game_id": gid})


def test_trained_npc_loading(tmp_path):
    """A checkpoint the port trains loads as a demo NPC."""
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.training.checkpoint import save_checkpoint
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig, make_ppo

    spec = from_layout_name("cramped_room")
    cfg = PPOConfig(num_envs=2, horizon=10, sgd_minibatch_size=20, num_sgd_iter=1, lr=1e-4)
    init_fn, train_it = make_ppo(spec, cfg, device="cpu")
    ts, _ = train_it(init_fn(0))
    save_checkpoint(str(tmp_path / "ppo"), ts, cfg, step=1)
    game = DemoGame(layout_name="cramped_room", game_time=300, device="cpu",
                    npc_policies={1: npc_from_kind(f"ppo:{tmp_path / 'ppo'}", "cramped_room",
                                                   device="cpu")})
    game.activate()
    for _ in range(5):
        out = game.tick()
    assert out is not None
    acts = [json.loads(r["joint_action"])[1] for r in game.get_data()]
    assert len(acts) == 5 and all(0 <= a <= 5 for a in acts)


def test_lobby_id_pool_and_handshake(demo):
    gid = _post(demo, "/api/create", {"layout": "cramped_room", "npc": "human",
                                      "game_time": 300})["game_id"]
    assert gid.isdigit()
    assert _get(demo, f"/api/state?game_id={gid}")["done"] is False
    joined = _post(demo, "/api/join", {"game_id": gid})
    assert joined["seat"] == 1 and joined["started"] is True
    assert "error" in _post(demo, "/api/join", {"game_id": gid})
    assert _post(demo, "/api/leave", {"game_id": gid})["ok"]
    try:
        gone = _get(demo, f"/api/state?game_id={gid}")
    except urllib.error.HTTPError as e:
        gone = json.loads(e.read())
    assert gone.get("error")
    # a create that fails returns its id to the pool
    free = len(demo_server._free_ids)
    bad = _post(demo, "/api/create", {"layout": "cramped_room", "npc": "no_such_kind"})
    assert "error" in bad and len(demo_server._free_ids) == free
    created = []
    while True:
        r = _post(demo, "/api/create", {"npc": "human"})
        if "error" in r:
            break
        created.append(r["game_id"])
    assert len(created) == free and len(set(created)) == len(created)
    _post(demo, "/api/leave", {"game_id": created[0]})
    again = _post(demo, "/api/create", {"npc": "human"})
    assert again.get("game_id") == created[0]
    for g in created:
        _post(demo, "/api/leave", {"game_id": g})


def test_debug_route_and_data_writeout(demo, tmp_path):
    import pickle

    gid = _post(demo, "/api/create", {"layout": "cramped_room", "game_time": 300})["game_id"]
    dbg = _get(demo, "/api/debug")
    assert gid in dbg["games"] and dbg["games"][gid]["layout"] == "cramped_room"
    assert dbg["max_games"] == demo_server.MAX_GAMES
    _wait_ticks(demo, gid, 1)
    with demo_server._games_lock:
        game = demo_server._games[gid]
    rows = game.get_data(write_dir=str(tmp_path))
    assert rows
    with open(next(tmp_path.glob("*.pkl")), "rb") as f:
        assert pickle.load(f)["trajectory"][0]["layout_name"] == "cramped_room"
    _post(demo, "/api/leave", {"game_id": gid})


def test_config_route(demo):
    """The JAX package's deploy config, served with the committed agents of
    each layout: the converted PPO runs and the BC proxies."""
    conf = _get(demo, "/api/config")
    assert "cramped_room" in conf["layouts"]
    assert conf["max_games"] == demo_server.MAX_GAMES and conf["max_game_length"] >= 1
    for lay in ("cramped_room", "asymmetric_advantages", "coordination_ring",
                "forced_coordination", "counter_circuit_o_1order"):
        assert conf["artifacts"][lay] == ["ppo_sp", "ppo_bc", "bc_proxy"]
    assert conf["artifacts"]["pipeline"] == []


def test_static_pages_served(demo):
    for path, marker in [("/", "graphics.js"), ("/tutorial", "Phase 1"),
                         ("/predefined", "experiment"), ("/static/graphics.js", "drawChef"),
                         ("/static/app.js", "OCApp"), ("/static/style.css", "canvas#game")]:
        assert marker in urllib.request.urlopen(f"{demo}{path}").read().decode(), path


def test_experiment_csv_roundtrip(demo, tmp_path):
    """Rounds played through the HTTP API, saved under a participant id, come
    back as a 2020-schema CSV that the port's human-data pipeline cleans,
    featurizes and clones."""
    participant = "ptest42"
    for rnd in range(2):
        gid = _post(demo, "/api/create", {"layout": "cramped_room", "npc": "greedy",
                                          "game_time": 300})["game_id"]
        deadline, k = time.time() + 60, 0
        state = _get(demo, f"/api/state?game_id={gid}")
        while state["state"]["timestep"] < 12 and time.time() < deadline:
            _post(demo, "/api/action", {"game_id": gid, "seat": 0,
                                        "action": [0, 2, 5, 3, 5][k % 5]})
            k += 1
            time.sleep(0.1)
            state = _get(demo, f"/api/state?game_id={gid}")
        saved = _post(demo, "/api/experiment/save", {"participant": participant,
                                                     "game_id": gid, "round": rnd})
        assert saved["ok"] and saved["rows"] >= 12
        _post(demo, "/api/leave", {"game_id": gid})
    csv_text = urllib.request.urlopen(
        f"{demo}/api/experiment/csv?participant={participant}").read().decode()
    assert csv_text.splitlines()[0] == (
        "state,joint_action,reward,time_left,score,time_elapsed,cur_gameloop,layout,"
        "layout_name,trial_id,player_0_id,player_1_id,player_0_is_human,player_1_is_human")
    csv_path = tmp_path / "collected.csv"
    csv_path.write_text(csv_text)

    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.human_data.pipeline import (
        csv_to_df_pickle,
        featurize_trajectories,
        trials_to_trajectories,
    )
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
    from overcooked_ai_tpu_torch.training.bc import BCConfig, train_bc_model

    df = csv_to_df_pickle(str(csv_path), str(tmp_path), "demo_collected",
                          button_presses_threshold=0.0, perform_train_test_split=False)
    assert len(df) >= 24
    spec = from_layout_name("cramped_room")
    trajs = trials_to_trajectories(df, spec, layouts=["cramped_room"])
    assert len(trajs) == 2
    obs, actions = featurize_trajectories(
        spec, build_motion_tables(spec.layout.terrain).feature_cost,
        [{"states": t["states"], "actions": t["actions"]} for t in trajs], device="cpu")
    assert obs.shape[0] == actions.shape[0] >= 48
    _, history = train_bc_model(obs, actions, BCConfig(epochs=2, early_stopping_patience=2),
                                seed=0, device="cpu")
    assert history["loss"][-1] <= history["loss"][0] * 1.5


class JaxNPCDraws:
    """JAX's demo NPC draws a key a call, PRNGKey(rng.randint(2**31)) from a
    RandomState(0) (`overcooked_ai_tpu/demo/game.py`): the same keys, call
    by call, through the port's `Draws` interface."""

    def __init__(self):
        self.rng = np.random.RandomState(0)

    def at(self, t, player):
        return KeyDraws(np.asarray(jax.random.PRNGKey(self.rng.randint(2**31)))[None])


@pytest.mark.parametrize("npc", ["artifact:ppo_bc", "greedy", None])
def test_demo_game_records_the_jax_trajectory(npc):
    """Human seats fed the same action stream, and the NPC (none: two human
    seats) under JAX's draws, record the same rows as JAX's DemoGame."""
    ticks = 60 if npc else 120
    mine_npc = {} if npc is None else {
        1: npc_from_kind(npc, "cramped_room", device="cpu", draws=JaxNPCDraws())}
    jax_npc = {} if npc is None else {1: jnpc_from_kind(npc, "cramped_room")}
    game = DemoGame("cramped_room", npc_policies=mine_npc, game_time=300, device="cpu")
    jgame = JDemoGame("cramped_room", npc_policies=jax_npc, game_time=300)
    rng = np.random.RandomState(4)
    for g in (game, jgame):
        g.activate()
    for _ in range(ticks):
        for seat in game.human_seats:
            a = int(rng.choice(6, p=[0.13, 0.13, 0.13, 0.13, 0.08, 0.4]))
            game.enqueue_action(seat, a)
            jgame.enqueue_action(seat, a)
        game.tick()
        jgame.tick()
    keys = ("state", "joint_action", "reward", "score", "cur_gameloop", "layout_name")
    rows, jrows = game.get_data(), jgame.get_data()
    assert len(rows) == len(jrows) == ticks
    for t, (r, j) in enumerate(zip(rows, jrows)):
        assert {k: r[k] for k in keys} == {k: j[k] for k in keys}, t
    npc_acts = [json.loads(r["joint_action"])[1] for r in rows]
    assert len(set(npc_acts)) > 1
