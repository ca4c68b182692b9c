"""Web demo server: human-vs-AI Overcooked in the browser (port of
`overcooked_ai_tpu.demo.server`, driving the port's `demo.game`).

Stdlib-only replacement for the reference Flask/SocketIO app
(reference overcooked_demo/server/app.py:109-670): a ThreadingHTTPServer
with a JSON API + an embedded canvas frontend that polls game state (the
reference pushes `state_pong` over socket.io at 6 fps; polling at the same
rate has identical bandwidth for this payload size and removes the
socket.io/eventlet dependency).

API:
    POST /api/create {layout, npc, game_time} -> {game_id, seat}
    POST /api/join   {game_id}                -> {seat}
    POST /api/action {game_id, seat, action}
    GET  /api/state?game_id=..                -> state payload
    GET  /api/data?game_id=..                 -> recorded trajectory rows
    POST /api/experiment/save {participant, game_id, round}
    GET  /api/experiment/csv?participant=..   -> 2020-schema CSV download
    GET  /            -> game page        (static/index.html)
    GET  /tutorial    -> tutorial page    (static/tutorial.html)
    GET  /predefined  -> experiment page  (static/predefined.html)
    GET  /static/*    -> sprite renderer, page logic, styles

The pages are the parity surface of the reference's browser frontend
(static/js/index.js, tutorial.js, predefined.js + the Phaser sprite
renderer): a procedural-canvas sprite renderer (graphics.js, original
art), a 3-phase tutorial driving TutorialGame, and a scripted
multi-layout experiment whose collected CSV feeds human_data/pipeline.py
directly (tests/test_demo.py::test_experiment_csv_roundtrip).

The deploy config (`config.json`) and the pages (`static/`) are the JAX
package's demo files, read in place by path as data. The games run on
`--device` (default `cuda`: each tick one B1 launch and the NPC's inference
on the card; `cpu` runs the plain versions).

Run: python -m overcooked_ai_tpu_torch.demo.server [--port 8000] [--device cuda]
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from overcooked_ai_tpu_torch.demo.game import (
    ROOT,
    DemoGame,
    TutorialGame,
    artifact_dir,
    npc_from_kind,
)

# the JAX package's demo files: data, read by path
_DEMO_DIR = os.path.join(ROOT, "overcooked_ai_tpu", "demo")
# deploy config (reference overcooked_demo/server/config.json); env var
# OVERCOOKED_CONFIG overrides the path (reference CONF_PATH, app.py:33)
_CONF_PATH = os.environ.get("OVERCOOKED_CONFIG", os.path.join(_DEMO_DIR, "config.json"))
with open(_CONF_PATH) as _f:
    CONFIG = json.load(_f)

MAX_GAMES = int(CONFIG.get("MAX_GAMES", 10))
TICK_FPS = int(CONFIG.get("TICK_FPS", 6))  # reference app.py:291 fps=6
LAYOUTS = list(CONFIG.get("layouts", ["cramped_room"]))

_games = {}
_games_lock = threading.Lock()
# fixed pool of reusable game ids (reference app.py:69-101: FREE_IDS queue
# + FREE_MAP); an id returns to the pool on /api/leave or stale reaping
_free_ids = list(range(MAX_GAMES - 1, -1, -1))

# per-participant experiment data (reference predefined experiment flow +
# data write-out, app.py:626-658); rows accumulate across rounds and are
# served back as a 2020-schema CSV
_experiments = {}
_experiments_lock = threading.Lock()
# hard cap on retained rows per participant: a predefined experiment is
# ~5 rounds x 400 ticks; 100k bounds memory against runaway clients
_MAX_EXPERIMENT_ROWS = 100_000
_MAX_EXPERIMENT_PARTICIPANTS = 1_000  # bound memory across distinct ids


def _safe_participant(raw) -> str:
    """Normalize a client-supplied participant id to a header/filename-safe
    token (no CRLF/quote header injection via Content-Disposition)."""
    import re

    return re.sub(r"[^A-Za-z0-9_.-]", "_", str(raw)[:64]) or "anon"
_STATIC_DIR = os.path.join(_DEMO_DIR, "static")

# action index -> reference JSON action (Direction tuples / "INTERACT"),
# the joint_action format of the 2020 human-data schema
_ACTION_JSON = {0: [0, -1], 1: [0, 1], 2: [1, 0], 3: [-1, 0],
                4: [0, 0], 5: "INTERACT"}

_CSV_COLUMNS = [
    "state", "joint_action", "reward", "time_left", "score",
    "time_elapsed", "cur_gameloop", "layout", "layout_name", "trial_id",
    "player_0_id", "player_1_id", "player_0_is_human", "player_1_is_human",
]


def _experiment_rows(game, participant, round_idx, partner_kind):
    """A finished game's trajectory as 2020-schema rows (the format of
    static/human_data/dummy/dummy_2020_hh_trials.csv, consumed by
    human_data.pipeline.csv_to_df_pickle)."""
    trial_id = f"{participant}_{round_idx}"
    is_human = [s in game.human_seats for s in range(game.num_players)]
    ids = [
        participant if is_human[s] else f"npc:{partner_kind}"
        for s in range(game.num_players)
    ]
    terrain = json.dumps(game.env.spec.terrain_chars)
    rows = []
    for r in game.get_data():
        joint = json.loads(r["joint_action"])
        rows.append(
            {
                "state": r["state"],
                "joint_action": json.dumps(
                    [_ACTION_JSON[int(a)] for a in joint]
                ),
                "reward": r["reward"],
                "time_left": r.get("time_left", ""),
                "score": r["score"],
                "time_elapsed": round(r["time_elapsed"], 3),
                "cur_gameloop": r["cur_gameloop"],
                "layout": terrain,
                "layout_name": r["layout_name"],
                "trial_id": trial_id,
                "player_0_id": ids[0],
                "player_1_id": ids[1] if len(ids) > 1 else "",
                "player_0_is_human": is_human[0],
                "player_1_is_human": is_human[1]
                if len(is_human) > 1 else False,
            }
        )
    return rows


def experiment_csv(participant):
    """The participant's collected rows as CSV text (2020 schema)."""
    import csv
    import io

    with _experiments_lock:
        rows = list(_experiments.get(participant, []))
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=_CSV_COLUMNS)
    w.writeheader()
    for r in rows:
        w.writerow(r)
    return buf.getvalue()


def _tick_loop(game_id):
    """Per-game loop thread (reference play_game, app.py:618-658)."""
    while not _shutting_down:
        with _games_lock:
            game = _games.get(game_id)
        if game is None:
            return
        out = game.tick()
        if out is None or out["done"]:
            return
        time.sleep(1.0 / TICK_FPS)


_shutting_down = False


def _force_end_all_games():
    """atexit: end every live game so loop threads stop ticking (reference
    on_exit cleanup, app.py:600-610). Without this a daemon loop thread
    can be mid-dispatch while the runtime tears down at interpreter exit."""
    global _shutting_down
    _shutting_down = True
    with _games_lock:
        for g in _games.values():
            g.active = False
        _games.clear()
    time.sleep(2.5 / TICK_FPS)  # let loop threads notice and return


import atexit  # noqa: E402

atexit.register(_force_end_all_games)


def _reap_finished_locked():
    """Free ids of games that finished >60s ago (caller holds the lock)."""
    now = time.time()
    for gid, g in list(_games.items()):
        if g.is_over() and now - (g.start_time or now) > 60:
            del _games[gid]
            _free_ids.append(int(gid))


def create_game(layout="cramped_room", npc="greedy", game_time=120,
                tutorial=False, device="cuda"):
    """npc: greedy | boltzmann | ppo:<ckpt_dir> | bc:<model_dir> |
    artifact:<name> | human (trained checkpoints load as NPC policies,
    reference get_policy overcooked_demo/server/game.py:674-692);
    tutorial=True starts the phased tutorial instead (reference
    OvercookedTutorial); npc="human" creates an all-human game that stays
    pending until the second seat joins (readiness handshake, reference
    app.py:485-520). The game runs on `device`."""
    game_time = min(int(game_time), int(CONFIG.get("MAX_GAME_LENGTH", 120)))
    with _games_lock:
        if not _free_ids:
            _reap_finished_locked()
        if not _free_ids:
            raise RuntimeError("server at capacity")
        game_id = str(_free_ids.pop())
        try:
            if tutorial:
                game = TutorialGame(device=device)
            else:
                npc_policies = {}
                if npc and npc != "human":
                    npc_policies[1] = npc_from_kind(npc, layout, device=device)
                game = DemoGame(layout_name=layout, npc_policies=npc_policies,
                                game_time=game_time, device=device)
        except Exception:
            _free_ids.append(int(game_id))
            raise
        game.claimed_seats = {0}
        game.partner_kind = npc if not tutorial else "TutorialAI"
        _games[game_id] = game
    if len(game.claimed_seats) == len(game.human_seats):
        _start_game(game_id, game)
    return game_id, game


def _start_game(game_id, game):
    game.activate()
    threading.Thread(target=_tick_loop, args=(game_id,), daemon=True).start()


def join_game(game_id):
    """Claim a free human seat; the game starts once every human seat is
    claimed (reference join lobby flow, app.py:485-520)."""
    with _games_lock:
        game = _games.get(game_id)
        if game is None:
            raise KeyError("no such game")
        free = [s for s in game.human_seats if s not in game.claimed_seats]
        if not free:
            raise RuntimeError("game full")
        seat = free[0]
        game.claimed_seats.add(seat)
        ready = len(game.claimed_seats) == len(game.human_seats)
    if ready and not game.active:
        _start_game(game_id, game)
    return seat


def leave_game(game_id):
    """End a game and return its id to the pool (reference leave/disconnect
    handlers + atexit cleanup, app.py:521-610)."""
    with _games_lock:
        game = _games.pop(game_id, None)
        if game is None:
            raise KeyError("no such game")
        game.active = False
        _free_ids.append(int(game_id))
    return game


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _file(self, rel, ctype):
        try:
            with open(os.path.join(_STATIC_DIR, rel), "rb") as f:
                body = f.read()
        except OSError:
            return self._json({"error": "not found"}, 404)
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    _PAGES = {
        "/": "index.html",
        "/tutorial": "tutorial.html",
        "/predefined": "predefined.html",
    }
    _CTYPES = {
        ".html": "text/html",
        ".js": "text/javascript",
        ".css": "text/css",
    }

    def do_GET(self):
        url = urlparse(self.path)
        if url.path in self._PAGES:
            return self._file(self._PAGES[url.path], "text/html")
        if url.path.startswith("/static/"):
            rel = os.path.basename(url.path)  # flat dir, no traversal
            ext = os.path.splitext(rel)[1]
            return self._file(rel, self._CTYPES.get(ext, "text/plain"))
        if url.path == "/api/experiment/csv":
            q = parse_qs(url.query)
            participant = _safe_participant((q.get("participant") or [""])[0])
            body = experiment_csv(participant).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/csv")
            self.send_header(
                "Content-Disposition",
                f'attachment; filename="{participant}.csv"',
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/api/config":
            # deploy config for the frontend (layout list, limits) plus
            # per-layout trained-artifact availability so the NPC
            # dropdown only offers checkpoints that actually exist
            artifacts = {
                lay: [
                    name
                    for name in ("ppo_sp", "ppo_bc", "bc_proxy")
                    if os.path.isdir(artifact_dir(name, lay))
                ]
                for lay in LAYOUTS
            }
            return self._json(
                {
                    "layouts": LAYOUTS,
                    "max_games": MAX_GAMES,
                    "max_game_length": CONFIG.get("MAX_GAME_LENGTH", 120),
                    "predefined": CONFIG.get("predefined", {}),
                    "artifacts": artifacts,
                }
            )
        if url.path == "/api/debug":
            # server introspection (reference /debug route, app.py:394-430)
            with _games_lock:
                return self._json(
                    {
                        "games": {
                            gid: {
                                "layout": g.layout_name,
                                "active": g.active,
                                "score": g.score,
                                "tick": g.tick_count,
                                "over": g.is_over(),
                                "claimed_seats": sorted(g.claimed_seats),
                            }
                            for gid, g in _games.items()
                        },
                        "free_ids": sorted(_free_ids),
                        "max_games": MAX_GAMES,
                    }
                )
        q = parse_qs(url.query)
        game_id = (q.get("game_id") or [None])[0]
        with _games_lock:
            game = _games.get(game_id)
        if game is None:
            return self._json({"error": "no such game"}, 404)
        if url.path == "/api/state":
            return self._json(game.get_state_payload())
        if url.path == "/api/data":
            return self._json({"trajectory": game.get_data()})
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        url = urlparse(self.path)
        try:
            body = self._read_body()
        except json.JSONDecodeError:
            return self._json({"error": "bad json"}, 400)
        if url.path == "/api/create":
            try:
                game_id, game = create_game(
                    layout=body.get("layout", "cramped_room"),
                    npc=body.get("npc", "greedy"),
                    game_time=body.get("game_time", 120),
                    tutorial=bool(body.get("tutorial", False)),
                    device=self.server.device,
                )
            except Exception as e:  # noqa: BLE001
                return self._json({"error": str(e)}, 400)
            return self._json({"game_id": game_id, "seat": 0})
        game_id = body.get("game_id")
        with _games_lock:
            game = _games.get(game_id)
        if game is None:
            return self._json({"error": "no such game"}, 404)
        if url.path == "/api/join":
            try:
                seat = join_game(game_id)
            except (KeyError, RuntimeError) as e:
                return self._json({"error": str(e)}, 400)
            return self._json({"seat": seat, "started": game.active})
        if url.path == "/api/leave":
            try:
                leave_game(game_id)
            except KeyError as e:
                return self._json({"error": str(e)}, 404)
            return self._json({"ok": True})
        if url.path == "/api/experiment/save":
            # snapshot a finished round's rows under the participant id
            # (reference writes per-game pickles at game end, app.py:626-658)
            participant = _safe_participant(body.get("participant", "anon"))
            round_idx = int(body.get("round", 0))
            rows = _experiment_rows(
                game, participant, round_idx,
                getattr(game, "partner_kind", "greedy"),
            )
            with _experiments_lock:
                if (participant not in _experiments
                        and len(_experiments) >= _MAX_EXPERIMENT_PARTICIPANTS):
                    return self._json(
                        {"error": "participant store full"}, 503
                    )
                store = _experiments.setdefault(participant, [])
                kept = rows[: max(0, _MAX_EXPERIMENT_ROWS - len(store))]
                store.extend(kept)
            return self._json({
                "ok": True,
                "rows": len(kept),
                "truncated": len(kept) < len(rows),
            })
        if url.path == "/api/action":
            try:
                action = int(body["action"])
                if not 0 <= action <= 5:
                    raise ValueError(f"action {action} out of range 0..5")
                game.enqueue_action(int(body["seat"]), action)
            except (KeyError, ValueError) as e:
                return self._json({"error": str(e)}, 400)
            return self._json({"ok": True})
        self._json({"error": "not found"}, 404)


def serve(port=8000, device="cuda", host="0.0.0.0"):
    """The demo's HTTP server on (host, port), its games on `device` (not
    yet serving: call `serve_forever`, and `shutdown` to stop it)."""
    server = ThreadingHTTPServer((host, port), Handler)
    server.device = device
    return server


def main(port=8000, device="cuda"):
    server = serve(port, device)
    print(f"overcooked demo serving on http://localhost:{server.server_address[1]} "
          f"(games on {device})")
    server.serve_forever()


def cli(argv=None):
    """Command-line entry point (`python -m overcooked_ai_tpu_torch.demo.server`)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (B1 and the NPCs on the card) or cpu")
    args = ap.parse_args(argv)
    from overcooked_ai_tpu_torch.cli.train_ppo import check_device

    main(args.port, str(check_device(args.device)))


if __name__ == "__main__":
    cli()
