"""The human-aware entry points of the torch port, tiny and on the CPU:
`cli.train_bc_proxy` (greedy and PPO demonstrators), `cli.train_ppo` with
`--bc-model / --bc-schedule / --use-phi / --phi-event-mix`,
`cli.train_ppo_from_params --use-phi`, and `cli.eval_matrix` with the
committed proxy `bc:runs/r4_bc/bc_proxy_cramped_room` (the JAX package's
format). Every CLI's `--device` defaults to `cuda`."""

import json
import os

import pytest
import torch

from overcooked_ai_tpu_torch.agents.loading import build_agent
from overcooked_ai_tpu_torch.cli import eval_matrix, train_bc_proxy, train_ppo, train_ppo_from_params
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import bc, checkpoint, ppo

from .test_torch_bc import CRAMPED


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_bc_proxy_clones_greedy_and_ppo_demonstrators(tmp_path):
    tiny = ["--device", "cpu", "--layouts", "cramped_room", "--num-games", "2", "--horizon",
            "30", "--epochs", "2"]
    (model_dir,) = train_bc_proxy.main(tiny + ["--out", str(tmp_path / "greedy")])
    assert model_dir == os.path.join(str(tmp_path / "greedy"), "bc_proxy_cramped_room")
    params, cfg = bc.load_bc_model(model_dir)
    meta = json.loads(open(os.path.join(model_dir, "metadata.json")).read())
    assert cfg.epochs == 2 and meta["obs_dim"] == 96 and "greedy" in meta["source"]
    assert os.path.exists(os.path.join(model_dir, "params.pt"))
    spec = from_layout_name("cramped_room")
    init_fn, _ = ppo.make_ppo(spec, ppo.PPOConfig(num_envs=2), device="cpu")
    ckpt = tmp_path / "ppo"
    checkpoint.save_checkpoint(ckpt, init_fn(0), ppo.PPOConfig(num_envs=2), step=1,
                               extra={"use_lstm": False})
    (ppo_dir,) = train_bc_proxy.main(tiny + ["--out", str(tmp_path / "from_ppo"),
                                             "--from-ppo", str(ckpt)])
    meta = json.loads(open(os.path.join(ppo_dir, "metadata.json")).read())
    assert "PPO demonstrations" in meta["source"] and meta["final_train_loss"] > 0
    agent = build_agent(f"bc:{ppo_dir}", spec, build_motion_tables(spec.layout.terrain), "cpu")
    assert not agent.stateful


def test_train_ppo_with_a_bc_partner_and_phi(tmp_path):
    run = tmp_path / "run"
    train_ppo.main(["--device", "cpu", "--local-testing", "--iters", "1", "--out", str(run),
                    "--bc-model", CRAMPED, "--bc-schedule", "0:0.5", "--use-phi",
                    "--phi-event-mix", "--eval-interval", "1", "--eval-games", "2",
                    "--num-sgd-iter", "1"])
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    it = [r for r in rows if "kl" in r]
    assert len(it) == 1 and it[0]["bc_factor"] == 0.5
    assert [r for r in rows if "eval_sparse_reward" in r]
    cfg = json.loads(open(run / "config.json").read())["config"]
    assert cfg["use_phi"] and cfg["phi_event_mix"] and cfg["lr"] == 5e-4
    assert cfg["bc_schedule"][0] == [0.0, 0.5] and cfg["bc_schedule"][-1][1] == 0.5


def test_train_ppo_flags_and_the_bc_schedule():
    assert train_ppo.parse_bc_schedule("0:0, 4e6:1") == ((0.0, 0.0), (4e6, 1.0),
                                                          (float("inf"), 1.0))
    assert train_ppo.parse_bc_schedule(None) == ppo.PPOConfig().bc_schedule
    assert train_ppo.parse_args([]).lr == 5e-5
    assert train_ppo.parse_args(["--use-phi"]).lr == 5e-4
    assert train_ppo.parse_args(["--use-phi", "--lr", "1e-3"]).lr == 1e-3
    with pytest.raises(SystemExit):
        train_ppo.parse_args(["--bc-schedule", "0:1"])  # no --bc-model


def test_train_ppo_from_params_with_phi(tmp_path):
    run = tmp_path / "pool"
    train_ppo_from_params.main(["--device", "cpu", "--local-testing", "--iters", "1",
                                "--use-phi", "--pool-size", "3", "--out", str(run)])
    assert json.loads(open(run / "config.json").read())["config"]["use_phi"]
    with pytest.raises(SystemExit):  # phi's tables belong to a fixed pool
        train_ppo_from_params.parse_args(["--use-phi", "--regen-every", "2"])


def test_eval_matrix_plays_the_committed_proxy(tmp_path):
    out = tmp_path / "m.json"
    results = eval_matrix.main(["--device", "cpu", "--layouts", "cramped_room", "--agents",
                                f"bc:{CRAMPED}", "stay", "--games", "2", "--horizon", "60",
                                "--out", str(out)])
    assert len(results) == 4 and json.loads(out.read_text()) == results
    assert all(v["games"] == 2 for v in results.values())


def test_entry_points_default_to_cuda():
    for mod, args in ((train_bc_proxy, []), (train_ppo, []), (train_ppo_from_params, []),
                      (eval_matrix, [])):
        assert mod.parse_args(args).device == "cuda", mod.__name__
