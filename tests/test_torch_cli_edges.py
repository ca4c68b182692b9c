"""The torch port's edge CLIs on the CPU, and the converter beside them:
`convert_jax_checkpoints.py` writes a run's committed files again;
`move_agents` copies a converted run (`artifacts_torch/`), a run the port
trains and a BC proxy, and refuses a JAX orbax run, a directory without
its step file, a bad BC directory and an existing destination;
`plot_metrics` writes a PNG from the JAX package's and the port's metrics
logs; `eval_artifact` plays the artifact's cells in the JAX results schema
and holds them against a JAX table by three combined standard errors. (The
JAX package's twins have no tests, and its `move_agents.validate` looks
for all-digit step entries where its own `save_checkpoint` writes
`step_{n}`, so it refuses every real run.)
"""

import json
import os
import shutil

import pytest
import torch

from overcooked_ai_tpu_torch.cli import eval_artifact, move_agents, plot_metrics
from overcooked_ai_tpu_torch.training.checkpoint import MetricsLogger

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONVERTED = os.path.join(ROOT, "artifacts_torch", "eval_artifact", "ppo_sp_cramped_room")
JAX_RUN = os.path.join(ROOT, "runs", "eval_artifact", "ppo_sp_cramped_room")
BC_PROXY = os.path.join(ROOT, "runs", "eval_artifact", "bc_proxy_cramped_room")


@pytest.mark.parametrize("src, kind", [(CONVERTED, "ppo"), (BC_PROXY, "bc"),
                                       (os.path.join(ROOT, "artifacts_torch", "r4_lstm_cramped"),
                                        "ppo")])
def test_move_agents_copies_a_run_the_port_loads(tmp_path, src, kind):
    dst = tmp_path / "agents" / "npc"
    move_agents.main([src, str(dst), "--kind", kind])
    assert sorted(os.listdir(dst)) == sorted(os.listdir(src))
    with pytest.raises(SystemExit, match="exists"):
        move_agents.main([src, str(dst), "--kind", kind])
    move_agents.main([src, str(dst), "--kind", kind, "--overwrite"])
    from overcooked_ai_tpu_torch.demo.game import npc_from_kind

    npc = npc_from_kind(f"{kind}:{dst}", "cramped_room", device="cpu")
    from overcooked_ai_tpu_torch.interop.single_env import OvercookedEnv

    assert 0 <= npc.act(OvercookedEnv.from_layout_name("cramped_room", device="cpu"), 1) < 6


def test_move_agents_copies_a_run_the_port_trained(tmp_path):
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.training.checkpoint import save_checkpoint
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig, make_ppo

    cfg = PPOConfig(num_envs=2, horizon=10)
    init_fn, _ = make_ppo(from_layout_name("cramped_room"), cfg, device="cpu")
    save_checkpoint(tmp_path / "run", init_fn(0), cfg, step=3)
    move_agents.validate(str(tmp_path / "run"), "ppo")
    assert torch.load(tmp_path / "run" / "step_3.pt", weights_only=True)["net"]


def test_move_agents_refuses_what_the_port_cannot_load(tmp_path):
    with pytest.raises(SystemExit, match="convert_jax_checkpoints"):
        move_agents.validate(JAX_RUN, "ppo")  # an orbax run
    bad = tmp_path / "bad"
    shutil.copytree(CONVERTED, bad)
    os.remove(next(bad.glob("step_*.pt")))
    with pytest.raises(SystemExit, match="no step_"):
        move_agents.validate(str(bad), "ppo")
    os.remove(bad / "config.json")
    with pytest.raises(SystemExit, match="config.json"):
        move_agents.validate(str(bad), "ppo")
    with pytest.raises(SystemExit, match="not a BC dir"):
        move_agents.validate(CONVERTED, "bc")
    with pytest.raises(SystemExit, match="unknown kind"):
        move_agents.validate(CONVERTED, "lstm")
    with pytest.raises(SystemExit, match="not a directory"):
        move_agents.main([str(tmp_path / "missing"), str(tmp_path / "dst")])
    assert not (tmp_path / "dst").exists()


def test_plot_metrics_writes_a_png(tmp_path):
    port_run = tmp_path / "port_run"
    log = MetricsLogger(str(port_run / "metrics.jsonl"))
    for step in range(1, 4):
        log.log(step, {"episode_sparse_reward": torch.tensor(float(step)),
                       "episode_total_reward": torch.tensor(2.0 * step)})
    log.close()
    out = tmp_path / "curves.png"
    assert plot_metrics.main([JAX_RUN, str(port_run), "--out", str(out)]) == str(out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert len(plot_metrics.load_metrics(str(port_run / "metrics.jsonl"))) == 3


def test_eval_artifact_cells_and_the_comparison(tmp_path):
    out = tmp_path / "results.json"
    summary = eval_artifact.main([
        "--device", "cpu", "--games", "2", "--horizon", "40", "--layouts", "cramped_room",
        "--cells", "PPO_SP+PPO_SP", "BC+greedy", "--out", str(out),
        "--compare", os.path.join(ROOT, "eval_matrix_results.json")])
    with open(out) as f:
        saved = json.load(f)
    assert saved["results"] == summary["results"]
    assert saved["dynamics"] == "new" and saved["games_per_pair"] == 2
    cells = saved["results"]["cramped_room"]
    assert set(cells) == {"PPO_SP+PPO_SP", "BC+greedy"}
    for cell in cells.values():
        assert cell["games"] == 2 and cell["b1_launches"] == 0  # CPU: B1's plain version
        assert {"mean", "std", "wall_s"} <= set(cell)
    assert saved["comparison"]["cells"] == 2
    ref = {"games_per_pair": 10, "results": {"L": {
        "a": {"mean": 10.0, "std": 3.0}, "b": {"mean": 10.0, "std": 0.0},
        "c": {"mean": 10.0, "std": 3.0}}}}
    mine = {"L": {"a": {"mean": 12.0, "std": 3.0, "games": 100},
                  "b": {"mean": 12.0, "std": 0.0, "games": 100},
                  "c": {"mean": 14.0, "std": 3.0, "games": 100}}}
    rows = {r[1]: r for r in eval_artifact.compare(mine, ref)}
    assert rows["a"][5] is True and rows["b"][5] is None and rows["c"][5] is False
    assert rows["a"][4] == pytest.approx((9 / 10 + 9 / 100) ** 0.5)


def test_the_converter_writes_the_committed_files(tmp_path):
    """`convert_jax_checkpoints.py` on a run writes what is committed: the
    same config.json and the same tensors in `step_{n}.pt`."""
    import convert_jax_checkpoints

    run = "eval_artifact_old/ppo_bc_counter_circuit_o_1order"
    out = convert_jax_checkpoints.out_dir_of(os.path.join(ROOT, "runs", run), str(tmp_path))
    assert out == os.path.join(str(tmp_path), run)
    _, step = convert_jax_checkpoints.convert_run(os.path.join(ROOT, "runs", run), out)
    for name in ("config.json",):
        with open(os.path.join(out, name)) as f, open(os.path.join(os.path.join(ROOT, "artifacts_torch", run), name)) as g:
            assert json.load(f) == json.load(g)
    got, want = (torch.load(os.path.join(d, f"step_{step}.pt"), map_location="cpu",
                            weights_only=True) for d in (out, os.path.join(ROOT, "artifacts_torch", run)))
    assert got.keys() == want.keys()
    for name, x in want["net"].items():
        assert torch.equal(got["net"][name], x), name
    for i, st in want["opt"]["state"].items():
        for k, x in st.items():
            assert torch.equal(got["opt"]["state"][i][k], x), (i, k)
    assert (got["env_steps"], got["kl_coeff"]) == (want["env_steps"], want["kl_coeff"])
