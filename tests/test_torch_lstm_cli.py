"""`--use-lstm` in the torch port's two training CLIs, on the CPU: both
train the recurrent learner, checkpoint with `use_lstm` in config.json and
resume; the checkpoint plays as a stateful `ppo:` agent; a restored
recurrent checkpoint continues bit for bit; and the JAX CLIs' refusals
stand (`--regen-every` with `--use-lstm`, `--use-lstm` with `--use-phi` in
the from-params CLI), in the JAX words."""

import json

import numpy as np
import pytest
import torch

from overcooked_ai_tpu_torch.agents import loading
from overcooked_ai_tpu_torch.cli import train_ppo, train_ppo_from_params
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import checkpoint, ppo, ppo_lstm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(path):
    return [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]


def test_train_ppo_use_lstm_trains_evaluates_and_resumes(tmp_path):
    out = tmp_path / "run"
    args = ["--device", "cpu", "--local-testing", "--use-lstm", "--num-sgd-iter", "2", "--out",
            str(out)]
    train_ppo.main(args + ["--iters", "2", "--eval-interval", "2", "--eval-games", "2"])
    train_ppo.main(args + ["--iters", "1", "--resume"])
    meta = json.loads((out / "config.json").read_text())
    assert meta["use_lstm"] and meta["latest_step"] == 3 and meta["layout"] == "cramped_room"
    iters = [r for r in _rows(out) if "kl" in r]
    assert [r["step"] for r in iters] == [1, 2, 3]
    assert all(np.isfinite(r["policy_loss"]) for r in iters)
    assert [r["step"] for r in _rows(out) if "eval_sparse_reward" in r] == [2]
    spec = from_layout_name("cramped_room")
    agent = loading.build_agent(f"ppo:{out}", spec, build_motion_tables(spec.layout.terrain),
                                "cpu")
    assert agent.stateful and agent.policy.horizon == 400


def test_train_ppo_from_params_use_lstm_trains_a_fixed_pool(tmp_path):
    out = tmp_path / "pool"
    train_ppo_from_params.main(["--device", "cpu", "--local-testing", "--use-lstm",
                                "--pool-size", "4", "--iters", "1", "--out", str(out)])
    meta = json.loads((out / "config.json").read_text())
    assert meta["use_lstm"] and meta["latest_step"] == 1
    (row,) = [r for r in _rows(out) if "kl" in r]
    assert row["episode_shaped_reward"] >= 0 and np.isfinite(row["kl"])


@pytest.mark.parametrize("flags,words", [
    (["--use-lstm", "--regen-every", "1"], "--regen-every requires plain PPO (phi/lstm pool "
                                           "tables are precomputed for a fixed pool)"),
    (["--use-phi", "--regen-every", "1"], "--regen-every requires plain PPO"),
    (["--use-lstm", "--use-phi"], "lstm+phi combination not wired yet")])
def test_from_params_refusals(flags, words, capsys):
    with pytest.raises(SystemExit):
        train_ppo_from_params.parse_args(flags)
    assert words in capsys.readouterr().err


def test_restored_lstm_checkpoint_continues_bit_for_bit(tmp_path):
    cfg = ppo.PPOConfig(num_envs=2, horizon=20, num_sgd_iter=2, sgd_minibatch_size=10)
    init_fn, train_iteration = ppo_lstm.make_ppo_lstm(from_layout_name("cramped_room"), cfg,
                                                      device="cpu")
    ts, _ = train_iteration(init_fn(1))
    checkpoint.save_checkpoint(tmp_path, ts, cfg, step=1, extra={"use_lstm": True})
    ts_a, m_a = train_iteration(ts)
    ts_b, step = checkpoint.restore_checkpoint(tmp_path, init_fn(2))
    ts_b, m_b = train_iteration(ts_b)
    assert step == 1
    for name in m_a._fields:
        assert torch.equal(getattr(m_a, name), getattr(m_b, name)), name
    for (k, a), b in zip(ts_a.net.state_dict().items(), ts_b.net.state_dict().values()):
        assert torch.equal(a, b), k
    net = checkpoint.load_policy_net(tmp_path, 4, 5, "cpu")
    assert type(net).__name__ == "LSTMPPONet" and not net.training
