"""Checkpoints, metrics logs and the two training CLIs of the torch port, on
the CPU: a restored checkpoint continues bit for bit, config.json and the
metrics rows have the JAX package's layout and keys, both CLIs train,
checkpoint, resume and log, and self-play PPO learns (the port's twin of
`tests/test_ppo.py::test_ppo_sp_no_phi_threshold`)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.training import checkpoint as jcheckpoint
from overcooked_ai_tpu.training import ppo as jppo
from overcooked_ai_tpu_torch.cli import train_ppo, train_ppo_from_params
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.training import checkpoint, ppo

SMALL = dict(num_envs=2, horizon=20, num_sgd_iter=2, sgd_minibatch_size=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU learner runs many small ops, which intra-op threads do not
    speed up; beside pytest-xdist's other workers they oversubscribe the
    cores (the learning check took 6x its lone time on 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_restored_checkpoint_continues_bit_for_bit(tmp_path):
    """Save after one iteration; the next iteration from the restored state
    (net, Adam, generator, counters) equals the one of a run that never
    saved, every param and metric bit for bit."""
    cfg = ppo.PPOConfig(**SMALL)
    init_fn, train_iteration = ppo.make_ppo(from_layout_name("cramped_room"), cfg, device="cpu")
    ts, _ = train_iteration(init_fn(1))
    checkpoint.save_checkpoint(tmp_path, ts, cfg, step=1)
    ts_a, m_a = train_iteration(ts)
    ts_b, step = checkpoint.restore_checkpoint(tmp_path, init_fn(2))
    assert step == checkpoint.latest_step(tmp_path) == 1
    ts_b, m_b = train_iteration(ts_b)
    for name in m_a._fields:
        assert torch.equal(getattr(m_a, name), getattr(m_b, name)), name
    for (k, a), b in zip(ts_a.net.state_dict().items(), ts_b.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(ts_a.env_steps, ts_b.env_steps) and ts_b.env_steps.item() == 80
    assert torch.equal(ts_a.kl_coeff, ts_b.kl_coeff)
    assert torch.equal(ts_a.generator.get_state(), ts_b.generator.get_state())


def test_config_json_matches_jax(tmp_path):
    kw = dict(num_envs=3, lr=1e-4, entropy_coeff_end=0.01, reward_shaping_horizon=2e7)
    extra = {"use_lstm": False, "layout": "cramped_room"}
    jinit, _ = jppo.make_ppo(jfrom_layout_name("cramped_room"), jppo.PPOConfig(**kw))
    jcheckpoint.save_checkpoint(tmp_path / "jax", jinit(jax.random.PRNGKey(0)),
                                jppo.PPOConfig(**kw), step=7, extra=extra)
    init_fn, _ = ppo.make_ppo(from_layout_name("cramped_room"), ppo.PPOConfig(**kw), device="cpu")
    checkpoint.save_checkpoint(tmp_path / "torch", init_fn(0), ppo.PPOConfig(**kw), step=7,
                               extra=extra)
    want = json.loads((tmp_path / "jax" / "config.json").read_text())
    got = json.loads((tmp_path / "torch" / "config.json").read_text())
    assert got.keys() == want.keys() and got["latest_step"] == 7 and got["layout"] == "cramped_room"
    shared = got["config"].keys() & want["config"].keys()
    assert shared == got["config"].keys()  # every field of the port's config is a JAX one
    for k in shared - {"net"}:
        assert got["config"][k] == want["config"][k], k
    for k, v in got["config"]["net"].items():
        assert want["config"]["net"][k] == v, k


def test_metrics_rows_have_jax_keys(tmp_path):
    zeros = {name: 0.5 for name in jppo.IterMetrics._fields}
    jlog = jcheckpoint.MetricsLogger(str(tmp_path / "jax.jsonl"))
    jlog.log(3, jppo.IterMetrics(**{k: jnp.float32(v) for k, v in zeros.items()}))
    jlog.log(3, {"compile_s": 1.5})
    jlog.close()
    log = checkpoint.MetricsLogger(str(tmp_path / "torch.jsonl"))
    log.log(3, ppo.IterMetrics(**{k: torch.tensor(v) for k, v in zeros.items()}))
    log.log(3, {"compile_s": 1.5})
    log.close()
    rows = [[json.loads(line) for line in (tmp_path / f"{n}.jsonl").read_text().splitlines()]
            for n in ("jax", "torch")]
    assert rows[0] == rows[1]
    assert ppo.IterMetrics._fields == jppo.IterMetrics._fields


def _rows(path):
    return [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]


def test_train_ppo_cli_trains_checkpoints_and_resumes(tmp_path):
    out = tmp_path / "run"
    args = ["--device", "cpu", "--local-testing", "--num-sgd-iter", "2", "--out", str(out)]
    train_ppo.main(args + ["--iters", "2", "--eval-interval", "2", "--eval-games", "2"])
    assert checkpoint.latest_step(out) == 2
    train_ppo.main(args + ["--iters", "1", "--resume"])
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["latest_step"] == 3 and cfg["config"]["num_envs"] == 2
    assert (out / "step_2.pt").exists() and (out / "step_3.pt").exists()
    rows = _rows(out)
    iters = [r for r in rows if "kl" in r]
    assert [r["step"] for r in iters] == [1, 2, 3]
    assert all(np.isfinite(r["policy_loss"]) for r in iters)
    assert [r["step"] for r in rows if "eval_sparse_reward" in r] == [2]
    assert [r["step"] for r in rows if "compile_s" in r] == [1, 3]


def test_train_ppo_from_params_cli_regenerates_and_resumes(tmp_path):
    out = tmp_path / "pool"
    args = ["--device", "cpu", "--local-testing", "--pool-size", "4", "--out", str(out)]
    train_ppo_from_params.main(args + ["--iters", "2", "--regen-every", "1"])
    train_ppo_from_params.main(args + ["--iters", "1", "--resume"])
    assert checkpoint.latest_step(out) == 3
    iters = [r for r in _rows(out) if "kl" in r]
    assert [r["step"] for r in iters] == [1, 2, 3]
    assert all(r["episode_shaped_reward"] >= 0 and np.isfinite(r["kl"]) for r in iters)


def test_cli_on_cuda_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the CLIs there")
    for main in (train_ppo.main, train_ppo_from_params.main):
        with pytest.raises(SystemExit, match="no CUDA card"):
            main(["--local-testing", "--iters", "1", "--out", "unused"])


def test_ppo_sp_learns():
    """PPO self-play (no phi) on cramped_room, 12 iterations x 2 envs x 400
    steps on the CPU: the last 5 iterations' mean episode_total_reward (the
    reference CI's episode_reward_mean) is at least 5."""
    cfg = ppo.PPOConfig(num_envs=2, horizon=400, sgd_minibatch_size=400, num_sgd_iter=8,
                        entropy_coeff_start=0.0, entropy_coeff_end=0.0, lr=5e-3)
    _, hist = ppo.train(from_layout_name("cramped_room"), cfg, num_iterations=12, seed=0,
                        device="cpu")
    last5 = np.mean([m.episode_total_reward.item() for m in hist[-5:]])
    assert last5 >= 5, last5
