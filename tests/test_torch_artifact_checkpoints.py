"""The JAX package's trained runs, converted to the torch port's format by
`convert_jax_checkpoints.py` and committed under `artifacts_torch/`, against
the JAX package on the CPU (the port's twin of
`tests/test_artifact_checkpoints.py`).

Every committed `step_{n}.pt` holds, bit for bit, what a fresh JAX restore
of its run gives through `training/convert.train_state_from_jax`: the net,
Adam's moments and step, and the counters; its config.json names the run's
layout, step, net family and horizon. A JAX orbax directory still raises
in `load_policy_net`, naming the converter. The converted agents playing
against JAX's are in `test_torch_artifact_play.py`.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.training import checkpoint as jcheckpoint
from overcooked_ai_tpu.training.networks import NetConfig as JNetConfig
from overcooked_ai_tpu.training.ppo import PPOConfig as JPPOConfig
from overcooked_ai_tpu.training.ppo import make_ppo as jmake_ppo
from overcooked_ai_tpu.training.ppo_lstm import make_ppo_lstm as jmake_ppo_lstm
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.training import checkpoint
from overcooked_ai_tpu_torch.training.convert import train_state_from_jax
from overcooked_ai_tpu_torch.training.networks import NetConfig
from overcooked_ai_tpu_torch.training.ppo import PPOConfig, make_ppo
from overcooked_ai_tpu_torch.training.ppo_lstm import make_ppo_lstm

ROOT = os.path.join(os.path.dirname(__file__), "..")
LAYOUTS = ["cramped_room", "asymmetric_advantages", "coordination_ring",
           "forced_coordination", "counter_circuit_o_1order"]
RUNS = ([f"{art}/ppo_{kind}_{layout}" for art in ("eval_artifact", "eval_artifact_old")
         for kind in ("sp", "bc") for layout in LAYOUTS] + ["r4_lstm_cramped"])


def jax_dir(run):
    return os.path.join(ROOT, "runs", run)


def port_dir(run):
    return os.path.join(ROOT, "artifacts_torch", run)


_TEMPLATES = {}


def _jax_template(layout, net, use_lstm):
    """A JAX TrainState of the run's shapes, as `agents/loading.py` builds it."""
    key = (layout, json.dumps(net, sort_keys=True), use_lstm)
    if key not in _TEMPLATES:
        cfg = JPPOConfig(num_envs=2, net=JNetConfig(**net))
        init_fn, _ = (jmake_ppo_lstm if use_lstm else jmake_ppo)(jfrom_layout_name(layout), cfg)
        _TEMPLATES[key] = init_fn(jax.random.PRNGKey(0))
    return _TEMPLATES[key]


def test_the_converted_runs_are_committed():
    assert len(RUNS) == 21
    for run in RUNS:
        assert os.path.isdir(jax_dir(run)), run
        with open(os.path.join(port_dir(run), "config.json")) as f:
            meta = json.load(f)
        assert os.path.isfile(os.path.join(port_dir(run), f"step_{meta['latest_step']}.pt"))


@pytest.mark.parametrize("run", RUNS)
def test_committed_checkpoint_is_the_jax_restore(run):
    with open(os.path.join(jax_dir(run), "config.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(port_dir(run), "config.json")) as f:
        meta = json.load(f)
    use_lstm = bool(jmeta.get("use_lstm"))
    assert (meta["latest_step"], meta["use_lstm"], meta["layout"]) == (
        jmeta["latest_step"], use_lstm, jmeta["layout"])
    assert meta["config"]["net"] == jmeta["config"]["net"]
    assert meta["config"]["horizon"] == jmeta["config"]["horizon"]
    jts, step = jcheckpoint.restore_checkpoint(
        jax_dir(run), _jax_template(jmeta["layout"], jmeta["config"]["net"], use_lstm))
    assert step == jmeta["latest_step"]
    spec = from_layout_name(jmeta["layout"])
    cfg = PPOConfig(num_envs=2, net=NetConfig(**jmeta["config"]["net"]))
    init_fn, _ = (make_ppo_lstm if use_lstm else make_ppo)(spec, cfg, device="cpu")
    ts = train_state_from_jax(jax.device_get(jts), init_fn(0))
    saved = torch.load(os.path.join(port_dir(run), f"step_{step}.pt"), map_location="cpu",
                       weights_only=True)
    want = ts.net.state_dict()
    assert saved["net"].keys() == want.keys()
    for name, x in want.items():
        assert torch.equal(saved["net"][name], x), name
    opt = ts.opt.state_dict()["state"]
    assert saved["opt"]["state"].keys() == opt.keys()
    for i, st in opt.items():
        for k, x in st.items():
            assert torch.equal(saved["opt"]["state"][i][k], x), (i, k)
    assert saved["env_steps"] == float(np.asarray(jts.env_steps))
    assert saved["kl_coeff"] == float(np.float32(np.asarray(jts.kl_coeff)))
    # the agent loads the same net
    net = checkpoint.load_policy_net(port_dir(run), spec.height, spec.width, "cpu")
    assert type(net).__name__ == ("LSTMPPONet" if use_lstm else "PPONet")
    for name, x in net.state_dict().items():
        assert torch.equal(x, want[name]), name


def test_a_jax_orbax_directory_still_raises():
    with pytest.raises(ValueError, match="convert_jax_checkpoints.py"):
        checkpoint.load_policy_net(jax_dir("eval_artifact/ppo_sp_cramped_room"), 4, 5, "cpu")

