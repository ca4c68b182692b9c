"""Guards of the torch port: it imports without JAX, and a tensor on a
device without a kernel raises instead of falling back."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from overcooked_ai_tpu_torch.core import env, layout
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.core.layout_generator import (
    LayoutGenerator,
    gather_lanes,
    stack_layouts,
)
from overcooked_ai_tpu_torch.ops import fused_pool, fused_rollout, fused_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "overcooked_ai_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import overcooked_ai_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
assert not any(k.split(".")[0] in ("jax", "flax") for k, v in sys.modules.items() if v)
print(" ".join(mods))
print(len(mods))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 18  # every module of the package
    mods = out.stdout.split()
    for name in ("core.layout_generator", "ops.fused_pool", "training.ppo",
                 "training.checkpoint", "cli.train_ppo", "cli.train_ppo_from_params"):
        assert f"overcooked_ai_tpu_torch.{name}" in mods, name


def test_no_jax_import_lines():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|overcooked_ai_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "overcooked_ai_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def _meta_state(spec, batch):
    return State(*(x.to("meta") for x in env.batch_reset(spec.layout, batch, "cpu")))


def test_kernels_do_not_fall_back():
    """A state off the CPU and off a card has no path: it raises, and no
    plain version runs in the kernel's place."""
    spec = layout.from_layout_name("cramped_room")
    state = _meta_state(spec, 4)
    fused_rollout.launches = fused_train.launches = 0
    with pytest.raises(ValueError, match="no rollout kernel"):
        fused_rollout.fused_rollout_random(spec.layout, state, 0, 5)
    with pytest.raises(ValueError, match="no train-step kernel"):
        fused_train.fused_train_step(
            spec.layout, state, torch.zeros((2, 4), dtype=torch.int32, device="meta")
        )
    assert fused_rollout.launches == fused_train.launches == 0


def test_pool_kernels_do_not_fall_back():
    """The same for the pool entries, whose lanes are packed on the state's
    device: on a device without a kernel they raise."""
    specs = [LayoutGenerator(rng=np.random.RandomState(0)).generate_spec()]
    lay = gather_lanes(stack_layouts(specs), np.zeros(4, dtype=np.int64))
    state = State(*(x.to("meta") for x in env.batch_reset(lay, 4, "cpu")))
    fused_pool.train_launches = fused_pool.rollout_launches = 0
    with pytest.raises(ValueError, match="no pool rollout kernel"):
        fused_pool.fused_pool_rollout_random(specs[0], lay, state, 0, 5)
    with pytest.raises(ValueError, match="no pool train-step kernel"):
        fused_pool.fused_pool_train_step(
            specs[0], lay, state, torch.zeros((2, 4), dtype=torch.int32, device="meta")
        )
    assert fused_pool.train_launches == fused_pool.rollout_launches == 0


def test_cuda_call_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the kernels there")
    spec = layout.from_layout_name("cramped_room")
    with pytest.raises((RuntimeError, AssertionError)):
        env.rollout_random(spec.layout, env.batch_reset(spec.layout, 4), 0, 5)
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig, collect_rollout
    from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet

    with pytest.raises((RuntimeError, AssertionError)):
        collect_rollout(spec, PPONet(NetConfig(), 4, 5), PPOConfig(num_envs=2, horizon=3))


def test_agent_and_planning_modules_import_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    for name in ("agents.agents", "agents.evaluation", "agents.loading", "planning._native",
                 "planning.tables", "planning.cache", "planning.greedy_tables", "planning.mlam",
                 "planning.joint", "cli.eval_matrix", "cli.eval_pool"):
        assert f"overcooked_ai_tpu_torch.{name}" in mods, name


def test_agent_pair_does_not_fall_back():
    """On a device without a kernel the agent-pair step raises: no plain
    version steps the games in B1's place."""
    from overcooked_ai_tpu_torch.agents import agents, evaluation

    spec = layout.from_layout_name("cramped_room")
    stay = evaluation.stateless(agents.stay_agent)
    fused_train.launches = 0
    with pytest.raises(ValueError, match="no train-step kernel"):
        evaluation.run_agent_pair(spec, [stay, stay], num_games=4, horizon=3, device="meta",
                                  draws=agents.GeneratorDraws(torch.Generator(), 4))
    with pytest.raises(ValueError, match="no train-step kernel"):
        fused_train.train_rollout_random(spec.layout, _meta_state(spec, 4), 2,
                                         actions_fn=lambda t: torch.zeros(
                                             (2, 4), dtype=torch.int32, device="meta"))
    assert fused_train.launches == 0


def test_agent_pair_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the agent pairs there")
    from overcooked_ai_tpu_torch.agents import agents, evaluation, loading
    from overcooked_ai_tpu_torch.cli import eval_matrix, eval_pool
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

    spec = layout.from_layout_name("cramped_room")
    stay = evaluation.stateless(agents.stay_agent)
    with pytest.raises((RuntimeError, AssertionError)):
        evaluation.run_agent_pair(spec, [stay, stay], num_games=2, horizon=3)
    with pytest.raises((RuntimeError, AssertionError)):
        loading.build_agent("greedy", spec, build_motion_tables(spec.layout.terrain))
    with pytest.raises((RuntimeError, AssertionError)):
        evaluation.check_trajectories(
            evaluation.trajectories_to_reference_format(spec, evaluation.run_agent_pair(
                spec, [stay, stay], num_games=1, horizon=3, device="cpu")), spec)
    for cli in (eval_matrix.main, lambda a: eval_pool.main(a + ["--ckpt", "x"])):
        with pytest.raises(SystemExit, match="no CUDA card"):
            cli(["--games", "1"])


def test_human_aware_modules_import_without_jax_msgpack_or_pandas():
    """The card's host has neither msgpack nor pandas: the BC reader is the
    port's own, and pandas is imported only inside the CSV/pickle readers."""
    script = _IMPORT_ALL.replace('"overcooked_ai_tpu")', '"overcooked_ai_tpu", "msgpack", "pandas")')
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    for name in ("core.featurize", "core.potential", "training.bc", "training._msgpack",
                 "human_data.compat", "human_data.pipeline", "cli.train_bc_proxy"):
        assert f"overcooked_ai_tpu_torch.{name}" in mods, name


def _human_aware_on(device):
    """featurize, phi and the BC partner's actions of a 4-env batch on `device`."""
    from overcooked_ai_tpu_torch.core.featurize import featurize_batch
    from overcooked_ai_tpu_torch.core.potential import make_potential_fn
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
    from overcooked_ai_tpu_torch.training import bc

    spec = layout.from_layout_name("cramped_room")
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    state = State(*(x.to(device) for x in env.batch_reset(spec.layout, 4, "cpu")))
    lay = layout.layout_on(spec.layout, device)
    params = bc.BCNet(bc.BCConfig(), 96).state_dict()
    partner = bc.bc_policy_batch(spec, fc, params, bc.BCConfig(), stochastic=False)
    return (featurize_batch(lay, torch.as_tensor(fc, device=device), state),
            make_potential_fn(spec, fc)(lay, state), partner(None, lay, state))


def test_featurize_phi_and_bc_stay_on_the_state_device():
    """Nothing moves to the CPU: on a device without data (meta) every
    output stays there."""
    feats, phi, acts = _human_aware_on("meta")
    assert feats.device.type == phi.device.type == acts.device.type == "meta"
    assert feats.shape == (4, 2, 96) and phi.shape == (4,) and acts.shape == (2, 4)


def test_featurize_phi_and_bc_on_cuda_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 14 runs them there")
    with pytest.raises((RuntimeError, AssertionError)):
        _human_aware_on("cuda")
