"""`bench_torch.py`, the port's benchmark, on the CPU: its pool is the JAX
`bench.py`'s, grid for grid; each timing function runs at a tiny size on
the plain versions; the JSON line has `bench.py`'s fields and the port's
own; without a card the script exits non-zero and prints no result; and it
imports nothing of JAX. Its numbers come from the card only."""

import importlib.util
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import Layout
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import fused_rollout, fused_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's fields, less those the port leaves out by design (the
# docstring's list): train_path_sweep, pool_xla_rollout_steps_per_sec, path
BENCH_PY_FIELDS = {
    "metric", "value", "unit", "vs_baseline", "sweep", "train_path_value",
    "train_path_unit", "train_path_vs_baseline", "dispatch_overhead_ms",
    "marginal_steps_per_sec", "train_iter_steps_per_sec", "train_iter_wall_s",
    "train_iter_config", "train_iter_ref_config_steps_per_sec",
    "train_iter_ref_config_wall_s", "pool_rollout_steps_per_sec",
}
PORT_FIELDS = {"ppo_bc_phi_iter_wall_s", "ppo_bc_phi_iter_config", "train_iter_ref_config",
               "device", "build_s", "wall_s"}
TINY = dict(BATCH=8, NUM_STEPS=6, NUM_STEPS_TRAIN=3, WARMUP=1, REPS=2, TRAIN_ITER_ENVS=2,
            TRAIN_ITER_HORIZON=8, TRAIN_ITER_MINIBATCH=8, REF_ENVS=2, REF_MINIBATCH=4,
            ITER_WARMUP=0, ITER_REPS=1, SWEEP_THREADS=(32,))


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    """Every size at a few envs and steps, one torch thread (the learner's
    small ops beside pytest-xdist's other workers)."""
    for k, v in TINY.items():
        monkeypatch.setattr(bench_torch, k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pool_is_bench_py_pool():
    """64 layouts from one generator seeded 0, the JAX bench.py's, grid for
    grid and leaf for leaf."""
    jspecs, jpool = _jax_bench()._make_pool()
    specs, pool = bench_torch._make_pool()
    assert len(specs) == len(jspecs) == 64
    assert len({tuple(s.terrain_chars) for s in specs}) > 1  # not one layout 64 times
    for s, js in zip(specs, jspecs):
        assert (s.name, s.terrain_chars, s.num_players) == (js.name, js.terrain_chars,
                                                            js.num_players)
    for f, g, w in zip(Layout._fields[:-1], pool[:-1], jpool[:-1]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)
    for f, g, w in zip(State._fields, pool.start_state, jpool.start_state):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)


def test_median_time_runs_warmup_then_timed_calls():
    calls = []

    def fn(state, k):
        calls.append(k)
        return state + 1

    dt, state = bench_torch._median_time(fn, 0, "cpu", warmup=2, reps=3)
    assert calls == [0, 1, 2, 3, 4] and state == 5 and dt >= 0


def test_bench_rollout_chains_its_calls():
    """The rate counts every env's steps; the state threads through the
    warm-up and timed calls, seeded by the call's index, as bench.py's."""
    layout = bench_torch._spec().layout
    state = batch_reset(layout, 8, "cpu")
    rate, dt, final = bench_torch._bench_rollout(layout, state, 32, 6, "cpu")
    assert rate == pytest.approx(8 * 6 / dt) and rate > 0
    want = state
    for seed in range(3):  # WARMUP + REPS calls
        want = fused_rollout.fused_rollout_random(layout, want, seed, 6)[0]
    for g, w in zip(final, want):
        assert torch.equal(g, w)
    assert int(final.t.max()) == 18


def test_bench_train_path():
    layout = bench_torch._spec().layout
    fused_train.launches = 0
    rate, final = bench_torch._bench_train_path(layout, batch_reset(layout, 8, "cpu"), "cpu")
    assert math.isfinite(rate) and rate > 0
    assert int(final.t.max()) == 9  # 3 calls of 3 steps
    assert fused_train.launches == 0  # the plain version on the CPU


def test_bench_train_iter():
    rate, dt = bench_torch._bench_train_iter(device="cpu")
    assert rate == pytest.approx(2 * 8 / dt)
    rate, dt = bench_torch._bench_train_iter(2, 4, "cpu")
    assert rate > 0


def test_bench_ppo_bc_phi():
    assert bench_torch._bench_ppo_bc_phi("cpu") > 0


def test_bench_pool_fused():
    assert bench_torch._bench_pool_fused(device="cpu") > 0


def test_line_fields():
    """measure()'s fields and main()'s three are FIELDS: bench.py's (less the
    ones left out by design) and the port's own."""
    line = bench_torch.measure("cpu")
    assert set(bench_torch.FIELDS) == BENCH_PY_FIELDS | PORT_FIELDS
    assert set(line) == set(bench_torch.FIELDS) - {"device", "build_s", "wall_s"}
    assert not any(isinstance(v, str) and "fail" in v for v in line.values())
    assert line["sweep"] == {"threads=32": line["value"]}
    assert "median of 1 timed" in line["train_iter_config"]


def test_main_without_a_card_exits_non_zero():
    assert not torch.cuda.is_available()
    assert bench_torch.main() != 0
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs a CUDA card" in out.stderr


def test_no_jax_import_lines():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|overcooked_ai_tpu)\b", re.M)
    with open(os.path.join(REPO, "bench_torch.py")) as f:
        assert not pattern.search(f.read())
