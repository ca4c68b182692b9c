"""The benchmark's recurrent cell `lstm_selfplay_cramped` on the CPU at a tiny
size: a whole run through `run.make_context` and `run.execute` is correct,
and is not under each of the recurrent learner's faults
(`benchmark/tests/lstm_faults.py`); the plain reference loads neither the
port nor JAX; one profiled `make_ppo_lstm` iteration gives its spans; and
the cell's span readers and work counts read what they should.

A run of the cell refuses to report once JAX is loaded, and this suite's
conftest loads it, so the runs and the import check are subprocesses.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.training import ppo, ppo_lstm
from overcooked_ai_tpu_torch.training.networks import NetConfig
from overcooked_ai_tpu_torch.utils import trace
from overcooked_ai_tpu_torch.utils.trace import Span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
from harness import core  # noqa: E402
from harness.device import Trace  # noqa: E402
from metrics import _lstm_counts, _spans  # noqa: E402

CELL = "lstm_selfplay_cramped"
# 4 envs x 40 steps: 2 chunks of 20 a sequence, 16 chunks, 4 minibatches of
# 4 chunks an epoch, 2 epochs; the reference follows 2 iterations
TINY = {"num_envs": 4, "horizon": 40, "sgd_minibatch_size": 40, "num_sgd_iter": 2}
MS = 1_000_000  # ns
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "overcooked_ai_tpu")


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("fault", [None, "lstm_zeroed_carry", "lstm_half_batch"])
def test_a_tiny_cpu_run_is_correct_and_each_fault_is_not(fault):
    code = f"""
import json, sys
sys.path[:0] = ['benchmark', 'benchmark/tests', '.']
import torch
torch.set_num_threads(2)
import lstm_faults, run
from harness import core
fault = {fault!r}
if fault:
    lstm_faults.PLANT[fault]()
args = run.parse(['--workload', {CELL!r}, '--seed', '4294967301', '--seconds', '0',
                  '--trace', '0'])
ctx = run.make_context(args, device='cpu', traffic_overrides={TINY!r}, check_iterations=2)
out = run.execute(ctx)
print(json.dumps({{'correct': out['correct'], 'checks': out['checks'],
                  'metrics': sorted(out['metrics']), 'loaded': core.forbidden_modules()}}))
"""
    out = json.loads(_python(code))
    assert out["loaded"] == []
    assert out["metrics"] == ["selfplay_env_steps_per_s", "setup_s"]
    assert "carry_gap" in out["checks"]
    assert out["correct"] is (fault is None), out["checks"]


def test_the_reference_loads_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark'); import reference.lstm; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    loaded = set(json.loads(_python(code).replace("'", '"')))
    assert "reference" in loaded
    assert "overcooked_ai_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)


def _read(name, bundle):
    read, rest = core.metric_reader(name)
    return read(bundle, rest)


def test_a_profiled_iteration_gives_the_recurrent_spans_and_the_idle_phases_sum():
    spec = from_layout_name("cramped_room")
    config = ppo.PPOConfig(**{k: TINY[k] for k in ("num_envs", "horizon", "sgd_minibatch_size",
                                                   "num_sgd_iter")}, net=NetConfig())
    init_fn, train_iteration = ppo_lstm.make_ppo_lstm(spec, config, device="cpu")
    ts = init_fn(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        train_iteration(ts)
    rec = trace.recording()
    minibatches = config.num_sgd_iter * 4
    count = {n: sum(s.name == n for s in rec) for n in {s.name for s in rec}}
    assert rec.dropped == 0 and all(s.end_ns is not None for s in rec)
    assert count["ppo.iteration"] == 1 and _lstm_counts.iterations(rec) == 1
    assert count["lstm.step"] == config.horizon
    assert count["lstm.torso"] == count["lstm.recurrence"] == count["sgd.forward"] == minibatches
    assert {rec[s.parent].name for s in rec if s.name.startswith("lstm.")} == {
        "rollout.policy", "sgd.forward"}
    assert _read("lstm_host_ms.step", {}) > 0 and _read("lstm_host_ms.recurrence", {}) > 0

    # a device trace over the iteration, busy every other 0.3 ms
    start, end = rec[0].start_ns - MS, rec[0].end_ns + MS
    busy = [("k", t, t + 300_000) for t in range(start, end, 600_000)]
    bundle = {"trace": Trace(busy, [], [], start, end)}
    phases = {p: _read(f"lstm_idle_ms.{p}", bundle)
              for p in ("policy", "env", "rest", "learner", "outside")}
    assert all(v > 0 for v in phases.values()), phases
    window_ms = bundle["trace"].window_s * 1e3
    assert sum(phases.values()) == pytest.approx(
        _read("device_idle.lstm", bundle) / 100 * window_ms, rel=1e-9)


def test_the_span_readers_on_a_synthetic_recording(monkeypatch):
    """Two iterations, each with two SGD minibatches of known device times."""
    spans = []
    for i, t0 in enumerate((0, 100)):
        top = len(spans)
        spans += [Span("ppo.iteration", -1, t0 * MS, (t0 + 90) * MS, 90.0),
                  Span("rollout.policy", top, t0 * MS, (t0 + 10) * MS, None),
                  Span("lstm.step", top + 1, (t0 + 2) * MS, (t0 + 5) * MS, None)]
        for j in range(2):
            fwd = len(spans)
            a = t0 + 20 + 30 * j
            spans += [Span("sgd.forward", top, a * MS, (a + 10) * MS, 8.0),
                      Span("lstm.torso", fwd, a * MS, (a + 2) * MS, 1.5),
                      Span("lstm.recurrence", fwd, (a + 2) * MS, (a + 9) * MS, 4.0),
                      Span("sgd.backward", top, (a + 10) * MS, (a + 20) * MS, 10.0),
                      Span("sgd.optimizer", top, (a + 20) * MS, (a + 21) * MS, 0.5)]
    monkeypatch.setattr(_spans, "recording", lambda: spans)
    got = {p: _read(f"lstm_sgd_device_ms.{p}", {})
           for p in ("torso", "recurrence", "backward", "optimizer")}
    assert got == pytest.approx({"torso": 3.0, "recurrence": 8.0, "backward": 20.0,
                                 "optimizer": 1.0})
    assert _read("lstm_host_ms.step", {}) == pytest.approx(3.0)
    assert _read("lstm_host_ms.recurrence", {}) == pytest.approx(14.0)
    bundle = {"traffic": {"num_envs": 2048, "horizon": 400, "sgd_minibatch_size": 32768,
                          "num_sgd_iter": 8},
              "config": core.find_config("ppo_lstm_cnn"), "height": 4, "width": 5}
    flops = 2 * (64 + 256) * 4 * 256 * 25 * 3276 * 20 * 8  # the cell on every trained sample
    assert _read("lstm_recurrence_roofline", bundle) == pytest.approx(
        100 * flops / 8.0e-3 / 67e12)
    monkeypatch.setattr(_spans, "recording", lambda: None)
    assert _read("lstm_sgd_device_ms.torso", {}) is None
    assert _read("lstm_idle_ms.learner", {"trace": bundle.get("trace")}) is None


def test_the_iteration_flops_by_hand():
    """cramped_room (5 x 4): the torso of `_counts`' hand count less its heads,
    the cell, the heads over the cell's 256 outputs."""
    per_sample = (978_980 - 2 * 64 * 7) + 2 * (64 + 256) * 4 * 256 + 2 * 256 * 7
    assert per_sample == 1_637_028
    bundle = {"traffic": {"num_envs": 2048, "horizon": 400, "sgd_minibatch_size": 32768,
                          "num_sgd_iter": 8},
              "config": core.find_config("ppo_lstm_cnn"), "height": 4, "width": 5,
              "spans": {"iteration": [5000.0]}}
    collected, trained = 2 * 2048 * 400, 25 * 3276 * 20 * 8
    assert _lstm_counts.samples(bundle["traffic"]) == (collected, trained)
    assert _lstm_counts.iteration_flops(bundle) == per_sample * (collected + 3 * trained)
    assert _read("lstm_mfu", bundle) == pytest.approx(
        100 * per_sample * (collected + 3 * trained) / 5.0 / 67e12)
