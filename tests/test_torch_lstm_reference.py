"""The recurrent learner (`LSTMPPONet`, `make_ppo_lstm`) against the
benchmark's plain reference (`benchmark/reference/lstm.py`) on the CPU, on
seeded Glorot weights at a small size.

`forward` over chunks and `step` one step at a time agree with the
reference's logits, values and final carry within NET_RTOL / NET_ATOL
(float32 sums in another order: the port adds the hidden product to the
bias in one `addmm`, the reference after it). One `train_iteration` (4
envs x 40 steps, 2 chunks a sequence, 2 epochs of 4 minibatches, its draws
through the hooks), replayed by the reference under the program's actions,
agrees in the chunk-start carries within CARRY_TOL, in each leaf's change,
in Adam's moments within STATE_RTOL of the leaf's largest, and in Adam's
count and the KL coefficient exactly. The same iteration with the
chunk-start carries zeroed (`benchmark/tests/lstm_faults.zeroed_carry`)
misses them by far more.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.training import ppo, ppo_lstm
from overcooked_ai_tpu_torch.training.networks import LSTMPPONet, NetConfig

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
for _path in (BENCH, os.path.join(BENCH, "tests")):
    if _path not in sys.path:
        sys.path.insert(0, _path)
import lstm_faults  # noqa: E402
from harness.core import load_module  # noqa: E402
from harness.weights import glorot_weights  # noqa: E402
from reference import learner as L  # noqa: E402
from reference import lstm as R  # noqa: E402
from reference.layout import build_layout, layout_on  # noqa: E402

NET = dict(num_hidden_layers=3, size_hidden_layers=64, num_filters=25, num_conv_layers=3,
           num_actions=6, d2rl=False, cell_size=256)
B, T, EPOCHS = 4, 40, 2
CFG = dict(num_envs=B, horizon=T, num_sgd_iter=EPOCHS, sgd_minibatch_size=40, lr=5e-4)
N_CHUNKS = 2 * B * T // R.MAX_SEQ_LEN  # 16: 4 minibatches of 4 chunks an epoch
# float32 rounding through at most 40 steps of the cell, on values of order 1
NET_RTOL, NET_ATOL = 1e-5, 2e-6
CARRY_TOL = 2e-6
# the leaves' changes and Adam's moments, as a share of the leaf's largest:
# 8 Adam steps from gradients that agree to float32 rounding; the zeroed
# carry moves them by more than 10 times this
STATE_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(spec, seed):
    shapes = load_module("drivers", "train_lstm").lstm_shapes(NET, spec.height, spec.width)
    return glorot_weights(shapes, seed, "cpu")


def _net(spec, weights):
    net = LSTMPPONet(NetConfig(**NET), spec.height, spec.width)
    net.load_state_dict(weights)
    return net


def test_the_weight_shapes_are_the_ports_leaves():
    spec = from_layout_name("cramped_room")
    net = LSTMPPONet(NetConfig(**NET), spec.height, spec.width)
    shapes = load_module("drivers", "train_lstm").lstm_shapes(NET, spec.height, spec.width)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == shapes


def test_forward_over_chunks_and_step_match_the_reference():
    spec = from_layout_name("cramped_room")
    w = _weights(spec, 2_147_483_917)
    net = _net(spec, w)
    g = torch.Generator().manual_seed(5)
    n = 6
    obs = torch.randint(0, 3, (n, 2 * R.MAX_SEQ_LEN, spec.height, spec.width, 26),
                        generator=g, dtype=torch.int8)
    carry = (torch.randn(n, 256, generator=g) * 0.5, torch.rand(n, 256, generator=g) - 0.5)
    with torch.no_grad():
        lg, v, (c, h) = net(obs, carry)
        rlg, rv, (rc, rh) = R.forward(w, obs, carry, 3, 3)
        for got, want in ((lg, rlg), (v, rv), (c, rc), (h, rh)):
            torch.testing.assert_close(got, want, rtol=NET_RTOL, atol=NET_ATOL)
        pc, rcar = carry, carry
        for t in range(obs.shape[1]):
            plg, pv, pc = net.step(obs[:, t], pc)
            qlg, qv, rcar = R.step(w, obs[:, t], rcar, 3, 3)
            torch.testing.assert_close(plg, qlg, rtol=NET_RTOL, atol=NET_ATOL)
            torch.testing.assert_close(pv, qv, rtol=NET_RTOL, atol=NET_ATOL)
        for got, want in zip(pc, rcar):
            torch.testing.assert_close(got, want, rtol=NET_RTOL, atol=NET_ATOL)


def _iteration_gaps(zeroed: bool) -> dict:
    """One program iteration and its reference replay: the worst gap of each
    compared quantity."""
    spec = from_layout_name("cramped_room")
    config = ppo.PPOConfig(net=NetConfig(**NET), **CFG)
    init_fn, train_iteration = ppo_lstm.make_ppo_lstm(spec, config, device="cpu")
    ts = init_fn(0)
    w = _weights(spec, 3_000_000_019)
    ts.net.load_state_dict(w)
    g = torch.Generator().manual_seed(11)
    u = torch.rand((T, 2 * B, 6), generator=g)
    perms = [torch.randperm(N_CHUNKS, generator=g) for _ in range(EPOCHS)]
    seen = {}
    undo = lstm_faults.zeroed_carry() if zeroed else None
    real = ppo_lstm._Recurrent

    class Noted(real):  # the iteration's recurrent policy, for its recorded carries
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen["policy"] = self

    def on_phase(name, out):
        seen[name] = out

    ppo_lstm._Recurrent = Noted
    try:
        ts, _ = train_iteration(ts, sample_fn=lambda lg, t: torch.argmax(lg + L.gumbel(u[t]), -1),
                                perm_fn=lambda e: perms[e], on_phase=on_phase)
    finally:
        ppo_lstm._Recurrent = real
        if undo:
            undo()

    ro_p = seen["rollout"]
    params = {k: v.clone() for k, v in w.items()}
    adam = L.Adam(params, config.lr)
    lay = layout_on(build_layout("cramped_room", _layout_config()).layout, "cpu")
    ro = R.rollout(lay, params, lambda t, lg: ro_p.action[t], T, B,
                   L.anneal(config.reward_shaping_factor, 0, config.reward_shaping_horizon), 3, 3,
                   "cpu")
    assert torch.equal(ro.obs, ro_p.obs) and torch.equal(ro.sparse, ro_p.sparse)
    adv, vt = L.gae(ro.reward, ro.value, config.gamma, config.lmbda)
    adv = L.standardize(adv, torch.ones_like(adv))
    terms, _ = R.epochs(params, adam, ro, ro_p.action, adv, vt, perms, config.kl_coeff,
                        L.anneal(config.entropy_coeff_start, 0, config.entropy_coeff_horizon,
                                 config.entropy_coeff_end), dataclasses.asdict(config), 3, 3)
    policy = seen["policy"]
    gaps = {"carry": max(float((ro.c0 - policy.c0).abs().max()),
                         float((ro.h0 - policy.h0).abs().max()))}
    opt = ts.opt
    named = dict(ts.net.named_parameters())
    moved, m_gap, v_gap, count_gap = 0.0, 0.0, 0.0, 0
    for n, p in named.items():
        st = opt.state[p]
        count_gap = max(count_gap, abs(int(st["step"]) - adam.count))
        delta_p, delta_r = p.detach() - w[n], params[n] - w[n]
        moved = max(moved, float((delta_p - delta_r).abs().max() / delta_r.abs().max()))
        m_gap = max(m_gap, float((st["exp_avg"] - adam.m[n]).abs().max() / adam.m[n].abs().max()))
        v_gap = max(v_gap, float((st["exp_avg_sq"] - adam.v[n]).abs().max()
                                 / adam.v[n].abs().max()))
    kl = float(terms[2])
    step = 1.5 if kl > 2.0 * config.kl_target else 0.5 if kl < 0.5 * config.kl_target else 1.0
    gaps.update(update=moved, adam_m=m_gap, adam_v=v_gap,
                adam_count=count_gap,
                kl_coeff=abs(float(ts.kl_coeff)
                             - float(torch.tensor(config.kl_coeff, dtype=torch.float32) * step)))
    return gaps


def _layout_config():
    with open(os.path.join(BENCH, "layouts", "cramped_room.json")) as f:
        return json.load(f)


WITHIN = {"carry": CARRY_TOL, "update": STATE_RTOL, "adam_m": STATE_RTOL, "adam_v": STATE_RTOL,
          "adam_count": 0, "kl_coeff": 0.0}


def test_one_iteration_matches_the_reference():
    gaps = _iteration_gaps(zeroed=False)
    assert all(gaps[k] <= tol for k, tol in WITHIN.items()), gaps


def test_the_iteration_with_the_chunk_start_carries_zeroed_misses_by_far():
    gaps = _iteration_gaps(zeroed=True)
    assert gaps["carry"] > 10 * CARRY_TOL, gaps
    assert max(gaps[k] / STATE_RTOL for k in ("update", "adam_m", "adam_v")) > 10, gaps
