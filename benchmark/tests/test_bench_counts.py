"""The counters of work match hand counts at cramped_room (5 x 4)."""

from harness.weights import ppo_shapes
from metrics import _counts

NET = {"num_hidden_layers": 3, "size_hidden_layers": 64, "num_filters": 25,
       "num_conv_layers": 3, "num_actions": 6, "d2rl": False}


def test_ppo_forward_flops_by_hand():
    by_hand = (2 * 26 * 25 * 25 * 20  # 5x5 SAME over 4 x 5
               + 2 * 25 * 25 * 9 * 20  # 3x3 SAME
               + 2 * 25 * 25 * 9 * 6  # 3x3 VALID: 2 x 3
               + 2 * 150 * 64 + 2 * 2 * 64 * 64  # dense
               + 2 * 64 * 7)  # logits and value
    assert _counts.ppo_forward_flops(NET, 4, 5) == by_hand == 978_980


def test_train_iteration_flops_by_hand():
    bundle = {"traffic": {"num_envs": 2048, "horizon": 400, "sgd_minibatch_size": 32768,
                          "num_sgd_iter": 8},
              "config": {"net": NET}, "height": 4, "width": 5}
    samples = 2 * 2048 * 400
    assert _counts.train_iteration_flops(bundle) == 978_980 * (samples + 3 * 25 * 65536 * 8)
    bundle["config"]["bc_net"] = {"obs_dim": 96, "net_arch": [64, 64], "num_actions": 6}
    bundle["bc_seat_envs"] = 1000
    bc = 2 * (96 * 64 + 64 * 64 + 64 * 6)
    assert _counts.train_iteration_flops(bundle) == (
        978_980 * (samples + 3 * 25 * 65536 * 8) + bc * 1000 * 400)


def test_b1_bytes_by_hand():
    state = 4 * (2 * (2 + 1 + 1 + 3 + 1) + 20 * (1 + 3 + 1 + 1) + 1)  # 548
    per_env = 2 * state + 2 * 4 + 2 * 26 * 20 + 3 * 2 * 4
    assert per_env == 2168
    assert _counts.b1_bytes(2048, 4, 5) == 2048 * 2168


def test_b1_bytes_are_the_kernel_state_tensors():
    import torch

    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.layout import build_layout
    from overcooked_ai_tpu_torch.ops.fused_train import plain_train_step

    import json
    import os
    from harness.core import BENCH_DIR

    with open(os.path.join(BENCH_DIR, "layouts", "cramped_room.json")) as f:
        spec = build_layout("cramped_room", json.load(f))
    st = batch_reset(spec.layout, 3, "cpu")
    act = torch.zeros((2, 3), dtype=torch.int32)
    out = plain_train_step(spec.layout, st, act, 400, 401)
    n = sum(x.numel() * x.element_size() for x in st) + act.numel() * 4
    n += sum(x.numel() * x.element_size() for x in out[0])
    n += sum(x.numel() * x.element_size() for x in out[1:])
    assert n == _counts.b1_bytes(3, 4, 5)


def test_weight_shapes_are_the_ports_net():
    import torch

    from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet

    net = PPONet(NetConfig(**NET), 4, 5)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == ppo_shapes(NET, 4, 5)
    assert sum(v.numel() for v in net.state_dict().values()) == sum(
        torch.Size(s).numel() for s in ppo_shapes(NET, 4, 5).values())
