"""The conv weight gradient (`ops/conv_wgrad`) and its wiring into the nets.

On the CPU:
- the plain version (`weight_grad_plain`) against autograd's `F.conv2d`
  weight and bias gradients: 5x5 SAME, 3x3 SAME and 3x3 VALID on 4x5, 5x8
  and 16x8 grids, 1, 7 and 26 input channels;
- `Conv2dWgrad` against `F.conv2d` for the input, weight and bias gradients,
  alone and inside a whole `PPONet` and `LSTMPPONet` loss (the card's
  condition, `conv_wgrad.card_smem`, given an H100's shared memory for CPU
  tensors, so the Function runs with the plain version);
- `_conv_features` keeps `F.conv2d` under `torch.no_grad`, for a bfloat16
  torso and off the card;
- the launcher's guards (device, dtype, shape, kernel size and padding) and
  the plans of the main path's shapes, sized to the card's shared memory.

The `card` test holds the kernel against the plain version on a CUDA card,
where the repo's conftest (which imports JAX) is absent: `python -m pytest
--noconftest tests/test_torch_conv_wgrad.py -m card`.
"""


import pytest
import torch
import torch.nn.functional as F

from overcooked_ai_tpu_torch.ops import _build, conv_wgrad
from overcooked_ai_tpu_torch.training import networks
from overcooked_ai_tpu_torch.training.networks import LSTMPPONet, NetConfig, PPONet

# float32 sums of a few hundred products of values near 1 in another order
TOL = 1e-5
CONVS = {"5x5_same": (5, 2), "3x3_same": (3, 1), "3x3_valid": (3, 0)}
H100_SMEM = 232_448  # bytes of shared memory a block may opt in to on an H100


def _inputs(n, c, h, w, k, pad, o=25, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, c, h, w), generator=g)
    weight = torch.randn((o, c, k, k), generator=g) * 0.2
    bias = torch.randn(o, generator=g)
    ho, wo = conv_wgrad.out_size(h, k, pad), conv_wgrad.out_size(w, k, pad)
    grad = torch.randn((n, o, ho, wo), generator=g)
    return x, weight, bias, grad


def _autograd(x, weight, bias, grad, pad):
    x, weight, bias = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
    F.conv2d(x, weight, bias, 1, pad).backward(grad)
    return x.grad, weight.grad, bias.grad


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("channels", [1, 7, 26])
@pytest.mark.parametrize("height,width", [(4, 5), (5, 8), (16, 8)])
@pytest.mark.parametrize("conv", list(CONVS))
def test_plain_version_matches_autograd(conv, height, width, channels):
    k, pad = CONVS[conv]
    x, weight, bias, grad = _inputs(6, channels, height, width, k, pad)
    _, want_w, want_b = _autograd(x, weight, bias, grad, pad)
    got_w, got_b = conv_wgrad.weight_grad_plain(x, grad, k, pad)
    assert got_w.shape == want_w.shape and _close(got_w, want_w)
    assert _close(got_b, want_b)


@pytest.fixture
def wgrad_on_cpu(monkeypatch):
    """The card's condition true for CPU tensors: the nets run `Conv2dWgrad`
    (with the plain version) where the card would run the kernel. Yields the
    count of weight gradients taken."""
    taken = []
    plain = conv_wgrad.weight_grad

    def counted(*args):
        taken.append(args[2])
        return plain(*args)

    monkeypatch.setattr(conv_wgrad, "card_smem", lambda x: H100_SMEM)
    monkeypatch.setattr(conv_wgrad, "weight_grad", counted)
    return taken


@pytest.mark.parametrize("input_grad", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("conv", list(CONVS))
def test_function_matches_conv2d(conv, input_grad):
    k, pad = CONVS[conv]
    x, weight, bias, grad = _inputs(5, 26, 4, 5, k, pad)
    want_x, want_w, want_b = _autograd(x, weight, bias, grad, pad)
    x = x.clone().requires_grad_(input_grad)
    weight, bias = weight.clone().requires_grad_(), bias.clone().requires_grad_()
    out = conv_wgrad.Conv2dWgrad.apply(x, weight, bias, pad)
    assert torch.equal(out, F.conv2d(x.detach(), weight.detach(), bias.detach(), 1, pad))
    out.backward(grad)
    assert _close(weight.grad, want_w) and _close(bias.grad, want_b)
    if input_grad:
        assert _close(x.grad, want_x)
    else:
        assert x.grad is None


def _obs(shape, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 3, shape, generator=g).float()


def _grads(net, loss_of, obs):
    """d loss / d (obs, every param)."""
    obs = obs.clone().requires_grad_()
    net.zero_grad(set_to_none=True)
    loss_of(net, obs).backward()
    return [obs.grad] + [p.grad for p in net.parameters()]


def _ppo_loss(net, obs):
    logits, value = net(obs)
    return (logits.log_softmax(-1)[:, 1] * value).sum() + value.square().mean()


def _lstm_loss(net, obs):
    logits, value, (c, h) = net(obs)
    return (logits.log_softmax(-1)[..., 2] * value).sum() + h.square().mean()


@pytest.mark.parametrize("net_kind", ["ppo", "ppo_d2rl", "lstm"])
def test_nets_take_the_same_gradients_through_the_function(net_kind, wgrad_on_cpu,
                                                           monkeypatch):
    if net_kind == "lstm":
        net, loss_of = LSTMPPONet(NetConfig(), 4, 5), _lstm_loss
        obs = _obs((3, 4, 4, 5, 26))
    else:
        net = PPONet(NetConfig(d2rl=net_kind == "ppo_d2rl"), 4, 5)
        loss_of, obs = _ppo_loss, _obs((12, 4, 5, 26))
    got = _grads(net, loss_of, obs)
    assert wgrad_on_cpu == [(25, 25, 3, 3), (25, 25, 3, 3), (25, 26, 5, 5)]  # backward order
    monkeypatch.setattr(conv_wgrad, "card_smem", lambda x: 0)  # F.conv2d's autograd
    want = _grads(net, loss_of, obs)
    assert len(wgrad_on_cpu) == 3
    for g, w in zip(got, want):
        assert g is not None and _close(g, w)


def _features_path(monkeypatch, net, obs, **ctx):
    """Run the net's conv features; the number of convs that went through
    `Conv2dWgrad`, and the features."""
    applied = []
    apply = conv_wgrad.Conv2dWgrad.apply
    monkeypatch.setattr(conv_wgrad.Conv2dWgrad, "apply",
                        lambda *a: applied.append(a) or apply(*a))
    with torch.set_grad_enabled(ctx.get("grad", True)):
        out = networks._conv_features(net.convs, obs, net.dtype)
    return len(applied), out


@pytest.mark.parametrize("case", ["no_grad", "bfloat16", "off_card", "float32_grad"])
def test_conv_features_take_conv2d_unless_float32_with_gradients_on_the_card(case,
                                                                              monkeypatch):
    dtype = "bfloat16" if case == "bfloat16" else "float32"
    net = PPONet(NetConfig(compute_dtype=dtype), 4, 5)
    obs = _obs((4, 4, 5, 26))
    want = networks._conv_features(net.convs, obs, net.dtype)  # off the card: F.conv2d
    monkeypatch.setattr(conv_wgrad, "card_smem",
                        lambda x: 0 if case == "off_card" else H100_SMEM)
    n, got = _features_path(monkeypatch, net, obs, grad=case != "no_grad")
    assert n == (3 if case == "float32_grad" else 0)
    assert torch.equal(got, want)


def _conv(k=5, pad=2, c=26, o=25, **kw):
    return torch.nn.Conv2d(c, o, k, padding=pad, **kw)


@pytest.mark.parametrize("case,conv,in_shape", [
    ("kernel_7", _conv(7, 3), (8, 26, 4, 5)),
    ("kernel_1", _conv(1, 0), (8, 26, 4, 5)),
    ("stride_2", _conv(stride=2), (8, 26, 4, 5)),
    ("dilation_2", _conv(dilation=2), (8, 26, 4, 5)),
    ("two_groups", _conv(c=26, o=26, groups=2), (8, 26, 4, 5)),
    ("no_bias", _conv(bias=False), (8, 26, 4, 5)),
    ("padding_1_of_5x5", _conv(5, 1), (8, 26, 4, 5)),
    ("65_channels_in", _conv(c=65), (8, 65, 4, 5)),
    ("65_filters", _conv(o=65), (8, 26, 4, 5)),
    ("no_samples", _conv(), (0, 26, 4, 5)),
    ("valid_larger_than_grid", _conv(3, 0), (8, 26, 2, 5)),
    ("grid_past_shared_memory", _conv(), (8, 26, 30, 30)),
])
def test_takes_refuses_what_the_kernel_does_not_take(case, conv, in_shape):
    assert not conv_wgrad.takes(in_shape, conv, H100_SMEM)


@pytest.mark.parametrize("conv,in_shape", [
    (_conv(), (65536, 26, 4, 5)), (_conv(3, 1, c=25), (65536, 25, 4, 5)),
    (_conv(3, 0, c=25), (65520, 25, 4, 5)), (_conv(), (1, 26, 16, 8)),
    (_conv(3, 1, c=64, o=64), (7, 64, 16, 8)), (_conv(3, 0, c=1, o=1), (3, 1, 3, 3))])
def test_takes_the_nets_shapes(conv, in_shape):
    assert conv_wgrad.takes(in_shape, conv, H100_SMEM)


@pytest.mark.parametrize("in_shape,h100_only", [((8, 26, 4, 5), False), ((8, 26, 16, 8), True)])
def test_whether_a_grid_fits_follows_the_cards_shared_memory(in_shape, h100_only):
    """A 16x8 grid's rows fit an H100 block's 227 KB, not the 48 KB any
    card gives a block; cramped room's fit both."""
    assert conv_wgrad.takes(in_shape, _conv(), H100_SMEM)
    assert conv_wgrad.takes(in_shape, _conv(), 48 * 1024) is not h100_only


@pytest.mark.parametrize("conv,hw,want", [
    # (units, blocks_x, blocks_y, unit_warps, groups, stage) at 65,536 samples on 132 SMs
    ((26, 5, 2), (4, 5), (25, 132, 1, 25, 1, 16)),
    ((25, 3, 1), (4, 5), (9, 132, 1, 9, 3, 7)),
    ((25, 3, 0), (4, 5), (9, 132, 1, 9, 3, 11)),
    ((26, 5, 2), (16, 8), (25, 132, 1, 25, 1, 3)),
    ((25, 3, 1), (16, 8), (9, 132, 1, 9, 3, 1)),
    ((25, 3, 1), (5, 8), (9, 132, 1, 9, 3, 3)),
    ((64, 5, 2), (4, 5), (150, 22, 6, 25, 1, 9)),
])
def test_plans_of_the_main_path_fit_a_block(conv, hw, want):
    c, k, pad = conv
    o = 25 if c < 64 else 64
    pl = conv_wgrad.plan(o, c, k, pad, *hw, 65536, 132, H100_SMEM)
    assert pl[:6] == want
    assert pl.smem_bytes <= H100_SMEM
    assert pl.unit_warps * pl.groups <= conv_wgrad.MAX_WARPS
    small = conv_wgrad.plan(o, c, k, pad, *hw, 5, 132, H100_SMEM)
    assert small.blocks_x == -(-5 // (small.groups * small.stage))  # no block without a sample


GOOD = {"x": (4, 26, 4, 5), "grad": (4, 25, 4, 5), "weight": (25, 26, 5, 5), "pad": 2}


@pytest.mark.parametrize("case,edit,match", [
    ("x_float64", {"x_dtype": torch.float64}, "float32 X and dY"),
    ("grad_bfloat16", {"grad_dtype": torch.bfloat16}, "float32 X and dY"),
    ("kernel_7", {"weight": (25, 26, 7, 7), "pad": 3}, r"square kernels of \(3, 5\)"),
    ("padding_1_of_5x5", {"pad": 1}, "SAME"),
    ("weight_channels", {"weight": (25, 27, 5, 5)}, "channels"),
    ("grad_shape", {"grad": (4, 25, 4, 4)}, r"dY must be \(4, 25, 4, 5\)"),
    ("x_3d", {"x": (4, 26, 20)}, r"\(N, C, H, W\)"),
    ("on_the_cpu", {}, "one CUDA device"),
    ("grad_elsewhere", {"grad_device": "meta"}, "one CUDA device"),
])
def test_launcher_refuses_what_it_does_not_take(case, edit, match):
    spec = {**GOOD, **edit}
    x = torch.zeros(spec["x"], dtype=spec.get("x_dtype", torch.float32))
    grad = torch.zeros(spec["grad"], dtype=spec.get("grad_dtype", torch.float32),
                       device=spec.get("grad_device", "cpu"))
    _build.launches.clear()
    with pytest.raises(ValueError, match=match):
        conv_wgrad.launch_kernel(x, grad, spec["weight"], spec["pad"])
    assert not _build.launches


def test_weight_grad_on_the_cpu_runs_the_plain_version_and_launches_nothing():
    x, _, _, grad = _inputs(3, 26, 4, 5, 5, 2)
    _build.launches.clear()
    got = conv_wgrad.weight_grad(x, grad, (25, 26, 5, 5), 2)
    want = conv_wgrad.weight_grad_plain(x, grad, 5, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not _build.launches


@pytest.mark.card
@pytest.mark.parametrize("layout", ["channels_last", "contiguous", "strided"])
@pytest.mark.parametrize("n,channels,height,width", [
    (4099, 26, 4, 5), (1000, 25, 4, 5), (777, 26, 16, 8), (3, 7, 5, 8), (513, 64, 4, 5)])
@pytest.mark.parametrize("conv", list(CONVS))
def test_on_the_card_the_kernel_matches_the_plain_version(conv, n, channels, height, width,
                                                          layout):
    """dW and db within float32 rounding of the plain version's (run in
    float64 on the card), for X and dY in either memory format and as
    strided views, and the same bits from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs on one")
    k, pad = CONVS[conv]
    o = 64 if channels == 64 else 25
    x, _, _, grad = (t.cuda() for t in _inputs(n, channels, height, width, k, pad, o=o))
    if layout == "channels_last":
        x, grad = (t.contiguous(memory_format=torch.channels_last) for t in (x, grad))
    elif layout == "strided":
        x, grad = (torch.cat([t, t], 1)[:, ::2] for t in (x, grad))
    got = conv_wgrad.launch_kernel(x, grad, (o, channels, k, k), pad)
    again = conv_wgrad.launch_kernel(x, grad, (o, channels, k, k), pad)
    want = conv_wgrad.weight_grad_plain(x.double(), grad.double(), k, pad)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert float((g.double() - w).abs().max()) <= 1e-5 * float(w.abs().max())
