"""The weight and bias gradient of the torso's float32 convolutions.

`csrc/conv_wgrad.cu` replaces no TPU kernel: in the JAX package the conv
gradient is XLA's. On the card cuDNN's float32 weight gradient ran the
learner's three convolutions at about 15% of the card's float32 rate; the
kernel computes dW and db of a stride-1 convolution on the CUDA cores in
float32, the taps that read padding skipped (the source's note has the
design).

`Conv2dWgrad` is the convolution as `training/networks._conv_features`
runs it in the learner: forward `F.conv2d`, backward the input gradient
from cuDNN (`aten.convolution_backward` with only the input in its mask, and
nothing when the input needs no gradient) and the weight and bias gradient
from `weight_grad`: the kernel on a CUDA tensor, the plain version
(`weight_grad_plain`) on a CPU one. `takes` says which convolutions the
kernel takes: stride 1, a square kernel of KERNEL_SIZES, SAME or VALID
padding, a bias, at most MAX_CHANNELS channels in and out, and a grid whose
rows fit the shared memory a block may have on the card (`card_smem`).
`plan` sizes the launch from the layout constants of the source, which
`_build.load` checks against CONSTANTS. The launch and its count
(`_build.launches["oc_conv_wgrad"]`) are `ops/_build`'s.

Every sum runs in a fixed order, so the kernel gives the same gradient from
run to run; against cuDNN's it differs by float32 rounding in the order of
the sums.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from overcooked_ai_tpu_torch.ops import _build

KERNEL_SIZES = (3, 5)
MAX_CHANNELS = 64
MAX_WARPS = 27  # warps a block
MAX_STAGE = 16  # samples a stage holds for each pair group
GROUP_O, GROUP_C = 32, 28  # a warp's filters and channels (channel C the ones column)
ROW_FLOATS = 32  # floats of one (group, cell, sample) row in shared memory
UNIT_FLOATS = 28 * 32  # a warp's partial: 28 accumulators a lane
# csrc/conv_wgrad.cu's layout constants, in `oc_conv_wgrad_constants`' order
CONSTANTS = (MAX_WARPS, UNIT_FLOATS, GROUP_O, GROUP_C, ROW_FLOATS, MAX_CHANNELS)


class Plan(NamedTuple):
    """One launch of `csrc/conv_wgrad.cu` (its `Params`)."""

    units: int  # warps of work: K * K taps x o-groups x c-groups
    blocks_x: int  # blocks over the samples
    blocks_y: int  # blocks over the units
    unit_warps: int  # units a block
    groups: int  # pair groups a block: each sums the stage over every groups-th pair of its tap
    stage: int  # samples a stage holds for each group: groups * stage in all
    smem_bytes: int


def out_size(size: int, kernel_size: int, padding: int) -> int:
    return size + 2 * padding - kernel_size + 1


def smem_bytes(out_ch: int, in_ch: int, kernel_size: int, padding: int, height: int,
               width: int, unit_warps: int, groups: int, stage: int) -> int:
    """A block's dynamic shared memory (csrc/conv_wgrad.cu `smem_bytes`):
    the cells' offsets, then two stage buffers of X's and dY's rows, or the
    groups' partials when more."""
    hw = height * width
    hwo = out_size(height, kernel_size, padding) * out_size(width, kernel_size, padding)
    og, cg = -(-out_ch // GROUP_O), -(-(in_ch + 1) // GROUP_C)
    buffers = 2 * (cg * hw + og * hwo) * groups * stage * ROW_FLOATS * 4
    partials = (groups - 1) * unit_warps * UNIT_FLOATS * 4
    return -(-(hw + hwo) * 8 // 16) * 16 + max(buffers, partials)


@functools.lru_cache(maxsize=64)
def plan(out_ch: int, in_ch: int, kernel_size: int, padding: int, height: int, width: int,
         batch: int, num_sms: int, smem_limit: int) -> Optional[Plan]:
    """The launch for `batch` samples on a card of `num_sms` SMs, or None
    where one sample's rows do not fit `smem_limit` bytes, the shared memory
    a block may have. The units (a warp each) are spread over as
    few blocks as MAX_WARPS allows; a block with room for more warps takes
    several pair groups, each summing a stage's samples over every
    groups-th pair of its tap; a stage holds the most samples, up to
    MAX_STAGE a group, that fit with its double buffer; one block an SM (it
    holds most of the SM's shared memory and registers) over the samples,
    at most one a sample."""
    units = kernel_size * kernel_size * -(-out_ch // GROUP_O) * -(-(in_ch + 1) // GROUP_C)
    blocks_y = -(-units // MAX_WARPS)
    unit_warps = -(-units // blocks_y)
    args = (out_ch, in_ch, kernel_size, padding, height, width, unit_warps)
    for groups in range(MAX_WARPS // unit_warps, 0, -1):
        stage = MAX_STAGE
        while stage and smem_bytes(*args, groups, stage) > smem_limit:
            stage -= 1
        if stage:
            break
    else:
        return None
    blocks_x = max(1, min(num_sms // blocks_y, -(-batch // (groups * stage))))
    return Plan(units, blocks_x, blocks_y, unit_warps, groups, stage,
                smem_bytes(*args, groups, stage))


def takes(in_shape, conv, smem_limit: int) -> bool:
    """Whether the kernel takes the weight gradient of `conv` (an
    `nn.Conv2d`) on inputs of `in_shape` (N, C, H, W), on a card whose block
    may have `smem_limit` bytes of shared memory."""
    if refusal(in_shape, conv.weight.shape, conv.padding, conv.stride, conv.dilation,
               conv.groups, conv.bias is not None) is not None:
        return False
    (n, c, h, w), (o, _, k, _) = in_shape, conv.weight.shape
    return plan(o, c, k, conv.padding[0], h, w, n, 1, smem_limit) is not None


def refusal(in_shape, weight_shape, padding, stride=(1, 1), dilation=(1, 1), groups=1,
            bias=True) -> Optional[str]:
    """Why the kernel does not take a convolution of these shapes on any
    card, or None. Whether a grid's rows fit the card's shared memory is
    `plan`'s to say."""
    if len(in_shape) != 4 or len(weight_shape) != 4:
        return f"takes (N, C, H, W) inputs and (O, C, K, K) weights, got {tuple(in_shape)} " \
               f"and {tuple(weight_shape)}"
    n, c, h, w = in_shape
    o, c_w, k, k_w = weight_shape
    if tuple(stride) != (1, 1) or tuple(dilation) != (1, 1) or groups != 1 or not bias:
        return "takes stride 1, dilation 1, one group and a bias"
    if k != k_w or k not in KERNEL_SIZES:
        return f"takes square kernels of {KERNEL_SIZES}, got {k}x{k_w}"
    if len(set(padding)) != 1 or padding[0] not in (0, k // 2):
        return f"takes SAME ({k // 2}) or VALID (0) padding, got {tuple(padding)}"
    if c != c_w or not (1 <= c <= MAX_CHANNELS and 1 <= o <= MAX_CHANNELS):
        return f"takes 1 to MAX_CHANNELS = {MAX_CHANNELS} channels in and out, got {c_w} -> " \
               f"{o} on an input of {c}"
    if n < 1 or out_size(h, k, padding[0]) < 1 or out_size(w, k, padding[0]) < 1:
        return f"needs at least one sample and one output cell, got {tuple(in_shape)}"
    return None


def weight_grad_plain(x: torch.Tensor, grad: torch.Tensor, kernel_size: int,
                      padding: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (dW (O, C, K, K), db (O,)) from X (N, C, H, W) and
    dY (N, O, Ho, Wo), tap by tap over the in-bounds output cells only, as
    the kernel sums."""
    _, c, h, w = x.shape
    o, ho, wo = grad.shape[1:]
    grad_w = x.new_zeros((o, c, kernel_size, kernel_size))
    for kh in range(kernel_size):
        for kw in range(kernel_size):
            dh, dw = kh - padding, kw - padding
            y0, y1 = max(0, -dh), min(ho, h - dh)
            x0, x1 = max(0, -dw), min(wo, w - dw)
            if y0 < y1 and x0 < x1:
                grad_w[:, :, kh, kw] = torch.einsum(
                    "noyx,ncyx->oc", grad[:, :, y0:y1, x0:x1],
                    x[:, :, y0 + dh:y1 + dh, x0 + dw:x1 + dw])
    return grad_w, grad.sum((0, 2, 3))


@functools.lru_cache(maxsize=8)
def _card(index: int) -> tuple[int, int]:
    """(SMs, bytes of shared memory a block may opt in to) of card `index`."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def card_smem(x: torch.Tensor) -> int:
    """The shared memory a block may have on the card `x` lies on, in
    bytes; 0 off the card, where the kernel does not run."""
    return _card(x.device.index)[1] if x.is_cuda else 0


def launch_kernel(x: torch.Tensor, grad: torch.Tensor, weight_shape,
                  padding: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone: (dW contiguous of `weight_shape`, db) float32 from X
    and dY float32 on one card, each in any memory format (read through its
    strides). Raises ValueError for what it does not take."""
    if x.dtype is not torch.float32 or grad.dtype is not torch.float32:
        raise ValueError(f"the wgrad kernel takes float32 X and dY, got {x.dtype} and "
                         f"{grad.dtype}")
    why = refusal(x.shape, weight_shape, (padding, padding))
    if why is not None:
        raise ValueError(f"the wgrad kernel {why}")
    n, c, h, w = x.shape
    o, _, k, _ = weight_shape
    want = (n, o, out_size(h, k, padding), out_size(w, k, padding))
    if tuple(grad.shape) != want:
        raise ValueError(f"dY must be {want}, got {tuple(grad.shape)}")
    dev = x.device
    if not (x.is_cuda and grad.device == dev):
        raise ValueError(f"the wgrad kernel takes X and dY on one CUDA device, got {x.device} "
                         f"and {grad.device}")
    num_sms, smem_limit = _card(dev.index)
    pl = plan(o, c, k, padding, h, w, n, num_sms, smem_limit)
    if pl is None:
        raise ValueError(f"the wgrad kernel needs a {h}x{w} grid's rows to fit a block's "
                         f"{smem_limit} bytes of shared memory")
    partial = torch.empty(pl.blocks_x * pl.units * UNIT_FLOATS, dtype=torch.float32, device=dev)
    grad_w = torch.empty(tuple(weight_shape), dtype=torch.float32, device=dev)
    grad_b = torch.empty(o, dtype=torch.float32, device=dev)
    _build.launch("oc_conv_wgrad", dev, x.data_ptr(), grad.data_ptr(), partial.data_ptr(),
                  grad_w.data_ptr(), grad_b.data_ptr(), n, c, h, w, o, k, padding, *x.stride(),
                  *grad.stride(), pl.blocks_x, pl.blocks_y, pl.unit_warps, pl.groups, pl.stage)
    return grad_w, grad_b


def weight_grad(x: torch.Tensor, grad: torch.Tensor, weight_shape,
                padding: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW, db): the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.is_cuda:
        return launch_kernel(x, grad, weight_shape, padding)
    if x.device.type != "cpu":
        raise ValueError(f"the wgrad kernel takes CUDA tensors, the plain version CPU ones; "
                         f"got {x.device}")
    return weight_grad_plain(x, grad, weight_shape[-1], padding)


class Conv2dWgrad(torch.autograd.Function):
    """`F.conv2d(x, weight, bias, padding=padding)`, stride 1, whose backward
    takes dW and db from `weight_grad` and dX from cuDNN."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding: int):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        return F.conv2d(x, weight, bias, 1, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        p = ctx.padding
        grad_x = None
        if ctx.needs_input_grad[0]:
            grad_x = torch.ops.aten.convolution_backward(
                grad, x, weight, None, (1, 1), (p, p), (1, 1), False, (0, 0), 1,
                (True, False, False))[0]
        grad_w, grad_b = weight_grad(x, grad, weight.shape, p)
        return grad_x, grad_w, grad_b, None
