"""The BC partner kernel: featurize and the BC MLP of every seat of a batch
in one launch.

`csrc/fused_bc.cu` replaces no TPU kernel: in the JAX package featurize
and the BC MLP are XLA ops that XLA fuses inside the jitted rollout. The
port's plain version, `core.featurize.featurize_batch` and
`training.bc.BCNet`, is about 270 PyTorch ops a call, and a PPO rollout
with a BC partner calls it every step; the kernel is one launch.

The layout's tables go to each device once, as one block of int32 words a
layout (`pack_words`; a pool's blocks stacked, each lane reading the entry
its pool index names, a single layout a pool of one): the terrain, the
cook times, the pot cells and the cost rows (`entry_layout` gives the
offsets). The weights go once too, as one float32 block (`pack_weights`).
On a card the kernel reads the layout fields from the word block, not from
the layout passed with the state.

`training.bc`'s policies call `launch_kernel` on a CUDA state and the
plain version on any other. On the card the features are the plain
version's bit for bit and the logits within float32 rounding of BCNet's
(`chip_smoke.py` phase 14f). The kernel takes 2 players, 1 to MAX_POTS pot
blocks (set by the net's input width, 56 + 20 a block), and an MLP of 1 to
MAX_HIDDEN hidden layers and actions each at most MAX_WIDTH wide; beyond
them it raises ValueError, with no fallback to the plain version. The state
and pool index checks, the launch and its count
(`_build.launches["oc_fused_bc"]`) are `ops/_build`'s.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from overcooked_ai_tpu_torch.core.constants import TERRAIN_POT
from overcooked_ai_tpu_torch.core.featurize import cost_rows, get_featurize_shape
from overcooked_ai_tpu_torch.ops import _build
from overcooked_ai_tpu_torch.planning.tables import INF_COST

NUM_PLAYERS = 2
MAX_POTS = 4  # pot blocks of the features; every committed proxy has 2
MAX_HIDDEN = 4  # hidden layers of the MLP; every committed proxy has 2
MAX_WIDTH = 64  # a hidden layer's or the actions' width; every committed proxy has (64, 64)
MAX_COST = 1 << 19  # finite motion costs stay below it, so cost * 4096 + rank fits int32
# the state leaves the kernel reads, each (leading shape, batch last)
READ_FIELDS = ("pos", "orient", "held", "held_soup", "obj", "soup_ing", "soup_tick", "obj_seq")


class EntryLayout(NamedTuple):
    """Word offsets of one table entry (csrc/fused_bc.cu `entry_layout`)."""

    terrain: int  # HW words, row-major
    time: int  # the (4, 4) cook times, [n_o * 4 + n_t]
    num_pots: int  # the number of pot cells
    pots: int  # HW words, the first num_pots the pot cells, row-major
    rows: int  # the cost rows, 4HW x HW
    words: int  # the entry's size


def entry_layout(num_cells: int) -> EntryLayout:
    rows = 2 * num_cells + 17
    return EntryLayout(0, num_cells, num_cells + 16, num_cells + 17, rows,
                       rows + 4 * num_cells * num_cells)


class BCTables(NamedTuple):
    """A layout's or pool's table entries and an MLP's weights on a card."""

    words: torch.Tensor  # (num_entries * entry_words,) int32
    num_entries: int
    entry_words: int
    height: int
    width: int
    weights: torch.Tensor  # (weights,) float32, `pack_weights`'s block
    widths: tuple  # the features, each hidden layer's width, the actions
    c_widths: ctypes.Array  # `widths` as the C int array the launch passes


def pack_entry(layout, feature_cost) -> np.ndarray:
    """One layout's entry: (entry words,) int32. feature_cost: its (4, H, W, H, W)."""
    terrain = np.asarray(layout.terrain)
    num_cells = terrain.size
    if num_cells > _build.MAX_HW:
        raise ValueError(f"the BC kernel takes grids of at most {_build.MAX_HW} cells, got "
                         f"{num_cells}")
    lay = entry_layout(num_cells)
    rows = cost_rows(feature_cost).numpy()
    if rows.shape != (4 * num_cells, num_cells):
        raise ValueError(f"motion costs of {rows.shape[1]} cells for a layout of {num_cells}")
    if (rows[rows < INF_COST] >= MAX_COST).any():
        raise ValueError(f"the BC kernel takes motion costs below {MAX_COST}")
    pots = _build.terrain_cells(terrain, TERRAIN_POT)
    words = np.zeros(lay.words, np.int64)
    words[lay.terrain:lay.terrain + num_cells] = terrain.reshape(-1)
    words[lay.time:lay.time + 16] = np.asarray(layout.time_table).reshape(-1)
    words[lay.num_pots] = pots.size
    words[lay.pots:lay.pots + pots.size] = pots
    words[lay.rows:] = rows.reshape(-1)
    return words.astype(np.int32)


def pack_words(layouts, feature_cost) -> np.ndarray:
    """The entries of a layout or pool, (N, entry words) int32. layouts: the
    N layouts; feature_cost: one (4, H, W, H, W) table, or their
    (N, 4, H, W, H, W) stack, of one grid shape."""
    fcs = np.asarray(feature_cost)
    fcs = fcs[None] if fcs.ndim == 5 else fcs
    if len(layouts) != len(fcs):
        raise ValueError(f"{len(layouts)} layouts for {len(fcs)} motion cost tables")
    return np.stack([pack_entry(lay, fc) for lay, fc in zip(layouts, fcs)])


def pack_weights(params: dict, net_arch, num_actions: int) -> tuple[torch.Tensor, tuple]:
    """A BCNet state dict -> (its weights as one float32 CPU block, the
    widths (features, *net_arch, actions)): Linear by Linear, W^T (in x
    out) row-major with zero columns up to a multiple of 4, then the bias
    as long (the kernel's 16-byte loads). Raises ValueError beyond the
    kernel's MAX_HIDDEN layers and MAX_WIDTH, or for features of no 1 to
    MAX_POTS pot blocks."""
    net_arch = tuple(net_arch)
    if not 1 <= len(net_arch) <= MAX_HIDDEN:
        raise ValueError(f"the BC kernel takes 1 to MAX_HIDDEN = {MAX_HIDDEN} hidden layers, "
                         f"got {len(net_arch)}")
    if not all(1 <= w <= MAX_WIDTH for w in (*net_arch, num_actions)):
        raise ValueError(f"the BC kernel takes widths of 1 to MAX_WIDTH = {MAX_WIDTH}, got "
                         f"net_arch {net_arch} and {num_actions} actions")
    names = [f"hidden.{i}" for i in range(len(net_arch))] + ["logits"]
    blocks = []
    widths = (int(params["hidden.0.weight"].shape[1]), *net_arch, num_actions)
    # the features' width sets the pot blocks the kernel writes
    if widths[0] not in [get_featurize_shape(NUM_PLAYERS, k)[0] for k in range(1, MAX_POTS + 1)]:
        raise ValueError(f"the BC kernel takes the features of 1 to MAX_POTS = {MAX_POTS} pot "
                         f"blocks, not {widths[0]}")
    for name, n_in, n_out in zip(names, widths[:-1], widths[1:]):
        weight, bias = params[f"{name}.weight"], params[f"{name}.bias"]
        if weight.shape != (n_out, n_in) or bias.shape != (n_out,):
            raise ValueError(f"{name}: want ({n_out}, {n_in}) and ({n_out},), got "
                             f"{tuple(weight.shape)} and {tuple(bias.shape)}")
        block = torch.zeros((n_in + 1, -(-n_out // 4) * 4))
        block[:n_in, :n_out] = weight.detach().float().cpu().T
        block[n_in, :n_out] = bias.detach().float().cpu()
        blocks.append(block.reshape(-1))
    return torch.cat(blocks), widths


def pack(layouts, feature_cost, params: dict, net_arch, num_actions: int, device) -> BCTables:
    """`pack_words` and `pack_weights` copied to a card once; checks the
    entry size against the kernel's."""
    words = pack_words(layouts, feature_cost)
    weights, widths = pack_weights(params, net_arch, num_actions)
    H, W = np.asarray(layouts[0].terrain).shape
    if _build.load().oc_bc_entry_words(H * W) != words.shape[1]:
        raise RuntimeError("the BC entry has another size in C than in Python")
    return BCTables(torch.from_numpy(words.reshape(-1)).to(device), words.shape[0],
                    words.shape[1], H, W, weights.to(device), widths,
                    (ctypes.c_int * len(widths))(*widths))


def launch_kernel(tables: BCTables, state, pool_idx=None, with_features: bool = False):
    """The kernel alone: the logits (B * 2, A) float32, row b * 2 + p for
    player p of env b, and with `with_features` also the features (B * 2,
    F). pool_idx (B,) names each lane's entry (`_build.pool_index`); None
    for a single layout's."""
    dev = state.obj.device
    if tables.words.device != dev or tables.weights.device != dev:
        raise ValueError(f"the BC kernel's tables are on {tables.words.device}, the state on "
                         f"{dev}")
    _build.check_state("BC", state, READ_FIELDS, NUM_PLAYERS, tables.height, tables.width, dev)
    batch = state.obj.shape[-1]
    pool_idx = _build.pool_index("BC", pool_idx, tables.num_entries, batch, dev)
    rows = NUM_PLAYERS * batch
    logits = torch.empty((rows, tables.widths[-1]), dtype=torch.float32, device=dev)
    feats = torch.empty((rows, tables.widths[0]), dtype=torch.float32, device=dev) \
        if with_features else None
    _build.launch(
        "oc_fused_bc", dev, tables.words.data_ptr(), tables.entry_words, tables.num_entries,
        None if pool_idx is None else pool_idx.data_ptr(), tables.height, tables.width, batch,
        tables.weights.data_ptr(), len(tables.widths) - 1, tables.c_widths,
        *(getattr(state, name).data_ptr() for name in READ_FIELDS), logits.data_ptr(),
        None if feats is None else feats.data_ptr())
    return (logits, feats) if with_features else logits
