"""The phi kernel: the reward-shaping potential phi(s) of every env of a
batch in one launch.

`csrc/fused_phi.cu` replaces no TPU kernel: in the JAX package phi is XLA
ops that XLA fuses inside the jitted rollout. The port's plain version,
`core.potential.potential`, is about 380 PyTorch ops a call, and a PPO
rollout with phi calls it every step; the kernel is one launch.

The tables go to each device once, as one block of int32 words a layout
(`pack_words`; a pool's blocks stacked, each lane reading the entry its
pool index names, a single layout a pool of one): the `PotentialTables`
scalars, five (4, 4) tables (`opt_no`, `opt_nt`, `opt_disc_value` and the
layout's `delivery_value` and `time_table`), the pot cells, the serve
cells, `partial_order` and the cost rows (`entry_layout` gives the
offsets). On a card the kernel reads the layout fields from that block, not
from the layout passed with the state.

`core.potential.make_potential_fn` / `make_potential_fn_pool` call
`launch_kernel` on a CUDA state and the plain version on any other. On the
card the kernel matches the plain version bit for bit (`chip_smoke.py`
phase 14). It takes 2 players and 1 to MAX_POTS pots; beyond them a CUDA
state raises ValueError, with no fallback to the plain version. The state
and pool index checks, the launch and its count
(`_build.launches["oc_fused_phi"]`) are `ops/_build`'s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from overcooked_ai_tpu_torch.core.constants import TERRAIN_POT, TERRAIN_SERVE
from overcooked_ai_tpu_torch.core.featurize import cost_rows
from overcooked_ai_tpu_torch.ops import _build

MAX_POTS = 8  # every shipped layout has 1 or 2; partial_order has 3**K rows
HEAD_FIELDS = ("gamma", "steady_state_value", "max_delivery_steps", "max_pickup_steps",
               "pot_onion_steps", "pot_tomato_steps", "onion_value", "tomato_value")
TABLE_FIELDS = ("opt_no", "opt_nt", "opt_disc_value")  # then delivery_value, time_table
_FLOAT_FIELDS = ("gamma", "steady_state_value", "onion_value", "tomato_value", "opt_disc_value")
# the state leaves the kernel reads, each (leading shape, batch last)
READ_FIELDS = ("pos", "orient", "held", "held_soup", "obj", "soup_ing", "soup_tick")


class EntryLayout(NamedTuple):
    """Word offsets of one table entry (csrc/fused_phi.cu `entry_layout`)."""

    tables: int  # the five (4, 4) tables, 16 words each, [n_o * 4 + n_t]
    pots: int  # K pot cells, y * W + x, row-major
    num_serve: int  # the number of serve cells S
    serve: int  # HW words, the first S the serve cells
    partial: int  # partial_order, 3**K x K
    rows: int  # the cost rows, 4HW x HW
    words: int  # the entry's size


def entry_layout(num_pots: int, num_cells: int) -> EntryLayout:
    tables = len(HEAD_FIELDS)
    pots = tables + 16 * (len(TABLE_FIELDS) + 2)
    serve = pots + num_pots + 1
    partial = serve + num_cells
    rows = partial + 3**num_pots * num_pots
    return EntryLayout(tables, pots, pots + num_pots, serve, partial, rows,
                       rows + 4 * num_cells * num_cells)


class PhiTables(NamedTuple):
    """A layout's or pool's table entries on a card."""

    words: torch.Tensor  # (num_entries * entry_words,) int32
    num_entries: int
    entry_words: int
    num_pots: int
    height: int
    width: int


def pack_entry(ptab, layout, feature_cost) -> np.ndarray:
    """One layout's entry: (entry words,) int32. ptab: the layout's own
    (unstacked) `core.potential.PotentialTables`; layout: its `Layout`; feature_cost (4, H, W, H, W)."""
    terrain = np.asarray(layout.terrain)
    num_cells = terrain.size
    pots = ptab.pot_xy[:, 1].astype(np.int64) * terrain.shape[1] + ptab.pot_xy[:, 0]
    if not np.array_equal(pots, _build.terrain_cells(terrain, TERRAIN_POT)):
        raise ValueError("the potential's pots are not the layout's")
    lay = entry_layout(len(pots), num_cells)
    words = np.zeros(lay.words, np.int64)

    def put(at, name, x):
        x = np.asarray(x).reshape(-1)
        if name in _FLOAT_FIELDS:
            x = x.astype(np.float32).view(np.int32)
        words[at:at + x.size] = x

    for i, name in enumerate(HEAD_FIELDS):
        put(i, name, getattr(ptab, name))
    tables = [(f, getattr(ptab, f)) for f in TABLE_FIELDS]
    tables += [("delivery_value", layout.delivery_value), ("time_table", layout.time_table)]
    for i, (name, x) in enumerate(tables):
        put(lay.tables + 16 * i, name, x)
    words[lay.pots:lay.pots + len(pots)] = pots
    serve = _build.terrain_cells(terrain, TERRAIN_SERVE)
    words[lay.num_serve] = serve.size
    words[lay.serve:lay.serve + serve.size] = serve
    put(lay.partial, "partial_order", ptab.partial_order)
    put(lay.rows, "rows", cost_rows(feature_cost).numpy())
    return words.astype(np.int32)


def pack_words(entries) -> np.ndarray:
    """The entries of a layout or pool, (N, entry words) int32. entries:
    (PotentialTables, layout, feature_cost) a pool entry, of one grid shape
    and number of pots."""
    blocks = [pack_entry(*e) for e in entries]
    if len({b.size for b in blocks}) != 1:
        raise ValueError("a pool's layouts must have the same grid shape and number of pots")
    return np.stack(blocks)


def pack(entries, device) -> PhiTables:
    """`pack_words` copied to a card once; checks the entry size against
    the kernel's."""
    words = pack_words(entries)
    ptab, layout, _ = entries[0]
    H, W = np.asarray(layout.terrain).shape
    K = ptab.pot_xy.shape[0]
    if _build.load().oc_phi_entry_words(K, H * W) != words.shape[1]:
        raise RuntimeError("the phi entry has another size in C than in Python")
    return PhiTables(torch.from_numpy(words.reshape(-1)).to(device), words.shape[0],
                     words.shape[1], K, H, W)


def check_inputs(state, num_pots: int, height: int, width: int, device) -> None:
    """Raise ValueError unless the kernel takes `state`: 2 players, 1 to
    MAX_POTS pots, and the leaves it reads contiguous int32 batch-last
    planes of a height x width grid on `device`."""
    if not 1 <= num_pots <= MAX_POTS:
        raise ValueError(f"the phi kernel takes 1 to MAX_POTS = {MAX_POTS} pots, got {num_pots}")
    _build.check_state("phi", state, READ_FIELDS, 2, height, width, device)


def launch_kernel(tables: PhiTables, state, pool_idx=None) -> torch.Tensor:
    """The kernel alone, on CUDA tensors: phi (B,) float32. pool_idx (B,)
    names each lane's entry (`_build.pool_index`); None for a single
    layout's."""
    dev = state.obj.device
    check_inputs(state, tables.num_pots, tables.height, tables.width, dev)
    batch = state.obj.shape[-1]
    pool_idx = _build.pool_index("phi", pool_idx, tables.num_entries, batch, dev)
    out = torch.empty((batch,), dtype=torch.float32, device=dev)
    _build.launch(
        "oc_fused_phi", dev, tables.words.data_ptr(), tables.entry_words, tables.num_entries,
        None if pool_idx is None else pool_idx.data_ptr(), tables.num_pots, tables.height,
        tables.width, batch, *(getattr(state, name).data_ptr() for name in READ_FIELDS),
        out.data_ptr())
    return out
