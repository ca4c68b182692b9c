# Frozen copy of stack_layouts and gather_lanes from
# overcooked_ai_tpu_torch/core/layout_generator.py at commit 594fcf2: the
# benchmark's plain reference, which later changes to the port do not move.
"""A layout pool: same-shape layouts stacked on a trailing axis, and one
pool entry per env lane."""

from __future__ import annotations

import numpy as np

from .layout import Layout
from .state import State


def stack_layouts(specs) -> Layout:
    """Stack same-shape layouts leaf-wise on a trailing axis (numpy)."""
    layouts = [s.layout for s in specs]

    def stack(leaves):
        return np.stack([np.asarray(x) for x in leaves], axis=-1)

    tables = (stack(leaves) for leaves in zip(*(lay[:-1] for lay in layouts)))
    start = State(*(stack(leaves) for leaves in zip(*(lay.start_state for lay in layouts))))
    return Layout(*tables, start_state=start)


def gather_lanes(pool: Layout, idx) -> Layout:
    """One pool entry per env lane: every leaf indexed `leaf[..., idx]`."""
    start = State(*(leaf[..., idx] for leaf in pool.start_state))
    return Layout(*(leaf[..., idx] for leaf in pool[:-1]), start_state=start)
