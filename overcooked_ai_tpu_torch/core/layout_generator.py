"""Procedural layout generation and stacked layout pools (port of
`overcooked_ai_tpu.core.layout_generator`).

`LayoutGenerator` digs a random room of `inner_shape` at a random offset
inside `outer_shape`, places at least one pot, onion dispenser, dish
dispenser and serving counter plus proportional extras, picks random start
positions and optionally random orders. It runs on the host with numpy's
`RandomState` and draws from it in exactly the JAX generator's order, so one
seed and one set of parameters give the same `LayoutSpec`s field for field.

`stack_layouts` stacks a pool of same-shape layouts leaf-wise on a trailing
axis; `gather_lanes` picks one pool entry per env lane, which gives every
env of a batch its own layout (the reference's `num_mdp=inf` mode). The
plain step, the encoding and the env accept such a per-lane `Layout`, and
the pool kernels (`ops/fused_pool.py`) take it packed as per-lane words.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from overcooked_ai_tpu_torch.core.layout import Layout, LayoutSpec, build_layout
from overcooked_ai_tpu_torch.core.state import State

DEFAULT_PROP_EMPTY = 0.95
DEFAULT_PROP_FEATS = 0.1


class MDPParamsGenerator:
    """Curriculum hook: generation params per episode or reset from outside
    information (reference MDPParamsGenerator). The schedule fn receives a
    dict (e.g. {"progress": 0.3}) and returns the kwargs for
    LayoutGenerator / generate_spec."""

    def __init__(self, params_schedule_fn):
        if not callable(params_schedule_fn):
            raise TypeError("params scheduling function must be a callable")
        self.params_schedule_fn = params_schedule_fn

    @staticmethod
    def from_fixed_param(mdp_params_always):
        return MDPParamsGenerator(lambda _ignored: mdp_params_always)

    def generate(self, outside_information=None):
        params = self.params_schedule_fn(outside_information or {})
        if not isinstance(params, dict):
            raise TypeError(f"the schedule must return a dict, got {type(params).__name__}")
        return params


def spec_gen_fn_from_dict(mdp_params=None, outer_shape=(5, 4), mdp_params_schedule_fn=None,
                          seed=0):
    """Layout-spec generator factory (reference
    LayoutGenerator.mdp_gen_fn_from_dict).

    Returns gen(outside_information={}) -> LayoutSpec; each call generates a
    fresh layout with the (possibly scheduled) params. Params keys:
    prop_empty, prop_feats, inner_shape, num_players, random_orders; any
    other key overrides the layout config.
    """
    if mdp_params is not None and mdp_params_schedule_fn:
        raise ValueError("either fixed params or a schedule fn, not both")
    pgen = (
        MDPParamsGenerator(mdp_params_schedule_fn)
        if mdp_params_schedule_fn
        else MDPParamsGenerator.from_fixed_param(mdp_params or {})
    )
    rng = np.random.RandomState(seed)
    counter = [0]

    def gen(outside_information=None):
        params = dict(pgen.generate(outside_information))
        random_orders = params.pop("random_orders", False)
        gen_keys = {
            k: params.pop(k)
            for k in ("inner_shape", "prop_empty", "prop_feats", "num_players")
            if k in params
        }
        lg = LayoutGenerator(outer_shape=outer_shape, rng=rng, **gen_keys)
        counter[0] += 1
        return lg.generate_spec(name=f"gen_{counter[0]}", random_orders=random_orders, **params)

    return gen


class LayoutGenerator:
    """Procedural generator with the reference's knobs."""

    def __init__(self, outer_shape=(5, 4), inner_shape=None, prop_empty=DEFAULT_PROP_EMPTY,
                 prop_feats=DEFAULT_PROP_FEATS, num_players=2,
                 rng: Optional[np.random.RandomState] = None):
        self.outer_shape = tuple(outer_shape)  # (width, height)
        self.inner_shape = tuple(inner_shape or outer_shape)
        self.prop_empty = prop_empty
        self.prop_feats = prop_feats
        self.num_players = num_players
        self.rng = rng or np.random.RandomState()

    def _dig_room(self, w, h):
        """Bool grid (h, w) of empty cells: interior cells dug in random
        order until the empty proportion is reached and they connect."""
        interior = [(x, y) for y in range(1, h - 1) for x in range(1, w - 1)]
        target = max(int(len(interior) * self.prop_empty), 1)
        empty = set()
        order = list(interior)
        self.rng.shuffle(order)
        for cell in order:
            if len(empty) >= target and self._connected(empty):
                break
            empty.add(cell)
        # keep digging until connected
        rest = [c for c in order if c not in empty]
        for cell in rest:
            if self._connected(empty):
                break
            empty.add(cell)
        grid = np.zeros((h, w), bool)
        for x, y in empty:
            grid[y, x] = True
        return grid

    @staticmethod
    def _connected(cells):
        if not cells:
            return False
        cells = set(cells)
        start = next(iter(cells))
        seen = {start}
        stack = [start]
        while stack:
            x, y = stack.pop()
            for nb in ((x + 1, y), (x - 1, y), (x, y + 1), (x, y - 1)):
                if nb in cells and nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        return len(seen) == len(cells)

    def generate_grid(self):
        """A terrain char grid with the players placed."""
        ow, oh = self.outer_shape
        iw, ih = self.inner_shape
        if iw > ow or ih > oh:
            raise ValueError(f"inner shape {self.inner_shape} exceeds outer {self.outer_shape}")
        # random offset of the inner room in the outer shape
        ox = self.rng.randint(0, ow - iw + 1)
        oy = self.rng.randint(0, oh - ih + 1)
        empty = np.zeros((oh, ow), bool)
        empty[oy:oy + ih, ox:ox + iw] = self._dig_room(iw, ih)

        grid = np.full((oh, ow), "X", dtype="<U1")
        grid[empty] = " "

        # walls next to an empty cell are feature candidates
        cand = []
        for y in range(oh):
            for x in range(ow):
                if grid[y, x] != "X":
                    continue
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nx, ny = x + dx, y + dy
                    if 0 <= nx < ow and 0 <= ny < oh and empty[ny, nx]:
                        cand.append((x, y))
                        break
        self.rng.shuffle(cand)
        required = ["P", "O", "D", "S"]
        n_extra = int(max(len(cand) - len(required), 0) * self.prop_feats)
        feats = required + [self.rng.choice(required) for _ in range(n_extra)]
        if len(cand) < len(required):
            raise ValueError("not enough walls for features")
        for f, (x, y) in zip(feats, cand):
            grid[y, x] = f

        # random start positions
        empties = [tuple(p) for p in np.argwhere(empty)]
        if len(empties) < self.num_players:
            raise ValueError("not enough space for players")
        idxs = self.rng.choice(len(empties), self.num_players, replace=False)
        for i, k in enumerate(idxs):
            y, x = empties[k]
            grid[y, x] = str(i + 1)
        return ["".join(row) for row in grid]

    def generate_random_orders(self, n=2, min_size=2, max_size=3):
        """Random unique recipes (reference Recipe.generate_random_recipes)."""
        combos = [
            (o, s - o) for s in range(min_size, max_size + 1) for o in range(s + 1)
        ]
        picks = self.rng.choice(len(combos), min(n, len(combos)), replace=False)
        return [
            {"ingredients": ["onion"] * combos[k][0] + ["tomato"] * combos[k][1]}
            for k in picks
        ]

    def generate_spec(self, name=None, random_orders=False, **cfg) -> LayoutSpec:
        """A valid generated layout; a draw that `build_layout` rejects is
        drawn again, up to 100 times."""
        for attempt in range(100):
            try:
                grid = self.generate_grid()
                config = {
                    "grid": "\n".join(grid),
                    "start_all_orders": (
                        self.generate_random_orders()
                        if random_orders
                        else [{"ingredients": ["onion"] * 3}]
                    ),
                    **cfg,
                }
                return build_layout(name or f"generated_{attempt}", config)
            except ValueError:
                continue
        raise RuntimeError("layout generation failed after 100 attempts")


def stack_layouts(specs: Sequence[LayoutSpec]) -> Layout:
    """Stack same-shape layouts leaf-wise on a trailing axis -> a pool
    `Layout` whose every leaf ends in the pool axis N (numpy)."""
    layouts = [s.layout for s in specs]
    if not layouts:
        raise ValueError("an empty pool")
    shapes = {np.asarray(lay.terrain).shape for lay in layouts}
    if len(shapes) != 1:
        raise ValueError(f"layouts must share a grid shape, got {shapes}")
    players = {np.asarray(lay.start_state.pos).shape[0] for lay in layouts}
    if len(players) != 1:
        raise ValueError(f"layouts must share the player count, got {players}")

    def stack(leaves):
        return np.stack([np.asarray(x) for x in leaves], axis=-1)

    tables = (stack(leaves) for leaves in zip(*(lay[:-1] for lay in layouts)))
    start = State(*(stack(leaves) for leaves in zip(*(lay.start_state for lay in layouts))))
    return Layout(*tables, start_state=start)


def gather_lanes(pool: Layout, idx) -> Layout:
    """One pool entry per env lane: every leaf indexed `leaf[..., idx]`.

    numpy leaves take a numpy `idx`, tensors a tensor `idx` on their device.
    """
    start = State(*(leaf[..., idx] for leaf in pool.start_state))
    return Layout(*(leaf[..., idx] for leaf in pool[:-1]), start_state=start)
