"""The one launch path of the port's kernels (`ops/_build`), on the CPU.

- The state guard (`_build.check_state`) as each launcher calls it: B1
  (`fused_train`), B2 (`fused_rollout`), B3 and B4 (`fused_pool`), phi
  (`fused_phi`) and BC (`fused_bc`) each refuse, with a ValueError naming
  the leaf, a state whose leaves they read through raw pointers in another
  dtype, shape, layout or device, another player count or no env, before
  the kernel library is loaded (here it cannot be: no nvcc).
- The actions guard (`_build.check_actions`) of the four env launchers.
- `_build.launch` passes the stream last, counts a launch in
  `_build.launches` by its C entry and raises on a failed one, uncounted.
- Every public entry on CPU tensors runs the plain version and launches
  nothing.
"""

import functools
import types

import numpy as np
import pytest
import torch

from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.core.layout_generator import gather_lanes, stack_layouts
from overcooked_ai_tpu_torch.core.potential import make_potential_fn, make_potential_fn_pool
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build, fused_bc, fused_phi, fused_pool, fused_rollout
from overcooked_ai_tpu_torch.ops import fused_train
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import bc

from .torch_states import rollout_states

B, T = 8, 3  # envs, and steps of the rollout kernels' actions


@functools.lru_cache(maxsize=None)
def _setup():
    """A 2-pot layout's states after 20 random steps, and the layout as a
    pool of one lane layout per env for B3 and B4."""
    spec = from_layout_name("counter_circuit_o_1order")
    state = rollout_states(spec.layout, B, (20,), seed=1)[20]
    lanes = gather_lanes(stack_layouts([spec]), np.zeros(B, np.int64))
    return spec, state, fused_pool.pool_data(spec, lanes, "cpu")


def _actions(steps):
    return torch.zeros((*steps, 2, B), dtype=torch.int32)


def _phi_tables(num_pots=2):
    spec = _setup()[0]
    H, W = spec.layout.terrain.shape
    return fused_phi.PhiTables(torch.zeros(1, dtype=torch.int32), 1, 1, num_pots, H, W)


def _bc_tables():
    spec = _setup()[0]
    H, W = spec.layout.terrain.shape
    words = fused_bc.entry_layout(H * W).words
    return fused_bc.BCTables(torch.zeros(words, dtype=torch.int32), 1, words, H, W,
                             torch.zeros(8), (96, 64, 64, 6), None)


# kernel -> (the leaves it reads, its launcher called on `state` with good
# actions and tables)
KERNELS = {
    "B1": (State._fields, lambda s, acts=None: fused_train.launch_kernel(
        _setup()[0].layout, s, _actions(()) if acts is None else acts, 400, 400)),
    "B2": (State._fields, lambda s, acts=None: fused_rollout.launch_kernel(
        _setup()[0].layout, s, 0, _actions((T,)) if acts is None else acts, T, 400)),
    "B3": (State._fields, lambda s, acts=None: fused_pool._launch_train(
        _setup()[2], s, _actions(()) if acts is None else acts, 400, 400)),
    "B4": (State._fields, lambda s, acts=None: fused_pool.launch_rollout_kernel(
        _setup()[2], s, 0, _actions((T,)) if acts is None else acts, T, 400)),
    "phi": (fused_phi.READ_FIELDS, lambda s: fused_phi.launch_kernel(_phi_tables(), s)),
    "BC": (fused_bc.READ_FIELDS, lambda s: fused_bc.launch_kernel(_bc_tables(), s)),
}


def _three_players(state):
    return state._replace(**{f: torch.cat([getattr(state, f), getattr(state, f)[:1]])
                             for f in ("pos", "orient", "held", "held_soup", "held_soup_tick")})


def _strided(x):
    return x.movedim(-1, 0).contiguous().movedim(0, -1)  # same values, batch axis outermost


# case -> (the leaf it edits, None for every kernel; the edit; the refusal)
CASES = {
    "three_players": (None, _three_players, "takes 2 players, got 3"),
    "no_envs": (None, lambda s: State(*(x[..., :0].contiguous() for x in s)),
                "needs at least one env"),
    "non_contiguous_leaf": ("soup_ing", lambda s: s._replace(soup_ing=_strided(s.soup_ing)),
                            "contiguous=False"),
    "wrong_grid": ("obj", lambda s: s._replace(obj=s.obj[:, :-1].contiguous()),
                   r"state.obj: want contiguous int32"),
    "leaf_on_another_device": ("pos", lambda s: s._replace(pos=s.pos.to("meta")),
                               "state.pos must be a tensor on cpu"),
    **{f"int64_{leaf}": (leaf, lambda s, leaf=leaf: s._replace(**{leaf: getattr(s, leaf).long()}),
                         rf"state.{leaf}: want contiguous int32 .* got torch.int64")
       for leaf in State._fields},
}


@pytest.mark.parametrize("kernel,case", [
    (k, c) for k, (fields, _) in KERNELS.items() for c, (leaf, _, _) in CASES.items()
    if leaf is None or leaf in fields])
def test_kernel_guards_refuse_what_it_does_not_take(kernel, case):
    spec, state, _ = _setup()
    fields, launch = KERNELS[kernel]
    leaf, edit, match = CASES[case]
    H, W = spec.layout.terrain.shape
    _build.check_state(kernel, state, fields, 2, H, W, state.t.device)  # the unedited state
    with pytest.raises(ValueError, match=match):
        launch(edit(state))


@pytest.mark.parametrize("num_pots", [0, fused_phi.MAX_POTS + 1], ids=["no_pots", "too_many_pots"])
def test_phi_kernel_refuses_pot_counts_it_does_not_take(num_pots):
    state = _setup()[1]
    with pytest.raises(ValueError, match="MAX_POTS"):
        fused_phi.launch_kernel(_phi_tables(num_pots), state)


ACTIONS = {
    "int64": lambda a: a.long(),
    "another_batch": lambda a: a[..., :-1].contiguous(),
    "non_contiguous": _strided,
    "on_another_device": lambda a: a.to("meta"),
}


@pytest.mark.parametrize("case", list(ACTIONS))
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4"])
def test_env_kernels_refuse_actions_before_loading_the_kernel(kernel, case):
    state = _setup()[1]
    _, launch = KERNELS[kernel]
    acts = ACTIONS[case](_actions(() if kernel in ("B1", "B3") else (T,)))
    with pytest.raises(ValueError, match="actions must be contiguous int32"):
        launch(state, acts)


def test_launch_counts_each_entry_and_raises_on_a_failed_launch(monkeypatch):
    calls = []
    lib = types.SimpleNamespace(oc_fused_phi=lambda *a: calls.append(a) or 0,
                                oc_fused_bc=lambda *a: 700)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1234,
                        raising=False)
    dev = torch.device("cuda", 0)
    _build.launches.clear()
    _build.launch("oc_fused_phi", dev, 1, 2)
    _build.launch("oc_fused_phi", dev, 3, 4)
    assert calls == [(1, 2, 1234), (3, 4, 1234)]  # the current stream last
    with pytest.raises(RuntimeError, match="oc_fused_bc: kernel launch failed with cudaError 700"):
        _build.launch("oc_fused_bc", dev, 5)
    assert _build.launches == {"oc_fused_phi": 2}
    _build.launches.clear()


@functools.lru_cache(maxsize=None)
def _fixed():
    spec = from_layout_name("cramped_room")
    return spec, spec.layout, batch_reset(spec.layout, 4, "cpu")


@functools.lru_cache(maxsize=None)
def _pool():
    specs = [from_layout_name("cramped_room")] * 2
    idx = np.array([0, 1, 0, 1])
    lanes = gather_lanes(stack_layouts(specs), idx)
    return specs, lanes, batch_reset(lanes, 4, "cpu"), torch.from_numpy(idx)


def _bc_partner(pool):
    params, cfg = bc.BCNet(bc.BCConfig(), 96).state_dict(), bc.BCConfig()
    if pool:
        specs, lanes, state, idx = _pool()
        fcs = [build_motion_tables(s.layout.terrain).feature_cost for s in specs]
        return bc.bc_policy_batch_pool(specs, fcs, params, cfg)(
            lambda lg: lg.argmax(-1), lanes, state, idx)
    spec, lay, state = _fixed()
    fc = build_motion_tables(lay.terrain).feature_cost
    return bc.bc_policy_batch(spec, fc, params, cfg)(lambda lg: lg.argmax(-1), lay, state)


def _acts(*lead):
    return torch.ones((*lead, 2, 4), dtype=torch.int32)


ENTRIES = {
    "fused_train_step": lambda: fused_train.fused_train_step(*_fixed()[1:], _acts()),
    "fused_train_step_tiles": lambda: fused_train.fused_train_step_tiles(*_fixed()[1:], _acts()),
    "train_rollout_random": lambda: fused_train.train_rollout_random(
        *_fixed()[1:], 2, generator=torch.Generator().manual_seed(0)),
    "fused_rollout_random": lambda: fused_rollout.fused_rollout_random(*_fixed()[1:], 0, T),
    "fused_rollout_actions": lambda: fused_rollout.fused_rollout_actions(*_fixed()[1:],
                                                                         _acts(T)),
    "fused_pool_train_step": lambda: fused_pool.fused_pool_train_step(
        _pool()[0][0], *_pool()[1:3], _acts()),
    "fused_pool_train_step_tiles": lambda: fused_pool.fused_pool_train_step_tiles(
        _pool()[0][0], fused_pool.pool_data(_pool()[0][0], _pool()[1], "cpu"), _pool()[2],
        _acts()),
    "fused_pool_rollout_random": lambda: fused_pool.fused_pool_rollout_random(
        _pool()[0][0], *_pool()[1:3], 0, T),
    "fused_pool_rollout_random_tiles": lambda: fused_pool.fused_pool_rollout_random_tiles(
        _pool()[0][0], fused_pool.pool_data(_pool()[0][0], _pool()[1], "cpu"), _pool()[2], 0,
        T),
    "fused_pool_rollout_actions": lambda: fused_pool.fused_pool_rollout_actions(
        _pool()[0][0], *_pool()[1:3], _acts(T)),
    "fused_pool_rollout_actions_tiles": lambda: fused_pool.fused_pool_rollout_actions_tiles(
        _pool()[0][0], fused_pool.pool_data(_pool()[0][0], _pool()[1], "cpu"), _pool()[2],
        _acts(T)),
    "phi": lambda: make_potential_fn(
        _fixed()[0], build_motion_tables(_fixed()[1].terrain).feature_cost)(*_fixed()[1:]),
    "phi_pool": lambda: make_potential_fn_pool(_pool()[0])(_pool()[3], *_pool()[1:3]),
    "bc_partner": lambda: _bc_partner(pool=False),
    "bc_partner_pool": lambda: _bc_partner(pool=True),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_public_entries_on_the_cpu_launch_nothing(entry):
    _build.launches.clear()
    out = ENTRIES[entry]()
    assert out is not None
    assert not _build.launches  # CPU tensors: the plain version ran
