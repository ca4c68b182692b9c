"""The BC partner kernel's CPU side (`ops/fused_bc.py`; the kernel itself,
`csrc/fused_bc.cu`, runs only on a card: `chip_smoke.py` phase 14f holds it
against the plain version there).

- The word block decodes back to each shipped layout's tables and to a
  pool's, entry by entry, at the C offsets; the weight block decodes back
  to each committed proxy's net and to nets of other depths and widths.
- The launch refuses tables on another device and a pool index it cannot
  read, before any launch (its state guard: `test_torch_kernel_guards.py`).
- The dispatch: on CPU states the partners (`bc_policy_batch`,
  `bc_policy_batch_pool`) and the agent (`bc_policy_fn`) launch nothing and
  return the plain version's logits, `featurize_batch` and `BCNet`
  (`tests/test_torch_bc.py` holds those against the JAX package).
"""

import glob
import os
import pickle

import numpy as np
import pytest
import torch

from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.constants import TERRAIN_POT
from overcooked_ai_tpu_torch.core.featurize import cost_rows, featurize_batch
from overcooked_ai_tpu_torch.core.layout import available_layouts, from_layout_name
from overcooked_ai_tpu_torch.ops import _build, fused_bc
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import bc

from .torch_states import crafted_states, rollout_states

PROXIES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "runs", "r4_bc", "*")))
CRAMPED = [d for d in PROXIES if d.endswith("bc_proxy_cramped_room")][0]


def _pool_specs(n=6, seed=11):
    g = gen.LayoutGenerator(outer_shape=(9, 7), prop_feats=0.6, rng=np.random.RandomState(seed))
    return [g.generate_spec(name=f"g{i}") for i in range(n)]


def _decode(words, H, W):
    """An entry of the BC kernel's word block, read at csrc/fused_bc.cu's
    offsets: the terrain, the cook times, the pot cells, the cost rows."""
    hw = H * W
    n_pots = words[hw + 16]
    out = {"terrain": words[:hw].reshape(H, W), "time_table": words[hw:hw + 16].reshape(4, 4),
           "pots": words[hw + 17:hw + 17 + n_pots],
           "rows": words[2 * hw + 17:].reshape(4 * hw, hw)}
    assert words.size == 2 * hw + 17 + 4 * hw * hw == fused_bc.entry_layout(hw).words
    return out


@pytest.mark.parametrize("name", available_layouts() + ["pool"])
def test_bc_kernel_words_decode_to_the_tables(name):
    specs = _pool_specs() if name == "pool" else [from_layout_name(name)]
    fcs = [build_motion_tables(s.layout.terrain).feature_cost for s in specs]
    words = fused_bc.pack_words([s.layout for s in specs], np.stack(fcs) if len(fcs) > 1
                                else fcs[0])
    assert words.dtype == np.int32 and words.shape[0] == len(specs)
    for row, spec, fc in zip(words, specs, fcs):
        terrain = np.asarray(spec.layout.terrain)
        got = _decode(row, *terrain.shape)
        np.testing.assert_array_equal(got["terrain"], terrain)
        np.testing.assert_array_equal(got["time_table"], np.asarray(spec.layout.time_table))
        np.testing.assert_array_equal(got["pots"], np.flatnonzero(terrain == TERRAIN_POT))
        np.testing.assert_array_equal(got["rows"], cost_rows(fc).numpy())


def _net_params(net_arch, seed=0, num_actions=6, obs_dim=96):
    cfg = bc.BCConfig(net_arch=net_arch, num_actions=num_actions)
    net = bc.BCNet(cfg, obs_dim, torch.Generator().manual_seed(seed))
    for p in net.parameters():  # nonzero biases, so that the decode sees them
        torch.nn.init.normal_(p, generator=torch.Generator().manual_seed(seed + 1))
    return net.state_dict(), cfg


NETS = {os.path.basename(d): d for d in PROXIES}
NETS.update({"one_hidden_32": ((32,), 6), "three_hidden_ragged": ((64, 17, 5), 3)})


@pytest.mark.parametrize("case", list(NETS))
def test_bc_kernel_weights_decode_to_the_net(case):
    """Linear by Linear, W^T with its columns padded to a multiple of 4,
    then the bias padded the same way; the widths as the kernel reads them."""
    if isinstance(NETS[case], str):
        params, cfg = bc.load_bc_model(NETS[case])
    else:
        params, cfg = _net_params(NETS[case][0], num_actions=NETS[case][1])
    block, widths = fused_bc.pack_weights(params, cfg.net_arch, cfg.num_actions)
    assert block.dtype == torch.float32 and widths == (96, *cfg.net_arch, cfg.num_actions)
    names = [f"hidden.{i}" for i in range(len(cfg.net_arch))] + ["logits"]
    o = 0
    for name, n_in, n_out in zip(names, widths[:-1], widths[1:]):
        n4 = -(-n_out // 4) * 4
        layer = block[o:o + (n_in + 1) * n4].reshape(n_in + 1, n4)
        assert torch.equal(layer[:n_in, :n_out], params[f"{name}.weight"].T)
        assert torch.equal(layer[n_in, :n_out], params[f"{name}.bias"])
        assert not layer[:, n_out:].any()
        o += (n_in + 1) * n4
    assert o == block.numel() and o % 4 == 0


def _state(batch=8):
    spec = from_layout_name("counter_circuit_o_1order")
    return spec, rollout_states(spec.layout, batch, (20,), seed=1)[20]


def _tables(spec, num_entries=1, device="cpu", widths=(96, 64, 64, 6)):
    H, W = spec.layout.terrain.shape
    words = fused_bc.entry_layout(H * W).words
    return fused_bc.BCTables(torch.zeros(num_entries * words, dtype=torch.int32, device=device),
                             num_entries, words, H, W, torch.zeros(8, device=device), widths,
                             None)


LAUNCH_GUARDS = {
    "tables_on_another_device": (dict(device="meta"), {}, "tables are on meta"),
    "pool_index_out_of_range": (dict(num_entries=2), dict(pool_idx=np.array([0, 1, 2] + [0] * 5)),
                                "pool_idx names entries 0..2 of 2"),
    "negative_pool_index": (dict(num_entries=2), dict(pool_idx=np.full(8, -1)),
                            "pool_idx names entries -1..-1 of 2"),
    "pool_index_of_another_batch": (dict(num_entries=2), dict(pool_idx=np.zeros(3, np.int64)),
                                    "pool_idx must be"),
    "pool_without_pool_index": (dict(num_entries=2), {}, "needs pool_idx"),
}


@pytest.mark.parametrize("case", list(LAUNCH_GUARDS))
def test_bc_kernel_launch_refuses_before_loading_the_kernel(case):
    spec, state = _state()
    table_kw, launch_kw, match = LAUNCH_GUARDS[case]
    with pytest.raises(ValueError, match=match):
        fused_bc.launch_kernel(_tables(spec, **table_kw), state, **launch_kw)


PACK_GUARDS = {
    "no_pot_blocks": (dict(net_arch=(64, 64), obs_dim=56), "MAX_POTS"),
    "too_many_pot_blocks": (dict(net_arch=(64, 64), obs_dim=56 + 20 * (fused_bc.MAX_POTS + 1)),
                            "MAX_POTS"),
    "features_of_no_pot_blocks": (dict(net_arch=(64, 64), obs_dim=100), "not 100"),
    "widened_net_arch": (dict(net_arch=(128, 64)), "MAX_WIDTH"),
    "too_many_actions": (dict(net_arch=(64, 64), num_actions=fused_bc.MAX_WIDTH + 1), "MAX_WIDTH"),
    "too_deep": (dict(net_arch=(8,) * (fused_bc.MAX_HIDDEN + 1)), "MAX_HIDDEN"),
}


@pytest.mark.parametrize("case", list(PACK_GUARDS))
def test_bc_kernel_refuses_a_net_it_does_not_take(case):
    kw, match = PACK_GUARDS[case]
    params, cfg = _net_params(**kw)
    with pytest.raises(ValueError, match=match):
        fused_bc.pack_weights(params, cfg.net_arch, cfg.num_actions)


def test_bc_kernel_refuses_params_unlike_the_config_and_tables_unlike_the_layouts():
    params, _ = _net_params((64, 64))
    with pytest.raises(ValueError, match="hidden.1: want"):
        fused_bc.pack_weights(params, (64, 32), 6)
    specs = [from_layout_name("cramped_room"), from_layout_name("counter_circuit_o_1order")]
    fc = build_motion_tables(specs[0].layout.terrain).feature_cost
    with pytest.raises(ValueError, match="motion costs of 20 cells for a layout of 40"):
        fused_bc.pack_words([s.layout for s in specs], np.stack([fc, fc]))
    with pytest.raises(ValueError, match="2 layouts for 1"):
        fused_bc.pack_words([s.layout for s in specs], fc)
    wide = gen.LayoutGenerator(outer_shape=(13, 11),
                               rng=np.random.RandomState(0)).generate_spec(name="wide")
    with pytest.raises(ValueError, match="at most 128 cells"):
        fused_bc.pack_words([wide.layout], build_motion_tables(wide.layout.terrain).feature_cost)


def _plain(params, cfg, layout, feature_cost, state, pool_idx=None):
    """Today's plain path: featurize_batch, then BCNet, on the CPU."""
    feats = featurize_batch(layout, cost_rows(feature_cost), state, pool_idx=pool_idx)
    with torch.no_grad():
        return bc.bc_net(params, cfg, "cpu")(feats.reshape(-1, feats.shape[-1]))


@pytest.mark.parametrize("layout", ["cramped_room", "counter_circuit_o_1order", "pool"])
def test_partners_and_agent_launch_nothing_on_cpu_states(layout):
    """The dispatch: on the CPU the wrapper returns the plain version's
    logits (crafted tie states included) and the kernel's counter stays 0."""
    params, cfg = bc.load_bc_model(CRAMPED)
    _build.launches.clear()
    if layout == "pool":
        specs = _pool_specs(4, seed=3)
        fcs = [build_motion_tables(s.layout.terrain).feature_cost for s in specs]
        idx = torch.from_numpy(np.random.RandomState(1).randint(0, 4, size=20))
        lanes = gen.gather_lanes(gen.stack_layouts(specs), idx.numpy())
        partner = bc.bc_policy_batch_pool(specs, fcs, params, cfg)
        for state in rollout_states(lanes, 20, (10, 80), seed=3).values():
            want = _plain(params, cfg, lanes, np.stack(fcs), state, idx)
            assert torch.equal(partner.logits(lanes, state, idx), want)
        assert not _build.launches
        return
    spec = from_layout_name(layout)
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    states = [crafted_states(spec, 24, seed=7),
              rollout_states(spec.layout, 16, (60,), seed=2)[60]]
    partner = bc.bc_policy_batch(spec, fc, params, cfg, stochastic=False)
    agent = bc.bc_policy_fn(spec, fc, params, cfg, stochastic=False)
    for state in states:
        want = _plain(params, cfg, spec.layout, fc, state)
        assert torch.equal(partner.logits(spec.layout, state), want)
        B = state.obj.shape[-1]
        acts = torch.argmax(want, -1).view(B, 2)
        got = partner(None, spec.layout, state)
        assert got.dtype == torch.int32 and torch.equal(got, acts.T.int())
        for i in (0, 1):
            assert torch.equal(agent(None, spec.layout, state, i), acts[:, i].int())
        again = pickle.loads(pickle.dumps(partner))  # pickled without its per-device copies
        assert again._on == {} and torch.equal(again.logits(spec.layout, state), want)
    assert not _build.launches
