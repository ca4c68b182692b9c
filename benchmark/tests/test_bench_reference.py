"""The plain reference agrees with the port on the CPU at tiny sizes, and a
whole run of each cell on the CPU comes out correct. Only these tests import
both the reference and the port."""

import json
import os

import numpy as np
import pytest
import torch

from cpu_run import TINY, cpu_run
from harness.core import BENCH_DIR, find_config, load_module
from harness.weights import glorot_weights, ppo_shapes


def _config(name):
    with open(os.path.join(BENCH_DIR, "layouts", f"{name}.json")) as f:
        return json.load(f)


def _pool():
    with open(os.path.join(BENCH_DIR, "layouts", "bench_pool64.json")) as f:
        return json.load(f)["layouts"][:8]


def _specs():
    from overcooked_ai_tpu_torch.core import layout as port
    from reference import layout as ref

    cfg = _config("cramped_room")
    return port.build_layout("cramped_room", cfg), ref.build_layout("cramped_room", cfg)


def test_env_step_encoding_featurize_and_phi_match_the_port():
    from overcooked_ai_tpu_torch.core import encoding as pe, env as penv, featurize as pf
    from overcooked_ai_tpu_torch.core.potential import make_potential_fn
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables as port_tables
    from reference import encoding as re_, env as renv, featurize as rf, potential as rp
    from reference.tables import build_motion_tables as ref_tables

    pspec, rspec = _specs()
    B = 16
    ps, rs = penv.batch_reset(pspec.layout, B, "cpu"), renv.batch_reset(rspec.layout, B, "cpu")
    pfc = port_tables(pspec.layout.terrain).feature_cost
    rfc = ref_tables(rspec.layout.terrain).feature_cost
    assert np.array_equal(pfc, rfc)
    phi_port = make_potential_fn(pspec, pfc)
    ptab = rp.tables_on(rp.build_potential_tables(rspec), "cpu")
    g = torch.Generator().manual_seed(3)
    for _ in range(60):
        act = torch.randint(6, (2, B), generator=g, dtype=torch.int32)
        pt, rt = penv.env_step(pspec.layout, ps, act, 400), renv.env_step(rspec.layout, rs, act,
                                                                            400)
        for a, b in zip(pt.obs_state, rt.obs_state):
            assert torch.equal(a, b)
        assert torch.equal(pt.sparse_reward, rt.sparse_reward)
        assert torch.equal(pt.shaped_reward, rt.shaped_reward)
        assert torch.equal(pt.events, rt.events)
        ps, rs = pt.obs_state, rt.obs_state
        assert torch.equal(pe.encode_nhwc(pspec.layout, ps, 400),
                           re_.encode_nhwc(rspec.layout, rs, 400))
        assert torch.equal(pf.featurize_batch(pspec.layout, pfc, ps),
                           rf.featurize_batch(rspec.layout, rfc, rs))
        assert torch.equal(phi_port(pspec.layout, ps),
                           rp.potential(rspec.layout, ptab, rf.cost_rows(rfc), rs))


def test_pool_rollout_and_murmur3_match_the_port():
    from overcooked_ai_tpu_torch.core import layout as pl, layout_generator as pg
    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.ops.fused_pool import check_pool_uniform, fused_pool_rollout_random
    from overcooked_ai_tpu_torch.ops.fused_rollout import murmur3_actions
    from reference import layout as rl, pool as rpool
    from reference.env import murmur3_actions as ref_murmur3

    cfgs = _pool()
    specs = [pl.build_layout(f"p{i}", c) for i, c in enumerate(cfgs)]
    lanes = torch.arange(24) % len(cfgs)
    lay = pg.gather_lanes(pl.layout_on(pg.stack_layouts(specs), "cpu"), lanes)
    st = batch_reset(lay, 24, "cpu")
    out, ret = fused_pool_rollout_random(check_pool_uniform(specs), lay, st, 77, 450)
    rspecs = [rl.build_layout(f"p{i}", c) for i, c in enumerate(cfgs)]
    rlay = rpool.gather_lanes(rl.layout_on(rpool.stack_layouts(rspecs), "cpu"), lanes)
    from reference.state import State

    rout, rret = load_module("drivers", "random_play").reference_rollout(rlay, State(*st), 77, 450, 400)
    assert all(torch.equal(a, b) for a, b in zip(out, rout)) and torch.equal(ret, rret)
    assert torch.equal(murmur3_actions(2**31 + 5, 9, 2, 24, "cpu"),
                       ref_murmur3(2**31 + 5, 9, 2, torch.arange(24)))


def test_the_reference_net_and_bc_mlp_match_the_port():
    from overcooked_ai_tpu_torch.training.bc import bc_net, load_bc_model
    from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet
    from reference import learner as L

    net_cfg = find_config("ppo_cnn")["net"]
    w = glorot_weights(ppo_shapes(net_cfg, 4, 5), 11, "cpu")
    net = PPONet(NetConfig(**net_cfg), 4, 5)
    net.load_state_dict(w)
    obs = torch.randint(0, 3, (7, 4, 5, 26), dtype=torch.int8)
    lg, v = net(obs)
    rlg, rv = L.net_forward(w, obs, 3, 3)
    torch.testing.assert_close(lg, rlg, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-6)
    proxy = os.path.join(BENCH_DIR, "configs", "bc_proxy_cramped_room")
    params, cfg = load_bc_model(proxy)
    x = torch.randn(5, 96)
    torch.testing.assert_close(bc_net(params, cfg, "cpu")(x),
                               L.bc_forward(L.read_bc_mlp(os.path.join(proxy, "params.msgpack"),
                                                          "cpu"), x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_whole_run_on_the_cpu_is_correct(cell):
    out = cpu_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
