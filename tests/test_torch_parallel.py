"""Data parallelism in the torch port (`parallel/mesh.py`,
`make_ppo(mesh=...)`, `parallel/dryrun.py`) on the CPU, over gloo.

The JAX package's mesh changes where the data lives, not what is computed
(`tests/test_parallel_and_checkpoint.py`): so here a one-rank mesh gives
the meshless iteration bit for bit, and two ranks (spawned once, by the
dry run's `launch`, the workers importing no JAX) hold bit-identical
params and KL coefficients, within PARAM_TOL of the one-process port
iteration on the same seed and with its integer metrics, because every
rank draws each random tensor at its global shape (a rank drawing at its
local shape would differ). Under JAX's draws, replayed from a file the
parent writes (as `tests/test_torch_ppo_learner.py`'s `_jax_hooks` makes
them), the two ranks match JAX's `make_ppo(mesh=make_mesh(8))` on
conftest's 8 virtual devices, on a fixed layout, a pool and PPO_BC + phi,
within the learner tests' tolerances.
"""

import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core import potential as jpot
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.parallel.mesh import make_mesh as jmake_mesh
from overcooked_ai_tpu.parallel.mesh import replicated as jreplicated
from overcooked_ai_tpu.training import bc as jbc
from overcooked_ai_tpu.training import ppo as jppo
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.parallel import dryrun
from overcooked_ai_tpu_torch.parallel.mesh import (
    Mesh,
    constrain_batch_minor,
    init_distributed,
    make_mesh,
    make_multihost_mesh,
    replicated,
    shard_batch_minor,
)
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import ppo
from overcooked_ai_tpu_torch.training.checkpoint import save_checkpoint
from overcooked_ai_tpu_torch.training.convert import params_from_jax, train_state_from_jax

from .test_torch_bc import CRAMPED
from .test_torch_ppo_learner import ATOL, EXACT, PARAM_TOL, RTOL
from .test_torch_ppo_bc import PHI_ATOL, PHI_RTOL

B, T, EPOCHS = 8, 40, 2  # JAX's 8-device mesh shards the 8 envs; 4 a rank here
CFG = dict(num_envs=B, horizon=T, num_sgd_iter=EPOCHS, sgd_minibatch_size=B * T // 4)
BC_CFG = dict(CFG, bc_schedule=[[0, 0.5], [float("inf"), 0.5]], use_phi=True,
              phi_event_mix=True)
BC_DIR = os.path.relpath(CRAMPED, dryrun.ROOT)
CPU = torch.device("cpu")
# 2 envs x 4 steps, minibatches of 4 samples: the permutation's first
# minibatch is env 0's samples alone (rank 1 has no member), its second
# env 1's (rank 0 has none)
SPARSE_CFG = dict(num_envs=2, horizon=4, num_sgd_iter=1, sgd_minibatch_size=2)
SPARSE_PERM = np.array([[0, 2, 4, 6, 1, 3, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15]])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_mesh(rank, size):
    return Mesh(None, rank, size, CPU)


def test_one_rank_mesh_without_a_group():
    """No process group: the mesh is this process alone, as JAX's one-process
    `make_mesh()`; more ranks need a group."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device, mesh.axis_name) == (
        None, 0, 1, CPU, "dp")
    assert make_multihost_mesh(device="cpu") == mesh
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh(2, device="cpu")
    state = batch_reset(from_layout_name("cramped_room").layout, 4, "cpu")
    assert constrain_batch_minor(mesh, state) is state
    x = torch.arange(5.0)
    assert torch.equal(mesh.all_reduce(x), torch.arange(5.0))  # no collective


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_shard_batch_minor_takes_the_ranks_contiguous_envs(rank):
    spec = from_layout_name("cramped_room")
    state = batch_reset(spec.layout, 8, "cpu")
    state = state._replace(t=torch.arange(8, dtype=torch.int32))
    tree = {"state": state, "scalar": torch.tensor(7), "rows": [np.arange(16).reshape(2, 8)]}
    got = shard_batch_minor(_free_mesh(rank, 4), tree)
    lo, hi = 2 * rank, 2 * rank + 2
    for g, x in zip(got["state"], state):
        assert g.is_contiguous() and torch.equal(g, x[..., lo:hi])
    assert got["scalar"].item() == 7
    assert torch.equal(got["rows"][0], torch.from_numpy(np.arange(16).reshape(2, 8)[:, lo:hi]))
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch_minor(_free_mesh(rank, 4), torch.zeros(6))


def test_init_distributed_once_then_a_mesh_of_its_group():
    """The first call joins (gloo on the CPU), the second does nothing and
    says so; the group's one-rank mesh all-reduces and replicates."""
    spec = from_layout_name("cramped_room")
    try:
        assert init_distributed(f"127.0.0.1:{dryrun.free_port()}", 1, 0, device="cpu")
        assert not init_distributed(f"127.0.0.1:{dryrun.free_port()}", 1, 0, device="cpu")
        assert dist.get_backend() == "gloo"
        mesh = make_mesh(device="cpu")
        assert mesh.group is not None and (mesh.rank, mesh.size) == (0, 1)
        with pytest.raises(ValueError, match="2 ranks in a process group of 1"):
            make_mesh(2, device="cpu")
        assert torch.equal(mesh.all_reduce(torch.arange(3.0)), torch.arange(3.0))
        init_fn, train_iteration = ppo.make_ppo(spec, ppo.PPOConfig(**CFG), device="cpu")
        ts, _ = train_iteration(init_fn(0))  # Adam's state and a drawn generator
        want = {k: v.clone() for k, v in ts.net.state_dict().items()}
        gen_state = ts.generator.get_state()
        assert replicated(mesh, ts) is ts
        assert all(torch.equal(v, want[k]) for k, v in ts.net.state_dict().items())
        assert torch.equal(ts.generator.get_state(), gen_state)
        tree = replicated(mesh, {"a": np.ones(3), "b": (torch.tensor(2.0),)})
        assert torch.equal(tree["a"], torch.ones(3, dtype=torch.float64))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["fixed", "pool"])
def test_one_rank_mesh_is_the_meshless_iteration(mode):
    """The sharded code path on one rank (every minibatch member its own,
    the gradients through the flat buffer) gives the meshless result bit
    for bit: params, Adam's moments, the generator and every metric."""
    if mode == "fixed":
        spec = from_layout_name("cramped_room")
    else:
        spec = dryrun._specs({"n": 4, "seed": 4})
    runs = []
    for mesh in (None, make_mesh(device="cpu")):
        init_fn, train_iteration = ppo.make_ppo(spec, ppo.PPOConfig(**CFG), mesh=mesh,
                                                device="cpu")
        ts, m = train_iteration(init_fn(2))
        runs.append((ts, m, ts.opt.state_dict()["state"]))
    (ts0, m0, opt0), (ts1, m1, opt1) = runs
    for k, v in ts0.net.state_dict().items():
        assert torch.equal(v, ts1.net.state_dict()[k]), k
    for i in opt0:
        assert all(torch.equal(opt0[i][k], opt1[i][k]) for k in opt0[i])
    assert torch.equal(ts0.generator.get_state(), ts1.generator.get_state())
    assert [x.item() for x in m0] == [x.item() for x in m1]


def test_members_of_a_minibatch_a_rank_does_not_own():
    """A minibatch of env 0's samples has no member of rank 1's; the other
    ranks' members map to their own sample indices."""
    idx = torch.from_numpy(SPARSE_PERM[0]).view(4, 4)
    for rank, sizes in ((0, [4, 0, 2, 2]), (1, [0, 4, 2, 2])):
        members = ppo._members(idx, ppo.mesh_shard(_free_mesh(rank, 2), 2), 2)
        assert [len(m) for m in members] == sizes
    # rank 1 owns env 1: global samples s = 4t + 2p + 1 are its 2t + p
    assert ppo._members(idx, ppo.Shard(1, 2, 2), 2)[1].tolist() == [0, 1, 2, 3]


def test_a_mesh_that_does_not_divide_the_envs_raises():
    spec = from_layout_name("cramped_room")
    with pytest.raises(ValueError, match="num_envs 16 does not divide over the mesh's 3 ranks"):
        ppo.make_ppo(spec, ppo.PPOConfig(num_envs=16), mesh=_free_mesh(0, 3), device="cpu")
    with pytest.raises(ValueError, match="for a mesh on"):
        ppo.make_ppo(spec, ppo.PPOConfig(num_envs=16), mesh=_free_mesh(0, 2), device="meta")


def _jax_draws(jts, path, n_pool=None, bc=False):
    """The JAX `train_iteration`'s draws from state `jts` as the dry run's
    hooks read them: each step's action noise (key_a) and partner noise
    (key_b), each epoch's permutation, the lanes and the BC seats."""
    key, k_roll, k_perm = jax.random.split(jts.key, 3)
    key, k_pool = jax.random.split(k_roll)
    key, k_bc, k_seat = jax.random.split(key, 3)
    halves = jax.vmap(jax.random.split)(jax.random.split(key, T))
    out = dict(
        gumbel=np.stack([np.asarray(jax.random.gumbel(halves[t, 0], (2 * B, 6)))
                         for t in range(T)]),
        perm=np.stack([np.asarray(jax.random.permutation(k, 2 * B * T))
                       for k in jax.random.split(k_perm, EPOCHS)]))
    if n_pool:
        out["pool_idx"] = np.asarray(jax.random.randint(k_pool, (B,), 0, n_pool))
    if bc:
        out["bc_gumbel"] = np.stack([np.asarray(jax.random.gumbel(halves[t, 1], (2 * B, 6)))
                                     for t in range(T)])
        out["bc_u"] = np.asarray(jax.random.uniform(k_bc, (B,)))
        out["bc_seat"] = np.asarray(jax.random.randint(k_seat, (B,), 0, 2))
    np.savez(path, **out)
    return path


def _jax_case(name, tmp, case, key):
    """JAX's make_ppo on its 8-device mesh (the XLA path) for a case, and
    the case made to start from JAX's state under JAX's draws."""
    config = jppo.PPOConfig(fused=False, **{k: (tuple(map(tuple, v)) if k == "bc_schedule"
                                                else v) for k, v in case["config"].items()})
    if "pool" in case:
        gen = jgen.LayoutGenerator(rng=np.random.RandomState(case["pool"]["seed"]))
        spec = [gen.generate_spec(name=f"g{i}") for i in range(case["pool"]["n"])]
    else:
        spec = jfrom_layout_name(case["layout"])
    phi = partner = None
    if case.get("bc"):
        fc = build_motion_tables(spec.layout.terrain).feature_cost
        phi = jpot.make_potential_fn(spec, fc)
        partner = jbc.bc_policy_batch(spec, fc, *jbc.load_bc_model(CRAMPED))
    mesh = jmake_mesh(8)
    jinit, jtrain = jppo.make_ppo(spec, config, phi, partner, mesh=mesh)
    jts0 = jreplicated(mesh, jinit(jax.random.PRNGKey(key)))
    with mesh:
        jts1, jm1 = jtrain(jts0)
    _, (init_fn, _) = dryrun.build(case)
    ckpt = os.path.join(tmp, name)
    save_checkpoint(ckpt, train_state_from_jax(jax.device_get(jts0), init_fn(0)),
                    ppo.PPOConfig(), step=0)
    n_pool = case["pool"]["n"] if "pool" in case else None
    draws = _jax_draws(jts0, os.path.join(tmp, f"{name}.npz"), n_pool, bool(case.get("bc")))
    return dict(case, name=name, checkpoint=ckpt, draws=draws), (jax.device_get(jts1), jm1)


CASES = {
    "fixed": dict(layout="cramped_room", config=CFG, seed=3),
    "pool": dict(pool={"n": 4, "seed": 4, "prefix": "g"}, regen={"n": 4, "seed": 5},
                 config=CFG, seed=4),
    "bc_phi": dict(layout="cramped_room", config=BC_CFG, seed=0, bc=BC_DIR, phi=True),
    "sparse_minibatch": dict(layout="cramped_room", config=SPARSE_CFG, seed=1),
}
JAX_CASES = {"fixed_jax": ("fixed", 3), "pool_jax": ("pool", 6), "bc_phi_jax": ("bc_phi", 3)}


@pytest.fixture(scope="module")
def two_ranks():
    """One spawn of two gloo ranks over every case; the JAX runs; and each
    case's one-process port iteration."""
    with tempfile.TemporaryDirectory() as tmp:
        cases = [dict(c, name=n) for n, c in CASES.items()]
        cases[-1]["draws"] = os.path.join(tmp, "sparse.npz")
        np.savez(cases[-1]["draws"], perm=SPARSE_PERM)
        jax_out = {}
        for name, (base, key) in JAX_CASES.items():
            base = {k: v for k, v in CASES[base].items() if k not in ("seed", "regen")}
            if "pool" in base:
                base["pool"] = {"n": 4, "seed": key, "prefix": "g"}
            case, jax_out[name] = _jax_case(name, tmp, base, key)
            cases.append(case)
        procs = dryrun.launch(cases, 2, tmp, backend="gloo", device="cpu")
        one = {}
        for case in cases:  # the one-process iterations while the ranks run
            train_iteration, ts, kw = dryrun.prepare(case)
            one[case["name"]] = train_iteration(ts, **kw)
        ranks = dryrun.wait(procs, tmp, timeout=600)
        codes = dryrun.stop(procs, grace=60)
    return dict(ranks=ranks, one=one, jax=jax_out, diff=dryrun.disagreement(ranks), codes=codes)


ALL = list(CASES) + list(JAX_CASES)


@pytest.mark.parametrize("name", ALL)
def test_two_ranks_hold_bit_identical_params_and_kl_coeff(two_ranks, name):
    assert two_ranks["codes"] == [0, 0]
    assert two_ranks["diff"][name] == 0.0
    r0, r1 = (r[name] for r in two_ranks["ranks"])
    assert r0["metrics"] == r1["metrics"]
    assert (r0["envs"], r1["envs"]) == ([0, B // 2], [B // 2, B]) or name == "sparse_minibatch"
    assert r0["launches"] == [0, 0, 0, 0]  # the CPU takes the plain steps
    epochs = CASES.get(name, CASES["fixed"])["config"]["num_sgd_iter"]
    assert r0["all_reduces"] == 2 + 4 * epochs + 1  # advantages, gradients, the sums


def _metrics_close(got, want, exact=EXACT, total_tol=(RTOL, ATOL)):
    for field, w in want.items():
        g = got[field]
        if field in exact:
            assert g == w, field
        elif field == "episode_total_reward":
            np.testing.assert_allclose(g, w, rtol=total_tol[0], atol=total_tol[1],
                                       err_msg=field)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=field)


@pytest.mark.parametrize("name", ALL)
def test_two_ranks_match_the_one_process_iteration(two_ranks, name):
    """Within PARAM_TOL (the ranks' sums run in another order), the integer
    metrics equal: the draws are the one-process run's."""
    ts, m = two_ranks["one"][name]
    got = two_ranks["ranks"][0][name]
    diff = max(float((got["params"][k] - v).abs().max()) for k, v in ts.net.state_dict().items())
    assert diff <= PARAM_TOL
    _metrics_close(got["metrics"], {k: v.item() for k, v in m._asdict().items()})
    assert got["env_steps"] == ts.env_steps.item() and got["kl_coeff"] == ts.kl_coeff.item()
    assert got["metrics"]["episode_shaped_reward"] > 0 or name == "sparse_minibatch"


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_two_ranks_match_jax_on_its_mesh(two_ranks, name):
    """Against JAX's make_ppo(mesh=make_mesh(8)) under its replayed draws;
    PPO_BC + phi's total reward within phi's tolerance."""
    jts1, jm1 = two_ranks["jax"][name]
    got = two_ranks["ranks"][1][name]
    want = params_from_jax(jts1.params)
    assert max(float((got["params"][k] - want[k]).abs().max()) for k in want) <= PARAM_TOL
    tol = (PHI_RTOL, PHI_ATOL) if name == "bc_phi_jax" else (RTOL, ATOL)
    _metrics_close(got["metrics"], {k: float(v) for k, v in jm1._asdict().items()},
                   total_tol=tol)
    assert got["kl_coeff"] == float(jts1.kl_coeff)
    assert got["env_steps"] == float(jts1.env_steps)
    if name == "bc_phi_jax":
        assert 0 < got["metrics"]["bc_sample_fraction"] < 1
