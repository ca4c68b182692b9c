"""Data-parallel dry run: one full PPO iteration on a mesh of N ranks
(port of the JAX package's `__graft_entry__.dryrun_multichip`).

    python -m overcooked_ai_tpu_torch.parallel.dryrun --nproc N [--backend gloo] [--device cpu]

spawns N rank processes joined over a free localhost port. Each builds a
mesh of all of them (`parallel/mesh.py`) and runs one full
`train_iteration` (rollout, GAE, minibatch SGD with the gradients
all-reduced) on `cramped_room` and one on a generated layout pool, then
writes its params. The parent checks that every rank holds the same
params and KL coefficient, bit for bit, and exits 0, or 1 if not. The
JAX dry run's third path, its XLA step, has no counterpart: on a card
every rank steps its shard with B1 (one layout) or B3 (the pool).

The defaults are the JAX dry run's sizes (8 envs a rank, 8 steps, 2
epochs, 4 layouts); each rank takes its card by its rank (`--device
cuda`, NCCL) unless `--backend gloo` puts them on one card. `launch` and
`wait` are the same spawn for other callers (the tests, `chip_smoke.py`),
with cases of their own: each a dict of
    name       the case's key in the results
    layout     a layout name, or
    pool       {"n", "seed", "prefix", "generator": LayoutGenerator's
               keywords}: n generated layouts (pool mode)
    regen      the same, a regenerated pool passed to train_iteration
    config     PPOConfig's fields (`net` a dict of NetConfig's)
    seed       init_fn's seed
    checkpoint a directory of `training/checkpoint.save_checkpoint` to
               start from instead (the tests' state converted from JAX)
    bc, phi    a BC model directory for the partner, and whether phi
               shapes the reward (the partner's motion costs)
    draws      an .npz of the iteration's draws, replayed by `hooks`
    keep_rollout  whether the result keeps the rollout's integers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROLLOUT_INTS = ("obs", "action", "sparse", "shaped", "events")
TIMEOUT = 600  # seconds for the command line's ranks


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_cases(nproc: int):
    """The JAX dry run's two kernel paths at its sizes: cramped_room and a
    generated pool of 4 layouts, 8 envs a rank x 8 steps, 2 epochs."""
    B = 8 * nproc
    config = dict(num_envs=B, horizon=8, sgd_minibatch_size=B * 4, num_sgd_iter=2)
    pool = {"n": 4, "seed": 0, "prefix": "dry_", "generator": {"outer_shape": [5, 4]}}
    return [dict(name="fixed", layout="cramped_room", config=config, seed=0),
            dict(name="pool", pool=pool, config=config, seed=0)]


def launch(cases, nproc: int, workdir: str, backend: Optional[str] = None, device="cuda",
           go: Optional[str] = None):
    """Start `nproc` rank processes running `cases` (written to `workdir`,
    where each rank writes its results and its output, rank{r}.pt and
    rank{r}.log); returns their Popen handles. With `go`, the ranks join,
    build their mesh and prepare the cases (their nets, pools and state),
    then wait for that file to exist before they run them."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "cases.json")
    with open(path, "w") as f:
        json.dump(cases, f)
    port = free_port()
    cmd = [sys.executable, "-m", "overcooked_ai_tpu_torch.parallel.dryrun", "--worker",
           "--nproc", str(nproc), "--port", str(port), "--cases", path, "--out", workdir,
           "--device", device]
    cmd += ["--backend", backend] if backend else []
    cmd += ["--go", go] if go else []
    # every rank runs on this host: gloo and NCCL's bootstrap over the loopback
    env = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo", **os.environ,
           "PYTHONPATH": os.pathsep.join([ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                                   if p])}
    procs = []
    for r in range(nproc):
        with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
    return procs


def stop(procs, grace: float = 0.0):
    """Reap the ranks, killing those still running after `grace` seconds;
    returns their exit codes."""
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return [p.returncode for p in procs]


def wait(procs, workdir: str, timeout: float):
    """Each rank's results ({case name: result}), as soon as every rank has
    written them (their processes may still be closing: `stop` reaps them).
    A rank that ends without its results, or a run past `timeout` seconds,
    fails at once: the ranks are killed, and RuntimeError gives the ends of
    their logs."""
    import torch

    paths = [os.path.join(workdir, f"rank{r}.pt") for r in range(len(procs))]
    deadline, failed = time.monotonic() + timeout, None
    while failed is None and not all(os.path.exists(x) for x in paths):
        bad = [r for r, p in enumerate(procs) if p.poll() is not None
               and not os.path.exists(paths[r])]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode} without its results"
        elif time.monotonic() > deadline:
            failed = f"the ranks have not all written their results after {timeout} s"
        time.sleep(0.02)
    if failed:
        stop(procs)
        logs = []
        for r in range(len(procs)):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                logs.append(f"--- rank {r}:\n{f.read()[-3000:]}")
        raise RuntimeError(failed + "\n" + "\n".join(logs))
    return [torch.load(x, weights_only=True) for x in paths]


def disagreement(results) -> dict:
    """{case: the largest |difference| of any param or the KL coefficient
    between rank 0 and another rank} (0.0 is bit for bit)."""
    out = {}
    for name, first in results[0].items():
        out[name] = max([abs(r[name]["kl_coeff"] - first["kl_coeff"]) for r in results]
                        + [float((r[name]["params"][k].double()
                                  - first["params"][k].double()).abs().max())
                           for r in results for k in first["params"]])
    return out


def hooks(draws, shard=None, device="cpu"):
    """`train_iteration`'s hooks replaying those of `draws` (an .npz's
    arrays) that it holds: the actions as argmax(logits + `gumbel`[t]) and
    the partner's as argmax(logits + `bc_gumbel`[t]) (JAX's `categorical`),
    `perm`[epoch], `pool_idx` and the BC seats (`bc_u`, `bc_seat`). With a
    `training.ppo.Shard`, the actions' noise is the rank's rows."""
    import torch

    def noise(name, t, env_major=False):
        g = torch.from_numpy(np.ascontiguousarray(draws[name][t])).to(device)
        return g if shard is None else shard.rows(g, env_major)

    out = {}
    if "gumbel" in draws:
        out["sample_fn"] = lambda lg, t: torch.argmax(lg + noise("gumbel", t), -1)
    if "perm" in draws:
        out["perm_fn"] = lambda e: torch.from_numpy(draws["perm"][e]).to(device)
    if "bc_gumbel" in draws:
        out["bc_sample_fn"] = lambda lg, t: torch.argmax(lg + noise("bc_gumbel", t, True), -1)
    if "pool_idx" in draws:
        out["pool_idx"] = torch.from_numpy(draws["pool_idx"]).long().to(device)
    if "bc_u" in draws:
        out["bc_draws"] = (torch.from_numpy(draws["bc_u"]).to(device),
                           torch.from_numpy(draws["bc_seat"]).to(device))
    return out


def _specs(pool):
    from overcooked_ai_tpu_torch.core.layout_generator import LayoutGenerator

    gen = LayoutGenerator(rng=np.random.RandomState(pool["seed"]), **pool.get("generator", {}))
    return [gen.generate_spec(name=f"{pool.get('prefix', 'g')}{i}") for i in range(pool["n"])]


def prepare(case, mesh=None, device="cpu"):
    """A case's (train_iteration, its TrainState, its keywords) on `mesh`,
    or on `device` without one (the one-process iteration)."""
    from overcooked_ai_tpu_torch.core.layout_generator import stack_layouts
    from overcooked_ai_tpu_torch.parallel.mesh import replicated
    from overcooked_ai_tpu_torch.training.checkpoint import restore_checkpoint
    from overcooked_ai_tpu_torch.training.ppo import mesh_shard

    config, (init_fn, train_iteration) = build(case, mesh, device)
    ts = init_fn(case.get("seed", 0))
    if case.get("checkpoint"):
        ts, _ = restore_checkpoint(case["checkpoint"], ts)
    kw = {}
    if mesh is not None:
        ts, device = replicated(mesh, ts), mesh.device
    if case.get("regen"):
        kw["pool"] = stack_layouts(_specs(case["regen"]))
    if case.get("draws"):
        with np.load(case["draws"]) as f:
            kw.update(hooks(dict(f), mesh and mesh_shard(mesh, config.num_envs), device))
    return train_iteration, ts, kw


def build(case, mesh=None, device="cpu"):
    """(PPOConfig, make_ppo's (init_fn, train_iteration)) of a case."""
    from overcooked_ai_tpu_torch.core import potential
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
    from overcooked_ai_tpu_torch.training import bc
    from overcooked_ai_tpu_torch.training.networks import NetConfig
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig, make_ppo

    cfg = dict(case["config"])
    cfg["net"] = NetConfig(**cfg.get("net", {}))
    if "bc_schedule" in cfg:
        cfg["bc_schedule"] = tuple(tuple(x) for x in cfg["bc_schedule"])
    config = PPOConfig(**cfg)
    spec = from_layout_name(case["layout"]) if "layout" in case else _specs(case["pool"])
    pool_mode = isinstance(spec, list)
    specs = spec if pool_mode else [spec]
    phi = partner = None
    if case.get("phi") or case.get("bc"):  # the partner's and phi's motion costs
        costs = [build_motion_tables(s.layout.terrain).feature_cost for s in specs]
    if case.get("phi"):
        phi = (potential.make_potential_fn_pool(specs) if pool_mode
               else potential.make_potential_fn(spec, costs[0]))
    if case.get("bc"):
        params, bc_cfg = bc.load_bc_model(os.path.join(ROOT, case["bc"]))
        partner = (bc.bc_policy_batch_pool(specs, costs, params, bc_cfg) if pool_mode
                   else bc.bc_policy_batch(spec, costs[0], params, bc_cfg))
    return config, make_ppo(spec, config, phi, partner, mesh=mesh,
                            device=mesh.device if mesh else device)


def run_case(case, mesh, train_iteration, ts, kw):
    """One iteration of a prepared case on this rank: its result dict."""
    import torch

    from overcooked_ai_tpu_torch.ops import _build
    from overcooked_ai_tpu_torch.training.ppo import mesh_shard

    on_card = mesh.device.type == "cuda"
    marks, kept = {}, {}

    def mark(name, out=None):
        if on_card:
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()
        else:
            marks[name] = time.perf_counter()
        if name == "rollout" and case.get("keep_rollout"):
            kept.update({f: getattr(out, f).cpu() for f in ROLLOUT_INTS})

    def ms(a, b):
        return marks[a].elapsed_time(marks[b]) if on_card else (marks[b] - marks[a]) * 1e3

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mesh.spans.clear()
    _build.launches.clear()
    t0 = time.perf_counter()
    mark("start")
    ts, metrics = train_iteration(ts, on_phase=mark, **kw)
    mark("end")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [_build.launches[k] for k in _build.ENV_ENTRIES]
    reduce_ms = sum(a.elapsed_time(b) if on_card else (b - a) * 1e3 for a, b in mesh.spans)
    params = list(ts.net.parameters())
    return {
        "params": {k: v.cpu() for k, v in ts.net.state_dict().items()},
        "kl_coeff": ts.kl_coeff.item(), "env_steps": ts.env_steps.item(),
        "metrics": {k: v.item() for k, v in metrics._asdict().items()},
        "launches": launches, "wall_s": wall,
        "split_ms": {"rollout": ms("start", "rollout"), "gae_std": ms("rollout", "advantages"),
                     "sgd": ms("advantages", "end"), "all_reduce": reduce_ms},
        "all_reduces": len(mesh.spans),
        "grad_bytes": sum(p.numel() * p.element_size() for p in params),
        "max_memory_bytes": torch.cuda.max_memory_allocated(mesh.device) if on_card else 0,
        "envs": list(mesh_shard(mesh, case["config"]["num_envs"])[:2]),
        **({"rollout": kept} if kept else {}),
    }


def _timed_mesh(mesh):
    """The mesh with each all-reduce's start and end recorded in `spans`
    (CUDA events on a card, host clock on the CPU)."""
    import torch

    from overcooked_ai_tpu_torch.parallel.mesh import Mesh

    @dataclasses.dataclass(frozen=True)
    class TimedMesh(Mesh):
        spans: list = dataclasses.field(default_factory=list)

        def all_reduce(self, x):
            if self.device.type == "cuda":
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                super().all_reduce(x)
                b.record()
            else:
                a = time.perf_counter()
                super().all_reduce(x)
                b = time.perf_counter()
            self.spans.append((a, b))
            return x

    return TimedMesh(**{f.name: getattr(mesh, f.name) for f in dataclasses.fields(Mesh)})


def worker(args) -> int:
    import torch

    from overcooked_ai_tpu_torch.parallel.mesh import init_distributed, make_mesh

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    # the net in full float32, as a one-process run it is held against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = 0 if args.backend == "gloo" else args.rank  # gloo ranks may share one card
    init_distributed(f"127.0.0.1:{args.port}", args.nproc, args.rank, card, args.backend,
                     args.device)
    mesh = _timed_mesh(make_mesh(device=args.device))
    mesh.all_reduce(torch.zeros(1, device=mesh.device))  # the group's links, once
    with open(args.cases) as f:
        cases = json.load(f)
    prepared = [(case, prepare(case, mesh)) for case in cases]  # before the go
    if mesh.device.type == "cuda":  # cuDNN and cuBLAS start before the timed iterations
        x = torch.ones((64, 26, 5, 5), device=mesh.device, requires_grad=True)
        w = torch.ones((25, 26, 5, 5), device=mesh.device, requires_grad=True)
        (torch.nn.functional.conv2d(x, w, padding=2).sum() + (x.flatten(1) @ w.flatten(1).T)
         .sum()).backward()
        torch.cuda.synchronize()
    while args.go and not os.path.exists(args.go):
        time.sleep(0.01)
    results = {case["name"]: run_case(case, mesh, *prep) for case, prep in prepared}
    path = os.path.join(args.out, f"rank{args.rank}.pt")
    torch.save(results, path + ".part")
    os.replace(path + ".part", path)  # whole, or not there
    torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--backend", default=None, help="default: NCCL on cuda, gloo on the CPU")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--cases", help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    p.add_argument("--go", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker(args)
    with tempfile.TemporaryDirectory() as tmp:
        procs = launch(default_cases(args.nproc), args.nproc, tmp, args.backend, args.device)
        results = wait(procs, tmp, TIMEOUT)
        codes = stop(procs, grace=60)
    diff = disagreement(results)
    for name, d in diff.items():
        r = results[0][name]
        print(f"{name}: {args.nproc} ranks ({args.backend or 'default backend'}, "
              f"{args.device}), {r['metrics']['entropy']:.4f} entropy, launches B1/B2/B3/B4 "
              f"{r['launches']} a rank, ranks' params and kl_coeff max |diff| {d}")
    ok = not any(codes) and all(d == 0 for d in diff.values()) and all(
        r[name]["metrics"]["entropy"] > 0 for r in results for name in r)
    print("dryrun ok" if ok else "dryrun FAILED: the ranks disagree")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
