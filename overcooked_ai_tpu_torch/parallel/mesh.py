"""Data-parallel meshes over `torch.distributed` (port of
`overcooked_ai_tpu.parallel.mesh`).

In the JAX package a `jax.sharding.Mesh` shards the env batch (the last
axis of every state leaf) over devices, the params stay replicated, and XLA
inserts the gradient all-reduce. Here, in torch.distributed's idiom, each
device is one process (a rank), and a `Mesh` is the process group with this
rank's place in it. `training/ppo.make_ppo(mesh=...)` steps the rank's
contiguous shard of the envs with its own kernel launches, draws every
random tensor at its global shape, and all-reduces the gradients, so that
every rank holds the same params as the one-process iteration.

One process per card, under torchrun (which sets MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK):

    init_distributed()                  # NCCL, this process's card
    mesh = make_multihost_mesh()
    init_fn, train_iteration = make_ppo(spec, config, mesh=mesh)
    ts = replicated(mesh, init_fn(0))
    ts, metrics = train_iteration(ts)

The collectives are `all_reduce` and `broadcast` only, so that a mesh runs
on NCCL and on gloo (which has no `all_gather` for CUDA tensors).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data-parallel axis of `size` ranks, this process being `rank`,
    on `device`. `group` is their process group; None is this process
    alone, without collectives."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis_name: str = "dp"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The first rank's x on every rank, in place."""
        if self.group is not None:
            dist.broadcast(x, src=0, group=self.group)  # a mesh's ranks start at 0
        return x


def _device(device) -> torch.device:
    """`device` with a CUDA index: "cuda" is this process's current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp", device="cuda") -> Mesh:
    """A mesh over the first `n_devices` ranks of the process group (all of
    them by default), this process on `device`. Without a process group it
    is this process alone on `device`, the JAX package's one-process mesh."""
    device = _device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process group: call "
                             "init_distributed in each rank first")
        return Mesh(None, 0, 1, device, axis_name)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    # every rank of the group takes part in new_group, also those left out
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is not among the mesh's first {n} ranks")
    return Mesh(group, rank, n, device, axis_name)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     local_device_ids=None, backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Join this process to the process group, once, before any collective.

    coordinator_address: "host:port" of rank 0's store; num_processes the
    world size, process_id this rank, local_device_ids this process's card
    (an index, or a sequence of one). Each left out is read from torchrun's
    MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, as JAX
    reads a pod's. On `device` "cuda" the process takes its card and the
    backend is NCCL; on the CPU it is gloo. `backend` replaces that choice
    (gloo carries `all_reduce` and `broadcast` on CUDA tensors too, so
    several ranks may share one card). Returns False, and does nothing, when
    a group exists already.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None:
        if "MASTER_PORT" not in env:
            raise ValueError("no coordinator_address, and no MASTER_ADDR / MASTER_PORT in the "
                             "environment (torchrun sets them)")
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    if local_device_ids is None:
        local = int(env.get("LOCAL_RANK", 0))
    else:
        (local,) = ([local_device_ids] if isinstance(local_device_ids, int)
                    else list(local_device_ids))  # one card a process
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed on CUDA without a card; pass device='cpu' "
                               "for gloo on the CPU")
        torch.cuda.set_device(local)
        backend = backend or "nccl"
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return True


def make_multihost_mesh(axis_name: str = "dp", device="cuda") -> Mesh:
    """One flat data-parallel mesh over every rank of every host. torchrun
    numbers the ranks host by host (every card of host 0, then of host 1,
    ...), the JAX package's hierarchical order, and NCCL splits an
    all-reduce over it into the hosts' links and the network itself."""
    return make_mesh(None, axis_name, device)


def _tree_map(fn, tree):
    """fn over the leaves of nested NamedTuples, tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return fn(tree)


def shard_batch_minor(mesh: Mesh, tree):
    """Every leaf's slice of its last (env) axis that this rank owns, the
    rank-th of `mesh.size` contiguous equal parts, as a contiguous tensor
    on the mesh's device; a 0-d leaf whole."""

    def one(x):
        x = torch.as_tensor(x)
        if x.ndim:
            n = x.shape[-1]
            if n % mesh.size:
                raise ValueError(f"an axis of {n} does not divide over {mesh.size} ranks")
            k = n // mesh.size
            x = x[..., mesh.rank * k:(mesh.rank + 1) * k]
        return x.to(mesh.device).contiguous()

    return _tree_map(one, tree)


def _broadcast_into(mesh: Mesh, x: torch.Tensor) -> None:
    """x = the first rank's x, through the mesh's device (NCCL carries
    nothing else)."""
    y = mesh.broadcast(x.to(mesh.device))
    if y is not x:
        x.copy_(y)


def replicated(mesh: Mesh, tree):
    """The first rank's values on every rank.

    A `training/ppo.TrainState` is set in place and returned: the net's
    params and buffers, Adam's state, the counters and the generator's
    state (every rank must hold one of the same structure, as `init_fn`
    makes). Any other tree of tensors (or arrays) is returned as copies on
    the mesh's device.
    """
    if hasattr(tree, "net") and hasattr(tree, "opt") and hasattr(tree, "generator"):
        tensors = list(tree.net.state_dict().values())  # they share the params' storage
        for group in tree.opt.param_groups:
            for p in group["params"]:
                st = tree.opt.state.get(p, {})
                tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
        for x in (*tensors, tree.env_steps, tree.kl_coeff):
            _broadcast_into(mesh, x)
        gen_state = tree.generator.get_state()
        _broadcast_into(mesh, gen_state)
        tree.generator.set_state(gen_state)
        return tree
    return _tree_map(lambda x: mesh.broadcast(torch.as_tensor(x).to(mesh.device).clone()),
                     tree)


def constrain_batch_minor(mesh: Mesh, tree, axis_name: str = "dp"):
    """The JAX package's in-jit sharding constraint, a hint to XLA's
    sharding propagation. It has no meaning in torch: a rank holds only its
    shard (`shard_batch_minor`), so `tree` is returned as it is. Nothing
    calls it; it keeps the JAX module's names."""
    return tree
