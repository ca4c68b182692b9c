"""The 49-layout dynamics certificate on the torch port (counterpart of the
hermetic half of the JAX package's `scripts/certify_layouts.py`).

The JAX package froze, for every shipped layout and both dynamics, a
certificate of 400 biased-random steps that it had held step by step against
the live reference: the final state's sha256, the sparse and shaped totals
and the 25 event totals (`tests/golden/certification_49.json.gz` and
`certification_49_old.json.gz`, read here by path). This module replays the
same action streams through the port and checks every certificate:

  * on the CPU, through the plain step (`core.step.step`), every field;
  * on the card, through B1 (`ops/fused_train.fused_train_step_tiles`, one
    launch a step, the sums on the device) on the 2-player layouts, every
    field; and through B2 (`ops/fused_rollout.fused_rollout_actions`, the
    400 steps in one launch) on every layout, 1- and 4-player ones
    included: the final state's sha256 and the sparse total, which are what
    B2 returns.

The reset horizon is past 400 steps on both kernels, so no auto-reset
happens, as in the JAX replay. A layout the certificate marks unsupported
(old dynamics accepts 3-item orders only) must be refused by
`from_layout_name(..., old_dynamics=True)`.

    python -m overcooked_ai_tpu_torch.cli.certify_layouts [--old-dynamics] [--device cuda|cpu]

exits non-zero at the first mismatch, naming the layout, the route and the
field. The live-reference half of the JAX script (`certify_live`) needs the
reference's own code and is not ported.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import time
import zlib

import numpy as np
import torch

HORIZON = 400
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
# the certificate's interact-heavy action distribution (the JAX package's
# tests/scenarios.biased_random_actions)
PROB = np.array([0.13, 0.13, 0.13, 0.13, 0.08, 0.40])


def layout_names():
    """Every shipped layout JSON, sorted."""
    from overcooked_ai_tpu_torch.core.layout import available_layouts

    return available_layouts()


def cert_seed(name: str) -> int:
    return zlib.crc32(name.encode()) & 0xFFFF


def certificates(old_dynamics: bool = False) -> dict:
    """{layout: certificate} of the frozen file for these dynamics."""
    name = "certification_49_old" if old_dynamics else "certification_49"
    with gzip.open(os.path.join(GOLDEN_DIR, name + ".json.gz"), "rt") as f:
        return json.load(f)["layouts"]


def biased_random_actions(num_players: int, horizon: int, seed: int) -> np.ndarray:
    """(horizon, num_players) actions in 0..5, the certificate's stream."""
    rng = np.random.RandomState(seed)
    return rng.choice(6, size=(horizon, num_players), p=PROB)


def state_sha(spec, state) -> str:
    """sha256 of one env's canonical reference-format state dict."""
    from overcooked_ai_tpu_torch.core.state import canonical_state_dict, state_to_dict

    d = canonical_state_dict(state_to_dict(state, spec))
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()


def _env0(state):
    """Env 0 of a batch-last state."""
    from overcooked_ai_tpu_torch.core.state import State

    return State(*(x[..., 0] for x in state))


def _plain(spec, acts):
    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.core.step import step

    state = batch_reset(spec.layout, 1, "cpu")
    sparse = shaped = 0
    events = np.zeros(25, np.int64)
    for t in range(HORIZON):
        state, info = step(spec.layout, state, acts[t])
        sparse += int(info.sparse_reward.sum())
        shaped += int(info.shaped_reward.sum())
        events += info.events.sum((1, 2)).numpy()
    return state, sparse, shaped, events


def _b1(spec, acts):
    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.ops import fused_train

    hw = spec.height * spec.width
    if HORIZON > fused_train.max_horizon(hw):
        raise ValueError(f"{spec.name}: {HORIZON} steps pass B1's stamp bound "
                         f"{fused_train.max_horizon(hw)} on {hw} cells")
    dev = acts.device
    state = batch_reset(spec.layout, 1, dev)
    sparse = torch.zeros((), dtype=torch.int32, device=dev)
    shaped = torch.zeros((), dtype=torch.int32, device=dev)
    events = torch.zeros((25,), dtype=torch.int32, device=dev)
    for t in range(HORIZON):
        state, _, sp, sh, ev = fused_train.fused_train_step_tiles(
            spec.layout, state, acts[t], horizon=HORIZON, reset_horizon=HORIZON + 1)
        sparse += sp.sum(dtype=torch.int32)
        shaped += sh.sum(dtype=torch.int32)
        events += fused_train.unpack_events(ev).sum((1, 2), dtype=torch.int32)
    return state, int(sparse), int(shaped), events.cpu().numpy()


def _b2(spec, acts):
    from overcooked_ai_tpu_torch.core.env import batch_reset
    from overcooked_ai_tpu_torch.ops import fused_rollout

    state = batch_reset(spec.layout, 1, acts.device)
    state, ret = fused_rollout.fused_rollout_actions(spec.layout, state, acts,
                                                     horizon=HORIZON + 1)
    return state, int(ret.sum())


def run_ours(name: str, old_dynamics: bool = False, device="cuda", routes=None) -> dict:
    """Replay `name`'s certificate stream through the port; returns
    {route: certificate fields}. `routes` defaults to ("plain",) on the CPU
    and ("B1", "B2") on the card: "plain" and "B1" give every field, "B2"
    the seed, horizon, final state's sha256 and sparse total. B1 steps
    2-player layouts only, so it is left out on the others. On CPU tensors
    the B1 and B2 wrappers run their plain versions (the tests' rehearsal
    of the card's routes)."""
    from overcooked_ai_tpu_torch.core.layout import from_layout_name

    spec = from_layout_name(name, **({"old_dynamics": True} if old_dynamics else {}))
    seed = cert_seed(name)
    device = torch.device(device)
    # (T, P, 1) int32, the single env's actions
    acts = torch.from_numpy(np.ascontiguousarray(
        biased_random_actions(spec.num_players, HORIZON, seed).astype(np.int32)[..., None])
    ).to(device)
    if routes is None:
        routes = ("plain",) if device.type == "cpu" else ("B1", "B2")
    head = {"seed": seed, "horizon": HORIZON}
    out = {}
    for route in routes:
        if route == "B1" and spec.num_players != 2:
            continue
        if route == "B2":
            state, sparse = _b2(spec, acts)
            out[route] = {**head, "final_state_sha256": state_sha(spec, _env0(state)),
                          "total_sparse": sparse}
            continue
        state, sparse, shaped, events = (_plain if route == "plain" else _b1)(spec, acts)
        out[route] = {**head, "final_state_sha256": state_sha(spec, _env0(state)),
                      "total_sparse": sparse, "total_shaped": shaped,
                      "event_totals": [int(x) for x in events]}
    return out


def mismatches(cert: dict, got: dict) -> list:
    """[(route, field, got, want)] of every field of `got` that differs."""
    return [(route, k, v, cert.get(k)) for route, fields in got.items()
            for k, v in fields.items() if v != cert.get(k)]


def refuses(name: str) -> bool:
    """Whether the port refuses `name` under old dynamics, as the
    certificate says the reference does."""
    from overcooked_ai_tpu_torch.core.layout import from_layout_name

    try:
        from_layout_name(name, old_dynamics=True)
    except ValueError:
        return True
    return False


def check_all(old_dynamics: bool = False, device="cuda", log=print) -> dict:
    """Check every certificate of these dynamics; raises SystemExit at the
    first mismatch. Returns the counts: layouts matched by each route, and
    the refusals."""
    certs = certificates(old_dynamics)
    names = layout_names()
    if sorted(certs) != names:
        raise SystemExit(f"the certificates cover {sorted(set(certs) ^ set(names))} "
                         "differently from the layout files")
    counts = {"layouts": 0, "refused": 0}
    for name in names:
        t0 = time.perf_counter()
        cert = certs[name]
        if cert.get("unsupported"):
            if not refuses(name):
                raise SystemExit(f"{name}: the port builds a layout that the reference "
                                 "refuses under old dynamics")
            counts["refused"] += 1
            log(f"{name}: refused under old dynamics, as the reference does")
            continue
        got = run_ours(name, old_dynamics, device)
        bad = mismatches(cert, got)
        if bad:
            route, field, g, w = bad[0]
            raise SystemExit(f"{name}: {route} gives {field} {g!r}, the certificate {w!r}")
        counts["layouts"] += 1
        for route in got:
            counts[route] = counts.get(route, 0) + 1
        log(f"{name}: ok on {'+'.join(got)} (sparse {cert['total_sparse']}, "
            f"{time.perf_counter() - t0:.2f}s)")
    return counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-dynamics", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (B1 and B2) or cpu (the plain step)")
    args = ap.parse_args(argv)
    from overcooked_ai_tpu_torch.cli.train_ppo import check_device

    device = check_device(args.device)
    t0 = time.perf_counter()
    counts = check_all(args.old_dynamics, device)
    print(f"{'old' if args.old_dynamics else 'new'} dynamics: every certificate matched "
          f"on {device}: " + json.dumps(counts) + f" in {time.perf_counter() - t0:.1f}s")
    return counts


if __name__ == "__main__":
    main()
