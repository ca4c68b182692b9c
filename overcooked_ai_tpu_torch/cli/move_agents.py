"""Copy a trained agent into the demo's agent directory (port of
`overcooked_ai_tpu.cli.move_agents`; reference overcooked_demo/move_agents.py).

Validates a run directory in the port's formats and copies it where the
demo server loads it by name (`ppo:<dir>` / `bc:<dir>` NPC kinds,
`demo/game.py` `npc_from_kind`):
  * ppo: a `config.json` whose `latest_step` names a `step_{n}.pt` beside it
    (`training/checkpoint.py`; the JAX runs converted by
    `convert_jax_checkpoints.py` included);
  * bc: a `metadata.json` beside `params.pt` (the port's) or
    `params.msgpack` (the JAX package's, which the port reads).

    python -m overcooked_ai_tpu_torch.cli.move_agents runs_torch/ppo demo_agents/my_ppo
    python -m overcooked_ai_tpu_torch.cli.move_agents runs_torch/bc demo_agents/my_bc --kind bc
"""

from __future__ import annotations

import argparse
import json
import os
import shutil


def validate(src: str, kind: str) -> None:
    """Raise SystemExit unless `src` is a `kind` agent directory the port loads."""
    if not os.path.isdir(src):
        raise SystemExit(f"{src}: not a directory")
    if kind == "ppo":
        cfg = os.path.join(src, "config.json")
        if not os.path.exists(cfg):
            raise SystemExit(f"{src}: missing config.json (not a PPO run dir)")
        try:
            with open(cfg) as f:
                step = json.load(f)["latest_step"]
        except (ValueError, KeyError) as e:
            raise SystemExit(f"{cfg}: no latest_step ({e!r})") from None
        if not os.path.exists(os.path.join(src, f"step_{step}.pt")):
            raise SystemExit(f"{src}: no step_{step}.pt for latest_step {step} (a JAX orbax "
                             "run? convert it with convert_jax_checkpoints.py)")
    elif kind == "bc":
        if not os.path.exists(os.path.join(src, "metadata.json")) or not any(
                os.path.exists(os.path.join(src, w)) for w in ("params.pt", "params.msgpack")):
            raise SystemExit(f"{src}: missing metadata.json and params.pt or params.msgpack "
                             "(not a BC dir)")
    else:
        raise SystemExit(f"unknown kind {kind!r} (ppo|bc)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="trained run directory")
    ap.add_argument("dst", help="destination under the demo agent dir")
    ap.add_argument("--kind", default="ppo", choices=["ppo", "bc"])
    ap.add_argument("--overwrite", action="store_true", help="replace an existing destination")
    args = ap.parse_args(argv)

    validate(args.src, args.kind)
    if os.path.exists(args.dst):
        if not args.overwrite:
            raise SystemExit(f"{args.dst} exists (pass --overwrite)")
        shutil.rmtree(args.dst)
    shutil.copytree(args.src, args.dst)
    print(f"copied {args.src} -> {args.dst}; load in the demo as '{args.kind}:{args.dst}'")


if __name__ == "__main__":
    main()
