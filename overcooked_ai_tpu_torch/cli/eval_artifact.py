"""The evaluation artifact's pairwise matrix on the torch port (counterpart
of the JAX package's `scripts/make_eval_artifact.py` loop; reference
human_aware_rl/ppo/evaluate.py:100-189).

On each layout, every ordered pair of {PPO_SP, PPO_BC, BC, greedy} (both
seat orders) plays `--games` games of `--horizon` steps from seed 0, and
the mean and std of the per-game sparse return go into a JSON file in the
schema of the JAX package's `eval_matrix_results.json`, each cell with its
wall and B1 launches beside them. The PPO agents are the JAX package's runs
converted by `convert_jax_checkpoints.py` (`artifacts_torch/eval_artifact`,
or `_old` with `--old-dynamics`); the BC proxies are read where the JAX
package wrote them (`runs/eval_artifact`, or `_old`). `--compare` holds each
cell against a JAX table: its mean must lie within three combined standard
errors, sqrt(s_J^2 / n_J + s_P^2 / n_P), of the table's; a cell where both
stds are 0 is reported and not gated.

    python -m overcooked_ai_tpu_torch.cli.eval_artifact --games 10 \\
        --compare eval_matrix_results.json
    python -m overcooked_ai_tpu_torch.cli.eval_artifact --games 10 --old-dynamics \\
        --compare eval_matrix_results_old_dynamics.json

The games run on the card (`--device cuda`, the default); `--device cpu`
runs the plain versions.

`--render` plays nothing: it writes the results JSON at `--out` as the JAX
package's markdown table and heatmap (`scripts/make_eval_artifact.py`'s
`_write_markdown` and `_plot`), to `EVAL_MATRIX_TORCH[_OLD_DYNAMICS].md` and
`eval_matrix_torch[_old_dynamics].png` at the repo root by default, never
over the JAX package's `EVAL_MATRIX*.md` or `eval_matrix*.png`:

    python -m overcooked_ai_tpu_torch.cli.eval_artifact --render [--old-dynamics]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
LAYOUTS = ["cramped_room", "asymmetric_advantages", "coordination_ring",
           "forced_coordination", "counter_circuit_o_1order"]
KINDS = ["PPO_SP", "PPO_BC", "BC", "greedy"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--games", type=int, default=10)
    ap.add_argument("--horizon", type=int, default=400)
    ap.add_argument("--layouts", nargs="+", default=LAYOUTS)
    ap.add_argument("--cells", nargs="+", default=None,
                    help="pairs to play, as A+B (default: all 16 of each layout)")
    ap.add_argument("--old-dynamics", action="store_true")
    ap.add_argument("--art-dir", default=None,
                    help="converted PPO runs (default artifacts_torch/eval_artifact[_old])")
    ap.add_argument("--out", default=None,
                    help="default runs_torch/eval_matrix_results[_old_dynamics].json")
    ap.add_argument("--compare", default=None, help="a JAX results JSON to hold the cells against")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    ap.add_argument("--render", action="store_true",
                    help="play nothing: write --out's results as the markdown table and heatmap")
    ap.add_argument("--md", default=None, help="default EVAL_MATRIX_TORCH[_OLD_DYNAMICS].md")
    ap.add_argument("--png", default=None, help="default eval_matrix_torch[_old_dynamics].png")
    return ap.parse_args(argv)


def agent_kinds(layout_name, art_dir, bc_dir) -> dict:
    return {"PPO_SP": f"ppo:{art_dir}/ppo_sp_{layout_name}",
            "PPO_BC": f"ppo:{art_dir}/ppo_bc_{layout_name}",
            "BC": f"bc:{bc_dir}/bc_proxy_{layout_name}",
            "greedy": "greedy"}


def compare(results: dict, reference: dict) -> list:
    """Each cell of `results` against the same cell of a JAX results JSON:
    [(layout, cell, port mean, JAX mean, combined standard error, within 3
    of it, or None when both stds are 0)]."""
    ref, n_ref = reference["results"], reference["games_per_pair"]
    rows = []
    for layout, cells in results.items():
        for cell, mine in cells.items():
            want = ref[layout][cell]
            se = math.sqrt(want["std"] ** 2 / n_ref + mine["std"] ** 2 / mine["games"])
            within = None if se == 0 else abs(mine["mean"] - want["mean"]) <= 3 * se
            rows.append((layout, cell, mine["mean"], want["mean"], se, within))
    return rows


def write_markdown(summary: dict, path: str, png_name: str) -> None:
    """The JAX package's EVAL_MATRIX.md layout: one table a layout, row =
    seat 0, column = seat 1, each cell `mean ± std` at one decimal."""
    old = summary["dynamics"] == "old"
    lines = [
        f"# Canonical evaluation matrix, torch port{' (old dynamics)' if old else ''}",
        "",
        f"Mean per-game sparse reward over {summary['games_per_pair']} games (horizon 400, seed "
        "0), both seat orders -- the reference's 5-layout eval protocol "
        "(`human_aware_rl/ppo/evaluate.py:100-189`), played by the torch port "
        f"(`overcooked_ai_tpu_torch.cli.eval_artifact`, device `{summary['device']}`). Agents: "
        "the JAX package's `PPO_SP` and `PPO_BC` runs converted by `convert_jax_checkpoints.py` "
        "(`artifacts_torch/`), its `BC` proxies (`runs/eval_artifact*/bc_proxy_*`) and the "
        "scripted `greedy` model; `EVAL_MATRIX.md` describes them. Dynamics: "
        + ("old (auto-cook) dynamics." if old else
           "current dynamics (explicit INTERACT starts cooking)."),
        "",
        "Row = seat 0, column = seat 1 (cell: mean ± std).",
        "",
    ]
    comp = summary.get("comparison")
    if comp:
        lines += [f"Against `{comp['reference']}`: {comp['within_3se']} of {comp['cells']} "
                  "cells within three combined standard errors of the JAX table's mean; outside: "
                  f"{', '.join(comp['outside_3se']) or 'none'}.", ""]
    for layout, lay_res in summary["results"].items():
        lines += [f"### {layout}", "", "| seat0 \\ seat1 | " + " | ".join(KINDS) + " |",
                  "|---|" + "---|" * len(KINDS)]
        for a in KINDS:
            row = [f"{round(lay_res[f'{a}+{b}']['mean'], 1)} ± "
                   f"{round(lay_res[f'{a}+{b}']['std'], 1)}" for b in KINDS]
            lines.append(f"| **{a}** | " + " | ".join(row) + " |")
        lines.append("")
    lines += [f"![pairwise matrix heatmaps]({png_name})", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def plot(results: dict, path: str) -> None:
    """The JAX package's small-multiples heatmap: magnitude as one
    sequential hue, value labels in the cells."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    n = len(results)
    fig, axes = plt.subplots(1, n, figsize=(3.4 * n, 3.8))
    axes = [axes] if n == 1 else axes
    vmax = max(v["mean"] for lay in results.values() for v in lay.values()) or 1.0
    for ax, (layout, lay_res) in zip(axes, results.items()):
        m = np.array([[lay_res[f"{a}+{b}"]["mean"] for b in KINDS] for a in KINDS])
        ax.imshow(m, cmap="Blues", vmin=0, vmax=vmax)
        for i in range(len(KINDS)):
            for j in range(len(KINDS)):
                ax.text(j, i, f"{m[i, j]:.0f}", ha="center", va="center", fontsize=10,
                        color="#f0f0f4" if m[i, j] / vmax > 0.6 else "#26262c")
        ax.set_xticks(range(len(KINDS)), KINDS, fontsize=7)
        ax.set_yticks(range(len(KINDS)), KINDS, fontsize=7)
        ax.set_title(layout, fontsize=10)
        ax.set_xlabel("seat 1", fontsize=8, color="#555")
        if ax is axes[0]:
            ax.set_ylabel("seat 0", fontsize=8, color="#555")
        for sp in ax.spines.values():
            sp.set_visible(False)
    fig.suptitle("Mean sparse reward per game -- pairwise agent matrix (torch port)",
                 fontsize=12)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def render(args) -> tuple:
    """--render: the results JSON at --out as markdown and heatmap; returns
    the two paths written."""
    suffix = "_OLD_DYNAMICS" if args.old_dynamics else ""
    md = args.md or os.path.join(ROOT, f"EVAL_MATRIX_TORCH{suffix}.md")
    png = args.png or os.path.join(ROOT, f"eval_matrix_torch{suffix.lower()}.png")
    for p in (md, png):
        base = os.path.basename(p)
        if base.startswith(("EVAL_MATRIX", "eval_matrix")) and "torch" not in base.lower():
            raise SystemExit(f"{p}: the JAX package's artifact is not overwritten")
    with open(args.out) as f:
        summary = json.load(f)
    write_markdown(summary, md, os.path.basename(png))
    plot(summary["results"], png)
    print(f"wrote {md} and {png}")
    return md, png


def main(argv=None):
    args = parse_args(argv)
    args.out = args.out or os.path.join(
        "runs_torch", f"eval_matrix_results{'_old_dynamics' if args.old_dynamics else ''}.json")
    if args.render:
        return render(args)
    from overcooked_ai_tpu_torch.agents.evaluation import run_agent_pair
    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.cli.train_ppo import check_device
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.ops import _build
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

    device = check_device(args.device)
    suffix = "_old" if args.old_dynamics else ""
    art_dir = args.art_dir or os.path.join(ROOT, "artifacts_torch", f"eval_artifact{suffix}")
    bc_dir = os.path.join(ROOT, "runs", f"eval_artifact{suffix}")
    out = args.out
    overrides = {"old_dynamics": True} if args.old_dynamics else {}
    cells = args.cells or [f"{a}+{b}" for a in KINDS for b in KINDS]
    results = {}
    for layout_name in args.layouts:
        spec = from_layout_name(layout_name, **overrides)
        tables = build_motion_tables(spec.layout.terrain)
        kinds = agent_kinds(layout_name, art_dir, bc_dir)
        needed = {k for cell in cells for k in cell.split("+")}
        agents = {k: build_agent(v, spec, tables, device) for k, v in kinds.items()
                  if k in needed}
        lay_res = {}
        for cell in cells:
            a, b = cell.split("+")
            b1_before = _build.launches["oc_fused_train_step"]
            t0 = time.perf_counter()
            traj = run_agent_pair(spec, [agents[a], agents[b]], num_games=args.games,
                                  horizon=args.horizon, seed=0, greedy_carry=True,
                                  device=device)
            per_game = traj["sparse"].sum(axis=(0, 1))
            lay_res[cell] = {"mean": float(per_game.mean()), "std": float(per_game.std()),
                             "games": int(per_game.shape[0]),
                             "wall_s": time.perf_counter() - t0,
                             "b1_launches": _build.launches["oc_fused_train_step"] - b1_before}
            print(f"{layout_name} {cell}: {lay_res[cell]['mean']:.1f} +- "
                  f"{lay_res[cell]['std']:.1f} ({lay_res[cell]['wall_s']:.3f}s, B1 launches "
                  f"{lay_res[cell]['b1_launches']})", flush=True)
        results[layout_name] = lay_res
    summary = {
        "protocol": "reference evaluate.py:100-189 analogue: mean per-game sparse reward, "
                    "horizon 400, both seat orders (A+B and B+A rows)",
        "dynamics": "old" if args.old_dynamics else "new",
        "games_per_pair": args.games,
        "device": str(device),
        "results": results,
    }
    if args.compare:
        with open(args.compare) as f:
            rows = compare(results, json.load(f))
        outside = [r for r in rows if r[5] is False]
        for layout, cell, mine, want, se, within in rows:
            if within is not True:
                print(f"{'not gated' if within is None else 'OUTSIDE'}: {layout} {cell} port "
                      f"{mine:.2f} JAX {want:.2f} combined se {se:.3f}")
        summary["comparison"] = {"reference": os.path.basename(args.compare),
                                 "cells": len(rows),
                                 "within_3se": sum(r[5] is True for r in rows),
                                 "outside_3se": [f"{r[0]}:{r[1]}" for r in outside],
                                 "not_gated": [f"{r[0]}:{r[1]}" for r in rows if r[5] is None]}
        print("comparison " + json.dumps(summary["comparison"]))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {out}")
    return summary


if __name__ == "__main__":
    main()
