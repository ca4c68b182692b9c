"""Plot training curves from metrics.jsonl run directories (port of
`overcooked_ai_tpu.cli.plot_metrics`; the reference's plot_graph.py).

Reads the JSONL rows that `training/checkpoint.MetricsLogger` writes (the
JAX package's keys, so its runs plot too); matplotlib is imported only to
draw.

    python -m overcooked_ai_tpu_torch.cli.plot_metrics runs_torch/ppo [more runs]
        [--keys episode_sparse_reward episode_total_reward] [--out curves.png]
"""

from __future__ import annotations

import argparse
import json
import os


def load_metrics(run_dir):
    path = run_dir if run_dir.endswith(".jsonl") else os.path.join(run_dir, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--keys", nargs="+", default=["episode_sparse_reward", "episode_total_reward"])
    ap.add_argument("--out", default="curves.png")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(args.keys), figsize=(6 * len(args.keys), 4), squeeze=False)
    for run in args.runs:
        rows = load_metrics(run)
        steps = [r["step"] for r in rows]
        label = os.path.basename(os.path.normpath(run))
        for j, key in enumerate(args.keys):
            axes[0][j].plot(steps, [r.get(key) for r in rows], label=label)
            axes[0][j].set_title(key)
            axes[0][j].set_xlabel("iteration")
    for j in range(len(args.keys)):
        axes[0][j].legend()
        axes[0][j].grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
