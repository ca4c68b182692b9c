"""`cli.eval_artifact --render` on the CPU: a two-layout results JSON in the
port's schema becomes the JAX package's markdown tables, row for row, and
a heatmap; the JAX package's own artifact files are never written."""

import json
import os

import pytest
from PIL import Image

from overcooked_ai_tpu_torch.cli import eval_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ["cramped_room", "coordination_ring"]


def _summary():
    """The JAX table's cells for two layouts, as the port's CLI writes them
    (unrounded floats, each cell with its wall and launches)."""
    with open(os.path.join(REPO, "eval_matrix_results.json")) as f:
        jax = json.load(f)
    results = {lay: {cell: {**v, "mean": v["mean"] + 1e-9, "wall_s": 0.5, "b1_launches": 400}
                     for cell, v in jax["results"][lay].items()} for lay in LAYOUTS}
    return {"protocol": jax["protocol"], "dynamics": "new", "games_per_pair": 10,
            "device": "cpu", "results": results}


def _tables(text):
    """{layout: its table's lines} of an EVAL_MATRIX markdown."""
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("### "):
            cur = out.setdefault(line[4:], [])
        elif cur is not None and line.startswith("|"):
            cur.append(line)
    return out


def test_render_two_layouts(tmp_path):
    results = tmp_path / "results.json"
    results.write_text(json.dumps(_summary()))
    md, png = tmp_path / "m.md", tmp_path / "h.png"
    got = eval_artifact.main(["--render", "--out", str(results), "--md", str(md),
                              "--png", str(png)])
    assert got == (str(md), str(png))
    text = md.read_text()
    with open(os.path.join(REPO, "EVAL_MATRIX.md")) as f:
        want = _tables(f.read())
    tables = _tables(text)
    assert list(tables) == LAYOUTS
    for lay in LAYOUTS:
        assert tables[lay] == want[lay] and len(tables[lay]) == 6
    assert "![pairwise matrix heatmaps](h.png)" in text and "device `cpu`" in text
    with Image.open(png) as im:
        assert im.format == "PNG" and im.size[0] > im.size[1] > 0  # two panels side by side


def test_default_names_are_the_port_s(tmp_path, monkeypatch):
    written = []
    monkeypatch.setattr(eval_artifact, "write_markdown", lambda s, p, n: written.append((p, n)))
    monkeypatch.setattr(eval_artifact, "plot", lambda r, p: written.append(p))
    results = tmp_path / "results.json"
    results.write_text(json.dumps(_summary()))
    eval_artifact.main(["--render", "--old-dynamics", "--out", str(results)])
    assert written == [(os.path.join(REPO, "EVAL_MATRIX_TORCH_OLD_DYNAMICS.md"),
                        "eval_matrix_torch_old_dynamics.png"),
                       os.path.join(REPO, "eval_matrix_torch_old_dynamics.png")]


@pytest.mark.parametrize("flag,name", [("--md", "EVAL_MATRIX.md"), ("--png", "eval_matrix.png")])
def test_never_over_the_jax_artifact(tmp_path, flag, name):
    results = tmp_path / "results.json"
    results.write_text(json.dumps(_summary()))
    with pytest.raises(SystemExit, match="not overwritten"):
        eval_artifact.main(["--render", "--out", str(results), flag, str(tmp_path / name)])
