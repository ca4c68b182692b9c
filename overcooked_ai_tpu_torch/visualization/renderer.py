"""State rendering (port of `overcooked_ai_tpu.visualization.renderer`;
reference StateVisualizer, visualization/state_visualizer.py:37-314).

A copy for the host: numpy and PIL over reference-format state dicts (the
port's `state_to_dict`), with PIL imported when a frame is drawn, so that
importing the module needs neither the card nor PIL.

The reference blits licensed sprite-sheet assets with pygame; this renderer
draws an original tile/glyph scheme with PIL so it runs headless, needs no
binary assets, and produces RGB arrays for notebooks, gym `render()`, the
web demo, and trajectory videos. A `StateVisualizer` class mirrors the
reference API surface (render_state / display_rendered_trajectory).
"""

from __future__ import annotations

import numpy as np

TILE = 48

COLORS = {
    "floor": (40, 40, 48),
    "counter": (130, 110, 90),
    "pot": (60, 60, 66),
    "onion_disp": (200, 170, 60),
    "tomato_disp": (190, 60, 50),
    "dish_disp": (210, 210, 215),
    "serve": (90, 160, 90),
    "onion": (230, 190, 70),
    "tomato": (220, 70, 60),
    "dish": (240, 240, 245),
    "soup_idle": (160, 120, 60),
    "soup_cooking": (230, 140, 40),
    "soup_ready": (90, 220, 90),
    "player0": (80, 140, 230),
    "player1": (90, 200, 120),
    "player2": (200, 120, 200),
    "player3": (230, 200, 90),
    "text": (235, 235, 235),
}

TERRAIN_FILL = {
    " ": "floor",
    "X": "counter",
    "P": "pot",
    "O": "onion_disp",
    "T": "tomato_disp",
    "D": "dish_disp",
    "S": "serve",
}

TERRAIN_GLYPH = {"P": "P", "O": "O", "T": "T", "D": "D", "S": "S"}


def _draw_object(draw, cx, cy, name, r=TILE // 5):
    color = COLORS.get(name, COLORS["dish"])
    draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color)


def _soup_color(obj):
    if obj.get("is_ready"):
        return "soup_ready"
    if obj.get("is_cooking"):
        return "soup_cooking"
    return "soup_idle"


_ING_COLOR = {"onion": "onion", "tomato": "tomato"}


def _draw_order_icon(draw, x0, y0, ingredients, size=20):
    """A mini recipe icon: a bowl with per-ingredient dots (the reference
    blits the sprite-sheet's done-soup frame, state_visualizer.py:495-531)."""
    draw.ellipse(
        [x0, y0 + 4, x0 + size, y0 + size], fill=COLORS["dish"],
        outline=(25, 25, 30),
    )
    for i, ing in enumerate(ingredients):
        ix = x0 + 3 + (i % 3) * (size // 3)
        iy = y0 + 6 + (i // 3) * (size // 3)
        draw.ellipse(
            [ix, iy, ix + size // 4, iy + size // 4],
            fill=COLORS[_ING_COLOR.get(ing, "dish")],
        )


_HUD_LINE_H = 24


def _render_hud(draw, hud_data, width_px):
    """Structured HUD lines (reference _render_hud_data,
    state_visualizer.py:478-560): order keys render recipe icons, the rest
    render as 'key: value' text."""
    order_keys = {
        "all_orders", "bonus_orders", "start_all_orders",
        "start_bonus_orders",
    }
    for line, (key, value) in enumerate(sorted(hud_data.items())):
        y0 = 4 + line * _HUD_LINE_H
        if key in order_keys and value:
            draw.text((4, y0), f"{key}:", fill=COLORS["text"])
        else:
            draw.text((4, y0), f"{key}: {value}", fill=COLORS["text"])
        if key in order_keys and value:
            x0 = 110
            for order in value:
                ings = (
                    order["ingredients"] if isinstance(order, dict) else order
                )
                _draw_order_icon(draw, x0, y0 - 2, list(ings))
                x0 += 26


def _draw_prob_arrow(draw, cx, cy, dx, dy, prob, color=(250, 250, 160)):
    """One action-probability arrow; area proportional to prob like the
    reference (sqrt scaling, state_visualizer.py:646-650)."""
    import math

    size = math.sqrt(max(float(prob), 0.0))
    if size < 0.05:
        return
    ln = size * TILE * 0.45
    wd = max(int(size * 6), 1)
    x1, y1 = cx + dx * TILE * 0.3, cy + dy * TILE * 0.3
    x2, y2 = x1 + dx * ln, y1 + dy * ln
    draw.line([x1, y1, x2, y2], fill=color, width=wd)
    # arrow head
    px, py = -dy, dx  # perpendicular
    hx, hy = x2 - dx * ln * 0.3, y2 - dy * ln * 0.3
    draw.polygon(
        [
            (x2, y2),
            (hx + px * wd * 1.5, hy + py * wd * 1.5),
            (hx - px * wd * 1.5, hy - py * wd * 1.5),
        ],
        fill=color,
    )


# action index -> direction delta (N, S, E, W); 4=STAY, 5=INTERACT
_ACTION_DELTAS = {0: (0, -1), 1: (0, 1), 2: (1, 0), 3: (-1, 0)}


def _render_action_probs(draw, state_dict, action_probs, hud_h):
    """Per-player 6-action probability overlay (reference
    _render_actions_probs, state_visualizer.py:609-660): directional
    arrows; STAY = ring on the player tile; INTERACT = square outline."""
    import math

    for p, probs in zip(state_dict["players"], action_probs):
        if probs is None:
            continue
        x, y = p["position"]
        cx, cy = x * TILE + TILE // 2, y * TILE + TILE // 2 + hud_h
        for a, (dx, dy) in _ACTION_DELTAS.items():
            _draw_prob_arrow(draw, cx, cy, dx, dy, probs[a])
        stay = math.sqrt(max(float(probs[4]), 0.0))
        if stay >= 0.05:
            r = stay * TILE * 0.25
            draw.ellipse(
                [cx - r, cy - r, cx + r, cy + r], outline=(250, 250, 160),
                width=2,
            )
        inter = math.sqrt(max(float(probs[5]), 0.0))
        if inter >= 0.05:
            r = inter * TILE * 0.35
            draw.rectangle(
                [cx - r, cy - r, cx + r, cy + r], outline=(160, 250, 250),
                width=2,
            )


def render_state_rgb(
    spec, state_dict, hud: str = "", hud_data=None, action_probs=None
) -> np.ndarray:
    """Render a reference-format state dict to an (H*T[+hud], W*T, 3) uint8
    RGB array.

    hud: single free-text HUD line. hud_data: structured dict (orders keys
    render recipe icons). action_probs: per-player (6,) action
    distributions drawn as probability arrows/markers.
    """
    from PIL import Image, ImageDraw

    rows = spec.terrain_chars
    height, width = len(rows), len(rows[0])
    if hud_data:
        hud_h = 4 + _HUD_LINE_H * len(hud_data)
    elif hud:
        hud_h = TILE // 2
    else:
        hud_h = 0
    img = Image.new("RGB", (width * TILE, height * TILE + hud_h), COLORS["floor"])
    draw = ImageDraw.Draw(img)

    for y, row in enumerate(rows):
        for x, c in enumerate(row):
            x0, y0 = x * TILE, y * TILE + hud_h
            draw.rectangle(
                [x0, y0, x0 + TILE - 1, y0 + TILE - 1],
                fill=COLORS[TERRAIN_FILL[c]],
                outline=(25, 25, 30),
            )
            if c in TERRAIN_GLYPH:
                draw.text(
                    (x0 + 4, y0 + 2), TERRAIN_GLYPH[c], fill=COLORS["text"]
                )

    # loose / pot objects
    for obj in state_dict.get("objects", []):
        x, y = obj["position"]
        cx, cy = x * TILE + TILE // 2, y * TILE + TILE // 2 + hud_h
        if obj["name"] == "soup":
            _draw_object(draw, cx, cy, _soup_color(obj), r=TILE // 4)
            n = len(obj.get("_ingredients", []))
            tick = obj.get("cooking_tick", -1)
            label = f"{n}" if tick < 0 else f"{tick}"
            draw.text((cx - 4, cy - 7), label, fill=(20, 20, 20))
        else:
            _draw_object(draw, cx, cy, obj["name"])

    # players with orientation wedge + held object
    arrow = {(0, -1): (0, -1), (0, 1): (0, 1), (1, 0): (1, 0), (-1, 0): (-1, 0)}
    for i, p in enumerate(state_dict["players"]):
        x, y = p["position"]
        cx, cy = x * TILE + TILE // 2, y * TILE + TILE // 2 + hud_h
        color = COLORS[f"player{i % 4}"]
        r = TILE // 3
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color)
        dx, dy = arrow[tuple(p["orientation"])]
        draw.line(
            [cx, cy, cx + dx * r, cy + dy * r], fill=(20, 20, 25), width=3
        )
        held = p.get("held_object")
        if held:
            hx, hy = cx + dx * r, cy + dy * r
            if held["name"] == "soup":
                _draw_object(draw, hx, hy, "soup_ready", r=TILE // 6)
            else:
                _draw_object(draw, hx, hy, held["name"], r=TILE // 6)

    if action_probs is not None:
        _render_action_probs(draw, state_dict, action_probs, hud_h)
    if hud_data:
        _render_hud(draw, hud_data, width * TILE)
    elif hud:
        draw.text((4, 2), hud, fill=COLORS["text"])
    return np.asarray(img, np.uint8)


class StateVisualizer:
    """API-compatible veneer over render_state_rgb (reference
    state_visualizer.py:37,162,262)."""

    def __init__(self, **config):
        self.config = config

    def render_state(
        self, state, grid=None, hud_data=None, spec=None, action_probs=None
    ):
        assert spec is not None or grid is not None
        if spec is None:
            spec = _spec_from_grid(grid)
        state_dict = state if isinstance(state, dict) else state.to_dict()
        return render_state_rgb(
            spec, state_dict, hud_data=hud_data, action_probs=action_probs
        )

    def display_rendered_trajectory(
        self,
        trajectories,
        trajectory_idx=0,
        spec=None,
        img_directory_path=None,
        hud_data_list=None,
        action_probs=None,
        ipython_display=False,
    ):
        """Render every state of a trajectory; returns (or saves) frames.

        action_probs: [timestep][player][action] like the reference
        (state_visualizer.py:167-219). ipython_display=True shows an
        interactive timestep slider when ipywidgets is available.
        """
        states = trajectories["ep_states"][trajectory_idx]
        n = len(states)
        hud_data_list = hud_data_list or [None] * n
        action_probs = action_probs or [None] * n
        frames = [
            self.render_state(
                s, spec=spec, hud_data=hud_data_list[i],
                action_probs=action_probs[i],
            )
            for i, s in enumerate(states)
        ]
        if img_directory_path:
            import os

            from PIL import Image

            os.makedirs(img_directory_path, exist_ok=True)
            for i, fr in enumerate(frames):
                Image.fromarray(fr).save(
                    os.path.join(img_directory_path, f"{i}.png")
                )
        if ipython_display:
            show_trajectory_slider(frames)
        return frames


def show_trajectory_slider(frames, slider_label="timestep"):
    """Interactive ipython slider over rendered frames (reference
    ipython_images_slider, visualization_utils.py:9-28). No-op with a
    message outside an ipython/ipywidgets environment."""
    try:
        from IPython.display import display
        from ipywidgets import IntSlider, interactive
    except ImportError:
        print("ipywidgets not available; returning frames only")
        return None

    import io

    from PIL import Image

    def display_f(**kwargs):
        from IPython.display import Image as IPImage

        buf = io.BytesIO()
        Image.fromarray(frames[kwargs[slider_label]]).save(buf, "PNG")
        display(IPImage(buf.getvalue()))

    widget = interactive(
        display_f,
        **{slider_label: IntSlider(min=0, max=len(frames) - 1, step=1)},
    )
    display(widget)
    return widget


def _spec_from_grid(grid):
    rows = grid if isinstance(grid[0], str) else ["".join(r) for r in grid]

    class _MiniSpec:
        terrain_chars = rows

    return _MiniSpec()
