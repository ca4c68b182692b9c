"""The torch port's renderer against the JAX package's, on the CPU (twins of
`tests/test_visualization.py`): `render_state_rgb` and `StateVisualizer`
draw the same pixels from the same state dicts (the port's env's, which
equal JAX's: `test_torch_interop.py`), plain, with a text HUD, with the
structured HUD and with action-probability arrows; frames written to disk
and the slider's fallback behave as JAX's do.
"""

import numpy as np
import pytest

from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.visualization import renderer as jrenderer
from overcooked_ai_tpu_torch.interop.single_env import OvercookedEnv
from overcooked_ai_tpu_torch.visualization import renderer

PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]


def _states(layout="cramped_room", steps=120, every=30):
    """State dicts of an interact-heavy episode (soups, held objects)."""
    env = OvercookedEnv.from_layout_name(layout, horizon=400, device="cpu")
    rng = np.random.RandomState(0)
    out = [env.state_dict()]
    for t in range(1, steps + 1):
        env.step(rng.choice(6, size=2, p=PROB).tolist())
        if t % every == 0:
            out.append(env.state_dict())
    return env.spec, jfrom_layout_name(layout), out


HUD = {"all_orders": [{"ingredients": ["onion", "onion", "onion"]}], "score": 42,
       "time_left": 37}
PROBS = [[0.7, 0.1, 0.1, 0.05, 0.03, 0.02], [0.0, 0.0, 0.0, 0.0, 0.5, 0.5]]


@pytest.mark.parametrize("layout", ["cramped_room", "counter_circuit_o_1order"])
@pytest.mark.parametrize("extra", [{}, {"hud": "score: 0"}, {"hud_data": HUD},
                                   {"action_probs": PROBS},
                                   {"hud_data": HUD, "action_probs": PROBS}])
def test_render_state_rgb_is_pixel_equal_to_jax(layout, extra):
    spec, jspec, states = _states(layout)
    assert any(sd["objects"] for sd in states)
    for sd in states:
        img = renderer.render_state_rgb(spec, sd, **extra)
        np.testing.assert_array_equal(img, jrenderer.render_state_rgb(jspec, sd, **extra))
        assert img.dtype == np.uint8 and img.shape[1] == spec.width * renderer.TILE


def test_hud_and_arrows_change_pixels_as_jax_documents():
    spec, _, states = _states(steps=0)
    sd = states[0]
    plain = renderer.render_state_rgb(spec, sd)
    img = renderer.render_state_rgb(spec, sd, hud_data=HUD)
    assert img.shape[0] == plain.shape[0] + 4 + 24 * len(HUD)
    assert (renderer.render_state_rgb(spec, sd, action_probs=PROBS) != plain).any()
    np.testing.assert_array_equal(
        renderer.render_state_rgb(spec, sd, action_probs=[[0.0] * 6] * 2), plain)


def test_visualizer_trajectory_with_probs_matches_jax(tmp_path):
    spec, jspec, states = _states(steps=60)
    probs = [[[1 / 6] * 6] * 2] * len(states)
    huds = [{"score": t} for t in range(len(states))]
    traj = {"ep_states": [states]}
    frames = renderer.StateVisualizer().display_rendered_trajectory(
        traj, spec=spec, img_directory_path=str(tmp_path / "port"), hud_data_list=huds,
        action_probs=probs)
    jframes = jrenderer.StateVisualizer().display_rendered_trajectory(
        traj, spec=jspec, img_directory_path=str(tmp_path / "jax"), hud_data_list=huds,
        action_probs=probs)
    assert len(frames) == len(states)
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    from PIL import Image

    last = f"{len(states) - 1}.png"
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / last)),
                                  np.asarray(Image.open(tmp_path / "jax" / last)))
    # a grid instead of a spec, and a gym env's render, draw the same
    grid = renderer.StateVisualizer().render_state(states[-1], grid=spec.terrain_chars)
    np.testing.assert_array_equal(grid, renderer.render_state_rgb(spec, states[-1]))


def test_gym_render_and_slider_fallback():
    from overcooked_ai_tpu_torch.interop.gym_env import Overcooked

    gym = Overcooked(OvercookedEnv.from_layout_name("cramped_room", horizon=5, device="cpu"),
                     seed=0)
    frame = gym.render()
    assert frame.shape == (4 * renderer.TILE, 5 * renderer.TILE, 3)
    out = renderer.show_trajectory_slider([frame])
    assert out is None or hasattr(out, "children")
