"""The 49-layout dynamics certificate (new dynamics) on the torch port.

`overcooked_ai_tpu_torch.cli.certify_layouts.run_ours` replays every
layout's certificate stream (400 biased-random steps from the layout's
seed) through the port's plain step on the CPU and must give every field
of the certificate the JAX package froze against the live reference
(`tests/golden/certification_49.json.gz`): the final state's sha256, the
sparse and shaped totals and the 25 event totals. The card's routes (B1 a
step, B2 the whole replay) are rehearsed here on their plain versions; on
the card `chip_smoke.py` runs them on every layout.
"""

import importlib.util
import os

import pytest
import torch

from overcooked_ai_tpu_torch.cli import certify_layouts
from overcooked_ai_tpu_torch.core.layout import from_layout_name

from . import golden_io

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "certify_layouts.py")


def _jax_script():
    """The JAX package's `scripts/certify_layouts.py`, under another name."""
    spec = importlib.util.spec_from_file_location("jax_certify_layouts", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain step at one env is many small ops; intra-op threads only
    oversubscribe the cores beside pytest-xdist's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_certificates_cover_every_layout_file():
    """The certificates, the port's layout list and the JAX script's are one
    list of 49 names; the seeds and the certificate's file agree."""
    jax_script = _jax_script()
    names = certify_layouts.layout_names()
    assert len(names) == 49
    assert sorted(certify_layouts.certificates()) == names == jax_script.layout_names()
    assert certify_layouts.certificates() == golden_io.load("certification_49")["layouts"]
    for name in names:
        assert certify_layouts.cert_seed(name) == jax_script.cert_seed(name)


@pytest.mark.parametrize("name", certify_layouts.layout_names())
def test_layout_certified(name):
    cert = certify_layouts.certificates()[name]
    got = certify_layouts.run_ours(name, device="cpu")
    assert list(got) == ["plain"]
    assert got["plain"] == cert, (
        f"{name}: the port's replay differs from the certificate\n"
        f"got:  {got['plain']}\nwant: {cert}")


@pytest.mark.parametrize("name", ["cramped_room", "corridor", "cramped_room_single",
                                  "multiplayer_schelling"])
def test_card_routes_rehearsed_on_the_plain_versions(name):
    """The card's routes on CPU tensors, where the B1 and B2 wrappers run
    their plain versions: B1 (2-player layouts only; corridor is the largest
    grid, 126 cells) gives every field, B2 (1 and 4 players too) the sha and
    the sparse total, each the certificate's."""
    cert = certify_layouts.certificates()[name]
    got = certify_layouts.run_ours(name, device="cpu", routes=("B1", "B2"))
    two_player = from_layout_name(name).num_players == 2
    assert list(got) == (["B1", "B2"] if two_player else ["B2"])
    assert set(got["B2"]) == {"seed", "horizon", "final_state_sha256", "total_sparse"}
    assert certify_layouts.mismatches(cert, got) == []


def test_a_mismatch_names_the_layout_route_and_field(monkeypatch):
    cert = dict(certify_layouts.certificates()["cramped_room"])
    cert["total_shaped"] += 1
    monkeypatch.setattr(certify_layouts, "layout_names", lambda: ["cramped_room"])
    monkeypatch.setattr(certify_layouts, "certificates", lambda old=False: {"cramped_room": cert})
    with pytest.raises(SystemExit, match="cramped_room: plain gives total_shaped"):
        certify_layouts.check_all(device="cpu", log=lambda _: None)


def test_a_cover_mismatch_stops_the_check(monkeypatch):
    monkeypatch.setattr(certify_layouts, "layout_names", lambda: ["cramped_room", "nowhere"])
    with pytest.raises(SystemExit, match="nowhere"):
        certify_layouts.check_all(device="cpu", log=lambda _: None)


def test_b1_refuses_a_replay_past_its_stamp_bound(monkeypatch):
    """B1 keeps placement stamps up to 2047 - HW: a replay longer than
    `fused_train.max_horizon` fails before the first step, loudly."""
    monkeypatch.setattr(certify_layouts, "HORIZON", 1014)  # (2047 - 20) // 2 + 1
    with pytest.raises(ValueError, match="stamp bound 1013"):
        certify_layouts.run_ours("cramped_room", device="cpu", routes=("B1",))
