"""The 49-layout dynamics certificate under old (auto-cook) dynamics on the
torch port: `run_ours(..., old_dynamics=True)` on the plain step against
`tests/golden/certification_49_old.json.gz`, and the 15 layouts whose
orders old dynamics does not accept refused, as the JAX package and the
reference refuse them."""

import pytest
import torch

from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu_torch.cli import certify_layouts
from overcooked_ai_tpu_torch.core.layout import from_layout_name

from . import golden_io

CERTS = certify_layouts.certificates(old_dynamics=True)
UNSUPPORTED = sorted(n for n, c in CERTS.items() if c.get("unsupported"))
SUPPORTED = sorted(n for n, c in CERTS.items() if not c.get("unsupported"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_certificates_cover_every_layout_file():
    assert sorted(CERTS) == certify_layouts.layout_names()
    assert CERTS == golden_io.load("certification_49_old")["layouts"]
    assert (len(SUPPORTED), len(UNSUPPORTED)) == (34, 15)


@pytest.mark.parametrize("name", SUPPORTED)
def test_layout_certified_old_dynamics(name):
    got = certify_layouts.run_ours(name, old_dynamics=True, device="cpu")
    assert got["plain"] == CERTS[name], (
        f"{name} (old dynamics): the port's replay differs from the certificate\n"
        f"got:  {got['plain']}\nwant: {CERTS[name]}")


@pytest.mark.parametrize("name", UNSUPPORTED)
def test_unsupported_layout_refused(name):
    """Old dynamics accepts 3-item orders only (reference
    overcooked_mdp.py:1121-1127): the port raises ValueError where the JAX
    package asserts."""
    assert certify_layouts.refuses(name)
    with pytest.raises(ValueError, match="3 items"):
        from_layout_name(name, old_dynamics=True)
    with pytest.raises(AssertionError):
        jfrom_layout_name(name, old_dynamics=True)
