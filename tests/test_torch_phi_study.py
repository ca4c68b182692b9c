"""`overcooked_ai_tpu_torch.cli.phi_study` on the CPU: one seed and two
iterations of the no-phi config, and the study's file against the JAX
study's own (`runs/phi_study/results.json`): the same configs and the same
schema. The study's numbers come from the card."""

import json
import os

import pytest
import torch

from overcooked_ai_tpu_torch.cli import phi_study

with open(phi_study.JAX_RESULTS) as f:
    JAX = json.load(f)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(entry):
    return (sorted(entry), sorted(entry["config"]), sorted(entry["seeds"][0]))


def test_one_seed_two_iterations(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(phi_study, "ITERATIONS", 2)
    out = tmp_path / "phi"
    results = phi_study.main(["--seeds", "1", "--only", "nophi_ci",
                              "--out", str(out), "--device", "cpu"])
    with open(out / "results.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(results)) and list(written) == ["nophi_ci"]
    entry = written["nophi_ci"]
    assert _keys(entry) == _keys(JAX["nophi_ci"])
    assert entry["config"] == JAX["nophi_ci"]["config"]
    assert (entry["source"], entry["reference_threshold"]) == (
        JAX["nophi_ci"]["source"], JAX["nophi_ci"]["reference_threshold"])
    seed = entry["seeds"][0]
    assert seed["seed"] == 0 and len(seed["curve_total_reward"]) == 2
    assert entry["mean"] == entry["min"] == entry["max"] == seed["avg_total_reward_last5"]
    with open(out / "comparison.json") as f:
        comp = json.load(f)
    assert comp["device"] == "cpu" and set(comp["configs"]) == {"nophi_ci"}
    assert comp["configs"]["nophi_ci"]["jax_mean"] == JAX["nophi_ci"]["mean"]
    assert "nophi_ci seed=0" in capsys.readouterr().out


def test_configs_are_the_jax_study_s():
    got = {name: (threshold, source) for name, _, threshold, source in phi_study.configs()}
    assert list(got) == list(JAX)
    for name, cfg, _, _ in phi_study.configs():
        assert got[name] == (JAX[name]["reference_threshold"], JAX[name]["source"])
        assert {"num_envs": cfg.num_envs, "horizon": cfg.horizon, "lr": cfg.lr,
                "use_phi": cfg.use_phi, "sgd_minibatch_size": cfg.sgd_minibatch_size,
                "num_sgd_iter": cfg.num_sgd_iter} == JAX[name]["config"]
        assert cfg.entropy_coeff_start == cfg.entropy_coeff_end == 0.0


def test_compare_floors_and_standard_errors():
    comp = phi_study.compare(JAX, JAX)
    assert all(row["distance_in_se"] == 0 for row in comp.values())
    assert comp["phi_ci_lr5e-3"]["seeds_below_floor"] == []  # 29.3 .. 48.5 >= 13
    assert comp["phi_prod_lr5e-5"]["seeds_below_floor"] == []  # no floor
    low = json.loads(json.dumps(JAX["nophi_ci"]))
    low["seeds"][3]["avg_total_reward_last5"] = 4.9
    low["mean"] += 1.0
    row = phi_study.compare({"nophi_ci": low}, JAX)["nophi_ci"]
    assert row["seeds_below_floor"] == [3]
    se = (2 * 2.43 ** 2 / 5) ** 0.5
    assert row["combined_se"] == pytest.approx(se) and row["distance_in_se"] == pytest.approx(
        1.0 / se)


def test_never_writes_the_jax_study():
    with pytest.raises(SystemExit, match="JAX study"):
        phi_study.main(["--out", os.path.dirname(phi_study.JAX_RESULTS), "--device", "cpu"])
