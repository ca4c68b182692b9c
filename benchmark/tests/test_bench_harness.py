"""The harness finds what BENCHMARK.json names, by name, and a new cell
needs only new files."""

import json
import os
import shutil

import pytest

from harness import core

BENCH = core.benchmark_spec()


def test_every_cell_config_traffic_driver_and_metric_is_found_by_name():
    for cell in BENCH["workloads"]:
        wl = core.find_workload(cell["name"])
        assert {k: wl[k] for k in ("config", "traffic", "chips")} == {
            k: cell[k] for k in ("config", "traffic", "chips")}
        core.find_config(cell["config"])
        core.load_module("drivers", core.find_traffic(cell["traffic"])["driver"])
        assert wl["limits"], cell["name"]
    for m in BENCH["per_layer"]:
        read, _ = core.metric_reader(m["name"])
        assert callable(read)
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(core.ROOT, c["file"]))


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in core.cell_metrics(BENCH, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = core.cell_metrics(BENCH, cell["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def test_a_workload_added_to_a_copy_is_found_and_listed(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(core.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cell = {"config": "ppo_cnn", "traffic": "selfplay_2048x400", "chips": 1,
            "limits": {"env_mismatch": 0}}
    (copy / "workloads" / "selfplay_cramped_copy.json").write_text(json.dumps(cell))
    assert "selfplay_cramped_copy" in core.list_workloads(str(copy))
    assert core.find_workload("selfplay_cramped_copy", str(copy))["traffic"] == cell["traffic"]
    assert "selfplay_cramped_copy" not in core.list_workloads()


def test_a_missing_name_is_an_error():
    with pytest.raises(core.BenchmarkError):
        core.find_workload("no_such_cell")
    with pytest.raises(core.BenchmarkError):
        core.metric_reader("no_such_metric.selfplay")


def test_check_is_correct_only_within_every_limit():
    check = core.Check({"a": 0, "b": 1e-3})
    check.add("a", 0)
    check.add("b", 5e-4)
    assert check.correct()
    check.add("b", 2e-3)
    assert not check.correct()
    assert check.table()["b"] == {"value": 2e-3, "limit": 1e-3}
    unlimited = core.Check({})
    unlimited.add("c", 0)
    assert not unlimited.correct()
    nan = core.Check({"d": 1.0})
    nan.add("d", float("nan"))
    assert not nan.correct()
    uncompared = core.Check({"e": None, "f": 1.0})
    uncompared.add("e", 5.0)
    uncompared.add("f", 0.5)
    assert uncompared.correct() and list(uncompared.table()) == ["f"]


def test_a_cell_that_benchmark_json_does_not_name_is_refused(monkeypatch):
    import run

    listed = dict(BENCH, workloads=[w for w in BENCH["workloads"]
                                    if w["name"] != "selfplay_cramped"])
    monkeypatch.setattr(core, "benchmark_spec", lambda root=core.ROOT: listed)
    args = run.parse(["--workload", "selfplay_cramped", "--seed", "1", "--seconds", "0",
                      "--trace", "0"])
    with pytest.raises(core.BenchmarkError):
        run.make_context(args, device="cpu")
