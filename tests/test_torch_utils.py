"""The torch port's `utils` against `overcooked_ai_tpu.utils` on the same
inputs: the I/O round trips (each package reading what the other wrote),
the statistics and distances, the dict helpers, the renormalisation, the
profiling helpers, and `device_trace` writing a trace on the CPU."""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from overcooked_ai_tpu import utils as jutils
from overcooked_ai_tpu_torch import utils

DATA = {"a": [1, 2, 3], "b": {"c": 1.5, "d": "x"}, "e": None}


@pytest.mark.parametrize("writer,reader", [(utils, jutils), (jutils, utils), (utils, utils)],
                         ids=["port-to-jax", "jax-to-port", "port"])
def test_pickle_and_json_round_trips(tmp_path, writer, reader):
    writer.save_pickle(DATA, tmp_path / "d")
    assert os.path.exists(tmp_path / "d.pickle")
    assert reader.load_pickle(tmp_path / "d") == DATA
    arrays = {"x": np.arange(3), "y": np.float32(2.5), "z": [np.int64(4)]}
    path = writer.save_as_json(arrays, str(tmp_path / "j"))
    assert path.endswith(".json")
    assert reader.load_from_json(tmp_path / "j") == {"x": [0, 1, 2], "y": 2.5, "z": [4]}
    with pytest.raises(TypeError, match="not JSON serializable"):
        writer.save_as_json({"s": {1, 2}}, str(tmp_path / "bad"))


def test_load_dict_from_file_reads_a_layout_without_eval(tmp_path):
    path = tmp_path / "grid.layout"
    path.write_text('{"grid": """XPX\n O \nXSX""", "start_bonus_orders": [], "rew": 3}')
    assert utils.load_dict_from_file(path) == jutils.load_dict_from_file(path)
    path.write_text('{"grid": __import__("os").getcwd()}')
    for mod in (utils, jutils):
        with pytest.raises(ValueError):
            mod.load_dict_from_file(path)


@pytest.mark.parametrize("values", [[1.0, 2.0, 4.0], [3], np.arange(17) ** 1.5, [-2, 2, 0, 7]])
def test_mean_and_std_err_matches(values):
    assert utils.mean_and_std_err(values) == jutils.mean_and_std_err(values)


@pytest.mark.parametrize("a,b", [((0, 0), (3, 4)), ((5, 1), (2, 7)), ((2, 2), (2, 2))])
def test_distances_match(a, b):
    assert utils.manhattan_distance(a, b) == jutils.manhattan_distance(a, b)
    assert utils.pos_distance(a, b) == jutils.pos_distance(a, b)


def test_dict_helpers_match():
    rows = [{"r": i, "s": [i] * 2} for i in range(4)]
    assert utils.append_dictionaries(rows) == jutils.append_dictionaries(rows)
    lists = [{"r": [i, i + 1], "s": [str(i)]} for i in range(3)]
    assert utils.merge_dictionaries(lists) == jutils.merge_dictionaries(lists)
    d = {"r": list("abcde"), "s": list(range(5)), "k": "kept, as it is"}
    for keys in (None, {"r", "s"}):
        assert utils.take_indexes_from_dict(d, [4, 0, 2], keys) == (
            jutils.take_indexes_from_dict(d, [4, 0, 2], keys))
    for mod in (utils, jutils):
        with pytest.raises(AssertionError, match="key sets"):
            mod.append_dictionaries([{"a": 1}, {"b": 2}])


@pytest.mark.parametrize("shape,indices,eps", [((6,), [0, 3], 0.0), ((6,), [5], 1e-3),
                                               ((4, 6), [1, 2], 0.0), ((3, 6), [0], 1e-6)])
def test_remove_indices_and_renormalize_matches(shape, indices, eps):
    probs = np.random.RandomState(len(shape) + len(indices)).dirichlet(
        np.ones(6), size=shape[:-1] or None)
    got = utils.remove_indices_and_renormalize(probs, indices, eps)
    want = jutils.remove_indices_and_renormalize(probs, indices, eps)
    assert isinstance(got, np.ndarray) and got.shape == shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0)
    assert not np.shares_memory(got, probs)


def test_profiling_helpers():
    @utils.profile
    def work(n):
        return sum(range(n))

    with redirect_stdout(io.StringIO()) as out:
        assert work(1000) == sum(range(1000))
        with utils.timeit("phase") as t:
            pass
    assert "cumulative" in out.getvalue() and "phase: " in out.getvalue() and t.dt >= 0

    class Thing:
        @utils.classproperty
        def name(cls):
            return cls.__name__.lower()

    assert Thing.name == Thing().name == "thing"
    assert issubclass(utils.OvercookedException, Exception)


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    with utils.device_trace(tmp_path / "trace"):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
