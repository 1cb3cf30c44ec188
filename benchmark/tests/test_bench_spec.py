"""BENCHMARK.json against the format its runner reads, and every name in it found
by the harness in a file of its own."""

import json
import re

import pytest

from benchmark import datagen, harness

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_bench_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    for sec, keys in KEYS.items():
        names = [e["name"] for e in BENCH[sec]]
        assert len(names) == len(set(names)), sec
        for e in BENCH[sec]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "source", "layer"):
                if k in e and sec != "end_to_end":
                    assert _line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            if "workloads" in e:
                assert set(e["workloads"]) <= set(CELLS), e["name"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bench_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_found_by_name(cell):
    spec = harness.cell_spec(cell)
    assert spec["cell"]["chips"] == 1
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    cfg, tr = spec["config"], spec["traffic"]
    assert {"dist_err", "rank_gap"} <= set(cfg["limits"])
    assert {"nq", "k", "depth"} <= set(tr)
    for key in ("metric", "storage"):
        assert key in cfg["index"]
    assert callable(harness.index_type(cfg).build)
    assert callable(datagen.load_generator(cfg["data"]["generator"]).draw)
    if any(m["name"].startswith("sweep_roofline") for m in spec["per_layer"]):
        assert {"kernels", "q_planes", "db_planes", "terms", "kind"} <= set(
            cfg["sweep"])


def test_bench_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert harness.read_json(harness.ROOT / c["file"])["name"] == c["name"]
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_bench_reader_falls_back_to_the_base_name():
    assert harness.reader("enqueue_ms.batch") is not None
    with pytest.raises(SystemExit):
        harness.reader("no_such_metric.batch")


def test_bench_unknown_index_type_and_chips_raise():
    cfg = harness.cell_spec(CELLS[0])["config"]
    with pytest.raises(SystemExit, match="no index type"):
        harness.index_type(dict(cfg, index=dict(cfg["index"], type="NoSuch")))
    with pytest.raises(SystemExit, match="chips"):
        harness.devices_of(2, "cpu")
    assert harness.devices_of(4, "cpu") == [harness.torch.device("cpu")]
