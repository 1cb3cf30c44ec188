"""Runs of the harness on the CPU at a tiny size: the result line, and
``correct`` false under each fault that a cell can have, planted in the
program's search underneath the harness."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(spec, name, trace=False, seconds=0.3):
    return harness.run_cell(name, 2 ** 31 + 77, seconds, trace, device="cpu",
                            spec=spec)


@pytest.mark.parametrize("name", ["deep1m-l2.single", "deep1m-l2.batch",
                                  "deep1m-l2.filtered", "deep10m-ip.batch"])
def test_bench_sound_run(tiny_spec, name):
    spec = tiny_spec(name)
    out = _run(spec, name)
    assert set(out) == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for m in out["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["device"]["count"] == 1
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out, allow_nan=False)


def test_bench_traced_run(tiny_spec):
    name = "deep1m-l2.batch"
    spec = tiny_spec(name)
    # on the CPU a call runs inside search_async: with 16 in flight the
    # loop's first wait could come after the window, so the trace never
    # starts on a loaded machine
    spec["traffic"]["depth"] = 2
    out = _run(spec, name, trace=True, seconds=2.0)
    assert out["correct"] is True
    # the CPU has no device trace: the readers of the trace read nothing
    assert set(out["metrics"]) == {"enqueue_ms.batch1m",
                                   "fallback_share.batch1m"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


class _Token:
    def __init__(self, result):
        self.result = result

    def wait(self):
        return self.result


def _plant(monkeypatch, fault):
    """Break TorchIndexFlat.search_async where its answer is produced."""
    from faiss_tpu_torch.index import TorchIndexFlat

    orig = TorchIndexFlat.search_async
    last = {}

    def search_async(self, x, k, params=None):
        if fault == "unfiltered":
            params = None
        if fault == "half":
            n = len(x) // 2
            d, i = orig(self, x[:n], k, params=params).wait()
            return _Token((np.concatenate([d, d])[:len(x)],
                           np.concatenate([i, i])[:len(x)]))
        d, i = orig(self, x, k, params=params).wait()
        d, i = d.copy(), i.copy()
        if fault == "altered":
            i[0, 0] = (i[0, 0] + 1) % self.ntotal
        if fault == "stale":
            prev = last.get(len(x))
            last[len(x)] = (d, i)
            if prev is not None:
                d, i = prev
        return _Token((d, i))

    monkeypatch.setattr(TorchIndexFlat, "search_async", search_async)


@pytest.mark.parametrize("name,fault", [
    ("deep1m-l2.single", "altered"), ("deep1m-l2.single", "stale"),
    ("deep1m-l2.batch", "altered"), ("deep1m-l2.batch", "stale"),
    ("deep1m-l2.batch", "half"), ("deep10m-ip.batch", "half"),
    ("deep1m-l2.filtered", "unfiltered"), ("deep1m-l2.filtered", "altered"),
])
def test_bench_fault_is_not_correct(tiny_spec, monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    out = _run(tiny_spec(name), name)
    assert out["correct"] is False, out["checks"]


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "deep1m-l2.single",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
         *args], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_bench_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _cli(harness.ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_bench_cli_fails_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("what", ["index", "generator", "chips", "selector",
                                  "flat_on_two"])
def test_bench_run_refuses_what_it_cannot_run(tiny_spec, what):
    """A cell that names an index type, a generator, a chip count or a
    selector the harness has no file or rule for raises; it never runs
    as something else."""
    name = "deep1m-l2.filtered" if what == "selector" else "deep1m-l2.single"
    spec = tiny_spec(name)
    cfg = spec["config"]
    if what == "index":
        cfg["index"]["type"] = "TorchIndexIVFFlat"
    elif what == "generator":
        cfg["data"]["generator"] = "sift_integers"
    elif what == "chips":
        spec["cell"]["chips"] = 2
    elif what == "selector":
        spec["traffic"]["selector"]["kind"] = "range"
    if what == "flat_on_two":
        from benchmark import harness as h
        with pytest.raises(SystemExit, match="one device"):
            h.index_type(cfg).build(cfg, [torch.device("cpu")] * 2)
        return
    with pytest.raises(SystemExit):
        _run(spec, name, seconds=0.1)


GATE = """
import json, sys
sys.path[:0] = [{copy!r}, {stub!r}, {root!r}]
from benchmark import run
spec = json.load(open({spec!r}))
sys.exit(run.main(["--workload", "deep1m-l2.single", "--seed", "5",
                   "--seconds", "0.3", "--trace", "0"],
                  device="cpu", spec=spec))
"""


@pytest.mark.parametrize("planted", [None, "jax", "faiss_tpu"])
def test_bench_gate_checks_the_modules_last(tiny_spec, tmp_path, planted):
    """A metric's reader, loaded after the window, that imports jax (a stub
    here) or faiss_tpu: the run exits 3 and prints no result. Without one
    the same run prints its result line."""
    copy = tmp_path / "copy"
    shutil.copytree(harness.BENCH_DIR, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    stub = tmp_path / "stub"
    for mod in ("jax", "faiss_tpu"):
        (stub / mod).mkdir(parents=True)
        (stub / mod / "__init__.py").write_text("")
    spec = tiny_spec("deep1m-l2.single")
    if planted:
        (copy / "benchmark" / "metrics" / "planted.py").write_text(
            f"import {planted}\n\n\ndef read(run):\n    return 1.0\n")
        spec["end_to_end"].append({"name": "planted", "unit": "s",
                                   "better": "lower", "bound": 0.25,
                                   "source": "host_clock"})
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    code = GATE.format(copy=str(copy), stub=str(stub),
                       root=str(harness.ROOT), spec=str(tmp_path / "spec.json"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    if planted:
        assert out.returncode == 3, out.stderr[-2000:]
        assert out.stdout == ""
        assert f"loaded {planted}" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is True and list(res)[-1] == "checks"


def test_bench_index_type_judges_its_own_answers(tiny_spec, monkeypatch):
    """An index module with a ``judge`` of its own is judged by it, through
    the harness's verdict."""
    import types

    flat = harness.index_type(tiny_spec("deep1m-l2.single")["config"])
    calls = []

    def judge(*args):
        calls.append(args)
        return dict(bad_ids=1, dist_err=0.0, rank_gap=0.0, answers=1)

    mod = types.SimpleNamespace(build=flat.build,
                                search_params=flat.search_params,
                                fallbacks=flat.fallbacks, judge=judge)
    monkeypatch.setattr(harness, "index_type", lambda config: mod)
    name = "deep1m-l2.single"
    out = _run(tiny_spec(name), name, seconds=0.1)
    assert calls and out["correct"] is False
    assert out["checks"]["bad_ids"]["value"] == 1
