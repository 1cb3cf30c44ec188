"""The filtered cell, ``deep1m-l2.filtered``: its spec found by name, the
readers of its selector layer (``sel_stream_ms``, ``sel_host_share``) on
planted and on recorded spans and counters, and a tiny run on the CPU,
correct as it is and not correct with the selector dropped."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import devtrace, harness

CELL = "deep1m-l2.filtered"
NEW = ("sel_stream_ms.filtered", "sel_host_share.filtered")
# the single cell's metrics, read in this cell too
SHARED = ("enqueue_ms", "upload_ms", "replay_ms", "copy_wait_ms",
          "fallback_share", "sweep_roofline", "idle_share")


def _run(device=(("kernel", 1.0, 2.0),)):
    return SimpleNamespace(trace=devtrace.Trace(0.0, 10.0,
                                                device=list(device)))


def test_bench_filtered_cell_found_by_name():
    spec = harness.cell_spec(CELL)
    assert spec["cell"]["config"] == "deep1m-l2-filtered"
    assert spec["cell"]["chips"] == 1
    tr = spec["traffic"]
    assert (tr["nq"], tr["k"], tr["depth"]) == (1, 10, 1)
    assert tr["selector"] == {"kind": "batch", "share": 0.1, "sets": 16}
    assert {m["name"] for m in spec["end_to_end"]} == {
        "latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == list(NEW) + [
        f"{stem}.filtered" for stem in SHARED]
    for m in spec["per_layer"]:
        assert m["moves"] == "latency_p95_ms"
        assert (m["layer"] == "selector") == (m["name"] in NEW)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    ixt = harness.index_type(spec["config"])
    (p,) = ixt.search_params([np.array([1, 5, 9])])
    np.testing.assert_array_equal(p.sel.ids, [1, 5, 9])
    # the single cell reads none of the selector's metrics
    assert not {m["name"] for m in harness.cell_spec(
        "deep1m-l2.single")["per_layer"]} & set(NEW)


def _records(monkeypatch, spans, counts):
    from faiss_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", lambda: [
        tracing.Record(name, 0, int(ms * 1e6), 1, None)
        for name, ms in spans])
    monkeypatch.setattr(tracing, "counts", lambda: [
        tracing.Count(name, v, 1) for name, v in counts])


def test_bench_selector_readers_read_planted_records(monkeypatch):
    _records(monkeypatch,
             [("index.sel_stream", 0.02), ("index.sel_stream", 0.04),
              ("index.sel_stream", 0.06), ("index.sel_stream", 0.08),
              ("programs.replay", 5.0)],
             [("sel.uploads", 1), ("sel.host_evals", 2),
              ("flat.tier1_rows", 7)])
    run = _run()
    assert harness.reader(NEW[0])(run) == pytest.approx(0.05)
    assert harness.reader(NEW[1])(run) == pytest.approx(75.0)


def test_bench_selector_readers_without_a_trace(monkeypatch):
    _records(monkeypatch, [("index.sel_stream", 0.02)], [("sel.uploads", 1)])
    for name in NEW:
        read = harness.reader(name)
        assert read(SimpleNamespace(trace=None)) is None
        assert read(_run(device=())) is None


def test_bench_selector_readers_without_spans_or_counters(monkeypatch):
    from faiss_tpu_torch import tracing

    _records(monkeypatch, [], [("sel.uploads", 1)])
    for name in NEW:
        assert harness.reader(name)(_run()) is None
    # a program that does not count them: nothing, not 0
    _records(monkeypatch, [("index.sel_stream", 45.0)], [])
    monkeypatch.setattr(tracing, "HOST_COUNTERS", ("flat.tier1_rows",))
    assert harness.reader(NEW[1])(_run()) is None
    assert harness.reader(NEW[0])(_run()) == pytest.approx(45.0)


def test_bench_selector_readers_on_a_program_without_spans(monkeypatch):
    import faiss_tpu_torch

    monkeypatch.delattr(faiss_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "faiss_tpu_torch.tracing", None)
    for name in NEW:
        assert harness.reader(name)(_run()) is None


def test_bench_selector_readers_on_recorded_stretches():
    """Five filtered searches under the CPU's profiler: a new selector's
    one copy in the first stretch, none in the next; the span's mean."""
    from faiss_tpu_torch import (IDSelectorBatch, SearchParams,
                                 TorchIndexFlat, tracing)

    rng = np.random.default_rng(0)
    idx = TorchIndexFlat(16, device="cpu")
    idx.add(rng.standard_normal((3000, 16), dtype=np.float32))
    xq = rng.standard_normal((1, 16), dtype=np.float32)
    p = SearchParams(sel=IDSelectorBatch(np.arange(0, 3000, 10)))
    reads = []
    for _ in range(2):
        idx.search(xq, 10)          # unprofiled: the next stretch is new
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(5):
                idx.search(xq, 10, params=p)
        ms = [r.ms for r in tracing.spans() if r.name == "index.sel_stream"]
        assert len(ms) == 5
        assert harness.reader(NEW[0])(_run()) == pytest.approx(
            sum(ms) / 5)
        reads.append(harness.reader(NEW[1])(_run()))
    assert reads == [pytest.approx(20.0), 0.0]


@pytest.mark.parametrize("fault", [None, "unfiltered"])
def test_bench_filtered_tiny_run(tiny_spec, monkeypatch, fault):
    """Correct as it is; with the selector dropped under the harness, ids
    outside each call's set come back and the judge counts them."""
    from faiss_tpu_torch.index import TorchIndexFlat

    if fault:
        orig = TorchIndexFlat.search_async
        monkeypatch.setattr(
            TorchIndexFlat, "search_async",
            lambda self, x, k, params=None: orig(self, x, k))
    out = harness.run_cell(CELL, 2 ** 31 + 61, 0.3, False, device="cpu",
                           spec=tiny_spec(CELL))
    assert out["failed"] == 0 and out["attempted"] > 0
    if fault:
        assert out["correct"] is False
        assert out["checks"]["bad_ids"]["value"] > 0
    else:
        assert out["correct"] is True, out["checks"]
        assert set(out["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                       "setup_s"}
