"""The readers of the program's spans (``copy_wait_ms``, ``replay_ms``,
``upload_ms``) on a stretch recorded under the CPU's profiler: each the
mean of its span, nothing without a device trace, nothing from a program
without spans."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import devtrace, harness

READERS = [("copy_wait_ms", "token.copy"), ("replay_ms", "programs.replay"),
           ("upload_ms", "index.prep_queries")]


@pytest.fixture(scope="module")
def recorded():
    """A stretch of five searches recorded under the profiler: the
    spans' means by name."""
    from faiss_tpu_torch import TorchIndexFlat, TorchResources, tracing

    rng = np.random.default_rng(0)
    idx = TorchIndexFlat(16, device="cpu", resources=TorchResources(["cpu"]))
    idx.add(rng.standard_normal((2000, 16), dtype=np.float32))
    xq = rng.standard_normal((3, 16), dtype=np.float32)
    idx.search(xq, 5)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            idx.search(xq, 5)
    ms = {}
    for r in tracing.spans():
        ms.setdefault(r.name, []).append(r.ms)
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _run(device):
    trace = devtrace.Trace(0.0, 10.0, device=device)
    return SimpleNamespace(trace=trace)


@pytest.mark.parametrize("metric,span", READERS)
def test_bench_span_reader_reads_the_mean(recorded, metric, span):
    read = harness.reader(f"{metric}.single")
    got = read(_run([("kernel", 1.0, 2.0)]))
    assert got == pytest.approx(recorded[span]) and got > 0


@pytest.mark.parametrize("metric,span", READERS)
def test_bench_span_reader_without_a_device_trace(recorded, metric, span):
    read = harness.reader(metric)
    assert read(SimpleNamespace(trace=None)) is None
    assert read(_run([])) is None


@pytest.mark.parametrize("metric,span", READERS)
def test_bench_span_reader_on_a_program_without_spans(recorded, monkeypatch,
                                                      metric, span):
    import faiss_tpu_torch

    # the parent's program: no faiss_tpu_torch.tracing to import
    monkeypatch.delattr(faiss_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "faiss_tpu_torch.tracing", None)
    assert harness.reader(metric)(_run([("kernel", 1.0, 2.0)])) is None


def test_bench_span_reader_without_its_span(monkeypatch):
    from faiss_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", lambda: [])
    for metric, _ in READERS:
        assert harness.reader(metric)(_run([("kernel", 1.0, 2.0)])) is None
