"""The profiling harness and the package surface, against faiss_tpu.

``DEFAULT_GRID`` is faiss_tpu's, dict for dict; ``_oracle_recall`` gives
faiss_tpu's recall on the same inputs; ``bench_grid`` draws faiss_tpu's
data (default_rng(42), in its order), so a small grid over CPU indexes
gives faiss_tpu's recall config for config. ``measure_search`` returns two
positive finite times; ``trace`` writes a Chrome trace on the CPU. Every
name faiss_tpu exports has its counterpart in faiss_tpu_torch.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import faiss_tpu
from faiss_tpu.utils import profiling as jprof
from faiss_tpu_torch import TorchIndexFlat
import faiss_tpu_torch
from faiss_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_default_grid_equals_reference():
    assert profiling.DEFAULT_GRID == jprof.DEFAULT_GRID
    assert len(profiling.DEFAULT_GRID) == 14
    assert max(c["k"] for c in profiling.DEFAULT_GRID) == 2048
    assert max(c["d"] for c in profiling.DEFAULT_GRID) == 1536


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_oracle_recall_equals_reference(metric):
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((1500, 24)).astype(np.float32)
    xq = rng.standard_normal((12, 24)).astype(np.float32)
    I = rng.integers(0, 1500, (12, 10))
    s = xq.astype(np.float64) @ xb.astype(np.float64).T
    if metric == "l2":
        s = 2 * s - (xb.astype(np.float64) ** 2).sum(1)
    I[:6] = np.argsort(-s[:6], 1)[:, :10]   # half the queries right
    for sample in (None, 4):
        for k in (10, 5):
            got = profiling._oracle_recall(xb, xq, k, metric, I, sample)
            assert got == jprof._oracle_recall(xb, xq, k, metric, I, sample)
    assert profiling._oracle_recall(xb, xq, 10, metric, I) == 0.5 + sum(
        len(set(I[i]) & set(np.argsort(-s[i])[:10])) for i in range(6, 12)
    ) / 120


GRID = [dict(name="tiny-bf16", nv=3000, nq=10, d=32, k=10, storage="bf16"),
        dict(name="tiny-int.ip", nv=2000, nq=8, d=16, k=5, storage="f32",
             metric="ip", data="int")]


def test_bench_grid_equals_reference_recall(monkeypatch, capsys):
    # faiss_tpu's timing (a 96-thread pool over 192 searches, three
    # times) is not what is compared; its recall is
    monkeypatch.setattr(jprof, "measure_search", lambda *a, **k: (1.0, 1.0))
    want = jprof.bench_grid(
        lambda d, m, s: faiss_tpu.TpuIndexFlat(d, metric=m, storage=s),
        GRID, verbose=False)
    got = profiling.bench_grid(
        lambda d, m, s: TorchIndexFlat(d, metric=m, storage=s, device="cpu"),
        GRID)
    lines = capsys.readouterr().out.splitlines()
    assert lines == [r.line() for r in got]
    for g, w in zip(got, want):
        assert (g.name, g.nv, g.nq, g.d, g.k, g.storage) == \
            (w.name, w.nv, w.nq, w.d, w.k, w.storage)
        assert g.recall_at_k == w.recall_at_k
        assert g.qps == pytest.approx(g.nq / (g.pipelined_ms / 1e3))
    assert got[1].recall_at_k == 1.0   # f32 on integer rows: exact
    # the data: faiss_tpu's draws in its order
    rng = np.random.default_rng(42)
    xb, xq = profiling.grid_data(rng, GRID[0])
    ref = np.random.default_rng(42)
    np.testing.assert_array_equal(
        xb, ref.standard_normal((3000, 32), dtype=np.float32))
    np.testing.assert_array_equal(
        xq, ref.standard_normal((10, 32), dtype=np.float32))


def test_measure_search_times():
    rng = np.random.default_rng(1)
    idx = TorchIndexFlat(16, device="cpu")
    idx.add(rng.standard_normal((500, 16)).astype(np.float32))
    xq = rng.standard_normal((4, 16)).astype(np.float32)
    lat, pipe = profiling.measure_search(idx, xq, 5, iters=3, warmup=1,
                                         depth=4)
    for t in (lat, pipe):
        assert isinstance(t, float) and math.isfinite(t) and t > 0


def test_trace_writes_a_file(tmp_path):
    idx = TorchIndexFlat(16, device="cpu")
    idx.add(np.ones((64, 16), np.float32))
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof:
        idx.search(np.ones((2, 16), np.float32), 3)
    assert os.path.dirname(prof.trace_file) == logdir
    with open(prof.trace_file) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_describe_capabilities():
    text = faiss_tpu_torch.describe_capabilities("cpu")
    assert text == faiss_tpu_torch.query_device_capabilities(
        "cpu").describe()
    assert faiss_tpu_torch.describe_capabilities(device="cpu") == text
    caps = faiss_tpu_torch.query_device_capabilities("cpu")
    assert faiss_tpu_torch.describe_capabilities(caps) == text
    assert "device              : cpu" in text


# faiss_tpu's names without a counterpart: none (TpuResources is
# TorchResources, its program cache the CUDA graphs of the searches)
LEFT_BEHIND = set()
RENAMED = {"TpuDeviceCapabilities": "DeviceCapabilities"}


def _port_name(name):
    return RENAMED.get(name, name.replace("Tpu", "Torch").replace(
        "tpu", "torch"))


def test_every_reference_name_has_its_counterpart():
    missing = [n for n in faiss_tpu.__all__ if n not in LEFT_BEHIND
               and _port_name(n) not in faiss_tpu_torch.__all__]
    assert not missing, missing
    for n in faiss_tpu.__all__:
        if n not in LEFT_BEHIND:
            assert hasattr(faiss_tpu_torch, _port_name(n)), n
    assert faiss_tpu_torch.__version__ == faiss_tpu.__version__
    for mod in ("loader", "native", "utils"):
        assert getattr(faiss_tpu_torch, mod).__name__ == \
            f"faiss_tpu_torch.{mod}"
    assert faiss_tpu_torch.utils.bench_grid is profiling.bench_grid
