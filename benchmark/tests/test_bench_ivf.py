"""The IVF cell on the CPU at a small size: its index type trains on the
first add and hands its centroids to the judge, the harness runs both new
cells sound and judges a planted fault not correct, the readers of the
fine scan's counters read a synthetic run and nothing from a program
without counters, ``roofline_ivf``'s count matches one by hand, and the
cell's generator (``spectral_mixture``) draws the noise it states."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import datagen, devtrace, harness, roofline_ivf

CELL = "deep10m-ivf8192.batch"
CPU = torch.device("cpu")


def _ivf_spec(tiny_spec):
    spec = tiny_spec(CELL)
    spec["config"]["index"].update(nlist=64, nprobe=8)
    return spec


def test_bench_ivf_trains_on_its_first_add(tiny_spec):
    cfg = _ivf_spec(tiny_spec)["config"]
    ixt = harness.index_type(cfg)
    src = datagen.Source(cfg["data"], 2 ** 31 + 1, CPU)
    index = ixt.build(cfg, [CPU])
    assert not index.index.is_trained and ixt.CENTROIDS not in cfg
    chunks = list(src.chunks())
    index.add(chunks[0][1].numpy())
    ix = index.index
    assert ix.is_trained and ix.ntotal == len(chunks[0][1])
    cents = cfg[ixt.CENTROIDS]
    assert cents.shape == (64, cfg["data"]["d"])
    np.testing.assert_array_equal(cents, ix._centroids)
    for _, rows in chunks[1:]:
        index.add(rows.numpy())
    assert cfg[ixt.CENTROIDS] is cents        # trained once
    assert ix.ntotal == cfg["data"]["rows"] and ixt.fallbacks(index) == 0


@pytest.mark.parametrize("name", [CELL, "deep1m-l2.gt100"])
def test_bench_new_cells_run_sound(tiny_spec, name):
    spec = _ivf_spec(tiny_spec) if name == CELL else tiny_spec(name)
    out = harness.run_cell(name, 2 ** 31 + 77, 0.3, False, device="cpu",
                           spec=spec)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"qps.1m", "setup_s"}


def test_bench_ivf_traced_run_reads_its_counters(tiny_spec):
    spec = _ivf_spec(tiny_spec)
    spec["traffic"]["depth"] = 2
    out = harness.run_cell(CELL, 2 ** 31 + 78, 2.0, True, device="cpu",
                           spec=spec)
    assert out["correct"] is True
    # the CPU has no device trace: the counter's share alone, and the
    # host clock's enqueue
    assert set(out["metrics"]) == {"budget_live_share.ivf", "enqueue_ms.ivf"}
    assert 0 < out["metrics"]["budget_live_share.ivf"]["value"] <= 100


def test_bench_ivf_fault_is_not_correct(tiny_spec, monkeypatch):
    from faiss_tpu_torch import TorchIndexIVFFlat

    orig = TorchIndexIVFFlat.search_async

    class Token:
        def __init__(self, result):
            self.result = result

        def wait(self):
            return self.result

    def search_async(self, x, k, params=None):
        d, i = orig(self, x, k, params=params).wait()
        i = i.copy()
        i[0, 0] = (i[0, 0] + 1) % self.ntotal
        return Token((d, i))

    monkeypatch.setattr(TorchIndexIVFFlat, "search_async", search_async)
    out = harness.run_cell(CELL, 2 ** 31 + 79, 0.2, False, device="cpu",
                           spec=_ivf_spec(tiny_spec))
    assert out["correct"] is False


def _counts(calls):
    from faiss_tpu_torch.tracing import Count

    return [Count(name, v, c) for c, vals in enumerate(calls)
            for name, v in zip(("ivf.live_chunks", "ivf.budget_chunks",
                                "ivf.chunks_read"), vals)]


def _run(device, nq=100, d=96):
    return SimpleNamespace(trace=devtrace.Trace(0.0, 1e4, device=device),
                           config={"data": {"d": d}}, traffic={"nq": nq})


KERNELS = [("void (anonymous namespace)::f32_count(int const*)", 0.0, 10.0),
           ("void (anonymous namespace)::f32_runs(F32Work)", 10.0, 15.0),
           ("void (anonymous namespace)::f32_order(int const*)", 15.0, 20.0),
           ("void (anonymous namespace)::rescore_f32_kernel<true>(float)",
            20.0, 520.0),
           ("sweep_split_mma_kernel", 600.0, 900.0)]


def test_bench_ivf_readers_read_a_synthetic_run(monkeypatch):
    from faiss_tpu_torch import tracing

    calls = [(500, 1000, 3000), (700, 1000, 3400)]
    monkeypatch.setattr(tracing, "counts", lambda: _counts(calls))
    live = harness.reader("budget_live_share.ivf")(_run(KERNELS))
    assert live == pytest.approx(100.0 * 1200 / 2000)
    # two calls counted, two launches traced, 1,040 µs of K10
    least = [roofline_ivf.scan_bound_s(chunks_read=r, budget_chunks=b,
                                       live_chunks=lv, nq=100, d=96)[0]
             for lv, b, r in calls]
    share = harness.reader("fine_scan_roofline.ivf")(_run(KERNELS * 2))
    assert share == pytest.approx(100.0 * sum(least) / 2 * 2 / 1040e-6)


def test_bench_ivf_readers_without_counters(monkeypatch):
    import faiss_tpu_torch
    from faiss_tpu_torch import tracing

    run = _run(KERNELS)
    for metric in ("budget_live_share.ivf", "fine_scan_roofline.ivf"):
        monkeypatch.setattr(tracing, "counts", lambda: [])
        assert harness.reader(metric)(run) is None
        # the parent's program: spans, no counters
        monkeypatch.delattr(tracing, "counts")
        assert harness.reader(metric)(run) is None
        monkeypatch.undo()
    # no device trace, or no K10 launch in it: no roofline
    monkeypatch.setattr(tracing, "counts", lambda: _counts([(1, 2, 3)]))
    read = harness.reader("fine_scan_roofline.ivf")
    assert read(SimpleNamespace(trace=None)) is None
    assert read(_run(KERNELS[-1:])) is None
    # a checkout without the program's tracing
    monkeypatch.delattr(faiss_tpu_torch, "tracing")
    monkeypatch.setitem(__import__("sys").modules, "faiss_tpu_torch.tracing",
                        None)
    assert harness.reader("budget_live_share.ivf")(run) is None


def test_bench_ivf_roofline_counts_by_hand():
    # 1,000 chunks of 128 rows × 96 fp32 and their norms; 104 × 1,024 group
    # ids and 128 scores each; 104 queries of 96 fp32
    nbytes = roofline_ivf.scan_bytes(chunks_read=1000,
                                     budget_chunks=104 * 1024, nq=100, d=96)
    assert nbytes == (1000 * 128 * 96 * 4 + 1000 * 128 * 4
                      + 104 * 1024 * 4 + 104 * 1024 * 128 * 4
                      + 104 * 96 * 4)
    assert roofline_ivf.scan_ops(live_chunks=500, d=96) == 2.0 * 500 * 128 * 96
    t, by = roofline_ivf.scan_bound_s(chunks_read=1000,
                                      budget_chunks=104 * 1024,
                                      live_chunks=500, nq=100, d=96)
    assert by == "bytes" and t == nbytes / 3.35e12
    # d pads to 8, queries to 8
    assert roofline_ivf.scan_bytes(chunks_read=1, budget_chunks=8, nq=1,
                                   d=90) == (128 * 96 * 4 + 128 * 4 + 8 * 4
                                             + 8 * 128 * 4 + 8 * 96 * 4)


def test_bench_spectral_mixture_is_the_isotropic_one_at_decay_0():
    base = dict(rows=3000, d=96, queries=10, chunk_rows=1000, centres=16,
                centre_scale=1.0, noise_scale=0.6, normalise=True)
    iso = datagen.Source(dict(base, generator="normalised_mixture"), 5, CPU)
    spec = datagen.Source(dict(base, generator="spectral_mixture",
                               decay=0.0), 5, CPU)
    assert torch.equal(iso.chunk(1)[1], spec.chunk(1)[1])
    assert torch.equal(iso.queries(), spec.queries())


def test_bench_spectral_mixture_noise_falls_as_its_decay():
    data = dict(generator="spectral_mixture", rows=200_000, d=96, queries=10,
                chunk_rows=200_000, centres=1, centre_scale=0.0,
                noise_scale=1.0, decay=1.0, normalise=False)
    x = datagen.Source(data, 2 ** 31 + 3, CPU).chunk(0)[1]
    sd = x.std(dim=0)
    assert float(sd.pow(2).mean()) == pytest.approx(1.0, rel=0.02)
    for i in (2, 10, 50):           # axis i + 1 against axis 1
        assert float(sd[i] / sd[0]) == pytest.approx(1.0 / (i + 1), rel=0.05)
    data["normalise"] = True
    rows = datagen.Source(data, 2 ** 31 + 3, CPU).chunk(0)[1]
    assert torch.allclose(torch.linalg.vector_norm(rows, dim=1),
                          torch.ones(len(rows)), atol=1e-6)
