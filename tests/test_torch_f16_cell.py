"""The float16 cell's data, its index and its fallback's spans and
counters, on the CPU.

``benchmark/generators/f16_mixture.py`` makes rows that are already
normal float16 values or signed zeros (its flush equals the index's ingest
flush bit for bit) and ``normalised_mixture``'s queries unchanged; an f16
``TorchIndexFlat`` stores those rows bit for bit by either add route (the
device conversion and the native host one); its searches, on the plain
path and on the fused one, pass the benchmark's judge under the
configuration's limits. A certificate failure (every row the same, so
every score ties) records ``flat.tier1_rows``, ``flat.tier2_rows``,
``flat.reduced_pins`` and the spans ``fallback.tier1`` and
``fallback.tier2`` under the profiler, in the flat and the sharded index,
and nothing without it; ``rerun_share``'s reader divides the reruns by
the traced calls' queries.
"""

import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import datagen, harness  # noqa: E402
from faiss_tpu_torch import (ShardedIndexFlat, TorchIndexFlat,  # noqa: E402
                             native, storage, tracing)
from faiss_tpu_torch.ops import fused  # noqa: E402

torch.set_num_threads(2)

CELL = "deep10m-ip-f16.batch"
SEED = 2 ** 31 + 24
CPU = torch.device("cpu")
F16_MIN_NORMAL = 2.0 ** -14


def _config(rows=20_000, queries=200, chunk_rows=8192):
    cfg = harness.cell_spec(CELL)["config"]
    cfg["data"].update(rows=rows, queries=queries, chunk_rows=chunk_rows,
                       centres=64)
    return cfg


def _rows(src):
    return torch.cat([r for _, r in src.chunks()])


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _bits_t(x):
    return x.contiguous().view(torch.int32)


@pytest.fixture
def open_gate(monkeypatch):
    """The fused path from 8192 rows (the cost gate sends a 20,000-row
    search down the plain path)."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)


def test_f16_mixture_rows_are_normal_f16_values():
    cfg = _config()
    rows = _rows(datagen.Source(cfg["data"], SEED, CPU))
    assert rows.dtype == torch.float32
    assert torch.equal(rows.to(torch.float16).to(torch.float32), rows)
    assert not bool(((rows != 0) & (rows.abs() < F16_MIN_NORMAL)).any())
    # the rounding and the flush of normalised_mixture's own rows
    base = _rows(datagen.Source(dict(cfg["data"],
                                     generator="normalised_mixture"),
                                SEED, CPU))
    gen = datagen.load_generator("f16_mixture")
    assert torch.equal(_bits_t(gen.to_f16_values(base)), _bits_t(rows))
    assert not torch.equal(base, rows)


def test_f16_mixture_flush_equals_the_ingest_flush():
    """Values around float16's least normal, ties and signed zeros: the
    generator's rows equal what the index's ingest stores, bit for bit."""
    gen = datagen.load_generator("f16_mixture")
    m = F16_MIN_NORMAL
    edge = torch.tensor([m, -m, m * (1 - 2 ** -12), -m / 2, m / 1024,
                         -m / 2048, m / 4096, 0.0, -0.0, 1.0 + 2 ** -11,
                         1.0 + 3 * 2 ** -11, 65504.0, -1e-30],
                        dtype=torch.float32)
    x = torch.cat([edge, torch.randn(20_000, generator=torch.Generator()
                                     .manual_seed(3)) * 2e-4])
    ingest = storage.decode_f16_bits(
        storage.flush_f16_subnormals(storage.encode_f16_bits(x)))
    got = gen.to_f16_values(x)
    assert torch.equal(_bits_t(got), _bits_t(ingest))
    assert torch.signbit(got[[1, 3, 5, 8, 12]]).all()
    assert got[4] == 0 and got[0] == m and got[9] == 1.0


def test_f16_mixture_queries_are_normalised_mixtures():
    cfg = _config()
    q = datagen.Source(cfg["data"], SEED, CPU).queries()
    base = datagen.Source(dict(cfg["data"], generator="normalised_mixture"),
                          SEED, CPU).queries()
    assert torch.equal(_bits_t(q), _bits_t(base))


@pytest.mark.parametrize("chunk_rows", [4096, 12_000],
                         ids=["device_route", "native_route"])
def test_f16_index_stores_the_rows_bit_for_bit(chunk_rows):
    """An add batch of 12,000 × 96 (≥ 2^20 elements) converts on the host
    through the native runtime where it builds, a smaller one on the
    device; both store the generator's rows as they are."""
    cfg = _config(rows=24_000, chunk_rows=chunk_rows)
    src = datagen.Source(cfg["data"], SEED, CPU)
    native0 = native.calls["f32_to_f16"]
    idx = harness.build_index(cfg, src, [CPU])
    rows = _rows(src).numpy()
    assert idx.is_float16_storage() and idx.ntotal == rows.shape[0]
    np.testing.assert_array_equal(_bits(idx.reconstruct_n(0, idx.ntotal)),
                                  _bits(rows))
    np.testing.assert_allclose(idx.store.norms[:idx.ntotal].numpy(),
                               (rows.astype(np.float64) ** 2).sum(1),
                               rtol=1e-6)
    native_route = chunk_rows * 96 >= storage.NATIVE_CONVERT_MIN_ELEMS
    assert (native.calls["f32_to_f16"] > native0) == (
        native_route and native.available())


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_f16_index_passes_the_judge(open_gate, monkeypatch, route):
    """Batches of 100 pool queries, as the cell's traffic sends them,
    judged by the benchmark's own comparison under the configuration's
    limits; the fused route runs the f16 sweep."""
    cfg = _config()
    src = datagen.Source(cfg["data"], SEED, CPU)
    idx = harness.build_index(cfg, src, [CPU])
    idx.set_force_plain(route == "plain")
    sweeps = []
    orig = fused.sweep_f16

    def record(q_hi, q_lo, db, vn, **kw):
        sweeps.append(q_lo is None)
        return orig(q_hi, q_lo, db, vn, **kw)

    monkeypatch.setattr(fused, "sweep_f16", record)
    pool = src.queries()
    tr = dict(harness.cell_spec(CELL)["traffic"])
    D, I = zip(*[idx.search(pool[i:i + 100].numpy(), tr["k"])
                 for i in range(0, len(pool), 100)])
    idx_q = np.arange(len(pool))
    nums = harness.judge(idx_q, np.full(len(pool), -1), np.concatenate(D),
                         np.concatenate(I), pool, src, [], cfg, tr)
    checks, correct = harness.verdict(nums, 0, cfg["limits"])
    assert correct, checks
    assert nums["answers"] == len(pool)
    assert (len(sweeps) > 0) == (route == "fused")


def _duplicates(kind):
    """An f16 index of 9,000 copies of one row a shard: every score ties,
    so no certificate holds on either sweep."""
    row = np.random.default_rng(14).standard_normal(96).astype(np.float32)
    if kind == "flat":
        idx = TorchIndexFlat(96, metric="IP", storage="f16", device="cpu")
    else:
        idx = ShardedIndexFlat(96, metric="IP", storage="f16",
                               devices=["cpu"] * 2)
    idx.add(np.tile(row, (9000 * (1 if kind == "flat" else 2), 1)))
    return idx


@pytest.mark.parametrize("kind", ["flat", "sharded"])
def test_a_forced_fallback_records_its_tiers(open_gate, kind):
    idx = _duplicates(kind)
    xq = np.random.default_rng(15).standard_normal((100, 96)).astype(
        np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        tok = idx.search_async(xq, 10)
        D1, I1 = tok.wait()
    # (a stretch may hold an earlier test's records: this call's only)
    recs = [c for c in tracing.counts() if c.call == tok._call]
    # the one-plane sweep failed every query: all re-ran on two planes
    # (which fail too), then on the plain path; the shape was pinned once
    assert [(c.name, c.value) for c in recs] == [
        ("flat.tier1_rows", 100), ("flat.reduced_pins", 1),
        ("flat.tier2_rows", 100)]
    names = {}
    for r in tracing.spans():
        if r.call == tok._call:
            names.setdefault(r.name, []).append(r)
    for tier in ("fallback.tier1", "fallback.tier2"):
        (r,) = names[tier]
        assert (r.parent, r.call) == ("token.fallback", tok._call)
    (fb,) = names["token.fallback"]
    assert fb.t0_ns <= names["fallback.tier1"][0].t0_ns
    assert names["fallback.tier2"][0].t1_ns <= fb.t1_ns
    assert idx._no_reduced_sweep == {104} and idx.fused_fallbacks == 1
    np.testing.assert_array_equal(I1, np.tile(np.arange(10), (100, 1)))
    # pinned: the next call sweeps two planes, so only the plain path
    # re-runs, and nothing is pinned again
    with profile(activities=[ProfilerActivity.CPU]):
        tok = idx.search_async(xq, 10)
        D2, I2 = tok.wait()
    assert [(c.name, c.value) for c in tracing.counts()
            if c.call == tok._call] == [("flat.tier2_rows", 100)]
    assert [r.name for r in tracing.spans() if r.call == tok._call
            and r.name.startswith("fallback.")] == ["fallback.tier2"]
    np.testing.assert_array_equal(I2, I1)
    np.testing.assert_array_equal(D2, D1)


def test_a_fallback_without_the_profiler_records_nothing(open_gate,
                                                         monkeypatch):
    monkeypatch.setattr(tracing, "_counts", deque(maxlen=8))
    monkeypatch.setattr(tracing, "_records", deque(maxlen=8))
    idx = _duplicates("flat")
    xq = np.random.default_rng(16).standard_normal((40, 96)).astype(
        np.float32)
    idx.search(xq, 10)
    assert idx.fused_fallbacks == 1 and idx._no_reduced_sweep == {40}
    assert not tracing._counts and not tracing._records


def _run(nq=100):
    return harness.Run(
        cell={}, config={}, traffic={"nq": nq, "k": 10}, setup_s=1.0,
        window_s=1.0, nq=np.full(5, nq), t_enqueue=np.zeros(5),
        latency=np.zeros(5), traced=np.ones(5, bool), fallbacks=0,
        trace=None)


def test_rerun_share_reads_the_reruns_over_the_traced_queries(monkeypatch):
    reader = harness.reader("rerun_share.f16")
    spans = [tracing.Record("token.wait", 0, 1, c, None) for c in range(4)]
    spans.append(tracing.Record("token.copy", 0, 1, 0, "token.wait"))
    counts = [tracing.Count("flat.tier1_rows", 30, 0),
              tracing.Count("flat.reduced_pins", 1, 0),
              tracing.Count("flat.tier2_rows", 10, 0),
              tracing.Count("flat.tier2_rows", 2, 3),
              tracing.Count("ivf.live_chunks", 999, 1)]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    monkeypatch.setattr(tracing, "counts", lambda: counts)
    assert reader(_run()) == pytest.approx(100.0 * 42 / 400)
    monkeypatch.setattr(tracing, "counts", lambda: [])
    assert reader(_run()) == 0.0
    # no traced wait, or a program that counts no reruns: nothing to read
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert reader(_run()) is None
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    monkeypatch.setattr(tracing, "HOST_COUNTERS", ())
    assert reader(_run()) is None
