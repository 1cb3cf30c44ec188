"""The native host runtime: faiss_tpu_torch.native against faiss_tpu.native.

Both build the same C++ source, so every entry point is held bit for bit,
NaN bits included: f32_to_bf16 and f32_to_f16 on test_native.py's special
floats and NaN payloads of both signs, l2_norms, merge_topk in both
directions (sorted lists with ties and ±0, and a list with (−inf, −1) at
rank 0), fill_sentinels, AlignedBuffer. The numpy versions equal the
library on inputs without NaN.

The store: an 8192×128 bf16 or f16 add batch (2^20 elements, with
subnormals and NaN payloads of both signs) takes the native route in both
packages, so the stored row bits and norms equal faiss_tpu's bit for bit
(bf16 NaN lanes keep their payload, as faiss_tpu stores them at that batch
size); at 4096×128 both convert on their device, the row bits equal and the
norms within 4 ulps (XLA and torch sum in different orders). Searches
over rows holding positive NaNs return faiss_tpu's ids, L2 and IP.

The reference's fault, repaired: faiss_tpu.IndexShardsHost merges with the
two-pointer merge, which a sub-index holding a NaN row breaks (its (∓inf,
−1) at rank 0 is not best-first); the port's stable merge returns the
exact top k of the rows that score. Both outputs are pinned.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import faiss_tpu
from faiss_tpu import native as jnative
from faiss_tpu_torch import (IndexShardsHost, MetricType, TorchIndexFlat,
                             native, storage)

from torch_parity import METRIC_IDS, METRICS, bits_of

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
NAN_BITS = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FC00001,
            0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000, 0xFFA00001, 0x7FA00001,
            0x7F810000, 0xFF810000, 0x7F800100, 0xFFBFFFFF]


def _special_floats():
    """tests/test_native.py's inputs."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(200_000).astype(np.float32) * 1e3
    specials = np.array(
        [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan,
         1e-40, -1e-40, 65504.0, 65520.0, 70000.0, 6.1e-5, 5.9e-8, 2.9e-8,
         1e-45, 3.4e38, -3.4e38],
        np.float32,
    )
    return np.concatenate([vals, specials])


def _with_nans():
    return np.concatenate([_special_floats(),
                           np.array(NAN_BITS, np.uint32).view(np.float32)])


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert native.available(), "g++ present in this image"
    assert jnative.available()
    assert native._load().ft_version() == jnative._load().ft_version() == 1


def _u16(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("fn", ["f32_to_bf16", "f32_to_f16"])
def test_conversion_bits_equal_reference(fn):
    x = _with_nans()
    before = native.calls[fn]
    got = getattr(native, fn)(x)
    want = getattr(jnative, fn)(x)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_u16(got), _u16(want))
    assert native.calls[fn] == before + 1
    if fn == "f32_to_bf16":   # payload kept: 0x7fa00001 -> 0x7fe0
        i = len(x) - len(NAN_BITS) + NAN_BITS.index(0x7FA00001)
        assert got[i] == 0x7FE0
        t = native.bf16_tensor(got)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits_of(t), got)


def test_l2_norms_equal_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 96)).astype(np.float32)
    x[5, 7] = np.nan
    x[9, 0] = np.inf
    got = native.l2_norms(x)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  jnative.l2_norms(x).view(np.uint32))
    ref = (x.astype(np.float64) ** 2).sum(1)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)


def _sorted_lists(largest):
    """Best-first lists with ties inside and across the lists and ±0."""
    rng = np.random.default_rng(2)
    nq, ka, kb = 64, 10, 14
    va = rng.integers(-4, 5, (nq, ka)).astype(np.float32)
    vb = rng.integers(-4, 5, (nq, kb)).astype(np.float32)
    va[va == 0] = -0.0
    va, vb = (-np.sort(-va, 1), -np.sort(-vb, 1)) if largest \
        else (np.sort(va, 1), np.sort(vb, 1))
    ia = rng.integers(0, 1000, (nq, ka)).astype(np.int64)
    ib = rng.integers(1000, 2000, (nq, kb)).astype(np.int64)
    return va, ia, vb, ib


def _unsorted_lists(largest):
    """List b carries (−inf, −1) (largest) or (+inf, −1) at rank 0, then
    its real results: what a sub-index holding a NaN row returns."""
    va, ia, vb, ib = _sorted_lists(largest)
    vb[:, 0] = -np.inf if largest else np.inf
    ib[:, 0] = -1
    return va, ia, vb, ib


@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("case", ["sorted", "unsorted"])
def test_merge_topk_equal_reference(case, largest):
    lists = (_sorted_lists if case == "sorted" else _unsorted_lists)(largest)
    for k in (5, 12, 24):
        vo, io = native.merge_topk(*lists, k, largest=largest)
        wv, wi = jnative.merge_topk(*lists, k, largest=largest)
        np.testing.assert_array_equal(vo.view(np.uint32), wv.view(np.uint32))
        np.testing.assert_array_equal(io, wi)
        sv, si = native.merge_topk_numpy(*lists, k, largest)
        if case == "sorted":   # the stable merge: the same, ±0 included
            np.testing.assert_array_equal(vo.view(np.uint32),
                                          sv.view(np.uint32))
            np.testing.assert_array_equal(io, si)
        else:                  # the two-pointer merge stops at the sentinel
            assert not np.array_equal(io, si)
            assert (si[:, : min(k, 23)] >= 0).all()


def test_numpy_versions_equal_library():
    x = _special_floats()
    x = x[~np.isnan(x)]
    np.testing.assert_array_equal(native.f32_to_bf16_numpy(x),
                                  native.f32_to_bf16(x))
    np.testing.assert_array_equal(_u16(native.f32_to_f16_numpy(x)),
                                  _u16(native.f32_to_f16(x)))
    rows = np.random.default_rng(3).standard_normal((2000, 130)).astype(
        np.float32)
    ulps = np.abs(native.l2_norms_numpy(rows).view(np.int32).astype(np.int64)
                  - native.l2_norms(rows).view(np.int32))
    assert ulps.max() <= 1   # both round a double sum to fp32
    d = np.zeros((4, 9), np.float32)
    lab = np.arange(36, dtype=np.int64).reshape(4, 9)
    d2, lab2 = d.copy(), lab.copy()
    native.fill_sentinels(d, lab, 6, np.inf, -1)
    d2[:, 6:], lab2[:, 6:] = np.inf, -1
    np.testing.assert_array_equal(d, d2)
    np.testing.assert_array_equal(lab, lab2)


def test_aligned_buffer():
    before = native.calls["alloc_aligned"]
    buf = native.AlignedBuffer(1 << 16)
    assert buf._ptr and buf._ptr % 4096 == 0
    assert native.calls["alloc_aligned"] == before + 1
    v = buf.view(np.float32, (128, 128))
    v[:] = 1.5
    assert float(v.sum()) == 128 * 128 * 1.5
    buf.close()
    assert buf._ptr is None


def test_concurrent_build_leaves_a_loadable_library(tmp_path):
    """Two processes building into one fresh directory at once: each
    compiles to its own temporary name and renames it into place."""
    code = ("import sys; from faiss_tpu_torch import native; "
            "print(native.build(sys.argv[1]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    so = tmp_path / native.LIB_NAME
    assert [o.strip() for o, _ in outs] == [str(so)] * 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [native.LIB_NAME]
    assert ctypes.CDLL(str(so)).ft_version() == 1


# ---------------------------------------------------------------------------
# the store's native route against faiss_tpu's
# ---------------------------------------------------------------------------

D = 128


def _rows(n, seed, nan_sign=True):
    """Gaussian rows with subnormals, and NaN payloads of both signs
    (positive only where ``nan_sign`` is False)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    sub = np.array([1, 0x80000001, 0x8000, 0x7FFFFF, 0x807FFFFF, 0x400000],
                   np.uint32).view(np.float32)
    x[np.arange(len(sub)) * 7 + 3, np.arange(len(sub))] = sub
    nans = np.array(NAN_BITS, np.uint32)
    if not nan_sign:
        nans = nans & np.uint32(0x7FFFFFFF)
    x[np.arange(len(nans)) * 97 + 11, (np.arange(len(nans)) * 13) % D] = \
        nans.view(np.float32)
    return x


def _stores(st, n, seed=5, nan_sign=True, metric=METRICS[0]):
    x = _rows(n, seed, nan_sign)
    jidx = faiss_tpu.TpuIndexFlat(D, metric=metric[1], storage=st)
    tidx = TorchIndexFlat(D, metric=metric[0], storage=st, device="cpu")
    jidx.add(x)
    tidx.add(x)
    return x, jidx, tidx


@pytest.mark.parametrize("st", ["bf16", "f16"])
def test_native_route_stores_reference_bits(st):
    native.reset_calls()
    x, jidx, tidx = _stores(st, 8192)
    assert x.size == storage.NATIVE_CONVERT_MIN_ELEMS
    conv = "f32_to_bf16" if st == "bf16" else "f32_to_f16"
    assert native.calls[conv] == 1 and native.calls["l2_norms"] == 1
    rows = bits_of(tidx.store.db[: len(x), :D])
    np.testing.assert_array_equal(
        rows, np.asarray(jidx.store.db)[: len(x), :D].view(np.uint16))
    np.testing.assert_array_equal(
        tidx.store.norms[: len(x)].numpy().view(np.uint32),
        np.asarray(jidx.store.norms)[: len(x)].view(np.uint32))
    # what the route stores: the native conversion of the rows
    want = native.f32_to_bf16(x) if st == "bf16" else _u16(
        native.f32_to_f16(x))
    want = want.copy()
    if st == "f16":   # the ingest flush of subnormal patterns
        sub = ((want & 0x7C00) == 0) & ((want & 0x3FF) != 0)
        want[sub] &= 0x8000
    np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("st", ["bf16", "f16"])
def test_device_route_below_threshold(st):
    native.reset_calls()
    x, jidx, tidx = _stores(st, 4096)
    assert native.calls["l2_norms"] == 0
    np.testing.assert_array_equal(
        bits_of(tidx.store.db[: len(x), :D]),
        np.asarray(jidx.store.db)[: len(x), :D].view(np.uint16))
    got = tidx.store.norms[: len(x)].numpy()
    want = np.asarray(jidx.store.norms)[: len(x)]
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ulps = np.abs(got[fin].view(np.int32).astype(np.int64)
                  - want[fin].view(np.int32))
    assert ulps.max() <= 4   # 128 fp32 adds in another order (3 seen)


@pytest.mark.parametrize("metric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("st", ["bf16", "f16"])
def test_native_route_ids_equal_reference(st, metric):
    """Rows holding positive NaNs (on the card every NaN a product makes is
    the positive one), one 8192-row batch: the ids of faiss_tpu's."""
    _, jidx, tidx = _stores(st, 8192, nan_sign=False, metric=metric)
    xq = np.random.default_rng(6).standard_normal((8, D)).astype(np.float32)
    D_j, I_j = jidx.search(xq, 5)
    D_t, I_t = tidx.search(xq, 5)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# IndexShardsHost over a NaN row: the reference's fault, repaired
# ---------------------------------------------------------------------------

NS, DS, KS = 2000, 32, 5


def _exact_top(rows, norms, xq, k, l2, among=None):
    """The exact top k (fp64) of the rows that score (no NaN), ties to the
    lower id; per query only the ids ``among[q]`` where given."""
    q = xq.astype(np.float64)
    s = q @ rows.astype(np.float64).T
    if l2:
        s = 2.0 * s - norms.astype(np.float64)[None, :]
    s[:, np.isnan(rows).any(1)] = -np.inf
    if among is not None:
        keep = np.zeros_like(s, dtype=bool)
        np.put_along_axis(keep, np.where(among < 0, 0, among), among >= 0, 1)
        s[~keep] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("metric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("st", ["f32", "bf16"])
def test_index_shards_host_nan_row_reference_fault_repaired(st, metric):
    """The NaN row takes one of the second sub-index's k slots, so that
    index returns k − 1 rows that score: the exact top k − 1 of all the
    rows that score are among the lists, and the port returns them, then
    the best of the rest of the lists (the exact top k of what the
    sub-indexes returned). faiss_tpu's two-pointer merge stops at the
    sentinel and never reaches the second list."""
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((NS, DS)).astype(np.float32)
    x2 = rng.standard_normal((NS, DS)).astype(np.float32)
    x2[7, 3] = np.nan
    xq = rng.standard_normal((4, DS)).astype(np.float32)
    jh = faiss_tpu.IndexShardsHost(
        [faiss_tpu.TpuIndexFlat(DS, metric=metric[1], storage=st)
         for _ in range(2)])
    th = IndexShardsHost([TorchIndexFlat(DS, metric=metric[0], storage=st,
                                         device="cpu") for _ in range(2)])
    for h in (jh, th):
        h.add(x1)
        h.add(x2)
    # the second sub-index: (∓inf, −1) at rank 0, then its real results,
    # in both packages alike
    subs = [ix.search(xq, KS)[1] for ix in th.indexes]
    np.testing.assert_array_equal(subs[1], jh.indexes[1].search(xq, KS)[1])
    assert (subs[1][:, 0] == -1).all()
    stored = np.concatenate([ix.reconstruct_n(0, NS) for ix in th.indexes])
    norms = np.concatenate([ix.store.norms[:NS].numpy()
                            for ix in th.indexes])
    l2 = metric[0] is MetricType.L2
    _, I_t = th.search(xq, KS)
    np.testing.assert_array_equal(
        I_t[:, : KS - 1], _exact_top(stored, norms, xq, KS - 1, l2))
    among = np.concatenate([subs[0], np.where(subs[1] < 0, -1,
                                              subs[1] + NS)], 1)
    np.testing.assert_array_equal(
        I_t, _exact_top(stored, norms, xq, KS, l2, among))
    assert (I_t >= NS).any()
    _, I_j = jh.search(xq, KS)
    assert not np.array_equal(I_j, I_t)   # the two-pointer merge's answer
    assert not (I_j >= NS).any()          # never reaches the second list
