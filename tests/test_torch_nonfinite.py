"""Non-finite inputs: faiss_tpu_torch against faiss_tpu, on the CPU.

Fault 1, NaN in bf16 storage. ``storage.f32_to_bf16`` is the port's one
fp32 → bf16 conversion: bit for bit ``jnp.astype(jnp.bfloat16)`` (round to
nearest even; every NaN, whatever its payload, to sign | 0x7fc0), where
``Tensor.to`` turns every NaN into 0xffff. Held here: its bits on NaN
payloads of both signs, ±inf, ±0, subnormals, the halfway cases and random
normals; the stored bits of both f32 splits, of bf16 rows, of the f32
pair-only planes and of the IVF bf16 pool; and the ids of searches over
rows holding a NaN (bf16 flat, f32 ``keep_master=False``, IVF16 bf16 on
its dense and gather routes), under IP and L2, fused and plain, equal to
faiss_tpu's. The NaNs of the searches are positive (numpy's nan and a
signalling payload): on the card every NaN a product makes is the
canonical positive one, so a positive NaN ranks alike on both devices.

Fault 2 of the reference, repaired in the port: a query with a ±inf
component under IP on bf16, f16 and int8 storage. faiss_tpu splits the
query into bf16 planes, inf − inf puts a NaN in the lo plane, and every
result is −1 / −inf; the port scores the fp32 query and returns the rows
that score +inf, lowest id first, which is what both packages return on
f32 storage. Both outputs are pinned.

Subnormal remainders: the port's f32 splits keep the subnormal
remainders that XLA flushes (the lo planes differ in bits), yet flat f32,
f32 ``keep_master=False`` and IVF f32 return faiss_tpu's ids on data made
of subnormals and of normals whose remainder is subnormal.

Sizes stay below faiss_tpu's native host conversion (``NATIVE_CONVERT_MIN
_ELEMS`` elements a batch), so JAX converts with ``astype`` as held here.
The batches at or above it, where both packages convert on the host, are
held in tests/test_torch_native.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import faiss_tpu
from faiss_tpu import TpuIndexFlat, TpuIndexIVFFlat
from faiss_tpu import storage as jstorage
from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu_torch import TorchIndexFlat, load_index, storage
from faiss_tpu_torch.dtypes import MetricType
from faiss_tpu_torch.ops import fused

from torch_parity import METRIC_IDS, METRICS, bits_of

torch.set_num_threads(2)

NV, D, NQ, K = 12000, 64, 8, 5
NLIST, NV_IVF = 16, 3000
NAN_AT = ([5, 300, 2000, 2999], [1, 7, 63, 0])   # (row, column) of the NaNs
SNAN = np.uint32(0x7F800001).view(np.float32)       # a signalling payload

_NAN = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FC00001,
        0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000, 0x7F810000, 0xFF810000,
        0x7F800100, 0xFFBFFFFF]
PATTERNS = {
    "nan": _NAN,
    "inf_zero_one": [0x7F800000, 0xFF800000, 0, 0x80000000, 0x3F800000,
                     0xBF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000],
    "subnormal": [1, 0x80000001, 0x8000, 0x18000, 0x7FFFFF, 0x807FFFFF,
                  0x400000, 0x7F8000, 0x7F7FFF, 0x80008000],
    # bits 15..0 exactly 0x8000 (a tie: to even) and around it
    "halfway": [0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001, 0xBF808000,
                0xBF818000, 0x00008000, 0x7F7F8000, 0x4B7F8000],
}


@pytest.fixture
def open_gate(monkeypatch):
    """Fused path from 8192 rows in both packages."""
    gate = lambda **kw: kw["nv_eff"] >= 8192  # noqa: E731
    monkeypatch.setattr(pf, "fused_path_eligible", gate)
    monkeypatch.setattr(fused, "fused_path_eligible", gate)


def _patterns(name):
    if name == "random":
        rng = np.random.default_rng(0)
        return rng.standard_normal(4096).astype(np.float32) * np.float32(
            2.0) ** rng.integers(-60, 60, 4096).astype(np.float32)
    return np.array(PATTERNS[name], np.uint32).view(np.float32)


def _jax_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("name", [*PATTERNS, "random"])
def test_f32_to_bf16_matches_jnp_astype(name):
    x = _patterns(name)
    want = _jax_bits(jnp.asarray(x).astype(jnp.bfloat16))
    got = storage.f32_to_bf16(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits_of(got), want)
    # 2-D and not contiguous: the same bits
    x2 = np.stack([x, x[::-1]], axis=1)
    got2 = storage.f32_to_bf16(torch.from_numpy(x2).t())
    np.testing.assert_array_equal(bits_of(got2), np.stack([want, want[::-1]]))


def _all_patterns(subnormal=True) -> np.ndarray:
    names = [n for n in [*PATTERNS, "random"] if subnormal or n != "subnormal"]
    return np.concatenate([_patterns(n) for n in names])


@pytest.mark.parametrize("split", ["split_f32_bf16", "split3_f32_bf16"])
def test_split_bits_match_jax(split):
    """Both splits against faiss_tpu's, NaN included. Subnormal inputs are
    left out: their remainder is subnormal, which XLA on the CPU flushes to
    +0 and the port keeps (ROADMAP §3, denormals)."""
    x = _all_patterns(subnormal=False)
    want = getattr(jstorage, split)(jnp.asarray(x))
    got = getattr(storage, split)(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits_of(g), _jax_bits(w))


def _rows_with_patterns(n, d, seed, subnormal=True):
    """Gaussian rows with every tested pattern written into them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    p = _all_patterns(subnormal)[: n * d]
    x.reshape(-1)[: p.size] = p
    return x


def _ivf_pair(xb_train, storage_type, metric=None, tmp_path=None):
    """(JAX IVF16, the port's copy through its saved file), both trained
    by JAX on clean rows."""
    jm = METRICS[0][1] if metric is None else metric
    jidx = TpuIndexIVFFlat(D, NLIST, metric=jm, storage=storage_type,
                           nprobe=NLIST, seed=3)
    jidx.train(xb_train)
    path = str(tmp_path / "ivf.npz")
    faiss_tpu.save_index(jidx, path)
    return jidx, load_index(path, device="cpu")


@pytest.mark.parametrize("store", ["bf16", "pair", "ivf_bf16"])
def test_stored_bits_match_jax(store, tmp_path):
    """bf16 rows, the f32 pair-only planes and the IVF bf16 pool store
    every tested pattern as faiss_tpu does, bit for bit (the planes all but
    the subnormals, as the splits)."""
    if store == "ivf_bf16":
        rng = np.random.default_rng(1)
        jidx, tidx = _ivf_pair(rng.standard_normal((NV_IVF, D)).astype(
            np.float32), "bf16", tmp_path=tmp_path)
        x = _rows_with_patterns(NV_IVF, D, 2)
        jidx.add(x)
        tidx.add(x)
        rows, _ = tidx._rows_by_id()
        jrows, _ = jidx._rows_by_id()
        np.testing.assert_array_equal(bits_of(rows[:, :D]),
                                      np.asarray(jrows)[:, :D])
        return
    x = _rows_with_patterns(2048, D, 2, subnormal=store != "pair")
    kw = {"keep_master": False} if store == "pair" else {}
    st = "f32" if store == "pair" else "bf16"
    jidx = TpuIndexFlat(D, storage=st, **kw)
    tidx = TorchIndexFlat(D, storage=st, device="cpu", **kw)
    jidx.add(x)
    tidx.add(x)
    planes = ("db_hi", "db_lo") if store == "pair" else ("db",)
    for name in planes:
        got = getattr(tidx.store, name)[: len(x), :D]
        want = np.asarray(getattr(jidx.store, name))[: len(x), :D]
        np.testing.assert_array_equal(bits_of(got), want.view(np.uint16),
                                      err_msg=name)


def _nan_rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    x[NAN_AT] = [np.nan, SNAN, np.nan, SNAN]
    return x


@pytest.fixture(scope="module")
def queries():
    return np.random.default_rng(4).standard_normal((NQ, D)).astype(
        np.float32)


@pytest.mark.parametrize("plain", [False, True], ids=["fused", "plain"])
@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("store", ["bf16", "pair"])
def test_nan_rows_flat_ids_match_jax(open_gate, queries, store, metric,
                                     jmetric, plain):
    """Rows holding a NaN: ids and distances equal to faiss_tpu's on the
    fused and the plain path (each NaN row takes label −1; under IP it
    ranks first)."""
    x = _nan_rows(NV, 3)
    kw = {"keep_master": False} if store == "pair" else {}
    st = "f32" if store == "pair" else "bf16"
    jidx = TpuIndexFlat(D, metric=jmetric, storage=st, **kw)
    tidx = TorchIndexFlat(D, metric=metric, storage=st, device="cpu", **kw)
    jidx.add(x)
    tidx.add(x)
    jidx.set_force_xla(plain)
    tidx.set_force_plain(plain)
    D_j, I_j = jidx.search(queries, K)
    D_t, I_t = tidx.search(queries, K)
    np.testing.assert_array_equal(I_t, I_j)
    assert (I_t == -1).any()
    if metric is MetricType.INNER_PRODUCT:
        assert (I_t[:, 0] == -1).all()
    np.testing.assert_allclose(D_t, D_j, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("nprobe", [4, NLIST], ids=["gather", "dense"])
@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_nan_rows_ivf_bf16_ids_match_jax(queries, metric, jmetric, nprobe,
                                         tmp_path):
    """IVF16 bf16 with NaN rows (routed to the same list by both
    packages' first argmax): ids equal to faiss_tpu's at nprobe 4 (the
    fine scan on K10's bf16 rows) and 16 (the dense route)."""
    rng = np.random.default_rng(5)
    jidx, tidx = _ivf_pair(rng.standard_normal((NV_IVF, D)).astype(
        np.float32), "bf16", jmetric, tmp_path)
    x = _nan_rows(NV_IVF, 6)
    jidx.add(x)
    tidx.add(x)
    np.testing.assert_array_equal(tidx._assignments(), jidx._assignments())
    jidx.nprobe = tidx.nprobe = nprobe
    D_j, I_j = jidx.search(queries, K)
    D_t, I_t = tidx.search(queries, K)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=5e-2, atol=5e-2)


# -- subnormal remainders: the splits keep what XLA flushes ------------------


def _subnormal_rows(n, seed, scale_exp):
    """Gaussian rows times 2^scale_exp, a quarter of their components
    replaced by normal values in [2^-126, 2^-111) (whose bf16 remainder
    x − hi is subnormal) and a tenth by subnormals of either sign."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, D)) * 2.0 ** scale_exp).astype(np.float32)
    pick = rng.random((n, D))
    mag = 2.0 ** rng.uniform(-126, -111, (n, D))
    small = (mag * np.sign(rng.standard_normal((n, D)))).astype(np.float32)
    sub = (rng.integers(1, 1 << 23, (n, D)).astype(np.uint32)
           | (rng.integers(0, 2, (n, D)).astype(np.uint32) << 31)
           ).view(np.float32)
    return np.where(pick < 0.25, small,
                    np.where(pick > 0.9, sub, x)).astype(np.float32)


# (row scale, query scale) as powers of two: Gaussian data with the planted
# components, and rows made of such components (most remainders subnormal)
# against large queries, where a remainder moves an IP score by up to 2^-8
# of it
SUBNORMAL_REGIMES = {"gauss": (0, 0), "tiny": (-118, 60)}
NV_SUB = 2048   # flat rows; the fused path from 1024 rows here


@pytest.fixture(scope="module")
def subnormal_indexes(tmp_path_factory):
    """build(regime, store, jmetric, metric) → (JAX index, the port's,
    queries), each built once for the module (both routes search the
    same pair)."""
    built = {}

    def build(regime, store, jmetric, metric):
        key = (regime, store, metric)
        if key in built:
            return built[key]
        rexp, qexp = SUBNORMAL_REGIMES[regime]
        x = _subnormal_rows(NV_IVF if store == "ivf_f32" else NV_SUB, 11,
                            rexp)
        xq = _subnormal_rows(NQ, 12, qexp)
        want_lo = _jax_bits(jstorage.split_f32_bf16(jnp.asarray(x))[1])
        got_lo = bits_of(storage.split_f32_bf16(torch.from_numpy(x))[1])
        assert (want_lo != got_lo).any()
        if store == "ivf_f32":
            # the rows cross in JAX's file, so both hold JAX's routing (its
            # coarse GEMM flushes subnormal inputs: a row may take another
            # list in the port's own add)
            jidx = TpuIndexIVFFlat(D, NLIST, metric=jmetric, nprobe=NLIST,
                                   seed=3)
            jidx.train(x)
            jidx.add(x)
            path = str(tmp_path_factory.mktemp("sub") / "ivf.npz")
            faiss_tpu.save_index(jidx, path)
            tidx = load_index(path, device="cpu")
        else:
            kw = {"keep_master": False} if store == "pair" else {}
            jidx = TpuIndexFlat(D, metric=jmetric, **kw)
            tidx = TorchIndexFlat(D, metric=metric, device="cpu", **kw)
            jidx.add(x)
            tidx.add(x)
        built[key] = (jidx, tidx, xq)
        return built[key]

    return build


@pytest.mark.parametrize("route", ["fused", "plain"])
@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("store", ["f32", "pair", "ivf_f32"])
@pytest.mark.parametrize("regime", list(SUBNORMAL_REGIMES))
def test_subnormal_remainders_ids_match_jax(monkeypatch, subnormal_indexes,
                                            regime, store, metric, jmetric,
                                            route):
    """Rows and queries holding subnormal components and normal components
    whose bf16 remainder is subnormal: the port's splits keep those
    remainders where XLA flushes them to +0 (the stored lo planes differ in
    bits, asserted here), yet the ids of flat f32, f32 keep_master=False
    and IVF16 f32 (fused and plain; IVF: its K10 fine scan at nprobe 4,
    ``fused``, and its dense sweep, ``plain``, with JAX's routing) equal
    faiss_tpu's, under L2 and IP, distances within tests/common.py's
    ladder. ε does not depend on the flush: s0 and s1 are the exact
    statistics of what each package stores."""
    gate = lambda **kw: kw["nv_eff"] >= 1024  # noqa: E731
    monkeypatch.setattr(pf, "fused_path_eligible", gate)
    monkeypatch.setattr(fused, "fused_path_eligible", gate)
    jidx, tidx, xq = subnormal_indexes(regime, store, jmetric, metric)
    if store == "ivf_f32":
        jidx.nprobe = tidx.nprobe = 4 if route == "fused" else NLIST
    else:
        jidx.set_force_xla(route == "plain")
        tidx.set_force_plain(route == "plain")
    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = tidx.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    # tests/common.py's ladder (XLA also flushes the subnormal inputs of
    # its plain products, which the port's keep)
    np.testing.assert_allclose(D_t, D_j, atol=0,
                               rtol=1e-3 if metric is MetricType.L2 else 1e-2)


# -- fault 2 of the reference: a ±inf query component under IP --------------


@pytest.fixture(scope="module")
def inf_case():
    """Rows, queries 0 and 1 with a +inf and a −inf component, and the
    answer both packages give on f32 storage (equal to each other)."""
    rng = np.random.default_rng(8)
    xb = rng.standard_normal((NV, D)).astype(np.float32)
    xq = rng.standard_normal((NQ, D)).astype(np.float32)
    xq[0, 3], xq[1, 5] = np.inf, -np.inf
    ip = METRICS[1]
    jidx = TpuIndexFlat(D, metric=ip[1], storage="f32")
    tidx = TorchIndexFlat(D, metric=ip[0], storage="f32", device="cpu")
    jidx.add(xb)
    tidx.add(xb)
    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = tidx.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_array_equal(D_t, D_j)
    # the rows that score +inf, lowest id first
    for qi, col, sign in ((0, 3, 1), (1, 5, -1)):
        want = np.flatnonzero(sign * xb[:, col] > 0)[:K]
        np.testing.assert_array_equal(I_t[qi], want)
        assert np.isposinf(D_t[qi]).all()
    return xb, xq, D_t, I_t


@pytest.mark.parametrize("plain", [False, True], ids=["fused", "plain"])
@pytest.mark.parametrize("st", ["bf16", "f16", "int8"])
def test_inf_query_ip_reference_fault_repaired(open_gate, inf_case, st,
                                               plain):
    """faiss_tpu returns −1 / −inf for the ±inf queries on bf16, f16 and
    int8 storage; the port returns the rows that score +inf, as on f32
    storage. The finite queries agree."""
    xb, xq, D_f32, I_f32 = inf_case
    ip = METRICS[1]
    jidx = TpuIndexFlat(D, metric=ip[1], storage=st)
    tidx = TorchIndexFlat(D, metric=ip[0], storage=st, device="cpu")
    jidx.add(xb)
    tidx.add(xb)
    jidx.set_force_xla(plain)
    tidx.set_force_plain(plain)
    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = tidx.search(xq, K)
    assert (I_j[:2] == -1).all() and np.isneginf(D_j[:2]).all()
    np.testing.assert_array_equal(I_t[:2], I_f32[:2])
    np.testing.assert_array_equal(D_t[:2], D_f32[:2])
    np.testing.assert_array_equal(I_t[2:], I_j[2:])
