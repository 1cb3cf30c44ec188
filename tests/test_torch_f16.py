"""faiss_tpu_torch's f16 storage against faiss_tpu's, on the CPU.

The f16 bit-pattern contract on all 65,536 patterns (RNE encode, the
ingest subnormal flush, the exact decode with every e=31 pattern → ±inf,
the exact (hi, lo) split); the split statistics and ``f16_clean``; the
plain versions of the f16 sweeps (K6 ``_kernel_f16_pair``, K7
``_kernel_f16_1``) and of K10's int16 mode against those Pallas kernels in
interpret mode; the pair certificate's soundness on f16 rows; and
TorchIndexFlat(storage="f16") against TpuIndexFlat(storage="f16"): the
one-plane sweep at nq=32, the tier-1 rerun and the shape pinning, and
files saved by the JAX package.

Tolerances: encode, flush, decode and split equal bit for bit; split
statistics within 1 ulp (the two packages sum the squares in different
orders); norms rtol 1e-6 (idem); group maxes within the pair ε
(``_sweep_eps(pair_sweep=True)`` with the f16 split statistics,
``single_pass`` for K7); rescores within the rescore term
(``rescore_term``: each side fp32-true, ≤ d·u·Q·V); index ids and
certificate outcomes equal, ids equal to the fp64 oracle over the stored
f16 values, distances within ε plus the norm difference where the two
packages computed the norms themselves. Ids equal rank for rank, except
that two rows scoring within ε of each other may swap
(``assert_ids_match``): the seed-80 database holds one such pair, 4.3e-6
apart at a distance of 178.9 (below fp32 resolution there), which the
port's fp32 rescore and the JAX package's 3-way split order differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faiss_tpu import TpuIndexFlat
from faiss_tpu import io as jio
from faiss_tpu import storage as jstorage
from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu_torch import KernelTuning, TorchIndexFlat, load_index
from faiss_tpu_torch import storage
from faiss_tpu_torch.ops import fused, kernels
from faiss_tpu_torch.storage import ROW_TILE, _round_up

from common import make_data
from test_torch_cuda import (CERT_CASES_F16, all_f16_patterns,
                             check_sweep_eps_sound_f16, f16_db, rescore_term)
from torch_parity import (METRIC_IDS, METRICS, assert_ids_match,
                          assert_within_eps, bits_of)

torch.set_num_threads(2)

NV, D, NQ = 16384, 128, 16
NTOTAL = NV - 37   # the last rows are padding: masked to −inf
NV_IDX = 20000     # index tests


@pytest.fixture
def open_gate(monkeypatch):
    """Fused path from 8192 rows in both packages."""
    gate = lambda **kw: kw["nv_eff"] >= 8192  # noqa: E731
    monkeypatch.setattr(pf, "fused_path_eligible", gate)
    monkeypatch.setattr(fused, "fused_path_eligible", gate)


def _i16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _f32_bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


# -- the bit-pattern contract ------------------------------------------------


@pytest.fixture(scope="module")
def patterns():
    pats = all_f16_patterns(torch.device("cpu"))
    return pats, jnp.asarray(_i16(pats))


def test_decode_and_split_every_pattern(patterns):
    """decode (e=31, NaN included, → ±inf) and split_f16_bits (lo = 0
    where the value is not finite) on all 65,536 patterns."""
    pats, pats_j = patterns
    dec = storage.decode_f16_bits(pats)
    assert not dec.isnan().any() and int(dec.isinf().sum()) == 2 * 1024
    np.testing.assert_array_equal(
        _f32_bits(dec.numpy()), _f32_bits(jstorage.decode_f16_bits(pats_j)))
    fin = np.isfinite(pats.numpy())
    np.testing.assert_array_equal(dec.numpy()[fin],
                                  pats.numpy()[fin].astype(np.float32))
    hi, lo = storage.split_f16_bits(pats)
    hi_j, lo_j = jstorage.split_f16_bits(pats_j)
    np.testing.assert_array_equal(bits_of(hi), np.asarray(hi_j).view(np.uint16))
    np.testing.assert_array_equal(bits_of(lo), np.asarray(lo_j).view(np.uint16))
    exact = hi.float() + lo.float()
    np.testing.assert_array_equal(exact.numpy()[fin], dec.numpy()[fin])


def test_ingest_flush_every_pattern(patterns):
    """The subnormal flush, as the JAX store applies it to raw rows (and
    the port's store to the same rows): subnormals → ±0, everything else
    kept, NaN patterns included."""
    pats, _ = patterns
    rows = pats.view(512, 128)
    jidx = TpuIndexFlat(128, storage="f16")
    jio._add_raw(jidx, _i16(rows).view(np.float16),
                 np.zeros((512,), np.float32))
    want = np.asarray(jidx.store.db)[:512]
    got = storage.flush_f16_subnormals(rows)
    np.testing.assert_array_equal(_i16(got), want)
    h = _i16(pats).astype(np.int32) & 0xFFFF
    sub = ((h & 0x7C00) == 0) & ((h & 0x3FF) != 0)
    assert sub.sum() == 2 * 1023
    np.testing.assert_array_equal(_i16(got).ravel()[sub] & 0x7FFF, 0)
    np.testing.assert_array_equal(_i16(got).ravel()[~sub], _i16(pats)[~sub])
    idx = TorchIndexFlat(128, storage="f16", device="cpu")
    idx.store.add_raw(rows, torch.zeros((512,)))
    np.testing.assert_array_equal(_i16(idx.store.db[:512]), want)
    assert not idx.store.f16_clean() and not jidx.store.f16_clean()


def test_encode_matches_jax(patterns):
    """RNE fp32 → f16: every f16 value, the midpoints between neighbours
    (ties to even), overflow to ±inf, underflow to subnormals and ±0, and
    NaN (any NaN pattern)."""
    pats, _ = patterns
    vals = pats.numpy().astype(np.float32)
    fin = vals[np.isfinite(vals)]
    srt = np.unique(fin)
    mids = ((srt[:-1].astype(np.float64) + srt[1:]) / 2).astype(np.float32)
    rng = np.random.default_rng(0)
    extra = np.array([65504.0, 65519.99, 65520.0, 1e6, -1e6, 3e-8, -3e-8,
                      2.0 ** -25, 2.0 ** -26, np.inf, -np.inf, np.nan,
                      0.0, -0.0], np.float32)
    x = np.concatenate([fin, mids, extra,
                        rng.standard_normal(5000).astype(np.float32) * 300])
    got = _i16(storage.encode_f16_bits(torch.from_numpy(x)))
    want = np.asarray(jstorage.encode_f16_bits(jnp.asarray(x)))
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert ((got[nan] & 0x7C00) == 0x7C00).all() and (got[nan] & 0x3FF).all()


@pytest.mark.parametrize("kind", ["gauss", "dirty"])
def test_split_stats_and_clean_match_jax(kind):
    """Two add batches: the same bits, norms, split statistics (running
    max) and f16_clean; 'dirty' data overflows f16 in one element."""
    rng = np.random.default_rng(11)
    xb = (rng.standard_normal((3000, 72)) * 40).astype(np.float32)
    if kind == "dirty":
        xb[1500, 3] = 1e6                   # → +inf in f16
    jidx = TpuIndexFlat(72, storage="f16")
    idx = TorchIndexFlat(72, storage="f16", device="cpu")
    for part in (xb[:1100], xb[1100:]):
        jidx.add(part)
        idx.add(part)
    st, jst = idx.store, jidx.store
    assert st.db.dtype == torch.float16 and st.d_pad == 72
    np.testing.assert_array_equal(_i16(st.db[:3000, :72]),
                                  np.asarray(jst.db)[:3000, :72])
    np.testing.assert_allclose(st.norms[:3000].numpy(),
                               np.asarray(jst.norms)[:3000], rtol=1e-6)
    clean = kind == "gauss"
    assert st.f16_clean() is jst.f16_clean() is clean
    assert f"f16_clean={clean}" in idx.describe()
    if clean:
        np.testing.assert_array_max_ulp(st.split_stats.numpy(),
                                        np.asarray(jst.split_stats), maxulp=1)
        assert min(st.split_stats_host()) >= 0
    else:                                   # inf − inf in the split: NaN
        assert np.isnan(st.split_stats.numpy()).all()
        assert np.isnan(np.asarray(jst.split_stats)).all()
    np.testing.assert_array_equal(idx.reconstruct_n(0, 3000),
                                  jidx.reconstruct_n(0, 3000))
    assert st.nbytes() == st.capacity * (2 * st.d_pad + 4)  # 2 B/element
    idx.reset()
    assert not idx.store.f16_clean()
    assert idx.store.split_stats_host() == (float("inf"),) * 2


# -- kernels' plain versions against the Pallas kernels ----------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4323)
    xb = (rng.standard_normal((NV, D)) * 3).astype(np.float32)
    xb[NTOTAL:] = 0.0
    xq = rng.standard_normal((NQ, D), dtype=np.float32)
    bits, norms, stats = f16_db(torch.device("cpu"), xb)
    return dict(q_t=torch.from_numpy(xq), q_j=jnp.asarray(xq),
                b_t=bits, b_j=jnp.asarray(_i16(bits)), n_t=norms,
                n_j=jnp.asarray(norms.numpy()), stats_t=stats)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("passes", [1, 2])
def test_sweep_f16_plain_matches_pallas(data, metric, jmetric, passes):
    """passes 2: K6 _kernel_f16_pair (qh·dh + qh·dl + ql·dh over the decoded
    pair); passes 1: K7 _kernel_f16_1 (q1·dh + q1·dl)."""
    gm_j = pf.groupmax_scores(
        data["q_j"], data["b_j"], data["n_j"], jnp.int32(NTOTAL), None,
        metric=jmetric, nv_eff=NV, interpret=True, sweep_passes=passes)
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    before = dict(kernels.launches)
    gm = fused.groupmax_scores(data["q_t"], data["b_t"], vn, metric=metric,
                               sweep_passes=passes)
    assert kernels.launches == before      # CPU tensors: the plain version
    assert gm.shape == (NQ, NV // 128)
    assert np.isneginf(gm[:, -1].numpy()).sum() == 0  # partly valid group
    eps = fused._sweep_eps(data["q_t"], data["n_t"], NV, metric=metric,
                           d_pad=D, single_pass=passes == 1, pair_sweep=True,
                           split_stats=data["stats_t"]).numpy()
    assert_within_eps(gm.numpy(), np.asarray(gm_j), eps, "group max")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_rescore_f16_plain_matches_pallas(data, metric, jmetric):
    rng = np.random.default_rng(26)
    gidx = np.sort(np.stack([rng.choice(NV // 128, 14, replace=False)
                             for _ in range(NQ)]), axis=1).astype(np.int32)
    gidx[0, -1] = NV // 128 - 1             # the partly padded last group
    s_j = pf.rescore_groups_pallas(
        data["q_j"], data["b_j"], data["n_j"], jnp.asarray(gidx),
        jnp.int32(NTOTAL), metric=jmetric, nv_eff=NV, interpret=True,
        ranks_per_step=pf.RESCORE_RANKS)
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    s = kernels.rescore_groups(data["q_t"], data["b_t"], vn,
                               torch.from_numpy(gidx), metric=metric)
    assert np.isneginf(s[0, -37:].numpy()).all()
    v_max = torch.sqrt(torch.amax(data["n_t"])) * fused._QUANT_V
    assert_within_eps(s.numpy(), np.asarray(s_j),
                      rescore_term(data["q_t"], v_max, data["n_t"], NV, D,
                                   metric).numpy(), "f16 rescore")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("single_pass", [False, True])
def test_pair_eps_with_f16_stats_matches_jax(data, metric, jmetric,
                                             single_pass):
    v32 = jstorage.decode_f16_bits(data["b_j"])
    stats_j = jstorage._split_stats_fn(jnp.zeros((2,), jnp.float32), v32,
                                       *jstorage.split_f32_bf16(v32))
    got = fused._sweep_eps(data["q_t"], data["n_t"], NV, metric=metric,
                           d_pad=D, single_pass=single_pass, pair_sweep=True,
                           split_stats=data["stats_t"])
    want = pf._sweep_eps(data["q_j"], data["n_j"], NV, metric=jmetric,
                         pair_sweep=True, d_pad=D, single_pass=single_pass,
                         split_stats=stats_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(data["stats_t"][1]) == 0.0    # s1 = 0: hi + lo == value


@pytest.mark.parametrize("case", range(len(CERT_CASES_F16)))
def test_sweep_eps_sound_f16(case):
    check_sweep_eps_sound_f16(torch.device("cpu"), case)


# -- the index ------------------------------------------------------------


@pytest.fixture(scope="module")
def gauss():
    return make_data(NV_IDX, 32, D, seed=80)


def _eps(idx, xq, metric, single_pass):
    q, _, _ = idx._prep_queries(xq)
    st = idx.store
    return fused._sweep_eps(
        q, st.norms, _round_up(idx.ntotal, ROW_TILE), metric=metric,
        d_pad=st.d_pad, single_pass=single_pass, pair_sweep=True,
        split_stats=st.split_stats)[: len(xq)].numpy()


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_index_matches_jax(open_gate, gauss, tmp_path, monkeypatch, metric,
                           jmetric):
    """Built independently and from the JAX package's saved file (bits and
    norms bit for bit): the same ids, certificates and fallbacks as
    TpuIndexFlat(storage="f16"), two query planes at nq=16 and one at
    nq=32, and the ids of the fp64 oracle over the stored f16 values."""
    xb, xq = gauss
    jidx = TpuIndexFlat(D, metric=jmetric, storage="f16")
    jidx.add(xb)
    path = str(tmp_path / "flat_f16.npz")
    jio.save_index(jidx, path)
    loaded = load_index(path, device="cpu")
    built = TorchIndexFlat(D, metric=metric, storage="f16", device="cpu")
    built.add(xb)
    st, jst = loaded.store, jidx.store
    np.testing.assert_array_equal(_i16(st.db[:NV_IDX]),
                                  np.asarray(jst.db)[:NV_IDX])
    np.testing.assert_array_equal(st.norms[:NV_IDX].numpy(),
                                  np.asarray(jst.norms)[:NV_IDX])
    assert loaded.store.f16_clean() and jst.f16_clean()
    n_diff = np.abs(built.store.norms[:NV_IDX].numpy()
                    - np.asarray(jst.norms)[:NV_IDX]).max()
    calls = []
    sweep = fused.sweep_f16

    def record(q_hi, q_lo, db, vn, **kw):
        calls.append(q_lo is None)
        return sweep(q_hi, q_lo, db, vn, **kw)

    monkeypatch.setattr(fused, "sweep_f16", record)
    stored = st.db[:NV_IDX, :D].to(torch.float32).numpy()
    for nq, one_plane in ((16, False), (32, True)):
        # the certificates of one fused search in each package
        out = jidx._run_search_fn(jidx._prep_queries(xq[:nq])[0], 10,
                                  max(nq, 8), force_plain=False)
        assert out[3] and out[4] is one_plane
        for idx in (loaded, built):
            q, _, nq_pad = idx._prep_queries(xq[:nq])
            packed, _, reduced = idx._run_search_fn(q, 10, nq_pad,
                                                    force_plain=False)
            assert reduced is one_plane and calls == [one_plane]
            calls.clear()
            np.testing.assert_array_equal(packed[:, 20].numpy() != 0,
                                          np.asarray(out[2]))
        # the searches, fallbacks and pinning included
        D_j, I_j = jidx.search(xq[:nq], 10)
        for idx, slack in ((loaded, 0.0), (built, n_diff)):
            D_t, I_t = idx.search(xq[:nq], 10)
            assert calls[0] is one_plane
            calls.clear()
            eps = _eps(idx, xq[:nq], metric, one_plane) + slack
            assert_ids_match(I_t, I_j, D_j, eps, "ids")
            assert_within_eps(D_t, D_j, eps, "distances")
            assert idx.fused_fallbacks == jidx.fused_fallbacks
            assert idx._no_reduced_sweep == jidx._no_reduced_sweep
        sc = xq[:nq].astype(np.float64) @ stored.astype(np.float64).T
        if metric.value == "l2":      # the stored (pre-quantization) norms
            sc = 2 * sc - st.norms[:NV_IDX].double().numpy()[None, :]
        np.testing.assert_array_equal(
            I_j, np.argsort(-sc, axis=1, kind="stable")[:, :10])


def test_duplicates_fall_back_and_pin_like_jax(open_gate, monkeypatch):
    """Every score ties, so no certificate holds. nq=32 starts on the
    one-plane sweep (K7): tier 1 (K6) fails too, the plain path answers,
    and the shape is pinned to two planes in both packages."""
    rng = np.random.default_rng(14)
    row = rng.standard_normal(D).astype(np.float32)
    xb = np.tile(row, (9000, 1))
    xq = rng.standard_normal((32, D)).astype(np.float32)
    jidx = TpuIndexFlat(D, storage="f16")
    jidx.add(xb)
    idx = TorchIndexFlat(D, storage="f16", device="cpu")
    idx.add(xb)
    calls = []
    sweep = fused.sweep_f16

    def record(q_hi, q_lo, db, vn, **kw):
        calls.append(q_lo is None)
        return sweep(q_hi, q_lo, db, vn, **kw)

    monkeypatch.setattr(fused, "sweep_f16", record)
    _, I_j = jidx.search(xq, 10)
    _, I_t = idx.search(xq, 10)
    assert calls == [True, False]           # K7, then the tier-1 K6
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_array_equal(I_t, np.tile(np.arange(10), (32, 1)))
    assert idx.fused_fallbacks == jidx.fused_fallbacks == 1
    assert idx._no_reduced_sweep == jidx._no_reduced_sweep == {32}
    idx.search(xq, 10)
    assert calls[2:] == [False]             # pinned: two planes from now on


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_plain_path_matches_jax(gauss, metric, jmetric):
    """set_force_plain against set_force_xla (f16_scores; chunked: three
    chunks and a tail)."""
    xb, xq = gauss
    jidx = TpuIndexFlat(D, metric=jmetric, storage="f16")
    jidx.add(xb)
    jidx.set_force_xla(True)
    idx = TorchIndexFlat(D, metric=metric, storage="f16", device="cpu",
                         tuning=KernelTuning(chunk_v=6144))
    idx.add(xb)
    idx.set_force_plain(True)
    D_j, I_j = jidx.search(xq, 10)
    D_t, I_t = idx.search(xq, 10)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-5, atol=1e-3)
