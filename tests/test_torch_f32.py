"""faiss_tpu_torch's f32 storage against faiss_tpu's, on the CPU.

The planes, split statistics and certificate bounds against the JAX
package's; the plain versions of the pair sweep (K3 ``_kernel_split``, K4
``_kernel_split2``) and of the pair rescore (K10's ``db2`` mode) against
those Pallas kernels in interpret mode; the certificate bounds' soundness
on adversarial data; and TorchIndexFlat(storage="f32") against
TpuIndexFlat(storage="f32"), with the master and pair-only (keep_master=
False), on Gaussian and integer-valued (hi_exact) data.

Tolerances: planes equal bit for bit, split statistics within 1 ulp (the
two packages sum the squares in different orders, exactly 0 on integer
data), bounds rtol 1e-6; sweep group maxes within the pair sweep's ε
(``_sweep_eps(pair_sweep=True)``), pair rescores within ε₂
(``_pair_rescore_eps``); index ids and certificate outcomes equal,
distances within ε plus the norm difference where the two packages
computed the norms themselves.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import faiss_tpu
from faiss_tpu import TpuIndexFlat
from faiss_tpu import io as jio
from faiss_tpu import storage as jstorage
from faiss_tpu.ops import pallas_fused as pf
import faiss_tpu_torch
from faiss_tpu_torch import TorchIndexFlat, load_index
from faiss_tpu_torch import storage
from faiss_tpu_torch.dtypes import StorageType
from faiss_tpu_torch.ops import fused, kernels
from faiss_tpu_torch.storage import ROW_TILE, _round_up

from common import make_data, numpy_search
from test_torch_cuda import (CERT_CASES_F32, T2_CASES, check_pair_eps_sound,
                             check_sweep_eps_sound)
from torch_parity import METRIC_IDS, METRICS, assert_within_eps, bits_of

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


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4321)
    xb = rng.standard_normal((NV, D), dtype=np.float32)
    xb[NTOTAL:] = 0.0                        # padding rows are zero
    xq = rng.standard_normal((NQ, D), dtype=np.float32)
    db_t = torch.from_numpy(xb)
    hi_t, lo_t = storage.split_f32_bf16(db_t)
    db_j = jnp.asarray(xb)
    hi_j, lo_j = jstorage.split_f32_bf16(db_j)
    return dict(q_t=torch.from_numpy(xq), q_j=jnp.asarray(xq),
                db_t=db_t, hi_t=hi_t, lo_t=lo_t,
                n_t=(db_t * db_t).sum(-1),
                stats_t=storage.split_stats(db_t, hi_t, lo_t),
                db_j=db_j, hi_j=hi_j, lo_j=lo_j,
                n_j=jnp.sum(db_j * db_j, axis=-1),
                stats_j=jstorage._split_stats_fn(
                    jnp.zeros((2,), jnp.float32), db_j, hi_j, lo_j))


def _sweep_eps(data, metric, single_pass):
    return fused._sweep_eps(
        data["q_t"], data["n_t"], NV, metric=metric, d_pad=D,
        single_pass=single_pass, pair_sweep=True,
        split_stats=data["stats_t"]).numpy()


# -- storage --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gauss", "int"])
def test_splits_and_stats_match_jax(kind):
    """Two add batches (growth, running max): the same planes bit for bit,
    the same norms and split statistics."""
    rng = np.random.default_rng(8)
    if kind == "gauss":
        xb = rng.standard_normal((3000, 72)).astype(np.float32) * 50
    else:
        xb = rng.integers(0, 256, (3000, 72)).astype(np.float32)
    jidx = TpuIndexFlat(72, storage="f32")
    idx = TorchIndexFlat(72, device="cpu")
    for part in (xb[:1100], xb[1100:]):
        jidx.add(part)
        idx.add(part)
    st, jst = idx.store, jidx.store
    assert st.capacity == 4096 and st.db.dtype == torch.float32
    np.testing.assert_array_equal(st.db[:3000, :72].numpy(), xb)
    for mine, theirs in ((st.db_hi, jst.db_hi), (st.db_lo, jst.db_lo)):
        np.testing.assert_array_equal(
            bits_of(mine[:3000, :72]),
            np.asarray(theirs)[:3000, :72].view(np.uint16))
    np.testing.assert_allclose(st.norms[:3000].numpy(),
                               np.asarray(jst.norms)[:3000], rtol=1e-6)
    np.testing.assert_array_max_ulp(st.split_stats.numpy(),
                                    np.asarray(jst.split_stats), maxulp=1)
    assert st.split_stats_host() == tuple(st.split_stats.tolist())
    if kind == "int":
        assert st.split_stats_host() == jst.split_stats_host() == (0.0, 0.0)
    else:
        assert min(st.split_stats_host()) > 0
    idx.reset()
    assert idx.store.split_stats_host() == (float("inf"),) * 2
    assert idx.store.nbytes() == 0


def test_default_storage_is_jax_default():
    """TorchIndexFlat(d) and index_numpy_to_torch store what
    TpuIndexFlat(d) and index_numpy_to_tpu store: f32, with the master."""
    pairs = ((TorchIndexFlat.__init__, TpuIndexFlat.__init__),
             (faiss_tpu_torch.index_numpy_to_torch,
              faiss_tpu.index_numpy_to_tpu))
    for mine, theirs in pairs:
        got = inspect.signature(mine).parameters["storage"].default
        want = inspect.signature(theirs).parameters["storage"].default
        assert StorageType.coerce(got).value == want.value == "float32"
    keep = [inspect.signature(f).parameters["keep_master"].default
            for f in pairs[0]]
    assert keep == [True, True]
    assert TorchIndexFlat(8, device="cpu").storage_type is StorageType.FLOAT32


@pytest.mark.parametrize("keep_master", [True, False])
def test_reconstruct_is_exact(keep_master):
    xb = make_data(2500, 1, 40, seed=9)[0] * np.float32(1e3)
    idx = TorchIndexFlat(40, device="cpu", keep_master=keep_master)
    idx.add(xb[:1000])
    idx.add(xb[1000:])
    assert idx.store.pair_only is not keep_master
    assert (idx.store.db is None) is not keep_master
    np.testing.assert_array_equal(idx.reconstruct_n(0, 2500), xb)
    np.testing.assert_array_equal(idx.reconstruct(1777), xb[1777])
    per_row = (8 if keep_master else 4) * idx.store.d_pad + 4
    assert idx.store.nbytes() == idx.store.capacity * per_row


# -- kernels' plain versions against the Pallas kernels ----------------------


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("passes", [1, 2])
def test_sweep_split_plain_matches_pallas(data, metric, jmetric, passes):
    """passes 2: K3 _kernel_split (qh·dh + qh·dl + ql·dh); passes 1: K4
    _kernel_split2 (q1·dh + q1·dl)."""
    gm_j = pf.groupmax_scores(
        data["q_j"], data["db_j"], data["n_j"], jnp.int32(NTOTAL),
        (data["hi_j"], data["lo_j"]), metric=jmetric, nv_eff=NV,
        interpret=True, sweep_passes=passes)
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    before = dict(kernels.launches)
    gm = fused.groupmax_scores(data["q_t"], data["db_t"], vn, metric=metric,
                               sweep_passes=passes,
                               db_split=(data["hi_t"], data["lo_t"]))
    assert kernels.launches == before      # CPU tensors: the plain version
    assert gm.shape == (NQ, NV // 128)
    assert np.isneginf(gm[:, -1].numpy()).sum() == 0  # partly valid group
    assert_within_eps(gm.numpy(), np.asarray(gm_j),
                      _sweep_eps(data, metric, passes == 1), "group max")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_pair_rescore_plain_matches_pallas(data, metric, jmetric):
    """The pair rescore against the JAX kernel in interpret mode within ε₂,
    on two id sets: each query its own random groups, and one set that
    every query names (the same group read for every query)."""
    rng = np.random.default_rng(24)
    own = np.sort(np.stack([rng.choice(NV // 128, 14, replace=False)
                            for _ in range(NQ)]), axis=1).astype(np.int32)
    shared = np.tile(np.sort(rng.choice(NV // 128 - 1, 14, replace=False)),
                     (NQ, 1)).astype(np.int32)
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    eps2 = fused._pair_rescore_eps(data["q_t"], data["n_t"], NV,
                                   metric=metric, d_pad=D,
                                   split_stats=data["stats_t"]).numpy()
    for gidx in (own, shared):
        gidx[0, -1] = NV // 128 - 1         # the partly padded last group
        s_j = pf.rescore_groups_pallas(
            data["q_j"], data["hi_j"], data["n_j"], jnp.asarray(gidx),
            jnp.int32(NTOTAL), metric=jmetric, nv_eff=NV, interpret=True,
            ranks_per_step=pf.RESCORE_RANKS_PAIR, db2=data["lo_j"])
        s = kernels.rescore_groups(data["q_t"], data["hi_t"], vn,
                                   torch.from_numpy(gidx), metric=metric,
                                   db2=data["lo_t"])
        assert np.isneginf(s[0, -37:].numpy()).all()
        assert_within_eps(s.numpy(), np.asarray(s_j), eps2, "pair rescore")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("single_pass", [False, True])
def test_pair_eps_match_jax(data, metric, jmetric, single_pass):
    """_sweep_eps(pair_sweep=True) with the exact statistics and with the
    envelopes, and _pair_rescore_eps, against the JAX package's."""
    for stats_t, stats_j in ((data["stats_t"], data["stats_j"]),
                             (None, None)):
        got = fused._sweep_eps(data["q_t"], data["n_t"], NV, metric=metric,
                               d_pad=D, single_pass=single_pass,
                               pair_sweep=True, split_stats=stats_t)
        want = pf._sweep_eps(data["q_j"], data["n_j"], NV, metric=jmetric,
                             pair_sweep=True, d_pad=D,
                             single_pass=single_pass, split_stats=stats_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        got = fused._pair_rescore_eps(data["q_t"], data["n_t"], NV,
                                      metric=metric, d_pad=D,
                                      split_stats=stats_t)
        want = pf._pair_rescore_eps(data["q_j"], data["n_j"], NV,
                                    metric=jmetric, d_pad=D,
                                    split_stats=stats_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- soundness of both bounds on the plain versions -------------------------


@pytest.mark.parametrize("case", range(len(CERT_CASES_F32)))
def test_sweep_eps_sound(case):
    check_sweep_eps_sound(torch.device("cpu"), case)


@pytest.mark.parametrize("case", range(len(T2_CASES)))
def test_pair_rescore_eps_sound(case):
    check_pair_eps_sound(torch.device("cpu"), case)


# -- the index ------------------------------------------------------------


def _eps(idx, xq, metric):
    q, _, _ = idx._prep_queries(xq)
    st = idx.store
    return fused._sweep_eps(
        q, st.norms, _round_up(idx.ntotal, ROW_TILE), metric=metric,
        d_pad=st.d_pad, pair_sweep=True,
        split_stats=st.split_stats)[: len(xq)].numpy()


@pytest.fixture(scope="module")
def gauss():
    return make_data(NV_IDX, NQ, D, seed=78)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("k", [10, 24])
def test_index_matches_jax(open_gate, gauss, tmp_path, metric, jmetric, k):
    """Built from the JAX package's saved file (rows and norms bit for bit)
    and independently: the same ids as TpuIndexFlat(storage="f32")."""
    xb, xq = gauss
    jidx = TpuIndexFlat(D, metric=jmetric, storage="f32")
    jidx.add(xb)
    path = str(tmp_path / "flat_f32.npz")
    jio.save_index(jidx, path)
    loaded = load_index(path, device="cpu")
    st, jst = loaded.store, jidx.store
    np.testing.assert_array_equal(st.db[:NV_IDX].numpy(), xb)
    np.testing.assert_array_equal(st.norms[:NV_IDX].numpy(),
                                  np.asarray(jst.norms)[:NV_IDX])
    np.testing.assert_array_equal(bits_of(st.db_lo[:NV_IDX]),
                                  np.asarray(jst.db_lo)[:NV_IDX].view(np.uint16))
    built = TorchIndexFlat(D, metric=metric, device="cpu")
    built.add(xb)
    n_diff = np.abs(built.store.norms[:NV_IDX].numpy()
                    - np.asarray(jst.norms)[:NV_IDX]).max()

    D_j, I_j = jidx.search(xq, k)
    for idx, slack in ((loaded, 0.0), (built, n_diff)):
        D_t, I_t = idx.search(xq, k)
        np.testing.assert_array_equal(I_t, I_j)
        assert idx.fused_fallbacks == jidx.fused_fallbacks == 0
        assert_within_eps(D_t, D_j, _eps(idx, xq, metric) + slack,
                          "distances")
    _, I_ref = numpy_search(xb, xq, k, metric.value)
    np.testing.assert_array_equal(I_j, I_ref)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_integer_data_takes_hi_exact_like_jax(open_gate, monkeypatch, metric,
                                              jmetric):
    """SIFT-like data: both packages take hi_exact, sweeping the hi plane
    with the bf16 kernels: two query planes at nq=16, one at nq=32."""
    rng = np.random.default_rng(31)
    xb = rng.integers(0, 256, (NV_IDX, D)).astype(np.float32)
    xq = rng.integers(0, 256, (32, D)).astype(np.float32)
    jidx = TpuIndexFlat(D, metric=jmetric, storage="f32")
    jidx.add(xb)
    idx = TorchIndexFlat(D, metric=metric, device="cpu")
    idx.add(xb)
    assert "hi_exact=True" in jidx.describe()
    assert "hi_exact=True" in idx.describe()
    calls = []
    sweep = fused.sweep_groupmax

    def record(q_hi, q_lo, db, vn, **kw):
        calls.append((q_lo is None, db is idx.store.db_hi))
        return sweep(q_hi, q_lo, db, vn, **kw)

    monkeypatch.setattr(fused, "sweep_groupmax", record)
    monkeypatch.setattr(fused, "sweep_split", None)   # never the pair sweep
    for nq, one_plane in ((16, False), (32, True)):
        D_j, I_j = jidx.search(xq[:nq], 10)
        D_t, I_t = idx.search(xq[:nq], 10)
        assert calls.pop() == (one_plane, True)
        np.testing.assert_array_equal(I_t, I_j)
        np.testing.assert_array_equal(D_t, D_j)    # integer scores: exact
    assert not calls
    assert idx.fused_fallbacks == jidx.fused_fallbacks
    assert idx._no_reduced_sweep == jidx._no_reduced_sweep
    _, I_ref = numpy_search(xb, xq, 10, metric.value)
    np.testing.assert_array_equal(I_t, I_ref)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_keep_master_false_matches_jax(open_gate, gauss, tmp_path, metric,
                                       jmetric):
    """Pair-only storage ranks by hi + lo, in both packages; a file saved
    from it loads into pair-only storage again."""
    xb, xq = gauss
    jidx = TpuIndexFlat(D, metric=jmetric, storage="f32", keep_master=False)
    jidx.add(xb)
    idx = TorchIndexFlat(D, metric=metric, device="cpu", keep_master=False)
    idx.add(xb)
    assert "pair_only=True" in idx.describe()
    path = str(tmp_path / "pair.npz")
    jio.save_index(jidx, path)
    loaded = load_index(path, device="cpu", keep_master=False)
    assert loaded.store.pair_only and loaded.store.db is None
    np.testing.assert_array_equal(loaded.reconstruct_n(0, NV_IDX), xb)
    D_j, I_j = jidx.search(xq, 10)
    n_diff = np.abs(idx.store.norms[:NV_IDX].numpy()
                    - np.asarray(jidx.store.norms)[:NV_IDX]).max()
    for mine, slack in ((idx, n_diff), (loaded, 0.0)):
        D_t, I_t = mine.search(xq, 10)
        np.testing.assert_array_equal(I_t, I_j)
        assert mine.fused_fallbacks == jidx.fused_fallbacks == 0
        assert_within_eps(D_t, D_j, _eps(mine, xq, metric) + slack,
                          "distances")
    pair = (idx.store.db_hi[:NV_IDX].double()
            + idx.store.db_lo[:NV_IDX].double()).numpy()
    _, I_ref = numpy_search(pair, xq, 10, metric.value)
    np.testing.assert_array_equal(I_t, I_ref)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("keep_master", [True, False])
def test_plain_path_matches_jax(gauss, metric, jmetric, keep_master):
    """set_force_plain against set_force_xla: matmul_scores on the master,
    pair_scores on the planes; chunked (three chunks and a tail)."""
    xb, xq = gauss
    jidx = TpuIndexFlat(D, metric=jmetric, storage="f32",
                        keep_master=keep_master)
    jidx.add(xb)
    jidx.set_force_xla(True)
    idx = TorchIndexFlat(D, metric=metric, device="cpu",
                         keep_master=keep_master,
                         tuning=faiss_tpu_torch.KernelTuning(chunk_v=6144))
    idx.add(xb)
    idx.set_force_plain(True)
    D_j, I_j = jidx.search(xq, 10)
    D_t, I_t = idx.search(xq, 10)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-5, atol=1e-3)
