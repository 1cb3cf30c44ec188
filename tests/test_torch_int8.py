"""faiss_tpu_torch's int8 storage against faiss_tpu's, on the CPU.

The quantization (scales, codes, decoded norms, clipped count,
int_norm_max), the query's residual expansion and ``_sweep_eps_int8``
against the JAX package's; the plain versions of the int8 sweep (K5
``_kernel_int8``) and of K10's int8 mode against those Pallas kernels in
interpret mode; the bound's conversion term at d = 1152 and its soundness
on adversarial codes; TorchIndexFlat(storage="int8") against
TpuIndexFlat(storage="int8"), built independently and from a saved file.

Tolerances: scales, codes, clipped count, int_norm_max, q₁, q₂, β₁ and β₂
equal bit for bit (XLA on the CPU does not contract ``qs − β₁·q₁`` here);
decoded norms within 4 ulps (the two packages sum in different orders);
ε at rtol 1e-6; group maxes within ε_int8 (the sweep of both packages is
exact up to its three roundings); rescores within the rescore term
(``rescore_term``: each side is fp32-true, ≤ d·u·Qs·Vq); index ids and
certificate outcomes equal, ids equal to the fp64 oracle over the decoded
database, distances within ε.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faiss_tpu import TpuIndexFlat
from faiss_tpu import io as jio
from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu_torch import KernelTuning, TorchIndexFlat, load_index
from faiss_tpu_torch.ops import fused, kernels

from common import make_data
from test_torch_cuda import check_int8_eps_sound, rescore_term
from torch_parity import METRIC_IDS, METRICS, assert_within_eps

torch.set_num_threads(2)

NV, D, NQ = 16384, 128, 16
NTOTAL = NV - 37   # the last rows are padding: masked to −inf


@pytest.fixture
def open_gate(monkeypatch):
    """Fused path from 8192 rows in both packages."""
    gate = lambda **kw: kw["nv_eff"] >= 8192  # noqa: E731
    monkeypatch.setattr(pf, "fused_path_eligible", gate)
    monkeypatch.setattr(fused, "fused_path_eligible", gate)


@pytest.fixture(scope="module")
def data():
    """One stored int8 database, quantized by the JAX package and handed
    to both sides as the same codes, scales and norms."""
    xb, xq = make_data(NV, NQ, D, seed=4322)
    xb[NTOTAL:] = 0.0
    jidx = TpuIndexFlat(D, storage="int8")
    jidx.add(xb[:NTOTAL])
    jst = jidx.store
    codes = np.asarray(jst.db)[:NV]
    norms = np.asarray(jst.norms)[:NV]
    scales = np.asarray(jst.scales)
    inm = np.float32(jst.int_norm_max)
    return dict(
        q_t=torch.from_numpy(xq), q_j=jnp.asarray(xq),
        c_t=torch.from_numpy(codes.copy()), c_j=jnp.asarray(codes),
        n_t=torch.from_numpy(norms.copy()), n_j=jnp.asarray(norms),
        s_t=torch.from_numpy(scales.copy()), s_j=jnp.asarray(scales),
        inm_t=torch.tensor(inm), inm_j=jnp.float32(inm))


def _eps(data, metric, d_pad=D):
    return fused._sweep_eps_int8(data["q_t"], data["s_t"], data["inm_t"],
                                 data["n_t"], NV, metric=metric,
                                 d_pad=d_pad).numpy()


# -- storage --------------------------------------------------------------


@pytest.mark.parametrize("d", [72, 128])
def test_quantization_matches_jax(d):
    """Two add batches, the second partly outside the trained range:
    the same scales, codes, clipped count and int_norm_max; norms of the
    decoded rows within a few ulps. int8 rows pad d to 16, not 128."""
    rng = np.random.default_rng(d)
    xb = rng.standard_normal((3000, d)).astype(np.float32) * 4
    xb[2500:, :5] *= 3.0                     # outgrows the first batch
    jidx = TpuIndexFlat(d, storage="int8")
    idx = TorchIndexFlat(d, storage="int8", device="cpu")
    assert not idx.is_trained
    for part in (xb[:1100], xb[1100:]):
        jidx.add(part)
        idx.add(part)
    st, jst = idx.store, jidx.store
    assert idx.is_trained and st.d_pad == (-(-d // 16)) * 16
    assert st.capacity == 4096 and st.db.dtype == torch.int8
    np.testing.assert_array_equal(st.scales[:d].numpy(),
                                  np.asarray(jst.scales)[:d])
    assert (st.scales[d:] == 1).all()
    np.testing.assert_array_equal(st.db[:3000, :d].numpy(),
                                  np.asarray(jst.db)[:3000, :d])
    assert (st.db[:, d:] == 0).all() and (st.db[3000:] == 0).all()
    np.testing.assert_array_max_ulp(st.norms[:3000].numpy(),
                                    np.asarray(jst.norms)[:3000], maxulp=4)
    assert float(st.int_norm_max) == float(jst.int_norm_max)
    assert st.int8_clipped_fraction == jst.int8_clipped_fraction > 0
    assert f"int8_clipped_fraction={st.int8_clipped_fraction:.2e}" \
        in idx.describe()
    np.testing.assert_array_equal(idx.reconstruct_n(0, 3000),
                                  jidx.reconstruct_n(0, 3000))
    assert st.nbytes() == st.capacity * (st.d_pad + 4)    # 1 B/element


def test_train_contract():
    """Explicit train, refusal of a second, reset keeping the scales (and
    clearing the counters), auto-train on the first add batch."""
    x = np.random.default_rng(0).standard_normal((256, 32)).astype(np.float32)
    idx = TorchIndexFlat(32, storage="int8", device="cpu")
    jidx = TpuIndexFlat(32, storage="int8")
    assert not idx.is_trained
    idx.train(x)
    jidx.train(x)
    assert idx.is_trained
    with pytest.raises(RuntimeError):
        idx.train(x)
    idx.add(x * 2)
    assert idx.store.int8_clipped_fraction > 0
    scales = idx.store.scales.clone()
    idx.reset()
    assert idx.is_trained and idx.ntotal == 0
    assert idx.store.int8_clipped_fraction == 0.0
    assert torch.equal(idx.store.scales, scales)
    np.testing.assert_array_equal(scales[:32].numpy(),
                                  np.asarray(jidx.store.scales)[:32])
    auto = TorchIndexFlat(32, storage="int8", device="cpu")
    auto.add(x)
    assert auto.is_trained and torch.equal(auto.store.scales, scales)
    for flt in ("f32", "bf16", "f16"):
        f = TorchIndexFlat(32, storage=flt, device="cpu")
        assert f.is_trained
        f.train(x)                          # a no-op
        assert f.ntotal == 0


# -- the query expansion and the bound -----------------------------------------


def test_int8_query_pair_matches_jax(data):
    got = fused.int8_query_pair(data["q_t"], data["s_t"])
    want = pf._int8_query_pair(data["q_j"], data["s_j"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_sweep_eps_int8_matches_jax(data, metric, jmetric):
    want = pf._sweep_eps_int8(data["q_j"], data["s_j"], data["inm_j"],
                              data["n_j"], NV, metric=jmetric, d_pad=D)
    np.testing.assert_allclose(_eps(data, metric), np.asarray(want),
                               rtol=1e-6)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_sweep_eps_int8_conversion_term(metric, jmetric):
    """d = 1152: 127²·d ≥ 2^24, the dots' conversions to f32 round, and
    the port's ε carries u·(Qs + 2·R1 + Rs)·Vq more than the JAX bound
    (×2 for L2). The bound holds on adversarial codes whose dots pass
    2^24; at d = 1040 the two bounds are the same."""
    eps, a1 = check_int8_eps_sound(torch.device("cpu"), metric, d=1152)
    assert float(a1.abs().max()) > 2 ** 24
    rng = np.random.default_rng(1)
    for d in (1152, 1040):
        q = rng.standard_normal((8, d)).astype(np.float32)
        s = (rng.random(d) + 0.5).astype(np.float32) / 127
        norms = rng.random(4096).astype(np.float32) * 50
        args_t = (torch.from_numpy(q), torch.from_numpy(s),
                  torch.tensor(np.float32(20.0)), torch.from_numpy(norms))
        args_j = (jnp.asarray(q), jnp.asarray(s), jnp.float32(20.0),
                  jnp.asarray(norms))
        got = fused._sweep_eps_int8(*args_t, 4096, metric=metric,
                                    d_pad=d).numpy()
        want = np.asarray(pf._sweep_eps_int8(*args_j, 4096, metric=jmetric,
                                             d_pad=d))
        if d == 1040:
            np.testing.assert_allclose(got, want, rtol=1e-6)
            continue
        q1, q2, b1, b2 = fused.int8_query_pair(*args_t[:2])
        qs = args_t[0] * args_t[1][None, :]
        r1 = qs - b1[:, None] * q1.to(torch.float32)
        rs = r1 - b2[:, None] * q2.to(torch.float32)
        term = (fused._U32 * 20.0
                * (qs.norm(dim=1) + 2 * r1.norm(dim=1) + rs.norm(dim=1)))
        term = term * (2.0 if metric.value == "l2" else 1.0) \
            * fused._EPS_SLACK
        np.testing.assert_allclose(got - want, term.numpy(), rtol=1e-3)


# -- kernels' plain versions against the Pallas kernels ----------------------


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_sweep_int8_plain_matches_pallas(data, metric, jmetric):
    """K5: two exact integer passes, then f32(a₁)·β₁ + f32(a₂)·β₂."""
    gm_j = pf.groupmax_scores(
        data["q_j"], data["c_j"], data["n_j"], jnp.int32(NTOTAL), None,
        metric=jmetric, nv_eff=NV, interpret=True, scales=data["s_j"])
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    before = dict(kernels.launches)
    gm = fused.int8_groupmax_scores(data["q_t"], data["c_t"], vn,
                                    data["s_t"], metric=metric)
    assert kernels.launches == before      # CPU tensors: the plain version
    assert gm.shape == (NQ, NV // 128)
    assert np.isneginf(gm[:, -1].numpy()).sum() == 0  # partly valid group
    assert_within_eps(gm.numpy(), np.asarray(gm_j), _eps(data, metric),
                      "group max")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_rescore_int8_plain_matches_pallas(data, metric, jmetric):
    """K10's int8 mode against q∘s: the codes widened exactly, one fp32
    product (the JAX kernel: an exact 3-way split of q∘s)."""
    rng = np.random.default_rng(25)
    gidx = np.sort(np.stack([rng.choice(NV // 128, 14, replace=False)
                             for _ in range(NQ)]), axis=1).astype(np.int32)
    gidx[0, -1] = NV // 128 - 1             # the partly padded last group
    qs_t = data["q_t"] * data["s_t"][None, :]
    s_j = pf.rescore_groups_pallas(
        data["q_j"] * data["s_j"][None, :], data["c_j"], data["n_j"],
        jnp.asarray(gidx), jnp.int32(NTOTAL), metric=jmetric, nv_eff=NV,
        interpret=True, ranks_per_step=pf.RESCORE_RANKS)
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    s = kernels.rescore_groups(qs_t, data["c_t"], vn, torch.from_numpy(gidx),
                               metric=metric)
    assert np.isneginf(s[0, -37:].numpy()).all()
    assert_within_eps(s.numpy(), np.asarray(s_j),
                      rescore_term(qs_t, data["inm_t"], data["n_t"], NV, D,
                                   metric).numpy(), "int8 rescore")


# -- the index ------------------------------------------------------------


def _decoded_oracle(idx, xq, k, metric):
    dec = idx.reconstruct_n(0, idx.ntotal).astype(np.float64)
    s = xq.astype(np.float64) @ dec.T
    if metric.value == "l2":
        s = 2 * s - np.asarray(idx.store.norms)[None, : idx.ntotal]
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


def _certs(idx, jidx, xq, k):
    """The per-query certificates of one fused search in each package."""
    q, _, nq_pad = idx._prep_queries(xq)
    packed, fused_ran, _ = idx._run_search_fn(q, k, nq_pad, force_plain=False)
    qj, _, _ = jidx._prep_queries(xq)
    out = jidx._run_search_fn(qj, k, nq_pad, force_plain=False)
    assert fused_ran and out[3]
    return packed[:, 2 * k].numpy() != 0, np.asarray(out[2])


@pytest.fixture(scope="module")
def gauss():
    return make_data(20000, NQ, D, seed=79)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_index_matches_jax(open_gate, gauss, tmp_path, metric, jmetric):
    """Built independently and from the JAX package's saved file (scales,
    codes and norms bit for bit): the same ids and certificate outcomes as
    TpuIndexFlat(storage="int8"), and the ids of the fp64 oracle over the
    decoded database."""
    xb, xq = gauss
    jidx = TpuIndexFlat(D, metric=jmetric, storage="int8")
    jidx.add(xb)
    path = str(tmp_path / "flat_int8.npz")
    jio.save_index(jidx, path)
    loaded = load_index(path, device="cpu")
    built = TorchIndexFlat(D, metric=metric, storage="int8", device="cpu")
    built.add(xb)
    st, jst = loaded.store, jidx.store
    assert loaded.is_trained and loaded.ntotal == 20000
    np.testing.assert_array_equal(st.scales.numpy(), np.asarray(jst.scales))
    np.testing.assert_array_equal(st.db[:20000].numpy(),
                                  np.asarray(jst.db)[:20000])
    np.testing.assert_array_equal(st.norms[:20000].numpy(),
                                  np.asarray(jst.norms)[:20000])
    assert float(st.int_norm_max) == float(jst.int_norm_max)

    n_diff = np.abs(built.store.norms[:20000].numpy()
                    - np.asarray(jst.norms)[:20000]).max()

    D_j, I_j = jidx.search(xq, 10)
    ref = _decoded_oracle(jidx, xq, 10, metric)
    np.testing.assert_array_equal(I_j, ref)
    for idx, slack in ((loaded, 0.0), (built, n_diff)):
        D_t, I_t = idx.search(xq, 10)
        np.testing.assert_array_equal(I_t, I_j)
        assert idx.fused_fallbacks == jidx.fused_fallbacks == 0
        c_t, c_j = _certs(idx, jidx, xq, 10)
        np.testing.assert_array_equal(c_t, c_j)
        q, _, _ = idx._prep_queries(xq)
        eps = fused._sweep_eps_int8(q, st.scales, st.int_norm_max, st.norms,
                                    20480, metric=metric, d_pad=D)[:NQ]
        assert_within_eps(D_t, D_j, eps.numpy() + slack, "distances")
    idx = built
    idx.set_force_plain(True)
    D_p, I_p = idx.search(xq, 10)
    np.testing.assert_array_equal(I_p, I_j)


def test_empty_trained_file_keeps_scales(tmp_path):
    """A trained but empty int8 index saved by faiss_tpu loads trained,
    with its scales; adding then quantizes as the JAX package does."""
    x = np.random.default_rng(3).standard_normal((500, 48)).astype(np.float32)
    jidx = TpuIndexFlat(48, storage="int8")
    jidx.train(x)
    path = str(tmp_path / "empty_int8.npz")
    jio.save_index(jidx, path)
    idx = load_index(path, device="cpu")
    assert idx.is_trained and idx.ntotal == 0
    idx.add(x * 1.5)
    jidx.add(x * 1.5)
    np.testing.assert_array_equal(idx.store.db[:500, :48].numpy(),
                                  np.asarray(jidx.store.db)[:500, :48])
    assert idx.store.int8_clipped_fraction == \
        jidx.store.int8_clipped_fraction > 0


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_plain_path_matches_jax(gauss, metric, jmetric):
    """set_force_plain against set_force_xla (int8_scores; chunked: three
    chunks and a tail)."""
    xb, xq = gauss
    jidx = TpuIndexFlat(D, metric=jmetric, storage="int8")
    jidx.add(xb)
    jidx.set_force_xla(True)
    idx = TorchIndexFlat(D, metric=metric, storage="int8", device="cpu",
                         tuning=KernelTuning(chunk_v=6144))
    idx.add(xb)
    idx.set_force_plain(True)
    D_j, I_j = jidx.search(xq, 10)
    D_t, I_t = idx.search(xq, 10)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-5, atol=1e-3)
