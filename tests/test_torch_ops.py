"""faiss_tpu_torch ops against faiss_tpu's, on the CPU.

Each kernel of the fused bf16 path runs here as its plain PyTorch version
(the wrappers take it for CPU tensors) and is held against the Pallas
kernel it replaces, run in interpret mode as tests/test_pallas_fused.py
runs it. Tolerances:
  * select_groups, final_select: equal bits (ids, thresholds, values);
  * sweep group maxes, rescore scores, fused_search distances: within the
    query's own ε (_sweep_eps) as an absolute difference. The two sides
    differ only in fp32 summation order, which ε budgets for both;
  * fused_search ids and certificate flags: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faiss_tpu.ops import distance as jdist
from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu.ops import topk as jtopk
from faiss_tpu import storage as jstorage
from faiss_tpu_torch import storage
from faiss_tpu_torch.ops import distance, fused, kernels, topk

from torch_parity import (METRIC_IDS, METRICS, assert_within_eps, bf16_bits,
                          bits_of, jax_bf16, torch_bf16)

torch.set_num_threads(2)

NV, D, NQ, K = 16384, 128, 16, 10
NTOTAL = NV - 37   # the last rows are padding: masked to −inf


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1234)
    xb = rng.standard_normal((NV, D), dtype=np.float32)
    xq = rng.standard_normal((NQ, D), dtype=np.float32)
    bits = bf16_bits(xb)
    bits[NTOTAL:] = 0                      # padding rows are zero
    norms = (xb * xb).sum(1, dtype=np.float32)
    norms[NTOTAL:] = 0.0
    return dict(xq=xq, bits=bits, norms=norms,
                q_t=torch.from_numpy(xq), db_t=torch_bf16(bits),
                n_t=torch.from_numpy(norms),
                q_j=jnp.asarray(xq), db_j=jax_bf16(bits),
                n_j=jnp.asarray(norms))


def _eps(data, metric, single_pass=False):
    return fused._sweep_eps(data["q_t"], data["n_t"], NV, metric=metric,
                            d_pad=D, single_pass=single_pass).numpy()


def test_splits_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 33)).astype(np.float32) * 1e3
    x[0, :6] = [0.0, -0.0, 1e-40, -3.4e38, 2.0 ** -130, 1.0 + 2.0 ** -20]
    for ours, theirs in ((storage.split_f32_bf16, jstorage.split_f32_bf16),
                         (storage.split3_f32_bf16, jstorage.split3_f32_bf16)):
        got = ours(torch.from_numpy(x))
        want = theirs(jnp.asarray(x))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                bits_of(g), np.asarray(w).view(np.uint16))


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("passes", [1, 2])
def test_sweep_groupmax_matches_pallas(data, metric, jmetric, passes):
    gm_j = pf.groupmax_scores(
        data["q_j"], data["db_j"], data["n_j"], jnp.int32(NTOTAL),
        metric=jmetric, nv_eff=NV, interpret=True, sweep_passes=passes)
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    before = dict(kernels.launches)
    gm = fused.groupmax_scores(data["q_t"], data["db_t"], vn, metric=metric,
                               sweep_passes=passes)
    assert kernels.launches == before      # CPU tensors: the plain version
    assert gm.shape == (NQ, NV // 128)
    assert np.isneginf(gm[:, -1].numpy()).sum() == 0  # partly valid group
    assert_within_eps(gm.numpy(), np.asarray(gm_j),
                      _eps(data, metric, passes == 1), "group max")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("single_pass", [False, True])
def test_sweep_eps_matches_jax(data, metric, jmetric, single_pass):
    want = pf._sweep_eps(data["q_j"], data["n_j"], NV, metric=jmetric,
                         pair_sweep=False, d_pad=D, single_pass=single_pass)
    np.testing.assert_allclose(_eps(data, metric, single_pass),
                               np.asarray(want), rtol=1e-6)


def _select_cases():
    rng = np.random.default_rng(21)
    ties = rng.integers(0, 4, (16, 256)).astype(np.float32)
    ties[2] = -np.inf                       # an all −inf row
    ties[5, 40:] = -np.inf                  # fewer finite columns than kg
    ties[7, ::3] = -np.inf
    rand = rng.standard_normal((16, 256)).astype(np.float32)
    # the rows the one-pass select (K8) must get right, 8 × 300 (not a
    # multiple of 32)
    nan = rng.integers(0, 4, (8, 300)).astype(np.float32)
    nan[1, 17] = np.nan
    nan[2] = np.nan
    nan[3, ::7] = np.nan
    zeros = np.where(rng.random((8, 300)) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[1, 150:] = -1.0                   # zeros then negatives
    zeros[2, ::5] = 1.0                     # ±0 ties below the picks: t = ±0
    zeros[3, 299] = 2.0
    infs = rng.standard_normal((8, 300)).astype(np.float32)
    infs[:, ::3] = np.inf                   # +inf ties, 100 a row
    infs[1, :] = np.inf
    infs[2, ::3] = -np.inf
    repick = np.full((8, 300), -np.inf, np.float32)
    repick[0, 0] = 1.0                      # column 0 finite, 5 finite: re-pick
    repick[0, [7, 40, 41, 299]] = [3.0, -2.0, 3.0, 0.5]
    repick[1, [7, 40, 41, 299]] = [3.0, -2.0, 3.0, 0.5]   # column 0 −inf
    repick[3, 0] = -0.0
    repick[4, 299] = np.inf
    repick[5, 100:113] = np.arange(13)      # 13 finite of kg 14
    return {"ties": (ties, 14), "random": (rand, 14),
            "kg_eq_ngroups": (rand[:, :12].copy(), 12),
            "kg_gt_ngroups": (ties[:, :8].copy(), 11),
            "nan": (nan, 14), "signed_zeros": (zeros, 14),
            "pos_inf_ties": (infs, 14), "neg_inf_repick": (repick, 14),
            "ragged_37": (ties[:, :37].copy(), 14),
            "kg_eq_ngroups_ties": (ties[:, :40].copy(), 40),
            "kg_eq_ngroups_repick": (repick[:, 280:].copy(), 20)}


@pytest.mark.parametrize("case", list(_select_cases()))
def test_select_groups_matches_pallas(case):
    """The group select's plain version against _select_kernel (interpret)
    on ties, NaN rows (nothing nominated, t NaN), ±0 and +inf ties, the −inf
    re-pick of column 0 (finite or −inf there), ragged widths and kg =
    ngroups: ids equal, t equal by value (−0.0 == +0.0)."""
    x, kg = _select_cases()[case]
    gidx_j, t_j = pf.select_groups_pallas(jnp.asarray(x), kg, x.shape[1],
                                          interpret=True)
    gidx, t = kernels.select_groups(torch.from_numpy(x), kg)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(gidx_j))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))


def test_select_groups_t_is_the_columns_own_value():
    """On a −0.0 / +0.0 tie among the unnominated columns t carries the
    lowest such column's sign, bit for bit, whichever sign it has."""
    x = np.full((2, 64), -1.0, np.float32)
    x[:, :4] = 5.0                           # the nominated four
    x[0, [10, 20]] = [-0.0, 0.0]
    x[1, [10, 20]] = [0.0, -0.0]
    _, t = kernels.select_groups(torch.from_numpy(x), 4)
    assert t.numpy().view(np.uint32).tolist() == [0x80000000, 0]


@pytest.mark.parametrize("case", ["ties", "random", "all_neg_inf"])
def test_final_select_matches_pallas(case):
    rng = np.random.default_rng(22)
    if case == "ties":
        s = rng.integers(0, 3, (16, 1792)).astype(np.float32)
        s[3, 7:] = -np.inf
    elif case == "random":
        s = rng.standard_normal((16, 1792)).astype(np.float32)
    else:
        s = np.full((16, 1792), -np.inf, np.float32)
        s[1, 5] = 1.0
    v_j, p_j = pf.final_select_pallas(jnp.asarray(s), K, interpret=True)
    v, p = kernels.final_select(torch.from_numpy(s), K)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_rescore_groups_matches_pallas(data, metric, jmetric):
    rng = np.random.default_rng(23)
    gidx = np.sort(np.stack([rng.choice(NV // 128, 14, replace=False)
                             for _ in range(NQ)]), axis=1).astype(np.int32)
    gidx[0, -1] = NV // 128 - 1             # the partly padded last group
    s_j = pf.rescore_groups_pallas(
        data["q_j"], data["db_j"], data["n_j"], jnp.asarray(gidx),
        jnp.int32(NTOTAL), metric=jmetric, nv_eff=NV, interpret=True,
        ranks_per_step=pf.RESCORE_RANKS)
    vn = fused._premask_norms(data["n_t"], NTOTAL, NV, metric)
    s = kernels.rescore_groups(data["q_t"], data["db_t"], vn,
                               torch.from_numpy(gidx), metric=metric)
    assert np.isneginf(s[0, -37:].numpy()).all()
    assert_within_eps(s.numpy(), np.asarray(s_j), _eps(data, metric),
                      "rescore")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("passes", [1, 2])
def test_fused_search_matches_jax(data, metric, jmetric, passes):
    v_j, i_j, c_j = pf.fused_search(
        data["q_j"], data["db_j"], data["n_j"], jnp.int32(NTOTAL), k=K,
        metric=jmetric, nv_eff=NV, interpret=True, sweep_passes=passes)
    v, i, c = fused.fused_search(
        data["q_t"], data["db_t"], data["n_t"], NTOTAL, k=K, metric=metric,
        nv_eff=NV, sweep_passes=passes)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    assert c.numpy().all()                  # random data certifies
    assert_within_eps(v.numpy(), np.asarray(v_j),
                      _eps(data, metric, passes == 1), "fused scores")
    # exact w.r.t. the stored rows: the fp64 oracle's ids
    rows = torch_bf16(data["bits"])[:NTOTAL].double().numpy()
    s = data["xq"].astype(np.float64) @ rows.T
    if metric.value == "l2":
        s = 2 * s - data["norms"][:NTOTAL].astype(np.float64)
    order = np.argsort(-s, axis=1, kind="stable")[:, :K]
    np.testing.assert_array_equal(i.numpy(), order)


def test_fused_search_refuses_unported_shapes(data):
    """f32 rows without their (hi, lo) planes would need K10's f32-rows
    mode (the IVF fine scan's), which is not ported: refused. Every k and
    number of groups is ported: k = 36 (kg 40) and k = 64 (kg 68, phase 2
    and the final top-k by stable sorts) run."""
    with pytest.raises(ValueError):
        fused.fused_search(data["q_t"], data["db_t"].to(torch.float32),
                           data["n_t"], NTOTAL, k=K, metric=METRICS[0][0],
                           nv_eff=NV)
    for k in (fused.SELECT_MAX_KG - 4, 64):
        v, i, c = fused.fused_search(data["q_t"], data["db_t"], data["n_t"],
                                     NTOTAL, k=k, metric=METRICS[0][0],
                                     nv_eff=NV)
        assert v.shape == i.shape == (NQ, k)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("kw", [
    dict(k=10, nv_eff=1 << 20, d_pad=128),                # SIFT1M shape
    dict(k=1024, nv_eff=1 << 20, d_pad=128, nq_pad=8),    # kg > 40
    dict(k=10, nv_eff=4096, d_pad=128),                   # below FUSED_MIN_NV
    dict(k=10, nv_eff=16384, d_pad=128, nq_pad=8),        # tiny: plain wins
    dict(k=10, nv_eff=4 << 20, d_pad=128),                # > 16384 groups
    dict(k=10, nv_eff=1 << 20, d_pad=128, itemsize=4),    # f32 pair sweep
    dict(k=36, nv_eff=1 << 17, d_pad=128, nq_pad=8, itemsize=4),
])
def test_eligibility_gate(metric, jmetric, kw):
    """The gate admits what the JAX gate admits, kg > 40 and more than
    16384 groups included."""
    got = fused.fused_path_eligible(metric=metric, **kw)
    assert got == pf.fused_path_eligible(metric=jmetric, **kw)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_matmul_scores_matches_jax(data, metric, jmetric):
    rows = slice(0, 2048)
    s = distance.matmul_scores(data["q_t"], data["db_t"][rows],
                               data["n_t"][rows], metric).numpy()
    s_j = np.asarray(jdist.matmul_scores(
        data["q_j"], data["db_j"][rows], data["n_j"][rows], jmetric))
    np.testing.assert_allclose(s, s_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.argmax(s, 1), np.argmax(s_j, 1))


def test_exact_fp32_matmul_restores_caller_settings(data):
    """The plain path forces true fp32 products only inside its own calls:
    a caller's TF32 setting survives a plain search."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        with distance.exact_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        distance.matmul_scores(data["q_t"], data["db_t"][:256],
                               data["n_t"][:256], METRICS[0][0])
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[1])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]


def test_direct_l2_scores_matches_jax(data):
    s = distance.direct_l2_scores(data["q_t"], data["db_t"][:200]).numpy()
    s_j = np.asarray(jdist.direct_l2_scores(data["q_j"], data["db_j"][:200]))
    np.testing.assert_allclose(s, s_j, rtol=1e-6, atol=1e-4)


def test_topk_ties_go_to_lowest_index():
    rng = np.random.default_rng(5)
    s = rng.integers(0, 5, (8, 300)).astype(np.float32)
    s[1] = -np.inf
    v, i = topk.topk_scores(torch.from_numpy(s), 17)
    v_j, i_j = jtopk.topk_scores(jnp.asarray(s), 17)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    assert i.dtype == torch.int32


@pytest.mark.parametrize("k", [5, 300])
def test_chunked_topk_matches_flat(k):
    rng = np.random.default_rng(6)
    s = rng.integers(0, 50, (8, 1024)).astype(np.float32)
    st = torch.from_numpy(s)
    v, i = topk.chunked_topk_scores(lambda a: st[:, a: a + 256], 1024, 256, k)
    v_j, i_j = jtopk.chunked_topk_scores(
        lambda a: jax.lax.dynamic_slice_in_dim(jnp.asarray(s), a, 256, 1),
        1024, 256, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))


def test_wrappers_refuse_other_devices(data):
    meta = torch.empty((8, 128), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        kernels.final_select(meta, 4)
    with pytest.raises(ValueError):   # tensors on different devices
        kernels.rescore_groups(data["q_t"], data["db_t"].to("meta"),
                               data["n_t"], torch.zeros((NQ, 2), dtype=torch.int32),
                               metric=METRICS[0][0])
