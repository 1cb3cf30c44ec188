"""The certificate's tensor-core budget (``_sweep_eps(accum="mma")``), on the
CPU.

The tensor-core sweeps on the card with float sums
(``csrc/sweep_split_mma.cu``: K3 and, with one query plane, K4 over the
f32 planes, K1 and, with one query plane, K2 over bf16 rows, K6 and, with one query plane, K7 over the
f16 rows' exact bf16 pair) sum
their bf16×bf16 products on the tensor cores, whose fp32 accumulation is
not proven round-to-nearest.
``_sweep_eps`` charges their term (2) as (36·⌈d/16⌉ + 2)·u·[(Q+R)·(V+s0) +
L·V] (bf16 rows: s0 = 0); the default ("fmaf") keeps the CUDA-core budget
(d+2)·u·[…], which is the JAX package's bound. ``sweep_accum`` picks the
budget from the route, the query planes and the device.

Checked here: the budget term by term against a float64 recomputation
(rtol 1e-6, the fp32 rounding of the port's computation), for the pair and
the bf16 rows; that it is never below the fmaf budget; that the default
still equals the JAX bound (rtol 1e-6); ``sweep_accum`` route by route, and
that fused_search asks it for the route it swept; and a numpy emulator of
the model's worst case, every addend of a 16-product k-step truncated at
the largest addend's exponent and the sum truncated to 24 bits, on
adversarial rows: its error stays within the new term (2), and on the
truncation adversary exceeds the fmaf term, so the new budget is needed
for that arithmetic; the emulated pair sweep (three accumulators), bf16
sweep (two), one-plane bf16 sweep (one), f16 pair sweep (three, over f16
rows; the CPU route's arithmetic), f16-native sweep (two, over the stored
f16 rows against the f16 query split: K6 on the card, within
``_sweep_eps(f16_planes=)``), one-plane f16 sweep (two) and
one-plane pair sweep (two, over f32 rows with both planes non-zero) stay
within the whole ε. tests/test_torch_cuda.py holds the
kernels themselves to the budget on the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu_torch.ops import fused
from faiss_tpu_torch.storage import (decode_f16_bits, encode_f16_bits,
                                     flush_f16_subnormals, split_f16_bits,
                                     split_f32_bf16, split_f32_f16,
                                     split_stats)

from torch_parity import METRIC_IDS, METRICS

U = 2.0 ** -24
D_PADS = [8, 128, 136, 1024]


def _case(d, seed=0, scale=1.0, nv=512, nq=12):
    rng = np.random.default_rng(seed)
    xb = (rng.standard_normal((nv, d)) * scale).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    db = torch.from_numpy(xb)
    hi, lo = split_f32_bf16(db)
    return (torch.from_numpy(xq), (db * db).sum(-1),
            split_stats(db, hi, lo))


def _want(q, norms, stats, metric, d_pad, single_pass, coeff):
    """_sweep_eps(pair_sweep=True) recomputed in float64 from its
    definition, with term (2)'s multiple ``coeff``; with ``stats`` None,
    _sweep_eps(pair_sweep=False), the bf16 rows' (s0 = s1 = 0)."""
    q64 = q.double()
    if single_pass:
        resid = q64 - q.to(torch.bfloat16).double()
        lo = torch.zeros_like(q64)
    else:
        qh, ql = split_f32_bf16(q)
        lo = ql.double()
        resid = q64 - qh.double() - lo
    R = resid.norm(dim=-1)
    L = lo.norm(dim=-1)
    Q = q64.norm(dim=-1)
    N = norms.double().max()
    V = N.sqrt() * (1 + 2.0 ** -8)
    s0, s1 = (0.0, 0.0) if stats is None else (float(x) for x in stats)
    drop = R * V if stats is None else R * V + L * s0 + (Q + R) * s1
    eps = (drop + coeff * U * ((Q + R) * (V + s0) + L * V)
           + 2.0 * d_pad * U * Q * V)
    if metric.value == "l2":
        eps = 2.0 * eps + 3.0 * U * (2.0 * Q * V + N)
    else:
        eps = eps + 2.0 * U * Q * V
    return (1 + 2.0 ** -10) * eps


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("d_pad", D_PADS)
@pytest.mark.parametrize("single_pass", [False, True])
def test_mma_budget_term_by_term(metric, jmetric, d_pad, single_pass):
    q, norms, stats = _case(64, seed=d_pad)
    got = fused._sweep_eps(q, norms, norms.shape[0], metric=metric,
                           d_pad=d_pad, single_pass=single_pass,
                           pair_sweep=True, split_stats=stats, accum="mma")
    coeff = 36 * math.ceil(d_pad / 16) + 2
    want = _want(q, norms, stats, metric, d_pad, single_pass, coeff)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-6)
    fmaf = _want(q, norms, stats, metric, d_pad, single_pass, d_pad + 2)
    np.testing.assert_allclose(
        fused._sweep_eps(q, norms, norms.shape[0], metric=metric,
                         d_pad=d_pad, single_pass=single_pass,
                         pair_sweep=True, split_stats=stats).double().numpy(),
        fmaf.numpy(), rtol=1e-6)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("d_pad", D_PADS)
@pytest.mark.parametrize("single_pass", [False, True])
def test_mma_budget_bf16_rows_term_by_term(metric, jmetric, d_pad,
                                           single_pass):
    """The bf16 rows' budget (pair_sweep=False: s0 = 0, no split terms), the
    one K1 is certified with: (36·⌈d/16⌉ + 2)·u·[(Q+R)·V + L·V] for term
    (2), the rest as the fmaf default's."""
    q, norms, _ = _case(64, seed=100 + d_pad)
    got = fused._sweep_eps(q, norms, norms.shape[0], metric=metric,
                           d_pad=d_pad, single_pass=single_pass, accum="mma")
    coeff = 36 * math.ceil(d_pad / 16) + 2
    want = _want(q, norms, None, metric, d_pad, single_pass, coeff)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-6)
    fmaf = _want(q, norms, None, metric, d_pad, single_pass, d_pad + 2)
    np.testing.assert_allclose(
        fused._sweep_eps(q, norms, norms.shape[0], metric=metric,
                         d_pad=d_pad, single_pass=single_pass
                         ).double().numpy(), fmaf.numpy(), rtol=1e-6)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("d_pad", D_PADS)
def test_mma_budget_not_below_fmaf(metric, jmetric, d_pad):
    q, norms, stats = _case(64, seed=1, scale=1e3)
    for st in (stats, None):
        kw = dict(metric=metric, d_pad=d_pad, pair_sweep=True,
                  split_stats=st)
        mma = fused._sweep_eps(q, norms, 512, accum="mma", **kw)
        fmaf = fused._sweep_eps(q, norms, 512, **kw)
        # 36·⌈d/16⌉ + 2 > d + 2 for every d ≥ 1
        assert bool((mma > fmaf).all())


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("pair_sweep", [False, True])
def test_default_budget_is_the_jax_bound(metric, jmetric, pair_sweep):
    q, norms, stats = _case(128, seed=5)
    st = stats if pair_sweep else None
    got = fused._sweep_eps(q, norms, 512, metric=metric, d_pad=128,
                           pair_sweep=pair_sweep, split_stats=st)
    same = fused._sweep_eps(q, norms, 512, metric=metric, d_pad=128,
                            pair_sweep=pair_sweep, split_stats=st,
                            accum="fmaf")
    want = pf._sweep_eps(jnp.asarray(q.numpy()), jnp.asarray(norms.numpy()),
                         512, metric=jmetric, d_pad=128,
                         pair_sweep=pair_sweep,
                         split_stats=None if st is None
                         else jnp.asarray(st.numpy()))
    assert torch.equal(got, same)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_unknown_accumulation_is_refused():
    q, norms, stats = _case(16)
    with pytest.raises(ValueError):
        fused._sweep_eps(q, norms, 512, metric=METRICS[0][0], d_pad=16,
                         accum="tf32")


# (route, query planes, device) → the accumulation its sweep charges: on
# the card the bf16 rows, hi_exact's hi plane, the f32 planes and the f16
# pair run on the tensor cores with one or two query planes (K2, K1; K4,
# K3; K7, K6); int8 (K5: exact integer sums, its own ε) and every CPU
# tensor keep the fmaf bound
ACCUM_CASES = [
    ("pair", 2, "cuda", "mma"), ("bf16", 2, "cuda", "mma"),
    ("hi_exact", 2, "cuda", "mma"), ("f16", 2, "cuda", "mma"),
    ("pair", 1, "cuda", "mma"), ("bf16", 1, "cuda", "mma"),
    ("hi_exact", 1, "cuda", "mma"), ("f16", 1, "cuda", "mma"),
    ("int8", 2, "cuda", "fmaf"),
] + [(r, p, "cpu", "fmaf") for r in fused.SWEEP_ROUTES for p in (1, 2)]


@pytest.mark.parametrize("route,passes,device,want", ACCUM_CASES)
def test_sweep_accum_by_route(route, passes, device, want):
    assert fused.sweep_accum(route, passes, torch.device(device)) == want


def test_sweep_accum_refuses_unknown_routes():
    with pytest.raises(ValueError):
        fused.sweep_accum("f32", 2, torch.device("cuda"))


def test_fused_search_names_its_route(monkeypatch):
    """fused_search asks sweep_accum for the route it swept, with its
    passes and the queries' device, and certifies with the answer."""
    seen = []
    real = fused.sweep_accum
    monkeypatch.setattr(fused, "sweep_accum", lambda r, p, dev: (
        seen.append((r, p, torch.device(dev).type)) or real(r, p, dev)))
    rng = np.random.default_rng(4)
    nv, d = 1024, 16
    xb = torch.from_numpy(rng.integers(-3, 4, (nv, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))
    norms = (xb * xb).sum(-1)
    hi, lo = split_f32_bf16(xb)
    kw = dict(k=5, metric=METRICS[0][0], nv_eff=nv)
    fused.fused_search(q, xb.to(torch.bfloat16), norms, nv, **kw)
    fused.fused_search(q, xb.to(torch.bfloat16), norms, nv, sweep_passes=1,
                       **kw)
    fused.fused_search(q, xb, norms, nv, db_split=(hi, lo), **kw)
    fused.fused_search(q, xb, norms, nv, db_split=(hi, lo), hi_exact=True,
                       split_stats=torch.zeros(2), **kw)
    fused.fused_search(q, xb.to(torch.float16), norms, nv,
                       split_stats=torch.zeros(2), **kw)
    assert seen == [("bf16", 2, "cpu"), ("bf16", 1, "cpu"), ("pair", 2, "cpu"),
                    ("hi_exact", 2, "cpu"), ("f16", 2, "cpu")]


# -- the model's worst case, emulated ----------------------------------------


def _trunc(x, e):
    """x truncated toward zero to a multiple of 2^(e − 23): the bits below
    a 24-bit significand at exponent e."""
    q = np.ldexp(1.0, e - 23)
    return np.trunc(x / q) * q


def _exponent(m):
    """e with m in [2^e, 2^(e+1)) (0 where m == 0)."""
    return np.where(m > 0, np.frexp(m)[1] - 1, 0)


def mma_chain(a, b):
    """(n,) the model's worst case of one wgmma accumulator over a (d,)
    against the rows of b (n, d), both bf16-valued float64: per k-step of
    16, every addend (the accumulator and 16 exact products) truncated at
    the largest addend's exponent, their sum (exact in float64) truncated
    to 24 bits."""
    acc = np.zeros(b.shape[0])
    for j in range(0, a.shape[0], 16):
        add = np.concatenate([acc[:, None], a[j:j + 16] * b[:, j:j + 16]],
                             axis=1)
        e = _exponent(np.abs(add).max(axis=1))
        s = _trunc(add, e[:, None]).sum(axis=1)
        acc = _trunc(s, _exponent(np.abs(s)))
    return acc


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def _term_check(a, b):
    """(error, ‖a‖·‖b‖) of the emulated chain a·b, per row of b."""
    exact = b @ a
    err = np.abs(mma_chain(a, b) - exact)
    return err, np.linalg.norm(a) * np.linalg.norm(b, axis=1)


def _adversaries(d):
    """bf16-valued (query, rows) pairs: the truncation adversary (one unit
    product, the others just under its ulp and of the other sign, each of
    which a truncating sum drops), cancellation across k-steps, and
    norm-skewed Gaussian rows."""
    s = 2.0 ** -12 * 1.4140625            # s² just under 2^-23 = ulp(1)
    a = np.full(d, s)
    a[0] = 1.0
    rows = np.tile(-a, (4, 1))
    rows[:, 0] = 1.0
    rows[1, 1:] *= 0.75
    rows[2, 17:] = 0.0                    # only the first k-step drops
    yield "truncation", a, _bf16(rows)
    rng = np.random.default_rng(d)
    a = _bf16(rng.standard_normal(d))
    big = _bf16(np.abs(rng.standard_normal(d)) * 1e4)
    rows = np.stack([np.where(np.arange(d) < 16, big, -big),
                     np.where(np.arange(d) < d // 2, big, -big[::-1]),
                     _bf16(rng.standard_normal(d) * 1e-3)])
    yield "cancellation", np.abs(a), rows
    rows = rng.standard_normal((64, d)) * 1e4
    rows[::8] *= 1e-4                     # norm-skewed
    yield "skewed", a, _bf16(rows)


@pytest.mark.parametrize("d", [128, 136])
def test_emulated_truncating_sum_within_mma_term(d):
    steps = math.ceil(d / 16)
    seen = {}
    for name, a, rows in _adversaries(d):
        err, ab = _term_check(a, rows)
        assert bool((err <= 36 * steps * U * ab).all()), name
        seen[name] = float((err / ab).max())
    # the fmaf budget (d·u per term) is too small for this arithmetic: the
    # truncation adversary loses ≈ 2u·‖a‖·‖b‖ on each of its d − 1 products
    assert seen["truncation"] > d * U
    assert seen["truncation"] > 1.9 * (d - 1) * U


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_emulated_pair_sweep_within_mma_eps(metric, jmetric):
    """The three emulated accumulators of the pair sweep added left to
    right in fp32, and its epilogue, against the exact score of the stored
    f32 row: within _sweep_eps(accum="mma") on Gaussian and norm-skewed rows
    (CERT_CASES_F32's 1e4) and on the truncation adversary's row."""
    d, nq = 128, 6
    rng = np.random.default_rng(17)
    xb = (rng.standard_normal((96, d)) * 1e4).astype(np.float32)
    xb[::5] *= np.float32(1e-4)
    s = 2.0 ** -12 * 1.4140625
    adv = np.full(d, s, np.float32)
    adv[0] = 1.0
    xb[1] = -adv
    xb[1, 0] = 1.0
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    xq[0] = adv
    q, db = torch.from_numpy(xq), torch.from_numpy(xb)
    qh, ql = (p.double().numpy() for p in split_f32_bf16(q))
    dh, dl = (p.double().numpy() for p in split_f32_bf16(db))
    norms = (db * db).sum(-1)
    stats = split_stats(db, *split_f32_bf16(db))
    eps = fused._sweep_eps(q, norms, 96, metric=metric, d_pad=d,
                           pair_sweep=True, split_stats=stats,
                           accum="mma").double().numpy()
    x64 = xb.astype(np.float64)
    for i in range(nq):
        t1 = mma_chain(qh[i], dh).astype(np.float32)
        t2 = mma_chain(qh[i], dl).astype(np.float32)
        t3 = mma_chain(ql[i], dh).astype(np.float32)
        acc = (t1 + t2) + t3                                 # fp32, RN
        # both sides subtract the same stored fp32 norms (0 for IP)
        vn = norms.numpy() if metric.value == "l2" \
            else np.zeros(96, np.float32)
        got = (np.float32(2) * acc if metric.value == "l2" else acc) - vn
        exact = x64 @ xq[i].astype(np.float64)
        if metric.value == "l2":
            exact = 2.0 * exact - vn.astype(np.float64)
        assert bool((np.abs(got - exact) <= eps[i]).all()), i


def _near_bf16_query(a, seed):
    """An fp32 query whose bit-mask hi plane is the bf16-valued ``a`` and
    whose lo plane is not zero: a times (1 + δ), 0 ≤ δ < 2^-9, so the
    two-plane sweep runs both of its terms."""
    rng = np.random.default_rng(seed)
    return (a * (1.0 + rng.random(a.shape) * 2.0 ** -9)).astype(np.float32)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("adversary", ["truncation", "cancellation", "skewed"])
@pytest.mark.parametrize("d", [128, 136])
def test_emulated_bf16_sweep_within_mma_eps(metric, jmetric, adversary, d):
    """K1's arithmetic emulated: the two accumulators qh·v and ql·v of the
    model's worst case (``mma_chain``), added once in fp32, and the
    epilogue, against the exact score of the stored bf16 row: within
    _sweep_eps(pair_sweep=False, accum="mma") on the truncation,
    cancellation and skewed adversaries. On the truncation adversary the
    emulated error exceeds the fmaf budget's accumulation term, so the
    tensor-core term is needed there."""
    name, a, rows = [c for c in _adversaries(d) if c[0] == adversary][0]
    xq = np.stack([_near_bf16_query(a, seed) for seed in range(3)])
    q = torch.from_numpy(xq)
    qh, ql = (p.double().numpy() for p in split_f32_bf16(q))
    assert np.array_equal(qh[0], a) and np.abs(ql).sum() > 0
    norms = torch.from_numpy((rows * rows).sum(1).astype(np.float32))
    n = rows.shape[0]
    eps = fused._sweep_eps(q, norms, n, metric=metric, d_pad=d,
                           accum="mma").double().numpy()
    l2 = metric.value == "l2"
    vn = norms.numpy() if l2 else np.zeros(n, np.float32)
    for i in range(len(xq)):
        acc = (mma_chain(qh[i], rows).astype(np.float32)
               + mma_chain(ql[i], rows).astype(np.float32))    # fp32, RN
        got = (np.float32(2) * acc if l2 else acc) - vn
        exact = rows @ xq[i].astype(np.float64)
        if l2:
            exact = 2.0 * exact - vn.astype(np.float64)
        err = np.abs(got - exact)
        assert bool((err <= eps[i]).all()), (name, i)
        if name == "truncation":
            qn = np.linalg.norm(qh[i]) + np.linalg.norm(ql[i])
            fmaf_term = (d + 2) * U * qn * np.linalg.norm(rows, axis=1)
            assert bool((err > (2.0 if l2 else 1.0) * fmaf_term)[:2].all())


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("adversary", ["truncation", "cancellation", "skewed"])
@pytest.mark.parametrize("d", [128, 136])
def test_emulated_one_plane_sweep_within_mma_eps(metric, jmetric, adversary,
                                                 d):
    """K2's arithmetic emulated: the one accumulator q1·v of the model's
    worst case (``mma_chain``; q1 the query rounded to bf16, RNE) and the
    epilogue, against the exact score of the stored bf16 row: within
    _sweep_eps(single_pass=True, accum="mma") on the truncation,
    cancellation and skewed adversaries. On the truncation adversary the
    emulated error exceeds the fmaf budget's accumulation term (2), so the
    tensor-core term is needed for the one-plane sweep too."""
    name, a, rows = [c for c in _adversaries(d) if c[0] == adversary][0]
    # fp32 queries that round to the bf16-valued a (the first is a itself)
    rng = np.random.default_rng(d)
    xq = np.stack([a] + [a * (1.0 + rng.uniform(-1, 1, a.shape) * 2.0 ** -10)
                         for _ in range(2)]).astype(np.float32)
    q = torch.from_numpy(xq)
    q1 = q.to(torch.bfloat16).double().numpy()
    assert np.array_equal(q1[0], a)
    norms = torch.from_numpy((rows * rows).sum(1).astype(np.float32))
    n = rows.shape[0]
    eps = fused._sweep_eps(q, norms, n, metric=metric, d_pad=d,
                           single_pass=True, accum="mma").double().numpy()
    l2 = metric.value == "l2"
    vn = norms.numpy() if l2 else np.zeros(n, np.float32)
    for i in range(len(xq)):
        acc = mma_chain(q1[i], rows).astype(np.float32)
        got = (np.float32(2) * acc if l2 else acc) - vn
        exact = rows @ xq[i].astype(np.float64)
        if l2:
            exact = 2.0 * exact - vn.astype(np.float64)
        err = np.abs(got - exact)
        assert bool((err <= eps[i]).all()), (name, i)
        if name == "truncation":
            fmaf_term = ((d + 2) * U * np.linalg.norm(q1[i])
                         * np.linalg.norm(rows, axis=1))
            assert bool((err > (2.0 if l2 else 1.0) * fmaf_term)[:2].all())


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("adversary", ["truncation", "cancellation", "skewed"])
@pytest.mark.parametrize("d", [128, 136])
def test_emulated_f32_one_plane_sweep_within_mma_eps(metric, jmetric,
                                                     adversary, d):
    """K4's arithmetic emulated: f32 rows v = w·(1 + 2^-12) for the
    adversary's bf16-valued rows w, so that both planes are non-zero (the
    bit-mask split gives dh = w and dl = w·2^-12, exactly), q1 the query
    rounded to bf16 (RNE), the two accumulators q1·dh and q1·dl of the
    model's worst case (``mma_chain``) added once in fp32, and the
    epilogue, against the exact score of the stored f32 row: within
    _sweep_eps(single_pass=True, pair_sweep=True, accum="mma") with the
    f32 split statistics on the truncation, cancellation and skewed
    adversaries. On the truncation adversary the emulated error exceeds
    the fmaf budget's accumulation term, so the tensor-core term is needed
    for K4 too."""
    name, a, rows = [c for c in _adversaries(d) if c[0] == adversary][0]
    db = torch.from_numpy((rows * (1.0 + 2.0 ** -12)).astype(np.float32))
    hi, lo = split_f32_bf16(db)
    dh, dl = hi.double().numpy(), lo.double().numpy()
    v = db.double().numpy()
    assert np.array_equal(dh, rows) and np.array_equal(dh + dl, v)
    assert np.abs(dl).sum() > 0
    stats = split_stats(db, hi, lo)
    # fp32 queries that round to the bf16-valued a (the first is a itself)
    rng = np.random.default_rng(d + 2)
    xq = np.stack([a] + [a * (1.0 + rng.uniform(-1, 1, a.shape) * 2.0 ** -10)
                         for _ in range(2)]).astype(np.float32)
    q = torch.from_numpy(xq)
    q1 = q.to(torch.bfloat16).double().numpy()
    assert np.array_equal(q1[0], a)
    norms = (db * db).sum(-1)
    n = v.shape[0]
    eps = fused._sweep_eps(q, norms, n, metric=metric, d_pad=d,
                           single_pass=True, pair_sweep=True,
                           split_stats=stats, accum="mma").double().numpy()
    l2 = metric.value == "l2"
    vn = norms.numpy() if l2 else np.zeros(n, np.float32)
    for i in range(len(xq)):
        acc = (mma_chain(q1[i], dh).astype(np.float32)
               + mma_chain(q1[i], dl).astype(np.float32))     # fp32, RN
        got = (np.float32(2) * acc if l2 else acc) - vn
        exact = v @ xq[i].astype(np.float64)
        if l2:
            exact = 2.0 * exact - vn.astype(np.float64)
        err = np.abs(got - exact)
        assert bool((err <= eps[i]).all()), (name, i)
        if name == "truncation":
            fmaf_term = ((d + 2) * U * np.linalg.norm(q1[i])
                         * np.linalg.norm(v, axis=1))
            assert bool((err > (2.0 if l2 else 1.0) * fmaf_term)[:2].all())


def _f16_rows(rows):
    """The f16 rows the store keeps for ``rows`` (RNE, subnormals flushed):
    their bits, their exact values (float64) and fp32 norms."""
    bits = flush_f16_subnormals(encode_f16_bits(
        torch.from_numpy(np.asarray(rows, np.float32))))
    v = decode_f16_bits(bits)
    assert bool(torch.isfinite(v).all())
    return bits, v.double().numpy(), (v * v).sum(-1)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("adversary", ["truncation", "cancellation", "skewed"])
@pytest.mark.parametrize("d", [128, 136])
def test_emulated_f16_pair_sweep_within_mma_eps(metric, jmetric, adversary,
                                                d):
    """K6's arithmetic emulated: the rows as f16 stores them, split to their
    exact bf16 pair (``split_f16_bits``), the three accumulators qh·dh,
    qh·dl, ql·dh of the model's worst case (``mma_chain``) added left to
    right in fp32, and the epilogue, against the exact score of the stored
    f16 row: within _sweep_eps(pair_sweep=True, accum="mma") with the f16
    split statistics on the truncation, cancellation and skewed
    adversaries. The pair is exact (dh + dl == v, s1 = 0), and on the
    truncation adversary the emulated error exceeds the fmaf budget's
    accumulation term, so the tensor-core term is needed there."""
    name, a, rows = [c for c in _adversaries(d) if c[0] == adversary][0]
    bits, v, norms = _f16_rows(rows)
    dh, dl = (p.double().numpy() for p in split_f16_bits(bits))
    assert np.array_equal(dh + dl, v)
    stats = split_stats(torch.from_numpy(v).float(),
                        *split_f32_bf16(torch.from_numpy(v).float()))
    assert float(stats[1]) == 0.0
    xq = np.stack([_near_bf16_query(a, seed) for seed in range(3)])
    q = torch.from_numpy(xq)
    qh, ql = (p.double().numpy() for p in split_f32_bf16(q))
    n = v.shape[0]
    eps = fused._sweep_eps(q, norms, n, metric=metric, d_pad=d,
                           pair_sweep=True, split_stats=stats,
                           accum="mma").double().numpy()
    l2 = metric.value == "l2"
    vn = norms.numpy() if l2 else np.zeros(n, np.float32)
    for i in range(len(xq)):
        t1 = mma_chain(qh[i], dh).astype(np.float32)
        t2 = mma_chain(qh[i], dl).astype(np.float32)
        t3 = mma_chain(ql[i], dh).astype(np.float32)
        acc = (t1 + t2) + t3                                 # fp32, RN
        got = (np.float32(2) * acc if l2 else acc) - vn
        exact = v @ xq[i].astype(np.float64)
        if l2:
            exact = 2.0 * exact - vn.astype(np.float64)
        err = np.abs(got - exact)
        assert bool((err <= eps[i]).all()), (name, i)
        if name == "truncation":
            qn = np.linalg.norm(qh[i]) + np.linalg.norm(ql[i])
            fmaf_term = (d + 2) * U * qn * np.linalg.norm(v, axis=1)
            assert bool((err > (2.0 if l2 else 1.0) * fmaf_term)[:2].all())


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("adversary", ["truncation", "cancellation", "skewed"])
@pytest.mark.parametrize("d", [96, 128, 136])
def test_emulated_f16_native_sweep_within_mma_eps(metric, jmetric, adversary,
                                                  d):
    """K6's arithmetic emulated: the rows as f16 stores them, used whole
    (f16×f16 products are exact in fp32); the query's f16 split
    (``split_f32_f16``): the two accumulators qh·v and ql·v of the model's
    worst case (``mma_chain``) in each plane's scaled space, each times its
    power of two (exact) and the two added once in fp32, and the epilogue,
    against the exact score of the stored f16 row: within
    _sweep_eps(f16_planes=, accum="mma") on the truncation,
    cancellation and skewed adversaries (d 96: the f16 cell's width). On
    the truncation adversary, for the query whose hi plane is its
    bf16-valued a (lo plane zero), the emulated error exceeds the fmaf
    budget's accumulation term, so the tensor-core term is needed there
    too."""
    name, a, rows = [c for c in _adversaries(d) if c[0] == adversary][0]
    bits, v, norms = _f16_rows(rows)
    xq = np.stack([a.astype(np.float32)]
                  + [_near_bf16_query(a, seed) for seed in range(3)])
    q = torch.from_numpy(xq)
    hi, lo, sc = split_f32_f16(q)
    qh, ql = hi.double().numpy(), lo.double().numpy()
    sc = sc.numpy()
    assert np.array_equal(qh[0] * np.float64(sc[0, 0]), a)
    assert (np.abs(ql[1:]).sum(axis=1) > 0).all()
    n = v.shape[0]
    eps = fused._sweep_eps(q, norms, n, metric=metric, d_pad=d,
                           pair_sweep=True, accum="mma",
                           f16_planes=(hi, lo, torch.from_numpy(sc))
                           ).double().numpy()
    l2 = metric.value == "l2"
    vn = norms.numpy() if l2 else np.zeros(n, np.float32)
    for i in range(len(xq)):
        t1 = mma_chain(qh[i], v).astype(np.float32) * sc[i, 0]
        t2 = mma_chain(ql[i], v).astype(np.float32) * sc[i, 1]
        acc = t1 + t2                                        # fp32, RN
        got = (np.float32(2) * acc if l2 else acc) - vn
        exact = v @ xq[i].astype(np.float64)
        if l2:
            exact = 2.0 * exact - vn.astype(np.float64)
        err = np.abs(got - exact)
        assert bool((err <= eps[i]).all()), (name, i)
        if name == "truncation" and i == 0:
            fmaf_term = ((d + 2) * U * np.linalg.norm(xq[i].astype(np.float64))
                         * np.linalg.norm(v, axis=1))
            assert bool((err > (2.0 if l2 else 1.0) * fmaf_term)[:2].all())


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("adversary", ["truncation", "cancellation", "skewed"])
@pytest.mark.parametrize("d", [128, 136])
def test_emulated_f16_one_plane_sweep_within_mma_eps(metric, jmetric,
                                                     adversary, d):
    """K7's arithmetic emulated: the rows as f16 stores them, split to their
    exact bf16 pair (``split_f16_bits``), q1 the query rounded to bf16
    (RNE), the two accumulators q1·dh and q1·dl of the model's worst case
    (``mma_chain``) added once in fp32 (acc = q1·dh; acc += q1·dl), and the
    epilogue, against the exact score of the stored f16 row: within
    _sweep_eps(single_pass=True, pair_sweep=True, accum="mma") with the f16
    split statistics on the truncation, cancellation and skewed
    adversaries. On the truncation adversary the emulated error exceeds
    the fmaf budget's accumulation term, so the tensor-core term is needed
    for the one-plane f16 sweep too."""
    name, a, rows = [c for c in _adversaries(d) if c[0] == adversary][0]
    bits, v, norms = _f16_rows(rows)
    dh, dl = (p.double().numpy() for p in split_f16_bits(bits))
    assert np.array_equal(dh + dl, v)
    stats = split_stats(torch.from_numpy(v).float(),
                        *split_f32_bf16(torch.from_numpy(v).float()))
    assert float(stats[1]) == 0.0
    # fp32 queries that round to the bf16-valued a (the first is a itself)
    rng = np.random.default_rng(d + 1)
    xq = np.stack([a] + [a * (1.0 + rng.uniform(-1, 1, a.shape) * 2.0 ** -10)
                         for _ in range(2)]).astype(np.float32)
    q = torch.from_numpy(xq)
    q1 = q.to(torch.bfloat16).double().numpy()
    assert np.array_equal(q1[0], a)
    n = v.shape[0]
    eps = fused._sweep_eps(q, norms, n, metric=metric, d_pad=d,
                           single_pass=True, pair_sweep=True,
                           split_stats=stats, accum="mma").double().numpy()
    l2 = metric.value == "l2"
    vn = norms.numpy() if l2 else np.zeros(n, np.float32)
    for i in range(len(xq)):
        acc = (mma_chain(q1[i], dh).astype(np.float32)
               + mma_chain(q1[i], dl).astype(np.float32))     # fp32, RN
        got = (np.float32(2) * acc if l2 else acc) - vn
        exact = v @ xq[i].astype(np.float64)
        if l2:
            exact = 2.0 * exact - vn.astype(np.float64)
        err = np.abs(got - exact)
        assert bool((err <= eps[i]).all()), (name, i)
        if name == "truncation":
            fmaf_term = ((d + 2) * U * np.linalg.norm(q1[i])
                         * np.linalg.norm(v, axis=1))
            assert bool((err > (2.0 if l2 else 1.0) * fmaf_term)[:2].all())
