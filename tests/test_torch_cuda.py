"""faiss_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA card. The module
imports neither jax nor faiss_tpu, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX.) Tolerances: selects equal
bit for bit; sweep and rescore within the query's two-plane ε, which bounds
the accumulation error of both sides (f32 planes: the pair sweep's ε, and
ε₂ of ``_pair_rescore_eps`` for the pair rescore).

int8 (K5 ``sweep_int8``, K10's int8 mode) and f16 (K6 ``sweep_f16_2``, K7
``sweep_f16_1``, K10's f16 mode): K5 equals its plain version bit for bit
(exact integer dots, then the same three roundings in the same order); the
f16 sweeps on the tensor cores, with accum="mma": K7 within the pair ε,
K6 (an f16 wgmma over the stored rows against the f16 query split,
``storage.split_f32_f16``) within the ε of that split
(``_sweep_eps(f16_planes=)``), its split equal to the CPU's bit for
bit; the rescores within the rescore term of their bound
(``rescore_term``); the in-kernel f16 decode equals the plain decode on
all 65,536 patterns, in K10 and in K7, and K6 reads every pattern as the
IEEE f16 value its twin reads.

f16 NaN sign: ``encode_f16_bits`` on the card equals the CPU (the card's
own f32 → f16 conversion turns every NaN into 0x7fff, so a negative NaN
would decode to +inf), and a bf16 or f16 store holds the CPU's bits on the
device route and on the native host route.

K10's f32-rows mode (``rescore_groups_f32``, the IVF fine scan, chunk-major
after a grouping pass on the card) within the rescore term, on random and
adversarial rows, with chunk ids past the pool clamped, runs longer than a
block's positions, and every position dead at chunk 0; it does not wait
for the device; TorchIndexIVFFlat on the card against the same index on
the CPU (integer data: exact scores, so ids and distances equal).

The certificate soundness cases (``check_sweep_eps_sound``,
``check_pair_eps_sound``, ``check_sweep_eps_sound_f16``,
``check_int8_eps_sound``) take a device: tests/test_torch_f32.py,
test_torch_f16.py and test_torch_int8.py run them on the plain versions on
the CPU, this module on the kernels.

K10's pair mode (``rescore_groups_pair``, stage 3a, streamed by TMA
through persistent blocks) within ε₂ at d 8 to 256 and kg 1 to 40, on ids
repeated across and within queries and clamped ids.

K3, K4, K1, K2, K6 and K7 run on the tensor cores (``csrc/sweep_split_mma.cu``):
they are held to ``_sweep_eps(accum="mma")`` (the budget of
tests/test_torch_mma_eps.py, which ``fused.sweep_accum`` picks for them),
their supergroup maxes bit for bit, also on the truncation adversary's
rows; K5 runs there on the integer tensor cores, bit for bit. The sharded
indexes over one card named P times give the unsharded index's ids. K9 (``csrc/final_select.cu``) and K8 (``csrc/select_groups.cu``),
both one pass, equal their plain versions bit for bit (K8's t by value on
a NaN row) on tie-heavy, −inf, NaN, ±0 and +inf rows and K8's −inf
re-pick; K11 and K10 → K9 agree bit for bit on a −0.0 / +0.0 tie.

The search programs (``programs.py``): every flat search (f32, pair, bf16,
f16, int8; L2 and IP; with a selector; both fallback tiers, also on
duplicated rows whose certificate fails at nq = 100) and every IVF route
is a CUDA graph in the index's TorchResources, and its replays equal the
eager search bit for bit (distances, id bits, certificate); 16 tokens in
flight each keep their own result; a replay adds the launch counts of an
eager run; a capture that meets a host synchronisation raises. So do the
sites that followed: the sharded flat search over one card named P times
(f32, int8, f16, a selector, both fallback tiers: one graph a search), the
sharded IVF search (the fine scan and the dense routes), flat and IVF
range passes at two radii (the second replays, no new program) and at the
rerun's capacity, and the IVF coarse assign; a shard changed under a
sharded index drops its programs, and a sharded capture that meets a host
synchronisation raises with nothing cached.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from faiss_tpu_torch import MetricType, TorchIndexFlat, programs
from faiss_tpu_torch.ops import distance, fused, kernels
from faiss_tpu_torch.storage import (decode_f16_bits, encode_f16_bits,
                                     flush_f16_subnormals,
                                     split_f32_bf16, split_f32_f16,
                                     split_stats)

pytestmark = pytest.mark.cuda

METRICS = [MetricType.L2, MetricType.INNER_PRODUCT]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _db(dev, nv, d, ntotal, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((nv, d), generator=g)
    x[ntotal:] = 0
    return (x.to(torch.bfloat16).to(dev).contiguous(),
            (x * x).sum(-1).to(dev))


def _within_eps(a, b, eps):
    fin = torch.isfinite(b)
    assert torch.equal(fin, torch.isfinite(a))
    err = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    eps = eps if eps.dim() == 2 else eps[:, None]   # per entry, or per row
    assert bool((err <= eps).all()), float(err.max())


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("nq,d,passes", [(8, 8, 2), (37, 136, 1),
                                         (104, 128, 1), (104, 128, 2)])
def test_sweep_and_rescore_match_plain(dev, metric, nq, d, passes):
    nv, ntotal = 8192, 8000
    db, norms = _db(dev, nv, d, ntotal)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(1)).to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    # two query planes run K1 on the tensor cores: its ε is the mma one
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           accum=fused.sweep_accum("bf16", passes, dev))
    qh, ql = fused.query_planes(q, passes)
    n0 = kernels.launches[f"sweep_groupmax_{passes}"]
    gm = kernels.sweep_groupmax(qh, ql, db, vn, metric=metric)
    assert kernels.launches[f"sweep_groupmax_{passes}"] == n0 + 1
    _within_eps(gm, fused.sweep_groupmax_plain(qh, ql, db, vn, metric=metric),
                eps)
    gidx, t = kernels.select_groups(gm, 14)
    s = kernels.rescore_groups(q, db, vn, gidx, metric=metric)
    _within_eps(s, fused.rescore_groups_plain(q, db, vn, gidx, metric=metric),
                eps)
    torch.cuda.synchronize()


@pytest.mark.parametrize("ncols,kg", [(7816, 14), (300, 40), (12, 12),
                                      (16384, 5)])
def test_selects_match_plain_bitwise(dev, ncols, kg):
    g = torch.Generator().manual_seed(ncols)
    x = torch.randint(0, 4, (24, ncols), generator=g).float()
    x[1] = float("-inf")
    x[2, kg // 2:] = float("-inf")
    x[3, ::2] = float("-inf")
    x = x.to(dev)
    gi, t = kernels.select_groups(x, kg)
    gi_p, t_p = fused.select_groups_plain(x, kg)
    assert torch.equal(gi, gi_p) and torch.equal(t, t_p)
    k = min(kg, 10)
    v, p = kernels.final_select(x, k)
    v_p, p_p = fused.final_select_plain(x, k)
    assert torch.equal(p, p_p) and torch.equal(v, v_p)


def _k9_rows(ncand: int, seed: int) -> torch.Tensor:
    """Rows for K9: tie-heavy integers, all −inf, partly −inf, ±0 ties
    (with and without larger values), a NaN among integers, all NaN,
    Gaussian, all equal, and +inf ties."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 4, (12, ncand), generator=g).float()
    x[1] = float("-inf")
    x[2, ::3] = float("-inf")
    signs = torch.rand((ncand,), generator=g) < 0.5
    x[3] = torch.where(signs, -0.0, 0.0)
    x[4] = torch.where(signs, -0.0, -1.0)
    x[4, ncand // 3] = 0.0
    x[5, ncand // 2] = float("nan")
    x[6] = float("nan")
    x[7] = torch.randn((ncand,), generator=g)
    x[8] = 5.0
    x[9, ::2] = float("inf")
    x[10] = torch.where(signs, 0.0, -0.0)
    x[10, -1] = 1.0
    return x


K9_CASES = [(nc, k) for nc in (32, 37, 1792, 16384) for k in (1, 10, 40)
            if k < nc]


def _k8_rows(ncols: int, seed: int) -> torch.Tensor:
    """Rows for K8: _k9_rows' (tie-heavy, all −inf, partly −inf, ±0 ties, a
    NaN, all NaN, Gaussian, all equal, +inf ties), then the −inf re-pick
    (fewer than kg finite columns) with column 0 finite and with column 0
    −inf, a −0.0 column 0 among −inf, and the ±0 ties below larger
    values."""
    x = _k9_rows(ncols, seed)
    extra = torch.full((4, ncols), float("-inf"))
    few = torch.arange(min(5, ncols))
    extra[0, few * (ncols // 5)] = torch.tensor([1.0, 3.0, -2.0, 3.0, 0.5])[
        : len(few)]
    extra[1, few * (ncols // 5) + (ncols > 5)] = 2.0
    extra[1, 0] = float("-inf")
    extra[2, 0] = -0.0
    g = torch.Generator().manual_seed(seed + 1)
    signs = torch.rand((ncols,), generator=g) < 0.5
    extra[3] = torch.where(signs, -0.0, 0.0)
    extra[3, ::7] = 1.0
    return torch.cat([x, extra])


# (nq, ngroups, kg): the flat phase 2's (104, 7816, 14), the f32 stage 3a's
# (104, 1792, 32), the widest (24, 16384, 40), and kg = ngroups and ragged
# widths in the four-rows-a-block layout
K8_CASES = [(104, 7816, 14), (104, 1792, 32), (24, 16384, 40), (4, 12, 12),
            (5, 37, 36)]


@pytest.mark.parametrize("nq,ngroups,kg", K8_CASES)
def test_group_select_one_pass_bitwise(dev, nq, ngroups, kg):
    """K8 against select_groups_plain: ids bit for bit, t equal by value
    (its bits too, but on a NaN row, where both are NaN) on _k8_rows, taken
    nq rows at a time (the last batch filled with Gaussian rows)."""
    rows = _k8_rows(ngroups, seed=ngroups + kg)
    g = torch.Generator().manual_seed(kg)
    for i in range(0, rows.shape[0], nq):
        x = torch.randn((nq, ngroups), generator=g)
        part = rows[i:i + nq]
        x[: part.shape[0]] = part
        x = x.to(dev)
        n0 = kernels.launches["select_groups"]
        gi, t = kernels.select_groups(x, kg)
        assert kernels.launches["select_groups"] == n0 + 1
        gi_p, t_p = fused.select_groups_plain(x, kg)
        assert torch.equal(gi, gi_p)
        nan = t_p.isnan()
        assert torch.equal(nan, t.isnan())
        assert torch.equal(t[~nan].view(torch.int32),
                           t_p[~nan].view(torch.int32))


def test_group_select_refuses_kg_past_40(dev):
    with pytest.raises(ValueError):
        kernels.select_groups(torch.zeros((4, 100), device=dev), 41)


@pytest.mark.parametrize("ncand,k", K9_CASES)
def test_final_select_one_pass_bitwise(dev, ncand, k):
    """K9 against final_select_plain bit for bit, values included (the
    column's own −0.0 or +0.0 on a zero tie; float('nan') on a NaN row),
    at the main path's widths 32 and 1792, ncand 37 (the scalar loads) and
    16384 (one row a block)."""
    x = _k9_rows(ncand, seed=ncand + k).to(dev)
    n0 = kernels.launches["final_select"]
    v, p = kernels.final_select(x, k)
    assert kernels.launches["final_select"] == n0 + 1
    v_p, p_p = fused.final_select_plain(x, k)
    assert torch.equal(p, p_p)
    assert torch.equal(v.view(torch.int32), v_p.view(torch.int32))
    assert bool((p[6] == ncand - 1).all()) and bool(v[6].isnan().all())
    assert torch.equal(p[1], torch.arange(k, dtype=torch.int32, device=dev))


def test_final_select_refuses_k_past_40(dev):
    with pytest.raises(ValueError):
        kernels.final_select(torch.zeros((4, 100), device=dev), 41)


@pytest.mark.parametrize("neg_first", [True, False])
def test_rescore_select_keeps_the_sign_of_a_zero_tie(dev, neg_first):
    """A −0.0 / +0.0 tie at the top of every query's candidates: a row whose
    products underflow to −0.0 (1e-30 · −1e-30), a zero row (+0.0), all
    others below zero (IP). K11 and K10 → K9 emit the lower column's own
    zero, bit for bit the same, and the ids of the plain chain."""
    nv, d, nq, k = 1024, 64, 4, 3
    x = np.full((nv, d), -1.0, np.float32)
    neg = np.full(d, -1e-30, np.float32)
    x[0], x[1] = (neg, 0.0) if neg_first else (0.0, neg)
    db = torch.from_numpy(x).to(torch.bfloat16).to(dev)
    norms = torch.from_numpy((x.astype(np.float64) ** 2).sum(1)).float()
    metric = MetricType.INNER_PRODUCT
    vn = fused._premask_norms(norms.to(dev), nv, nv, metric)
    q = torch.full((nq, d), 1e-30, device=dev)
    gidx = torch.arange(nv // 128, dtype=torch.int32, device=dev)
    gidx = gidx[None, :].repeat(nq, 1).contiguous()
    vals, ids = kernels.rescore_select_groups(q, db, vn, gidx, nv, k=k,
                                              metric=metric)
    s = kernels.rescore_groups(q, db, vn, gidx, metric=metric)
    v2, p2 = kernels.final_select(
        s.masked_fill(fused.candidate_drop(gidx, nv), float("-inf")), k)
    ids2 = torch.gather(fused.candidate_columns(gidx), 1, p2.to(torch.int64))
    assert torch.equal(vals.view(torch.int32), v2.view(torch.int32))
    assert torch.equal(ids, ids2)
    zero = torch.tensor(-0.0 if neg_first else 0.0, device=dev)
    assert bool((vals[:, 0].view(torch.int32) == zero.view(torch.int32)).all())
    assert bool((ids[:, :2] == torch.tensor([0, 1], device=dev)).all())
    _, ip = fused.rescore_select_groups_plain(q, db, vn, gidx, nv, k=k,
                                              metric=metric)
    assert torch.equal(ids, ip)


def test_selects_stay_in_bounds_on_nan(dev):
    x = torch.randn((4, 500), device=dev)
    x[0, 17] = float("nan")
    x[1] = float("nan")
    gi, t = kernels.select_groups(x, 14)
    v, p = kernels.final_select(x, 10)
    torch.cuda.synchronize()
    assert int(gi.min()) >= 0 and int(gi.max()) < 500
    assert int(p.min()) >= 0 and int(p.max()) < 500
    gi_p, _ = fused.select_groups_plain(x, 14)
    _, p_p = fused.final_select_plain(x, 10)
    assert torch.equal(gi, gi_p) and torch.equal(p, p_p)


def test_wrappers_check_inputs(dev):
    gm = torch.zeros((8, 64), device=dev)
    with pytest.raises(ValueError):
        kernels.select_groups(gm, 65)             # kg > ngroups
    with pytest.raises(TypeError):
        kernels.final_select(gm.double(), 4)
    with pytest.raises(ValueError):
        kernels.final_select(gm.T, 4)              # not contiguous
    db = torch.zeros((1024, 12), dtype=torch.bfloat16, device=dev)
    q = torch.zeros((8, 12), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):                # d % 8 != 0
        kernels.sweep_groupmax(q, None, db, torch.zeros(1024, device=dev),
                               metric=MetricType.L2)


def test_plain_scores_stay_fp32_under_callers_tf32(dev):
    """With the caller's TF32 on, the plain path's products are still true
    fp32 (TF32 errs ~1e-3 here, fp32 ~1e-6), and the setting survives."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        db, _ = _db(dev, 4096, 128, 4096)
        q = torch.randn((16, 128), generator=torch.Generator().manual_seed(2))
        q = q.to(dev)
        s = distance.matmul_scores(q, db, None, MetricType.INNER_PRODUCT)
        ref = q.double() @ db.double().T
        assert float((s.double() - ref).abs().max()) < 1e-4
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[1])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_index_fused_matches_plain(dev, metric, monkeypatch):
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((50_000, 96), dtype=np.float32)
    xq = rng.standard_normal((40, 96), dtype=np.float32)
    idx = TorchIndexFlat(96, metric=metric, storage="bf16", device=dev)
    idx.add(xb)
    before = dict(kernels.launches)
    D1, I1 = idx.search(xq, 10)
    assert all(kernels.launches[n] > before[n] for n in
               ("sweep_groupmax_1", "select_groups", "rescore_groups",
                "final_select"))
    assert idx.fused_fallbacks == 0
    idx.set_force_plain(True)
    D2, I2 = idx.search(xq, 10)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-3)


def test_search_async_does_not_wait_for_the_device(dev, monkeypatch):
    """Enqueueing a search makes no host synchronisation: with ~0.5 s of
    device work queued ahead, search_async returns at once."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(4)
    idx = TorchIndexFlat(64, storage="bf16", device=dev)
    idx.add(rng.standard_normal((20_000, 64), dtype=np.float32))
    xq = rng.standard_normal((16, 64), dtype=np.float32)
    D0, I0 = idx.search(xq, 10)
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    tok = idx.search_async(xq, 10)
    enqueue_s = time.perf_counter() - t0
    assert not tok.is_ready()
    D1, I1 = tok.wait()
    assert enqueue_s < 0.1, enqueue_s
    np.testing.assert_array_equal(I1, I0)
    np.testing.assert_array_equal(D1, D0)


# -- f32 storage: the pair sweep (K3, K4) and the pair rescore --------------

# the f32 rows of tests/test_property_selection.py's adversarial cases:
# (sweep passes, metric, db scale, const groups), and (metric, db scale)
CERT_CASES_F32 = [
    (2, MetricType.L2, 1.0, True),
    (2, MetricType.L2, 1e4, True),       # norm-skewed
    (1, MetricType.L2, 1e4, False),
    (2, MetricType.INNER_PRODUCT, 1e4, True),
]
T2_CASES = [
    (MetricType.L2, 1.0),
    (MetricType.L2, 316.0),              # norm-skewed
    (MetricType.INNER_PRODUCT, 1.0),
]


def _f32_db(x: np.ndarray, dev):
    db = torch.from_numpy(x).to(dev)
    hi, lo = split_f32_bf16(db)
    return db, hi, lo, split_stats(db, hi, lo), (db * db).sum(-1)


def _planted(xb):
    xb[7] = xb[3] * (1 + np.float32(2.0 ** -22))   # a planted near-tie
    return xb


@pytest.mark.parametrize("d", [8, 128, 136, 256])
@pytest.mark.parametrize("kg", [1, 14, 40])
def test_k10_pair_streaming_matches_plain(dev, d, kg):
    """K10's pair mode (stage 3a, streamed by TMA through the persistent
    blocks) against its plain version within ε₂, both metrics, at nq 300:
    more positions than the persistent grid holds at every kg but 1 (and
    there, more than a block a position on a small card); group ids that
    repeat across queries (every third query names query 0's), that repeat
    within a query, and that lie past either end (clamped by the kernel:
    the same scores bit for bit as the clamped ids, which the plain version
    is given); d 8 and 136: a last d slice shorter than 64 (TMA's zero
    fill is never read); a last group only partly stored."""
    nv, ntotal, nq = 8192, 8000, 300
    ngroups = nv // 128
    g = torch.Generator().manual_seed(100 * d + kg)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    db, hi, lo, stats, norms = _f32_db(x.numpy(), dev)
    q = torch.randn((nq, d), generator=g).to(dev)
    raw = torch.randint(0, ngroups, (nq, kg), generator=g, dtype=torch.int32)
    raw[::3] = raw[0]
    raw[1, -1] = raw[1, 0]
    raw[4, 0], raw[5, -1], raw[7, 0] = -3, ngroups + 11, 1 << 30
    gc = raw.clamp(0, ngroups - 1).to(dev)
    raw = raw.to(dev)
    for metric in METRICS:
        vn = fused._premask_norms(norms, ntotal, nv, metric)
        n0 = kernels.launches["rescore_groups_pair"]
        s = kernels.rescore_groups(q, hi, vn, raw, metric=metric, db2=lo)
        assert kernels.launches["rescore_groups_pair"] == n0 + 1
        sc = kernels.rescore_groups(q, hi, vn, gc, metric=metric, db2=lo)
        assert torch.equal(s.view(torch.int32), sc.view(torch.int32))
        eps2 = fused._pair_rescore_eps(q, norms, nv, metric=metric, d_pad=d,
                                       split_stats=stats)
        _within_eps(s, fused.rescore_groups_plain(q, hi, vn, gc,
                                                  metric=metric, db2=lo),
                    eps2)
    torch.cuda.synchronize()


def check_sweep_eps_sound(dev, case: int, nq: int = 64) -> None:
    """|sweep group max − best exact master score of the group| ≤ ε for
    every (query, group); with const groups every row of a group is the
    same, so the check is pointwise. k = nv nominates every group, so the
    search rescores every row (the single-stage f32 branch). On the card
    two query planes run K3 on the tensor cores: ε with accum="mma"."""
    passes, metric, scale, const = CERT_CASES_F32[case]
    nv, d = 2048, 128
    rng = np.random.default_rng(9000 + case)
    if const:
        xb = np.repeat(rng.standard_normal((nv // 128, d)).astype(np.float32),
                       128, axis=0)
    else:
        xb = rng.standard_normal((nv, d)).astype(np.float32)
    xb = _planted(xb * np.float32(scale))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    q = q.to(dev)
    db, hi, lo, stats, norms = _f32_db(xb, dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    gm = fused.groupmax_scores(q, db, vn, metric=metric, sweep_passes=passes,
                               db_split=(hi, lo))
    vals, ids, cert = fused.fused_search(
        q, db, norms, nv, k=nv, metric=metric, nv_eff=nv, sweep_passes=passes,
        db_split=(hi, lo), split_stats=stats)
    assert bool(cert.all())              # every group nominated: trivial
    s = torch.full((nq, nv), float("nan"), device=dev)
    s.scatter_(1, ids.to(torch.int64), vals)
    assert not bool(s.isnan().any())
    resc_gmax = s.view(nq, nv // 128, 128).amax(-1)
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=passes == 1, pair_sweep=True,
                           split_stats=stats,
                           accum=fused.sweep_accum("pair", passes,
                                                   dev))[:, None]
    gap = (resc_gmax - gm).abs()
    assert bool((gap <= eps).all()), float((gap - eps).max())
    assert float(eps.max()) >= float(gap.max())


def check_pair_eps_sound(dev, case: int, nq: int = 64) -> None:
    """|pair rescore − exact master rescore| ≤ ε₂ for every stored row."""
    metric, scale = T2_CASES[case]
    nv, d = 1024, 128
    rng = np.random.default_rng(7000 + case)
    xb = _planted(rng.standard_normal((nv, d)).astype(np.float32)
                  * np.float32(scale))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    q = q.to(dev)
    db, hi, lo, stats, norms = _f32_db(xb, dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    gidx = torch.arange(nv // 128, dtype=torch.int32, device=dev)
    gidx = gidx[None, :].repeat(nq, 1)
    s_pair = kernels.rescore_groups(q, hi, vn, gidx, metric=metric, db2=lo)
    s_exact = fused.rescore_exact(q, db, norms, fused.candidate_columns(gidx),
                                  metric=metric)
    eps2 = fused._pair_rescore_eps(q, norms, nv, metric=metric, d_pad=d,
                                   split_stats=stats)[:, None]
    gap = (s_pair - s_exact).abs()
    assert bool((gap <= eps2).all()), float((gap - eps2).max())
    assert float(eps2.max()) >= float(gap.max())


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("nq,d,passes", [(8, 8, 1), (37, 136, 2),
                                         (37, 136, 1), (104, 128, 2)])
def test_split_sweep_and_pair_rescore_match_plain(dev, metric, nq, d, passes):
    """K3 (two query planes) and K4 (one), both on the tensor cores (the
    MMA ε), against sweep_split_plain, and the pair rescore against its plain version, at
    odd shapes: nq 37, d 136, and a last group only partly stored (ntotal
    8000 of 8192)."""
    nv, ntotal = 8192, 8000
    g = torch.Generator().manual_seed(d)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    db, hi, lo, stats, norms = _f32_db(x.numpy(), dev)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(1)).to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    qh, ql = fused.query_planes(q, passes)
    name = f"sweep_split_{passes + 1}"
    n0 = kernels.launches[name]
    gm = kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric)
    assert kernels.launches[name] == n0 + 1
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=passes == 1, pair_sweep=True,
                           split_stats=stats, accum="mma")
    _within_eps(gm, fused.sweep_split_plain(qh, ql, hi, lo, vn, metric=metric),
                eps)
    gidx, _ = kernels.select_groups(gm, 14)
    n0 = kernels.launches["rescore_groups_pair"]
    s = kernels.rescore_groups(q, hi, vn, gidx, metric=metric, db2=lo)
    assert kernels.launches["rescore_groups_pair"] == n0 + 1
    eps2 = fused._pair_rescore_eps(q, norms, nv, metric=metric, d_pad=d,
                                   split_stats=stats)
    _within_eps(s, fused.rescore_groups_plain(q, hi, vn, gidx, metric=metric,
                                              db2=lo), eps2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", range(len(CERT_CASES_F32)))
def test_sweep_eps_sound_on_kernels(dev, case):
    check_sweep_eps_sound(dev, case, nq=256)


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("d", [8, 136, 128, 1024])
@pytest.mark.parametrize("nq", [8, 37, 104, 300])
def test_k3_tensor_core_sweep_matches_plain(dev, metric, nq, d):
    """K3 on the tensor cores against sweep_split_plain within
    _sweep_eps(accum="mma"), with a last group partly stored (ntotal 8000 of
    8192) and one wholly past ntotal; its supergroup maxes equal
    block_max_plain of the same launch's gm bit for bit, and that gm the
    one-output launch's. nq 300: three query tiles; d 8 and 136: the
    zero-filled k-tail; d 1024: the query planes ride the ring."""
    nv, ntotal = 8192, 8000
    g = torch.Generator().manual_seed(nq * 10_000 + d)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    db, hi, lo, stats, norms = _f32_db(x.numpy(), dev)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(nq))
    q = q.to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    qh, ql = fused.query_planes(q, 2)
    n0 = dict(kernels.launches)
    gm, bmax = kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric,
                                   with_block_max=True)
    assert kernels.launches["sweep_split_3"] == n0["sweep_split_3"] + 1
    assert kernels.launches["sweep_split_2"] == n0["sweep_split_2"]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           pair_sweep=True, split_stats=stats, accum="mma")
    _within_eps(gm, fused.sweep_split_plain(qh, ql, hi, lo, vn, metric=metric),
                eps)
    assert bool(torch.isneginf(gm[:, -1]).all())
    assert not bool(torch.isneginf(gm[:, :-1]).any())
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))
    one = kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric)
    assert torch.equal(gm.view(torch.int32), one.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("d", [8, 72, 128, 136, 1024, 2048])
@pytest.mark.parametrize("nq", [8, 104, 300])
def test_k4_tensor_core_sweep_matches_plain(dev, metric, nq, d):
    """K4 (one query plane over the f32 planes) on the tensor cores against
    sweep_split_plain within _sweep_eps(single_pass=True, accum="mma"),
    with a last group partly stored (ntotal 8000 of 8192) and one wholly
    past ntotal; its supergroup maxes equal block_max_plain of the same
    launch's gm bit for bit, and that gm the one-output launch's; it counts
    as sweep_split_2 and launches no K3. d 72 and 136: the zero-filled
    k-tail; d 128: q1 as A fragments in registers; d ≥ 1024: the query
    plane rides the ring."""
    nv, ntotal = 8192, 8000
    g = torch.Generator().manual_seed(nq * 10_000 + d + 7)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    db, hi, lo, stats, norms = _f32_db(x.numpy(), dev)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(nq + 1))
    q = q.to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    q1, none = fused.query_planes(q, 1)
    assert none is None
    n0 = dict(kernels.launches)
    gm, bmax = kernels.sweep_split(q1, None, hi, lo, vn, metric=metric,
                                   with_block_max=True)
    assert kernels.launches["sweep_split_2"] == n0["sweep_split_2"] + 1
    assert kernels.launches["sweep_split_3"] == n0["sweep_split_3"]
    assert fused.sweep_accum("pair", 1, dev) == "mma"
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=True, pair_sweep=True,
                           split_stats=stats, accum="mma")
    _within_eps(gm, fused.sweep_split_plain(q1, None, hi, lo, vn,
                                            metric=metric), eps)
    assert bool(torch.isneginf(gm[:, -1]).all())
    assert not bool(torch.isneginf(gm[:, :-1]).any())
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))
    one = kernels.sweep_split(q1, None, hi, lo, vn, metric=metric)
    assert torch.equal(gm.view(torch.int32), one.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_k4_truncation_adversary_within_mma_eps(dev, metric):
    """The truncation adversary of tests/test_torch_mma_eps.py on K4: the
    bf16-valued query [1, s, …, s] (q1 is the query itself) against f32
    rows w·(1 + 2^-12), w = [1, −s, …, −s] scaled per group by 2^j, so that
    both planes are non-zero (dh = w, dl = w·2^-12): |group max − exact
    score| ≤ _sweep_eps(single_pass=True, accum="mma") pointwise (every row
    of a group is the same), and the supergroup maxes bit for bit."""
    d, nv, nq = 128, 1024, 8
    s = np.float32(2.0 ** -12 * 1.4140625)
    a = np.full(d, s, np.float32)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = np.repeat(2.0 ** np.arange(nv // 128), 128).astype(np.float32)
    xb = (row[None, :] * scale[:, None]
          * np.float32(1.0 + 2.0 ** -12)).astype(np.float32)
    db, hi, lo, stats, norms = _f32_db(xb, dev)
    assert bool((lo != 0).any())
    q = torch.from_numpy(np.tile(a, (nq, 1))).to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    q1, _ = fused.query_planes(q, 1)
    n0 = kernels.launches["sweep_split_2"]
    gm, bmax = kernels.sweep_split(q1, None, hi, lo, vn, metric=metric,
                                   with_block_max=True)
    assert kernels.launches["sweep_split_2"] == n0 + 1
    dot = (xb[::128].astype(np.float64) @ a.astype(np.float64))
    exact = torch.from_numpy(dot).to(dev)[None, :].expand(nq, -1)
    if metric is MetricType.L2:
        exact = 2.0 * exact - norms[::128].double()[None, :]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=True, pair_sweep=True,
                           split_stats=stats, accum="mma")
    gap = (gm.double() - exact).abs()
    assert bool((gap <= eps[:, None].double()).all()), float(gap.max())
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_k3_truncation_adversary_within_mma_eps(dev, metric):
    """The truncation adversary of tests/test_torch_mma_eps.py on K3: the
    query [1, s, …, s] and rows [1, −s, …, −s] (s² just under ulp(1), so a
    truncating sum drops every product but the first; group j's rows scaled
    per group by 2^j): |group max − exact score| ≤ _sweep_eps(accum="mma")
    pointwise (every row of a group is the same)."""
    d, nv, nq = 128, 1024, 8
    s = np.float32(2.0 ** -12 * 1.4140625)
    a = np.full(d, s, np.float32)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = np.repeat(2.0 ** np.arange(nv // 128), 128).astype(np.float32)
    xb = row[None, :] * scale[:, None]
    db, hi, lo, stats, norms = _f32_db(xb, dev)
    q = torch.from_numpy(np.tile(a, (nq, 1))).to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    gm = fused.groupmax_scores(q, db, vn, metric=metric, sweep_passes=2,
                               db_split=(hi, lo))
    dot = (xb[::128].astype(np.float64) @ a.astype(np.float64))
    exact = torch.from_numpy(dot).to(dev)[None, :].expand(nq, -1)
    if metric is MetricType.L2:
        exact = 2.0 * exact - norms[::128].double()[None, :]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           pair_sweep=True, split_stats=stats, accum="mma")
    gap = (gm.double() - exact).abs()
    assert bool((gap <= eps[:, None].double()).all()), float(gap.max())


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("d", [8, 72, 136, 128, 1024])
@pytest.mark.parametrize("nq", [8, 37, 104, 300])
def test_k1_tensor_core_sweep_matches_plain(dev, metric, nq, d):
    """K1 (bf16 rows, two query planes) on the tensor cores against
    sweep_groupmax_plain within _sweep_eps(accum="mma"), with a last group
    partly stored (ntotal 8000 of 8192) and one wholly past ntotal; its
    supergroup maxes equal block_max_plain of the same launch's gm bit for
    bit, and that gm the one-output launch's. nq 300: three query tiles; d
    72 and 128: the query planes as A fragments in registers (72: with a
    zero-filled k-tail); d 8 and 136: the k-tail from shared memory; d
    1024: the query planes ride the ring."""
    nv, ntotal = 8192, 8000
    db, norms = _db(dev, nv, d, ntotal, seed=nq * 10_000 + d)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(nq))
    q = q.to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    qh, ql = fused.query_planes(q, 2)
    n0 = dict(kernels.launches)
    gm, bmax = kernels.sweep_groupmax(qh, ql, db, vn, metric=metric,
                                      with_block_max=True)
    assert kernels.launches["sweep_groupmax_2"] == n0["sweep_groupmax_2"] + 1
    assert kernels.launches["sweep_split_3"] == n0["sweep_split_3"]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d, accum="mma")
    _within_eps(gm, fused.sweep_groupmax_plain(qh, ql, db, vn, metric=metric),
                eps)
    assert bool(torch.isneginf(gm[:, -1]).all())
    assert not bool(torch.isneginf(gm[:, :-1]).any())
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))
    one = kernels.sweep_groupmax(qh, ql, db, vn, metric=metric)
    assert torch.equal(gm.view(torch.int32), one.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_k1_truncation_adversary_within_mma_eps(dev, metric):
    """The truncation adversary of tests/test_torch_mma_eps.py on K1: bf16
    rows [1, −s, …, −s] scaled per group by 2^j against the query [1, s,
    …, s] (bf16-valued: its lo plane is zero): |group max − exact score| ≤
    _sweep_eps(accum="mma") pointwise (every row of a group is the same)."""
    d, nv, nq = 128, 1024, 8
    s = np.float32(2.0 ** -12 * 1.4140625)
    a = np.full(d, s, np.float32)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = np.repeat(2.0 ** np.arange(nv // 128), 128).astype(np.float32)
    xb = row[None, :] * scale[:, None]
    db = torch.from_numpy(xb).to(dev)
    assert torch.equal(db.to(torch.bfloat16).float(), db)
    norms = (db.double() ** 2).sum(-1).float()
    q = torch.from_numpy(np.tile(a, (nq, 1))).to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    gm = fused.groupmax_scores(q, db.to(torch.bfloat16), vn, metric=metric,
                               sweep_passes=2)
    dot = (xb[::128].astype(np.float64) @ a.astype(np.float64))
    exact = torch.from_numpy(dot).to(dev)[None, :].expand(nq, -1)
    if metric is MetricType.L2:
        exact = 2.0 * exact - norms[::128].double()[None, :]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d, accum="mma")
    gap = (gm.double() - exact).abs()
    assert bool((gap <= eps[:, None].double()).all()), float(gap.max())


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("block_max", [False, True], ids=["gm", "bmax"])
@pytest.mark.parametrize("d", [64, 128, 136, 256])
@pytest.mark.parametrize("nq", [8, 104, 200])
def test_k2_tensor_core_sweep_matches_plain(dev, metric, nq, d, block_max):
    """K2 (bf16 rows, one query plane) on the tensor cores against
    sweep_groupmax_plain within _sweep_eps(single_pass=True, accum="mma"),
    with a last group partly stored (ntotal 8000 of 8192) and one wholly
    past ntotal; with the block max, its supergroup maxes equal
    block_max_plain of the same launch's gm bit for bit, and that gm the
    one-output launch's. nq 200: two query tiles; d 128: the query plane as
    A fragments in registers; d 64: one chunk, from shared memory; d 136
    (a bf16 row is a multiple of 8 elements): with a zero-filled k-tail; d
    256: four resident chunks."""
    nv, ntotal = 8192, 8000
    db, norms = _db(dev, nv, d, ntotal, seed=nq * 1_000 + d)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(d))
    q = q.to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    qh, ql = fused.query_planes(q, 1)
    assert ql is None
    n0 = dict(kernels.launches)
    out = kernels.sweep_groupmax(qh, None, db, vn, metric=metric,
                                 with_block_max=block_max)
    gm = out[0] if block_max else out
    assert kernels.launches["sweep_groupmax_1"] == n0["sweep_groupmax_1"] + 1
    assert kernels.launches["sweep_groupmax_2"] == n0["sweep_groupmax_2"]
    assert fused.sweep_accum("bf16", 1, dev) == "mma"
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=True, accum="mma")
    _within_eps(gm, fused.sweep_groupmax_plain(qh, None, db, vn,
                                               metric=metric), eps)
    assert bool(torch.isneginf(gm[:, -1]).all())
    assert not bool(torch.isneginf(gm[:, :-1]).any())
    if block_max:
        assert torch.equal(out[1].view(torch.int32),
                           fused.block_max_plain(gm).view(torch.int32))
        one = kernels.sweep_groupmax(qh, None, db, vn, metric=metric)
        assert torch.equal(gm.view(torch.int32), one.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_k2_truncation_adversary_within_mma_eps(dev, metric):
    """The truncation adversary of tests/test_torch_mma_eps.py on K2: bf16
    rows [1, −s, …, −s] scaled per group by 2^j against the query [1, s,
    …, s] (bf16-valued, so q1 is the query), one query plane:
    |group max − exact score| ≤ _sweep_eps(single_pass=True, accum="mma")
    pointwise (every row of a group is the same)."""
    d, nv, nq = 128, 1024, 8
    s = np.float32(2.0 ** -12 * 1.4140625)
    a = np.full(d, s, np.float32)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = np.repeat(2.0 ** np.arange(nv // 128), 128).astype(np.float32)
    xb = row[None, :] * scale[:, None]
    db = torch.from_numpy(xb).to(dev)
    assert torch.equal(db.to(torch.bfloat16).float(), db)
    norms = (db.double() ** 2).sum(-1).float()
    q = torch.from_numpy(np.tile(a, (nq, 1))).to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    n0 = kernels.launches["sweep_groupmax_1"]
    gm = fused.groupmax_scores(q, db.to(torch.bfloat16), vn, metric=metric,
                               sweep_passes=1)
    assert kernels.launches["sweep_groupmax_1"] == n0 + 1
    dot = (xb[::128].astype(np.float64) @ a.astype(np.float64))
    exact = torch.from_numpy(dot).to(dev)[None, :].expand(nq, -1)
    if metric is MetricType.L2:
        exact = 2.0 * exact - norms[::128].double()[None, :]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=True, accum="mma")
    gap = (gm.double() - exact).abs()
    assert bool((gap <= eps[:, None].double()).all()), float(gap.max())


def test_bf16_search_launch_counts(dev, monkeypatch):
    """A bf16 index's search at nq 8 on the card sweeps two query planes
    from the start: one launch each of K1 (on the tensor cores), K8, K10
    and K9, none of K2 or K3, and no fallback under the mma ε."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(12)
    idx = TorchIndexFlat(64, storage="bf16", device=dev)
    idx.add(rng.standard_normal((20_000, 64), dtype=np.float32))
    kernels.reset_launches()
    idx.search(rng.standard_normal((8, 64), dtype=np.float32), 10)
    n = dict(kernels.launches)
    assert idx.fused_fallbacks == 0
    assert n["sweep_groupmax_1"] == 0 and n["sweep_split_3"] == 0, n
    for key in ("sweep_groupmax_2", "select_groups", "rescore_groups",
                "final_select"):
        assert n[key] == 1, n


def test_f32_search_runs_the_tensor_core_sweep(dev, monkeypatch):
    """An f32 index's search on the card sweeps with K3 (two query planes,
    the tensor cores), never K4, and certifies every query."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(11)
    idx = TorchIndexFlat(64, device=dev)
    idx.add(rng.standard_normal((20_000, 64), dtype=np.float32))
    kernels.reset_launches()
    idx.search(rng.standard_normal((40, 64), dtype=np.float32), 10)
    n = dict(kernels.launches)
    assert n["sweep_split_3"] == 1 and n["sweep_split_2"] == 0, n
    assert n["final_select"] == 1 and idx.fused_fallbacks == 0


@pytest.mark.parametrize("case", range(len(T2_CASES)))
def test_pair_eps_sound_on_kernels(dev, case):
    check_pair_eps_sound(dev, case, nq=256)


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("keep_master", [True, False])
def test_index_f32_fused_matches_plain(dev, metric, keep_master, monkeypatch):
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((50_000, 96), dtype=np.float32)
    xq = rng.standard_normal((40, 96), dtype=np.float32)
    idx = TorchIndexFlat(96, metric=metric, device=dev,
                         keep_master=keep_master)
    idx.add(xb)
    before = dict(kernels.launches)
    D1, I1 = idx.search(xq, 10)
    assert all(kernels.launches[n] > before[n] for n in
               ("sweep_split_3", "select_groups", "rescore_groups_pair",
                "final_select"))
    assert idx.fused_fallbacks == 0
    idx.set_force_plain(True)
    D2, I2 = idx.search(xq, 10)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-3)


def test_index_f32_integer_data_takes_hi_exact(dev, monkeypatch):
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(6)
    xb = rng.integers(0, 256, (50_000, 128)).astype(np.float32)
    xq = rng.integers(0, 256, (40, 128)).astype(np.float32)
    idx = TorchIndexFlat(128, device=dev)
    idx.add(xb)
    assert "hi_exact=True" in idx.describe()
    before = dict(kernels.launches)
    D1, I1 = idx.search(xq, 10)
    # one query plane over the hi plane: K2, on the tensor cores, and its
    # certificate under the mma term passes every query of integer data
    assert fused.sweep_accum("hi_exact", 1, dev) == "mma"
    assert kernels.launches["sweep_groupmax_1"] > before["sweep_groupmax_1"]
    assert kernels.launches["sweep_groupmax_2"] == before["sweep_groupmax_2"]
    assert kernels.launches["sweep_split_3"] == before["sweep_split_3"]
    assert kernels.launches["rescore_groups"] > before["rescore_groups"]
    assert idx.fused_fallbacks == 0
    idx.set_force_plain(True)
    D2, I2 = idx.search(xq, 10)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)


# -- int8 storage: K5 and K10's int8 mode -----------------------------------


def rescore_term(q, v_max, norms, nv, d, metric):
    """(nq,) bound on |rescore − rescore'| for two fp32-true rescores of
    the same rows: each errs ≤ d·u·‖q‖·V, plus the epilogues (the rescore
    terms (3)-(5) of ``_sweep_eps``). ``q``: the fp32 query the rescore
    multiplies (q∘s for int8), ``v_max``: max‖v‖ of the rows it reads."""
    Q = torch.sqrt(torch.sum(q * q, dim=-1))
    N = torch.amax(norms[:nv])
    return fused._epilogue_eps(2.0 * d * fused._U32 * Q * v_max, Q, v_max, N,
                               metric)


def rescore_term_rows(q, rows, gidx, d, metric):
    """(nq, nb·128) ``rescore_term`` entry by entry, in fp64: ‖q‖ of the
    entry's query, ‖v‖ and ‖v‖² of the one row it scores (row gidx·128 +
    r of ``rows``). A pool's largest row does not loosen the bound of the
    others, so a rescore that drops or truncates part of d fails on the
    ordinary rows beside huge ones."""
    q, rows = q.to(torch.float64), rows.to(torch.float64)
    Q = torch.sqrt(torch.sum(q * q, dim=-1))[:, None]
    r = (gidx.to(torch.int64)[:, :, None] * 128
         + torch.arange(128, device=gidx.device)).reshape(gidx.shape[0], -1)
    N = torch.sum(rows * rows, dim=-1)[r]
    V = torch.sqrt(N)
    return fused._epilogue_eps(2.0 * d * fused._U32 * Q * V, Q, V, N, metric)


def int8_db(dev, nv, d, ntotal, seed=0):
    """Random codes in [-127, 127] with edge rows: all +127, all -127, a
    zero row, alternating ±127; rows past ntotal zero. Returns (codes,
    scales, decoded norms, int_norm_max) on ``dev``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (nv, d)).astype(np.int8)
    codes[1], codes[2], codes[3] = 127, -127, 0
    codes[4] = np.where(np.arange(d) % 2 == 0, 127, -127)
    codes[ntotal:] = 0
    scales = (rng.random(d).astype(np.float32) + 0.5) / 127.0
    c = torch.from_numpy(codes).to(dev)
    s = torch.from_numpy(scales).to(dev)
    dec = c.to(torch.float32) * s[None, :]
    cf = c.to(torch.float32)
    return (c, s, torch.sum(dec * dec, dim=-1),
            torch.sqrt(torch.amax(torch.sum(cf * cf, dim=-1))))


def _equal_or_same_nonfinite(a, b):
    fin = torch.isfinite(b)
    assert torch.equal(fin, torch.isfinite(a))
    assert bool((a[fin] == b[fin]).all()), float((a[fin] - b[fin]).abs().max())
    assert bool((a[~fin].nan_to_num() == b[~fin].nan_to_num()).all())


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("nq,d", [(8, 16), (37, 144), (104, 128), (16, 1152)])
def test_int8_sweep_and_rescore_match_plain(dev, metric, nq, d):
    """K5 equal to its plain version bit for bit on edge codes (±127 rows,
    a zero row, rows past ntotal; d 1152 passes 2^24 in the int32 dots);
    K10's int8 mode within its rescore term, the masked rows −inf."""
    nv, ntotal = 8192, 8000
    codes, scales, norms, inm = int8_db(dev, nv, d, ntotal, seed=d)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(1))
    q = (q * 3.0).to(dev)
    q[0] = 1.0 / scales                    # q∘s all ones: q₁ all 127
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    q1, q2, b1, b2 = fused.int8_query_pair(q, scales)
    beta = torch.stack([b1, b2], dim=1)
    n0 = kernels.launches["sweep_int8"]
    gm = kernels.sweep_int8(q1, q2, codes, vn, beta, metric=metric)
    assert kernels.launches["sweep_int8"] == n0 + 1
    _equal_or_same_nonfinite(
        gm, fused.sweep_int8_plain(q1, q2, codes, vn, beta, metric=metric))
    gidx, _ = kernels.select_groups(gm, 14)
    gidx[:, -1] = nv // 128 - 1            # the partly stored last group
    gidx = torch.sort(gidx, dim=1)[0].contiguous()
    qs = q * scales[None, :]
    n0 = kernels.launches["rescore_groups_int8"]
    s = kernels.rescore_groups(qs, codes, vn, gidx, metric=metric)
    assert kernels.launches["rescore_groups_int8"] == n0 + 1
    s_p = fused.rescore_groups_plain(qs, codes, vn, gidx, metric=metric)
    assert bool(torch.isneginf(s[:, -128:]).all())   # group 63: past ntotal
    _within_eps(s, s_p, rescore_term(qs, inm, norms, nv, d, metric))
    torch.cuda.synchronize()


def check_int8_eps_sound(dev, metric, d: int = 1152, nq: int = 8):
    """|int8 sweep − rescore| ≤ ε (``_sweep_eps_int8``) on every row of
    adversarial codes: rows of ±127 (a few ±125) sharing the queries' sign
    pattern, so the exact dots a_i pass 2^24 and their conversions to f32
    round (at d = 1152). Groups hold one row 128 times, so the check is
    pointwise; k = nv nominates every group. Returns (ε, a₁) for the
    caller's checks."""
    nv = 2048
    rng = np.random.default_rng(d)
    sign = np.where(rng.random(d) < 0.5, -1, 1)
    base = np.where(rng.random((nv // 128, d)) < 0.03, -1, 1) * sign
    mag = np.where(rng.random((nv // 128, d)) < 0.05, 125, 127)
    codes = np.repeat((base * mag).astype(np.int8), 128, axis=0)
    xq = (sign * (1.0 + 0.02 * rng.random((nq, d)))).astype(np.float32)
    c = torch.from_numpy(codes).to(dev)
    scales = torch.ones((d,), device=dev)
    cf = c.to(torch.float32)
    norms = torch.sum(cf * cf, dim=-1)
    inm = torch.sqrt(torch.amax(norms))
    q = torch.from_numpy(xq).to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    gm = fused.int8_groupmax_scores(q, c, vn, scales, metric=metric)
    vals, ids, cert = fused.fused_search(
        q, c, norms, nv, k=nv, metric=metric, nv_eff=nv, scales=scales,
        int_norm_max=inm)
    assert bool(cert.all())
    s = torch.full((nq, nv), float("nan"), device=dev)
    s.scatter_(1, ids.to(torch.int64), vals)
    resc_gmax = s.view(nq, nv // 128, 128).amax(-1)
    eps = fused._sweep_eps_int8(q, scales, inm, norms, nv, metric=metric,
                                d_pad=d)
    gap = (resc_gmax - gm).abs()
    assert bool((gap <= eps[:, None]).all()), float((gap - eps[:, None]).max())
    q1 = fused.int8_query_pair(q, scales)[0]
    a1 = q1.to(torch.float64) @ c[::128].to(torch.float64).T
    return eps, a1


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_int8_eps_sound_on_kernels(dev, metric):
    _, a1 = check_int8_eps_sound(dev, metric, nq=64)
    assert float(a1.abs().max()) > 2 ** 24


# -- f16 storage: K6, K7 and K10's f16 mode ----------------------------------


def f16_db(dev, x: np.ndarray):
    """f16 rows as the store keeps them: RNE, subnormals flushed; the fp32
    norms of the input; the split statistics of the decoded pair."""
    xd = torch.from_numpy(x).to(dev)
    bits = flush_f16_subnormals(encode_f16_bits(xd))
    v32 = decode_f16_bits(bits)
    return (bits, (xd * xd).sum(-1),
            split_stats(v32, *split_f32_bf16(v32)))


def f16_sweep_planes(q, passes):
    """((q_hi, q_lo, scales), f16_planes): the f16 rows' sweep planes as
    ``fused_search`` makes them on q's device: with two passes on the card
    the f16 split (K6), which the certificate reads too
    (``_sweep_eps(f16_planes=)``); else ``query_planes``' bf16 planes."""
    accum = fused.sweep_accum("f16", passes, q.device)
    if fused.sweep_query_split("f16", passes, accum) == "f16":
        planes = split_f32_f16(q)
        return planes, planes
    return (*fused.query_planes(q, passes), None), None


def all_f16_patterns(dev):
    """The 65,536 f16 bit patterns as a float16 tensor."""
    return torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.float16).to(dev)


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("nq,d,passes", [(8, 8, 2), (37, 136, 1),
                                         (37, 136, 2), (104, 128, 1),
                                         (104, 128, 2)])
def test_f16_sweep_and_rescore_match_plain(dev, metric, nq, d, passes):
    """K6 (two f16 planes) and K7 (one bf16 plane), both on the tensor
    cores, within the ε of their split (``sweep_query_split``: K6's f16
    split, K7's pair) with the tensor-core term (``sweep_accum``), K10's
    f16 mode within its rescore term, on finite rows; a last group partly
    stored."""
    nv, ntotal = 8192, 8000
    g = torch.Generator().manual_seed(d)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    bits, norms, stats = f16_db(dev, x.numpy())
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(1)).to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    (qh, ql, sc), fp = f16_sweep_planes(q, passes)
    name = f"sweep_f16_{passes}"
    n0 = kernels.launches[name]
    gm = kernels.sweep_f16(qh, ql, bits, vn, metric=metric, scales=sc)
    assert kernels.launches[name] == n0 + 1
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=passes == 1, pair_sweep=True,
                           split_stats=stats,
                           accum=fused.sweep_accum("f16", passes, dev),
                           f16_planes=fp)
    _within_eps(gm, fused.sweep_f16_plain(qh, ql, bits, vn, metric=metric,
                                          scales=sc), eps)
    gidx, _ = kernels.select_groups(gm, 14)
    gidx[:, -1] = nv // 128 - 1
    gidx = torch.sort(gidx, dim=1)[0].contiguous()
    n0 = kernels.launches["rescore_groups_f16"]
    s = kernels.rescore_groups(q, bits, vn, gidx, metric=metric)
    assert kernels.launches["rescore_groups_f16"] == n0 + 1
    assert bool(torch.isneginf(s[:, -128:]).all())   # group 63: past ntotal
    v_max = torch.sqrt(torch.amax(norms)) * fused._QUANT_V
    _within_eps(s, fused.rescore_groups_plain(q, bits, vn, gidx,
                                              metric=metric),
                rescore_term(q, v_max, norms, nv, d, metric))
    torch.cuda.synchronize()


@pytest.mark.parametrize("passes", [1, 2])
def test_f16_sweeps_on_inf_and_nan_patterns(dev, passes):
    """Rows holding ±inf and NaN patterns (each decodes to ±inf for K7;
    K6 and its twin read them as IEEE f16 values): the kernel's group
    maxes equal the plain version's in place and kind of every non-finite
    entry, and within ε elsewhere (the ε of the finite rows: the clean
    groups)."""
    nv, d, nq = 4096, 64, 40
    rng = np.random.default_rng(passes)
    x = rng.standard_normal((nv, d)).astype(np.float32)
    bits, norms, _ = f16_db(dev, x)
    h = bits.view(torch.int16).clone()
    for r, pat in ((5, 0x7C00), (300, -0x0400), (301, 0x7E01),
                   (302, -0x0100), (2000, 0x7C00), (2000 + 7, -0x0400)):
        h[r, r % d] = pat                  # +inf, -inf, NaN, -NaN, both
    dirty = h.view(torch.float16)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(3))
    q = q.to(dev)
    clean_stats = f16_db(dev, x)[2]
    for metric in METRICS:
        vn = fused._premask_norms(norms, nv, nv, metric)
        (qh, ql, sc), fp = f16_sweep_planes(q, passes)
        gm = kernels.sweep_f16(qh, ql, dirty, vn, metric=metric, scales=sc)
        gm_p = fused.sweep_f16_plain(qh, ql, dirty, vn, metric=metric,
                                     scales=sc)
        fin = torch.isfinite(gm_p)
        assert not bool(fin.all())
        assert torch.equal(fin, torch.isfinite(gm))
        assert bool((gm[~fin].nan_to_num() == gm_p[~fin].nan_to_num()).all())
        eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                               single_pass=passes == 1, pair_sweep=True,
                               split_stats=clean_stats,
                               accum=fused.sweep_accum("f16", passes, dev),
                               f16_planes=fp)
        err = torch.where(fin, (gm - gm_p).abs(), torch.zeros_like(gm))
        assert bool((err <= eps[:, None]).all())


def test_f16_decode_in_kernel_on_every_pattern(dev):
    """The rescore kernel's f16 decode on all 65,536 patterns equals the
    plain decode (NaN → ±inf): row r holds pattern r in column 0 and zeros
    elsewhere, the query is e₀, so each score is 1·f + 0·0 + … = f (no
    inf·0). A −0 pattern scores +0, which compares equal."""
    pats = all_f16_patterns(dev)
    nv, d = pats.shape[0], 8
    db = torch.zeros((nv, d), dtype=torch.float16, device=dev)
    db[:, 0] = pats
    q = torch.zeros((1, d), device=dev)
    q[0, 0] = 1.0
    vn = torch.zeros((nv,), device=dev)
    gidx = torch.arange(nv // 128, dtype=torch.int32, device=dev)[None, :]
    s = kernels.rescore_groups(q, db, vn, gidx.contiguous(),
                               metric=MetricType.INNER_PRODUCT)
    want = decode_f16_bits(pats)
    assert not bool(want.isnan().any())
    assert bool((s[0] == want).all())


# the f16 rows of the soundness cases: (sweep passes, metric, db scale,
# const groups); 1e4 keeps |x| < 65504 (4.5σ at this size)
CERT_CASES_F16 = [
    (2, MetricType.L2, 1.0, True),
    (2, MetricType.L2, 1e4, True),       # norm-skewed
    (1, MetricType.L2, 1e4, False),
    (2, MetricType.INNER_PRODUCT, 1e4, True),
    (1, MetricType.INNER_PRODUCT, 1.0, True),
]


def check_sweep_eps_sound_f16(dev, case: int, nq: int = 64) -> None:
    """|f16 sweep group max − best rescore of the group| ≤ the ε of the
    sweep's query split (``sweep_query_split``: the pair ε with the f16
    split statistics, or on the card with two planes the f16 split's), for
    every (query, group); k = nv nominates every group, so the search
    rescores every row."""
    passes, metric, scale, const = CERT_CASES_F16[case]
    nv, d = 2048, 128
    rng = np.random.default_rng(9100 + case)
    if const:
        xb = np.repeat(rng.standard_normal((nv // 128, d)).astype(np.float32),
                       128, axis=0)
    else:
        xb = rng.standard_normal((nv, d)).astype(np.float32)
    xb = _planted(xb * np.float32(scale))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    q = q.to(dev)
    bits, norms, stats = f16_db(dev, xb)
    vn = fused._premask_norms(norms, nv, nv, metric)
    _, fp = f16_sweep_planes(q, passes)
    gm = fused.groupmax_scores(q, bits, vn, metric=metric, sweep_passes=passes,
                               f16_planes=fp)
    vals, ids, cert = fused.fused_search(
        q, bits, norms, nv, k=nv, metric=metric, nv_eff=nv,
        sweep_passes=passes, split_stats=stats)
    assert bool(cert.all())
    s = torch.full((nq, nv), float("nan"), device=dev)
    s.scatter_(1, ids.to(torch.int64), vals)
    assert not bool(s.isnan().any())
    resc_gmax = s.view(nq, nv // 128, 128).amax(-1)
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=passes == 1, pair_sweep=True,
                           split_stats=stats,
                           accum=fused.sweep_accum("f16", passes, dev),
                           f16_planes=fp)[:, None]
    gap = (resc_gmax - gm).abs()
    assert bool((gap <= eps).all()), float((gap - eps).max())


@pytest.mark.parametrize("case", range(len(CERT_CASES_F16)))
def test_sweep_eps_sound_f16_on_kernels(dev, case):
    check_sweep_eps_sound_f16(dev, case, nq=256)


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("d", [8, 72, 128, 136, 1024])
@pytest.mark.parametrize("nq", [8, 37, 104, 300])
def test_k6_tensor_core_sweep_matches_plain(dev, metric, nq, d):
    """K6 (f16 rows, two f16 query planes) on the tensor cores against
    sweep_f16_plain within _sweep_eps(accum="mma", f16_planes=),
    with a last group partly stored (ntotal 8000 of 8192) and one wholly
    past ntotal; its supergroup maxes equal block_max_plain of the same
    launch's gm bit for bit, and that gm the one-output launch's. nq 300:
    three query tiles; d 8, 72 and 136: the zero-filled k-tail; d 128: the
    query planes as A fragments in registers, the other widths from shared
    memory (d 1024: riding the ring)."""
    nv, ntotal = 8192, 8000
    g = torch.Generator().manual_seed(nq * 10_000 + d)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    bits, norms, stats = f16_db(dev, x.numpy())
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(nq))
    q = q.to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    (qh, ql, sc), fp = f16_sweep_planes(q, 2)
    assert qh.dtype == ql.dtype == torch.float16
    n0 = dict(kernels.launches)
    gm, bmax = kernels.sweep_f16(qh, ql, bits, vn, metric=metric,
                                 with_block_max=True, scales=sc)
    assert kernels.launches["sweep_f16_2"] == n0["sweep_f16_2"] + 1
    assert kernels.launches["sweep_f16_1"] == n0["sweep_f16_1"]
    assert fused.sweep_accum("f16", 2, dev) == "mma"
    assert fused.sweep_query_split("f16", 2, "mma") == "f16"
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           pair_sweep=True, split_stats=stats, accum="mma",
                           f16_planes=fp)
    _within_eps(gm, fused.sweep_f16_plain(qh, ql, bits, vn, metric=metric,
                                          scales=sc), eps)
    assert bool(torch.isneginf(gm[:, -1]).all())
    assert not bool(torch.isneginf(gm[:, :-1]).any())
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))
    one = kernels.sweep_f16(qh, ql, bits, vn, metric=metric, scales=sc)
    assert torch.equal(gm.view(torch.int32), one.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_k6_truncation_adversary_within_mma_eps(dev, metric):
    """The truncation adversary of tests/test_torch_mma_eps.py on K6: f16
    rows [1, −s, …, −s] scaled per group by 2^j (exact in f16) against the
    query [1, s, …, s] (its f16 hi plane the query, scaled; its lo plane
    zero): |group max − exact score| ≤ _sweep_eps(accum="mma",
    f16_planes=), pointwise (every row of a group is the same)."""
    d, nv, nq = 128, 1024, 8
    s = np.float32(2.0 ** -12 * 1.4140625)
    a = np.full(d, s, np.float32)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = np.repeat(2.0 ** np.arange(nv // 128), 128).astype(np.float32)
    xb = row[None, :] * scale[:, None]
    bits, norms, stats = f16_db(dev, xb)
    assert torch.equal(decode_f16_bits(bits), torch.from_numpy(xb).to(dev))
    q = torch.from_numpy(np.tile(a, (nq, 1))).to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    _, fp = f16_sweep_planes(q, 2)
    n0 = kernels.launches["sweep_f16_2"]
    gm = fused.groupmax_scores(q, bits, vn, metric=metric, sweep_passes=2,
                               f16_planes=fp)
    assert kernels.launches["sweep_f16_2"] == n0 + 1
    dot = (xb[::128].astype(np.float64) @ a.astype(np.float64))
    exact = torch.from_numpy(dot).to(dev)[None, :].expand(nq, -1)
    if metric is MetricType.L2:
        exact = 2.0 * exact - norms[::128].double()[None, :]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           pair_sweep=True, split_stats=stats, accum="mma",
                           f16_planes=fp)
    gap = (gm.double() - exact).abs()
    assert bool((gap <= eps[:, None].double()).all()), float(gap.max())


def test_k6_on_every_f16_pattern(dev):
    """K6 on all 65,536 f16 patterns, each alone in a group of its own (row
    0 of group p holds pattern p in column 0; the other rows are zeros,
    masked by a +inf norm), IP, against sweep_f16_plain: K6 reads the
    stored bits as IEEE f16 values, subnormals included, with no decode.
    The query e₀ (its f16 lo plane zero) scores each finite pattern as its
    exact value and each e=31 pattern NaN (0·inf, 0·NaN in ql·v); the
    query (1 + 2^-11)·e₀ (both planes non-zero) scores ±inf by its sign and
    NaN as NaN. Every finite entry equal, every non-finite one of the same
    kind (NaN, +inf, −inf): the tensor cores follow IEEE on inf·0, NaN and
    inf + finite."""
    pats = all_f16_patterns(dev)
    ng, d = pats.shape[0], 8
    h = torch.zeros((ng * 128, d), dtype=torch.int16, device=dev)
    h[::128, 0] = pats.view(torch.int16)
    bits = h.view(torch.float16)
    vn = torch.full((ng * 128,), float("inf"), device=dev)
    vn[::128] = 0.0
    q = torch.zeros((2, d), device=dev)
    q[0, 0] = 1.0
    q[1, 0] = 1.0 + 2.0 ** -11
    (qh, ql, sc), fp = f16_sweep_planes(q, 2)
    assert float(ql[0].abs().max()) == 0.0
    assert float(ql[1, 0]) * float(sc[1, 1]) == 2.0 ** -11
    ip = MetricType.INNER_PRODUCT
    n0 = kernels.launches["sweep_f16_2"]
    gm = kernels.sweep_f16(qh, ql, bits, vn, metric=ip, scales=sc)
    assert kernels.launches["sweep_f16_2"] == n0 + 1
    want = fused.sweep_f16_plain(qh, ql, bits, vn, metric=ip, scales=sc)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(gm))
    assert bool((gm[fin] == want[fin]).all())
    assert torch.equal(gm.isnan(), want.isnan())
    assert torch.equal(gm.isposinf(), want.isposinf())
    assert torch.equal(gm.isneginf(), want.isneginf())
    i16 = pats.view(torch.int16)
    e31 = (i16 & 0x7C00) == 0x7C00
    nan = e31 & ((i16 & 0x3FF) != 0)
    assert bool(gm[0, e31].isnan().all()) and not bool(gm[0, ~e31].isnan().any())
    assert bool(gm[1, nan].isnan().all())
    inf = e31 & ~nan
    assert torch.equal(gm[1, inf], decode_f16_bits(pats[inf]))
    assert bool((gm[0, ~e31] == decode_f16_bits(pats[~e31])).all())


def _split_rows():
    """fp32 query rows for the f16 split: normalised, spread over 2^-60 …
    2^60, at f16's and fp32's limits, zero, and holding ±inf or NaN."""
    g = torch.Generator().manual_seed(25)
    x = torch.randn((40, 96), generator=g)
    x[:16] /= torch.linalg.vector_norm(x[:16], dim=1, keepdim=True)
    x[16:24] *= torch.exp2(torch.randint(-60, 61, (8, 96), generator=g)
                           .float())
    x[24, :8] = torch.tensor([65504.0, 65519.0, 65520.0, 1e5, 6e-8, 5.96e-8,
                              -1e-30, 3.4e38])
    x[25, :4] = torch.tensor([1e-40, -2e-41, 1e-45, 5e-39])
    x[25, 4:] = 0.0
    x[26] = 0.0
    x[27, 3], x[28, 5], x[29, 0] = float("inf"), float("-inf"), float("nan")
    return x


def test_f16_split_on_the_card_equals_the_cpu(dev):
    """``split_f32_f16`` on the card gives the CPU's planes and scales bit
    for bit on every finite row (every step is exact), and on a row
    holding ±inf or NaN the same kind of entry in each place (the card's
    own f32 → f16 conversion writes NaN as 0x7fff); on the card
    the f16 route with two passes takes this split."""
    x = _split_rows()
    cpu = split_f32_f16(x)
    card = split_f32_f16(x.to(dev))
    fin = torch.isfinite(x).all(dim=1)
    for a, b in zip(cpu, card):
        b = b.cpu()
        if a.dtype == torch.float16:
            assert torch.equal(a[fin].view(torch.int16),
                               b[fin].view(torch.int16))
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for kind in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(kind(a[~fin]), kind(b[~fin]))
    assert fused.sweep_query_split(
        "f16", 2, fused.sweep_accum("f16", 2, dev)) == "f16"
    planes, fp = f16_sweep_planes(x.to(dev), 2)
    assert fp is planes
    for a, b in zip(card, planes):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_k6_against_fp64_at_the_cell_width(dev, metric):
    """K6 at d 96 (Deep's width, two k chunks: the query planes as A
    fragments in registers) and nq 104 over normalised f16 rows, for
    queries of norm 1, 1e-15 and 1e15 (the planes' powers of two at both
    ends): |group max − fp64 group max of the stored rows| ≤
    _sweep_eps(accum="mma", f16_planes=) for every (query, group)."""
    nv, d, nq = 65536, 96, 104
    g = torch.Generator().manual_seed(96)
    x = torch.randn((nv, d), generator=g)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    bits, norms, _ = f16_db(dev, x.numpy())
    v = decode_f16_bits(bits).double()
    q = torch.randn((nq, d), generator=g)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    q[40:72] *= 1e-15
    q[72:] *= 1e15
    q = q.to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    _, fp = f16_sweep_planes(q, 2)
    n0 = kernels.launches["sweep_f16_2"]
    gm = fused.groupmax_scores(q, bits, vn, metric=metric, sweep_passes=2,
                               f16_planes=fp)
    assert kernels.launches["sweep_f16_2"] == n0 + 1
    dots = q.double() @ v.T
    s = (2.0 * dots if metric is MetricType.L2 else dots) - vn.double()
    want = s.view(nq, nv // 128, 128).amax(-1)
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d, accum="mma",
                           f16_planes=fp)
    gap = (gm.double() - want).abs()
    assert bool((gap <= eps.double()[:, None]).all()), float(gap.max())


def test_k6_is_the_instance_the_f16_cell_finds(dev):
    """The f16 cell's sweep route finds K6 in a trace by the name prefix
    ``sweep_split_mma_kernel<2, 2,`` (benchmark/configs/deep10m-ip-f16.json):
    one K6 launch at d 96 under the profiler is one kernel of that name,
    the instance with the query planes in registers (``…, false, 2>``)."""
    nv, d, nq = 8192, 96, 104
    rng = np.random.default_rng(3)
    bits, norms, _ = f16_db(dev, rng.standard_normal((nv, d)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    q = q.to(dev)
    ip = MetricType.INNER_PRODUCT
    vn = fused._premask_norms(norms, nv, nv, ip)
    _, fp = f16_sweep_planes(q, 2)
    fused.groupmax_scores(q, bits, vn, metric=ip, sweep_passes=2,
                          f16_planes=fp)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fused.groupmax_scores(q, bits, vn, metric=ip, sweep_passes=2,
                              f16_planes=fp)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if "sweep_split_mma_kernel" in e.name]
    assert names and all("sweep_split_mma_kernel<2, 2, false, 2>" in n
                         for n in names), names


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("d", [8, 72, 128, 136, 1024])
@pytest.mark.parametrize("nq", [8, 37, 104, 300])
def test_k7_tensor_core_sweep_matches_plain(dev, metric, nq, d):
    """K7 (f16 bits, one query plane: q1·dh + q1·dl) on the tensor cores
    against sweep_f16_plain within _sweep_eps(single_pass=True,
    accum="mma") with the f16 split statistics, as K6's test: a last group
    partly stored and one wholly past ntotal, supergroup maxes equal to
    block_max_plain of the same launch's gm bit for bit, and that gm the
    one-output launch's. d 128: q1 as A fragments in registers; the other
    widths from shared memory (d 1024: riding the ring)."""
    nv, ntotal = 8192, 8000
    g = torch.Generator().manual_seed(nq * 10_000 + d + 7)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    bits, norms, stats = f16_db(dev, x.numpy())
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(nq))
    q = q.to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    q1, _ = fused.query_planes(q, 1)
    n0 = dict(kernels.launches)
    gm, bmax = kernels.sweep_f16(q1, None, bits, vn, metric=metric,
                                 with_block_max=True)
    assert kernels.launches["sweep_f16_1"] == n0["sweep_f16_1"] + 1
    assert kernels.launches["sweep_f16_2"] == n0["sweep_f16_2"]
    assert fused.sweep_accum("f16", 1, dev) == "mma"
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=True, pair_sweep=True,
                           split_stats=stats, accum="mma")
    _within_eps(gm, fused.sweep_f16_plain(q1, None, bits, vn, metric=metric),
                eps)
    assert bool(torch.isneginf(gm[:, -1]).all())
    assert not bool(torch.isneginf(gm[:, :-1]).any())
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))
    one = kernels.sweep_f16(q1, None, bits, vn, metric=metric)
    assert torch.equal(gm.view(torch.int32), one.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_k7_truncation_adversary_within_mma_eps(dev, metric):
    """The truncation adversary of tests/test_torch_mma_eps.py on K7: f16
    rows [1, −s, …, −s] scaled per group by 2^j against the query
    [1, s, …, s] (bf16-valued, so q1 is the query), one query plane:
    |group max − exact score| ≤ _sweep_eps(single_pass=True, accum="mma")
    with the f16 statistics, pointwise."""
    d, nv, nq = 128, 1024, 8
    s = np.float32(2.0 ** -12 * 1.4140625)
    a = np.full(d, s, np.float32)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = np.repeat(2.0 ** np.arange(nv // 128), 128).astype(np.float32)
    xb = row[None, :] * scale[:, None]
    bits, norms, stats = f16_db(dev, xb)
    q = torch.from_numpy(np.tile(a, (nq, 1))).to(dev)
    vn = fused._premask_norms(norms, nv, nv, metric)
    n0 = kernels.launches["sweep_f16_1"]
    gm = fused.groupmax_scores(q, bits, vn, metric=metric, sweep_passes=1)
    assert kernels.launches["sweep_f16_1"] == n0 + 1
    dot = (xb[::128].astype(np.float64) @ a.astype(np.float64))
    exact = torch.from_numpy(dot).to(dev)[None, :].expand(nq, -1)
    if metric is MetricType.L2:
        exact = 2.0 * exact - norms[::128].double()[None, :]
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d,
                           single_pass=True, pair_sweep=True,
                           split_stats=stats, accum="mma")
    gap = (gm.double() - exact).abs()
    assert bool((gap <= eps[:, None].double()).all()), float(gap.max())


def test_k7_on_every_f16_pattern(dev):
    """K7 (one query plane) on all 65,536 f16 patterns, each alone in a
    group of its own (row 0 of group p holds pattern p in column 0; the
    other rows are zeros, masked by a +inf norm), IP, against
    sweep_f16_plain: the query e₀ (q1 = e₀) scores each finite pattern as
    its exact value dh + dl and each e=31 pattern ±inf by its sign bit
    (1·dh with dh = ±inf, plus 1·dl = 0). Every finite entry equal, every
    non-finite one of the same kind."""
    pats = all_f16_patterns(dev)
    ng, d = pats.shape[0], 8
    h = torch.zeros((ng * 128, d), dtype=torch.int16, device=dev)
    h[::128, 0] = pats.view(torch.int16)
    bits = h.view(torch.float16)
    vn = torch.full((ng * 128,), float("inf"), device=dev)
    vn[::128] = 0.0
    q = torch.zeros((1, d), device=dev)
    q[0, 0] = 1.0
    q1, none = fused.query_planes(q, 1)
    assert none is None
    ip = MetricType.INNER_PRODUCT
    n0 = kernels.launches["sweep_f16_1"]
    gm = kernels.sweep_f16(q1, None, bits, vn, metric=ip)
    assert kernels.launches["sweep_f16_1"] == n0 + 1
    want = fused.sweep_f16_plain(q1, None, bits, vn, metric=ip)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(gm))
    assert bool((gm[fin] == want[fin]).all())
    assert torch.equal(gm.isposinf(), want.isposinf())
    assert torch.equal(gm.isneginf(), want.isneginf())
    assert not bool(gm.isnan().any())
    e31 = (pats.view(torch.int16) & 0x7C00) == 0x7C00
    assert bool(gm[0, e31].isinf().all())
    assert bool((gm[0, ~e31] == decode_f16_bits(pats[~e31])).all())


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("d", [16, 144, 128, 1152])
@pytest.mark.parametrize("nq", [8, 37, 104, 300])
def test_k5_tensor_core_sweep_bitwise(dev, metric, nq, d):
    """K5 (int8 codes, s8 × s8 wgmma with s32 sums) equal to
    sweep_int8_plain bit for bit on edge codes (±127 rows, a zero row, rows
    past ntotal) with its supergroup maxes equal to block_max_plain of the
    same launch's gm bit for bit, and that gm the one-output launch's. nq
    300: three query tiles; d 16 and 128: the query planes as A fragments
    in registers (one 128-code chunk; 16 with a zero-filled k-tail); d 144:
    two chunks from shared memory; d 1152: the query planes ride the ring,
    and the dots pass 2^24."""
    nv, ntotal = 8192, 8000
    codes, scales, norms, _ = int8_db(dev, nv, d, ntotal, seed=nq + d)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(nq))
    q = (q * 3.0).to(dev)
    q[0] = 1.0 / scales                    # q∘s all ones: q₁ all 127
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    q1, q2, b1, b2 = fused.int8_query_pair(q, scales)
    beta = torch.stack([b1, b2], dim=1)
    n0 = dict(kernels.launches)
    gm, bmax = kernels.sweep_int8(q1, q2, codes, vn, beta, metric=metric,
                                  with_block_max=True)
    assert kernels.launches["sweep_int8"] == n0["sweep_int8"] + 1
    want = fused.sweep_int8_plain(q1, q2, codes, vn, beta, metric=metric)
    assert torch.equal(gm.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isneginf(gm[:, -1]).all())
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))
    one = kernels.sweep_int8(q1, q2, codes, vn, beta, metric=metric)
    assert torch.equal(gm.view(torch.int32), one.view(torch.int32))
    if d == 1152:
        a1 = q1[:1].double() @ codes[1:2].double().T     # 127 · 127 · d
        assert float(a1.abs().max()) > 2 ** 24
    torch.cuda.synchronize()


@pytest.mark.parametrize("storage", ["f16", "int8"])
def test_f16_int8_search_launch_counts(dev, storage, monkeypatch):
    """An f16 or int8 index's search at nq 8 on the card: one launch each of
    the two-plane sweep on the tensor cores (K6 from the start at nq 8; K5),
    K8, the rescore's mode of K10 and K9, none of the one-plane sweep, and
    no fallback (f16: under the mma ε)."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(13)
    idx = TorchIndexFlat(64, storage=storage, device=dev)
    idx.add(rng.standard_normal((20_000, 64), dtype=np.float32))
    kernels.reset_launches()
    idx.search(rng.standard_normal((8, 64), dtype=np.float32), 10)
    n = dict(kernels.launches)
    assert idx.fused_fallbacks == 0
    sweep, resc = (("sweep_f16_2", "rescore_groups_f16") if storage == "f16"
                   else ("sweep_int8", "rescore_groups_int8"))
    assert n["sweep_f16_1"] == 0, n
    for key in (sweep, "select_groups", resc, "final_select"):
        assert n[key] == 1, n
    assert sum(v for k, v in n.items() if k.startswith("sweep_")) == 1, n


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("storage", ["int8", "f16"])
def test_index_int8_f16_fused_matches_plain(dev, metric, storage,
                                            monkeypatch):
    """The index's fused path launches the slice's kernels and returns the
    plain path's ids; int8 auto-trains on the first batch."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((50_000, 96), dtype=np.float32)
    xq = rng.standard_normal((40, 96), dtype=np.float32)
    idx = TorchIndexFlat(96, metric=metric, storage=storage, device=dev)
    idx.add(xb)
    assert idx.is_trained
    want = (("sweep_int8", "rescore_groups_int8") if storage == "int8"
            else ("sweep_f16_1", "rescore_groups_f16"))
    before = dict(kernels.launches)
    D1, I1 = idx.search(xq, 10)
    assert all(kernels.launches[n] > before[n] for n in
               want + ("select_groups", "final_select"))
    idx.set_force_plain(True)
    D2, I2 = idx.search(xq, 10)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-3)


# -- the flat surface: block max (the sweeps' second output), K11 -----------


def _sweep_cases(dev, metric, nq, d, seed):
    """One (name, launch) per sweep format on one random database: each
    launch(with_block_max) calls that format's wrapper. Rows from 7100 on
    are past ntotal: the last supergroup is all −inf."""
    nv, ntotal = 8192, 7100
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((nv, d), generator=g) * 3.0
    x[ntotal:] = 0
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(1)).to(dev)
    db, hi, lo, _, norms = _f32_db(x.numpy(), dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    bf, bits = db.to(torch.bfloat16), f16_db(dev, x.numpy())[0]
    codes, scales, n8, _ = int8_db(dev, nv, d, ntotal, seed=seed)
    vn8 = fused._premask_norms(n8, ntotal, nv, metric)
    cases = []
    for passes in (1, 2):
        qh, ql = fused.query_planes(q, passes)
        (fh, fl, sc), _ = f16_sweep_planes(q, passes)
        cases += [
            (f"sweep_groupmax_{passes}", lambda bm, qh=qh, ql=ql:
             kernels.sweep_groupmax(qh, ql, bf, vn, metric=metric,
                                    with_block_max=bm)),
            (f"sweep_split_{passes + 1}", lambda bm, qh=qh, ql=ql:
             kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric,
                                 with_block_max=bm)),
            (f"sweep_f16_{passes}", lambda bm, fh=fh, fl=fl, sc=sc:
             kernels.sweep_f16(fh, fl, bits, vn, metric=metric,
                               with_block_max=bm, scales=sc))]
    q1, q2, b1, b2 = fused.int8_query_pair(q, scales)
    beta = torch.stack([b1, b2], dim=1)
    cases.append(("sweep_int8", lambda bm: kernels.sweep_int8(
        q1, q2, codes, vn8, beta, metric=metric, with_block_max=bm)))
    return cases


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("nq,d", [(8, 16), (37, 144), (104, 128)])
def test_block_max_equals_amax_of_group_max(dev, metric, nq, d):
    """Every sweep format's second output equals the plain amax over the
    (nq, ngroups/8, 8) view of the same launch's gm, bit for bit (a max is
    exact), including the all −inf supergroup past ntotal; the gm of a
    block-max launch equals that of a plain launch; each such launch counts
    once in sweep_block_max."""
    for name, launch in _sweep_cases(dev, metric, nq, d, seed=d):
        n0 = dict(kernels.launches)
        gm, bmax = launch(True)
        assert kernels.launches[name] == n0[name] + 1
        assert kernels.launches["sweep_block_max"] == \
            n0["sweep_block_max"] + 1
        want = fused.block_max_plain(gm)
        assert bmax.shape == (nq, 8)
        assert torch.equal(bmax, want), name
        assert torch.equal(bmax.view(torch.int32), want.view(torch.int32))
        assert bool(torch.isneginf(bmax[:, -1]).all())
        assert not bool(torch.isneginf(bmax[:, :-1]).any())
        assert torch.equal(gm, launch(False)), name
    torch.cuda.synchronize()


def test_block_max_refuses_ragged_supergroups(dev):
    q = torch.zeros((8, 16), dtype=torch.bfloat16, device=dev)
    db = torch.zeros((1152, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):            # 9 groups: not a multiple of 8
        kernels.sweep_groupmax(q, None, db, torch.zeros(1152, device=dev),
                               metric=MetricType.L2, with_block_max=True)


def _dup_rows(nv, d, seed):
    """Every row four times (exact ties everywhere), as
    tests/test_pallas_fused.py:524 builds them."""
    rng = np.random.default_rng(seed)
    return np.tile(rng.standard_normal((nv // 4, d)).astype(np.float32),
                   (4, 1))


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "f16"])
@pytest.mark.parametrize("k", [1, 12, 32])
def test_rescore_select_matches_rescore_then_final_select(dev, metric, fmt, k):
    """K11 equals K10 → the ntotal mask → K9 → the row ids bit for bit, in
    values and ids, on duplicated rows with rows past ntotal nominated."""
    nv, d, nq = 16384, 64, 16
    ntotal = nv - 300
    x = _dup_rows(nv, d, seed=77)
    x[ntotal:] = 0
    xd = torch.from_numpy(x).to(dev)
    norms = (xd * xd).sum(-1)
    if fmt == "bf16":
        db, qmul = xd.to(torch.bfloat16), None
    elif fmt == "f16":
        db, qmul = f16_db(dev, x)[0], None
    else:
        db, qmul, norms, _ = int8_db(dev, nv, d, ntotal, seed=5)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(2))
    q = q.to(dev)
    if qmul is not None:
        q = q * qmul[None, :]
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    kg = min(k + 4, 36)
    g = torch.Generator().manual_seed(k)
    gidx = torch.sort(torch.randperm(nv // 128, generator=g)[:kg]).values
    gidx = gidx[None, :].repeat(nq, 1)
    gidx[:, -1] = nv // 128 - 1            # the partly stored last group
    gidx = torch.sort(gidx, dim=1).values.to(torch.int32).to(dev).contiguous()
    counter = {"bf16": "rescore_select", "int8": "rescore_select_int8",
               "f16": "rescore_select_f16"}[fmt]
    n0 = kernels.launches[counter]
    vals, ids = kernels.rescore_select_groups(q, db, vn, gidx, ntotal, k=k,
                                              metric=metric)
    assert kernels.launches[counter] == n0 + 1
    cols = fused.candidate_columns(gidx)
    s = kernels.rescore_groups(q, db, vn, gidx, metric=metric)
    v2, p2 = kernels.final_select(
        s.masked_fill(fused.candidate_drop(gidx, ntotal), float("-inf")), k)
    ids2 = torch.gather(cols, 1, p2.to(torch.int64))
    assert torch.equal(vals.view(torch.int32), v2.view(torch.int32))
    assert torch.equal(ids, ids2)
    vp, ip = fused.rescore_select_groups_plain(q, db, vn, gidx, ntotal, k=k,
                                               metric=metric)
    assert torch.equal(ids, ip)


def test_filtered_fallback_keeps_filtering(dev, monkeypatch):
    """Duplicated rows: the one-plane certificate fails, and both fallback
    tiers run under the selector; every returned id is admitted."""
    from faiss_tpu_torch import IDSelectorRange, SearchParams
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    row = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    idx = TorchIndexFlat(64, storage="bf16", device=dev)
    idx.add(np.tile(row, (20_000, 1)))
    xq = np.random.default_rng(2).standard_normal((32, 64)).astype(np.float32)
    kernels.reset_launches()
    p = SearchParams(sel=IDSelectorRange(5000, 15000))   # ~78 groups
    D, I = idx.search(xq, 10, params=p)
    n = dict(kernels.launches)
    assert idx.fused_fallbacks == 1
    assert n["sweep_groupmax_1"] == 1 and n["sweep_groupmax_2"] == 1
    np.testing.assert_array_equal(I, np.tile(np.arange(5000, 5010), (32, 1)))


def test_f32_stage3b_masks_the_selector_again(dev, monkeypatch):
    """The selector admits 5 rows, fewer than the m = k + 22 candidates of
    stage 3b: the filtered candidates, scored −inf by stage 3a, must not
    come back from the master's raw rescore."""
    from faiss_tpu_torch import IDSelectorBatch, SearchParams
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(8)
    xb = rng.standard_normal((20_000, 64)).astype(np.float32)
    xq = rng.standard_normal((16, 64)).astype(np.float32)
    idx = TorchIndexFlat(64, device=dev)
    idx.add(xb)
    keep = np.array([3, 999, 4096, 12345, 19999])
    before = kernels.launches["rescore_groups_pair"]
    D, I = idx.search(xq, 10, params=SearchParams(sel=IDSelectorBatch(keep)))
    assert kernels.launches["rescore_groups_pair"] > before
    assert (I[:, 5:] == -1).all() and np.isinf(D[:, 5:]).all()
    d2 = ((xq[:, None, :] - xb[keep][None]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.sort(I[:, :5], 1),
                                  np.tile(keep, (16, 1)))
    np.testing.assert_array_equal(I[:, :5], keep[np.argsort(d2, 1)])


# -- K10 f32 rows and the IVF index (the IVF slice) ---------------------------


def f32_pool(dev, npool, d, seed=0):
    """An f32 chunk pool of npool·128 rows: Gaussian rows with edge rows
    (±2^20, a zero row, alternating ±1, one tiny row), and empty slots
    (norm +inf in the pre-masked stream); returns (rows, raw norms, the
    pre-masked L2 / IP streams via ``occ``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((npool * 128, d)).astype(np.float32)
    x[1], x[2], x[3] = 2.0 ** 20, -(2.0 ** 20), 0.0
    x[4] = np.where(np.arange(d) % 2 == 0, 1.0, -1.0)
    x[5] = 1e-30
    occ = rng.random(npool * 128) > 0.1
    x[~occ] = 0.0
    rows = torch.from_numpy(x).to(dev)
    return rows, (rows * rows).sum(-1), torch.from_numpy(occ).to(dev)


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("nq,d,npool,nbudget", [(8, 16, 24, 7),
                                                (104, 128, 64, 64),
                                                (16, 132, 9, 30)])
@pytest.mark.parametrize("ids", ["random", "shared", "dead"])
def test_rescore_f32_matches_plain(dev, metric, nq, d, npool, nbudget, ids):
    """K10 f32 rows against its plain version within the rescore term of
    each entry's own row (each side fp32-true, ≤ d·u·Q·‖v‖), on chunk ids
    in any order, repeated (dead budget positions point at chunk 0), and
    past the pool (clamped by the kernel: the plain version is given the
    clamped ids). "shared": every query probes the same chunks, so at nq
    104 each chunk's run is longer than a block's 16 positions and is cut
    into pieces; "dead": every position is dead, at chunk 0. The bound has
    teeth: the plain version with the last 4 elements of d dropped breaks
    it on most entries."""
    rows, norms, occ = f32_pool(dev, npool, d)
    nv = npool * 128
    vn = fused._premask_norms(norms, nv, nv, metric, occ)
    rng = np.random.default_rng(nq)
    g = rng.integers(0, npool, (nq, nbudget)).astype(np.int32)
    if ids == "shared":
        g[:] = g[0]
    if ids == "dead":
        g[:] = 0
    else:
        g[:, -2:] = 0                          # dead positions
        g[0, 0], g[1, 0] = npool + 3, 1 << 30  # past the pool
        g[2, 1] = -5
    gidx = torch.from_numpy(g).to(dev)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    q = q.to(dev)
    n0 = kernels.launches["rescore_groups_f32"]
    s = kernels.rescore_groups(q, rows, vn, gidx, metric=metric)
    assert kernels.launches["rescore_groups_f32"] == n0 + 1
    gc = gidx.clamp(0, npool - 1)
    s_p = fused.rescore_groups_plain(q, rows, vn, gc, metric=metric)
    term = rescore_term_rows(q, rows, gc, d, metric)
    _within_eps(s, s_p, term)
    cut = rows.clone()
    cut[:, -4:] = 0.0
    s_cut = fused.rescore_groups_plain(q, cut, vn, gc, metric=metric)
    fin = torch.isfinite(s_p)
    assert float(((s_cut - s_p).abs() > term)[fin].double().mean()) > 0.5
    torch.cuda.synchronize()


def test_rescore_f32_does_not_wait_for_the_device(dev):
    """The f32 rows' grouping pass runs on the card with a fixed grid: with
    ~0.5 s of device work queued ahead, rescore_groups returns at once and
    its scores come out once that work has drained."""
    rows, norms, occ = f32_pool(dev, 64, 128)
    vn = fused._premask_norms(norms, 64 * 128, 64 * 128, MetricType.L2, occ)
    rng = np.random.default_rng(3)
    gidx = torch.from_numpy(rng.integers(0, 64, (104, 64)).astype(np.int32))
    gidx = gidx.to(dev)
    q = torch.from_numpy(rng.standard_normal((104, 128)).astype(np.float32))
    q = q.to(dev)
    want = kernels.rescore_groups(q, rows, vn, gidx, metric=MetricType.L2)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    got = kernels.rescore_groups(q, rows, vn, gidx, metric=MetricType.L2)
    enqueue_s = time.perf_counter() - t0
    assert not torch.cuda.current_stream().query()
    assert enqueue_s < 0.1, enqueue_s
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_rescore_f32_refuses_bad_rows(dev):
    q = torch.zeros((8, 6), device=dev)
    rows = torch.zeros((256, 6), device=dev)
    g = torch.zeros((8, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                # d % 4 != 0
        kernels.rescore_groups(q, rows, torch.zeros(256, device=dev), g,
                               metric=MetricType.L2)
    with pytest.raises(TypeError):                 # f64 rows
        kernels.rescore_groups(q, rows.double(), torch.zeros(256, device=dev),
                               g, metric=MetricType.L2)


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_ivf_on_card_matches_cpu(dev, metric, storage):
    """The same IVF index (centroids and scales carried from a CPU-trained
    one) on the card and on the CPU, on integer data: the gather routes
    (nprobe 1, 5) through K10, the dense route (f32: the plain sweep;
    bf16, int8: the fused kernels), range_search, remove_ids; ids equal,
    and distances equal (f32, bf16: every score is exact on integer data)
    or within the rescore term (int8: the decoded rows are not integers,
    and each side errs ≤ d·u·‖q∘s‖·max‖codes‖)."""
    from faiss_tpu_torch import TorchIndexIVFFlat

    rng = np.random.default_rng(7)
    cents = rng.integers(-20, 20, (24, 32)).astype(np.float32)
    xb = cents[rng.integers(0, 24, 20_000)] + rng.integers(-3, 4, (20_000, 32))
    xb = xb.astype(np.float32)
    xq = xb[rng.choice(20_000, 37, replace=False)] + 1.0
    cpu = TorchIndexIVFFlat(32, 24, metric=metric, storage=storage,
                            device="cpu", seed=3)
    cpu.train(xb)
    gpu = TorchIndexIVFFlat(32, 24, metric=metric, storage=storage,
                            device=dev, seed=3)
    if storage == "int8":
        gpu._set_scales(cpu._scales.cpu().numpy()[:32])
    gpu._set_centroids(cpu._centroids)
    for part in (xb[:12_000], xb[12_000:]):
        cpu.add(part)
        gpu.add(part)
    np.testing.assert_array_equal(cpu._assignments(), gpu._assignments())
    eps = np.zeros((len(xq), 1))
    if storage == "int8":
        q = torch.zeros((len(xq), cpu.d_pad))
        q[:, :32] = torch.from_numpy(xq)
        eps = rescore_term(q * cpu._scales, cpu._int8_qn, cpu._norms,
                           cpu._norms.shape[0], cpu.d_pad,
                           metric).numpy()[:, None]
    kernels.reset_launches()
    for nprobe in (1, 5, 24):
        cpu.nprobe = gpu.nprobe = nprobe
        Dc, Ic = cpu.search(xq, 10)
        Dg, Ig = gpu.search(xq, 10)
        np.testing.assert_array_equal(Ig, Ic)
        assert (np.abs(Dg - Dc) <= eps).all(), np.abs(Dg - Dc).max()
    n = dict(kernels.launches)
    gather = {"f32": "rescore_groups_f32", "bf16": "rescore_groups",
              "int8": "rescore_groups_int8"}[storage]
    assert n[gather] >= 2 and n["budget_select"] == 2
    if storage != "f32":
        assert n["select_groups"] > 0 and n["final_select"] > 0
    cpu.nprobe = gpu.nprobe = 5
    r = float(np.quantile(((xq[:, None] - xb[None, :2000]) ** 2).sum(-1),
                          0.01)) if metric is MetricType.L2 else 2000.0
    lc, Dc, Ic = cpu.range_search(xq, r)
    lg, Dg, Ig = gpu.range_search(xq, r)
    np.testing.assert_array_equal(lg, lc)
    if storage != "int8":
        np.testing.assert_array_equal(Ig, Ic)
        np.testing.assert_array_equal(Dg, Dc)
    else:   # hits within ε of each other may order either way
        for i in range(len(xq)):
            sl = slice(lc[i], lc[i + 1])
            assert set(Ig[sl]) == set(Ic[sl])
            assert (np.abs(np.sort(Dg[sl]) - np.sort(Dc[sl])) <= eps[i]).all()
    rm = np.arange(0, 20_000, 3)
    assert cpu.remove_ids(rm) == gpu.remove_ids(rm) == rm.size
    Dc, Ic = cpu.search(xq, 10)
    Dg, Ig = gpu.search(xq, 10)
    np.testing.assert_array_equal(Ig, Ic)
    torch.cuda.synchronize()


# -- PR 10's kernels, and what replaced them --------------------------------


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    """PR 10's K10 f16 mode (the thread-per-row kernel) and K11 (a block of
    512 threads a query), built by scripts/k10_variants.py beside the
    library: {"k10_legacy": lib, "k11_legacy": lib}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys
    from pathlib import Path

    scripts = str(Path(__file__).resolve().parent.parent / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import k10_variants as kv

    procs = kv.start_build(kernels._nvcc(), kernels.NVCC_FLAGS,
                           str(tmp_path_factory.mktemp("legacy")),
                           kv.legacy_sources())
    return kv, kv.finish_build(procs, verbose=False)


def _f16_e31_rows(nv, d, seed):
    """f16 rows (the stored bits) of random values with every e=31 pattern
    (±inf and every NaN payload) written into rows 1000 on, one a row and
    column."""
    g = torch.Generator().manual_seed(seed)
    bits = flush_f16_subnormals(encode_f16_bits(torch.randn((nv, d),
                                                            generator=g)))
    e31 = torch.cat([torch.arange(0x7C00, 0x8000), torch.arange(-0x400, 0)])
    flat = bits.view(torch.int16).reshape(-1)
    at = 1000 * d + torch.arange(e31.numel()) * (d + 1)
    keep = at < flat.numel()
    flat[at[keep]] = e31[keep].to(torch.int16)
    return bits


@pytest.mark.parametrize("kg", [1, 14, 36])
@pytest.mark.parametrize("d", [8, 64, 72, 128, 136, 1024, 2048])
def test_k10_f16_streamed_equals_thread_per_row(dev, legacy, d, kg):
    """K10's f16 mode, streamed by TMA, against PR 10's thread-per-row
    kernel bit for bit (both metrics), and within the rescore term of its
    plain version on the finite entries: every e=31 pattern in the rows,
    group ids repeated across queries and past either end (clamped), a last
    group only partly stored, d not a multiple of the 64-element slice."""
    kv, libs = legacy
    nv, ntotal, nq = 8192, 8000, 60
    ngroups = nv // 128
    db = _f16_e31_rows(nv, d, 10 * d + kg).to(dev)
    g = torch.Generator().manual_seed(d + kg)
    q = torch.randn((nq, d), generator=g).to(dev)
    raw = torch.randint(0, ngroups, (nq, kg), generator=g, dtype=torch.int32)
    raw[::3] = raw[0]
    raw[4, 0], raw[5, -1] = -3, ngroups + 11
    raw[6, 0] = 1000 // 128   # the e=31 rows
    gc = raw.clamp(0, ngroups - 1).to(dev)
    raw = raw.to(dev)
    v32 = decode_f16_bits(db)
    norms = torch.where(torch.isfinite(v32), v32, 0).square().sum(-1)
    for metric in METRICS:
        vn = fused._premask_norms(norms, ntotal, nv, metric)
        n0 = kernels.launches["rescore_groups_f16"]
        s = kernels.rescore_groups(q, db, vn, raw, metric=metric)
        assert kernels.launches["rescore_groups_f16"] == n0 + 1
        old = torch.empty_like(s)
        kv.call_rescore(torch, libs["k10_legacy"], 3, q, db, None, vn, raw,
                        old, metric is MetricType.L2)
        torch.cuda.synchronize()
        assert torch.equal(s.view(torch.int32), old.view(torch.int32))
        plain = fused.rescore_groups_plain(q, db, vn, gc, metric=metric)
        # a sum holding ±inf is NaN or ±inf in any order
        inf = torch.isinf(plain)
        assert torch.equal(torch.isnan(s), torch.isnan(plain))
        assert torch.equal(torch.isinf(s), inf)
        assert torch.equal(s[inf], plain[inf])
        fin = torch.isfinite(plain)
        term = rescore_term_rows(q, torch.where(torch.isfinite(v32), v32, 0),
                                 gc, d, metric)
        err = (s - plain).abs().to(torch.float64)
        assert bool((err[fin] <= term[fin]).all())


def _k11_case(dev, fmt, d, kg, nq, seed):
    """(q, rows, norms, gidx, ntotal, nan_row) for K11: tie-heavy integer
    rows (values in [-3, 3]), a last group cut by ntotal and nominated by
    every query, ascending group ids with repeats (query 1 repeats its first
    group, query 2 names one group kg times), and a row of query 3's first
    group that scores NaN (its vn entry; for bf16 also a NaN element)."""
    rng = np.random.default_rng(seed)
    ngroups = 64
    nv = ngroups * 128
    ntotal = nv - 77
    x = rng.integers(-3, 4, (nv, d)).astype(np.float32)
    x[ntotal:] = 0
    xd = torch.from_numpy(x).to(dev)
    if fmt == "bf16":
        rows = xd.to(torch.bfloat16)
    elif fmt == "f16":
        rows = encode_f16_bits(xd)
    else:
        rows = xd.to(torch.int8)
    norms = (xd * xd).sum(-1)
    q = torch.from_numpy(rng.integers(-3, 4, (nq, d)).astype(np.float32))
    gidx = np.sort(np.stack([rng.choice(ngroups - 1, kg, replace=False)
                             for _ in range(nq)]), axis=1)
    gidx[:, -1] = ngroups - 1
    gidx = np.sort(gidx, axis=1)
    if kg > 1:
        gidx[1, 1] = gidx[1, 0]
    gidx[2] = gidx[2, 0]
    g3 = int(gidx[3, 0])
    if fmt == "bf16":
        rows[g3 * 128 + 5, 0] = float("nan")
    return (q.to(dev), rows, norms, torch.from_numpy(gidx).to(torch.int32)
            .to(dev).contiguous(), ntotal, g3 * 128 + 9)


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("kg", [1, 2, 14, 36])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "f16"])
def test_k11_equals_k10_then_k9(dev, legacy, fmt, kg, k):
    """K11 (a cluster a query, streamed, one-pass select) against K10 →
    candidate_drop → K9 → the row ids, and against PR 10's kernel, bit for
    bit in values and ids, both metrics, at d 64 and 2048 (kg ≤ 14)."""
    kv, libs = legacy
    counter = {"bf16": "rescore_select", "int8": "rescore_select_int8",
               "f16": "rescore_select_f16"}[fmt]
    for d in (64, 2048) if kg <= 14 else (64,):
        q, rows, norms, gidx, ntotal, nan_row = _k11_case(
            dev, fmt, d, kg, 12, 7 * d + kg + k)
        for metric in METRICS:
            vn = fused._premask_norms(norms, ntotal, norms.shape[0], metric)
            vn[nan_row] = float("nan")
            n0 = kernels.launches[counter]
            vals, ids = kernels.rescore_select_groups(q, rows, vn, gidx,
                                                      ntotal, k=k,
                                                      metric=metric)
            assert kernels.launches[counter] == n0 + 1
            s = kernels.rescore_groups(q, rows, vn, gidx, metric=metric)
            v2, p2 = kernels.final_select(
                s.masked_fill(fused.candidate_drop(gidx, ntotal),
                              float("-inf")), k)
            ids2 = torch.gather(fused.candidate_columns(gidx), 1,
                                p2.to(torch.int64))
            assert torch.equal(vals.view(torch.int32), v2.view(torch.int32))
            assert torch.equal(ids, ids2)
            lv, li = torch.empty_like(vals), torch.empty_like(ids)
            kv.call_select(torch, libs["k11_legacy"],
                           kernels._SELECT_FMT[rows.dtype][0], q, rows, vn,
                           gidx, ntotal, k, lv, li, metric is MetricType.L2)
            torch.cuda.synchronize()
            assert torch.equal(vals.view(torch.int32), lv.view(torch.int32))
            assert torch.equal(ids, li)
            assert bool(torch.isnan(vals[3]).all())


def test_f32_to_bf16_on_the_card_equals_the_cpu(dev):
    """storage.f32_to_bf16 gives the same bits for a CUDA tensor as for a
    CPU tensor: NaN payloads of both signs, ±inf, ±0, subnormals, the
    halfway cases and random values of every magnitude."""
    from faiss_tpu_torch.storage import f32_to_bf16

    pats = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                     0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000, 0x7F800000,
                     0xFF800000, 0, 0x80000000, 1, 0x80000001, 0x7FFFFF,
                     0x8000, 0x18000, 0x3F808000, 0x3F818000, 0xBF808000,
                     0x7F7F8000], np.uint32).view(np.float32)
    rng = np.random.default_rng(0)
    x = np.concatenate([pats, (rng.standard_normal(1 << 16) * 2.0 ** rng
                               .integers(-140, 120, 1 << 16))
                        .astype(np.float32)])
    t = torch.from_numpy(x)
    want = f32_to_bf16(t).view(torch.int16)
    got = f32_to_bf16(t.to(dev)).view(torch.int16).cpu()
    assert torch.equal(got, want)
    assert got[0] == 0x7FC0 and got[1] == -64   # sign | 0x7fc0


NAN_NV, NAN_D, NAN_NQ, NAN_K = 12000, 64, 8, 5


def _nan_rows(n, seed):
    """tests/test_torch_nonfinite.py's rows holding NaNs (numpy's nan and a
    signalling payload, both positive)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, NAN_D)).astype(np.float32)
    snan = np.uint32(0x7F800001).view(np.float32)
    x[[5, 300, 2000, 2999], [1, 7, 63, 0]] = [np.nan, snan, np.nan, snan]
    return x


@pytest.mark.parametrize("plain", [False, True], ids=["fused", "plain"])
@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("store", ["bf16", "pair"])
def test_nan_rows_search_on_the_card_equals_the_cpu(dev, store, metric,
                                                    plain, monkeypatch):
    """The NaN-row searches of tests/test_torch_nonfinite.py (bf16 flat and
    f32 keep_master=False, fused and plain) give on the card the ids the
    port gives on the CPU (those equal faiss_tpu's there)."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    x = _nan_rows(NAN_NV, 3)
    xq = np.random.default_rng(4).standard_normal(
        (NAN_NQ, NAN_D)).astype(np.float32)
    kw = {"keep_master": False} if store == "pair" else {"storage": "bf16"}
    out = []
    for device in ("cpu", "cuda"):
        idx = TorchIndexFlat(NAN_D, metric=metric, device=device, **kw)
        idx.add(x)
        idx.set_force_plain(plain)
        out.append(idx.search(xq, NAN_K))
    (Dc, Ic), (Dg, Ig) = out
    np.testing.assert_array_equal(Ig, Ic)
    assert (Ig == -1).any()
    np.testing.assert_allclose(Dg, Dc, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("nprobe", [4, 16], ids=["gather", "dense"])
@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_nan_rows_ivf_bf16_on_the_card_equals_the_cpu(dev, metric, nprobe,
                                                      tmp_path):
    """IVF16 bf16 with the NaN rows: the card's pool bits and ids equal the
    CPU port's, the index carried across by its saved file."""
    from faiss_tpu_torch import TorchIndexIVFFlat, load_index, save_index

    rng = np.random.default_rng(5)
    cpu = TorchIndexIVFFlat(NAN_D, 16, metric=metric, storage="bf16",
                            device="cpu")
    cpu.train(rng.standard_normal((3000, NAN_D)).astype(np.float32))
    path = str(tmp_path / "ivf.npz")
    save_index(cpu, path)
    gpu = load_index(path, device="cuda")
    x = _nan_rows(3000, 6)
    xq = np.random.default_rng(4).standard_normal(
        (NAN_NQ, NAN_D)).astype(np.float32)
    for i in (cpu, gpu):
        i.add(x)
        i.nprobe = nprobe
    np.testing.assert_array_equal(gpu._assignments(), cpu._assignments())
    assert torch.equal(gpu._rows_by_id()[0].cpu().view(torch.int16),
                       cpu._rows_by_id()[0].view(torch.int16))
    (Dc, Ic), (Dg, Ig) = cpu.search(xq, NAN_K), gpu.search(xq, NAN_K)
    np.testing.assert_array_equal(Ig, Ic)
    np.testing.assert_allclose(Dg, Dc, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("nq", [NAN_NQ, 100])
@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_nan_rows_f16_on_the_card_equals_the_cpu(dev, metric, nq,
                                                 monkeypatch, capsys):
    """f16 flat storage with the NaN rows: the card's fused search (nq 8:
    K6 from the start; nq 100: K7, then K6 for the rows it leaves
    uncertified) returns the CPU route's ids, distances within the rescore
    tolerance. K6 reads a stored NaN as NaN, so its group turns NaN where
    the CPU route's decoded pair reads ±inf; the certificate then fails for
    the query and the plain path re-runs it. The fallbacks of both routes
    are printed."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    x = _nan_rows(NAN_NV, 3)
    xq = np.random.default_rng(4).standard_normal(
        (nq, NAN_D)).astype(np.float32)
    out, falls = [], []
    for device in ("cpu", "cuda"):
        idx = TorchIndexFlat(NAN_D, metric=metric, storage="f16",
                             device=device)
        idx.add(x)
        out.append(idx.search(xq, NAN_K))
        falls.append(idx.fused_fallbacks)
    (Dc, Ic), (Dg, Ig) = out
    with capsys.disabled():
        print(f"\nf16 NaN rows {metric.value} nq {nq}: fused_fallbacks cpu "
              f"{falls[0]}, card {falls[1]}")
    np.testing.assert_array_equal(Ig, Ic)
    np.testing.assert_allclose(Dg, Dc, rtol=1e-4, atol=1e-3)


# -- sharded flat and IVF over one card named P times ------------------------


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "int8"])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_sharded_flat_on_card_matches_unsharded(dev, monkeypatch, p,
                                                 storage):
    """ShardedIndexFlat over ["cuda:0"] * P: ids equal to the unsharded
    index's on the same card (the fused path from 8192 rows a shard, so
    every shard takes it), launch counts of the storage's kernels and
    never K4 (no index route reaches it)."""
    from faiss_tpu_torch import ShardedIndexFlat

    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(31 + p)
    xb = rng.standard_normal((40_000, 64)).astype(np.float32)
    xq = rng.standard_normal((40, 64)).astype(np.float32)
    single = TorchIndexFlat(64, storage=storage, device=dev)
    sh = ShardedIndexFlat(64, storage=storage, num_shards=p,
                          devices=["cuda:0"] * p)
    for idx in (single, sh):
        idx.add(xb[:15_000])
        idx.add(xb[15_000:])
    D1, I1 = single.search(xq, 10)
    n0 = dict(kernels.launches)
    Ds, Is = sh.search(xq, 10)
    n = {k: v - n0[k] for k, v in kernels.launches.items()}
    np.testing.assert_array_equal(Is, I1)
    np.testing.assert_allclose(Ds, D1, rtol=1e-4, atol=1e-3)
    assert n["select_groups"] >= p and n["sweep_split_2"] == 0, n
    assert sh.fused_fallbacks == single.fused_fallbacks
    torch.cuda.synchronize()


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_sharded_ivf_on_card_matches_single(dev, storage, tmp_path):
    """A TorchIndexIVFFlat saved and reloaded with load_index(sharded=True)
    over ["cuda:0"] * 3: ids equal to the single index's at nprobe 4 (the
    fine scan on K10) and 16 = nlist (the dense route)."""
    from faiss_tpu_torch import TorchIndexIVFFlat, load_index, save_index

    rng = np.random.default_rng(41)
    xb = rng.integers(0, 64, (6000, 32)).astype(np.float32)
    xq = rng.integers(0, 64, (12, 32)).astype(np.float32)
    single = TorchIndexIVFFlat(32, 16, storage=storage, device=dev)
    single.train(xb)
    single.add(xb)
    path = str(tmp_path / "ivf.npz")
    save_index(single, path)
    sh = load_index(path, sharded=True, devices=["cuda:0"] * 3)
    assert sh.num_shards == 3
    for nprobe in (4, 16):
        single.nprobe = sh.nprobe = nprobe
        D1, I1 = single.search(xq, 7)
        Ds, Is = sh.search(xq, 7)
        np.testing.assert_array_equal(Is, I1)
        np.testing.assert_allclose(Ds, D1, rtol=1e-5)
    torch.cuda.synchronize()


F16_NAN_PATS = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FC00001,
                0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000, 0xFFA00001, 0x7F810000,
                0xFF810000, 0x7F800000, 0xFF800000, 0, 0x80000000, 1,
                0x80000001, 0x33800000, 0xB3800000, 0x477FE000, 0x477FF000,
                0x3F802000, 0x3F806000]


def test_encode_f16_bits_on_the_card_equals_the_cpu(dev):
    """storage.encode_f16_bits gives the same bits for a CUDA tensor as for
    a CPU tensor, NaN payloads of both signs included (the card's own
    conversion turns every NaN into 0x7fff), ±inf, ±0, subnormals, the
    overflow edge and the halfway cases, and random values of every
    magnitude."""
    rng = np.random.default_rng(1)
    x = np.concatenate([np.array(F16_NAN_PATS, np.uint32).view(np.float32),
                        (rng.standard_normal(1 << 16) * 2.0 ** rng
                         .integers(-30, 20, 1 << 16)).astype(np.float32)])
    t = torch.from_numpy(x)
    want = encode_f16_bits(t).view(torch.int16)
    got = encode_f16_bits(t.to(dev)).view(torch.int16).cpu()
    assert torch.equal(got, want)
    assert got[0] == 0x7E00 and got[1] == -512      # sign | 0x7e00
    assert got[7] == 0x7F00 and got[8] == -256      # payload kept


@pytest.mark.parametrize("n", [4096, 8192], ids=["device_route",
                                                 "native_route"])
@pytest.mark.parametrize("storage", ["f16", "bf16"])
def test_reduced_store_on_the_card_equals_the_cpu(dev, storage, n):
    """A bf16 or f16 store of one batch with NaNs of both signs and
    subnormals: the card's row bits equal the CPU's on both routes (4096
    rows × 128 convert on the device, 8192 × 128 on the host); the norms
    bit for bit on the native route (the same host code), within 4 ulps on
    the device route (another summation order). A negative NaN decodes to
    −inf in f16 on both."""
    from faiss_tpu_torch import native

    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 128)).astype(np.float32)
    pats = np.array(F16_NAN_PATS, np.uint32).view(np.float32)
    x[np.arange(len(pats)) * 31 + 3, np.arange(len(pats)) * 5] = pats
    native.reset_calls()
    idx = [TorchIndexFlat(128, storage=storage, device=d)
           for d in ("cpu", "cuda")]
    for i in idx:
        i.add(x)
    assert native.calls["l2_norms"] == (2 if n == 8192 else 0)
    bits = [i.store.db[:n].contiguous().view(torch.int16).cpu() for i in idx]
    assert torch.equal(bits[1], bits[0])
    norms = [i.store.norms[:n].cpu().view(torch.int32) for i in idx]
    if n == 8192:
        assert torch.equal(norms[1], norms[0])
    else:
        fin = torch.isfinite(idx[0].store.norms[:n])
        ulps = (norms[1][fin].long() - norms[0][fin].long()).abs()
        assert int(ulps.max()) <= 4
    if storage == "f16":
        r = 1 * 31 + 3   # the row of 0xFFC00000
        for i in idx:
            assert float(decode_f16_bits(i.store.db[r, 5:6].cpu())) \
                == float("-inf")


# -- the IVF fine scan's top-k: budget_select (csrc/budget_select.cu) --------

BUDGET_CASES = ["normal", "ties", "zeros", "inf", "nan", "dead"]
# NaN bit patterns of both signs; 0xffffffff is key 0 under the total order
# (row_select.cuh's "no column"), 0x7fffffff the largest key
BUDGET_NANS = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF,
               0xFFFFFFFF, 0x7FA00000]
NEG_INF_BITS, POS_INF_BITS = 0xFF800000, 0x7F800000


def budget_rows(case: str, nq: int, nbudget: int, seed: int = 0,
                dead: float = 0.43):
    """(s (nq, nbudget·128) f32, okc (nq, nbudget) bool) on the CPU: the
    fine scan's budget scores and live chunks, ``dead`` the share of dead
    chunks. "normal": Gaussian scores, the dead chunks at the end of each
    row as ``ivf._chunk_ids`` lays them out; the other cases scatter them:
    "ties" a few values, every chunk edge at the top one; "zeros" ±0.0
    with a few ±1; "inf" ±inf among Gaussians; "nan" NaNs of both signs
    (``BUDGET_NANS``), a row of 0xffffffff, one of 0x7fffffff and one with
    41 of them; "dead" a row all dead, one with 5 finite live columns,
    one whose live columns are −inf (tied with the dead), one whose live
    columns are −NaN (below the dead chunks' −inf)."""
    rng = np.random.default_rng(seed)
    n = nbudget * 128
    s = rng.standard_normal((nq, n)).astype(np.float32)
    if case == "normal":
        live = np.clip(np.round(nbudget * (1 - dead)
                                * rng.uniform(0.8, 1.2, nq)), 1, nbudget)
        okc = np.arange(nbudget)[None] < live[:, None]
    else:
        okc = rng.random((nq, nbudget)) >= dead
    bits = s.view(np.uint32)
    if case == "normal":
        pass
    elif case == "ties":
        s[:] = rng.integers(-2, 3, (nq, n))
        s[:, 127::128] = 3.0
        s[:, ::128] = 3.0
    elif case == "zeros":
        s[:] = rng.choice(np.float32([0.0, -0.0, 0.0, -0.0, 1.0, -1.0]),
                          (nq, n))
    elif case == "inf":
        u = rng.random((nq, n))
        bits[u < 0.3] = NEG_INF_BITS
        bits[u > 0.98] = POS_INF_BITS
    elif case == "nan":
        u = rng.random((nq, n))
        pick = rng.integers(0, len(BUDGET_NANS), (nq, n))
        bits[u < 0.1] = np.uint32(BUDGET_NANS)[pick[u < 0.1]]
        for r, b in zip(range(nq), (0xFFFFFFFF, 0x7FFFFFFF)):
            bits[r] = b
        if nq > 2:
            bits[2, rng.choice(n, min(41, n), replace=False)] = 0x7FFFFFFF
    elif case == "dead":
        for r in range(min(nq, 4)):
            okc[r] = False
        if nq > 1:
            okc[1, 0] = True
            bits[1, :128] = NEG_INF_BITS
            bits[1, rng.choice(128, 5, replace=False)] = 0x3F800000
        if nq > 2:
            okc[2, ::2] = True
            bits[2] = NEG_INF_BITS
        if nq > 3:
            okc[3, 1::2] = True
            bits[3] = 0xFFFFFFFF
    else:
        raise ValueError(case)
    return torch.from_numpy(s), torch.from_numpy(okc)


def budget_reference(s: torch.Tensor, okc: torch.Tensor, k: int):
    """The contract of ``kernels.budget_select`` in numpy: per row the k
    columns largest in the fp32 total order, the dead chunks' columns
    −inf, ties to the lowest column. → (value bits (nq, k) uint32, columns
    (nq, k) int32)."""
    b = s.cpu().numpy().view(np.uint32).astype(np.int64)
    dead = ~np.repeat(okc.cpu().numpy(), 128, axis=1)
    b = np.where(dead, NEG_INF_BITS, b)
    key = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    cols = np.arange(b.shape[1])
    order = np.stack([np.lexsort((cols, -key[r]))[:k]
                      for r in range(b.shape[0])])
    return (np.take_along_axis(b, order, 1).astype(np.uint32),
            order.astype(np.int32))


def assert_budget_select(vals, pos, s, okc, k, what=""):
    """vals, pos bit for bit the contract (``budget_reference``)."""
    want_v, want_p = budget_reference(s, okc, k)
    np.testing.assert_array_equal(pos.cpu().numpy(), want_p, what)
    np.testing.assert_array_equal(
        vals.cpu().numpy().view(np.uint32), want_v, what)


@pytest.mark.parametrize("nbudget", [1, 5, 1024, 1280])
@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("case", BUDGET_CASES)
def test_budget_select_adversarial_rows(dev, case, k, nbudget):
    """The kernel on ties across chunk edges, ±0.0, ±inf, ±NaN (the bits
    0xffffffff and 0x7fffffff whole rows), all-dead rows and rows of fewer
    than k live finite columns: bit for bit the numpy contract and the
    plain version (the masked stable sort) on the card."""
    s, okc = budget_rows(case, 6, nbudget, seed=nbudget + k)
    sd, od = s.to(dev), okc.to(dev)
    n0 = kernels.launches["budget_select"]
    v, p = kernels.budget_select(sd, od, k)
    assert kernels.launches["budget_select"] == n0 + 1
    assert_budget_select(v, p, s, okc, k, f"{case} k={k} nbudget={nbudget}")
    v_p, p_p = kernels.budget_select_plain(sd, od, k)
    assert torch.equal(_bits(v), _bits(v_p)) and torch.equal(p, p_p)


@pytest.mark.parametrize("nq,nbudget,k", [
    (104, 1024, 10),          # the IVF cell: 32 tiles a row, 43 % dead
    (104, 1280, 10),          # 40 tiles
    (104, 1048, 40),          # 33 tiles, the last of 24 chunks
    (13, 130, 7),             # 5 tiles, the last of 2 chunks
    (8, 32, 10),              # one tile: one launch writes the result
    (2, 60_000, 40),          # 1,875 tiles: a second reduction round
    (1, 131_072, 40),         # 4,096 tiles, the gather budget's widest row
])
def test_budget_select_matches_plain_bitwise(dev, nq, nbudget, k):
    """Gaussian scores with ~43 % of the chunks dead at the end of each
    row: the kernel against its plain version on the card and the numpy
    contract, bit for bit, at the cell's width and ragged ones."""
    s, okc = budget_rows("normal", nq, nbudget, seed=nq * nbudget)
    sd, od = s.to(dev), okc.to(dev)
    v, p = kernels.budget_select(sd, od, k)
    v_p, p_p = kernels.budget_select_plain(sd, od, k)
    assert torch.equal(_bits(v), _bits(v_p)) and torch.equal(p, p_p)
    if nq * nbudget <= 200_000:
        assert_budget_select(v, p, s, okc, k)
    torch.cuda.synchronize()


def test_budget_select_checks_inputs(dev):
    s = torch.zeros((4, 256), device=dev)
    okc = torch.ones((4, 2), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        kernels.budget_select(s, okc, 41)
    with pytest.raises(ValueError):
        kernels.budget_select(s, okc[:, :1].contiguous(), 10)
    with pytest.raises(TypeError):
        kernels.budget_select(s.double(), okc, 10)
    with pytest.raises(ValueError):
        kernels.budget_select(s, okc.cpu(), 10)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_captured_ivf_search_launches_budget_select_once(dev, storage):
    """Each IVF fine-scan search at k ≤ 40 launches budget_select once,
    eager, captured or replayed, with the eager answers bit for bit; k 41
    keeps the sort and launches none."""
    from faiss_tpu_torch import SearchParams, TorchIndexIVFFlat

    rng = np.random.default_rng(31)
    xb = rng.standard_normal((20_000, 64), dtype=np.float32)
    xq = rng.standard_normal((30, 64), dtype=np.float32)
    ivf = TorchIndexIVFFlat(64, 32, storage=storage, device=dev)
    ivf.train(xb)
    ivf.add(xb)
    for nprobe in (1, 8):
        p = SearchParams(nprobe=nprobe)
        for k in (10, 40, 41):
            kernels.reset_launches()
            with programs.eager():
                ref = ivf._search_packed(xq, k, p)[0]
            counts = [kernels.launches["budget_select"]]
            for _ in range(2):                  # build, replay
                kernels.reset_launches()
                got = ivf._search_packed(xq, k, p)[0]
                counts.append(kernels.launches["budget_select"])
                assert torch.equal(_bits(got), _bits(ref))
            assert counts == [int(k <= 40)] * 3, (nprobe, k, counts)
    torch.cuda.synchronize()


# -- the search programs: CUDA graphs replayed from TorchResources' cache ----


def _graphs_of(idx):
    """The index's cached programs (every one must be a CUDA graph)."""
    from faiss_tpu_torch.programs import GraphProgram

    progs = [p for key, p in idx.res._cache.items()
             if isinstance(key, tuple) and key[1] == idx._owner]
    assert progs and all(isinstance(p, GraphProgram) for p in progs)
    return progs


def _bits(t):
    return t.contiguous().view(torch.int32)


def _replays_equal_eager(idx, xq, k, params=None, **route):
    """Three calls of the cached search (the build's warm-up result, then
    two replays) against the eager search, bit for bit: distances, id
    bits and the certificate."""
    q, _, nq_pad = idx._prep_queries(xq)
    sel = idx._sel_stream(params)
    with programs.eager():
        ref = idx._run_search_fn(q, k, nq_pad, sel=sel, **route)
    for _ in range(3):
        got = idx._run_search_fn(q, k, nq_pad, sel=sel, **route)
        assert got[1:] == ref[1:]
        assert torch.equal(_bits(got[0]), _bits(ref[0]))
    return ref[1]


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("storage,kw", [
    ("f32", {}), ("f32", {"keep_master": False}), ("bf16", {}),
    ("f16", {}), ("int8", {})], ids=["f32", "pair", "bf16", "f16", "int8"])
def test_replayed_flat_search_equals_eager(dev, metric, storage, kw,
                                           monkeypatch):
    from faiss_tpu_torch import IDSelectorRange, SearchParams

    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(21)
    xb = rng.standard_normal((30_000, 64), dtype=np.float32)
    xq = rng.standard_normal((40, 64), dtype=np.float32)
    idx = TorchIndexFlat(64, metric=metric, storage=storage, device=dev,
                         **kw)
    idx.add(xb)
    sel = SearchParams(sel=IDSelectorRange(1000, 21_000))
    for nq in (8, 40):
        for params in (None, sel):
            assert _replays_equal_eager(idx, xq[:nq], 10, params,
                                        force_plain=False)
            # the fallback's tiers: the two-plane sweep, the plain path
            _replays_equal_eager(idx, xq[:nq], 10, params,
                                 force_plain=False, full_sweep=True)
            assert not _replays_equal_eager(idx, xq[:nq], 10, params,
                                            force_plain=True)
    _graphs_of(idx)
    D1, I1 = idx.search(xq, 10, params=sel)
    D2, I2 = idx.search(xq, 10, params=sel)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    torch.cuda.synchronize()


def test_replayed_fallback_tiers_on_duplicates(dev, monkeypatch):
    """Every score ties: the one-plane bf16 search at nq = 100 fails its
    certificate, tier 1 (two planes) fails, tier 2 (plain) answers; each
    tier a replayed graph, equal to its eager run."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    row = np.random.default_rng(22).standard_normal(64).astype(np.float32)
    dup = TorchIndexFlat(64, storage="bf16", device=dev)
    dup.add(np.tile(row, (50_000, 1)))
    xq = np.random.default_rng(23).standard_normal((100, 64)).astype(
        np.float32)
    D, I = dup.search(xq, 10)
    assert dup.fused_fallbacks == 1 and dup._no_reduced_sweep == {104}
    np.testing.assert_array_equal(I, np.tile(np.arange(10), (100, 1)))
    _replays_equal_eager(dup, xq, 10, force_plain=False)
    _replays_equal_eager(dup, xq, 10, force_plain=False, full_sweep=True)
    _replays_equal_eager(dup, xq, 10, force_plain=True)
    # the one-plane search, then (pinned) the two-plane one, which tier 1
    # shares, and the plain path
    assert len(_graphs_of(dup)) == 3
    D2, I2 = dup.search(xq, 10)
    np.testing.assert_array_equal(I2, I)
    np.testing.assert_array_equal(D2, D)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_replayed_ivf_search_equals_eager(dev, storage):
    from faiss_tpu_torch import (IDSelectorRange, SearchParams,
                                 TorchIndexIVFFlat)

    rng = np.random.default_rng(24)
    xb = rng.standard_normal((20_000, 64), dtype=np.float32)
    xq = rng.standard_normal((30, 64), dtype=np.float32)
    ivf = TorchIndexIVFFlat(64, 32, storage=storage, device=dev)
    ivf.train(xb)
    ivf.add(xb)
    for nprobe in (1, 8, 32):           # fine scan, fine scan, dense
        for sel in (None, IDSelectorRange(500, 15_000)):
            p = SearchParams(sel=sel, nprobe=nprobe)
            for force in (False, True):
                with programs.eager():
                    ref = ivf._search_packed(xq, 10, p,
                                             force_plain_dense=force)[0]
                for _ in range(3):
                    got = ivf._search_packed(xq, 10, p,
                                             force_plain_dense=force)[0]
                    assert torch.equal(_bits(got), _bits(ref))
    _graphs_of(ivf)
    D1, I1 = ivf.search(xq, 10, params=SearchParams(nprobe=32))
    D2, I2 = ivf.search(xq, 10, params=SearchParams(nprobe=32))
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)


def test_pipelined_tokens_hold_their_own_results(dev):
    """16 tokens in flight on one program, each with its own queries: each
    returns its own result (a replay never overwrites another's)."""
    rng = np.random.default_rng(25)
    idx = TorchIndexFlat(64, storage="bf16", device=dev)
    idx.add(rng.standard_normal((100_000, 64), dtype=np.float32))
    batches = [rng.standard_normal((8, 64), dtype=np.float32)
               for _ in range(16)]
    want = [idx.search(b, 10) for b in batches]
    assert len(_graphs_of(idx)) == 1
    toks = [idx.search_async(b, 10) for b in batches]
    got = [t.wait() for t in toks]
    for (Dt, It), (D, I) in zip(got, want):
        np.testing.assert_array_equal(It, I)
        np.testing.assert_array_equal(Dt, D)
    # 16 more calls on other queries, each waited: their pinned copies
    # reuse the host blocks that the first 16 tokens gave back, and the
    # first results, arrays of their own, stay as they were
    others = [rng.standard_normal((8, 64), dtype=np.float32)
              for _ in range(16)]
    for t in [idx.search_async(b, 10) for b in others]:
        t.wait()
    for (Dt, It), (D, I) in zip(got, want):
        np.testing.assert_array_equal(It, I)
        np.testing.assert_array_equal(Dt, D)


def test_pipelined_tokens_sync_before_their_copy(dev):
    """Under the profiler, 16 tokens in flight: each wait's ``token.sync``
    (the call's own work) ends before its ``token.copy`` (the copy that
    search_async enqueued behind it) begins."""
    from torch.profiler import ProfilerActivity, profile

    from faiss_tpu_torch import tracing

    rng = np.random.default_rng(27)
    idx = TorchIndexFlat(64, storage="bf16", device=dev)
    idx.add(rng.standard_normal((100_000, 64), dtype=np.float32))
    batches = [rng.standard_normal((8, 64), dtype=np.float32)
               for _ in range(16)]
    want = [idx.search(b, 10) for b in batches]
    with profile(activities=[ProfilerActivity.CPU]):
        toks = [idx.search_async(b, 10) for b in batches]
        got = [t.wait() for t in toks]
    for (Dt, It), (D, I) in zip(got, want):
        np.testing.assert_array_equal(It, I)
    recs = tracing.spans()
    syncs = {r.call: r for r in recs if r.name == "token.sync"}
    copies = {r.call: r for r in recs if r.name == "token.copy"}
    assert sorted(syncs) == sorted(copies) == sorted(t._call for t in toks)
    for call, sync in syncs.items():
        assert sync.t1_ns <= copies[call].t0_ns


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_token_wait_does_not_queue_behind_later_work(dev, storage,
                                                     monkeypatch):
    """A token's copy back is enqueued right behind its own search: with
    a long sleep and a second search enqueued after it, the first token's
    wait returns once its own work and copy are done, and the second
    token is not ready yet."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(28)
    idx = TorchIndexFlat(64, storage=storage, device=dev)
    idx.add(rng.standard_normal((20_000, 64), dtype=np.float32))
    xa, xb = (rng.standard_normal((16, 64), dtype=np.float32)
              for _ in range(2))
    want = idx.search(xa, 10)
    idx.search(xb, 10)
    # the sleep's length on this card
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    torch.cuda._sleep(1_000_000_000)
    t1.record()
    t1.synchronize()
    sleep_s = t0.elapsed_time(t1) * 1e-3
    a = idx.search_async(xa, 10)
    torch.cuda._sleep(1_000_000_000)
    t = time.perf_counter()
    b = idx.search_async(xb, 10)
    enqueue_s = time.perf_counter() - t
    D, I = a.wait()
    wait_s = time.perf_counter() - t
    assert not b.is_ready()
    assert enqueue_s < sleep_s / 10, (enqueue_s, sleep_s)
    assert wait_s < sleep_s / 10, (wait_s, sleep_s)
    np.testing.assert_array_equal(I, want[1])
    np.testing.assert_array_equal(D, want[0])
    b.wait()
    assert idx.fused_fallbacks == 0


def test_replay_counts_launches_as_eager(dev, monkeypatch):
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(26)
    idx = TorchIndexFlat(64, device=dev)
    idx.add(rng.standard_normal((30_000, 64), dtype=np.float32))
    q, _, nq_pad = idx._prep_queries(
        rng.standard_normal((8, 64), dtype=np.float32))
    counts = []
    for eager in (True, False, False):  # eager, build, replay
        kernels.reset_launches()
        with programs.eager() if eager else contextlib.nullcontext():
            idx._run_search_fn(q, 10, nq_pad, force_plain=False)
        counts.append(dict(kernels.launches))
    assert counts[0]["sweep_split_3"] == 1
    assert counts[0]["rescore_groups_pair"] == 1
    assert counts[1] == counts[0] and counts[2] == counts[0]


def test_capture_meeting_a_host_sync_raises(dev):
    x = torch.ones(8, device=dev)
    with pytest.raises(RuntimeError):
        programs.build(lambda t: t * float(t.sum()), [x], dev)
    # no quiet fallback, and the card works on
    prog, first = programs.build(lambda t: t * 2.0, [x], dev)
    assert torch.equal(prog(x + 1.0), torch.full((8,), 4.0, device=dev))
    assert torch.equal(first, torch.full((8,), 2.0, device=dev))
    torch.cuda.synchronize()


# -- the sites that followed: sharded, range passes, the coarse assign --------


def _graphs_owned(res, owner):
    """The programs of ``owner`` (every one must be a CUDA graph)."""
    from faiss_tpu_torch.programs import GraphProgram

    progs = [p for key, p in res._cache.items() if key[1] == owner]
    assert progs and all(isinstance(p, GraphProgram) for p in progs)
    return progs


def _equal_tuples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("storage", ["f32", "int8", "f16"])
def test_replayed_sharded_flat_equals_eager(dev, storage, monkeypatch):
    """ShardedIndexFlat over cuda:0 named three times: one CUDA graph a
    search, its replays equal to the eager search bit for bit, with a
    selector and on both fallback tiers."""
    from faiss_tpu_torch import IDSelectorRange, SearchParams, ShardedIndexFlat

    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(27)
    xb = rng.standard_normal((36_000, 64), dtype=np.float32)
    xq = rng.standard_normal((40, 64), dtype=np.float32)
    sh = ShardedIndexFlat(64, storage=storage, devices=["cuda:0"] * 3)
    sh.add(xb[:20_000])
    sh.add(xb[20_000:])
    sel = SearchParams(sel=IDSelectorRange(1000, 25_000))
    for nq in (8, 40):
        q, _, nq_pad = sh._prep_queries(xq[:nq])
        for params in (None, sel):
            s = sh._sel_stream(params)
            for kw in (dict(force_plain=False),
                       dict(force_plain=False, full_sweep=True),
                       dict(force_plain=True)):
                with programs.eager():
                    ref = sh._run_search_fn(q, 10, nq_pad, sel=s, **kw)
                for _ in range(3):
                    got = sh._run_search_fn(q, 10, nq_pad, sel=s, **kw)
                    assert got[1:] == ref[1:]
                    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    # one device: one program a shape and route
    progs = _graphs_owned(sh.res, sh._owner)
    assert all(key[-1] == torch.device("cuda", 0)
               for key in sh.res._cache if key[1] == sh._owner)
    D1, I1 = sh.search(xq, 10, params=sel)
    D2, I2 = sh.search(xq, 10, params=sel)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    assert len(_graphs_owned(sh.res, sh._owner)) == len(progs)
    torch.cuda.synchronize()


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_replayed_sharded_ivf_equals_eager(dev, storage, tmp_path):
    """A TorchIndexIVFFlat reloaded sharded over cuda:0 named three times:
    the fine scan at nprobe 16 and the dense route (bf16: the fused one
    with its certificate, and its forced plain rerun) replay the eager
    search bit for bit."""
    from faiss_tpu_torch import (IDSelectorRange, SearchParams,
                                 TorchIndexIVFFlat, load_index, save_index)

    rng = np.random.default_rng(28)
    xb = rng.standard_normal((20_000, 64), dtype=np.float32)
    xq = rng.standard_normal((30, 64), dtype=np.float32)
    single = TorchIndexIVFFlat(64, 32, storage=storage, device=dev)
    single.train(xb)
    single.add(xb)
    path = str(tmp_path / "ivf.npz")
    save_index(single, path)
    sh = load_index(path, sharded=True, devices=["cuda:0"] * 3)
    for nprobe in (16, 32):
        for sel in (None, IDSelectorRange(500, 15_000)):
            p = SearchParams(sel=sel, nprobe=nprobe)
            for force in (False, True):
                with programs.eager():
                    ref = sh._search_packed(xq, 10, p,
                                            force_plain_dense=force)[0]
                for _ in range(3):
                    got = sh._search_packed(xq, 10, p,
                                            force_plain_dense=force)[0]
                    assert torch.equal(_bits(got), _bits(ref))
        Ds, Is = sh.search(xq, 10, params=SearchParams(nprobe=nprobe))
        D1, I1 = single.search(xq, 10, params=SearchParams(nprobe=nprobe))
        np.testing.assert_array_equal(Is, I1)
    _graphs_owned(sh.res, sh._owner)
    torch.cuda.synchronize()


def test_replayed_flat_range_equals_eager(dev):
    """The flat range pass at two radii is one graph (the second radius
    replays it: no new program), and the rerun's capacity another; each
    equals the eager pass bit for bit."""
    from faiss_tpu_torch.calls import range_threshold

    rng = np.random.default_rng(29)
    xb = rng.standard_normal((30_000, 64), dtype=np.float32)
    xq = rng.standard_normal((20, 64), dtype=np.float32)
    idx = TorchIndexFlat(64, device=dev)
    idx.add(xb)
    q, _, nq_pad = idx._prep_queries(xq)
    for i, radius in enumerate((75.0, 85.0)):
        thr = range_threshold(radius, idx.metric)
        for cap in (1024, 4096):
            with programs.eager():
                ref = idx._run_range(q, nq_pad, thr, cap, None)
            for _ in range(2):
                _equal_tuples(idx._run_range(q, nq_pad, thr, cap, None),
                              ref)
        assert len(_graphs_owned(idx.res, idx._owner)) == 2
    lims, _, _ = idx.range_search(xq, 110.0)     # past 1024 hits a chunk
    assert np.diff(lims).max() > 1024
    lims2, D2, I2 = idx.range_search(xq, 110.0)
    np.testing.assert_array_equal(lims, lims2)
    torch.cuda.synchronize()


def test_replayed_ivf_range_and_assign_equal_eager(dev):
    """The IVF range pass (the probe inside it) at two radii is one graph
    a capacity; the coarse assign of add one a padded batch size; each
    equals its eager run bit for bit, and an add keeps the assign's."""
    from faiss_tpu_torch import TorchIndexIVFFlat
    from faiss_tpu_torch.calls import range_threshold

    rng = np.random.default_rng(30)
    xb = rng.standard_normal((20_000, 64), dtype=np.float32)
    xq = rng.standard_normal((20, 64), dtype=np.float32)
    ivf = TorchIndexIVFFlat(64, 32, nprobe=8, device=dev)
    ivf.train(xb)
    for n0, n1 in ((0, 9000), (9000, 20_000)):   # pads to 16,384 rows both
        x = xb[n0:n1]
        with programs.eager():
            _, want = ivf._coarse_assign(x)
        for _ in range(3):
            xd, got = ivf._coarse_assign(x)
            np.testing.assert_array_equal(got, want)
            assert xd.shape[0] == n1 - n0
        ivf.add(x)
    assert len(_graphs_owned(ivf.res, ivf._assign_owner)) == 1
    q, _, _, nprobe, nbudget, sel = ivf._prep_search(xq, None)
    for radius in (95.0, 105.0):
        thr = range_threshold(radius, ivf.metric)
        for rcap in (1024, 64):
            with programs.eager():
                ref = ivf._run_range(q, nprobe, nbudget, thr, rcap, sel)
            for _ in range(2):
                _equal_tuples(ivf._run_range(q, nprobe, nbudget, thr, rcap,
                                             sel), ref)
    assert len(_graphs_owned(ivf.res, ivf._owner)) == 2
    lims, D, I = ivf.range_search(xq, 100.0)
    assert lims[-1] > 0
    torch.cuda.synchronize()


def test_sharded_shard_change_drops_the_programs(dev, monkeypatch):
    """A change made through the sharded index, or on a shard's store
    alone, drops the sharded index's graphs; the next search captures
    anew and equals a fresh index built by the same adds."""
    from faiss_tpu_torch import ShardedIndexFlat

    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)
    rng = np.random.default_rng(31)
    xb = rng.standard_normal((30_000, 64), dtype=np.float32)
    xq = rng.standard_normal((16, 64), dtype=np.float32)
    sh = ShardedIndexFlat(64, devices=["cuda:0"] * 2)
    sh.add(xb[:20_000])
    sh.search(xq, 10)
    _graphs_owned(sh.res, sh._owner)
    sh.add(xb[20_000:])
    assert not any(key[1] == sh._owner for key in sh.res._cache)
    D1, I1 = sh.search(xq, 10)
    fresh = ShardedIndexFlat(64, devices=["cuda:0"] * 2)
    fresh.add(xb[:20_000])
    fresh.add(xb[20_000:])
    D2, I2 = fresh.search(xq, 10)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    gen = sh._gen
    sh.shards[1].store.add(xb[:10])       # a shard's store changed alone
    sh.search(xq, 10)
    assert sh._gen > gen and len(_graphs_owned(sh.res, sh._owner)) == 1
    torch.cuda.synchronize()


def test_sharded_capture_meeting_a_host_sync_raises(dev, monkeypatch):
    """A shard search that synchronises with the host inside the sharded
    capture raises; nothing is cached and nothing ran eagerly in its
    place."""
    from faiss_tpu_torch import ShardedIndexFlat

    rng = np.random.default_rng(32)
    sh = ShardedIndexFlat(64, devices=["cuda:0"] * 2)
    sh.add(rng.standard_normal((10_000, 64), dtype=np.float32))
    xq = rng.standard_normal((8, 64), dtype=np.float32)
    local = TorchIndexFlat._search_local

    def syncing(self, q, k, **kw):
        vals, ids, cert = local(self, q, k, **kw)
        return vals * float(vals[0, 0].item() != 0.0), ids, cert

    monkeypatch.setattr(TorchIndexFlat, "_search_local", syncing)
    with pytest.raises(RuntimeError):
        sh.search(xq, 10)
    assert not any(key[1] == sh._owner for key in sh.res._cache)
    monkeypatch.setattr(TorchIndexFlat, "_search_local", local)
    D, I = sh.search(xq, 10)
    assert (I >= 0).all()
    torch.cuda.synchronize()


# -- an f16 index past 65,536 groups (the float16 benchmark cell's shape) ---

F16_HIER_ROWS = 8_400_000   # 65,632 groups: hierarchical phase 2


def _mixture_rows(dev, n, d, g, cents):
    """n normalised rows of a Gaussian mixture around ``cents``."""
    x = cents[torch.randint(0, cents.shape[0], (n,), generator=g,
                            device=dev)]
    x = x + 0.6 * torch.randn((n, d), generator=g, device=dev)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def test_f16_index_past_65536_groups(dev):
    """An f16 inner-product index of 8.4M normalised mixture rows (65,632
    groups, so the sweeps also write the supergroup maxes and phase 2 ranks
    them first) searched by 100 queries (nq_pad 104). On each sweep route,
    K7 (one query plane) and K6 (two: tier 1 and a pinned shape), the
    eager search launches that sweep and the block max once, its replays
    equal it bit for bit, and every certified row returns the plain path's
    ids, distances within the rescore term; K6 certifies all 100. K11 over K7's nominated groups
    equals K10 → K9 bit for bit and the plain version's ids, and the
    supergroup maxes equal block_max_plain of the same launch's gm."""
    from faiss_tpu_torch import calls

    d, k = 96, 10
    g = torch.Generator(device=dev).manual_seed(24)
    cents = torch.randn((1024, d), generator=g, device=dev)
    idx = TorchIndexFlat(d, metric="IP", storage="f16", device=dev)
    for i0 in range(0, F16_HIER_ROWS, 1_000_000):
        n = min(1_000_000, F16_HIER_ROWS - i0)
        idx.add(_mixture_rows(dev, n, d, g, cents).cpu().numpy())
    xq = _mixture_rows(dev, 100, d, g, cents).cpu().numpy()
    q, nq, nq_pad = idx._prep_queries(xq)
    st, nv_eff = idx.store, 8_400_896
    assert nq_pad == 104 and nv_eff // 128 == 65_632
    with programs.eager():
        plain = idx._run_search_fn(q, k, nq_pad, force_plain=True)
    d_p, i_p, _ = calls.unpack(plain[0].cpu().numpy(), k)
    tol = rescore_term(q[:nq], torch.sqrt(torch.amax(st.norms[:nv_eff])),
                       st.norms, nv_eff, d, MetricType.INNER_PRODUCT)
    for full_sweep, name in ((False, "sweep_f16_1"), (True, "sweep_f16_2")):
        n0 = dict(kernels.launches)
        with programs.eager():
            ref = idx._run_search_fn(q, k, nq_pad, force_plain=False,
                                     full_sweep=full_sweep)
        assert ref[1] and ref[2] == (not full_sweep)
        assert kernels.launches[name] == n0[name] + 1
        assert kernels.launches["sweep_block_max"] == \
            n0["sweep_block_max"] + 1
        assert _replays_equal_eager(idx, xq, k, force_plain=False,
                                    full_sweep=full_sweep)
        d_f, i_f, cert = calls.unpack(ref[0].cpu().numpy(), k)
        cert = cert[:nq]
        print(f"{name}: {int(cert.sum())} of {nq} queries certified")
        assert cert.any()
        if full_sweep:   # K6 over the f16 split certifies every query
            assert cert.all()
        np.testing.assert_array_equal(i_f[:nq][cert], i_p[:nq][cert])
        err = np.abs(d_f[:nq] - d_p[:nq]).max(axis=1)
        assert (err[cert] <= tol.cpu().numpy()[cert]).all()
    # K7's launch, its supergroup maxes, phase 2 over them, then K11
    metric = MetricType.INNER_PRODUCT
    vn = fused._premask_norms(st.norms, idx.ntotal, nv_eff, metric)
    q1, _ = fused.query_planes(q, 1)
    gm, bmax = kernels.sweep_f16(q1, None, st.db, vn, metric=metric,
                                 with_block_max=True)
    assert torch.equal(bmax.view(torch.int32),
                       fused.block_max_plain(gm).view(torch.int32))
    gidx, _ = fused._top_groups_from_bmax(gm, bmax, k + fused.GROUP_PAD,
                                          nv_eff // 128)
    gidx = torch.sort(gidx, dim=-1).values.to(torch.int32).contiguous()
    n0 = kernels.launches["rescore_select_f16"]
    vals, ids = kernels.rescore_select_groups(q, st.db, vn, gidx, idx.ntotal,
                                              k=k, metric=metric)
    assert kernels.launches["rescore_select_f16"] == n0 + 1
    cols = fused.candidate_columns(gidx)
    s = kernels.rescore_groups(q, st.db, vn, gidx, metric=metric)
    v2, p2 = kernels.final_select(
        s.masked_fill(fused.candidate_drop(gidx, idx.ntotal),
                      float("-inf")), k)
    assert torch.equal(vals.view(torch.int32), v2.view(torch.int32))
    assert torch.equal(ids, torch.gather(cols, 1, p2.to(torch.int64)))
    _, ip = fused.rescore_select_groups_plain(q, st.db, vn, gidx, idx.ntotal,
                                              k=k, metric=metric)
    assert torch.equal(ids, ip)
    torch.cuda.synchronize()
