"""The f16 query split of the f16 rows' two-plane sweep on the card (K6), on
the CPU.

On the card K6 sweeps the stored f16 rows as they are, an f16 wgmma,
against the query's f16 split (``storage.split_f32_f16``): two f16 planes,
each scaled per query by a power of two, the leading 11 significand bits
and the next 11, truncated toward zero. ``fused.sweep_query_split`` picks
that split from ``sweep_accum``'s answer ("mma" on the card), and
``fused_search`` makes it once, for the sweep and its certificate: the CPU route
keeps the JAX package's bf16 split and its pair arithmetic (the JAX-parity
tests of test_torch_f16.py run unchanged). Here the split itself, its
certificate (``_sweep_eps(f16_planes=)``: bf16 rows' form, s0 =
s1 = 0, R and L of the f16 planes), the plain twin over f16 planes
(``sweep_f16_plain``), and the whole flat route run on the CPU with the
split forced to "f16", as the card runs it. Tolerances: the split and its
reconstruction bit for bit (every step is exact); group maxes within ε of
an fp64 reference; index answers equal to the fp64 oracle over the stored
f16 rows (and, for the ±inf query, to f32 storage's answer).
"""

import numpy as np
import pytest
import torch

from faiss_tpu_torch import MetricType, TorchIndexFlat
from faiss_tpu_torch.ops import fused
from faiss_tpu_torch.storage import (decode_f16_bits, encode_f16_bits,
                                     flush_f16_subnormals, split_f32_bf16,
                                     split_f32_f16, split_stats)

torch.set_num_threads(2)

METRICS = [MetricType.L2, MetricType.INNER_PRODUCT]
METRIC_IDS = ["l2", "ip"]


def _normalised(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _rows(kind):
    """fp32 rows of one kind: Gaussian, normalised, integer-valued,
    wide-ranged (each row's components spread over 2^-60 … 2^60), and rows
    at the limits (f16's largest, values that round to f16's inf, fp32's
    largest and subnormals, f16's subnormals, zeros, a zero row)."""
    g = torch.Generator().manual_seed(5)
    if kind == "gauss":
        return torch.randn((64, 96), generator=g) * 3.0
    if kind == "normalised":
        return _normalised(64, 96, 6)
    if kind == "integers":
        return torch.randint(-300, 300, (64, 96), generator=g).float()
    if kind == "wide":
        e = torch.randint(-60, 61, (64, 96), generator=g).float()
        return torch.randn((64, 96), generator=g) * torch.exp2(e)
    x = torch.zeros((8, 8))
    x[0] = torch.tensor([65504.0, 65519.0, 65520.0, 1e5, 6e-8, 5.96e-8,
                         -1e-30, 0.0])
    x[1] = torch.tensor([3.4e38, -3.0e38, 1.0, 1e-45, -1e-40, 1e-20, 7.0,
                         0.5])
    x[2] = torch.tensor([1e-40, -2e-41, 1e-45, 0.0, 0.0, 0.0, 0.0, 5e-39])
    x[3] = torch.tensor([-1e-7, 3e-5, -65519.0, 65520.0, 7e4, 1.0, 1.0, 1.0])
    x[4] = torch.tensor([2.0 ** -14, 2.0 ** -15, 2.0 ** -24, 2.0 ** -25,
                         1.0, -1.0, 2.0 ** 15, -(2.0 ** 16)])
    x[5] = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -23,
                         -3.0, 0.1, 1e-3, 1e-6, 1e-9])
    return x        # rows 6, 7: zero


KINDS = ["gauss", "normalised", "integers", "wide", "limits"]


def _parts(x):
    """(hi·2^-eh, lo·2^-el, R) of the split of x, in float64."""
    hi, lo, sc = split_f32_f16(x)
    h = hi.double() * sc[:, 0:1].double()
    lo = lo.double() * sc[:, 1:2].double()
    return h, lo, x.double() - h - lo


@pytest.mark.parametrize("kind", KINDS)
def test_split_reproduces_the_query_bit_for_bit(kind):
    """qh·2^-eh + ql·2^-el + R == q bit for bit, R computed in fp32 the way
    ``_sweep_eps`` computes it (the subtractions exact); both planes are
    truncations toward zero (same sign, no larger), and R is below
    2^-21·‖q‖."""
    x = _rows(kind)
    hi, lo, sc = split_f32_f16(x)
    assert hi.dtype == lo.dtype == torch.float16
    assert sc.dtype == torch.float32 and sc.shape == (x.shape[0], 2)
    r32 = (x - hi.float() * sc[:, 0:1]) - lo.float() * sc[:, 1:2]
    h, low, r = _parts(x)
    assert torch.equal(r32.double(), r)
    assert torch.equal(h + low + r32.double(), x.double())
    assert bool((h.abs() <= x.double().abs()).all())
    assert bool((h * x.double() >= 0).all())
    assert bool((low.abs() <= (x.double() - h).abs()).all())
    qn = torch.linalg.vector_norm(x.double(), dim=1)
    assert bool((torch.linalg.vector_norm(r, dim=1) <= 2.0 ** -21 * qn).all())


@pytest.mark.parametrize("kind", KINDS)
def test_scales_are_powers_of_two(kind):
    """Each plane's scale is a normal fp32 power of two (2^-126 … 2^126),
    so that the kernel's __fmul_rn by it is exact, and a plane's largest
    component lies in [2^15, 2^16) unless its row is zero or its exponent
    was clamped."""
    x = _rows(kind)
    hi, lo, sc = split_f32_f16(x)
    m, e = torch.frexp(sc)
    assert bool((m == 0.5).all())
    assert bool(((e - 1 >= -126) & (e - 1 <= 126)).all())
    for plane, col in ((hi, 0), (lo, 1)):
        top = plane.float().abs().amax(dim=1)
        unclamped = (sc[:, col] > 2.0 ** -126) & (sc[:, col] < 2.0 ** 126)
        live = (top > 0) & unclamped
        assert bool(((top[live] >= 2.0 ** 15) & (top[live] < 2.0 ** 16))
                    .all())


def test_normalised_query_planes_hold_no_f16_subnormals():
    """10,000 normalised 96-d queries (the f16 cell's shape): neither plane
    holds an f16 subnormal pattern, so the kernel's operands are normal
    f16 or zero."""
    hi, lo, _ = split_f32_f16(_normalised(10_000, 96, 7))
    for plane in (hi, lo):
        b = plane.view(torch.int16)
        sub = ((b & 0x7C00) == 0) & ((b & 0x3FF) != 0)
        assert not bool(sub.any())


def test_components_near_the_f16_limits_stay_finite():
    """Rows with components at and past f16's range (65504, 65520, 1e5,
    fp32's largest, f16 and fp32 subnormals): every plane and scale is
    finite, and the reconstruction exact."""
    x = _rows("limits")
    hi, lo, sc = split_f32_f16(x)
    for t in (hi, lo, sc):
        assert bool(torch.isfinite(t).all())
    h, low, r = _parts(x)
    assert torch.equal(h + low + r, x.double())


def test_nonfinite_query_rows():
    """A row holding ±inf or NaN: its hi plane carries the non-finite
    component and its lo plane a NaN there, so the twin scores the row NaN,
    and its ε is NaN, so the certificate fails for it (the index re-runs it
    on the plain path); the finite rows' planes are unchanged."""
    x = _rows("gauss")[:6].clone()
    x[1, 3], x[2, 5], x[3, 0] = float("inf"), float("-inf"), float("nan")
    hi, lo, sc = split_f32_f16(x)
    clean = split_f32_f16(_rows("gauss")[:6])
    for i in (0, 4, 5):
        assert torch.equal(hi[i], clean[0][i]) and torch.equal(lo[i],
                                                               clean[1][i])
    assert bool(hi[1, 3].isposinf()) and bool(hi[2, 5].isneginf())
    assert bool(hi[3, 0].isnan())
    assert bool(lo[1, 3].isnan() & lo[2, 5].isnan() & lo[3, 0].isnan())
    assert bool(torch.isfinite(sc).all())
    db = torch.randn((1024, 96), generator=torch.Generator().manual_seed(2))
    bits = flush_f16_subnormals(encode_f16_bits(db))
    norms = (db * db).sum(-1)
    vn = fused._premask_norms(norms, 1024, 1024, MetricType.INNER_PRODUCT)
    gm = fused.sweep_f16_plain(hi, lo, bits, vn,
                               metric=MetricType.INNER_PRODUCT, scales=sc)
    assert bool(gm[1:4].isnan().all()) and bool(gm[[0, 4, 5]].isfinite().all())
    eps = fused._sweep_eps(x, norms, 1024, metric=MetricType.INNER_PRODUCT,
                           d_pad=96, accum="mma", f16_planes=(hi, lo, sc))
    assert bool(eps[1:4].isnan().all()) and bool(eps[[0, 4, 5]].isfinite()
                                                 .all())


@pytest.fixture(scope="module")
def f16_case():
    """f16 rows as the store keeps them (RNE, subnormals flushed), their
    exact values, fp32 norms and split statistics, and fp32 queries of
    three scales (the f16 split is scale-free; 1e-15 and 1e15 exercise the
    powers of two, and keep ‖q‖² inside fp32's normal range)."""
    rng = np.random.default_rng(11)
    nv, d = 4096, 96
    x = (rng.standard_normal((nv, d)) * 3.0).astype(np.float32)
    bits = flush_f16_subnormals(encode_f16_bits(torch.from_numpy(x)))
    v = decode_f16_bits(bits)
    q = torch.from_numpy(rng.standard_normal((24, d)).astype(np.float32))
    q[8:16] *= 1e-15
    q[16:] *= 1e15
    stats = split_stats(v, *split_f32_bf16(v))
    return bits, v, (torch.from_numpy(x) ** 2).sum(-1), q, stats


@pytest.mark.parametrize("metric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("accum", ["fmaf", "mma"])
def test_f16_planes_twin_within_the_f16_eps(f16_case, metric, accum):
    """The plain twin over f16 planes (K6's arithmetic: two fp32 products,
    each scaled, added once) against the fp64 group maxes of the stored
    rows: within _sweep_eps(f16_planes=) on queries of norm ≈ 10,
    1e-14 and 1e16."""
    bits, v, norms, q, _ = f16_case
    nv, d = v.shape
    hi, lo, sc = split_f32_f16(q)
    vn = fused._premask_norms(norms, nv, nv, metric)
    gm = fused.sweep_f16_plain(hi, lo, bits, vn, metric=metric, scales=sc)
    dots = q.double() @ v.double().T
    s = (2.0 * dots if metric is MetricType.L2 else dots) - vn.double()
    want = s.view(q.shape[0], nv // 128, 128).amax(-1)
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d, accum=accum,
                           f16_planes=(hi, lo, sc))
    err = (gm.double() - want).abs()
    assert bool((err <= eps.double()[:, None]).all())


@pytest.mark.parametrize("metric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("accum", ["fmaf", "mma"])
def test_f16_split_eps_below_the_pair_eps(f16_case, metric, accum):
    """The f16 split's ε is never above the bf16 pair ε that K6 was charged
    before (R ≈ 2^-22·Q for ≈ 2^-16·Q, L ≈ 2^-11·Q for ≈ 2^-8·Q, and no
    s0, s1 terms), and its R and L are those of the split."""
    bits, v, norms, q, stats = f16_case
    nv, d = v.shape
    kw = dict(metric=metric, d_pad=d, accum=accum)
    planes = split_f32_f16(q)
    new = fused._sweep_eps(q, norms, nv, pair_sweep=True, split_stats=stats,
                           f16_planes=planes, **kw)
    old = fused._sweep_eps(q, norms, nv, pair_sweep=True, split_stats=stats,
                           **kw)
    assert bool((new <= old).all())
    # strictly below where the query terms weigh (under L2 the tiny
    # queries' ε is the norms' rounding, 3·u·N, on both sides)
    assert bool((new < old)[:8].all()) and bool((new < old)[16:].all())
    # pair_sweep and split_stats do not enter the f16 split's ε
    same = fused._sweep_eps(q, norms, nv, f16_planes=planes, **kw)
    assert torch.equal(new, same)


def test_f16_split_eps_refuses_one_plane_and_unknown_splits(f16_case):
    """The f16 split's ε takes two planes, and only ``split_f32_f16``'s:
    one pass, the bf16 split's planes, or planes of other queries raise."""
    _, v, norms, q, _ = f16_case
    kw = dict(metric=MetricType.L2, d_pad=v.shape[1])
    planes = split_f32_f16(q)
    with pytest.raises(ValueError):
        fused._sweep_eps(q, norms, v.shape[0], single_pass=True,
                         f16_planes=planes, **kw)
    with pytest.raises(ValueError):
        fused._sweep_eps(q, norms, v.shape[0],
                         f16_planes=(*split_f32_bf16(q), planes[2]), **kw)
    with pytest.raises(ValueError):
        fused._sweep_eps(q, norms, v.shape[0],
                         f16_planes=split_f32_f16(q[:8]), **kw)


# (route, query planes, device) → the query split: f16 with two planes on
# the card (K6) alone takes the f16 split
SPLIT_CASES = [("f16", 2, "cuda", "f16"), ("f16", 1, "cuda", "bf16")] + [
    (r, p, dev, "bf16") for r in fused.SWEEP_ROUTES for p in (1, 2)
    for dev in ("cpu", "cuda") if (r, dev) != ("f16", "cuda")]


@pytest.mark.parametrize("route,passes,device,want", SPLIT_CASES)
def test_sweep_query_split_by_route(route, passes, device, want):
    """The split follows the route's accumulation, ``sweep_accum``'s
    answer for the device, as ``fused_search`` asks for it."""
    accum = fused.sweep_accum(route, passes, torch.device(device))
    assert fused.sweep_query_split(route, passes, accum) == want


def test_sweep_query_split_refuses_unknown_routes():
    with pytest.raises(ValueError):
        fused.sweep_query_split("f32", 2, "mma")


def _recording_sweep(monkeypatch):
    """Wrap ``fused.sweep_f16`` to record the (q_hi dtype, q_lo dtype,
    scales given) of each call."""
    calls, real = [], fused.sweep_f16

    def rec(q_hi, q_lo, *a, scales=None, **kw):
        calls.append((q_hi.dtype, None if q_lo is None else q_lo.dtype,
                      scales is not None))
        return real(q_hi, q_lo, *a, scales=scales, **kw)
    monkeypatch.setattr(fused, "sweep_f16", rec)
    return calls


@pytest.mark.parametrize("passes", [1, 2])
def test_cpu_route_keeps_the_bf16_split(f16_case, passes, monkeypatch):
    """On the CPU the f16 route takes ``query_planes``' bf16 planes and no
    scales (``sweep_query_split`` says "bf16"), and the f16 sweep's group
    maxes are the bf16 pair arithmetic's, bit for bit."""
    bits, v, norms, q, _ = f16_case
    accum = fused.sweep_accum("f16", passes, q.device)
    assert fused.sweep_query_split("f16", passes, accum) == "bf16"
    calls = _recording_sweep(monkeypatch)
    vn = fused._premask_norms(norms, v.shape[0], v.shape[0], MetricType.L2)
    gm = fused.groupmax_scores(q, bits, vn, metric=MetricType.L2,
                               sweep_passes=passes)
    want = fused.query_planes(q, passes)
    pair = fused.sweep_f16_plain(*want, bits, vn, metric=MetricType.L2)
    assert torch.equal(gm, pair)
    fused.fused_search(q, bits, norms, v.shape[0], k=10,
                       metric=MetricType.L2, nv_eff=v.shape[0],
                       sweep_passes=passes)
    lo = None if passes == 1 else torch.bfloat16
    assert calls == [(torch.bfloat16, lo, False)] * 2


@pytest.fixture
def card_split(monkeypatch):
    """The card's choice of split on the CPU: "f16" for the f16 rows' two
    query planes, through ``fused.sweep_query_split`` (which
    ``fused_search`` asks once, for the sweep and the certificate)."""
    real = fused.sweep_query_split
    monkeypatch.setattr(fused, "sweep_query_split", lambda r, p, acc: (
        "f16" if r == "f16" and p == 2 else real(r, p, acc)))
    gate = lambda **kw: kw["nv_eff"] >= 8192  # noqa: E731
    monkeypatch.setattr(fused, "fused_path_eligible", gate)


def test_groupmax_scores_takes_the_split_the_route_names(f16_case,
                                                         card_split,
                                                         monkeypatch):
    """With the card's split, ``fused_search`` sweeps the two-plane f16
    route over the f16 planes and their scales (the twin of K6) and the
    one-plane route over its bf16 plane; ``groupmax_scores`` sweeps the
    f16 planes it is given, else the bf16 split."""
    bits, v, norms, q, _ = f16_case
    nv = v.shape[0]
    ip = MetricType.INNER_PRODUCT
    calls = _recording_sweep(monkeypatch)
    for passes in (2, 1):
        fused.fused_search(q, bits, norms, nv, k=10, metric=ip, nv_eff=nv,
                           sweep_passes=passes)
    assert calls == [(torch.float16, torch.float16, True),
                     (torch.bfloat16, None, False)]
    vn = fused._premask_norms(norms, nv, nv, ip)
    hi, lo, sc = split_f32_f16(q)
    gm = fused.groupmax_scores(q, bits, vn, metric=ip, sweep_passes=2,
                               f16_planes=(hi, lo, sc))
    assert torch.equal(gm, fused.sweep_f16_plain(hi, lo, bits, vn, metric=ip,
                                                 scales=sc))
    gm2 = fused.groupmax_scores(q, bits, vn, metric=ip, sweep_passes=2)
    assert torch.equal(gm2, fused.sweep_f16_plain(
        *fused.query_planes(q, 2), bits, vn, metric=ip))
    gm1 = fused.groupmax_scores(q, bits, vn, metric=ip, sweep_passes=1)
    q1, _ = fused.query_planes(q, 1)
    assert torch.equal(gm1, fused.sweep_f16_plain(q1, None, bits, vn,
                                                  metric=ip))


def _oracle_ids(v, xq, k, metric):
    """fp64 top-k ids over the stored rows, ties to the lowest id."""
    q = torch.from_numpy(xq).double()
    dots = q @ v.double().T
    s = 2.0 * dots - (v.double() ** 2).sum(-1)[None, :] \
        if metric is MetricType.L2 else dots
    order = np.lexsort((np.broadcast_to(np.arange(v.shape[0]), s.shape),
                        -s.numpy()), axis=1)
    return order[:, :k]


@pytest.mark.parametrize("metric", METRICS, ids=METRIC_IDS)
def test_index_with_the_card_split_matches_the_oracle(card_split, metric):
    """A TorchIndexFlat(storage="f16") search at nq 8 (two query planes
    from the start) on the CPU with the card's split: the fused route
    certifies every query with the f16 split's ε and returns the fp64
    oracle's ids over the stored f16 rows."""
    rng = np.random.default_rng(12)
    xb = rng.standard_normal((20_000, 96)).astype(np.float32)
    xq = rng.standard_normal((8, 96)).astype(np.float32)
    idx = TorchIndexFlat(96, metric=metric, storage="f16", device="cpu")
    idx.add(xb)
    D, I = idx.search(xq, 10)
    assert idx.fused_fallbacks == 0
    v = decode_f16_bits(idx.store.db[: idx.ntotal, :96])
    np.testing.assert_array_equal(I, _oracle_ids(v, xq, 10, metric))


def test_inf_query_ip_with_the_card_split(card_split):
    """The ±inf query under IP with the card's split keeps the port's
    contract (test_torch_nonfinite.py's repair of the reference fault): its
    certificate fails, the plain path re-runs it, and the answer is f32
    storage's, the rows that score +inf, lowest id first; the finite
    queries equal the bf16 split's answer."""
    rng = np.random.default_rng(8)
    nv, d, k = 16384, 64, 10
    xb = rng.standard_normal((nv, d)).astype(np.float32)
    xq = rng.standard_normal((8, d)).astype(np.float32)
    xq[0, 3], xq[1, 5] = np.inf, -np.inf
    ref = TorchIndexFlat(d, metric="IP", storage="f32", device="cpu")
    ref.add(xb)
    D_f32, I_f32 = ref.search(xq, k)
    idx = TorchIndexFlat(d, metric="IP", storage="f16", device="cpu")
    idx.add(xb)
    D, I = idx.search(xq, k)
    assert idx.fused_fallbacks >= 1
    np.testing.assert_array_equal(I[:2], I_f32[:2])
    np.testing.assert_array_equal(D[:2], D_f32[:2])
    v = decode_f16_bits(idx.store.db[: idx.ntotal, :d])
    np.testing.assert_array_equal(
        I[2:], _oracle_ids(v, xq[2:], k, MetricType.INNER_PRODUCT))
