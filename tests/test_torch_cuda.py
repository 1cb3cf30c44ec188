"""faiss_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA card. The module
imports neither jax nor faiss_tpu, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX.) Tolerances: selects equal
bit for bit; sweep and rescore within the query's two-plane ε, which bounds
the accumulation error of both sides.
"""

import time

import numpy as np
import pytest
import torch

from faiss_tpu_torch import MetricType, TorchIndexFlat
from faiss_tpu_torch.ops import distance, fused, kernels

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
    assert bool((err <= eps[:, None]).all()), float(err.max())


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("nq,d,passes", [(8, 8, 2), (37, 136, 1),
                                         (104, 128, 1), (104, 128, 2)])
def test_sweep_and_rescore_match_plain(dev, metric, nq, d, passes):
    nv, ntotal = 8192, 8000
    db, norms = _db(dev, nv, d, ntotal)
    q = torch.randn((nq, d), generator=torch.Generator().manual_seed(1)).to(dev)
    vn = fused._premask_norms(norms, ntotal, nv, metric)
    eps = fused._sweep_eps(q, norms, nv, metric=metric, d_pad=d)
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
    idx = TorchIndexFlat(96, metric=metric, device=dev)
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
    idx = TorchIndexFlat(64, device=dev)
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
