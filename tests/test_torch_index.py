"""TorchIndexFlat against TpuIndexFlat (bf16 storage), on the CPU.

The JAX index runs its fused path through the Pallas kernels in interpret
mode (it picks that mode by itself off a TPU); the port runs the kernels'
plain versions. At these sizes both cost models pick the plain path, so
tests of the fused path open the gate in both packages as
tests/test_pallas_fused.py does. Tolerances: ids and certificate outcomes
equal; distances within the query's ε (_sweep_eps), plus the norm
difference where the two packages computed the norms themselves.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from faiss_tpu import TpuIndexFlat
from faiss_tpu import io as jio
from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu_torch import (KernelTuning, TorchIndexFlat,
                             index_numpy_to_torch, load_index)
from faiss_tpu_torch.ops import fused
from faiss_tpu_torch.storage import ROW_TILE, _round_up

from common import compare_results, make_data, numpy_search
from torch_parity import (METRIC_IDS, METRICS, assert_within_eps, bf16_bits,
                          bits_of)

torch.set_num_threads(2)

NV, D, NQ, K = 20000, 128, 8, 10


@pytest.fixture
def open_gate(monkeypatch):
    """Fused path from 8192 rows in both packages."""
    gate = lambda **kw: kw["nv_eff"] >= 8192  # noqa: E731
    monkeypatch.setattr(pf, "fused_path_eligible", gate)
    monkeypatch.setattr(fused, "fused_path_eligible", gate)


@pytest.fixture(scope="module")
def data():
    return make_data(NV, NQ, D, seed=77)


def _jax_index(xb, jmetric):
    idx = TpuIndexFlat(D, metric=jmetric, storage="bf16")
    idx.add(xb)
    return idx


def _eps(idx, xq, metric):
    q, _, _ = idx._prep_queries(xq)
    nv_eff = _round_up(idx.ntotal, ROW_TILE)
    return fused._sweep_eps(q, idx.store.norms, nv_eff, metric=metric,
                            d_pad=idx.store.d_pad)[: len(xq)].numpy()


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_state_carry_from_jax_npz(open_gate, data, tmp_path, metric,
                                  jmetric):
    """A file saved by faiss_tpu loads with the same stored bits and norms,
    and searches to the same ids."""
    xb, xq = data
    jidx = _jax_index(xb, jmetric)
    path = str(tmp_path / "flat.npz")
    jio.save_index(jidx, path)
    idx = load_index(path, device="cpu")
    assert (idx.metric, idx.ntotal, idx.d) == (metric, NV, D)
    np.testing.assert_array_equal(
        bits_of(idx.store.db[:NV]), jio._raw_bits(jidx.store, NV))
    np.testing.assert_array_equal(
        idx.store.norms[:NV].numpy(), np.asarray(jidx.store.norms)[:NV])

    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = idx.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    assert idx.fused_fallbacks == jidx.fused_fallbacks == 0
    assert_within_eps(D_t, D_j, _eps(idx, xq, metric), "distances")
    D_ref, I_ref = numpy_search(xb, xq, K, metric.value)
    compare_results(D_t, I_t, D_ref, I_ref, dist_tol=5e-2, k=K,
                    label=f"bf16 {metric.value}")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_independent_build_matches_jax(open_gate, data, metric, jmetric):
    """Both packages quantize the same fp32 data to the same bits (RNE);
    their fp32 norm sums may differ in the last ulp."""
    xb, xq = data
    jidx = _jax_index(xb, jmetric)
    idx = TorchIndexFlat(D, metric=metric, storage="bf16", device="cpu")
    idx.add(xb)
    np.testing.assert_array_equal(bits_of(idx.store.db[:NV]),
                                  jio._raw_bits(jidx.store, NV))
    n_j = np.asarray(jidx.store.norms)[:NV]
    n_t = idx.store.norms[:NV].numpy()
    np.testing.assert_allclose(n_t, n_j, rtol=1e-6)
    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = idx.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    assert_within_eps(D_t, D_j,
                      _eps(idx, xq, metric) + np.abs(n_t - n_j).max(),
                      "distances")


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_plain_path_matches_jax(data, metric, jmetric):
    """Plain path, chunked (three chunks and a tail) against force_xla."""
    xb, xq = data
    jidx = _jax_index(xb, jmetric)
    jidx.set_force_xla(True)
    idx = TorchIndexFlat(D, metric=metric, storage="bf16", device="cpu",
                         tuning=KernelTuning(chunk_v=6144))
    idx.add(xb)
    idx.set_force_plain(True)
    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = idx.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("n,k", [(0, 5), (5, 8), (100, 7)])
def test_sentinels_match_jax(metric, jmetric, n, k):
    """Empty index and k > ntotal: worst distance and label -1 past the
    stored rows (n=100 takes the direct L2 path in both packages)."""
    xb, xq = make_data(max(n, 1), 3, D, seed=5)
    jidx = TpuIndexFlat(D, metric=jmetric, storage="bf16")
    idx = TorchIndexFlat(D, metric=metric, storage="bf16", device="cpu")
    if n:
        jidx.add(xb[:n])
        idx.add(xb[:n])
    D_j, I_j = jidx.search(xq, k)
    D_t, I_t = idx.search(xq, k)
    assert D_t.dtype == np.float32 and I_t.dtype == np.int64
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-5, atol=1e-3)
    if n < k:
        assert (I_t[:, n:] == -1).all()
        assert (D_t[:, n:] == (np.inf if metric.value == "l2" else -np.inf)
                ).all()


def test_bad_arguments():
    idx = TorchIndexFlat(D, device="cpu")
    idx.add(make_data(50, 1, D)[0])
    with pytest.raises(ValueError):
        idx.search(np.zeros((2, D + 1), np.float32), 3)
    for k in (0, -1):
        with pytest.raises(ValueError):
            idx.search(np.zeros((2, D), np.float32), k)
    with pytest.raises(ValueError):
        idx.add(np.zeros((2, D - 1), np.float32))
    with pytest.raises(IndexError):
        idx.reconstruct(50)
    with pytest.raises(ValueError):
        TorchIndexFlat(D, storage="f8", device="cpu")
    with pytest.raises(RuntimeError):              # int8 scales frozen
        i8 = TorchIndexFlat(D, storage="int8", device="cpu")
        i8.train(np.ones((4, D), np.float32))
        i8.train(np.ones((4, D), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TorchIndexFlat(D)             # the default device is "cuda"


def test_search_async_and_reconstruct(open_gate, data):
    xb, xq = data
    idx = index_numpy_to_torch(xb, storage="bf16", device="cpu")
    tok = idx.search_async(xq, K)
    assert tok.is_ready()
    D1, I1 = tok.wait()
    D2, I2 = idx.search(xq[0], K)          # 1-D query
    np.testing.assert_array_equal(I1[:1], I2)
    np.testing.assert_array_equal(D1[:1], D2)
    stored = (bf16_bits(xb[3:5]).astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(idx.reconstruct_n(3, 2), stored)
    np.testing.assert_array_equal(idx.reconstruct(4), stored[1])
    assert idx.store.capacity == 20480      # doubling from a 1024-row floor
    idx.add(xb[:1000])
    assert idx.store.capacity == 40960
    idx.reset()
    assert idx.ntotal == 0 and idx.search(xq, 3)[1].max() == -1


@pytest.mark.parametrize("nq", [4, 32])
def test_duplicated_vectors_fall_back_like_jax(open_gate, nq):
    """Every score ties, so no certificate holds. nq=32 starts on the
    one-plane sweep: tier 1 (two planes) fails too, tier 2 (plain) answers,
    and the shape is pinned to two planes. nq=4 starts on two planes and
    goes straight to tier 2. Ids equal JAX's: 0..k-1, lowest id first."""
    rng = np.random.default_rng(13)
    row = rng.standard_normal(D).astype(np.float32)
    xb = np.tile(row, (9000, 1))
    xq = rng.standard_normal((nq, D)).astype(np.float32)
    jidx = _jax_index(xb, METRICS[0][1])
    idx = TorchIndexFlat(D, storage="bf16", device="cpu")
    idx.add(xb)
    _, I_j = jidx.search(xq, K)
    _, I_t = idx.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_array_equal(I_t, np.tile(np.arange(K), (nq, 1)))
    assert idx.fused_fallbacks == jidx.fused_fallbacks == 1
    assert idx._no_reduced_sweep == jidx._no_reduced_sweep
    assert idx._no_reduced_sweep == ({32} if nq == 32 else set())
    _, I_t2 = idx.search_async(xq, K).wait()
    np.testing.assert_array_equal(I_t2, I_t)
    assert idx.fused_fallbacks == 2
    idx.reset()
    assert not idx._no_reduced_sweep


def test_import_leaves_jax_out():
    """The port imports torch and numpy, never jax or faiss_tpu."""
    code = ("import sys, faiss_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'faiss_tpu')]; "
            "assert not bad, bad; "
            "from faiss_tpu_torch.ops import kernels; "
            "assert kernels._lib_handle is None")
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
