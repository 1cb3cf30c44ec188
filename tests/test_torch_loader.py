"""The dataset loader: faiss_tpu_torch.loader against faiss_tpu.loader.

The readers yield faiss_tpu's batches bit for bit on the same small .npy,
.fvecs and .bvecs files; ``build_index_from_file`` builds indexes that
return faiss_tpu's ids: f32, bf16 with a first batch above the native
conversion threshold, integer rows from .fvecs in 5 batches (split
statistics (0, 0): hi_exact), and sharded over ["cpu"] * 4 against the
port's unsharded index.
"""


import numpy as np
import pytest
import torch

from faiss_tpu import loader as jloader
from faiss_tpu_torch import ShardedIndexFlat, TorchIndexFlat, loader, native

from torch_parity import bits_of

torch.set_num_threads(2)


def _write_fvecs(path, x):
    n, d = x.shape
    rows = np.empty((n, d + 1), np.float32)
    rows[:, 0] = np.frombuffer(np.full(n, d, np.int32).tobytes(), np.float32)
    rows[:, 1:] = x
    rows.tofile(path)


def _write_bvecs(path, x):
    n, d = x.shape
    out = np.empty((n, 4 + d), np.uint8)
    out[:, :4] = np.frombuffer(np.int32(d).tobytes(), np.uint8)[None, :]
    out[:, 4:] = x
    out.tofile(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3001, 24)).astype(np.float32)
    xi = rng.integers(0, 256, (2999, 16)).astype(np.uint8)
    paths = {"npy": str(tmp / "base.npy"), "fvecs": str(tmp / "base.fvecs"),
             "bvecs": str(tmp / "base.bvecs")}
    np.save(paths["npy"], x)
    _write_fvecs(paths["fvecs"], x)
    _write_bvecs(paths["bvecs"], xi)
    return paths, x, xi


@pytest.mark.parametrize("batch_rows", [700, 1000, 1 << 18])
@pytest.mark.parametrize("fmt", ["npy", "fvecs", "bvecs"])
def test_batches_equal_reference(files, fmt, batch_rows):
    paths, x, xi = files
    reader = f"iter_{fmt}_batches"
    got = list(getattr(loader, reader)(paths[fmt], batch_rows))
    want = list(getattr(jloader, reader)(paths[fmt], batch_rows))
    assert len(got) == len(want) == -(-len(x if fmt != "bvecs" else xi)
                                      // batch_rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    got_f = list(loader.iter_file_batches(paths[fmt], batch_rows))
    np.testing.assert_array_equal(np.concatenate(got_f),
                                  np.concatenate(want))
    full = x if fmt != "bvecs" else xi.astype(np.float32)
    np.testing.assert_array_equal(np.concatenate(got), full)


def _search_both(jidx, tidx, d, k=10, seed=1):
    xq = np.random.default_rng(seed).standard_normal((8, d)).astype(
        np.float32)
    D_j, I_j = jidx.search(xq, k)
    D_t, I_t = tidx.search(xq, k)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-4, atol=1e-3)
    return I_t


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_f32_equals_reference(files, metric):
    paths, x, _ = files
    jidx = jloader.build_index_from_file(paths["fvecs"], metric=metric,
                                         batch_rows=700)
    tidx = loader.build_index_from_file(paths["fvecs"], metric=metric,
                                        device="cpu", batch_rows=700)
    assert isinstance(tidx, TorchIndexFlat) and tidx.ntotal == len(x)
    np.testing.assert_array_equal(tidx.vectors_numpy(), x)
    _search_both(jidx, tidx, x.shape[1])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_bf16_native_batch_equals_reference(tmp_path, metric):
    """10,000×128 in batches of 8192 rows: the first batch (2^20
    elements) converts on the host in both packages, the second on the
    device. Stored bits, norms and ids equal faiss_tpu's."""
    x = np.random.default_rng(2).standard_normal((10_000, 128)).astype(
        np.float32)
    p = str(tmp_path / "base.npy")
    np.save(p, x)
    native.reset_calls()
    jidx = jloader.build_index_from_file(p, metric=metric, storage="bf16",
                                         batch_rows=8192)
    tidx = loader.build_index_from_file(p, metric=metric, storage="bf16",
                                        device="cpu", batch_rows=8192)
    assert native.calls["f32_to_bf16"] == 1
    n = len(x)
    np.testing.assert_array_equal(
        bits_of(tidx.store.db[:n]), np.asarray(jidx.store.db)[:n].view(
            np.uint16))
    np.testing.assert_array_equal(
        tidx.store.norms[:8192].numpy().view(np.uint32),
        np.asarray(jidx.store.norms)[:8192].view(np.uint32))
    _search_both(jidx, tidx, 128)


def test_integer_fvecs_in_five_batches_is_hi_exact(tmp_path):
    rng = np.random.default_rng(4)
    xb = rng.integers(0, 218, (3000, 32)).astype(np.float32)
    p = str(tmp_path / "sift.fvecs")
    _write_fvecs(p, xb)
    jidx = jloader.build_index_from_file(p, batch_rows=700)
    tidx = loader.build_index_from_file(p, device="cpu", batch_rows=700)
    assert tidx.store.split_stats_host() == (0.0, 0.0)
    assert jidx.store.split_stats_host() == (0.0, 0.0)
    assert "hi_exact=True" in tidx.describe()
    _search_both(jidx, tidx, 32, k=5, seed=5)


@pytest.mark.parametrize("fmt", ["npy", "bvecs"])
def test_build_sharded_equals_unsharded(files, fmt):
    paths, x, xi = files
    sh = loader.build_index_from_file(paths[fmt], sharded=True,
                                      devices=["cpu"] * 4, batch_rows=1000)
    one = loader.build_index_from_file(paths[fmt], device="cpu",
                                       batch_rows=1000)
    assert isinstance(sh, ShardedIndexFlat) and sh.num_shards == 4
    assert sh.ntotal == one.ntotal
    d = x.shape[1] if fmt == "npy" else xi.shape[1]
    xq = np.random.default_rng(3).standard_normal((8, d)).astype(np.float32)
    D_s, I_s = sh.search(xq, 10)
    D_o, I_o = one.search(xq, 10)
    np.testing.assert_array_equal(I_s, I_o)
    np.testing.assert_array_equal(D_s, D_o)


def test_bad_format(tmp_path):
    p = str(tmp_path / "x.bin")
    with open(p, "wb") as f:
        f.write(b"xx")
    with pytest.raises(ValueError, match="unsupported dataset format"):
        list(loader.iter_file_batches(p))
    with pytest.raises(ValueError):
        loader.build_index_from_file(p, device="cpu")
    bad = str(tmp_path / "bad.fvecs")
    np.array([4, 0, 0], np.int32).tofile(bad)   # 12 bytes: not whole rows
    with pytest.raises(ValueError, match="whole number"):
        list(loader.iter_fvecs_batches(bad))
    with pytest.raises(ValueError, match="whole number"):
        list(jloader.iter_fvecs_batches(bad))


@pytest.mark.parametrize("fmt", ["fvecs", "bvecs"])
def test_empty_file(tmp_path, fmt):
    p = str(tmp_path / f"empty.{fmt}")
    open(p, "wb").close()
    assert list(loader.iter_file_batches(p)) == []
    with pytest.raises(ValueError, match="empty"):
        loader.build_index_from_file(p, device="cpu")
    idx = loader.build_index_from_file(p, d=16, storage="bf16",
                                       device="cpu")
    jidx = jloader.build_index_from_file(p, d=16, storage="bf16")
    assert idx.ntotal == jidx.ntotal == 0 and idx.d == jidx.d == 16
    D, I = idx.search(np.zeros((2, 16), np.float32), 3)
    assert (I == -1).all() and np.isinf(D).all()
