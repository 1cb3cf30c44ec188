"""The faiss IndexFlat interop: index_cpu_to_torch / index_torch_to_cpu
against faiss_tpu's index_cpu_to_tpu / index_tpu_to_cpu.

faiss is not installed here, so a stand-in ``faiss`` module goes into
``sys.modules`` (the one of tests/test_faiss_interop.py, rebuilt here): an
IndexFlat with ``d``, ``metric_type``, ``ntotal``, ``add`` and
``reconstruct_n``, and faiss's metric constants (METRIC_L2 = 1,
METRIC_INNER_PRODUCT = 0). Both packages convert the same stand-in index
and return the same ids; f32 rows go back bit for bit, reduced precision
through the decode.
"""

import sys
import types

import numpy as np
import pytest
import torch

import faiss_tpu
from faiss_tpu.index import index_cpu_to_tpu, index_tpu_to_cpu
from faiss_tpu_torch import (MetricType, StorageType, TorchIndexFlat,
                             index_cpu_to_torch, index_torch_to_cpu)

torch.set_num_threads(2)


class _FakeIndexFlat:
    def __init__(self, d, metric):
        self.d, self.metric_type, self.ntotal = d, metric, 0
        self._xb = np.zeros((0, d), np.float32)

    def add(self, x):
        x = np.ascontiguousarray(x, np.float32).reshape(-1, self.d)
        self._xb = np.concatenate([self._xb, x], axis=0)
        self.ntotal = len(self._xb)

    def reconstruct_n(self, i0, n):
        return self._xb[i0:i0 + n].copy()


@pytest.fixture
def faiss(monkeypatch):
    mod = types.ModuleType("faiss")
    mod.METRIC_L2, mod.METRIC_INNER_PRODUCT = 1, 0
    mod.IndexFlat = _FakeIndexFlat
    monkeypatch.setitem(sys.modules, "faiss", mod)
    return mod


def _data(n=3000, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((8, d)).astype(np.float32))


@pytest.mark.parametrize("metric,storage", [("l2", "f32"), ("ip", "bf16")])
def test_cpu_to_torch_equals_reference(faiss, metric, storage):
    xb, xq = _data()
    cpu = faiss.IndexFlat(64, faiss.METRIC_L2 if metric == "l2"
                          else faiss.METRIC_INNER_PRODUCT)
    cpu.add(xb)
    t = index_cpu_to_torch(cpu, storage=storage, device="cpu")
    j = index_cpu_to_tpu(cpu, storage=storage)
    assert isinstance(t, TorchIndexFlat)
    assert t.metric is MetricType.coerce(metric)
    assert t.storage_type is StorageType.coerce(storage)
    assert (t.ntotal, t.d) == (cpu.ntotal, cpu.d)
    D_t, I_t = t.search(xq, 10)
    D_j, I_j = j.search(xq, 10)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_torch_to_cpu_f32_round_trips_bits(faiss, metric):
    xb, _ = _data(seed=1)
    t = TorchIndexFlat(64, metric=metric, device="cpu")
    t.add(xb)
    cpu = index_torch_to_cpu(t)
    assert cpu.metric_type == (faiss.METRIC_L2 if metric == "l2"
                               else faiss.METRIC_INNER_PRODUCT)
    assert (cpu.d, cpu.ntotal) == (64, len(xb))
    np.testing.assert_array_equal(
        cpu.reconstruct_n(0, cpu.ntotal).view(np.uint32), xb.view(np.uint32))
    back = index_cpu_to_torch(cpu, device="cpu")
    np.testing.assert_array_equal(back.vectors_numpy(), xb)


@pytest.mark.parametrize("storage", ["bf16", "f16", "int8"])
def test_torch_to_cpu_reduced_goes_through_decode(faiss, storage):
    xb, _ = _data(2000, 32, seed=2)
    t = TorchIndexFlat(32, storage=storage, device="cpu")
    t.add(xb)
    assert t.vectors_numpy() is None
    cpu = index_torch_to_cpu(t)
    got = cpu.reconstruct_n(0, cpu.ntotal)
    np.testing.assert_array_equal(got, t.reconstruct_n(0, t.ntotal))
    # the reference's export of the same storage decodes to the same values
    j = faiss_tpu.TpuIndexFlat(32, storage=storage)
    j.add(xb)
    np.testing.assert_array_equal(
        index_tpu_to_cpu(j).reconstruct_n(0, len(xb)), got)


def test_torch_to_cpu_empty_index(faiss):
    t = TorchIndexFlat(16, metric="ip", device="cpu")
    cpu = index_torch_to_cpu(t)
    assert cpu.ntotal == 0 and cpu.d == 16
    assert cpu.metric_type == faiss.METRIC_INNER_PRODUCT
    jcpu = index_tpu_to_cpu(faiss_tpu.TpuIndexFlat(16, metric="ip"))
    assert (jcpu.ntotal, jcpu.d, jcpu.metric_type) == (0, 16, 0)


def test_missing_faiss_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "faiss", None)
    t = TorchIndexFlat(8, device="cpu")
    with pytest.raises(ImportError, match="faiss is not installed"):
        index_torch_to_cpu(t)
    with pytest.raises(ImportError, match="faiss is not installed"):
        index_cpu_to_torch(object(), device="cpu")


@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "int8"])
def test_storage_predicates(storage):
    t = TorchIndexFlat(8, storage=storage, device="cpu")
    j = faiss_tpu.TpuIndexFlat(8, storage=storage)
    assert t.is_float16_storage() == j.is_float16_storage() \
        == (storage == "f16")
    assert t.is_bfloat16_storage() == j.is_bfloat16_storage() \
        == (storage == "bf16")
