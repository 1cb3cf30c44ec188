"""faiss_tpu_torch: exact (flat) vector search on PyTorch + CUDA.

A port of ``faiss_tpu`` (JAX on a TPU) to one NVIDIA H100, module by module
beside the original, which stays the reference it is tested against. This
package imports torch and numpy, never jax or faiss_tpu.

The slice ported so far: the flat index with bf16 storage, L2 and IP, add /
search / search_async, the fused search (four hand-written CUDA kernels in
``csrc/``, built with nvcc at first use) with its exactness certificate and
two-tier fallback, and the plain path.

    TorchIndexFlat, TorchSearchToken, index_numpy_to_torch
    MetricType, StorageType
    load_index, index_from_arrays     (files saved by faiss_tpu.save_index)
    query_device_capabilities, gpu_name_and_power_limit
"""

from .dtypes import MetricType, StorageType
from .index import TorchIndexFlat, TorchSearchToken, index_numpy_to_torch
from .io import index_from_arrays, load_index
from .resources import (DeviceCapabilities, KernelTuning,
                        gpu_name_and_power_limit, query_device_capabilities)

__all__ = [
    "MetricType", "StorageType",
    "TorchIndexFlat", "TorchSearchToken", "index_numpy_to_torch",
    "index_from_arrays", "load_index",
    "DeviceCapabilities", "KernelTuning", "gpu_name_and_power_limit",
    "query_device_capabilities",
]
