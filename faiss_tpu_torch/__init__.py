"""faiss_tpu_torch: exact (flat) and IVF vector search on PyTorch + CUDA.

A port of ``faiss_tpu`` (JAX on a TPU) to one NVIDIA H100, module by module
beside the original, which stays the reference it is tested against. This
package imports torch and numpy, never jax or faiss_tpu.

The slices ported so far: the flat index with f32 storage (the default, as
in ``faiss_tpu``: master rows, bf16 (hi, lo) planes, exact split statistics,
``keep_master=False`` pair-only storage, the hi_exact dispatch on
integer-valued data), with bf16 storage, with f16 storage (the f16 bit
patterns, decoded in the kernels) and with int8 storage (per-dimension
scales, trained once); L2 and IP, add / train / search / search_async, the
fused search (hand-written CUDA kernels in ``csrc/``, built with nvcc at
first use) with its exactness certificates and two-tier fallback at any
index size and k, and the plain path; the rest of the flat surface:
selectors, range_search, remove_ids, merge_from, assign,
search_and_reconstruct, vectors_numpy, the IDMap wrappers, host-merged
shards and ``.npz`` save and load; k-means with balanced training and the
functional knn; IVF-Flat on the chunk-paged pool (f32, bf16 and int8
lists), its fine scan on K10 (f32 rows included) and its dense route on
the fused search; sharded flat and IVF search over a list of torch devices
(one process, each shard's search on its own device, the lists merged on
the first); the native host runtime (g++, built at first call: host
bf16 / f16 conversion and norms for large add batches), the dataset
loader (.npy, .fvecs, .bvecs), the profiling harness (bench_grid over
faiss_tpu's DEFAULT_GRID, measure_search, a torch.profiler trace) and the
faiss IndexFlat interop; and TorchResources, the devices and the cache of
search programs that the flat and IVF searches run through (on a CUDA
device each search captured once per shape as a CUDA graph and replayed,
``programs.py``). With these the port has the counterpart of every name
``faiss_tpu`` exports. Beside them, ``tracing``: spans at the search
path's layer boundaries, live only while a ``torch.profiler`` records.

    TorchIndexFlat, TorchSearchToken, index_numpy_to_torch,
    index_cpu_to_torch, index_torch_to_cpu
    TorchIndexIVFFlat, Kmeans, kmeans_clustering, knn, pairwise_distances
    ShardedIndexFlat, ShardedIndexIVFFlat
    TorchIndexIDMap, TorchIndexIDMap2, IndexShardsHost,
    merge_search_results
    IDSelector*, SearchParams (and the faiss spellings SearchParameters,
    SearchParametersIVF)
    MetricType, StorageType
    save_index, load_index, index_from_arrays  (faiss_tpu's .npz format)
    TorchResources, default_resources, query_device_capabilities,
    describe_capabilities, gpu_name_and_power_limit
    loader, native, tracing, utils (modules)
"""

from .clustering import Kmeans, kmeans_clustering, knn, pairwise_distances
from .dtypes import MetricType, StorageType
from .idmap import TorchIndexIDMap, TorchIndexIDMap2
from .calls import TorchSearchToken
from .index import (TorchIndexFlat, index_cpu_to_torch, index_numpy_to_torch,
                    index_torch_to_cpu)
from .io import index_from_arrays, load_index, save_index
from .ivf import TorchIndexIVFFlat
from .multi import IndexShardsHost, merge_search_results
from .parallel import ShardedIndexFlat, ShardedIndexIVFFlat
from .resources import (DeviceCapabilities, KernelTuning, TorchResources,
                        default_resources, describe_capabilities,
                        gpu_name_and_power_limit, query_device_capabilities)
from .selector import (IDSelector, IDSelectorAnd, IDSelectorBatch,
                       IDSelectorMask, IDSelectorNot, IDSelectorOr,
                       IDSelectorRange, SearchParameters, SearchParametersIVF,
                       SearchParams, reject_ivf_params)
from . import loader, native, tracing, utils

__version__ = "0.1.0"

__all__ = [
    "MetricType", "StorageType",
    "TorchIndexFlat", "TorchSearchToken", "index_numpy_to_torch",
    "index_cpu_to_torch", "index_torch_to_cpu",
    "TorchIndexIVFFlat", "Kmeans", "kmeans_clustering", "knn",
    "pairwise_distances", "ShardedIndexFlat", "ShardedIndexIVFFlat",
    "TorchIndexIDMap", "TorchIndexIDMap2", "IndexShardsHost",
    "merge_search_results",
    "IDSelector", "IDSelectorRange", "IDSelectorBatch", "IDSelectorMask",
    "IDSelectorNot", "IDSelectorAnd", "IDSelectorOr", "SearchParams",
    "SearchParameters", "SearchParametersIVF", "reject_ivf_params",
    "index_from_arrays", "load_index", "save_index",
    "DeviceCapabilities", "KernelTuning", "TorchResources",
    "default_resources", "gpu_name_and_power_limit",
    "query_device_capabilities", "describe_capabilities",
    "loader", "native", "utils", "__version__",
]
