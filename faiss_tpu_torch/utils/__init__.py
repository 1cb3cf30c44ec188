"""Utilities: the profiling / QPS harness (``faiss_tpu.utils``'s
counterpart)."""

from .profiling import (DEFAULT_GRID, BenchResult, bench_grid,  # noqa: F401
                        measure_search, trace)
