"""Shared enums + sentinel constants (a copy of ``faiss_tpu/dtypes.py``).

Copied, not imported: importing anything from ``faiss_tpu`` runs its
package ``__init__``, which imports jax, and the port must run where jax is
not installed.

  * Sentinels: +inf distance for L2, -inf for IP, label -1 (the k > ntotal
    and empty-index fill).
  * Ids are int32 on the device and int64 at the API.
"""

import enum

import numpy as np


class StorageType(enum.Enum):
    """On-device vector storage precision. Queries and accumulation stay
    fp32. The port stores bf16 only so far; the other members exist so that
    files written by ``faiss_tpu`` parse, and an index refuses them."""

    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT8 = "int8"

    @classmethod
    def coerce(cls, v) -> "StorageType":
        if isinstance(v, cls):
            return v
        s = str(v).lower().replace("-", "").replace("_", "")
        aliases = {
            "float32": cls.FLOAT32, "f32": cls.FLOAT32, "fp32": cls.FLOAT32,
            "float16": cls.FLOAT16, "f16": cls.FLOAT16, "fp16": cls.FLOAT16,
            "half": cls.FLOAT16,
            "bfloat16": cls.BFLOAT16, "bf16": cls.BFLOAT16,
            "int8": cls.INT8, "i8": cls.INT8, "qint8": cls.INT8,
        }
        try:
            return aliases[s]
        except KeyError:
            raise ValueError(f"unknown storage type: {v!r}") from None


class MetricType(enum.Enum):
    L2 = "l2"                 # squared L2, like faiss METRIC_L2
    INNER_PRODUCT = "ip"

    @classmethod
    def coerce(cls, v) -> "MetricType":
        if isinstance(v, cls):
            return v
        s = str(v).lower()
        aliases = {
            "l2": cls.L2, "metric_l2": cls.L2, "euclidean": cls.L2,
            "ip": cls.INNER_PRODUCT, "inner_product": cls.INNER_PRODUCT,
            "metric_inner_product": cls.INNER_PRODUCT, "dot": cls.INNER_PRODUCT,
        }
        try:
            return aliases[s]
        except KeyError:
            raise ValueError(f"unknown metric: {v!r}") from None


def worst_distance(metric: MetricType) -> float:
    return np.inf if metric is MetricType.L2 else -np.inf
