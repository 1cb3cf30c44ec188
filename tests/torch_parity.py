"""Helpers for the tests that hold faiss_tpu_torch against faiss_tpu.

Inputs are made once with numpy from a seed; bf16 values are made once as
bit patterns (RNE via ml_dtypes) and handed to both packages, so the two
sides see the same stored database bit for bit.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import torch

import jax.numpy as jnp

from faiss_tpu.dtypes import MetricType as JaxMetric
from faiss_tpu_torch.dtypes import MetricType

# (port metric, JAX metric) pairs for parametrize
METRICS = [(MetricType.L2, JaxMetric.L2),
           (MetricType.INNER_PRODUCT, JaxMetric.INNER_PRODUCT)]
METRIC_IDS = ["l2", "ip"]


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 → bf16 (round to nearest even) as uint16 bit patterns."""
    return np.ascontiguousarray(x, np.float32).astype(
        ml_dtypes.bfloat16).view(np.uint16)


def jax_bf16(bits: np.ndarray):
    return jnp.asarray(bits.view(ml_dtypes.bfloat16))


def torch_bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def bits_of(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def assert_within_eps(a, b, eps, what=""):
    """Per row: |a − b| ≤ eps[row] on finite entries, and the non-finite
    entries identical in place and value."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    eps = np.asarray(eps, np.float64).reshape(-1, *([1] * (a.ndim - 1)))
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=what)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=what)
    err = np.where(fin, np.abs(np.where(fin, a, 0) - np.where(fin, b, 0)), 0)
    bad = err > eps
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} entries beyond ε, worst "
        f"{(err - eps).max():.3e} over")
