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


def assert_ids_match(I_a, I_b, D_b, eps, what=""):
    """Ids equal rank for rank, except where two stored rows score within
    the query's ε of each other (a near-tie below the fp32 rescores'
    resolution may order either way in the two packages): each id of
    ``I_a`` off its place in ``I_b`` must sit at a rank of ``I_b`` whose
    distance is within ε of this rank's, or, past the end of ``I_b``, within
    ε of its last distance."""
    I_a, I_b, D_b = np.asarray(I_a), np.asarray(I_b), np.asarray(D_b)
    eps = np.broadcast_to(np.asarray(eps, np.float64).reshape(-1), (len(I_b),))
    for r, p in np.argwhere(I_a != I_b):
        where = np.nonzero(I_b[r] == I_a[r, p])[0]
        other = D_b[r, where[0]] if where.size else D_b[r, -1]
        assert abs(float(D_b[r, p]) - float(other)) <= eps[r], (
            f"{what}: row {r} rank {p}: id {I_a[r, p]} vs {I_b[r, p]}")
