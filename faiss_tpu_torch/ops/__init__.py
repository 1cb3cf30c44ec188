"""Compute ops: plain path (l2norm, distance, topk), the fused search
(fused) and its CUDA kernels (kernels)."""

from . import distance, fused, kernels, l2norm, topk  # noqa: F401
