"""Distance stage of the plain path (counterpart of
``faiss_tpu/ops/distance.py``, bf16 storage).

The plain path is the port's exact oracle and the tier-2 fallback of the
fused path. Scores are larger-is-better:
  L2 : score = −(‖q‖² − 2·q·v + ‖v‖²)   (negated squared distance)
  IP : score =  q·v
Invalid (padding) columns are −inf, so a top-k ranks them last.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..dtypes import MetricType
from . import l2norm

DIRECT_PATH_MAX_NV = 256    # tiny db: exact per-pair L2, no expanded form


@contextlib.contextmanager
def exact_fp32_matmul():
    """Within the block, fp32 matrix products are true fp32 on the card (the
    counterpart of ``Precision.HIGHEST``): TF32 would keep about three
    decimal digits. The caller's settings are restored on exit, so the
    port leaves the precision of other GPU work alone."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def matmul_scores(
    queries: torch.Tensor,            # (nq, d) fp32
    db: torch.Tensor,                 # (nv, d) bf16
    db_norms: Optional[torch.Tensor],  # (nv,) fp32, required for L2
    metric: MetricType,
) -> torch.Tensor:
    """(nq, nv) fp32 scores via one fp32 GEMM.

    Both operands go to fp32 before the product: ``bf16 @ bf16`` returns
    bf16 in PyTorch and would round every score. Each fp32 product
    q_i·v_i rounds once and the sum accumulates in fp32, so the result is
    fp32-true w.r.t. the stored rows, as the JAX package's exact 3-way
    query split is (both within d·u·‖q‖·‖v‖)."""
    with exact_fp32_matmul():
        dots = queries.to(torch.float32) @ db.to(torch.float32).T
    if metric is MetricType.INNER_PRODUCT:
        return dots
    if db_norms is None:
        db_norms = l2norm.l2_norm_squared(db)
    q_norms = l2norm.l2_norm_squared(queries)
    return 2.0 * dots - q_norms[:, None] - db_norms[None, :]


def direct_l2_scores(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Exact per-pair −‖q−v‖², materializing (nq, nv, d) differences. Only
    for tiny nv (no catastrophic cancellation from the expanded form)."""
    diff = queries[:, None, :].to(torch.float32) \
        - db[None, :, :].to(torch.float32)
    return -torch.sum(diff * diff, dim=-1)


def scores_to_distances(scores: torch.Tensor,
                        metric: MetricType) -> torch.Tensor:
    """Internal larger-is-better scores back to user-facing distances."""
    return -scores if metric is MetricType.L2 else scores
