"""Row-wise squared-L2 norms (counterpart of ``faiss_tpu/ops/l2norm.py``).

The index takes database norms at add() time from the fp32 input, before
bf16 quantization (storage.py); this is the same reduction for queries.
"""

from __future__ import annotations

import torch


def l2_norm_squared(x: torch.Tensor) -> torch.Tensor:
    """``‖x_i‖²`` per row of an (n, d) matrix, accumulated in fp32."""
    if x.ndim != 2:
        raise ValueError(f"expected (n, d) matrix, got shape {tuple(x.shape)}")
    return torch.sum((x * x).to(torch.float32), dim=-1)
