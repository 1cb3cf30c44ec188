"""Top-k selection of the plain path (counterpart of
``faiss_tpu/ops/topk.py``).

Ties go to the LOWEST index, as ``lax.top_k`` sends them. ``torch.topk``
promises no order among equal values, so every selection here is a stable
descending sort followed by a slice. The sort key is the fp32 total order
that ``lax.top_k`` ranks by (−0.0 below +0.0), so the two packages pick
the same columns bit for bit. All functions take larger-is-better fp32
scores and return (scores, int32 ids) sorted descending.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def topk_scores(scores: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis, ties to the lowest column."""
    bits = scores.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)     # fp32 total order
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(scores, -1, idx), idx.to(torch.int32)


def merge_topk(vals_a: torch.Tensor, ids_a: torch.Tensor,
               vals_b: torch.Tensor, ids_b: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial top-k lists into one (…, k) list. On equal scores
    list a wins, so callers put the list of lower ids first."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    top, pos = topk_scores(vals, k)
    return top, torch.gather(ids, -1, pos.to(torch.int64))


def chunked_topk_scores(
    score_fn: Callable[[int], torch.Tensor],
    nv_padded: int,
    chunk: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage exact top-k over a virtual (nq, nv) score matrix.

    ``score_fn(start)`` returns the (nq, chunk) score block of db columns
    [start, start + chunk). Only one block is live at a time: each chunk's
    top-min(k, chunk) merges into the running list, which holds lower ids
    and so keeps the lowest-id tie order."""
    if nv_padded % chunk:
        raise ValueError(f"nv {nv_padded} is not a multiple of chunk {chunk}")
    kc = min(k, chunk)
    run_v = run_i = None
    for start in range(0, nv_padded, chunk):
        v, i = topk_scores(score_fn(start), kc)
        i = i + start
        if run_v is None:
            if kc < k:  # k > chunk: pad so later merges keep k slots
                pad = (v.shape[0], k - kc)
                v = torch.cat([v, v.new_full(pad, float("-inf"))], dim=-1)
                i = torch.cat([i, i.new_full(pad, -1)], dim=-1)
            run_v, run_i = v, i
        else:
            run_v, run_i = merge_topk(run_v, run_i, v, i, k)
    return run_v, run_i
