"""Fused bf16 search: group-max sweep → group nomination → gather-rescore →
final top-k, with a per-query exactness certificate.

Counterpart of the bf16 route of ``faiss_tpu/ops/pallas_fused.py``. The
nq×nv score matrix is never materialized:

  phase 1  sweep_groupmax   per 128-row group, the max of the masked score
                            s = 2·q·v − ‖v‖² (L2) or q·v (IP) (−‖q‖² is
                            rank-invariant and re-added by the index)
  phase 2  select_groups    the top-(k+GROUP_PAD) groups per query, and
                            t = the max group-max among the others
  phase 3  rescore_groups   the nominated groups' rows scored fp32-true
  final    final_select     the top-k of the rescored candidates

Every true top-k row lies in a nominated group unless a non-nominated group
could beat the k-th rescored score; the certificate
``vals[k-1] ≥ t + ε`` (ε from ``_sweep_eps``, a strict bound on
|sweep score − rescore score|) proves per query that none can. An
uncertified query is re-run by the index on an exact path.

The four phases are CUDA kernels (``csrc/*.cu``) behind the wrappers of
``ops/kernels.py``. Each has its plain PyTorch version here (``*_plain``):
the wrappers run it for CPU tensors, the tests hold it against the JAX package, and the
chip smoke run holds each kernel against it on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..dtypes import MetricType
from ..storage import split_f32_bf16
from .distance import exact_fp32_matmul
# the kernel wrappers, under the names of their JAX counterparts' roles
from .kernels import GROUP  # rows per candidate group
from .kernels import final_select, rescore_groups, select_groups
from .kernels import sweep_groupmax

GROUP_PAD = 4         # groups nominated beyond k (certificate margin)
NEG_INF = float("-inf")

# Dispatch gate (fused_path_eligible). The minimum size and the cost-model
# coefficients are carried from the JAX package, not measured on this card.
FUSED_MIN_NV = 8192
FUSED_GATHER_BUDGET = 1 << 30     # cap on the phase-3 gather volume
PLAIN_SCORE_BYTES = 8.0           # plain path: write + read of each fp32 score
PLAIN_TOPK_BYTES_PER_K16 = 1.0    # + k/16 bytes/score for its top-k
# At nq_pad ≥ this the sweep runs one RNE-rounded query plane (certified
# with single_pass=True; an uncertified query re-runs with two planes).
REDUCED_SWEEP_MIN_NQ = 32
# What the select kernels take: one bitmask row of ≤ 16384 columns, and
# extraction loops of ≤ 40 steps. Larger shapes go to the plain path.
SELECT_MAX_GROUPS = 16384
SELECT_MAX_KG = 40

# Certificate constants (derivation in _sweep_eps)
_U32 = 2.0 ** -24          # fp32 unit roundoff, round to nearest
_QUANT_V = 1.0 + 2.0 ** -8  # max ‖v_stored‖ / ‖v‖ under RNE bf16 quantization
_EPS_SLACK = 1.0 + 2.0 ** -10  # strictness + rounding of the ε computation
_BIG = 1 << 30


def pick_sweep_passes(nq_pad: int) -> int:
    """1 (reduced, certified) query plane for large batches, else 2."""
    return 1 if nq_pad >= REDUCED_SWEEP_MIN_NQ else 2


def _premask_norms(db_norms: torch.Tensor, ntotal: int, nv_eff: int,
                   metric: MetricType) -> torch.Tensor:
    """(nv_eff,) norm stream with the validity mask folded in: ‖v‖² (L2) or
    0 (IP) on rows < ntotal, +inf past it, so every kernel scores padding
    −inf without a per-row compare."""
    past = torch.arange(nv_eff, device=db_norms.device) >= ntotal
    vn = db_norms[:nv_eff] if metric is MetricType.L2 \
        else torch.zeros((nv_eff,), dtype=torch.float32,
                         device=db_norms.device)
    return vn.masked_fill(past, math.inf)


def query_planes(queries_f32: torch.Tensor, sweep_passes: int):
    """The sweep's bf16 query planes: the RNE-rounded query (one pass) or
    the bit-mask (hi, lo) split (two passes; drops only a ~2^-16 residual)."""
    if sweep_passes == 1:
        return queries_f32.to(torch.bfloat16), None
    return split_f32_bf16(queries_f32)


def groupmax_scores(queries_f32: torch.Tensor, db: torch.Tensor,
                    vn: torch.Tensor, *, metric: MetricType,
                    sweep_passes: int = 2) -> torch.Tensor:
    """(nq_pad, nv_eff/128) per-group max of the masked sweep scores, the
    bf16 route of ``faiss_tpu``'s groupmax_scores. Takes the pre-masked norm
    stream ``vn`` (length nv_eff), which the rescore reuses."""
    q_hi, q_lo = query_planes(queries_f32, sweep_passes)
    return sweep_groupmax(q_hi, q_lo, db, vn, metric=metric)


# -- plain versions of the kernels ----------------------------------------


def sweep_groupmax_plain(q_hi, q_lo, db, vn, *, metric: MetricType):
    """Plain version of the sweep kernel: full (nq, nv_eff) scores, then a
    max per 128 columns. One fp32 product per plane (bf16×bf16 products are
    exact), planes added at the end as in the kernel."""
    nv_eff = vn.shape[0]
    v = db[:nv_eff].to(torch.float32)
    with exact_fp32_matmul():
        acc = q_hi.to(torch.float32) @ v.T
        if q_lo is not None:
            acc = acc + q_lo.to(torch.float32) @ v.T
    s = (2.0 * acc if metric is MetricType.L2 else acc) - vn[None, :]
    return torch.amax(s.view(s.shape[0], nv_eff // GROUP, GROUP), dim=-1)


def select_groups_plain(gm: torch.Tensor, kg: int):
    """Plain version of the group select, step for step the Pallas
    ``_select_kernel``: kg max-extractions (ties to the lowest column; a
    −inf tie may re-pick a marked column), t = max of the rest, then the
    marked set in ascending order, padded and clamped to ngroups−1."""
    nq, ng = gm.shape
    iota = torch.arange(ng, device=gm.device, dtype=torch.int32)[None, :]
    excl = torch.zeros_like(gm, dtype=torch.bool)
    for _ in range(kg):
        xm = gm.masked_fill(excl, NEG_INF)
        m = torch.amax(xm, dim=-1, keepdim=True)
        j = torch.amin(torch.where(xm == m, iota, _BIG), dim=-1, keepdim=True)
        excl |= iota == j
    t = torch.amax(gm.masked_fill(excl, NEG_INF), dim=-1)
    out = torch.empty((nq, kg), dtype=torch.int32, device=gm.device)
    emitted = torch.zeros_like(excl)
    for j in range(kg):
        col = torch.amin(torch.where(excl & ~emitted, iota, _BIG), dim=-1,
                         keepdim=True)
        emitted |= iota == col
        out[:, j] = torch.clamp(col[:, 0], max=ng - 1)
    return out, t


def final_select_plain(s: torch.Tensor, k: int):
    """Plain version of the final select, step for step the Pallas
    ``_final_select_kernel``: k max-extractions in descending order, ties
    to the lowest column not yet extracted, columns clamped to ncand−1."""
    nq, nc = s.shape
    iota = torch.arange(nc, device=s.device, dtype=torch.int32)[None, :]
    excl = torch.zeros_like(s, dtype=torch.bool)
    vals = torch.empty((nq, k), dtype=torch.float32, device=s.device)
    pos = torch.empty((nq, k), dtype=torch.int32, device=s.device)
    for j in range(k):
        xm = s.masked_fill(excl, NEG_INF)
        m = torch.amax(xm, dim=-1, keepdim=True)
        col = torch.amin(torch.where((xm == m) & ~excl, iota, _BIG), dim=-1,
                         keepdim=True)
        excl |= iota == col
        vals[:, j] = m[:, 0]
        pos[:, j] = torch.clamp(col[:, 0], max=nc - 1)
    return vals, pos


def candidate_columns(gidx: torch.Tensor) -> torch.Tensor:
    """(nq, kg·128) database row ids of the nominated groups, in order."""
    offs = torch.arange(GROUP, device=gidx.device, dtype=torch.int32)
    return (gidx[:, :, None] * GROUP + offs).reshape(gidx.shape[0], -1)


def rescore_groups_plain(queries, db, vn, gidx, *, metric: MetricType):
    """Plain version of the rescore kernel: gather the nominated groups'
    rows, one fp32 batched product with the fp32 queries, same epilogue."""
    nq, d = queries.shape
    cols = candidate_columns(gidx).to(torch.int64)
    rows = db[cols].to(torch.float32)                      # (nq, kg·128, d)
    with exact_fp32_matmul():
        dots = torch.bmm(rows, queries[:, :, None])[:, :, 0]
    return (2.0 * dots if metric is MetricType.L2 else dots) - vn[cols]


# -- certificate ------------------------------------------------------------


def _sweep_eps(queries_f32: torch.Tensor, db_norms: torch.Tensor,
               nv_eff: int, *, metric: MetricType, d_pad: int,
               single_pass: bool = False) -> torch.Tensor:
    """Per-query strict upper bound ε on |sweep score − rescore score| for
    any stored row: the bf16 case of ``faiss_tpu``'s _sweep_eps, derived
    for this port's own arithmetic.

    Notation: u = 2^-24; Q = ‖q‖; R = ‖q − Σ q_planes‖ (computed exactly:
    the bit-mask split makes the subtractions exact); L = ‖q_lo‖;
    N = max stored ‖v‖² (pre-quantization), V = √N·(1+2^-8) ≥ max‖v_stored‖.

      (1) dropped query residual              R·V
      (2) sweep accumulation                  (d+2)·u·[(Q+R)·V + L·V]
          csrc/sweep_groupmax.cu: per plane a sequential fmaf chain of
          exact bf16×bf16 products (≤ d·u·‖plane‖·V each, round to
          nearest), the planes added once
      (3) rescore accumulation                2·d·u·Q·V
          csrc/rescore_groups.cu: a sequential fmaf chain of fp32 q times
          exactly widened bf16 v, ≤ d·u·Q·V
      (4) L2 epilogues fl(2·dot − ‖v‖²) on both sides and the rounding of
          fl(t + ε) in the comparison: 3·u·(2QV + N); IP: 2·u·Q·V
      (5) ×2 on (1)-(3) for L2; ×(1+2^-10) to make the bound strict and
          cover the rounding of this computation.
    """
    q = queries_f32
    if single_pass:
        resid = q - q.to(torch.bfloat16).to(torch.float32)
        lo32 = torch.zeros_like(q)
    else:
        qh, ql = split_f32_bf16(q)
        lo32 = ql.to(torch.float32)
        resid = q - qh.to(torch.float32) - lo32
    R = torch.sqrt(torch.sum(resid * resid, dim=-1))
    L = torch.sqrt(torch.sum(lo32 * lo32, dim=-1))
    Q = torch.sqrt(torch.sum(q * q, dim=-1))
    N = torch.amax(db_norms[:nv_eff])
    V = torch.sqrt(N) * _QUANT_V
    eps = (R * V
           + (d_pad + 2.0) * _U32 * ((Q + R) * V + L * V)
           + 2.0 * d_pad * _U32 * Q * V)
    if metric is MetricType.L2:
        eps = 2.0 * eps + 3.0 * _U32 * (2.0 * Q * V + N)
    else:
        eps = eps + 2.0 * _U32 * Q * V
    return _EPS_SLACK * eps


# -- the fused search ---------------------------------------------------------


def fused_search(
    queries_f32: torch.Tensor,   # (nq_pad, d_pad) fp32
    db: torch.Tensor,            # (capacity, d_pad) bf16
    db_norms: torch.Tensor,      # (capacity,) fp32 ‖v‖² (pre-quantization)
    ntotal: int,
    *,
    k: int,
    metric: MetricType,
    nv_eff: int,
    sweep_passes: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores (nq_pad, k_eff) descending, ids (nq_pad, k_eff) int32,
    certified (nq_pad,) bool), k_eff = min(k, nv_eff). ``certified[i]``
    proves row i is the exact top-k of the stored database, ties to the
    lowest id; the caller re-runs the others on an exact path. No host
    synchronisation happens in here."""
    nq_pad, d_pad = queries_f32.shape
    k_eff = min(k, nv_eff)
    ngroups = nv_eff // GROUP
    kg = min(k_eff + GROUP_PAD, ngroups)
    if kg > SELECT_MAX_KG or ngroups > SELECT_MAX_GROUPS:
        raise ValueError(
            f"fused search takes kg ≤ {SELECT_MAX_KG} and ngroups ≤ "
            f"{SELECT_MAX_GROUPS} (kg={kg}, ngroups={ngroups})")
    vn = _premask_norms(db_norms, ntotal, nv_eff, metric)

    gm = groupmax_scores(queries_f32, db, vn, metric=metric,
                         sweep_passes=sweep_passes)
    gidx, t = select_groups(gm, kg)
    s = rescore_groups(queries_f32, db, vn, gidx, metric=metric)
    cols = candidate_columns(gidx)
    s = s.masked_fill(cols >= ntotal, NEG_INF)
    vals, pos = final_select(s, k_eff)
    ids = torch.gather(cols, 1, pos.to(torch.int64))

    eps = _sweep_eps(queries_f32, db_norms, nv_eff, metric=metric,
                     d_pad=d_pad, single_pass=sweep_passes == 1)
    certified = (t == NEG_INF) | (vals[:, k_eff - 1] >= t + eps)
    return vals, ids, certified


def fused_path_eligible(*, metric: MetricType, k: int, nv_eff: int,
                        d_pad: int, nq_pad: int = 128) -> bool:
    """Dispatch gate, the JAX package's traffic cost model: the plain path
    pays for materializing the nq×nv fp32 scores and a k-scaled top-k over
    them, the fused path for the candidate gather. Its coefficients are
    carried from the JAX package, not measured on this card. Shapes the
    select kernels do not take (kg > 40, ngroups > 16384) return False and
    run on the plain path."""
    if nv_eff < FUSED_MIN_NV or d_pad > 2048:
        return False
    ngroups = nv_eff // GROUP
    kg = min(k + GROUP_PAD, ngroups)
    if kg > SELECT_MAX_KG or ngroups > SELECT_MAX_GROUPS:
        return False
    gather_bytes = nq_pad * kg * GROUP * d_pad * 2
    if gather_bytes > FUSED_GATHER_BUDGET:
        return False
    plain_extra = nq_pad * nv_eff * (
        PLAIN_SCORE_BYTES + PLAIN_TOPK_BYTES_PER_K16 * k / 16.0)
    fused_extra = 2.0 * gather_bytes + nq_pad * ngroups * 8.0
    return fused_extra < plain_extra
