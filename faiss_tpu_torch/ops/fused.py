"""Fused search: group-max sweep → group nomination → gather-rescore →
final top-k, with a per-query exactness certificate.

Counterpart of ``faiss_tpu/ops/pallas_fused.py``'s routes for the four
storage modes. The nq×nv score matrix is never materialized:

  phase 1  sweep_groupmax   per 128-row group, the max of the masked score
           / sweep_split    s = 2·q·v − ‖v‖² (L2) or q·v (IP) (−‖q‖² is
           / sweep_f16      rank-invariant and re-added by the index);
           / sweep_int8     bf16 rows, the f32 rows' bf16 (hi, lo) planes,
                            f16 bits decoded to the exact (hi, lo) pair, or
                            int8 codes against the query's int8 expansion
  phase 2  select_groups    the top-(k+GROUP_PAD) groups per query, and
                            t = the max group-max among the others
                            (kg ≤ 40, ≤ 16384 groups; else _top_groups,
                            and from HIER_MIN_GROUPS groups on
                            _top_groups_from_bmax over the sweep's second
                            output, the per-1024-row supergroup maxes)
  phase 3  rescore_groups   the nominated groups' rows scored fp32-true
  final    final_select     the top-k of the rescored candidates (k ≤ 40,
                            else a stable sort); with rescore_select=True
                            rescore_select_groups does phase 3 and the
                            final top-k in one kernel (k ≤ 32; bf16, int8,
                            f16 rows)

Every true top-k row lies in a nominated group unless a non-nominated group
could beat the k-th rescored score; the certificate
``vals[k-1] ≥ t + ε`` (ε from ``_sweep_eps``, a strict bound on
|sweep score − rescore score|, with the tensor-core accumulation term where
the sweep ran on the card over bf16 rows or the f16 pair, or with two query
planes over the f32 planes: ``sweep_accum``) proves per query that none
can. An uncertified query is re-run by the index on an exact path.

f32 storage (``db_split`` = the (hi, lo) planes) rescores in two stages:
stage 3a scores every candidate against hi + lo (the pair mode of
rescore_groups), select_groups nominates the top k + F32_CAND_PAD of them
and returns t2, the max unselected pair score; stage 3b scores those
against the f32 master with one exact fp32 batched product. A second
certificate ``vals[k-1] ≥ t2 + ε₂`` (``_pair_rescore_eps``) proves no
unselected candidate could win. Pair-only storage (no master on the device)
ranks by hi + lo and ends after stage 3a; integer-valued data (split
statistics exactly zero, ``hi_exact``) sweeps and rescores the hi plane alone
with the bf16 kernels, bit for bit the same scores.

f16 storage sweeps, with two query planes on the card (K6), the stored
rows as they are against the query's f16 split (``split_f32_f16``, its
planes scaled per query by powers of two), certified as bf16 rows with the
f16 split's residual (``_sweep_eps(f16_planes=)``, s0 = s1 = 0);
with one query plane (K7), and on the CPU (the JAX package's arithmetic),
it sweeps the decoded pair with the pair sweep's arithmetic and
certificate (``_sweep_eps(pair_sweep=True)`` with the f16 split
statistics; on the card the tensor-core term). It rescores the decoded
rows in one stage. int8 storage sweeps two exact
integer passes over the query's residual expansion (``int8_query_pair``),
rescores the codes against q∘s, and is certified by ``_sweep_eps_int8``:
both sides score the decoded database s∘v_q.

A selector (``sel``, a (capacity,) bool stream) folds into the same
pre-masked norm stream as padding, so every kernel scores a filtered row
−inf; the f32 rescores against the master (stage 3b, single stage) read
the raw norms and mask with ``sel`` again.

The phases are CUDA kernels (``csrc/*.cu``) behind the wrappers of
``ops/kernels.py``. Each has its plain PyTorch version here (``*_plain``):
the wrappers run it for CPU tensors, the tests hold it against the JAX
package, and the chip smoke run holds each kernel against it on the card.
Stage 3b and the phase 2 of large shapes (``_top_groups``,
``_top_groups_from_bmax``: stable sorts, gathers, a scatter of −inf and a
row max) are plain PyTorch on purpose: the JAX package computes them
outside any Pallas kernel too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..dtypes import MetricType
from ..storage import (decode_f16_bits, f32_to_bf16, split_f16_bits,
                       split_f32_bf16, split_f32_f16)
from .distance import exact_fp32_matmul
from .topk import topk_scores
# the kernel wrappers, under the names of their JAX counterparts' roles
from .kernels import GROUP  # rows per candidate group
from .kernels import SUPERGROUP  # groups per block max (1024 rows)
from .kernels import SELECT_MAX_GROUPS, SELECT_MAX_KG
from .kernels import (final_select, rescore_groups, rescore_select_groups,
                      select_groups)
from .kernels import sweep_f16, sweep_groupmax, sweep_int8, sweep_split

GROUP_PAD = 4         # groups nominated beyond k (certificate margin)
F32_CAND_PAD = 22     # f32 stage 3a: candidates beyond k given stage 3b
NEG_INF = float("-inf")

# Dispatch gate (fused_path_eligible). The minimum size and the cost-model
# coefficients are carried from the JAX package, not measured on this card.
FUSED_MIN_NV = 8192
FUSED_GATHER_BUDGET = 1 << 30     # cap on the phase-3 gather volume
PLAIN_SCORE_BYTES = 8.0           # plain path: write + read of each fp32 score
PLAIN_TOPK_BYTES_PER_K16 = 1.0    # + k/16 bytes/score for its top-k
# At nq_pad ≥ this the bf16 and f16 sweeps run one RNE-rounded query plane
# (certified with single_pass=True; an uncertified query re-runs with two
# planes). f32 pair storage always sweeps two query planes, and int8 two
# integer passes.
REDUCED_SWEEP_MIN_NQ = 32
# What the select kernels take: rows of ≤ SELECT_MAX_GROUPS (16384)
# columns and ≤ SELECT_MAX_KG (40) picks, faiss_tpu's limits (imported
# above). Larger shapes select with stable sorts (_top_groups,
# topk_scores), as the JAX package selects them in XLA.
# From this many groups on, phase 2 ranks the sweep's supergroup maxes
# first (_top_groups_from_bmax), as the JAX package does (carried from it,
# not measured on this card).
HIER_MIN_GROUPS = 65536
# rescore_select=True: the one-kernel rescore + top-k takes k ≤ this
RESCORE_SELECT_MAX_K = 32

# Certificate constants (derivation in _sweep_eps)
_U32 = 2.0 ** -24          # fp32 unit roundoff, round to nearest
_QUANT_V = 1.0 + 2.0 ** -8  # max ‖v_stored‖ / ‖v‖ under RNE bf16 quantization
_EPS_SLACK = 1.0 + 2.0 ** -10  # strictness + rounding of the ε computation
# envelopes of max‖v_lo‖ / max‖v − hi − lo‖ relative to V, used only when
# the exact split statistics are not given
_LO_REL = 2.0 ** -7
_RESID_REL = 2.0 ** -15
_BIG = 1 << 30


def pick_sweep_passes(nq_pad: int, pair_storage: bool = False) -> int:
    """1 (reduced, certified) query plane for large bf16 or f16 batches,
    else 2. Pair storage (f32 planes, and int8) never reduces, as in the
    JAX package."""
    return 1 if nq_pad >= REDUCED_SWEEP_MIN_NQ and not pair_storage else 2


def _premask_norms(db_norms: torch.Tensor, ntotal: int, nv_eff: int,
                   metric: MetricType,
                   sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nv_eff,) norm stream with the validity mask folded in: ‖v‖² (L2) or
    0 (IP) on rows < ntotal that the selector stream ``sel`` (a (capacity,)
    bool, or None) admits, +inf elsewhere, so every kernel scores padding
    and filtered rows −inf without a per-row compare."""
    out = torch.arange(nv_eff, device=db_norms.device) >= ntotal
    if sel is not None:
        out |= ~sel[:nv_eff]
    vn = db_norms[:nv_eff] if metric is MetricType.L2 \
        else torch.zeros((nv_eff,), dtype=torch.float32,
                         device=db_norms.device)
    return vn.masked_fill(out, math.inf)


def query_planes(queries_f32: torch.Tensor, sweep_passes: int):
    """The sweep's bf16 query planes: the RNE-rounded query (one pass) or
    the bit-mask (hi, lo) split (two passes; drops only a ~2^-16 residual)."""
    if sweep_passes == 1:
        return f32_to_bf16(queries_f32), None
    return split_f32_bf16(queries_f32)


def groupmax_scores(queries_f32: torch.Tensor, db: torch.Tensor,
                    vn: torch.Tensor, *, metric: MetricType,
                    sweep_passes: int = 2, db_split=None,
                    with_block_max: bool = False, f16_planes=None):
    """(nq_pad, nv_eff/128) per-group max of the masked sweep scores, the
    bf16, pair and f16 routes of ``faiss_tpu``'s groupmax_scores. Takes the
    pre-masked norm stream ``vn`` (length nv_eff), which the rescore reuses.
    With ``db_split`` = (hi, lo) it runs the pair sweep over the planes
    (``db`` unread); over float16 rows (f16 bits) the f16 sweep; else the
    bf16 sweep over ``db``. (int8 rows: ``int8_groupmax_scores``.) With
    ``with_block_max`` it returns (gm, the (nq_pad, nv_eff/1024) supergroup
    maxes of the same launch). Over f16 rows it sweeps ``f16_planes`` =
    (q_hi, q_lo, scales), the f16 split ``split_f32_f16`` of the queries
    (K6: ``fused_search`` passes it where ``sweep_query_split`` says
    "f16", and certifies with it), else ``query_planes``."""
    kw = dict(metric=metric, with_block_max=with_block_max)
    if f16_planes is not None:
        q_hi, q_lo, scales = f16_planes
        return sweep_f16(q_hi, q_lo, db, vn, scales=scales, **kw)
    q_hi, q_lo = query_planes(queries_f32, sweep_passes)
    if db_split is not None:
        return sweep_split(q_hi, q_lo, db_split[0], db_split[1], vn, **kw)
    if db.dtype == torch.float16:
        return sweep_f16(q_hi, q_lo, db, vn, **kw)
    return sweep_groupmax(q_hi, q_lo, db, vn, **kw)


def int8_query_pair(queries_f32: torch.Tensor, scales: torch.Tensor):
    """qs = q∘s ≈ β₁·q₁ + β₂·q₂ with q₁, q₂ int8 (q₂ quantizes the first
    residual): the port of ``faiss_tpu``'s ``_int8_query_pair``, op for op.
    Returns (q₁, q₂, β₁, β₂)."""
    qs = queries_f32 * scales[None, :]
    b1 = torch.clamp_min(torch.amax(torch.abs(qs), dim=1), 1e-30) / 127.0
    q1 = torch.clamp(torch.round(qs / b1[:, None]), -127.0, 127.0)
    r = qs - b1[:, None] * q1
    b2 = torch.clamp_min(torch.amax(torch.abs(r), dim=1), 1e-30) / 127.0
    q2 = torch.clamp(torch.round(r / b2[:, None]), -127.0, 127.0)
    return q1.to(torch.int8), q2.to(torch.int8), b1, b2


def int8_groupmax_scores(queries_f32: torch.Tensor, db: torch.Tensor,
                         vn: torch.Tensor, scales: torch.Tensor, *,
                         metric: MetricType, with_block_max: bool = False):
    """(nq_pad, nv_eff/128) group maxes of the int8 sweep: ``faiss_tpu``'s
    groupmax_scores int8 branch, over the int8 codes ``db`` (and the
    supergroup maxes with ``with_block_max``, as groupmax_scores)."""
    q1, q2, b1, b2 = int8_query_pair(queries_f32, scales)
    return sweep_int8(q1, q2, db, vn, torch.stack([b1, b2], dim=1),
                      metric=metric, with_block_max=with_block_max)


# -- plain versions of the kernels ----------------------------------------


def block_max_plain(gm: torch.Tensor) -> torch.Tensor:
    """Plain version of the sweeps' second output: the max of each
    SUPERGROUP consecutive groups, (nq, ngroups/8)."""
    nq, ng = gm.shape
    if ng % SUPERGROUP:
        raise ValueError(f"block max needs ngroups % {SUPERGROUP} == 0 "
                         f"(ngroups={ng})")
    return torch.amax(gm.view(nq, ng // SUPERGROUP, SUPERGROUP), dim=-1)


def _plain_epilogue(acc, vn, metric: MetricType, with_block_max: bool):
    nv_eff = vn.shape[0]
    s = (2.0 * acc if metric is MetricType.L2 else acc) - vn[None, :]
    gm = torch.amax(s.view(s.shape[0], nv_eff // GROUP, GROUP), dim=-1)
    return (gm, block_max_plain(gm)) if with_block_max else gm


def sweep_groupmax_plain(q_hi, q_lo, db, vn, *, metric: MetricType,
                         with_block_max: bool = False):
    """Plain version of the bf16 sweep kernel: full (nq, nv_eff) scores,
    then a max per 128 columns. One fp32 product per plane (bf16×bf16
    products are exact), planes added at the end as in the kernel."""
    v = db[: vn.shape[0]].to(torch.float32)
    with exact_fp32_matmul():
        acc = q_hi.to(torch.float32) @ v.T
        if q_lo is not None:
            acc = acc + q_lo.to(torch.float32) @ v.T
    return _plain_epilogue(acc, vn, metric, with_block_max)


def sweep_split_plain(q_hi, q_lo, db_hi, db_lo, vn, *, metric: MetricType,
                      with_block_max: bool = False):
    """Plain version of the pair sweep kernel: one fp32 product per term,
    qh·dh, qh·dl, then ql·dh (two query planes), added left to right as in
    the kernel and the Pallas _kernel_split / _kernel_split2."""
    nv_eff = vn.shape[0]
    dh = db_hi[:nv_eff].to(torch.float32)
    dl = db_lo[:nv_eff].to(torch.float32)
    qh = q_hi.to(torch.float32)
    with exact_fp32_matmul():
        acc = qh @ dh.T + qh @ dl.T
        if q_lo is not None:
            acc = acc + q_lo.to(torch.float32) @ dh.T
    return _plain_epilogue(acc, vn, metric, with_block_max)


def sweep_f16_plain(q_hi, q_lo, dbits, vn, *, metric: MetricType,
                    with_block_max: bool = False, scales=None):
    """Plain version of the f16 sweep kernel, by the dtype of its planes.
    f16 planes (``split_f32_f16``, with their (nq, 2) ``scales``; K6): one
    fp32 product per plane over the stored rows as IEEE f16 values (f16×f16
    products are exact in fp32; an e=31 pattern is ±inf or NaN, as the
    tensor cores read it, where ``decode_f16_bits`` reads NaN as ±inf),
    each times its power of two, then added, as the kernel's epilogue does.
    bf16 planes: the rows decoded and split to the exact (hi, lo) pair
    (``storage.split_f16_bits``), then the pair sweep's plain version, term
    for term (_kernel_f16_pair / _kernel_f16_1)."""
    if q_hi.dtype == torch.float16:
        v = dbits[: vn.shape[0]].to(torch.float32)
        with exact_fp32_matmul():
            acc = ((q_hi.to(torch.float32) @ v.T) * scales[:, 0:1]
                   + (q_lo.to(torch.float32) @ v.T) * scales[:, 1:2])
        return _plain_epilogue(acc, vn, metric, with_block_max)
    hi, lo = split_f16_bits(dbits[: vn.shape[0]])
    return sweep_split_plain(q_hi, q_lo, hi, lo, vn, metric=metric,
                             with_block_max=with_block_max)


def sweep_int8_plain(q1, q2, db, vn, beta, *, metric: MetricType,
                     with_block_max: bool = False):
    """Plain version of the int8 sweep kernel. The two integer dots come
    from fp64 products of the integer-valued planes, exact because every
    partial sum is an integer below 2^53 (``torch.matmul`` takes no int8 on
    CUDA); then f32(a₁)·β₁ + f32(a₂)·β₂ with the kernel's three roundings
    in its order, so the two agree bit for bit."""
    v = db[: vn.shape[0]].to(torch.float64)
    a1 = (q1.to(torch.float64) @ v.T).to(torch.float32)
    a2 = (q2.to(torch.float64) @ v.T).to(torch.float32)
    dots = a1 * beta[:, 0:1] + a2 * beta[:, 1:2]
    return _plain_epilogue(dots, vn, metric, with_block_max)


def select_groups_plain(gm: torch.Tensor, kg: int):
    """Plain version of the group select, step for step the Pallas
    ``_select_kernel``: kg max-extractions (ties to the lowest column; a
    −inf tie may re-pick a marked column), t = max of the rest, then the
    marked set in ascending order, padded and clamped to ngroups−1. t is
    the value of the lowest unmarked column holding that max, bit for bit
    (the max alone takes the reduction order's sign on a −0.0 / +0.0 tie);
    −inf when every column is marked, NaN on a row holding a NaN."""
    nq, ng = gm.shape
    iota = torch.arange(ng, device=gm.device, dtype=torch.int32)[None, :]
    excl = torch.zeros_like(gm, dtype=torch.bool)
    for _ in range(kg):
        xm = gm.masked_fill(excl, NEG_INF)
        m = torch.amax(xm, dim=-1, keepdim=True)
        j = torch.amin(torch.where(xm == m, iota, _BIG), dim=-1, keepdim=True)
        excl |= iota == j
    xm = gm.masked_fill(excl, NEG_INF)
    m = torch.amax(xm, dim=-1, keepdim=True)
    col = torch.amin(torch.where((xm == m) & ~excl, iota, _BIG), dim=-1,
                     keepdim=True)
    t = torch.where(col < ng,
                    torch.gather(gm, 1, torch.clamp(col, max=ng - 1)
                                 .to(torch.int64)), m)[:, 0]
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
    to the lowest column not yet extracted, columns clamped to ncand−1.
    Each value is its column's own score, bit for bit (the extraction's
    max, but on a −0.0 / +0.0 tie, where the max's sign depends on the
    order of the reduction); a row holding a NaN gives (NaN, ncand−1)
    everywhere, the NaN being float('nan')."""
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
        c = torch.clamp(col, max=nc - 1)
        vals[:, j] = torch.where(col[:, 0] < nc,
                                 torch.gather(s, 1, c.to(torch.int64))[:, 0],
                                 math.nan)
        pos[:, j] = c[:, 0]
    return vals, pos


def candidate_columns(gidx: torch.Tensor) -> torch.Tensor:
    """(nq, kg·128) database row ids of the nominated groups, in order."""
    offs = torch.arange(GROUP, device=gidx.device, dtype=torch.int32)
    return (gidx[:, :, None] * GROUP + offs).reshape(gidx.shape[0], -1)


def candidate_drop(gidx: torch.Tensor, ntotal: int) -> torch.Tensor:
    """(nq, kg·128) True on the candidates of ``candidate_columns(gidx)``
    that the final top-k must not see: rows past ntotal, and the rows of a
    nominated group that repeats the one before it (``gidx`` is ascending,
    so a repeat is adjacent). Repeats come from the group select's padding:
    when fewer than kg groups score finitely (a selector admitting few
    rows), it pads the nominated set with group ngroups − 1, whose stored
    rows would otherwise come back once per copy. (faiss_tpu keeps this
    fault on its default route; its _rescore_select_kernel drops repeats by
    id.)"""
    rep = torch.zeros_like(gidx, dtype=torch.bool)
    rep[:, 1:] = gidx[:, 1:] == gidx[:, :-1]
    return ((candidate_columns(gidx) >= ntotal)
            | rep.repeat_interleave(GROUP, dim=1))


def rescore_groups_plain(queries, db, vn, gidx, *, metric: MetricType,
                         db2=None):
    """Plain version of the rescore kernel: gather the nominated groups'
    rows, widened exactly to fp32 (bf16 and int8 by conversion, f16 bits by
    ``storage.decode_f16_bits``; hi + lo in the pair mode, an exact fp32
    sum; f32 rows, the IVF fine scan's, as stored: the conversion is a
    no-op), one fp32 batched product with the fp32 queries (q∘s for int8),
    same epilogue. Group ids must lie in range (the kernel clamps them)."""
    cols = candidate_columns(gidx).to(torch.int64)
    rows = db[cols]                                        # (nq, kg·128, d)
    rows = decode_f16_bits(rows) if rows.dtype == torch.float16 \
        else rows.to(torch.float32)
    if db2 is not None:
        rows = rows + db2[cols].to(torch.float32)
    with exact_fp32_matmul():
        dots = torch.bmm(rows, queries[:, :, None])[:, :, 0]
    return (2.0 * dots if metric is MetricType.L2 else dots) - vn[cols]


def rescore_select_groups_plain(queries, db, vn, gidx, ntotal: int, *,
                                k: int, metric: MetricType):
    """Plain version of the rescore-select kernel: ``rescore_groups_plain``,
    the mask of ``candidate_drop`` (rows ≥ ntotal, repeated rows),
    ``final_select_plain``, and the selected columns mapped to row ids
    through ``candidate_columns``; the JAX package's own bar for
    _rescore_select_kernel is this chain's result."""
    s = rescore_groups_plain(queries, db, vn, gidx, metric=metric)
    vals, pos = final_select_plain(
        s.masked_fill(candidate_drop(gidx, ntotal), NEG_INF), k)
    return vals, torch.gather(candidate_columns(gidx), 1,
                              pos.to(torch.int64))


def rescore_exact(queries, db, db_norms, cols, *, metric: MetricType):
    """(nq, m) scores of the rows ``cols`` (nq, m) against the f32 master:
    the gathered rows times the fp32 queries in one batched product, true
    fp32 (stage 3b, and the single-stage f32 rescore). Raw norms: the
    caller masks columns past ntotal."""
    cols = cols.to(torch.int64)
    with exact_fp32_matmul():
        dots = torch.bmm(db[cols], queries[:, :, None])[:, :, 0]
    if metric is MetricType.L2:
        return 2.0 * dots - db_norms[cols]
    return dots


# -- phase 2 beyond the select kernel ------------------------------------------


def _top_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """int64 columns of the top-k of each row, ties to the lowest column
    (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return topk_scores(x, k)[1].to(torch.int64)


def _max_without(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row max of ``x`` with the columns ``idx`` set to −inf."""
    return torch.amax(x.scatter(1, idx, NEG_INF), dim=-1)


def _top_groups(gmax: torch.Tensor, kg: int, ngroups: int):
    """(top-kg group ids (nq, kg) int64, unordered, and t = the max group
    max among the non-nominated groups, −inf when all are nominated): the
    port of ``faiss_tpu``'s _top_groups without ``approx``, op for op, with
    stable sorts for ``lax.top_k``. From 65536 groups it goes hierarchical
    over supergroup maxes it reduces itself."""
    nq = gmax.shape[0]
    if ngroups < 65536 or ngroups % SUPERGROUP or kg * SUPERGROUP > ngroups:
        gidx = _top_idx(gmax, kg)
        if kg >= ngroups:
            return gidx, torch.full((nq,), NEG_INF, dtype=torch.float32,
                                    device=gmax.device)
        return gidx, _max_without(gmax, gidx)
    return _top_groups_from_bmax(gmax, block_max_plain(gmax), kg, ngroups)


def _top_groups_from_bmax(gmax: torch.Tensor, bmax: torch.Tensor, kg: int,
                          ngroups: int):
    """_top_groups' hierarchical route, fed by the sweep's own supergroup
    maxes (``with_block_max``): the port of ``faiss_tpu``'s
    _top_groups_from_bmax. The top-kg supergroups by block max provably
    hold the top-kg groups (a block's max bounds its groups); the top-kg of
    their kg·8 groups are nominated, and t is the max of the unnominated
    candidates and of the unnominated blocks."""
    nq = gmax.shape[0]
    bidx = _top_idx(bmax, kg)
    offs = torch.arange(SUPERGROUP, device=gmax.device)
    cand_cols = (torch.sort(bidx, dim=-1).values[:, :, None] * SUPERGROUP
                 + offs).reshape(nq, kg * SUPERGROUP)
    cand = torch.gather(gmax, 1, cand_cols)
    pos = _top_idx(cand, kg)
    gidx = torch.gather(cand_cols, 1, pos)
    t = _max_without(cand, pos)
    if kg < ngroups // SUPERGROUP:
        t = torch.maximum(t, _max_without(bmax, bidx))
    return gidx, t


# -- certificate ------------------------------------------------------------


def _sweep_eps(queries_f32: torch.Tensor, db_norms: torch.Tensor,
               nv_eff: int, *, metric: MetricType, d_pad: int,
               single_pass: bool = False, pair_sweep: bool = False,
               split_stats: Optional[torch.Tensor] = None,
               accum: str = "fmaf",
               f16_planes=None) -> torch.Tensor:
    """Per-query strict upper bound ε on |sweep score − rescore score| for
    any stored row: ``faiss_tpu``'s _sweep_eps, derived for this port's
    own arithmetic. ``accum`` names the sweep's accumulation: "fmaf" (the
    default, and the JAX bound) or "mma", the tensor-core sweeps with float
    sums (csrc/sweep_split_mma.cu: the bf16 rows', the f32 planes', the
    f16 rows' and the f16 pair's, with one or two query planes;
    ``sweep_accum`` picks it by route); only term (2) differs.
    ``f16_planes`` = (q_hi, q_lo, scales), the f16 split of
    ``split_f32_f16`` that the f16 rows' two-plane sweep on the card ran
    (K6, where ``sweep_query_split`` says "f16"; None: the JAX package's
    bf16 split): the stored f16 rows used whole and exactly, charged as
    bf16 rows are (s0 = s1 = 0, whatever ``pair_sweep`` says) with R and L
    of those planes: R ≈ 2^-22·Q where the bf16 split leaves ≈ 2^-16·Q, so
    ε only shrinks. Its planes are truncations of q toward zero (‖q_hi‖ ≤ Q), a
    term accumulates on the tensor cores in its plane's scaled space and
    its power of two multiplies it exactly, so term (2) holds as for bf16
    rows.

    Notation: u = 2^-24; Q = ‖q‖; R = ‖q − Σ q_planes‖ (computed exactly:
    the bit-mask split makes the subtractions exact; the f16 split's too,
    its planes unscaled); L = ‖q_lo‖;
    N = max stored ‖v‖² (pre-quantization), V = √N·(1+2^-8) ≥ max‖v_stored‖;
    pair sweep: s0 ≥ max‖v_lo‖, s1 ≥ max‖v − v_hi − v_lo‖ (the exact
    running split statistics, else the envelopes 2^-7·V and 2^-15·V).

      (1) dropped terms                       R·V
          pair sweep, also                    L·s0 + (Q+R)·s1
          (q_lo·v_lo, and (q_hi + q_lo)·(v − v_hi − v_lo))
      (2) sweep accumulation                  (d+2)·u·[(Q+R)·(V+s0) + L·V]
          the JAX bound's: per product term a sequential chain of exact
          bf16×bf16 products, round to nearest (a·b errs ≤ d·u·‖a‖·‖b‖;
          ‖q_hi‖, ‖q_rne‖ ≤ Q+R, ‖v_hi‖ ≤ V, ‖v_lo‖ ≤ s0), the ≤ 3 terms
          added once (+2·u); bf16 rows: s0 = 0. Every CPU tensor (the
          plain versions) is charged it
          accum="mma":                 (36·⌈d/16⌉ + 2)·u·[(Q+R)·(V+s0) + L·V]
          csrc/sweep_split_mma.cu: per product term one fp32 wgmma
          accumulator over ⌈d/16⌉ k-steps, each adding 16 exact bf16×bf16
          products to it in a sum not proven round-to-nearest. The model
          charges a step 2u·M for each of its 17 addends (M the largest
          addend magnitude: alignment by truncation, no guard bits) and
          2u·|result| for the normalisation; with every product and
          partial sum ≤ ‖a‖·‖b‖ (to first order) a step errs
          ≤ 36·u·‖a‖·‖b‖, a term ≤ 36·⌈d/16⌉·u·‖a‖·‖b‖; the norms above and
          the ≤ 2 round-to-nearest adds of the terms give the budget
          (≈ 2.2× the fmaf one at d = 128); the f16 pair: the f32 planes'
          arithmetic, with the f16 statistics; bf16 rows: two terms,
          s0 = 0; the f16 rows with two f16 query planes (K6,
          f16_planes): bf16 rows' two terms, 16 exact f16×f16
          products a k-step; bf16 rows with one query plane (K2,
          single_pass): the one term q1·v, ‖q1‖ ≤ Q+R, ‖v‖ ≤ V, errs
          ≤ 36·⌈d/16⌉·u·(Q+R)·V and is added to nothing, inside the
          budget with L = 0 and s0 = 0 (its +2u is slack): at d = 128
          term (2) is 290u·(Q+R)·V
          where the fmaf chain's was 130u·(Q+R)·V, and the whole ε grows
          ≈ 1.41× (term (3) stays 256u·Q·V); the f16 pair with one query
          plane (K7, single_pass, pair_sweep): the terms q1·dh and q1·dl
          err ≤ 36·⌈d/16⌉·u·(Q+R)·V and ≤ 36·⌈d/16⌉·u·(Q+R)·s0, and their
          one round-to-nearest add ≤ u·(Q+R)·(V+s0), inside the budget
          with L = 0; the f32 planes with one query plane (K4,
          single_pass, pair_sweep) are K7's case over the f32 split
          statistics: q1·dh errs ≤ 36·⌈d/16⌉·u·(Q+R)·V (‖q1‖ ≤ Q+R,
          ‖dh‖ ≤ V), q1·dl ≤ 36·⌈d/16⌉·u·(Q+R)·s0 (‖dl‖ ≤ s0, the exact
          statistic of ``st.split_stats``), each in its own accumulator,
          and their one round-to-nearest add ≤ u·(Q+R)·(V+s0): in all
          (36·⌈d/16⌉ + 1)·u·(Q+R)·(V+s0), inside the budget with L = 0
          (one accumulator over both terms would need another
          derivation)
      (3) rescore accumulation                2·d·u·Q·V
          csrc/rescore_groups.cu: a sequential fmaf chain of fp32 q times
          exactly widened rows, ≤ d·u·Q·V; f32 stage 3b: an fp32 product
          in any order, ≤ d·u·Q·V to first order
      (4) L2 epilogues fl(2·dot − ‖v‖²) on both sides and the rounding of
          fl(t + ε) in the comparison: 3·u·(2QV + N); IP: 2·u·Q·V
      (5) ×2 on (1)-(3) for L2; ×(1+2^-10) to make the bound strict and
          cover the rounding of this computation.
    """
    q = queries_f32
    if f16_planes is not None:
        qh, ql, sc = f16_planes
        if single_pass:
            raise ValueError("the f16 query split has two planes")
        if (qh.dtype != torch.float16 or ql.dtype != torch.float16
                or qh.shape != q.shape or ql.shape != q.shape
                or sc.shape != (q.shape[0], 2)):
            raise ValueError("f16_planes must be split_f32_f16 of the "
                             "queries")
        lo32 = ql.to(torch.float32) * sc[:, 1:2]
        resid = q - qh.to(torch.float32) * sc[:, 0:1] - lo32
        pair_sweep = False
    elif single_pass:
        resid = q - f32_to_bf16(q).to(torch.float32)
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
    if pair_sweep:
        s0, s1 = _stats_or_envelopes(split_stats, V)
        drop = R * V + L * s0 + (Q + R) * s1
    else:
        s0 = 0.0
        drop = R * V
    eps = (drop
           + _accum_coeff(d_pad, accum) * _U32 * ((Q + R) * (V + s0) + L * V)
           + 2.0 * d_pad * _U32 * Q * V)
    return _epilogue_eps(eps, Q, V, N, metric)


SWEEP_ROUTES = ("bf16", "pair", "hi_exact", "f16", "int8")


def sweep_accum(route: str, sweep_passes: int, device) -> str:
    """The accumulation ``_sweep_eps`` must charge for the sweep that
    ``route`` ran: "mma" where it ran on the tensor cores with float sums
    on the card, with one or two query planes: over bf16 rows (K2, K1:
    "bf16", and "hi_exact", whose sweep is the bf16 kernel over the hi
    plane), the f32 planes (K4, K3: "pair") or the f16 rows (K7 over the
    decoded pair, K6 over the stored rows: "f16"); "fmaf" for the int8
    route (exact integer sums, certified by ``_sweep_eps_int8``) and every
    CPU tensor (the plain versions; the JAX bound). ``sweep_passes`` (1 or 2) changes no route's answer."""
    if route not in SWEEP_ROUTES:
        raise ValueError(f"route must be one of {SWEEP_ROUTES}, got {route!r}")
    on_card = torch.device(device).type == "cuda"
    return "mma" if on_card and route != "int8" else "fmaf"


def sweep_query_split(route: str, sweep_passes: int, accum: str) -> str:
    """The query split of the sweep that ``route`` runs with ``accum``
    (``sweep_accum``'s answer): "f16" (``split_f32_f16``, whose planes the
    sweep and ``_sweep_eps(f16_planes=)`` share) where the f16 rows sweep
    two query planes on the tensor cores (K6, an f16 wgmma over the stored
    rows), "bf16" for every other route and every CPU tensor (the JAX
    package's split, so the CPU route keeps its arithmetic and its
    certificate)."""
    if route not in SWEEP_ROUTES:
        raise ValueError(f"route must be one of {SWEEP_ROUTES}, got {route!r}")
    return ("f16" if route == "f16" and sweep_passes == 2 and accum == "mma"
            else "bf16")


def _accum_coeff(d_pad: int, accum: str) -> float:
    """Term (2) of _sweep_eps over u·[(Q+R)·(V+s0) + L·V]."""
    if accum == "fmaf":
        return d_pad + 2.0
    if accum == "mma":
        return 36.0 * math.ceil(d_pad / 16) + 2.0
    raise ValueError(f"accum must be 'fmaf' or 'mma', got {accum!r}")


def _pair_rescore_eps(queries_f32: torch.Tensor, db_norms: torch.Tensor,
                      nv_eff: int, *, metric: MetricType, d_pad: int,
                      split_stats: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Tier-2 bound of the f32 two-stage rescore: strict upper bound ε₂ on
    |pair rescore(x) − exact rescore(x)| for any stored row x, where the
    pair rescore is stage 3a (rescore_groups' pair mode: one fmaf chain of
    fp32 q against the exact fp32 sum hi + lo) and the exact rescore is
    stage 3b (an fp32 product against the f32 master). ``faiss_tpu``'s
    _pair_rescore_eps, which holds for this arithmetic:
      dropped term         Q·s1              (q·(v − hi − lo); q is not split)
      pair accumulation    (d+6)·u·Q·(V+s0+s1)  (the chain errs
                                              ≤ d·u·Q·‖hi + lo‖ ≤ d·u·Q·(V+s1))
      exact accumulation   2·d·u·Q·V
      epilogues and the fl(t2 + ε₂) comparison as in _sweep_eps (4), (5).
    """
    Q = torch.sqrt(torch.sum(queries_f32 * queries_f32, dim=-1))
    N = torch.amax(db_norms[:nv_eff])
    V = torch.sqrt(N) * _QUANT_V
    s0, s1 = _stats_or_envelopes(split_stats, V)
    eps = (Q * s1
           + (d_pad + 6.0) * _U32 * Q * (V + s0 + s1)
           + 2.0 * d_pad * _U32 * Q * V)
    return _epilogue_eps(eps, Q, V, N, metric)


def _sweep_eps_int8(queries_f32: torch.Tensor, scales: torch.Tensor,
                    int_norm_max: torch.Tensor, db_norms: torch.Tensor,
                    nv_eff: int, *, metric: MetricType,
                    d_pad: int) -> torch.Tensor:
    """Per-query strict upper bound ε on |int8 sweep score − rescore score|
    for any stored row: ``faiss_tpu``'s _sweep_eps_int8, term for term,
    with the conversion term it misses.

    Both sides score the SAME stored codes v_q against the SAME computed
    qs = fl(q∘s) and subtract the same stored decoded norm, so the common
    target is qs·v_q:
      sweep   = fl(fl(β₁·f32(a₁)) + fl(β₂·f32(a₂))), a_i = q_i·v_q exact
                int32 dots (csrc/sweep_split_mma.cu, INT8_CODES)
      rescore = one fmaf chain of qs against the exactly widened codes
                (csrc/rescore_groups.cu INT8)
    Notation: u = 2^-24, Qs = ‖qs‖, Vq = max‖v_q‖ (``int_norm_max``),
    R1 = ‖qs − β₁q₁‖, Rs = ‖qs − β₁q₁ − β₂q₂‖, N = max stored norm.
      (1) dropped residual                    Rs·Vq
      (2) the β multiplies and the add        3·u·(Qs + 2·R1 + Rs)·Vq
          (‖β₁q₁‖ ≤ Qs + R1, ‖β₂q₂‖ ≤ R1 + Rs, |a_i| ≤ ‖q_i‖·Vq)
      (2') the conversions f32(a_i), inexact once |a_i| can pass 2^24,
          i.e. when 127²·d_pad ≥ 2^24 (d_pad ≥ 1041): each errs ≤ u·|a_i|,
          times β_i ≤ u·‖β_i q_i‖·Vq, together u·(Qs + 2·R1 + Rs)·Vq. The
          JAX bound assumes them exact (|a_i| ≤ 127²·d < 2^24 holds only
          for d ≤ 1040, yet its gate admits d_pad 2048); below that d_pad
          this bound equals the JAX one.
      (3) rescore accumulation                2·d·u·Qs·Vq (the chain errs
          ≤ d·u·Qs·Vq)
      (4), (5) epilogues, comparison, ×2 for L2 and the strictness slack
          as in _sweep_eps (with Qs, Vq for Q, V).
    """
    q1, q2, b1, b2 = int8_query_pair(queries_f32, scales)
    qs = queries_f32 * scales[None, :]
    r1 = qs - b1[:, None] * q1.to(torch.float32)
    resid = r1 - b2[:, None] * q2.to(torch.float32)
    Rs = torch.sqrt(torch.sum(resid * resid, dim=-1))
    R1 = torch.sqrt(torch.sum(r1 * r1, dim=-1))
    Qs = torch.sqrt(torch.sum(qs * qs, dim=-1))
    N = torch.amax(db_norms[:nv_eff])
    Vq = int_norm_max
    roundings = 3.0 + (1.0 if 127 * 127 * d_pad >= 2 ** 24 else 0.0)
    eps = (Rs * Vq
           + roundings * _U32 * (Qs + 2.0 * R1 + Rs) * Vq
           + 2.0 * d_pad * _U32 * Qs * Vq)
    return _epilogue_eps(eps, Qs, Vq, N, metric)


def _stats_or_envelopes(split_stats, V):
    if split_stats is not None:
        return split_stats[0], split_stats[1]
    return _LO_REL * V, _RESID_REL * V


def _epilogue_eps(eps, Q, V, N, metric: MetricType):
    """Terms (4) and (5) of _sweep_eps, shared by both bounds."""
    if metric is MetricType.L2:
        eps = 2.0 * eps + 3.0 * _U32 * (2.0 * Q * V + N)
    else:
        eps = eps + 2.0 * _U32 * Q * V
    return _EPS_SLACK * eps


# -- the fused search ---------------------------------------------------------


def fused_search(
    queries_f32: torch.Tensor,   # (nq_pad, d_pad) fp32
    db: torch.Tensor,            # (capacity, d_pad) bf16 rows, f32 master,
                                 # db_hi when pair_only, f16 bits (float16)
                                 # or int8 codes
    db_norms: torch.Tensor,      # (capacity,) fp32 ‖v‖² (pre-quantization;
                                 # int8: of the decoded rows)
    ntotal: int,
    *,
    k: int,
    metric: MetricType,
    nv_eff: int,
    sweep_passes: int = 2,
    db_split=None,               # f32 storage: the (db_hi, db_lo) planes
    pair_only: bool = False,     # the device holds only the planes
    split_stats: Optional[torch.Tensor] = None,  # (2,) exact plane maxima
                                 # (f32, and f16 over the decoded pair)
    hi_exact: bool = False,      # caller-proven split_stats == (0, 0)
    scales: Optional[torch.Tensor] = None,        # int8: (d_pad,) scales
    int_norm_max: Optional[torch.Tensor] = None,  # int8: () max ‖v_q‖
    sel: Optional[torch.Tensor] = None,  # (capacity,) bool selector stream
    rescore_select: bool = False,  # one-kernel rescore + top-k (opt-in)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores (nq_pad, k_eff) descending, ids (nq_pad, k_eff) int32,
    certified (nq_pad,) bool), k_eff = min(k, nv_eff). ``certified[i]``
    proves row i is the exact top-k of the stored database (the f32 master,
    hi + lo when pair_only, the f16 values, the decoded int8 rows) among
    the rows ``sel`` admits, ties to the lowest id; the caller re-runs the
    others on an exact path. The route follows the storage: ``db_split``
    (f32), float16 rows (f16), int8 rows (needs ``scales`` and
    ``int_norm_max``), else bf16 rows; f32 rows without the planes are
    refused (K10's f32-rows mode serves the IVF fine scan, which calls
    ``rescore_groups`` itself). ``rescore_select``
    runs phase 3 and the final top-k as one kernel where it applies (bf16,
    int8 and f16 rows, k_eff ≤ 32), as ``faiss_tpu`` does. No host
    synchronisation happens in here."""
    nq_pad, d_pad = queries_f32.shape
    k_eff = min(k, nv_eff)
    ngroups = nv_eff // GROUP
    kg = min(k_eff + GROUP_PAD, ngroups)
    pair_sweep = db_split is not None
    is_int8 = db.dtype == torch.int8
    if db.dtype == torch.float32 and not pair_sweep:
        raise ValueError("f32 rows need the (hi, lo) planes (db_split)")
    if hi_exact and not pair_sweep:
        raise ValueError("hi_exact requires the (hi, lo) planes")
    if is_int8 and (scales is None or int_norm_max is None):
        raise ValueError("int8 rows need scales and int_norm_max")
    vn = _premask_norms(db_norms, ntotal, nv_eff, metric, sel)

    # phase 1, and phase 2: at ≥ HIER_MIN_GROUPS groups the sweep also
    # writes the supergroup maxes, and phase 2 ranks those first
    hier = (ngroups >= HIER_MIN_GROUPS and ngroups % SUPERGROUP == 0
            and kg < ngroups // SUPERGROUP and kg * SUPERGROUP <= ngroups)
    # hi_exact: v == v_hi on every stored row, so the bf16 kernels over the
    # hi plane compute the pair program's scores bit for bit (every dropped
    # term is an exact +0.0); ε with stats (0, 0) charges them nothing
    is_f16 = db.dtype == torch.float16
    route = ("int8" if is_int8 else "f16" if is_f16 else "hi_exact"
             if hi_exact else "pair" if pair_sweep else "bf16")
    accum = None if is_int8 else sweep_accum(route, sweep_passes,
                                             queries_f32.device)
    # the f16 split (K6) is made once, for the sweep and its certificate
    f16_planes = (split_f32_f16(queries_f32) if sweep_query_split(
        route, sweep_passes, accum) == "f16" else None)
    if is_int8:
        gm = int8_groupmax_scores(queries_f32, db, vn, scales, metric=metric,
                                  with_block_max=hier)
    else:
        gm = groupmax_scores(
            queries_f32, db_split[0] if hi_exact else db, vn, metric=metric,
            sweep_passes=sweep_passes,
            db_split=None if hi_exact or not pair_sweep else db_split,
            with_block_max=hier, f16_planes=f16_planes)
    if not hier and kg <= SELECT_MAX_KG and ngroups <= SELECT_MAX_GROUPS:
        gidx, t = select_groups(gm, kg)         # ascending int32 already
    else:
        gidx, t = (_top_groups_from_bmax(gm[0], gm[1], kg, ngroups) if hier
                   else _top_groups(gm, kg, ngroups))
        gidx = torch.sort(gidx, dim=-1).values.to(torch.int32)

    if is_int8:
        eps = _sweep_eps_int8(queries_f32, scales, int_norm_max, db_norms,
                              nv_eff, metric=metric, d_pad=d_pad)
    else:
        # f16 sweeps the decoded pair (K7; every CPU tensor): the pair ε
        # with the f16 statistics, or with two query planes on the card
        # the stored rows against the f16 split (K6: ``f16_planes``);
        # bf16 rows (K2, K1), the f16 rows (K7, K6) with one or two query
        # planes, and the f32 planes (K4, K3) ran on the tensor cores
        # when the queries lie on the card
        eps = _sweep_eps(queries_f32, db_norms, nv_eff, metric=metric,
                         d_pad=d_pad, single_pass=sweep_passes == 1,
                         pair_sweep=pair_sweep or is_f16,
                         split_stats=split_stats,
                         accum=accum, f16_planes=f16_planes)
    if rescore_select and k_eff <= RESCORE_SELECT_MAX_K and not pair_sweep:
        # bf16 and f16 rows against q, int8 codes against q∘s; the
        # certificate is the sweep's alone, as in faiss_tpu
        q_resc = queries_f32 * scales[None, :] if is_int8 else queries_f32
        vals, ids = rescore_select_groups(q_resc, db, vn, gidx, ntotal,
                                          k=k_eff, metric=metric)
        certified = (t == NEG_INF) | (vals[:, k_eff - 1] >= t + eps)
        return vals, ids, certified

    cols = candidate_columns(gidx)
    drop = candidate_drop(gidx, ntotal)
    t2 = None
    # the rescores against the f32 master read the raw norms: a filtered
    # row must be masked again there (it reaches stage 3b only when the
    # selector leaves fewer than m live candidates)
    sel_remask = False
    if not pair_sweep:
        # bf16 and f16 rows against q; int8 codes against q∘s, so that the
        # scores are those of the decoded rows the norms belong to
        q_resc = queries_f32 * scales[None, :] if is_int8 else queries_f32
        s = rescore_groups(q_resc, db, vn, gidx, metric=metric)
    else:
        hi, lo = db_split[0], None if hi_exact else db_split[1]
        m = k_eff + F32_CAND_PAD
        if pair_only:
            # no master on the device: hi + lo is the stored database
            s = rescore_groups(queries_f32, hi, vn, gidx, metric=metric,
                               db2=lo)
        elif m < kg * GROUP:
            # two-stage: pair scores nominate m candidates (3a), the
            # master rescores them exactly (3b); t2 feeds the tier-2 bound
            s_pair = rescore_groups(queries_f32, hi, vn, gidx, metric=metric,
                                    db2=lo).masked_fill(drop, NEG_INF)
            if m <= SELECT_MAX_KG and s_pair.shape[1] <= SELECT_MAX_GROUPS:
                ppos, t2 = select_groups(s_pair, m)     # ascending positions
                ppos = ppos.to(torch.int64)
            else:
                _, ppos = topk_scores(s_pair, m)
                ppos = ppos.to(torch.int64)
                t2 = torch.gather(s_pair, 1, ppos[:, m - 1:])[:, 0]
                # ascending ids keep the lowest-id tie order downstream
                ppos = torch.gather(
                    ppos, 1, torch.sort(torch.gather(cols, 1, ppos),
                                        dim=1, stable=True).indices)
            # a dropped candidate (a repeat, a padding or filtered row) that
            # stage 3a had to take stays dropped after the raw rescore
            cols = torch.gather(cols, 1, ppos)
            drop = torch.gather(drop, 1, ppos)
            s = rescore_exact(queries_f32, db, db_norms, cols, metric=metric)
            sel_remask = sel is not None
        else:
            # single stage: too few candidates for stage 3a to thin out
            s = rescore_exact(queries_f32, db, db_norms, cols, metric=metric)
            sel_remask = sel is not None
    if sel_remask:
        drop |= ~sel[cols.to(torch.int64)]
    s = s.masked_fill(drop, NEG_INF)
    if (k_eff <= SELECT_MAX_KG
            and k_eff < s.shape[1] <= SELECT_MAX_GROUPS):
        vals, pos = final_select(s, k_eff)
    else:
        vals, pos = topk_scores(s, k_eff)
    ids = torch.gather(cols, 1, pos.to(torch.int64))

    certified = (t == NEG_INF) | (vals[:, k_eff - 1] >= t + eps)
    if t2 is not None:
        eps2 = _pair_rescore_eps(queries_f32, db_norms, nv_eff, metric=metric,
                                 d_pad=d_pad, split_stats=split_stats)
        certified &= (t2 == NEG_INF) | (vals[:, k_eff - 1] >= t2 + eps2)
    return vals, ids, certified


def fused_path_eligible(*, metric: MetricType, k: int, nv_eff: int,
                        d_pad: int, nq_pad: int = 128,
                        itemsize: int = 2, dtype=None) -> bool:
    """Dispatch gate, the JAX package's traffic cost model: the plain path
    pays for materializing the nq×nv fp32 scores and a k-scaled top-k over
    them, the fused path for the candidate gather. Its coefficients are
    carried from the JAX package, not measured on this card. ``itemsize``
    is the swept bytes per element: 4 for the f32 pair (d_pad ≤ 1024, and
    the gather reads two planes), 2 for bf16 rows, hi_exact and f16, 1 for
    int8 (its gather counted at 2 bytes, as the JAX gate counts it);
    ``dtype`` the stored rows' torch dtype: f16 (torch.float16) takes
    d_pad ≤ 1024, as in the JAX gate. Any k and any number of groups the
    JAX gate admits pass (phase 2 and the final top-k fall back to stable
    sorts past the select kernels' limits). Not carried: the JAX gate's
    refusal of d_pad > 128 shapes whose sweep tile breaks Mosaic's
    8-sublane rule (``_pick_block_v``); the CUDA sweeps have no such tile."""
    pair_sweep = itemsize == 4
    is_f16 = dtype == torch.float16
    if nv_eff < FUSED_MIN_NV or d_pad > (
            1024 if pair_sweep or is_f16 else 2048):
        return False
    ngroups = nv_eff // GROUP
    kg = min(k + GROUP_PAD, ngroups)
    gather_bytes = nq_pad * kg * GROUP * d_pad * (4 if pair_sweep else 2)
    if gather_bytes > FUSED_GATHER_BUDGET:
        return False
    plain_extra = nq_pad * nv_eff * (
        PLAIN_SCORE_BYTES + PLAIN_TOPK_BYTES_PER_K16 * k / 16.0)
    fused_extra = 2.0 * gather_bytes + nq_pad * ngroups * 8.0
    return fused_extra < plain_extra
