"""The plain reference of a flat exact k-NN search, its lower-precision
control, and the comparison that decides ``correct``.

Plain PyTorch in float64, blocked over rows and queries, over the rows the
benchmark made itself (``datagen``): nothing of the program is read but
the answers it returned, which are judged here. Imports numpy and torch
only.

Every value is handled as a cost, lower is better: the squared L2
distance, or the negated inner product. An answer row is judged by

* ``bad_ids``: it holds an id outside [0, n_rows), one that its selector
  does not admit, or one id twice;
* ``dist_err``: the largest gap between a returned distance and the exact
  distance of the id it was returned with;
* ``rank_gap``: the largest gap between its j-th best exact cost and the
  reference's j-th best (0 for an exact answer, whatever the order of
  ties);

both gaps over the scale of the query's values: ‖q‖² + max‖v‖² for L2,
‖q‖·max‖v‖ for the inner product.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

# elements of one (query block, row chunk) block of costs
BLOCK_ELEMS = 1 << 28


def _round_mantissa(x: torch.Tensor, keep_bits: int) -> torch.Tensor:
    """fp32 rounded to nearest even at ``keep_bits`` mantissa bits (10:
    TF32's inputs; 7: bf16's)."""
    drop = 23 - keep_bits
    b = x.contiguous().view(torch.int32)
    half = (1 << (drop - 1)) - 1
    b = (b + half + ((b >> drop) & 1)) & ~((1 << drop) - 1)
    return b.view(torch.float32)


PRECISIONS = {"fp64": None, "tf32": 10, "bf16": 7}


def _costs(q: torch.Tensor, qn: torch.Tensor, v: torch.Tensor,
           vn: torch.Tensor, l2: bool) -> torch.Tensor:
    dots = q @ v.T
    return qn[:, None] + vn[None, :] - 2.0 * dots if l2 else -dots


def _prep(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The operands in the pass's precision: fp64, or fp32 whose inputs
    are rounded to TF32's or bf16's mantissa (the products then add in
    fp32, as on the tensor cores)."""
    if precision == "fp64":
        return x.to(torch.float64)
    return _round_mantissa(x.to(torch.float32), PRECISIONS[precision])


@dataclass
class PassResult:
    ref_ids: torch.Tensor        # (m, k) int64, best first
    ref_cost: torch.Tensor       # (m, k) costs in the pass's precision
    ans_cost: Optional[torch.Tensor]  # (u, k) fp64 exact cost of each
                                 # answered id
    max_norm2: float             # max ‖v‖² over every row, fp64


def knn_pass(chunks: Iterable[Tuple[int, torch.Tensor]], q: torch.Tensor,
             k: int, l2: bool, *, n_rows: int,
             admit: Optional[torch.Tensor] = None,
             answers: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             precision: str = "fp64") -> PassResult:
    """One pass over the row chunks ((first id, (n, d) fp32 rows), in id
    order) for the (m, d) fp32 queries ``q``: each query's k best admitted
    rows (``admit``: an (n_rows,) bool, None for all) by exact fp64 costs,
    or in ``precision`` (the control); and, for ``answers`` = (query index
    into q (u,), ids (u, k)), the exact fp64 cost of each answered id."""
    dev = q.device
    m = q.shape[0]
    if m == 0:
        raise ValueError("knn_pass needs at least one query")
    qp = _prep(q, precision)
    qn = (qp * qp).sum(1)
    q64 = q.to(torch.float64)
    best_c = torch.full((m, 0), float("inf"), dtype=qp.dtype, device=dev)
    best_i = torch.zeros((m, 0), dtype=torch.int64, device=dev)
    ans_cost = None
    if answers is not None:
        a_q, a_ids = answers
        ans_cost = torch.full(a_ids.shape, float("inf"), dtype=torch.float64,
                              device=dev)
    max_norm2 = 0.0
    for start, rows in chunks:
        n = rows.shape[0]
        r64 = rows.to(torch.float64)
        rn64 = (r64 * r64).sum(1)
        max_norm2 = max(max_norm2, float(rn64.max()))
        vp = _prep(rows, precision)
        vn = rn64 if precision == "fp64" else (vp * vp).sum(1)
        drop = None if admit is None else ~admit[start:start + n]
        qb = max(1, BLOCK_ELEMS // max(n, 1))
        for q0 in range(0, m, qb):
            c = _costs(qp[q0:q0 + qb], qn[q0:q0 + qb], vp, vn, l2)
            if drop is not None:
                c.masked_fill_(drop[None, :], float("inf"))
            kk = min(k, n)
            cv, ci = torch.topk(c, kk, dim=1, largest=False, sorted=True)
            cc = torch.cat([best_c[q0:q0 + qb], cv], 1)
            ii = torch.cat([best_i[q0:q0 + qb], ci + start], 1)
            if q0 == 0:
                new_c = torch.empty((m, min(k, cc.shape[1])), dtype=qp.dtype,
                                    device=dev)
                new_i = torch.empty(new_c.shape, dtype=torch.int64,
                                    device=dev)
            # ties to the lower id: sort by id, then stably by cost
            o = torch.argsort(ii, dim=1)
            cc, ii = torch.gather(cc, 1, o), torch.gather(ii, 1, o)
            o = torch.argsort(cc, dim=1, stable=True)[:, :new_c.shape[1]]
            new_c[q0:q0 + qb] = torch.gather(cc, 1, o)
            new_i[q0:q0 + qb] = torch.gather(ii, 1, o)
        best_c, best_i = new_c, new_i
        if answers is not None:
            inside = (a_ids >= start) & (a_ids < start + n)
            uu, jj = torch.nonzero(inside, as_tuple=True)
            if uu.numel():
                v = r64[a_ids[uu, jj] - start]
                qq = q64[a_q[uu]]
                dots = (qq * v).sum(1)
                cost = ((qq * qq).sum(1) + (v * v).sum(1) - 2.0 * dots
                        if l2 else -dots)
                ans_cost[uu, jj] = cost
    return PassResult(best_i, best_c, ans_cost, max_norm2)


@dataclass
class Answers:
    """Answer rows to judge: for each, its query's index into the pool,
    its selector set (-1: none), and the returned (k,) distances and ids;
    ``count`` how many identical answers each row stands for."""
    pool_idx: np.ndarray      # (u,) int64
    set_idx: np.ndarray       # (u,) int64
    dists: np.ndarray         # (u, k) float32, as returned
    ids: np.ndarray           # (u, k) int64, as returned
    count: np.ndarray         # (u,) int64

    @staticmethod
    def unique(pool_idx, set_idx, dists, ids) -> "Answers":
        """The distinct answers among many (every repeat is the same
        judgement)."""
        dists = np.ascontiguousarray(dists, np.float32)
        ids = np.ascontiguousarray(ids, np.int64)
        key = np.concatenate(
            [np.asarray(pool_idx, np.int64)[:, None],
             np.asarray(set_idx, np.int64)[:, None], ids,
             dists.view(np.int32).astype(np.int64)], axis=1)
        _, first, count = np.unique(key, axis=0, return_index=True,
                                    return_counts=True)
        return Answers(np.asarray(pool_idx, np.int64)[first],
                       np.asarray(set_idx, np.int64)[first], dists[first],
                       ids[first], count.astype(np.int64))


def admit_masks(sets, n_rows: int, device):
    """Each selector set (sorted ids) as an (n_rows,) bool on ``device``."""
    out = []
    for s in sets:
        a = torch.zeros(n_rows, dtype=torch.bool, device=device)
        a[torch.as_tensor(s, device=device)] = True
        out.append(a)
    return out


def _worst(cur: float, x: float) -> float:
    """The larger reading; a non-finite one (a NaN distance) is +inf."""
    return math.inf if not math.isfinite(x) else max(cur, x)


def judge(answers: Answers, pool: torch.Tensor, chunks_fn: Callable,
          k: int, l2: bool, n_rows: int, admits) -> dict:
    """The comparison numbers over every answer. ``pool``: the (P, d) fp32
    query pool on the reference's device; ``chunks_fn()``: a fresh
    iterable of the row chunks; ``admits[s]``: selector set s as an
    (n_rows,) bool on that device."""
    dev = pool.device
    out = dict(bad_ids=0, dist_err=0.0, rank_gap=0.0,
               answers=int(answers.count.sum()))
    for s in np.unique(answers.set_idx):
        rows_s = np.nonzero(answers.set_idx == s)[0]
        qsel, a_q = np.unique(answers.pool_idx[rows_s], return_inverse=True)
        ids = answers.ids[rows_s]
        cnt = answers.count[rows_s]
        admit = None if s < 0 else admits[int(s)]
        q = pool[torch.as_tensor(qsel, device=dev)]
        ids_t = torch.as_tensor(ids, device=dev)
        safe = ids_t.clamp(0, max(n_rows - 1, 0))
        res = knn_pass(chunks_fn(), q, k, l2, n_rows=n_rows, admit=admit,
                       answers=(torch.as_tensor(a_q, device=dev), safe))
        valid = (ids_t >= 0) & (ids_t < n_rows)
        if admit is not None:
            valid &= admit[safe]
        srt = torch.sort(ids_t, dim=1).values
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        bad = (~valid).any(1) | dup
        out["bad_ids"] += int(cnt[bad.cpu().numpy()].sum())
        good = ~bad
        if not bool(good.any()):
            continue
        q64 = q.to(torch.float64)[torch.as_tensor(a_q, device=dev)]
        r2 = res.max_norm2
        scale = ((q64 * q64).sum(1) + r2 if l2
                 else torch.linalg.vector_norm(q64, dim=1) * r2 ** 0.5)
        exact = res.ans_cost[good]
        d_ret = torch.as_tensor(answers.dists[rows_s], device=dev,
                                dtype=torch.float64)[good]
        value = exact if l2 else -exact
        sc = scale[good][:, None]
        out["dist_err"] = _worst(out["dist_err"],
                                 float(((d_ret - value).abs() / sc).max()))
        ref = res.ref_cost.to(torch.float64)[torch.as_tensor(
            a_q, device=dev)][good]
        got = torch.sort(exact, dim=1).values
        out["rank_gap"] = _worst(out["rank_gap"],
                                 float(((got - ref) / sc).max()))
    return out


def control_answers(pool: torch.Tensor, pool_idx: np.ndarray,
                    set_idx: np.ndarray, chunks_fn: Callable, k: int,
                    l2: bool, n_rows: int, admits,
                    precision: str) -> Tuple[np.ndarray, np.ndarray]:
    """The control: the reference put in the program's place, in
    ``precision`` (TF32 or bf16 inputs, fp32 arithmetic), answering the
    queries ``pool_idx`` under the selector sets ``set_idx``. Returns the
    (n, k) fp32 distances and int64 ids a caller would get."""
    dev = pool.device
    n = len(pool_idx)
    dists = np.zeros((n, k), np.float32)
    ids = np.zeros((n, k), np.int64)
    for s in np.unique(set_idx):
        rows_s = np.nonzero(set_idx == s)[0]
        qsel, inv = np.unique(pool_idx[rows_s], return_inverse=True)
        res = knn_pass(chunks_fn(), pool[torch.as_tensor(qsel, device=dev)],
                       k, l2, n_rows=n_rows,
                       admit=None if s < 0 else admits[int(s)],
                       precision=precision)
        c = res.ref_cost.to(torch.float32).cpu().numpy()[inv]
        dists[rows_s] = c if l2 else -c
        ids[rows_s] = res.ref_ids.cpu().numpy()[inv]
    return dists, ids
