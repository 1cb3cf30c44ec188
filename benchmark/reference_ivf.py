"""The plain reference of an IVF-Flat search (faiss ``IndexIVFFlat`` at a
given nprobe), its controls, and the comparison that decides ``correct``
for an index whose answers are the exact top-k within the probed lists.

Plain PyTorch in float64 (TF32 off), blocked over rows, centroids and
queries so that it fits on the card, over the rows the benchmark made
itself (``datagen``) and the centroids the index trained: nothing of the
program is read but those centroids and the answers it returned. Imports
numpy, torch and the flat reference's helpers only.

The semantics, with cost(x, c) = ‖x − c‖² (L2) or −x·c (IP): row x lies in
its lowest-cost list (ties to the lowest list id); query q scans the rows
of its ``nprobe`` lowest-cost lists (ties to the lowest list id), and its
answer is the exact top-k of those rows.

The program takes both argmins on fp32 scores (``2x·c − ‖x‖² − ‖c‖²``, or
``x·c``), so where two costs lie within fp32 rounding of each other either
choice is sound. The rounding, for d products summed in any order
(Higham, Accuracy and Stability, Thm 3.5: |fl(x·c) − x·c| ≤ γ_d ‖x‖‖c‖,
γ_d = d·u / (1 − d·u), u = 2⁻²⁴): the dot product 2γ_d ‖x‖‖c‖, the two
subtractions u(2‖x‖‖c‖ + ‖x‖²) and u(2‖x‖‖c‖ + ‖x‖² + ‖c‖²), the fp32
‖c‖² u‖c‖²; fl(‖x‖²) is one number for every list of a row and cancels.
Their sum is at most

    e(x) = (d + 8) · u · (‖x‖ + max‖c‖)²        (d ≤ 4096)

for every list, so a computed argmin lies within 2·e(x) of the true
minimum (``coarse_eps``). Hence:

* a row is admissible in every list within 2e of its lowest cost (the ε
  band of rows);
* a list is surely probed when its cost + 2e lies below the (nprobe+1)-th
  lowest (no list outside the true top nprobe can then pass it), and maybe
  probed when its cost ≤ the nprobe-th lowest + 2e (the ε band of
  queries: maybe and not surely);
* a row is surely scanned when every list it is admissible in is surely
  probed, and may have been scanned when one of them may have been.

An answer row is judged by

* ``bad_ids``: it holds an id outside [0, n_rows), one outside the rows its
  query may have scanned, or one id twice;
* ``dist_err``: the largest gap between a returned distance and the exact
  distance of the id it was returned with;
* ``rank_gap``: the largest excess of its j-th best exact cost over the
  j-th best of the rows its query surely scanned (rows it may have scanned
  besides can only lower its costs: the positive part);

both gaps over the scale of the flat judge: ‖q‖² + max‖v‖² (L2),
‖q‖·max‖v‖ (IP). ``control_answers`` puts the reference in the program's
place: the scan in TF32 or bf16 inputs, or one probed list fewer.

The centroids themselves are held to k-means (``kmeans_excess``): their
k-means objective on the training rows against that of plain Lloyd's
k-means (``lloyd``) over the same rows with the same rounds, both in
fp64. The index's judge decides what excess it admits.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from benchmark.reference import BLOCK_ELEMS, Answers, _costs, _prep, _worst

U = 2.0 ** -24          # fp32's unit roundoff


@contextlib.contextmanager
def _no_tf32():
    """fp32 products in fp32 (the control's emulated TF32 rounds its own
    inputs), whatever the process set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def coarse_eps(norms: torch.Tensor, cmax: float, d: int) -> torch.Tensor:
    """e(x) of each row or query of norm ``norms``: the bound on the fp32
    rounding of any of its coarse scores (module docstring)."""
    if d > 4096:
        raise ValueError(f"coarse_eps holds for d ≤ 4096, not {d}")
    return (d + 8) * U * (norms + cmax) ** 2


class Centroids:
    """The trained centroids (an array, or a tensor) in float64 on
    ``device``, with their norms."""

    def __init__(self, centroids, l2: bool, device):
        if not torch.is_tensor(centroids):
            centroids = torch.as_tensor(np.asarray(centroids, np.float32))
        self.c = centroids.to(device=device, dtype=torch.float64)
        self.cn = (self.c * self.c).sum(1)
        self.cmax = float(self.cn.max().sqrt())
        self.nlist, self.d = self.c.shape
        self.l2 = l2

    def costs(self, x64: torch.Tensor) -> torch.Tensor:
        """(n, nlist) fp64 costs of the fp64 rows or queries ``x64``."""
        return _costs(x64, (x64 * x64).sum(1), self.c, self.cn, self.l2)

    def eps2(self, x64: torch.Tensor) -> torch.Tensor:
        """2·e(x) of each row: the width of its ε band."""
        return 2.0 * coarse_eps(torch.linalg.vector_norm(x64, dim=1),
                                self.cmax, self.d)

    def block(self) -> int:
        return max(1, BLOCK_ELEMS // self.nlist)


def assign(rows: torch.Tensor, cents: Centroids):
    """The lists of (n, d) fp32 rows: (primary (n,) int64, the lowest cost,
    ties to the lowest id; the ε band's other admissible (row, list) pairs
    as two (b,) int64, by row)."""
    prim, br, bl = [], [], []
    for r0 in range(0, rows.shape[0], cents.block()):
        x = rows[r0:r0 + cents.block()].to(torch.float64)
        c = cents.costs(x)
        cmin, a = torch.min(c, dim=1)       # the first minimum
        band = c <= (cmin + cents.eps2(x))[:, None]
        band[torch.arange(len(a), device=a.device), a] = False
        r, l = torch.nonzero(band, as_tuple=True)
        prim.append(a)
        br.append(r + r0)
        bl.append(l)
    return torch.cat(prim), torch.cat(br), torch.cat(bl)


def probe(q: torch.Tensor, cents: Centroids, nprobe: int):
    """The lists of (m, d) fp32 queries: (maybe (m, nlist) bool, surely
    (m, nlist) bool probed; the nprobe lowest-cost lists (m, nprobe) int64,
    ties to the lowest id)."""
    maybe, sure, top = [], [], []
    for q0 in range(0, q.shape[0], cents.block()):
        x = q[q0:q0 + cents.block()].to(torch.float64)
        c = cents.costs(x)
        order = torch.argsort(c, dim=1, stable=True)
        kth = torch.gather(c, 1, order[:, nprobe - 1:nprobe])
        nxt = (torch.gather(c, 1, order[:, nprobe:nprobe + 1])
               if nprobe < cents.nlist else torch.full_like(kth, np.inf))
        e2 = cents.eps2(x)[:, None]
        maybe.append(c <= kth + e2)
        sure.append(c + e2 < nxt)
        top.append(order[:, :nprobe])
    return torch.cat(maybe), torch.cat(sure), torch.cat(top)


class _Band:
    """One chunk's ε band of rows as a table: ``rows`` (nu,) local row ids,
    ``lists`` (nu, w) their other admissible lists (−1 past the last),
    ``pairs`` (b,) each band pair's index into ``rows``, ``lists_flat``
    (b,) the pair's list, and ``of`` (n,) each row's index into ``rows``
    (−1: not in the band)."""

    def __init__(self, n: int, br: torch.Tensor, bl: torch.Tensor):
        dev = br.device
        self.rows, self.pairs = torch.unique(br, return_inverse=True)
        self.lists_flat = bl
        cnt = torch.bincount(self.pairs, minlength=len(self.rows))
        w = int(cnt.max()) if len(cnt) else 0
        first = torch.cumsum(cnt, 0) - cnt
        self.lists = torch.full((len(self.rows), w), -1, dtype=torch.int64,
                                device=dev)
        self.lists[self.pairs, torch.arange(len(bl), device=dev)
                   - first[self.pairs]] = bl
        self.of = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.of[self.rows] = torch.arange(len(self.rows), device=dev)

    def widen(self, mb: torch.Tensor, sb: torch.Tensor, mp: torch.Tensor,
              sp: torch.Tensor) -> None:
        """Fold the band into a block's (Q, n) maybe- and surely-scanned
        masks, given its queries' (Q, nlist) probe tables."""
        if not len(self.rows):
            return
        Q, nu = mp.shape[0], len(self.rows)
        z = torch.zeros((Q, nu), dtype=torch.int32, device=mp.device)
        any_m = z.index_add(1, self.pairs,
                            mp[:, self.lists_flat].to(torch.int32)) > 0
        any_ns = z.index_add(1, self.pairs,
                             (~sp[:, self.lists_flat]).to(torch.int32)) > 0
        mb[:, self.rows] |= any_m
        sb[:, self.rows] &= ~any_ns

    def maybe(self, r: torch.Tensor, mp_rows: torch.Tensor) -> torch.Tensor:
        """Whether rows ``r`` (local ids) lie in a band list that the
        matching rows ``mp_rows`` (e, nlist) of the maybe table name."""
        out = torch.zeros(len(r), dtype=torch.bool, device=r.device)
        if not len(self.rows) or not len(r):
            return out
        b = self.of[r]
        hit = b >= 0
        lst = self.lists[b[hit]]                          # (h, w)
        ok = (lst >= 0) & torch.gather(mp_rows[hit], 1, lst.clamp_min(0))
        out[hit] = ok.any(1)
        return out


def _lowest(x64: torch.Tensor, cents: Centroids):
    """(lowest cost (n,), its list (n,)) of fp64 rows, blocked."""
    vals, lists = [], []
    for r0 in range(0, x64.shape[0], cents.block()):
        v, a = torch.min(cents.costs(x64[r0:r0 + cents.block()]), dim=1)
        vals.append(v)
        lists.append(a)
    return torch.cat(vals), torch.cat(lists)


def _train_rows(rows: torch.Tensor, l2: bool) -> torch.Tensor:
    """The training rows in fp64; for the inner product normalised, as
    spherical k-means takes them."""
    x = rows.to(torch.float64)
    if not l2:
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
            1e-30)
    return x


def kmeans_objective(rows: torch.Tensor, centroids: np.ndarray,
                     l2: bool) -> float:
    """The k-means objective of ``centroids`` on the training rows: the
    mean over rows of the lowest cost, in fp64 (L2: ‖x − c‖²; inner
    product: −x·c over the normalised rows)."""
    with _no_tf32():
        x = _train_rows(rows, l2)
        v, _ = _lowest(x, Centroids(centroids, l2, rows.device))
        return float(v.mean())


def lloyd(rows: torch.Tensor, nlist: int, niter: int, l2: bool,
          seed: int = 0) -> np.ndarray:
    """Plain Lloyd's k-means in fp64: ``nlist`` distinct training rows
    drawn by a torch generator seeded with ``seed`` as the start, then
    ``niter`` rounds of assigning each row to its lowest-cost centroid
    (ties to the lowest id) and moving each centroid to its rows' mean (an
    empty cluster keeps its centroid; the inner product's renormalised, as
    spherical k-means does). ``niter`` 0: the drawn rows themselves.
    Returns (nlist, d) float32."""
    with _no_tf32():
        x = _train_rows(rows, l2)
        g = torch.Generator(device=rows.device)
        g.manual_seed(seed)
        c = x[torch.randperm(x.shape[0], generator=g,
                             device=rows.device)[:nlist]]
        for _ in range(niter):
            _, a = _lowest(x, Centroids(c, l2, rows.device))
            sums = torch.zeros_like(c).index_add_(0, a, x)
            cnt = torch.bincount(a, minlength=nlist).to(x.dtype)
            new = sums / cnt.clamp_min(1.0)[:, None]
            if not l2:
                new = new / torch.linalg.vector_norm(
                    new, dim=1, keepdim=True).clamp_min(1e-30)
            c = torch.where((cnt > 0)[:, None], new, c)
        return c.to(torch.float32).cpu().numpy()


def kmeans_excess(rows: torch.Tensor, centroids: np.ndarray, niter: int,
                  l2: bool) -> Tuple[float, float, float]:
    """(excess, the centroids' objective, the reference's): how far the
    trained ``centroids``' k-means objective on the training ``rows`` lies
    above that of plain Lloyd's k-means (``lloyd``) over the same rows
    with the same number of rounds, as a share of the reference's
    magnitude. Positive: worse than the reference."""
    ref = kmeans_objective(rows, lloyd(rows, len(centroids), niter, l2), l2)
    got = kmeans_objective(rows, centroids, l2)
    return (got - ref) / abs(ref), got, ref


def judge(answers: Answers, pool: torch.Tensor, chunks_fn: Callable,
          centroids: np.ndarray, nprobe: int, k: int, l2: bool,
          n_rows: int) -> dict:
    """The comparison numbers over every answer (no selector sets):
    ``pool`` the (P, d) fp32 query pool on the reference's device,
    ``chunks_fn()`` a fresh iterable of the row chunks (first id, (n, d)
    fp32 rows) in id order, ``centroids`` the index's (nlist, d). Besides
    the numbers: ``band_rows``, the rows admissible in more than one list,
    ``band_queries``, the queries with a list maybe but not surely probed,
    and ``recall``, the share of the answers' ids that lie within their
    query's exact top-k over every row (its k-th best cost or better)."""
    if (answers.set_idx >= 0).any():
        raise ValueError("the IVF judge takes no selector sets")
    dev = pool.device
    out = dict(bad_ids=0, dist_err=0.0, rank_gap=0.0,
               answers=int(answers.count.sum()), band_rows=0,
               band_queries=0, recall=0.0)
    qsel, a_q = np.unique(answers.pool_idx, return_inverse=True)
    a_q = torch.as_tensor(a_q, device=dev)
    q = pool[torch.as_tensor(qsel, device=dev)]
    ids = torch.as_tensor(answers.ids, device=dev)
    with _no_tf32():
        cents = Centroids(centroids, l2, dev)
        mp, sp, _ = probe(q, cents, nprobe)
        out["band_queries"] = int((mp & ~sp).any(1).sum())
        m = q.shape[0]
        q64 = q.to(torch.float64)
        qn = (q64 * q64).sum(1)
        sure_best = torch.full((m, 0), np.inf, dtype=torch.float64,
                               device=dev)
        all_best = sure_best
        ans_cost = torch.full(ids.shape, np.inf, dtype=torch.float64,
                              device=dev)
        ans_ok = torch.zeros(ids.shape, dtype=torch.bool, device=dev)
        max_norm2 = 0.0
        for start, rows in chunks_fn():
            n = rows.shape[0]
            a, br, bl = assign(rows, cents)
            band = _Band(n, br, bl)
            out["band_rows"] += len(band.rows)
            r64 = rows.to(torch.float64)
            rn = (r64 * r64).sum(1)
            max_norm2 = max(max_norm2, float(rn.max()))
            qb = max(1, BLOCK_ELEMS // max(n, 1))
            blocks, every = [], []
            for q0 in range(0, m, qb):
                c = _costs(q64[q0:q0 + qb], qn[q0:q0 + qb], r64, rn, l2)
                every.append(torch.topk(c, min(k, n), dim=1,
                                        largest=False).values)
                mpb, spb = mp[q0:q0 + qb], sp[q0:q0 + qb]
                mb, sb = mpb[:, a], spb[:, a]
                band.widen(mb, sb, mpb, spb)
                cv = torch.topk(c.masked_fill_(~sb, np.inf), min(k, n),
                                dim=1, largest=False).values
                blocks.append(cv)
            sure_best = torch.sort(torch.cat([sure_best, torch.cat(blocks)],
                                             1), dim=1).values[:, :k]
            all_best = torch.sort(torch.cat([all_best, torch.cat(every)], 1),
                                  dim=1).values[:, :k]
            inside = (ids >= start) & (ids < start + n)
            uu, jj = torch.nonzero(inside, as_tuple=True)
            if uu.numel():
                r = ids[uu, jj] - start
                qq = q64[a_q[uu]]
                v = r64[r]
                dots = (qq * v).sum(1)
                ans_cost[uu, jj] = ((qq * qq).sum(1) + (v * v).sum(1)
                                    - 2.0 * dots if l2 else -dots)
                mrow = mp[a_q[uu]]
                ans_ok[uu, jj] = (torch.gather(mrow, 1, a[r][:, None])[:, 0]
                                  | band.maybe(r, mrow))
    valid = (ids >= 0) & (ids < n_rows) & ans_ok
    hits = (valid & (ans_cost <= all_best[a_q, -1:])).sum(1).cpu().numpy()
    out["recall"] = float((answers.count * hits).sum()
                          / (answers.count.sum() * all_best.shape[1]))
    srt = torch.sort(ids, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    bad = (~valid).any(1) | dup
    cnt = answers.count
    out["bad_ids"] = int(cnt[bad.cpu().numpy()].sum())
    good = ~bad
    if not bool(good.any()):
        return out
    qa = q64[a_q]
    scale = ((qa * qa).sum(1) + max_norm2 if l2
             else torch.linalg.vector_norm(qa, dim=1) * max_norm2 ** 0.5)
    sc = scale[good][:, None]
    exact = ans_cost[good]
    d_ret = torch.as_tensor(answers.dists, device=dev,
                            dtype=torch.float64)[good]
    value = exact if l2 else -exact
    out["dist_err"] = _worst(0.0, float(((d_ret - value).abs() / sc).max()))
    got = torch.sort(exact, dim=1).values
    ref = sure_best[a_q][good]
    if ref.shape[1] < got.shape[1]:         # fewer surely scanned rows than k
        ref = torch.cat([ref, ref.new_full(
            (ref.shape[0], got.shape[1] - ref.shape[1]), np.inf)], 1)
    out["rank_gap"] = _worst(0.0, float(((got - ref) / sc).max()))
    return out


def control_answers(pool: torch.Tensor, pool_idx: np.ndarray,
                    chunks: Iterable[Tuple[int, torch.Tensor]],
                    centroids: np.ndarray, nprobe: int, k: int, l2: bool,
                    precision: str = "fp64",
                    skip: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A control: the reference put in the program's place, answering the
    pool queries ``pool_idx`` with the IVF semantics at ``nprobe`` (the
    lists and the probe in fp64, no ε band), the scan's costs in
    ``precision`` (``fp64``; ``tf32`` or ``bf16``: inputs rounded to that
    mantissa, fp32 arithmetic), the ``skip`` nearest of the probed lists
    left out. Returns the (n, k) fp32 distances and int64 ids a caller
    would get (ties to the lower id; −1 past the scanned rows)."""
    dev = pool.device
    qsel, inv = np.unique(pool_idx, return_inverse=True)
    q = pool[torch.as_tensor(qsel, device=dev)]
    m = q.shape[0]
    with _no_tf32():
        cents = Centroids(centroids, l2, dev)
        _, _, top = probe(q, cents, nprobe)
        probed = torch.zeros((m, cents.nlist), dtype=torch.bool, device=dev)
        probed.scatter_(1, top[:, skip:], True)
        qp = _prep(q, precision)
        qn = (qp * qp).sum(1)
        best_c = torch.full((m, 0), np.inf, dtype=qp.dtype, device=dev)
        best_i = torch.zeros((m, 0), dtype=torch.int64, device=dev)
        for start, rows in chunks:
            n = rows.shape[0]
            a, _, _ = assign(rows, cents)
            vp = _prep(rows, precision)
            vn = (vp * vp).sum(1)
            qb = max(1, BLOCK_ELEMS // max(n, 1))
            cs, cis = [], []
            for q0 in range(0, m, qb):
                c = _costs(qp[q0:q0 + qb], qn[q0:q0 + qb], vp, vn, l2)
                c.masked_fill_(~probed[q0:q0 + qb][:, a], np.inf)
                cv, ci = torch.topk(c, min(k, n), dim=1, largest=False,
                                    sorted=True)
                cs.append(cv)
                cis.append(ci + start)
            cc = torch.cat([best_c, torch.cat(cs)], 1)
            ii = torch.cat([best_i, torch.cat(cis)], 1)
            # ties to the lower id: sort by id, then stably by cost
            o = torch.argsort(ii, dim=1)
            cc, ii = torch.gather(cc, 1, o), torch.gather(ii, 1, o)
            o = torch.argsort(cc, dim=1, stable=True)[:, :k]
            best_c, best_i = torch.gather(cc, 1, o), torch.gather(ii, 1, o)
    best_i = best_i.masked_fill(torch.isinf(best_c), -1)
    c = best_c.to(torch.float32).cpu().numpy()[inv]
    return (c if l2 else -c), best_i.cpu().numpy()[inv]


def control_spec(name: str, nprobe: int):
    """(nprobe, precision, skip, rounds) of a control by name, at a cell's
    ``nprobe``: ``fp64`` the reference itself, ``tf32`` and ``bf16`` the
    scan's inputs rounded, ``nprobe<n>`` n lists probed, ``nearest_dropped``
    each query's nearest probed list left out; ``lloyd<n>`` the centroids
    of plain Lloyd's k-means with n rounds in place of the index's
    (``lloyd``; 0: training rows taken as centroids), searched exactly at
    ``nprobe`` (``rounds`` None: the index's own centroids)."""
    if name in ("fp64", "tf32", "bf16"):
        return nprobe, name, 0, None
    if name == "nearest_dropped":
        return nprobe, "fp64", 1, None
    if name.startswith("nprobe") and name[6:].isdigit():
        return int(name[6:]), "fp64", 0, None
    if name.startswith("lloyd") and name[5:].isdigit():
        return nprobe, "fp64", 0, int(name[5:])
    raise SystemExit(f"unknown IVF control {name!r}")
