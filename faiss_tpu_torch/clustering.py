"""k-means with balanced training, and the functional knn (faiss.Kmeans,
faiss.kmeans_clustering, faiss.knn, faiss.pairwise_distances).

Counterpart of ``faiss_tpu/clustering.py``. The JAX package compiles the
whole Lloyd run into one program (``lax.scan`` over the iterations,
``lax.map`` over data chunks); PyTorch runs eagerly, so here it is a Python
loop over iterations and chunks of ``_CHUNK`` rows, with the same
arithmetic:

  * E-step: ``ops/distance.matmul_scores`` (the index's plain-path GEMM,
    true fp32) against the centroids, then the first argmax of each row;
  * M-step: the one-hot product ``ohᵀ @ x`` in exact fp32 (each product is
    1·x) and the counts as column sums of the one-hot. No scatter and no
    atomics: the same data on the same card gives the same centroids bit
    for bit (three IVF trainings of one set agree, ``chip_smoke.py``);
  * empty clusters: the j-th empty centroid is re-seeded on the point
    ranked j-th by distance to its own centroid (the worst served), from
    one top-k per chunk and one over their union, ties to the lowest row
    (``ops/topk.topk_scores``, ``lax.top_k``'s order);
  * spherical: centroids L2-renormalised after every M-step.

Every product here is a plain GEMM that the JAX package also computes
outside Pallas, so ``torch.matmul`` under ``exact_fp32_matmul`` (no TF32)
is the port of it. The random choices (the subsample, one initial pick per
redo) are drawn from one ``np.random.default_rng(seed)`` in the JAX class's
order, so both packages start from the same points. ``balance_centroids``
keeps the JAX package's numpy ``split_pass`` as it is, quirk included: a
degenerate split that is skipped still counts towards ``nsplit``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import MetricType
from .ops import distance as dist_ops
from .ops.distance import exact_fp32_matmul
from .ops.topk import topk_scores
from .resources import TorchResources, bind_device
from .storage import _round_up

__all__ = ["Kmeans", "balance_centroids", "kmeans_clustering", "knn",
           "pairwise_distances"]

# training rows per E/M block: one (chunk, k) score block and one (chunk, k)
# one-hot live at a time (256 MB each at k = 4096)
_CHUNK = 16_384
# at most this many empty clusters re-seeded per iteration (more wait for
# the next iteration)
_MAX_RESEED = 128


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu'")
    return device


def _padded(x: np.ndarray, device):
    """(x padded to a multiple of the chunk on ``device``, valid mask,
    chunk): the JAX package's padding, so every chunk has ``chunk`` rows."""
    n = x.shape[0]
    chunk = min(_CHUNK, _round_up(n, 8))
    n_pad = _round_up(n, chunk)
    xp = torch.zeros((n_pad, x.shape[1]), dtype=torch.float32)
    xp[:n] = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    valid = torch.zeros((n_pad,), dtype=torch.bool)
    valid[:n] = True
    return xp.to(device), valid.to(device), chunk


def _lloyd_iter(cents: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                chunk: int, metric: MetricType, spherical: bool):
    """One Lloyd iteration over the padded rows: (new centroids (k, d),
    objective as a device scalar) — ``faiss_tpu``'s one_iter."""
    k, d = cents.shape
    reseed = min(_MAX_RESEED, k, chunk)
    cnorm = torch.sum(cents * cents, dim=-1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    obj = torch.zeros((), dtype=torch.float32, device=x.device)
    rows = torch.arange(chunk, device=x.device)
    sign = 1.0 if metric is MetricType.INNER_PRODUCT else -1.0
    wvs, wis = [], []
    for c0 in range(0, x.shape[0], chunk):
        xs, vs = x[c0:c0 + chunk], valid[c0:c0 + chunk]
        s = dist_ops.matmul_scores(xs, cents, cnorm, metric)
        bscore, best = torch.max(s, dim=-1)     # the first max, as argmax
        oh = torch.zeros((chunk, k), dtype=torch.float32, device=x.device)
        oh[rows, best] = vs.to(torch.float32)
        with exact_fp32_matmul():
            sums += oh.T @ xs
        counts += torch.sum(oh, dim=0)
        # L2: Σ‖x − c‖² = −Σ score; IP: Σ score
        obj += torch.sum(torch.where(vs, bscore, 0.0)) * sign
        # the worst-served rows, candidates for re-seeding empty clusters
        wv, wi = topk_scores(-torch.where(vs, bscore, float("inf")), reseed)
        wvs.append(wv)
        wis.append(wi.to(torch.int64) + c0)
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    _, gi = topk_scores(torch.cat(wvs), reseed)
    cand = x[torch.cat(wis)[gi.to(torch.int64)]]
    empty = counts == 0.0
    rank = torch.cumsum(empty.to(torch.int64), dim=0) - 1   # j-th empty → j
    take = torch.clamp(rank, 0, reseed - 1)
    new = torch.where((empty & (rank < reseed))[:, None], cand[take], new)
    new = torch.where((empty & (rank >= reseed))[:, None], cents, new)
    if spherical:
        nrm = torch.sqrt(torch.sum(new * new, dim=-1, keepdim=True))
        new = new / torch.clamp_min(nrm, 1e-30)
    return new, obj


def _lloyd_train(x, valid, init, *, niter: int, chunk: int,
                 metric: MetricType, spherical: bool):
    """``niter`` Lloyd iterations from ``init``: (centroids (k, d) device,
    objective per iteration (niter,) f32 host), ``faiss_tpu``'s
    _lloyd_train_fn. The objectives stay on the device until the end."""
    cents, objs = init, []
    for _ in range(niter):
        cents, obj = _lloyd_iter(cents, x, valid, chunk, metric, spherical)
        objs.append(obj)
    return cents, torch.stack(objs).cpu().numpy()


def _assign_only(x, valid, cents, *, chunk: int,
                 metric: MetricType) -> torch.Tensor:
    """The E-step alone: (n_pad,) int64 nearest-centroid ids, −1 on pad
    rows (``faiss_tpu``'s _assign_only_fn)."""
    cnorm = torch.sum(cents * cents, dim=-1)
    out = []
    for c0 in range(0, x.shape[0], chunk):
        s = dist_ops.matmul_scores(x[c0:c0 + chunk], cents, cnorm, metric)
        a = torch.argmax(s, dim=-1)
        out.append(torch.where(valid[c0:c0 + chunk], a, -1))
    return torch.cat(out)


def balance_centroids(x: np.ndarray, centroids: np.ndarray, *,
                      cap_ratio: float = 2.0, rounds: int = 6,
                      lloyd_iters: int = 2, metric=MetricType.L2,
                      spherical: bool = False, verbose: bool = False,
                      device="cuda") -> np.ndarray:
    """Rebalance trained centroids so that no cluster holds more than
    ~``cap_ratio`` × the mean occupancy of the training sample
    (``faiss_tpu``'s balance_centroids, round for round). Each round: the
    E-step's occupancy → each oversized cluster split in two along its
    spread direction (the half-means either side of the median
    projection), the smallest clusters retired to keep k fixed → a
    ``lloyd_iters`` warm-started Lloyd polish; the last round's split
    stays unpolished. faiss has no balancing: it trades a slightly higher
    objective for a bounded IVF search budget."""
    metric = MetricType.coerce(metric)
    device = _check_device(device)
    x = np.ascontiguousarray(x, np.float32)
    centroids = np.array(centroids, np.float32, copy=True)
    k, d = centroids.shape
    n = x.shape[0]
    if n < 4 * k:  # too few points to measure skew: leave as trained
        return centroids
    xd, vd, chunk = _padded(x, device)
    cap = max(int(np.ceil(cap_ratio * n / k)), 2)

    def split_pass(cents, a):
        # ``faiss_tpu.clustering.balance_centroids.split_pass``, as it is
        counts = np.bincount(a[a >= 0], minlength=k)[:k]
        over = np.nonzero(counts > cap)[0]
        if over.size == 0:
            return cents, counts, 0
        over = over[np.argsort(-counts[over])]
        order = np.argsort(a, kind="stable")       # members grouped by list
        starts = np.searchsorted(a[order], np.arange(k))
        ends = np.searchsorted(a[order], np.arange(k), side="right")
        victims = [v for v in np.argsort(counts) if counts[v] <= cap // 2]
        nsplit = min(over.size, len(victims))
        for i in range(nsplit):
            cl, v = int(over[i]), int(victims[i])
            m = x[order[starts[cl]:ends[cl]]]
            mu = m.mean(axis=0)
            dev = m - mu
            far = dev[int(np.argmax((dev * dev).sum(1)))]
            proj = dev @ far
            med = np.median(proj)
            lo, hi = m[proj <= med], m[proj > med]
            if not len(lo) or not len(hi):          # degenerate: all ties
                continue
            c1, c2 = lo.mean(axis=0), hi.mean(axis=0)
            if spherical:
                c1 = c1 / max(np.linalg.norm(c1), 1e-30)
                c2 = c2 / max(np.linalg.norm(c2), 1e-30)
            cents[cl], cents[v] = c1, c2
        return cents, counts, nsplit

    for r in range(rounds):
        cd = torch.from_numpy(centroids).to(device)
        a = _assign_only(xd, vd, cd, chunk=chunk, metric=metric)
        centroids, counts, nsplit = split_pass(centroids,
                                               a[:n].cpu().numpy())
        if verbose:
            print(f"balance round {r}: max {counts.max()} cap {cap} "
                  f"splits {nsplit}")
        if nsplit == 0:
            return centroids
        if r < rounds - 1:                          # last split stays raw
            cd, _ = _lloyd_train(
                xd, vd, torch.from_numpy(centroids).to(device),
                niter=lloyd_iters, chunk=chunk, metric=metric,
                spherical=spherical)
            centroids = cd.cpu().numpy().copy()
    return centroids


class Kmeans:
    """faiss.Kmeans over the port's index machinery.

    After ``train(x)``: ``centroids`` (k, d) fp32, ``obj`` (niter,) the
    per-iteration objective of the best redo (the sum of squared distances
    for L2, the negated summed similarity for IP: faiss's "to minimize"),
    and ``index``, a TorchIndexFlat over the centroids on the same device
    and ``resources``, so ``assign`` runs the index's search. ``device``
    defaults to "cuda" (the default device of ``resources`` where given)
    and raises without a card; "cpu" runs the same code on the CPU."""

    def __init__(self, d: int, k: int, *, niter: int = 25, nredo: int = 1,
                 seed: int = 1234, spherical: bool = False,
                 metric=MetricType.L2,
                 min_points_per_centroid: int = 39,
                 max_points_per_centroid: int = 256,
                 verbose: bool = False, device=None,
                 resources: Optional[TorchResources] = None):
        if k <= 0 or d <= 0 or niter <= 0 or nredo <= 0:
            raise ValueError(f"bad Kmeans config: {d=} {k=} {niter=} {nredo=}")
        self.d, self.k = int(d), int(k)
        self.niter, self.nredo = int(niter), int(nredo)
        self.seed, self.spherical = int(seed), bool(spherical)
        self.metric = MetricType.coerce(metric)
        self.min_points_per_centroid = int(min_points_per_centroid)
        self.max_points_per_centroid = int(max_points_per_centroid)
        self.verbose = bool(verbose)
        self.device, self.resources = bind_device(device, resources)
        self.centroids: Optional[np.ndarray] = None
        self.obj: Optional[np.ndarray] = None
        self.index = None

    def train(self, x: np.ndarray) -> float:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) training data, "
                             f"got {x.shape}")
        n = x.shape[0]
        if n < self.k:
            raise ValueError(f"need at least k={self.k} training points, "
                             f"got {n}")
        rng = np.random.default_rng(self.seed)
        if n < self.k * self.min_points_per_centroid:
            warnings.warn(
                f"kmeans: {n} training points for k={self.k} is below "
                f"faiss's recommended {self.min_points_per_centroid}/centroid")
        cap = self.k * self.max_points_per_centroid
        if n > cap:  # faiss Clustering.cpp subsample_training_set
            x = x[rng.choice(n, cap, replace=False)]
            n = cap
        if self.spherical:
            nrm = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(nrm, 1e-30)
        xd, vd, chunk = _padded(x, self.device)

        best = None
        for redo in range(self.nredo):
            sel = rng.choice(n, self.k, replace=False)
            init = torch.from_numpy(np.ascontiguousarray(x[sel], np.float32))
            cents, obj = _lloyd_train(
                xd, vd, init.to(self.device), niter=self.niter, chunk=chunk,
                metric=self.metric, spherical=self.spherical)
            final = float(obj[-1])
            if self.verbose:
                print(f"kmeans redo {redo}: obj {obj[0]:.6g} -> {final:.6g}")
            if best is None or final < best[0]:
                best = (final, cents, obj)
        final, cents, self.obj = best
        self.centroids = np.ascontiguousarray(cents.cpu().numpy())
        from .index import TorchIndexFlat

        self.index = TorchIndexFlat(self.d, metric=self.metric,
                                    device=self.device,
                                    resources=self.resources)
        self.index.add(self.centroids)
        return final

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        if self.index is None:
            raise RuntimeError("Kmeans.train has not run")
        return self.index.assign(x, k)


def kmeans_clustering(x: np.ndarray, k: int,
                      **kw) -> Tuple[np.ndarray, float]:
    """faiss.kmeans_clustering: (centroids (k, d), final objective)."""
    x = np.asarray(x, np.float32)
    km = Kmeans(x.shape[1], k, **kw)
    obj = km.train(x)
    return km.centroids, obj


def knn(xq: np.ndarray, xb: np.ndarray, k: int, metric=MetricType.L2,
        storage="f32", device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """faiss.knn: one exact top-k search without keeping an index (the
    index's own search path, fused kernels and certificate included)."""
    from .index import index_numpy_to_torch

    idx = index_numpy_to_torch(np.asarray(xb, np.float32), metric=metric,
                               storage=storage, device=device)
    try:
        return idx.search(np.asarray(xq, np.float32), k)
    finally:
        idx.reset()


def pairwise_distances(xq: np.ndarray, xb: np.ndarray, metric=MetricType.L2,
                       device="cuda") -> np.ndarray:
    """faiss.pairwise_distances: the dense (nq, nv) fp32 distances (squared
    L2, or inner products) in the index's plain arithmetic."""
    metric = MetricType.coerce(metric)
    device = _check_device(device)
    q = torch.from_numpy(np.ascontiguousarray(xq, np.float32)).to(device)
    b = torch.from_numpy(np.ascontiguousarray(xb, np.float32)).to(device)
    s = dist_ops.matmul_scores(q, b, torch.sum(b * b, dim=-1), metric)
    return dist_ops.scores_to_distances(s, metric).cpu().numpy()
