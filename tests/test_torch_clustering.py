"""faiss_tpu_torch's k-means, balancing and functional knn against
faiss_tpu's, on the CPU.

The same numpy inputs go through ``faiss_tpu.clustering`` and
``faiss_tpu_torch.clustering``. Both draw the subsample and the initial
centroids from one ``np.random.default_rng(seed)`` in the same order, so
they start from the same points; what differs is the order of the fp32
sums (XLA's and PyTorch's GEMMs), so on separated data the assignments
are identical and the centroids and objectives agree to fp32 rounding.

Tolerances (``tests/common.py``'s ladder, f32-L2 rung 1e-3, tightened
where both sides are fp32 sums of the same terms): centroids at rtol 1e-5
(atol 1e-5 on coordinates near 0); objectives at rtol 1e-5 plus the
expanded form's rounding (``obj_atol``: on tight blobs each point's
2·x·c − ‖x‖² − ‖c‖² cancels to a small distance, and both sides err by up
to (d+2)·u·(‖x‖ + ‖c‖)² in it);
assignments, re-seeded points and balanced occupancies equal; on
integer-valued data every sum is exact, so centroids and objectives equal
bit for bit; knn ids equal and distances at rtol 1e-5; pairwise distances
at the ladder's f32 rung, rtol 1e-5 against the JAX function.
"""

import numpy as np
import pytest
import torch

from faiss_tpu import clustering as jcl
from faiss_tpu_torch import MetricType, clustering as tcl

from test_clustering import blobs

torch.set_num_threads(2)

CENT_RTOL, CENT_ATOL = 1e-5, 1e-5
U32 = 2.0 ** -24


def obj_atol(x, cents):
    """Bound on |obj − obj'| for two fp32 evaluations of the expanded-form
    objective: each point's score errs ≤ (d+2)·u·(‖x‖ + C)², C = max‖c‖,
    on each side, and each side's sum of n terms ≤ n·u·Σ|score|."""
    n, d = x.shape
    xn = np.linalg.norm(x.astype(np.float64), axis=1)
    c = np.linalg.norm(cents.astype(np.float64), axis=1).max()
    per = (d + 2) * U32 * (xn + c) ** 2
    return 2.0 * (per.sum() + n * U32 * ((xn + c) ** 2).sum())


def assert_obj_close(tk, jk, x):
    np.testing.assert_allclose(tk.obj, jk.obj, rtol=1e-5,
                               atol=obj_atol(x, jk.centroids))


def _both(x, d, k, **kw):
    """The same Kmeans in both packages, trained on x."""
    jk = jcl.Kmeans(d, k, **kw)
    tk = tcl.Kmeans(d, k, device="cpu", **kw)
    jo, to = jk.train(x), tk.train(x)
    return jk, tk, jo, to


def test_kmeans_matches_jax_on_blobs():
    """Separated blobs, seed 527 (one initial point per blob): identical
    assignments, centroids and objective series at rtol 1e-5, and both
    match the float64 Lloyd from the same initial indices."""
    from test_clustering import numpy_lloyd

    x, labels, _ = blobs(200, 8, 32, seed=3)
    jk, tk, jo, to = _both(x, 32, 8, niter=10, seed=527)
    np.testing.assert_array_equal(tk.assign(x), jk.assign(x))
    np.testing.assert_allclose(tk.centroids, jk.centroids, rtol=CENT_RTOL,
                               atol=CENT_ATOL)
    assert_obj_close(tk, jk, x)
    sel = np.random.default_rng(527).choice(len(x), 8, replace=False)
    ref, _ = numpy_lloyd(x, x[sel], 10)
    np.testing.assert_allclose(tk.centroids, ref.astype(np.float32),
                               rtol=1e-4, atol=1e-4)
    assert isinstance(tk.index, __import__("faiss_tpu_torch").TorchIndexFlat)
    assert tk.index.device.type == "cpu"


@pytest.mark.parametrize("case", ["nredo", "spherical", "subsample"])
def test_kmeans_options_match_jax(case):
    """nredo picks the same best redo; spherical centroids (IP) stay unit
    and match; subsampling draws the same rows first."""
    if case == "nredo":
        x, _, _ = blobs(50, 6, 8, seed=2)
        kw = dict(niter=8, nredo=3, seed=11)
        d, k = 8, 6
    elif case == "spherical":
        x, _, _ = blobs(80, 5, 24, seed=4)
        kw = dict(niter=5, spherical=True, metric="ip", seed=3)
        d, k = 24, 5
    else:
        x, _, _ = blobs(400, 2, 8, seed=6)
        kw = dict(niter=3, max_points_per_centroid=50, seed=1)
        d, k = 8, 2
    jk, tk, jo, to = _both(x, d, k, **kw)
    np.testing.assert_allclose(tk.centroids, jk.centroids, rtol=CENT_RTOL,
                               atol=CENT_ATOL)
    assert_obj_close(tk, jk, x)
    np.testing.assert_array_equal(tk.assign(x), jk.assign(x))
    if case == "spherical":
        np.testing.assert_allclose(np.linalg.norm(tk.centroids, axis=1), 1.0,
                                   rtol=1e-5)


def test_forced_empty_reseed_matches_jax_bit_for_bit():
    """k near n with 5 distinct integer points repeated: empty clusters are
    re-seeded every iteration on the worst-served points, ties to the
    lowest row. Integer data makes every score and sum exact, so both
    packages re-seed the same points and end on the same centroids and
    objectives, bit for bit."""
    rng = np.random.default_rng(9)
    base = rng.integers(-6, 7, (5, 8)).astype(np.float32)
    x = np.concatenate([base] * 10)
    jk, tk, jo, to = _both(x, 8, 16, niter=8, seed=2,
                           min_points_per_centroid=1)
    np.testing.assert_array_equal(tk.centroids, jk.centroids)
    np.testing.assert_array_equal(tk.obj, jk.obj)
    assert np.isfinite(tk.centroids).all()
    # the first iteration's reseed, step by step: one Lloyd iteration from
    # the same initial points in both packages
    init = x[np.random.default_rng(2).choice(len(x), 16, replace=False)]
    xp, vd, chunk = tcl._padded(x, "cpu")
    new, obj = tcl._lloyd_iter(torch.from_numpy(init), xp, vd, chunk,
                               MetricType.L2, False)
    fn = jcl._lloyd_train_fn(n_pad=xp.shape[0], k_pad=16, d_pad=128, niter=1,
                             chunk=chunk, k=16, metric=jcl.MetricType.L2,
                             spherical=False)
    xj = np.zeros((xp.shape[0], 128), np.float32)
    xj[:, :8] = xp.numpy()
    ij = np.zeros((16, 128), np.float32)
    ij[:, :8] = init
    cj, oj = fn(xj, vd.numpy(), ij)
    np.testing.assert_array_equal(new.numpy(), np.asarray(cj)[:, :8])
    assert float(obj) == float(np.asarray(oj)[0])


def test_balance_centroids_matches_jax():
    """The same trained centroids into both balance_centroids: the same
    occupancies after balancing (each package's E-step) with the cap held
    (2.5 × the mean: the cap 2.0 plus the polish's drift), centroids at
    rtol 1e-5 (the split pass is numpy in both; the polish is fp32)."""
    rng = np.random.default_rng(1)
    ncomp, d, k, n = 64, 16, 16, 8000
    comps = (6.0 * rng.standard_normal((ncomp, d))).astype(np.float32)
    w = rng.dirichlet(np.full(ncomp, 0.2))
    x = (comps[rng.choice(ncomp, n, p=w)]
         + rng.standard_normal((n, d))).astype(np.float32)
    km = jcl.Kmeans(d, k, niter=8, seed=7)
    km.train(x)
    jb = jcl.balance_centroids(x, km.centroids, cap_ratio=2.0)
    tb = tcl.balance_centroids(x, km.centroids, cap_ratio=2.0, device="cpu")
    assert tb.dtype == np.float32 and tb.shape == (k, d)
    np.testing.assert_allclose(tb, jb, rtol=CENT_RTOL, atol=CENT_ATOL)
    xp, vd, chunk = tcl._padded(x, "cpu")
    a = tcl._assign_only(xp, vd, torch.from_numpy(tb), chunk=chunk,
                         metric=MetricType.L2)[:n].numpy()
    counts = np.bincount(a, minlength=k)
    d2 = ((x[:, None, :].astype(np.float64) - jb[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(counts,
                                  np.bincount(d2.argmin(1), minlength=k))
    c0 = np.bincount(km.assign(x).ravel(), minlength=k)
    assert counts.max() < c0.max() and counts.max() <= 2.5 * n / k
    # a balanced set comes back unchanged
    np.testing.assert_array_equal(
        tcl.balance_centroids(x, tb, cap_ratio=1e9, device="cpu"), tb)


def test_kmeans_clustering_knn_pairwise_match_jax():
    x, _, _ = blobs(60, 3, 8, seed=8)
    cj, oj = jcl.kmeans_clustering(x, 3, niter=5, seed=4)
    ct, ot = tcl.kmeans_clustering(x, 3, niter=5, seed=4, device="cpu")
    np.testing.assert_allclose(ct, cj, rtol=CENT_RTOL, atol=CENT_ATOL)
    assert abs(ot - oj) <= 1e-5 * abs(oj) + obj_atol(x, cj)
    rng = np.random.default_rng(12)
    xb = rng.standard_normal((3000, 24)).astype(np.float32)
    xq = rng.standard_normal((6, 24)).astype(np.float32)
    for metric in ("l2", "ip"):
        Dj, Ij = jcl.knn(xq, xb, 5, metric=metric)
        Dt, It = tcl.knn(xq, xb, 5, metric=metric, device="cpu")
        np.testing.assert_array_equal(It, Ij)
        np.testing.assert_allclose(Dt, Dj, rtol=1e-5)
    xq = rng.standard_normal((7, 33)).astype(np.float32)   # d not aligned
    xb = rng.standard_normal((11, 33)).astype(np.float32)
    for metric in ("l2", "ip"):
        np.testing.assert_allclose(
            tcl.pairwise_distances(xq, xb, metric, device="cpu"),
            jcl.pairwise_distances(xq, xb, metric), rtol=1e-5, atol=1e-5)


def test_kmeans_validation():
    x, _, _ = blobs(400, 2, 8, seed=6)
    with pytest.raises(ValueError):
        tcl.Kmeans(8, 0, device="cpu")
    with pytest.raises(ValueError):
        tcl.Kmeans(8, 4, device="cpu").train(np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError):
        tcl.Kmeans(8, 2, device="cpu").train(np.zeros((10, 9), np.float32))
    with pytest.raises(RuntimeError):
        tcl.Kmeans(8, 2, device="cpu").assign(x)
    with pytest.warns(UserWarning):
        tcl.Kmeans(8, 4, niter=1, device="cpu").train(
            np.random.default_rng(0).standard_normal((8, 8)).astype(
                np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcl.Kmeans(8, 2)                   # the default device is cuda
