import numpy as np
import pytest
import torch

from benchmark import datagen, harness, reference

DATA = dict(generator="normalised_mixture", rows=6000, d=96, queries=40,
            chunk_rows=2500, centres=16, centre_scale=1.0, noise_scale=0.6,
            normalise=True)


def _setup(seed=5):
    src = datagen.Source(DATA, seed, "cpu")
    rows = torch.cat([r for _, r in src.chunks()])
    return src.queries(), src.chunks, rows.numpy().astype(np.float64)


def _brute(q, rows, k, l2, admit=None):
    q = q.astype(np.float64)
    c = (((q[:, None, :] - rows[None, :, :]) ** 2).sum(-1) if l2
         else -(q @ rows.T))
    if admit is not None:
        c[:, ~admit] = np.inf
    order = np.argsort(c, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(c, order, 1)


@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("filtered", [False, True])
def test_bench_reference_topk_equals_brute_force(l2, filtered):
    pool, chunks, rows = _setup()
    admit = None
    if filtered:
        ids = datagen.selector_sets(DATA["rows"], dict(share=0.1, sets=1),
                                    9, "cpu")[0]
        admit = np.zeros(DATA["rows"], bool)
        admit[ids] = True
    res = reference.knn_pass(chunks(), pool, 10, l2, n_rows=DATA["rows"],
                             admit=None if admit is None
                             else torch.from_numpy(admit))
    ids_np, cost_np = _brute(pool.numpy(), rows, 10, l2, admit)
    assert np.array_equal(res.ref_ids.numpy(), ids_np)
    np.testing.assert_allclose(res.ref_cost.numpy(), cost_np, rtol=0,
                               atol=1e-12)
    if admit is not None:
        assert admit[res.ref_ids.numpy()].all()


def _judge(dists, ids, l2=True, admits=(), set_idx=None):
    pool, chunks, _ = _setup()
    n = len(ids)
    set_idx = np.full(n, -1) if set_idx is None else set_idx
    ans = reference.Answers.unique(np.arange(n), set_idx, dists, ids)
    return reference.judge(ans, pool, chunks, 10, l2, DATA["rows"],
                           list(admits))


def _exact(l2=True):
    pool, chunks, rows = _setup()
    ids, cost = _brute(pool.numpy(), rows, 10, l2)
    return (cost if l2 else -cost).astype(np.float32), ids


def test_bench_judge_passes_exact_answers_and_counts_bad_ones():
    d, i = _exact()
    out = _judge(d, i)
    assert out["bad_ids"] == 0 and out["rank_gap"] < 1e-12
    assert out["dist_err"] < 1e-7 and out["answers"] == len(i)
    bad = i.copy()
    bad[0, 1] = bad[0, 0]            # an id twice
    bad[1, 0] = -1                   # a sentinel
    bad[2, 0] = DATA["rows"]         # past the end
    assert _judge(d, bad)["bad_ids"] == 3
    swapped = i.copy()
    swapped[3, 9] = np.setdiff1d(np.arange(DATA["rows"]), i[3])[0]
    out = _judge(d, swapped)
    assert out["bad_ids"] == 0 and out["dist_err"] > 1e-3


def test_bench_judge_nan_distance_is_not_finite():
    d, i = _exact()
    d[0, 0] = np.nan
    assert _judge(d, i)["dist_err"] == float("inf")


def test_bench_judge_counts_ids_outside_the_selector():
    d, i = _exact()
    admit = torch.ones(DATA["rows"], dtype=torch.bool)
    admit[int(i[0, 0])] = False
    out = _judge(d, i, admits=[admit], set_idx=np.zeros(len(i), np.int64))
    assert out["bad_ids"] == 1


@pytest.mark.parametrize("config", ["deep1m-l2", "deep10m-ip"])
@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_bench_control_fails_the_limits(config, precision):
    """The control (the reference in the program's place, in the precision
    below float32), judged by the harness's own comparison, comes out not
    correct; the exact reference in its place comes out correct."""
    spec = harness.cell_spec(config.replace("-ip", "-ip.batch")
                             .replace("-l2", "-l2.single"))
    cfg = dict(spec["config"], data=dict(spec["config"]["data"], **DATA))
    l2 = cfg["index"]["metric"] == "L2"
    src = datagen.Source(cfg["data"], 21, "cpu")
    pool = src.queries()
    n = len(pool)
    pidx, sidx = np.arange(n), np.full(n, -1)
    for prec, fails in ((precision, True), ("fp64", False)):
        d, i = reference.control_answers(pool, pidx, sidx, src.chunks, 10,
                                         l2, DATA["rows"], [], prec)
        nums = harness.judge(pidx, sidx, d, i, pool, src, [], cfg,
                             spec["traffic"])
        checks, correct = harness.verdict(nums, 0, cfg["limits"])
        assert correct is not fails, (prec, checks)


def test_bench_round_mantissa():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12],
                     dtype=torch.float32)
    y = reference._round_mantissa(x, 10)
    # ties to even at TF32's 10 bits, below half rounds down
    assert y.tolist() == [1.0, 1.0 + 2 * 2 ** -10, 1.0]
