import numpy as np
import pytest
import torch

from benchmark import datagen

DATA = dict(generator="normalised_mixture", rows=5000, d=96, queries=50,
            chunk_rows=2048, centres=16, centre_scale=1.0, noise_scale=0.6,
            normalise=True)
BIG_SEED = 2 ** 31 + 987654321


def _all(seed):
    src = datagen.Source(DATA, seed, "cpu")
    rows = torch.cat([r for _, r in src.chunks()])
    return rows, src.queries()


def test_bench_generator_repeats_for_a_seed():
    r1, q1 = _all(BIG_SEED)
    r2, q2 = _all(BIG_SEED)
    assert torch.equal(r1, r2) and torch.equal(q1, q2)
    assert r1.shape == (DATA["rows"], DATA["d"]) and r1.dtype == torch.float32
    assert torch.allclose(torch.linalg.vector_norm(r1, dim=1),
                          torch.ones(DATA["rows"]), atol=1e-5)


def test_bench_generator_differs_across_seeds():
    r1, q1 = _all(7)
    r2, q2 = _all(8)
    assert not torch.equal(r1, r2) and not torch.equal(q1, q2)


def test_bench_chunk_made_alone_equals_chunk_in_sequence():
    src = datagen.Source(DATA, 3, "cpu")
    last = src.n_chunks - 1
    start, alone = datagen.Source(DATA, 3, "cpu").chunk(last)
    assert start == last * DATA["chunk_rows"]
    assert alone.shape[0] == DATA["rows"] - start
    rows, _ = _all(3)
    assert torch.equal(rows[start:], alone)


def test_bench_selector_sets_same_sizes_every_seed():
    sel = {"kind": "batch", "share": 0.1, "sets": 4}
    a = datagen.selector_sets(5000, sel, BIG_SEED, "cpu")
    b = datagen.selector_sets(5000, sel, BIG_SEED, "cpu")
    c = datagen.selector_sets(5000, sel, 11, "cpu")
    assert [len(s) for s in a] == [500] * 4 == [len(s) for s in c]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert all(len(np.unique(s)) == len(s) and s.min() >= 0 and s.max() < 5000
               for s in a)


def test_bench_generator_found_by_name():
    assert callable(datagen.load_generator("normalised_mixture").draw)
    with pytest.raises(SystemExit, match="no data generator"):
        datagen.Source(dict(DATA, generator="no_such_generator"), 1, "cpu")
