import pytest

from benchmark import devtrace


def _trace():
    # window 0–100 µs; kernels overlap at 10–30 and 20–40; a copy 60–70
    return devtrace.Trace(
        0.0, 100.0,
        device=[("void k_a<1>(float*)", 10.0, 30.0), ("k_b", 20.0, 40.0),
                ("Memcpy DtoH", 60.0, 70.0)],
        host=[("enqueue", 0.0, 8.0), ("wait", 8.0, 75.0),
              ("enqueue", 80.0, 100.0)])


def test_bench_busy_is_the_union():
    assert devtrace.union([(3, 5), (1, 2), (4, 8), (8, 9)]) == [(1, 2), (3, 9)]
    assert devtrace.busy_s(_trace()) == pytest.approx(40e-6)


def test_bench_gaps_named_by_host_span():
    g = devtrace.gaps(_trace())
    assert [lab for lab, _ in g] == ["enqueue", "wait", "enqueue"]
    assert [s for _, s in g] == pytest.approx([10e-6, 20e-6, 30e-6])
    assert devtrace.longest_gaps(_trace(), 2) == [
        ["enqueue", pytest.approx(30e-6)], ["wait", pytest.approx(20e-6)]]
    assert devtrace.busy_s(_trace()) + sum(s for _, s in g) == \
        pytest.approx(_trace().window_s)


def test_bench_top_ops_short_names():
    ops = devtrace.top_ops(_trace())
    assert ops[0][0] == "k_a<1>" and ops[0][1] == pytest.approx(20e-6)
    assert {n for n, _ in ops} == {"k_a<1>", "k_b", "Memcpy DtoH"}
