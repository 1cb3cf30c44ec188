from benchmark import roofline


def test_bench_shapes_of_the_cells():
    s = roofline.search_shapes(100, 1_000_000, 96, 10)
    assert s == dict(nq_pad=104, nv_eff=1_000_448, d_pad=96, ngroups=7816,
                     hier=False)
    s = roofline.search_shapes(1, 9_990_000, 96, 10)
    assert s == dict(nq_pad=8, nv_eff=9_990_144, d_pad=96, ngroups=78_048,
                     hier=True)


def test_bench_sweep_bytes_and_operations():
    s = roofline.search_shapes(100, 1_000_000, 96, 10)
    nbytes = roofline.sweep_bytes(s, q_planes=2, db_planes=2)
    assert nbytes == (2 * 104 * 96 * 2 + 2 * 1_000_448 * 96 * 2
                      + 1_000_448 * 4 + 104 * 7816 * 4)
    t, by = roofline.sweep_bound_s(s, q_planes=2, db_planes=2, terms=3,
                                   kind="bf16")
    assert by == "bytes" and t == nbytes / 3.35e12
    ops = 2.0 * 3 * 104 * 1_000_448 * 96
    assert ops / 989e12 < t
    # the hierarchical search also writes the supergroup maxes
    h = roofline.search_shapes(100, 9_990_000, 96, 10)
    assert roofline.sweep_bytes(h, q_planes=2, db_planes=2) == (
        2 * 104 * 96 * 2 + 2 * 9_990_144 * 96 * 2 + 9_990_144 * 4
        + 104 * 78_048 * 4 + 104 * 9756 * 4)


def test_bench_bound_by_operations():
    t, by = roofline.bound_s(1.0, 989e12, "bf16")
    assert (t, by) == (1.0, "operations")
