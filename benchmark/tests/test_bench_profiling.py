"""The device-trace arithmetic: union of intervals, idle gaps, names."""

from kbench import profiling


def test_union_counts_overlaps_once():
    assert profiling.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert profiling.union_length([(5, 6), (0, 10)]) == 10
    assert profiling.union_length([]) == 0


def test_idle_gaps_cover_the_rest_of_the_window():
    gaps = profiling.idle_gaps([(2, 4), (3, 5), (7, 8)], 0, 10)
    assert gaps == [(0, 2), (5, 7), (8, 10)]
    assert sum(e - s for s, e in gaps) + 4 == 10


def test_trace_busy_ops_and_gap_names():
    tr = profiling.Trace(window_s=10e-6)
    tr.device = [("propose_kernel<0,true>", 1.0, 3.0), ("gemm", 2.0, 4.0),
                 ("gemm", 6.0, 7.0)]
    tr.host = [("kbench.window", 0.0, 10.0), ("kbench.commit", 4.0, 6.0),
               ("aten::copy_", 4.5, 5.5), ("kbench.prepare", 7.0, 10.0)]
    assert abs(tr.busy_s - 4e-6) < 1e-15
    assert abs(tr.kernel_s("propose_kernel") - 2e-6) < 1e-15
    assert tr.top_ops()[0][0] == "gemm"
    names = dict((n, s) for n, s in tr.gaps())
    assert names["kbench.prepare"] == 3e-6
    assert names["kbench.commit / aten::copy_"] == 2e-6
    assert names["kbench.window"] == 1e-6
