"""The byte and operation counters against values worked by hand."""

import pytest

from benchmark.harness import peaks, registry
from benchmark.tasks import gcn_train


def test_segment_reduce_launch_bytes():
    r = registry.metric_reader("segment_reduce_roofline")
    # kron20: n = 2**20, m = 2 * 16 * 2**20 = 33,554,432 4-byte values
    assert r.launch_bytes(2**20, 33554432) == 134217728 + 4194308 + 4194304


def test_banded_segment_sum_step_bytes():
    r = registry.metric_reader("banded_segment_sum_roofline")
    # one layer 4 -> 2 over m = 10 edges, n = 3: per aggregation 10 * 2 * 4
    # message bytes + 10 * 4 weight bytes + 3 * 2 * 4 output bytes = 144,
    # forward and backward
    assert r.step_bytes(3, 10, [4, 2]) == 288.0
    # arxiv: n = 169,343, m = 2,332,486, widths 256, 256, 40
    n, m = 169343, 2332486
    want = 2 * sum(4 * m * f + 4 * m + 4 * n * f for f in (256, 256, 40))
    assert r.step_bytes(n, m, [128, 256, 256, 40]) == want


def test_gcn_step_flops():
    # 2 layers 3 -> 4 -> 2, n = 5, m = 7: layer 1 forward and weight
    # gradient 2 * 2*5*3*4 = 240, aggregations 2 * 2*7*4 = 112; layer 2
    # forward, weight and input gradients 3 * 2*5*4*2 = 240, aggregations
    # 2 * 2*7*2 = 56
    assert gcn_train.step_flops(5, 7, [3, 4, 2]) == 240 + 112 + 240 + 56
    # arxiv: 104.34 GFLOP a step, 99.19 of them in the matmuls
    n, m = 169343, 2332486
    want = (4 * n * 128 * 256 + 6 * n * 256 * 256 + 6 * n * 256 * 40
            + 4 * m * (256 + 256 + 40))
    assert gcn_train.step_flops(n, m, [128, 256, 256, 40]) == want
    assert want == 104339065792


def test_roofline_share():
    # 3.35 GB in 2 ms is half the HBM rate
    assert peaks.roofline_share(3.35e9, 0.0, 2e-3) == pytest.approx(50.0)
    # 67 GFLOP in 10 ms is a tenth of the float32 rate
    assert peaks.roofline_share(0.0, 67e9, 10e-3) == pytest.approx(10.0)
    assert peaks.roofline_share(1.0, 1.0, 0.0) is None


def test_pagerank_query_work():
    import torch

    from benchmark.tasks import pagerank

    cell = registry.load_cell("kron20-pagerank")
    inputs = {"n": 10, "src": torch.zeros(20, dtype=torch.int64)}
    # m = 40 directed edges, n = 10: a round 8 * 40 + 12 * 10 = 440 bytes
    # and 80 operations; two queries of 3 and 2 rounds
    assert pagerank.work(inputs, cell, [(None, 3), (None, 2)]) == (
        5 * 440.0, 5 * 80.0)


def test_bfs_query_work():
    import torch

    from benchmark.tasks import bfs

    cell = registry.load_cell("kron20-bfs")
    # a path 0 - 1 - 2 and an edge 3 - 4, both directions: the component
    # of 0 holds 4 directed edges, that of 3 holds 2; n = 5
    inputs = {"n": 5, "src": torch.tensor([0, 1, 3]),
              "dst": torch.tensor([1, 2, 4])}
    nbytes, ops = bfs.work(inputs, cell, [(0, 3), (3, 2), (0, 3)])
    assert (nbytes, ops) == (2 * (4 * 4 + 12 * 5) + (4 * 2 + 12 * 5), 0.0)
