"""Port parity: ``bfs_batch``, PageRank and connected components of
``mini_tpu_torch`` against ``mini_tpu``'s on the same graphs.
``bfs_batch`` (every field: its round counters equal too) and CC bitwise
(and CC against the union-find oracle ``cc_cpu``); PageRank within
``tests/test_algorithms.py``'s tolerance (rtol 1e-4, atol 1e-6) of JAX's
ranks and of the float64 oracle ``pagerank_cpu``: the segment-reduce
kernel sums in another order than ``jax.ops.segment_sum``, so the ranks are
not bitwise, and a vertex whose move sits on the ``tol_rel`` edge can end
the iteration one round apart."""

import functools

import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.algorithms import (
    bfs_batch as jbfs_batch,
    connected_components as jcc,
    pagerank as jpagerank,
)
import mini_tpu_torch.graph as tg
from mini_tpu_torch.algorithms import (
    bfs,
    bfs_batch,
    cc_cpu,
    connected_components,
    pagerank,
    pagerank_cpu,
)
from mini_tpu_torch.algorithms.bfs import COUNTERS as BFS_COUNTERS

from test_torch_graph import build
from test_torch_sssp import count_reads

PR_TOL = dict(rtol=1e-4, atol=1e-6)
BFS_FIELDS = ("labels", "preds", "sparse_overflowed") + BFS_COUNTERS


def build_graph(pkg, name):
    if name == "grid24":
        return pkg.grid2d(24, 24, seed=5, weighted=True)
    if name == "blocks":  # tests/test_algorithms.py: 3 triangles, 2 isolated
        edges = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3),
                 (6, 7), (7, 8), (8, 6)]
        s, d = zip(*edges)
        return pkg.from_edges(np.array(s), np.array(d), num_nodes=11,
                              make_undirected=True)
    return build(pkg, name)


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(host graph, JAX GraphSlice, port GraphSlice) of one graph."""
    ht = build_graph(tg, name)
    return (ht, jg.GraphSlice.from_host(build_graph(jg, name)),
            tg.GraphSlice.from_host(ht, device="cpu"))


@pytest.mark.parametrize("with_preds", [True, False])
@pytest.mark.parametrize("name", ["random", "random_directed", "grid24",
                                  "blocks"])
def test_bfs_batch_matches(name, with_preds):
    ht, gj, gt = graphs(name)
    srcs = [0, 5, ht.n - 1]
    want = jbfs_batch(gj, np.array(srcs), with_preds=with_preds)
    got = bfs_batch(gt, srcs, with_preds=with_preds)
    assert got.labels.shape == (3, gt.n_pad)
    for f in BFS_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.sparse_overflowed.dtype == torch.bool
    assert not got.sparse_overflowed.any()
    for i, s in enumerate(srcs):  # each row is bfs's, bit for bit
        one = bfs(gt, s)
        assert torch.equal(got.labels[i], one.labels)
        for f in BFS_COUNTERS:
            assert int(getattr(got, f)[i]) == getattr(one, f), f
        if with_preds:
            assert torch.equal(got.preds[i], one.preds)
    if name == "grid24":  # the chained rounds ran
        assert int(got.num_chained_iterations.sum()) > 0
    if not with_preds:
        assert (got.preds == -1).all()


def test_bfs_batch_arguments():
    ht, _, gt = graphs("random")
    # JAX's positional order: srcs, alpha, max_iter, capv, cape, with_preds
    cut = bfs_batch(gt, torch.tensor([0, 17]), 0.5, 2, 16, 128, False, 0)
    assert cut.num_iterations.tolist() == [2, 2]
    assert (cut.preds == -1).all()
    one = bfs_batch(gt, 3)  # a scalar source is a batch of one
    assert one.labels.shape == (1, gt.n_pad)
    with pytest.raises(TypeError):
        bfs_batch(gt, [0], max_iter=2.0)


@pytest.mark.parametrize("variant", ["standard", "mini"])
@pytest.mark.parametrize("name", ["random", "random_directed", "grid24",
                                  "rmat8", "blocks"])
def test_pagerank_matches(name, variant):
    ht, gj, gt = graphs(name)
    want = jpagerank(gj, variant=variant, max_iter=30)
    got = pagerank(gt, variant=variant, max_iter=30)
    ranks = got.ranks.numpy()
    assert ranks.dtype == np.float32
    np.testing.assert_allclose(ranks, np.asarray(want.ranks), **PR_TOL)
    np.testing.assert_allclose(
        ranks[: ht.n], pagerank_cpu(ht, variant=variant, max_iter=30),
        **PR_TOL)
    assert (ranks[ht.n:] == 0).all()  # ghost vertices hold no rank
    # a vertex on the tol_rel edge may end the run one round apart
    assert abs(got.num_iterations - int(want.num_iterations)) <= 1


def test_pagerank_converges_and_sums_to_one():
    ht, _, gt = graphs("random")
    res = pagerank(gt, variant="standard", tol_rel=1e-7, max_iter=200)
    assert 0 < res.num_iterations < 200
    assert abs(float(res.ranks.sum()) - 1.0) < 1e-3
    with pytest.raises(ValueError):
        pagerank(gt, variant="personalized")


@pytest.mark.parametrize("name", ["random", "random_directed", "grid24",
                                  "rmat8", "blocks", "tiny"])
def test_cc_matches(name):
    ht, gj, gt = graphs(name)
    want = jcc(gj)
    got = connected_components(gt)
    np.testing.assert_array_equal(got.components.numpy(),
                                  np.asarray(want.components))
    assert got.components.dtype == torch.int32
    expected = cc_cpu(ht)
    np.testing.assert_array_equal(got.components.numpy()[: ht.n], expected)
    assert got.num_components == int(want.num_components) \
        == len(np.unique(expected))
    assert got.num_iterations == int(want.num_iterations)
    if name == "blocks":
        assert got.num_components == 5


def test_cc_max_iter():
    _, gj, gt = graphs("grid24")
    cut = connected_components(gt, max_iter=1)
    assert cut.num_iterations == 1
    want = jcc(gj, max_iter=1)
    np.testing.assert_array_equal(cut.components.numpy(),
                                  np.asarray(want.components))


def test_one_read_a_round(monkeypatch):
    """PageRank reads whether a vertex is still active once a round (and
    once more to find none left); CC whether a label changed, and its
    count once; ``bfs`` once a round and once more, whatever form its
    rounds take; ``bfs_batch`` reads its sources once and each BFS as
    ``bfs`` does."""
    ht, _, gt = graphs("grid24")
    r, reads = count_reads(monkeypatch, lambda: pagerank(gt))
    assert 1 < r.num_iterations < 100 and reads == r.num_iterations + 1
    r, reads = count_reads(monkeypatch, lambda: pagerank(gt, max_iter=5))
    assert r.num_iterations == 5 and reads == 5
    r, reads = count_reads(monkeypatch, lambda: connected_components(gt))
    assert reads == r.num_iterations + 1
    r, reads = count_reads(monkeypatch, lambda: bfs_batch(gt, [0, 300]))
    assert reads == 1 + int(r.num_iterations.sum()) + 2
    # a chained round reads the device as a bitmap round does, and a round
    # cap ends the search with one read of the overflow flag
    r, reads = count_reads(monkeypatch, lambda: bfs(gt, 0))
    assert r.num_chained_iterations > 20
    assert reads == r.num_iterations + 1
    r, reads = count_reads(monkeypatch, lambda: bfs(gt, 0, max_iter=30))
    assert r.num_iterations == 30 and reads == 31
