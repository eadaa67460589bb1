"""Port parity: BFS labels, preds and iteration count of
``mini_tpu_torch`` against ``mini_tpu``'s ``bfs`` and the NumPy oracle
``bfs_cpu``, bitwise, from several sources (an isolated vertex among
them)."""

import numpy as np
import pytest

import mini_tpu.graph as jg
from mini_tpu.algorithms import bfs as jbfs
import mini_tpu_torch.graph as tg
from mini_tpu_torch.algorithms import bfs, bfs_cpu, validate_preds

from test_torch_graph import TINY_EDGES, build


def build_case(pkg, name):
    if name == "tiny_isolated":  # vertices 7 and 8 have no edges
        s, d = zip(*TINY_EDGES)
        return pkg.from_edges(np.array(s), np.array(d), num_nodes=9,
                              make_undirected=True)
    if name == "rmat10":
        return pkg.rmat(10, seed=1, weighted=True)
    return build(pkg, name)


@pytest.mark.parametrize(
    "name", ["tiny_isolated", "random", "random_directed", "rmat10"]
)
def test_bfs_matches(name):
    hj, ht = build_case(jg, name), build_case(tg, name)
    gj = jg.GraphSlice.from_host(hj)
    gt = tg.GraphSlice.from_host(ht, device="cpu")
    deg = ht.out_degrees + ht.in_degrees
    isolated = np.nonzero(deg == 0)[0]
    assert len(isolated) > 0 or name.startswith("random")
    srcs = [0, int(np.argmax(ht.out_degrees)), ht.n - 1]
    srcs += [int(v) for v in isolated[:1]]
    for src in srcs:
        want = jbfs(gj, src)
        got = bfs(gt, src)
        labels, preds = got.labels.numpy(), got.preds.numpy()
        np.testing.assert_array_equal(labels, np.asarray(want.labels))
        np.testing.assert_array_equal(preds, np.asarray(want.preds))
        assert got.num_iterations == int(want.num_iterations)
        np.testing.assert_array_equal(labels[: ht.n], bfs_cpu(ht, src))
        assert validate_preds(labels, preds, ht, src)
        assert not got.sparse_overflowed
        if deg[src] == 0:  # only the source is reached
            assert got.num_iterations == 1
            assert (labels[: ht.n] >= 0).sum() == 1


def test_bfs_max_iter_and_result_fields():
    ht = build_case(tg, "random")
    gt = tg.GraphSlice.from_host(ht, device="cpu")
    full = bfs(gt, 0)
    assert full.num_iterations > 2
    cut = bfs(gt, 0, max_iter=2)
    assert cut.num_iterations == 2
    # depths up to 2 are final, deeper vertices are not reached yet
    lab = full.labels.numpy()
    np.testing.assert_array_equal(cut.labels.numpy(),
                                  np.where(lab <= 2, lab, -1))
    assert (full.num_pull_iterations, full.num_sparse_iterations,
            full.num_chained_iterations) == (0, 0, 0)
