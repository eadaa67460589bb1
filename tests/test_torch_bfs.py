"""Port parity: every field of ``mini_tpu_torch``'s ``BfsResult`` against
``mini_tpu``'s ``bfs``: labels and preds bitwise, the four round counters
(rounds, pull, sparse, chained) equal, ``sparse_overflowed`` False; and
the labels against the NumPy oracle ``bfs_cpu``.  The families lie on
both sides of the chaining threshold (mean out-degree 5): an isolated
vertex among them, a 64 x 32 grid and ``tests/test_sparse.py``'s
2000-vertex path.  The schedules are JAX's defaults, all push, all pull,
dense rounds only, a tier too narrow for mid-size frontiers, chaining
off, a chain that overflows and falls back to a bitmap round, and round
caps inside a chained stretch.  Each JAX result is computed once per
file."""

import functools
import sys

import numpy as np
import pytest

import mini_tpu.graph as jg
from mini_tpu.algorithms import bfs as jbfs
import mini_tpu_torch.graph as tg
from mini_tpu_torch.algorithms import bfs, bfs_cpu, validate_preds
from mini_tpu_torch.algorithms.bfs import COUNTERS

from test_torch_graph import TINY_EDGES, build

# the modules, not the functions the packages' __init__ export by their name
jbfs_mod = sys.modules["mini_tpu.algorithms.bfs"]
tbfs_mod = sys.modules["mini_tpu_torch.algorithms.bfs"]

FAMILIES = ["tiny_isolated", "random", "random_directed", "rmat10", "grid",
            "path"]
SCHEDULES = {
    "default": {},  # test_bfs_matches
    "push": dict(alpha=0.0),
    "pull": dict(alpha=1e9),
    "dense": dict(sparse_cape=1),
    "narrow": dict(sparse_capv=4),  # mid-size frontiers miss the tier
    "unchained": dict(chain_cap=0),
    "tight_chain": dict(chain_cap=8),  # wider wavefronts overflow it
    "cut": dict(max_iter=2),  # round 1 is a chained one where chains run
}


def build_case(pkg, name):
    if name == "tiny_isolated":  # vertices 7 and 8 have no edges
        s, d = zip(*TINY_EDGES)
        return pkg.from_edges(np.array(s), np.array(d), num_nodes=9,
                              make_undirected=True)
    if name == "rmat10":
        return pkg.rmat(10, seed=1, weighted=True)
    if name == "grid":  # mean out-degree under 5: the chain is on
        return pkg.grid2d(64, 32, seed=1, weighted=True)
    if name == "path":  # tests/test_sparse.py's: diameter 1999
        n = 2000
        return pkg.from_edges(np.arange(n - 1), np.arange(1, n), num_nodes=n,
                              make_undirected=True)
    return build(pkg, name)


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(host graph, JAX GraphSlice, port GraphSlice) of one family."""
    ht = build_case(tg, name)
    return (ht, jg.GraphSlice.from_host(build_case(jg, name)),
            tg.GraphSlice.from_host(ht, device="cpu"))


def sources(name) -> list:
    """0, the top out-degree vertex, the last vertex and an isolated one
    (the path: its end, where every round's frontier is one vertex)."""
    ht = graphs(name)[0]
    if name == "path":
        return [0]
    isolated = np.nonzero(ht.out_degrees + ht.in_degrees == 0)[0]
    srcs = [0, int(np.argmax(ht.out_degrees)), ht.n - 1]
    return list(dict.fromkeys(srcs + [int(v) for v in isolated[:1]]))


@functools.lru_cache(maxsize=None)
def jax_result(name, src, kw):
    """``mini_tpu``'s result as numpy, once per file."""
    r = jbfs(graphs(name)[1], src, **dict(kw))
    return {f: np.asarray(getattr(r, f))
            for f in ("labels", "preds", "sparse_overflowed") + COUNTERS}


def check(name, src, **kw):
    """The port's ``bfs`` against JAX's, field by field, and the oracle."""
    ht, _, gt = graphs(name)
    want = jax_result(name, src, tuple(sorted(kw.items())))
    got = bfs(gt, src, **kw)
    labels, preds = got.labels.numpy(), got.preds.numpy()
    np.testing.assert_array_equal(labels, want["labels"])
    np.testing.assert_array_equal(preds, want["preds"])
    assert tuple(getattr(got, f) for f in COUNTERS) == tuple(
        int(want[f]) for f in COUNTERS)
    assert got.sparse_overflowed is False
    assert not want["sparse_overflowed"]
    if "max_iter" not in kw:
        np.testing.assert_array_equal(labels[: ht.n], bfs_cpu(ht, src))
    assert validate_preds(labels, preds, ht, src)
    return got


@pytest.mark.parametrize("name", FAMILIES)
def test_bfs_matches(name):
    """JAX's defaults, from every source."""
    deg = graphs(name)[0].out_degrees + graphs(name)[0].in_degrees
    # the isolated-source case is tested wherever the family has one
    assert (any(deg[s] == 0 for s in sources(name))
            or name in ("random", "random_directed", "grid", "path"))
    for src in sources(name):
        got = check(name, src)
        if deg[src] == 0:  # only the source is reached
            assert got.num_iterations == 1
            assert (got.labels.numpy() >= 0).sum() == 1


# on the path every frontier is one vertex: all push, the narrow tier and
# the tight chain run the defaults' rounds there, so they are left out
CASES = [(name, s) for name in FAMILIES for s in SCHEDULES
         if s != "default"
         and not (name == "path" and s in ("push", "narrow", "tight_chain"))]


@pytest.mark.parametrize("name,schedule", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_bfs_schedules_match(name, schedule):
    kw = SCHEDULES[schedule]
    for src in sources(name):
        got = check(name, src, **kw)
        if schedule == "pull":
            assert got.num_pull_iterations == got.num_iterations
        if schedule == "push":
            assert got.num_pull_iterations == 0
        if schedule == "dense":
            assert got.num_sparse_iterations == 0
        if schedule == "unchained":
            assert got.num_chained_iterations == 0
        if schedule == "cut":
            full = jax_result(name, src, ())["num_iterations"]
            assert got.num_iterations == min(2, int(full))


def test_the_schedules_really_ran():
    """Each form of round runs where the schedule says it does."""
    path = check("path", 0)
    assert path.num_sparse_iterations > 1900  # nearly all sparse
    assert path.num_chained_iterations == path.num_iterations - 1
    grid = check("grid", 0)
    assert grid.num_chained_iterations > 0
    # a chain too small for the wavefront: bitmap rounds take over
    tight = check("grid", 0, chain_cap=8)
    assert 0 < tight.num_chained_iterations < grid.num_chained_iterations
    assert tight.num_sparse_iterations - tight.num_chained_iterations > 1
    # mid-size frontiers miss a narrow tier and take the dense sweep
    narrow = check("random", 0, sparse_capv=4)
    assert 0 < narrow.num_sparse_iterations < narrow.num_iterations
    # the default's last round is a pull round (nothing left unvisited)
    assert check("random", 0).num_pull_iterations > 0
    assert check("random", 0, alpha=0.0).num_pull_iterations == 0


@pytest.mark.parametrize("name,max_iter", [("grid", 40), ("path", 1000)])
def test_a_round_cap_inside_a_chained_stretch(name, max_iter):
    full = check(name, 0)
    cut = check(name, 0, max_iter=max_iter)
    assert cut.num_iterations == max_iter < full.num_iterations
    assert cut.num_chained_iterations == max_iter - 1
    # depths up to the cap are final, deeper vertices are not reached yet
    lab = full.labels.numpy()
    np.testing.assert_array_equal(cut.labels.numpy(),
                                  np.where(lab <= max_iter, lab, -1))


def test_auto_chain_cap_is_jax_s():
    """The default chain capacity from ``m / n`` equals JAX's from the
    device's out-degrees, on each side of the threshold."""
    for name in ("grid", "rmat10", "tiny_isolated", "random", "path"):
        _, gj, gt = graphs(name)
        for cape in (16, 4096, gt.m_pad):
            assert (tbfs_mod._auto_chain_cap(gt, cape)
                    == jbfs_mod._auto_chain_cap(gj, cape))
    assert tbfs_mod._auto_chain_cap(graphs("grid")[2], 4096) > 0
    assert tbfs_mod._auto_chain_cap(graphs("rmat10")[2], 4096) == 0


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
    want = jax_result("random", 0, ())
    assert tuple(getattr(full, f) for f in COUNTERS) == tuple(
        int(want[f]) for f in COUNTERS)
