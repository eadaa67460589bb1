"""Port parity: k-core of ``mini_tpu_torch`` against ``mini_tpu``'s on the
same graphs, bitwise (cores, ``largest_k_core`` and ``num_iterations``),
and against the NumPy oracles: ``mini`` against ``kcore_cpu``, ``hindex``
against ``kcore_cpu_true``.  The graphs: tests/conftest.py's fixtures, the
reference's k-core fixture graph, the 8 random multigraphs and the
semantics-divergence case of ``tests/test_algorithms.py``.  Each JAX
result is computed once per file."""

import functools
import sys

import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.algorithms import kcore as jkcore
from mini_tpu.algorithms import kcore_cpu as jkcore_cpu
from mini_tpu.algorithms import kcore_cpu_true as jkcore_cpu_true
import mini_tpu_torch.graph as tg
from mini_tpu_torch.algorithms import kcore, kcore_cpu, kcore_cpu_true

from test_torch_graph import build
from test_torch_sssp import count_reads

tkcore_mod = sys.modules["mini_tpu_torch.algorithms.kcore"]

# tests/test_algorithms.py's reference fixture graph (gunrock's
# tests/kcore/test_kcore.mtx: 9 nodes, 17 edges, loaded undirected)
REFERENCE_EDGES = [
    (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (3, 4), (4, 5),
    (4, 6), (5, 6), (2, 5), (1, 6), (0, 7), (7, 8), (5, 8), (0, 8),
    (8, 2),
]


def _multigraphs():
    """tests/test_algorithms.py's 8 random undirected multigraphs (parallel
    edges and self-loops), from the same draws."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(8):
        n = rng.randint(3, 40)
        m = rng.randint(1, 150)
        out.append((rng.randint(0, n, m), rng.randint(0, n, m), n))
    return out


MULTIGRAPHS = _multigraphs()
UNDIRECTED = ["tiny", "random", "reference", "divergence"] + [
    f"multi{i}" for i in range(len(MULTIGRAPHS))]
GRAPHS = UNDIRECTED + ["random_directed"]


def build_graph(pkg, name):
    if name == "reference":
        s, d = zip(*REFERENCE_EDGES)
        return pkg.from_edges(np.array(s), np.array(d), num_nodes=9,
                              make_undirected=True)
    if name == "divergence":  # tests/test_algorithms.py's pinned case
        return pkg.from_edges(np.array([0, 0, 0, 1, 2]),
                              np.array([1, 1, 1, 2, 3]), num_nodes=4,
                              make_undirected=True)
    if name.startswith("multi"):
        s, d, n = MULTIGRAPHS[int(name[5:])]
        return pkg.from_edges(s, d, num_nodes=n, make_undirected=True)
    return build(pkg, name)


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(host graph, JAX GraphSlice, port GraphSlice) of one graph."""
    ht = build_graph(tg, name)
    return (ht, jg.GraphSlice.from_host(build_graph(jg, name)),
            tg.GraphSlice.from_host(ht, device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_result(name, variant):
    r = jkcore(graphs(name)[1], variant)
    return (np.asarray(r.num_cores), int(r.largest_k_core),
            int(r.num_iterations))


def assert_same(name, variant, got):
    cores, largest, iters = jax_result(name, variant)
    np.testing.assert_array_equal(got.num_cores.numpy(), cores)
    assert got.num_cores.dtype == torch.int32
    assert (got.largest_k_core, got.num_iterations) == (largest, iters)


@pytest.mark.parametrize("name", GRAPHS)
def test_mini_is_the_jax_package_s_and_the_oracle_s(name):
    ht, _, gt = graphs(name)
    got = kcore(gt, "mini")
    assert_same(name, "mini", got)
    cores, largest = kcore_cpu(ht)
    np.testing.assert_array_equal(got.num_cores.numpy()[: ht.n], cores)
    assert got.largest_k_core == largest
    assert not got.num_cores[ht.n:].any()  # ghosts keep core 0


@pytest.mark.parametrize("name", UNDIRECTED)
def test_hindex_is_the_jax_package_s_and_the_true_cores(name):
    ht, _, gt = graphs(name)
    got = kcore(gt, "hindex")
    assert_same(name, "hindex", got)
    cores, largest = kcore_cpu_true(ht)
    np.testing.assert_array_equal(got.num_cores.numpy()[: ht.n], cores)
    assert got.largest_k_core == largest


@pytest.mark.parametrize("name", ["random", "random_directed"])
def test_auto_picks_hindex_undirected_and_mini_directed(name):
    gt = graphs(name)[2]
    variant = "mini" if gt.directed else "hindex"
    assert_same(name, variant, kcore(gt))
    assert_same(name, variant, kcore(gt, "auto"))


def test_hindex_refuses_a_directed_graph():
    for pkg_kcore, g in ((kcore, graphs("random_directed")[2]),
                         (jkcore, graphs("random_directed")[1])):
        with pytest.raises(ValueError, match="undirected"):
            pkg_kcore(g, "hindex")


@pytest.mark.parametrize("name", ["multi0", "multi1"])
def test_divergence_of_the_reference_peel_is_kept(name):
    """On these two multigraphs parallel edges drive one vertex's degree
    past 0 in the reference's peel, which robs it of its core number; the
    two variants differ there and nowhere else, as the two oracles do."""
    ht, _, gt = graphs(name)
    mini = kcore(gt, "mini").num_cores.numpy()[: ht.n]
    true = kcore(gt, "hindex").num_cores.numpy()[: ht.n]
    robbed = kcore_cpu(ht)[0] != kcore_cpu_true(ht)[0]
    assert robbed.sum() == 1
    np.testing.assert_array_equal(mini != true, robbed)
    assert (mini[robbed] < true[robbed]).all()


@pytest.mark.parametrize("name", ["random", "random_directed", "multi3"])
def test_oracles_are_the_jax_package_s(name):
    ht, _, _ = graphs(name)
    hj = build_graph(jg, name)
    for mine, theirs in ((kcore_cpu, jkcore_cpu),
                         (kcore_cpu_true, jkcore_cpu_true)):
        got, want = mine(ht), theirs(hj)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_peel_takes_both_tiers(monkeypatch):
    """On the random graph the first rounds peel more out-edges than the
    sparse tier holds (the dense sweep) and the later ones fewer (the
    sparse tier); with the tier closed every round is dense, with the
    same result."""
    gt = graphs("random")[2]
    calls = {"dense": 0, "sparse": 0}
    for kind in calls:
        fn = getattr(tkcore_mod, f"_peel_{kind}")

        def counted(*a, _fn=fn, _kind=kind):
            calls[_kind] += 1
            return _fn(*a)
        monkeypatch.setattr(tkcore_mod, f"_peel_{kind}", counted)
    monkeypatch.setattr(tkcore_mod, "default_tiers",
                        lambda g: [(g.n_pad, 64)])
    got = kcore(gt, "mini")
    assert calls["dense"] > 0 and calls["sparse"] > 0
    assert calls["dense"] + calls["sparse"] == got.num_iterations
    assert_same("random", "mini", got)
    monkeypatch.setattr(tkcore_mod, "default_tiers", lambda g: [])
    calls.update(dense=0, sparse=0)
    got = kcore(gt, "mini")
    assert calls == {"dense": got.num_iterations, "sparse": 0}
    assert_same("random", "mini", got)


def test_one_read_a_round(monkeypatch):
    """A peel round reads the device once (the peel set's size and edge
    total and the least positive degree, in one transfer), and each level
    once more, the read that finds nothing to peel; an h-index step reads
    once, and the largest core once at the end."""
    gt = graphs("random")[2]
    levels = [0, 0]  # reads, reads that ended a level
    read = tkcore_mod._read

    def counted(*scalars):
        out = read(*scalars)
        levels[0] += 1
        levels[1] += out[1] == 0
        return out
    monkeypatch.setattr(tkcore_mod, "_read", counted)
    r, reads = count_reads(monkeypatch, lambda: kcore(gt, "mini"))
    assert reads == levels[0] == r.num_iterations + levels[1]
    assert 1 < levels[1] < r.num_iterations
    r, reads = count_reads(monkeypatch, lambda: kcore(gt, "hindex"))
    assert reads == r.num_iterations + 1
