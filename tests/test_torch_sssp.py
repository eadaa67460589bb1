"""Port parity: SSSP of ``mini_tpu_torch`` against ``mini_tpu``'s on the
same graphs, bitwise (dists and preds) with equal round counters, and
against the Dijkstra oracle ``sssp_cpu``: Bellman-Ford (sparse tier, dense
sweep and the mix of both), delta-stepping over the chain capacities of
``tests/test_algorithms.py`` (chaining off, caps that overflow mid-run,
caps that hold the whole run), ``auto`` and ``sssp_batch``.  Each JAX result
is computed once per file."""

import functools
import sys

import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.algorithms import sssp as jsssp, sssp_batch as jsssp_batch
import mini_tpu_torch.graph as tg
from mini_tpu_torch.algorithms import (
    sssp,
    sssp_batch,
    sssp_cpu,
    validate_pred_tree,
)

from test_torch_graph import build

# the modules, not the functions the packages' __init__ export by their name
jsssp_mod = sys.modules["mini_tpu.algorithms.sssp"]
tsssp_mod = sys.modules["mini_tpu_torch.algorithms.sssp"]


def build_graph(pkg, name):
    if name == "grid24":  # tests/test_algorithms.py's chained-rounds grid
        return pkg.grid2d(24, 24, seed=5, weighted=True)
    if name == "unreachable":  # tests/test_algorithms.py's two-of-four
        return pkg.from_edges([0, 1], [1, 0], num_nodes=4)
    return build(pkg, name)


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(host graph, JAX GraphSlice, port GraphSlice) of one graph."""
    ht = build_graph(tg, name)
    return (ht, jg.GraphSlice.from_host(build_graph(jg, name)),
            tg.GraphSlice.from_host(ht, device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_result(name, src, kw):
    """``mini_tpu``'s result as numpy, once per file."""
    r = jsssp(graphs(name)[1], src, **dict(kw))
    return {f: np.asarray(getattr(r, f)) for f in (
        "dists", "preds", "num_iterations", "num_sparse_iterations",
        "num_chained_iterations", "sparse_overflowed")}


@functools.lru_cache(maxsize=None)
def oracle(name, src):
    return sssp_cpu(graphs(name)[0], src)[0]


def assert_same(want, got, n):
    np.testing.assert_array_equal(got.dists.numpy(), want["dists"])
    np.testing.assert_array_equal(got.preds.numpy(), want["preds"])
    assert (got.num_iterations, got.num_sparse_iterations,
            got.num_chained_iterations) == (
        int(want["num_iterations"]), int(want["num_sparse_iterations"]),
        int(want["num_chained_iterations"]))
    assert got.sparse_overflowed is False
    assert not want["sparse_overflowed"]


def check(name, src, **kw):
    ht, _, gt = graphs(name)
    got = sssp(gt, src, **kw)
    assert_same(jax_result(name, src, tuple(sorted(kw.items()))), got, ht.n)
    dists = got.dists.numpy()[: ht.n]
    np.testing.assert_array_equal(dists, oracle(name, src))
    if kw.get("with_preds", True):
        assert validate_pred_tree(dists, got.preds.numpy(), ht, src)
    else:
        assert (got.preds.numpy() == -1).all()
    return got


# the sparse tier only, the dense sweep only (cape 0), and small tiers that
# leave the big frontiers to the dense sweep
BELLMAN = [{}, dict(sparse_cape=0), dict(sparse_capv=16, sparse_cape=128)]


@pytest.mark.parametrize("kw", BELLMAN, ids=["tiers", "dense", "mixed"])
@pytest.mark.parametrize("name", ["random", "random_directed", "grid24"])
def test_bellman_matches(name, kw):
    for src in (0, 17):
        got = check(name, src, **kw)
        if kw == dict(sparse_cape=0):
            assert got.num_sparse_iterations == 0
    if kw == BELLMAN[2]:  # the mix really ran both forms
        got = sssp(graphs(name)[2], 0, **kw)
        assert 0 < got.num_sparse_iterations < got.num_iterations


@pytest.mark.parametrize("chain_cap", [0, 8, 64, 4096, None])
@pytest.mark.parametrize("src", [0, 300])
def test_delta_chain_caps(chain_cap, src):
    """chaining off, caps that overflow mid-run and fall back to bitmap
    rounds, caps that hold the whole run chained."""
    got = check("grid24", src, variant="delta", chain_cap=chain_cap,
                with_preds=False)
    if chain_cap == 0:
        assert got.num_chained_iterations == 0
    if chain_cap == 4096:
        assert got.num_chained_iterations > got.num_iterations // 2


@pytest.mark.parametrize("kw", [
    dict(variant="delta"),
    dict(variant="delta", delta=8.0),
    dict(variant="delta", sparse_capv=8, sparse_cape=64, chain_cap=16),
    dict(variant="delta", sparse_cape=0),
    dict(variant="auto"),
], ids=["default", "narrow", "mixed", "dense", "auto"])
@pytest.mark.parametrize("name", ["random", "random_directed", "grid24"])
def test_delta_and_auto_match(name, kw):
    for src in (0, 17):
        check(name, src, **kw)


def test_auto_variant_and_default_delta():
    for name in ("random", "random_directed", "grid24"):
        _, gj, gt = graphs(name)
        assert tsssp_mod._auto_variant(gt) == jsssp_mod._auto_variant(gj)
        assert tsssp_mod._default_delta(gt) == jsssp_mod._default_delta(gj)
    assert tsssp_mod._auto_variant(graphs("grid24")[2]) == "delta"
    assert tsssp_mod._auto_variant(graphs("random")[2]) == "bellman"
    assert tsssp_mod._AUTO_DEGREE_THRESHOLD == jsssp_mod._AUTO_DEGREE_THRESHOLD


@pytest.mark.parametrize("kw", [dict(sparse_capv=0), dict(sparse_cape=0),
                                dict(sync_cape=0), dict(sync_cape=4096)],
                         ids=["capv0", "cape0", "sync0", "sync4096"])
@pytest.mark.parametrize("variant", ["bellman", "delta"])
def test_caps_change_no_bits(kw, variant):
    """A tier of no vertices or no edges leaves every round to the dense
    sweep, and ``sync_cape`` changes nothing: the same bits as the
    defaults (JAX itself cannot trace a zero-vertex tier)."""
    want = jax_result("random", 0, (("variant", variant),))
    got = sssp(graphs("random")[2], 0, variant=variant, **kw)
    np.testing.assert_array_equal(got.dists.numpy(), want["dists"])
    np.testing.assert_array_equal(got.preds.numpy(), want["preds"])
    if "sparse_capv" in kw or "sparse_cape" in kw:
        assert got.num_sparse_iterations == 0


def test_unreachable():
    ht, _, gt = graphs("unreachable")
    for variant in ("bellman", "delta"):
        r = sssp(gt, 0, variant=variant)
        assert_same(jax_result("unreachable", 0, (("variant", variant),)), r,
                    ht.n)
        d = r.dists.numpy()
        assert d[1] == 1.0 and np.isinf(d[2]) and np.isinf(d[3])
        assert r.preds.numpy()[:4].tolist() == [-1, 0, -1, -1]


def test_max_iter_cuts_the_rounds():
    ht, _, gt = graphs("grid24")
    cut = sssp(gt, 0, max_iter=5)
    assert cut.num_iterations == 5
    assert_same(jax_result("grid24", 0, (("max_iter", 5),)), cut, ht.n)


@pytest.mark.parametrize("variant", ["bellman", "delta"])
@pytest.mark.parametrize("with_preds", [True, False])
def test_batch_matches(variant, with_preds):
    _, gj, gt = graphs("random")
    srcs = [0, 17, 123]
    want = jsssp_batch(gj, np.array(srcs), variant=variant,
                       with_preds=with_preds)
    got = sssp_batch(gt, srcs, variant=variant, with_preds=with_preds)
    assert got.dists.shape == (3, gt.n_pad)
    for f in ("dists", "preds", "num_iterations", "num_sparse_iterations",
              "num_chained_iterations", "sparse_overflowed"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for i, s in enumerate(srcs):  # each row is the single-source run's
        one = sssp(gt, s, variant=variant, with_preds=with_preds)
        assert torch.equal(got.dists[i], one.dists)
        assert torch.equal(got.preds[i], one.preds)
        assert int(got.num_iterations[i]) == one.num_iterations
    if not with_preds:
        assert (got.preds == -1).all()


HOST_READS = ("tolist", "item", "__bool__", "__int__", "__float__",
              "__index__", "numpy", "cpu")


def count_reads(monkeypatch, fn):
    """``fn()`` and the number of times it read a tensor on the host."""
    count = [0]
    with monkeypatch.context() as m:
        for name in HOST_READS:
            def read(self, *a, _orig=getattr(torch.Tensor, name), **k):
                count[0] += 1
                return _orig(self, *a, **k)
            m.setattr(torch.Tensor, name, read)
        out = fn()
    return out, count[0]


@pytest.mark.parametrize("kw", [{}, dict(sparse_cape=0),
                                dict(variant="delta", delta=30.0),
                                dict(variant="delta", chain_cap=0,
                                     delta=30.0)],
                         ids=["bellman", "dense", "delta", "unchained"])
def test_one_read_a_round(monkeypatch, kw):
    """Each round reads the device once (its counts in one transfer); then
    one read finds no work left and one reads the overflow flag."""
    gt = graphs("grid24")[2]
    r, reads = count_reads(monkeypatch, lambda: sssp(gt, 0, **kw))
    assert r.num_iterations > 20
    assert reads == r.num_iterations + 2


@pytest.mark.parametrize("kwargs,error", [
    (dict(variant="dijkstra"), ValueError),
    (dict(sync_cape=1.5), TypeError),
    (dict(chain_cap=-1), ValueError),
    (dict(delta="8"), TypeError),
    (dict(max_iter=True), TypeError),
])
def test_refuses_a_wrong_argument(kwargs, error):
    with pytest.raises(error):
        sssp(graphs("random")[2], 0, **kwargs)
    with pytest.raises(error):
        sssp_batch(graphs("random")[2], [0], **kwargs)
