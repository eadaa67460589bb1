"""Port parity: graph coloring of ``mini_tpu_torch`` against ``mini_tpu``'s,
and the engine's ``bor`` reduce it runs on.

``torch`` cannot draw ``jax.random``'s bits, so the parity tests hand the
port's two paths JAX's draws (the fast path a salt a round, the generic
path a seed array a round) and require the colors and the round count
bitwise JAX's: the fast path at K = 2, 8, 16 (on
``erdos_renyi(2000, 20000)`` also, where JAX's first round colors more
edges than its sparse update holds and it rebuilds its colored bits by a
sort), the generic path at K = 1 and 8.  With the port's own generator the
colorings are checked by the oracle ``validate_coloring``.  Each JAX
result is computed once per file."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
import mini_tpu.ops as jops
from mini_tpu.algorithms import coloring as jcoloring
from mini_tpu.algorithms import validate_coloring as jvalidate
import mini_tpu_torch.graph as tg
import mini_tpu_torch.ops as tops
from mini_tpu_torch.algorithms import coloring, validate_coloring
from mini_tpu_torch.ops.kernels import segreduce_kernel as k1

from test_torch_graph import build
from test_torch_sssp import count_reads

jcol = sys.modules["mini_tpu.algorithms.coloring"]
tcol = sys.modules["mini_tpu_torch.algorithms.coloring"]

PRIME = 1000003
IMPROPER_SEED = 5  # JAX's K=1 coloring of 0 -> 1 is improper for it


def build_graph(pkg, name):
    if name == "er2000":  # JAX's dense rebuild of the colored bits runs
        return pkg.erdos_renyi(2000, 20000, seed=1, undirected=True)
    if name == "arc":  # one directed edge, 0 -> 1
        return pkg.from_edges(np.array([0]), np.array([1]), num_nodes=2)
    return build(pkg, name)


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(host graph, JAX GraphSlice, port GraphSlice) of one graph."""
    ht = build_graph(tg, name)
    return (ht, jg.GraphSlice.from_host(build_graph(jg, name)),
            tg.GraphSlice.from_host(ht, device="cpu"))


def max_iter(name):
    return max(2 * graphs(name)[0].n, 64)


@functools.lru_cache(maxsize=None)
def jax_salt(seed, it):
    """JAX's fast-path salt of round ``it``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    return int(jax.random.bits(key, (), jnp.uint32))


@functools.lru_cache(maxsize=None)
def jax_seeds(seed, it, n_pad):
    """JAX's generic-path seeds of round ``it``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    return np.asarray(jax.random.randint(key, (n_pad,), 0, PRIME, jnp.int32))


@functools.lru_cache(maxsize=None)
def jax_result(name, path, K, seed):
    _, gj, _ = graphs(name)
    key = jax.random.PRNGKey(seed)
    if path == "fast":
        cape = max(2048, gj.m_pad // 64)
        r = jcol._coloring_fast_impl(gj, key, max_iter(name), K, cape)
    else:
        r = jcol._coloring_impl(gj, key, PRIME, max_iter(name), K)
    return np.asarray(r.colors), int(r.num_iterations)


def port_run(name, path, K, seed):
    gt = graphs(name)[2]
    if path == "fast":
        return tcol._coloring_fast(gt, lambda it: jax_salt(seed, it),
                                   max_iter(name), K)
    return tcol._coloring_generic(
        gt, lambda it: torch.tensor(jax_seeds(seed, it, gt.n_pad)),
        max_iter(name), K)


@pytest.mark.parametrize("name,path,K,seed", [
    ("tiny", "fast", 16, 0),
    ("random", "fast", 2, 0),
    ("random", "fast", 8, 1),
    ("random", "fast", 16, 2),
    ("er2000", "fast", 2, 0),
    ("er2000", "fast", 16, 0),
    ("tiny", "generic", 1, 0),
    ("random", "generic", 1, 3),
    ("random", "generic", 8, 2),
    ("random_directed", "generic", 1, 0),
    ("random_directed", "generic", 8, 1),
    ("arc", "generic", 1, IMPROPER_SEED),
])
def test_colors_are_the_jax_package_s_with_its_draws(name, path, K, seed):
    ht = graphs(name)[0]
    got = port_run(name, path, K, seed)
    colors, iters = jax_result(name, path, K, seed)
    assert got.colors.dtype == torch.int32
    np.testing.assert_array_equal(got.colors.numpy(), colors)
    assert got.num_iterations == iters
    if not ht.directed:
        assert validate_coloring(got.colors.numpy(), ht)


@pytest.mark.parametrize("name,K,path", [
    ("random", 16, "fast"), ("random", 2, "fast"), ("random", 1, "generic"),
    ("random_directed", 8, "generic"), ("arc", 16, "generic"),
])
def test_the_public_entry_takes_jax_s_path(monkeypatch, name, K, path):
    """``coloring`` sends K > 1 on an undirected graph with equal degrees to
    the fast path, and K = 1 or a directed graph to the generic one, as
    ``mini_tpu.algorithms.coloring`` does."""
    taken = []
    for kind in ("fast", "generic"):
        fn = getattr(tcol, f"_coloring_{kind}")
        monkeypatch.setattr(tcol, f"_coloring_{kind}",
                            lambda *a, _fn=fn, _k=kind: taken.append(_k)
                            or _fn(*a))
    coloring(graphs(name)[2], hashes_per_round=K, max_iter=1)
    assert taken == [path]


def test_reference_fault_on_a_directed_edge_is_kept():
    """JAX reduces the blocker bits over out-edges only, so on ``0 -> 1``
    vertex 1 sees no neighbour and both ends can take color 1.  The port
    gives the same improper colors; it does not repair the reference."""
    ht, gj, _ = graphs("arc")
    want = jcoloring(gj, seed=IMPROPER_SEED, hashes_per_round=1)
    assert not jvalidate(np.asarray(want.colors), ht)
    got = port_run("arc", "generic", 1, IMPROPER_SEED)
    np.testing.assert_array_equal(got.colors.numpy(),
                                  np.asarray(want.colors))
    assert got.colors[0] == got.colors[1] == 1
    assert not validate_coloring(got.colors.numpy(), ht)


@pytest.mark.parametrize("K", [1, 2, 8, 16])
def test_own_draws_give_a_proper_coloring(K):
    ht, _, gt = graphs("random")
    r = coloring(gt, seed=K, hashes_per_round=K)
    colors = r.colors.numpy()
    assert validate_coloring(colors, ht)
    assert not colors[ht.n:].any()  # ghosts untouched
    again = coloring(gt, seed=K, hashes_per_round=K)
    assert torch.equal(again.colors, r.colors)
    assert again.num_iterations == r.num_iterations


def test_tiny_graph_is_colored():
    ht, _, gt = graphs("tiny")
    assert validate_coloring(coloring(gt, seed=0).colors.numpy(), ht)


def test_more_hashes_fewer_rounds():
    ht, _, gt = graphs("random")
    r1 = coloring(gt, seed=3, hashes_per_round=1)
    r8 = coloring(gt, seed=3, hashes_per_round=8)
    assert r8.num_iterations < r1.num_iterations
    assert validate_coloring(r8.colors.numpy(), ht)


@pytest.mark.parametrize("K", [1, 16])
def test_max_iter_is_honoured(K):
    ht, _, gt = graphs("random")
    full = coloring(gt, seed=4, hashes_per_round=K)
    assert full.num_iterations > 1
    cut = coloring(gt, max_iter=1, seed=4, hashes_per_round=K)
    assert cut.num_iterations == 1
    colors = cut.colors.numpy()[: ht.n]
    assert (colors > 0).any() and (colors == 0).any()
    assert (colors <= 2 * K).all()  # round 0's colors only


@pytest.mark.parametrize("K", [0, 17])
def test_refuses_more_bits_than_a_word(K):
    with pytest.raises(ValueError, match="hashes_per_round"):
        coloring(graphs("tiny")[2], hashes_per_round=K)


def test_one_read_a_round(monkeypatch):
    gt = graphs("random")[2]
    for K in (1, 16):
        r, reads = count_reads(
            monkeypatch, lambda: coloring(gt, seed=0, hashes_per_round=K))
        # a round reads whether a vertex is left, and one more read finds
        # none; a fast round also reads its salt off the host generator (a
        # CPU tensor: no device read)
        salts = r.num_iterations if K > 1 else 0
        assert reads == r.num_iterations + 1 + salts


def test_mix_is_the_jax_package_s():
    """The fast path's priorities, the murmur3 finaliser on uint32, in
    int64 arithmetic: every order j < 16 bitwise JAX's ``_mix``, over
    words with every bit pattern."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randint(0, 2**32, 4096, dtype=np.uint64),
                        [0, 1, 2**31 - 1, 2**31, 2**32 - 1]]).astype(
        np.uint32)
    got = tcol._Slots(16, "cpu").mix(torch.from_numpy(x.astype(np.int64)))
    got = got.numpy()
    for j in range(16):
        want = np.asarray(jcol._mix(jnp.asarray(x), j))
        np.testing.assert_array_equal(
            (got[:, j].astype(np.int64) + 2**31).astype(np.uint32), want)


# ------------------------------------------------------------ the bor reduce
@pytest.fixture(scope="module")
def words():
    """32-bit words with bit 31 set in about half of them, per edge of the
    random graph (JAX's as uint32, the port's the same bits as int32)."""
    gt = graphs("random")[2]
    rng = np.random.RandomState(7)
    w = rng.randint(0, 2**32, gt.m_pad, dtype=np.uint64).astype(np.uint32)
    w &= rng.randint(0, 2**32, gt.m_pad, dtype=np.uint64).astype(np.uint32)
    return w


@pytest.mark.parametrize("reduce", ["reduce_csr_by_src", "reduce_csc_by_dst"])
@pytest.mark.parametrize("identity", [0, 5])
def test_bor_is_the_jax_package_s(words, reduce, identity):
    """JAX's engine needs the identity for ``bor``; the port's defaults to
    0."""
    _, gj, gt = graphs("random_directed" if identity == 5 else "random")
    w = words[: gt.m_pad]
    want = np.asarray(getattr(jops, reduce)(gj, jnp.asarray(w), "bor",
                                            identity=identity))
    before = k1.launches
    got = getattr(tops, reduce)(gt, torch.from_numpy(w.view(np.int32)),
                                "bor", identity=identity)
    assert k1.launches == before  # the plain version on the CPU
    assert got.dtype == torch.int32 and (want >= 2**31).any()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if identity == 0:
        assert torch.equal(getattr(tops, reduce)(
            gt, torch.from_numpy(w.view(np.int32)), "bor"), got)


@pytest.mark.parametrize("reduce", ["reduce_csr_by_src", "reduce_csc_by_dst"])
def test_bor_refuses_float_values(reduce):
    _, gj, gt = graphs("random")
    vals = np.ones(gt.m_pad, np.float32)
    with pytest.raises(TypeError):
        getattr(tops, reduce)(gt, torch.from_numpy(vals), "bor", identity=0)
    with pytest.raises(TypeError):
        np.asarray(getattr(jops, reduce)(gj, jnp.asarray(vals), "bor",
                                         identity=0))
