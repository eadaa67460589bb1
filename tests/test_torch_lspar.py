"""Port parity: L-Spar and the segmented sort of ``mini_tpu_torch`` against
``mini_tpu``'s on the same inputs, bitwise: ``lspar``'s ``selected_mask``,
``sims`` and ``num_selected``, and the oracle checks of
``tests/test_algorithms.py`` (``lspar_cpu``'s counts, per vertex too, and
the top-by-sim property); ``segment_sort`` and ``segment_argsort`` on int32
keys with ties and float32 keys with ties, signed zeros, infinities and
NaN, ascending and descending, with 0, 1 and 2 payloads.  Each JAX result
is computed once per file."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.algorithms import is_prime as jis_prime
from mini_tpu.algorithms import lspar as jlspar
from mini_tpu.algorithms import lspar_cpu as jlspar_cpu
from mini_tpu.ops.sort import segment_argsort as jargsort
from mini_tpu.ops.sort import segment_sort as jsort
import mini_tpu_torch.graph as tg
from mini_tpu_torch.algorithms import is_prime, lspar, lspar_cpu
from mini_tpu_torch.ops.sort import segment_argsort, segment_sort

from test_torch_graph import build


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(host graph, JAX GraphSlice, port GraphSlice) of one graph."""
    ht = build(tg, name)
    return (ht, jg.GraphSlice.from_host(build(jg, name)),
            tg.GraphSlice.from_host(ht, device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_result(name, prime, e, seed):
    r = jlspar(graphs(name)[1], prime, e, seed)
    return (np.asarray(r.selected_mask), np.asarray(r.sims),
            int(r.num_selected))


def host_hashes(n_pad, prime, seed):
    """tests/test_algorithms.py's hashes: the draws of ``lspar``."""
    rng = np.random.RandomState(seed)
    a = rng.randint(1, prime)
    b = rng.randint(0, prime)
    return ((b + a * np.arange(n_pad, dtype=np.int64)) % prime).astype(
        np.int32)


CASES = [
    ("tiny", 999983, 0.5, 0),
    ("random", 999983, 0.5, 0),
    ("random", 1000003, 0.7, 3),
    ("random", 7, 0.5, 1),  # a small prime: many equal minwise hashes
    ("random", 999983, 1.0, 2),  # every edge selected
    ("random_directed", 999983, 0.5, 1),
    ("rmat8", 999983, 0.5, 0),
]


@pytest.mark.parametrize("name,prime,e,seed", CASES)
def test_lspar_is_the_jax_package_s_and_the_oracle_s(name, prime, e, seed):
    ht, _, gt = graphs(name)
    got = lspar(gt, prime, e, seed)
    mask, sims, count = jax_result(name, prime, e, seed)
    assert got.selected_mask.dtype == torch.bool
    assert got.sims.dtype == torch.int32
    np.testing.assert_array_equal(got.selected_mask.numpy(), mask)
    np.testing.assert_array_equal(got.sims.numpy(), sims)
    assert int(got.num_selected) == count

    # the oracle: equal counts, per vertex too (ties within one sim may
    # pick other edges), and no unselected sim-1 edge beside a selected
    # sim-0 edge of its vertex
    want_sel, want_count = lspar_cpu(ht, host_hashes(gt.n_pad, prime, seed),
                                     e)
    assert int(got.num_selected) == want_count
    sel = got.selected_mask.numpy()[: ht.m]
    np.testing.assert_array_equal(
        np.bincount(ht.csr_srcs[sel], minlength=ht.n),
        np.bincount(ht.csr_srcs[want_sel], minlength=ht.n))
    s = got.sims.numpy()[: ht.m]
    for v in range(ht.n):
        lo, hi = ht.row_offsets[v], ht.row_offsets[v + 1]
        if sel[lo:hi].any() and (~sel[lo:hi]).any():
            assert s[lo:hi][sel[lo:hi]].min() >= s[lo:hi][~sel[lo:hi]].max()
    if e == 1.0:
        assert sel.all()


def test_lspar_refuses_a_composite_prime():
    for pkg_lspar, g in ((lspar, graphs("random")[2]),
                         (jlspar, graphs("random")[1])):
        with pytest.raises(ValueError, match="not prime"):
            pkg_lspar(g, prime=1000)


def test_is_prime_is_the_jax_package_s():
    numbers = list(range(-3, 3000)) + [999981, 999983, 1000003, 2**31 - 1]
    assert [is_prime(x) for x in numbers] == [jis_prime(x) for x in numbers]
    assert is_prime(2) and is_prime(999983) and not is_prime(999981)


@pytest.mark.parametrize("name", ["random", "random_directed"])
def test_lspar_cpu_is_the_jax_package_s(name):
    ht, _, gt = graphs(name)
    hashs = host_hashes(gt.n_pad, 999983, 4)
    got = lspar_cpu(ht, hashs, 0.5)
    want = jlspar_cpu(build(jg, name), hashs, 0.5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


# ------------------------------------------------------------ segmented sort
def sort_keys(kind, m):
    rng = np.random.RandomState(5)
    if kind == "int32":  # few values: many ties, negatives too
        return rng.randint(-4, 5, m).astype(np.int32)
    pool = np.array([-0.0, 0.0, 1.5, -1.5, 2.0, np.inf, -np.inf, np.nan],
                    np.float32)
    return pool[rng.randint(0, len(pool), m)]


def payloads(n, m):
    rng = np.random.RandomState(6)
    return [np.arange(m, dtype=np.int32),
            rng.rand(m).astype(np.float32)][:n]


def assert_bitwise(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("kind", ["int32", "float32"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("n_payloads", [0, 1, 2])
def test_segment_sort_is_the_jax_package_s(kind, descending, n_payloads):
    seg = graphs("random")[2].csr_srcs
    keys = sort_keys(kind, seg.shape[0])
    extra = payloads(n_payloads, seg.shape[0])
    want = jsort(jnp.asarray(keys), jnp.asarray(seg.numpy()),
                 *map(jnp.asarray, extra), descending=descending)
    got = segment_sort(torch.from_numpy(keys), seg,
                       *map(torch.from_numpy, extra), descending=descending)
    if not n_payloads:
        got, want = (got,), (want,)
    assert len(got) == len(want) == 1 + n_payloads
    for g_, w_ in zip(got, want):
        assert_bitwise(g_, w_)
    if kind == "float32":  # the signed zeros keep their input order
        k = got[0].numpy()
        zero = k == 0
        assert np.signbit(k[zero]).any() and (~np.signbit(k[zero])).any()


@pytest.mark.parametrize("kind", ["int32", "float32"])
@pytest.mark.parametrize("descending", [False, True])
def test_segment_argsort_is_the_jax_package_s(kind, descending):
    seg = graphs("random")[2].csr_srcs
    keys = sort_keys(kind, seg.shape[0])
    want = jargsort(jnp.asarray(keys), jnp.asarray(seg.numpy()), descending)
    got = segment_argsort(torch.from_numpy(keys), seg, descending)
    assert_bitwise(got, want)
    # within each segment, a stable sort of the segment alone
    off = graphs("random")[0].row_offsets
    for v in (0, 7, 99):
        lo, hi = off[v], off[v + 1]
        k = keys[lo:hi]
        order = np.argsort(-k if descending else k, kind="stable") + lo
        if kind == "int32":
            np.testing.assert_array_equal(got.numpy()[lo:hi], order)
