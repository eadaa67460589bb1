"""Port parity of the engine pieces under SSSP: the compact-frontier
advance (``ops/sparse.py``), the compact frontier and ``uniquify``,
``segment_argmin_by``, ``segment_reduce``'s routes, ``neighborhood_reduce``
and ``reduce_by_dst``/``reduce_by_src``, each bitwise against its
``mini_tpu`` twin on the same inputs (drawn from a numpy seed), float sums
within float32 rounding of a sum taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
import mini_tpu.ops as jops
import mini_tpu.ops.sparse as jsparse
from mini_tpu.ops.frontier import Frontier as JFrontier
import mini_tpu_torch.graph as tg
import mini_tpu_torch.ops as tops
import mini_tpu_torch.ops.sparse as tsparse
from mini_tpu_torch.ops.frontier import Frontier as TFrontier

from test_torch_graph import build

GRAPHS = ["random", "random_directed", "grid24"]
# the JAX twins under jit, one trace per static capacity (eager dispatch
# compiles every op anew for each shape)
j_expand = jax.jit(jsparse.expand_frontier, static_argnums=(3,))
j_relax = jax.jit(jsparse.relax_and_chain, static_argnums=(5, 6))
j_visit = jax.jit(jsparse.visit_and_chain, static_argnums=(4, 5))


def build_graph(pkg, name):
    if name == "grid24":  # tests/test_algorithms.py's chained-rounds grid
        return pkg.grid2d(24, 24, seed=5, weighted=True)
    return build(pkg, name)


@pytest.fixture(scope="module", params=GRAPHS)
def slices(request):
    """(JAX GraphSlice, port GraphSlice) of the same graph."""
    return (jg.GraphSlice.from_host(build_graph(jg, request.param)),
            tg.GraphSlice.from_host(build_graph(tg, request.param),
                                    device="cpu"))


def t(a):
    return torch.from_numpy(np.array(a))


def eq(want, got):
    """Bitwise, with the dtype; scalars and 0-d tensors too."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    np.testing.assert_array_equal(got, want)


def eq_all(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        try:
            eq(w, g)
        except AssertionError as exc:
            raise AssertionError(f"output {i}") from exc


def frontier_mask(n_pad, n, size, seed):
    rng = np.random.RandomState(seed)
    mask = np.zeros(n_pad, bool)
    mask[rng.choice(n, size, replace=False)] = True
    return mask


@pytest.mark.parametrize("size,capv", [(0, 8), (5, 8), (8, 8), (13, 8),
                                       (40, 64), (150, 32)])
def test_compact_frontier_and_mask(size, capv):
    n_pad = 256
    mask = frontier_mask(n_pad, 200, size, seed=size)
    eq_all(jsparse.compact_frontier(jnp.asarray(mask), capv),
           tsparse.compact_frontier(t(mask), capv))
    eq_all(JFrontier(jnp.asarray(mask)).to_indices(capv),
           TFrontier(t(mask)).to_indices(capv))
    eq_all(jops.compact_mask(jnp.asarray(mask), capv),
           tops.compact_mask(t(mask), capv))
    idx, count, ovf = tops.compact_mask(t(mask), capv)
    assert bool(ovf) == (size > capv) and int(count) == min(size, capv)
    assert (idx[int(count):] == -1).all()


@pytest.mark.parametrize("capacity", [None, 4, 16, 64])
def test_uniquify(capacity):
    rng = np.random.RandomState(capacity or 0)
    # duplicates, -1 holes and an out-of-range id among 48 entries
    idx = rng.randint(-1, 40, 48).astype(np.int32)
    idx[7] = 99
    want = jops.uniquify(jnp.asarray(idx), 64, capacity)
    got = tops.uniquify(t(idx), 64, capacity)
    eq_all(want, got)
    uniq = np.unique(idx[(idx >= 0) & (idx < 64)])
    assert int(got[1]) == min(len(uniq), capacity or 48)


def test_from_indices_drops_holes():
    idx = np.array([3, -1, 3, 9, 130, 0], np.int32)
    want = JFrontier.from_indices(jnp.asarray(idx), 128).mask
    eq(want, TFrontier.from_indices(t(idx), 128).mask)


@pytest.mark.parametrize("size", [1, 7, 30])
def test_expand_frontier(slices, size):
    gj, gt = slices
    mask = frontier_mask(gt.n_pad, gt.n, size, seed=size)
    eq(jsparse.frontier_edge_count(gj, jnp.asarray(mask)),
       tsparse.frontier_edge_count(gt, t(mask)))
    capv = 32
    idx_j, cnt_j, _ = jsparse.compact_frontier(jnp.asarray(mask), capv)
    idx_t, cnt_t, _ = tsparse.compact_frontier(t(mask), capv)
    fe = int(tsparse.frontier_edge_count(gt, t(mask)))
    for cape in (fe, 1024):  # an exact fit, a larger tier
        eq_all(j_expand(gj, idx_j, cnt_j, cape),
               tsparse.expand_frontier(gt, idx_t, cnt_t, cape))


def relax_inputs(gt, size, seed):
    """A float32 dist with some finite entries and a frontier among them."""
    rng = np.random.RandomState(seed)
    dist = np.full(gt.n_pad, np.inf, np.float32)
    reached = rng.choice(gt.n, gt.n // 2, replace=False)
    dist[reached] = rng.randint(0, 200, reached.size).astype(np.float32)
    mask = np.zeros(gt.n_pad, bool)
    mask[rng.choice(reached, size, replace=False)] = True
    return dist, mask


@pytest.mark.parametrize("size,capv_next", [(3, 64), (12, 16), (30, 512)])
@pytest.mark.parametrize("bound", [None, 60.0])
def test_relax_and_chain(slices, size, capv_next, bound):
    gj, gt = slices
    dist, mask = relax_inputs(gt, size, seed=size)
    capv = 32
    idx_j, cnt_j, _ = jsparse.compact_frontier(jnp.asarray(mask), capv)
    idx_t, cnt_t, _ = tsparse.compact_frontier(t(mask), capv)
    fe = int(tsparse.frontier_edge_count(gt, t(mask)))
    for cape in (fe, 1024):
        b = None if bound is None else np.float32(bound)
        want = j_relax(
            gj, jnp.asarray(dist), gj.csr_weights, idx_j, cnt_j, cape,
            capv_next, bound=None if b is None else jnp.float32(b))
        got = tsparse.relax_and_chain(
            gt, t(dist), gt.csr_weights, idx_t, cnt_t, cape, capv_next,
            bound=None if b is None else torch.tensor(b))
        eq_all(want, got)
    # the relax is the oracle's: every out-edge of the frontier lowers its dst
    src, dst, eid, valid, _ = tsparse.expand_frontier(gt, idx_t, cnt_t, 1024)
    v = valid.numpy()
    d2 = dist.copy()
    np.minimum.at(d2, dst.numpy()[v], dist[src.numpy()[v]]
                  + gt.csr_weights.numpy()[eid.numpy()[v]])
    eq(d2, got[0])


@pytest.mark.parametrize("size,capv_next", [(3, 64), (12, 8), (30, 512)])
def test_visit_and_chain(slices, size, capv_next):
    gj, gt = slices
    rng = np.random.RandomState(size)
    labels = np.full(gt.n_pad, -1, np.int32)
    seen = rng.choice(gt.n, gt.n // 3, replace=False)
    labels[seen] = 1
    mask = np.zeros(gt.n_pad, bool)
    mask[seen[:size]] = True
    idx_j, cnt_j, _ = jsparse.compact_frontier(jnp.asarray(mask), 32)
    idx_t, cnt_t, _ = tsparse.compact_frontier(t(mask), 32)
    fe = int(tsparse.frontier_edge_count(gt, t(mask)))
    for cape in (fe, 1024):
        eq_all(j_visit(gj, jnp.asarray(labels), idx_j, cnt_j, cape,
                       capv_next, jnp.int32(2)),
               tsparse.visit_and_chain(gt, t(labels), idx_t, cnt_t, cape,
                                       capv_next, 2))


def test_default_caps(slices):
    gj, gt = slices
    for capv, cape in ((None, None), (64, None), (None, 512), (0, 4096)):
        assert (tsparse.default_tiers(gt, capv, cape)
                == jsparse.default_tiers(gj, capv, cape))
    for cape in (16, 4096, 10**6):
        assert (tsparse.default_chain_cap(gt, cape)
                == jsparse.default_chain_cap(gj, cape))


@pytest.mark.parametrize("with_mask", [False, True])
def test_segment_argmin_by(slices, with_mask):
    gj, gt = slices
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 4, gt.m_pad).astype(np.float32)  # many ties
    payload = rng.randint(0, 1000, gt.m_pad).astype(np.int32)
    mask = (rng.rand(gt.m_pad) < 0.7) if with_mask else None
    want = jops.segment_argmin_by(
        jnp.asarray(keys), jnp.asarray(payload), gj.csc_dsts, gj.n_pad,
        None if mask is None else jnp.asarray(mask))
    got = tops.segment_argmin_by(t(keys), t(payload), gt.csc_dsts, gt.n_pad,
                                 None if mask is None else t(mask))
    eq_all(want, got)


@pytest.mark.parametrize("op,dtype", [
    ("sum", "int32"), ("sum", "float32"), ("min", "float32"),
    ("max", "int32"), ("or", "bool"), ("and", "bool"),
])
@pytest.mark.parametrize("route", ["scatter", "offsets", "unsorted"])
def test_segment_reduce_routes(slices, op, dtype, route):
    """``indices_are_sorted`` and ``offsets`` choose a route in both
    packages and never change the result."""
    gj, gt = slices
    rng = np.random.RandomState(6)
    if dtype == "bool":
        vals = rng.rand(gt.m_pad) < 0.6
    elif dtype == "int32":
        vals = rng.randint(-500, 500, gt.m_pad).astype(np.int32)
    else:
        vals = (rng.rand(gt.m_pad) * 10 - 5).astype(np.float32)
    mask = rng.rand(gt.m_pad) < 0.8
    kw = dict(mask=mask)
    if route == "offsets":
        kw["offsets"] = gt.col_offsets.numpy()
    if route == "unsorted":
        kw["indices_are_sorted"] = False
    want = jops.segment_reduce(
        jnp.asarray(vals), gj.csc_dsts, gj.n_pad, op,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    got = tops.segment_reduce(
        t(vals), gt.csc_dsts, gt.n_pad, op,
        **{k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    if op == "sum" and dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    else:
        eq(want, got)


@pytest.mark.parametrize("direction,op,identity", [
    ("pull", "sum", None), ("push", "min", None), ("pull", "max", -7.0),
    ("push", "min", 123.0),
])
@pytest.mark.parametrize("with_frontier", [False, True])
def test_neighborhood_reduce(slices, direction, op, identity, with_frontier):
    gj, gt = slices
    rng = np.random.RandomState(8)
    x = (rng.rand(gt.n_pad) * 100).astype(np.float32)
    mask = frontier_mask(gt.n_pad, gt.n, gt.n // 3, seed=9)
    fj = JFrontier(jnp.asarray(mask)) if with_frontier else None
    ft = TFrontier(t(mask)) if with_frontier else None
    jx, tx = jnp.asarray(x), t(x)
    want = jops.neighborhood_reduce(
        gj, fj, lambda ev: jx[ev.src] * ev.weight, op, direction, identity)
    got = tops.neighborhood_reduce(
        gt, ft, lambda ev: tx[ev.src.long()] * ev.weight, op, direction,
        identity)
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    else:
        eq(want, got)
    if with_frontier:  # vertices outside the frontier get the identity
        ident = tops.identity_for(op, torch.float32) if identity is None \
            else identity
        assert (got.numpy()[~mask] == np.float32(ident)).all()


@pytest.mark.parametrize("op", ["sum", "min", "max", "or", "and"])
@pytest.mark.parametrize("order", ["dst", "src"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_reduce_by_dst_and_src(slices, op, order, with_mask):
    gj, gt = slices
    rng = np.random.RandomState(10)
    if op in ("or", "and"):
        vals = rng.rand(gt.m_pad) < 0.5
    elif op == "max":
        vals = rng.randint(-99, 99, gt.m_pad).astype(np.int32)
    else:
        vals = (rng.rand(gt.m_pad) * 20 - 10).astype(np.float32)
    mask = rng.rand(gt.m_pad) < 0.75 if with_mask else None
    jfn = jops.reduce_by_dst if order == "dst" else jops.reduce_by_src
    tfn = tops.reduce_by_dst if order == "dst" else tops.reduce_by_src
    want = jfn(gj, jnp.asarray(vals), op,
               None if mask is None else jnp.asarray(mask))
    got = tfn(gt, t(vals), op, None if mask is None else t(mask))
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    else:
        eq(want, got)
