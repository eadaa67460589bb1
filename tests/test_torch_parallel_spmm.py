"""Port parity of the distributed SpMMs against ``mini_tpu.parallel`` at
D=8 (JAX's 8 virtual CPU devices here, the port's 8 ``gloo`` ranks from
one spawn): ``dist_spmm`` and ``halo_spmm`` (flat, overlapped, and over
the 2-level ("dcn", "ici") mesh) on tests/test_halo.py's graphs and
tests/test_distributed.py's, within tests/test_halo.py:38's tolerance
(rtol 1e-5, atol 1e-6) of JAX's and of each other.  The backward of each
exchange (the all-gather's reduce-scatter, the all-to-all's reverse
exchange, the overlapped sum's mirror image) against the transpose of the
dense matrix: rtol 1e-5, and an atol of D float32 roundings of the
largest partial sum (each rank's partial sum of a row is rounded once).
The overlapped sum's order of steps, which the CPU cannot time: the
own-edge sum between the exchange's start and its wait, both ways.

JAX is imported inside the tests only: the ranks import this module."""

import functools

import numpy as np
import pytest
import torch

from mini_tpu_torch.parallel import (
    build_halo_plan,
    dist_spmm,
    halo_spmm,
    make_mesh,
    partition_graph,
    shard_to_mesh,
)
from mini_tpu_torch.parallel import distributed as pdist
from mini_tpu_torch.parallel.distributed import make_mesh_2level
from mini_tpu_torch.parallel.halo import RankHalo
from mini_tpu_torch.parallel.launch import run_ranks

from test_torch_parallel import D, full, graphs

TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_halo.py:38
F = 8
AXES = ("dcn", "ici")


def features(pg, seed=0):
    """tests/test_halo.py:_setup's features: ``[D, n_loc, F]``."""
    return np.random.RandomState(seed).rand(
        pg.num_shards, pg.n_loc, F).astype(np.float32)


def dense_features(hg, pg):
    """tests/test_distributed.py:79's: ``[n_pad, F]``, zero past n."""
    x = np.random.RandomState(0).rand(pg.n_pad, F).astype(np.float32)
    x[hg.n:] = 0.0
    return x


def _rank_cases():
    import mini_tpu_torch.graph as tg

    mesh = make_mesh(D, device="cpu")
    mesh2 = make_mesh_2level(2, D // 2, device="cpu")
    s = torch.distributed.get_rank()
    out = {}
    for name, hg in graphs(tg).items():
        if name not in ("dist", "halo", "block", "halo2"):
            continue
        pg = partition_graph(hg, D)
        shards = shard_to_mesh(pg, mesh)
        plan = build_halo_plan(pg)
        x = features(pg) if name != "dist" else dense_features(
            hg, pg).reshape(D, pg.n_loc, F)
        xs = torch.from_numpy(x[s: s + 1])
        out[f"{name}_ag"] = full(dist_spmm(pg, shards, xs, mesh))
        for ov in (False, True):
            out[f"{name}_halo_{ov}"] = full(
                halo_spmm(pg, shards, plan, xs, mesh, overlap=ov))
        if name == "halo2":
            shards2 = shard_to_mesh(pg, mesh2, axis=AXES)
            assert shards2.shard == s
            for ov in (False, True):
                out[f"{name}_2level_{ov}"] = full(halo_spmm(
                    pg, shards2, plan, xs, mesh2, axis=AXES, overlap=ov))
            out["backward"] = _backward_cases(pg, shards, plan, mesh, mesh2,
                                              xs)
            out["overlap_order"] = _overlap_order(pg, shards, plan, mesh, xs)
    return out


def _overlap_order(pg, shards, plan, mesh, xs):
    """The order of the overlapped sum's steps, forward then backward:
    each exchange's start and wait, and each edge sum (which table it
    read)."""
    from mini_tpu_torch.parallel import halo
    from mini_tpu_torch.parallel.distributed import EdgeSum

    order = []
    start, call = halo.Exchanger.start, EdgeSum.__call__

    def logged_start(self, rows):
        order.append("start")
        wait = start(self, rows)

        def logged_wait():
            order.append("wait")
            return wait()
        return logged_wait

    def logged_call(self, table, w=None):
        order.append(f"sum of {table.shape[0]} rows")
        return call(self, table, w)

    try:
        halo.Exchanger.start, EdgeSum.__call__ = logged_start, logged_call
        rh = RankHalo(pg, plan, shards.shard, mesh, "graph")
        x = xs[0].clone().requires_grad_()
        out = rh.overlap_sum(x, rh.own_w, rh.halo_w)
        order.append("backward")
        out.sum().backward()
    finally:
        halo.Exchanger.start, EdgeSum.__call__ = start, call
    return order, pg.n_loc, pg.num_shards * plan.halo_width


def _backward_cases(pg, shards, plan, mesh, mesh2, xs):
    """d<c, A x>/dx through each exchange, gathered: ``[D, n_loc, F]``."""
    ct = torch.from_numpy(np.random.RandomState(5).randn(
        pg.num_shards, pg.n_loc, F).astype(np.float32))[shards.shard]
    w = shards.csc_weights[0, : shards.m_real]
    out = {}

    def grad(fn):
        x = xs[0].clone().requires_grad_()
        (g,) = torch.autograd.grad((fn(x) * ct).sum(), [x])
        return full(g)

    es = pdist.csc_edge_sum(pg, shards)
    group = pdist.axis_group(mesh, "graph")
    out["ag"] = grad(lambda x: es.apply(pdist._AllGather.apply(x, group), w))
    for label, m, axis in (("flat", mesh, "graph"), ("2level", mesh2, AXES)):
        rh = RankHalo(pg, plan, shards.shard, m, axis)
        out[f"halo_{label}"] = grad(lambda x: rh.buf.apply(rh.table(x), w))
        out[f"overlap_{label}"] = grad(lambda x: rh.overlap_sum(
            x, rh.own_w, rh.halo_w))
    return out


@pytest.fixture(scope="module")
def port():
    return run_ranks(_rank_cases, D, device="cpu", timeout_s=600)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """JAX's mesh, partition, shards, plan and sharded features."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import mini_tpu.graph as jg
    from mini_tpu.parallel import make_mesh as jmesh
    from mini_tpu.parallel import partition_graph as jpart
    from mini_tpu.parallel import shard_to_mesh as jshard
    from mini_tpu.parallel.halo import build_halo_plan as jplan

    hg = graphs(jg)[name]
    mesh = jmesh(D)
    pg = jpart(hg, D)
    x = features(pg) if name != "dist" else dense_features(
        hg, pg).reshape(D, pg.n_loc, F)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("graph")))
    return hg, mesh, pg, jshard(pg, mesh), jplan(pg), xs


def test_dist_spmm_matches_jax_and_dense(port):
    """tests/test_distributed.py's ``dist_spmm`` case: JAX's result within
    TOL, and the dense oracle ``A^T x`` at that test's rtol 1e-4."""
    from mini_tpu.parallel import dist_spmm as jspmm

    hg, mesh, pg, shards, _, xs = jax_case("dist")
    got = port["dist_ag"].numpy()
    np.testing.assert_allclose(got, np.asarray(jspmm(pg, shards, xs, mesh)),
                               **TOL)
    a = np.zeros((hg.n, hg.n))
    np.add.at(a, (hg.csr_srcs, hg.csr_dsts), hg.csr_weights)
    want = a.T @ dense_features(hg, pg)[: hg.n]
    np.testing.assert_allclose(got.reshape(pg.n_pad, F)[: hg.n], want,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["halo", "block"])
def test_halo_matches_allgather(port, name):
    """tests/test_halo.py's random and block graphs: the boundary-only
    exchange equals the all-gather path and JAX's ``halo_spmm``."""
    from mini_tpu.parallel.halo import halo_spmm as jhalo

    hg, mesh, pg, shards, plan, xs = jax_case(name)
    got = port[f"{name}_halo_False"].numpy()
    np.testing.assert_allclose(got, port[f"{name}_ag"].numpy(), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jhalo(pg, shards, plan, xs, mesh)), **TOL)
    if name == "block":  # the plan (bitwise JAX's) moves few rows
        assert plan.boundary_rows < 0.15 * pg.num_shards * pg.n_pad
        assert plan.halo_width <= 64


def test_halo_overlap_matches_allgather(port):
    from mini_tpu.parallel.halo import halo_spmm as jhalo

    hg, mesh, pg, shards, plan, xs = jax_case("halo")
    got = port["halo_halo_True"].numpy()
    np.testing.assert_allclose(got, port["halo_ag"].numpy(), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jhalo(pg, shards, plan, xs, mesh, overlap=True)),
        **TOL)


@pytest.mark.parametrize("overlap", [False, True])
def test_halo_2level_mesh_matches(port, overlap):
    """The hierarchical (dcn, ici) exchange on a 2 x 4 mesh == the flat
    exchange == the all-gather path == JAX's."""
    from mini_tpu.parallel.distributed import make_mesh_2level as jmesh2
    from mini_tpu.parallel import shard_to_mesh as jshard
    from mini_tpu.parallel.halo import halo_spmm as jhalo
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    hg, _, pg, _, plan, _ = jax_case("halo2")
    got = port[f"halo2_2level_{overlap}"].numpy()
    np.testing.assert_allclose(got, port["halo2_ag"].numpy(), **TOL)
    np.testing.assert_allclose(got, port[f"halo2_halo_{overlap}"].numpy(),
                               **TOL)
    mesh2 = jmesh2(2, D // 2)
    xs2 = jax.device_put(jnp.asarray(features(pg)),
                         NamedSharding(mesh2, P(AXES)))
    want = jhalo(pg, jshard(pg, mesh2, axis=AXES), plan, xs2, mesh2,
                 axis=AXES, overlap=overlap)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("path", ["ag", "halo_flat", "overlap_flat",
                                  "halo_2level", "overlap_2level"])
def test_exchange_backward_is_the_transpose(port, path):
    """d<c, A x>/dx = A^T c (A the weighted pull matrix of tests/
    test_halo.py:91's graph), whichever exchange carries x: the
    all-gather (its backward the reduce-scatter), the all-to-all (its
    backward the exchange back) flat or in two levels, and the overlapped
    sum (its backward the mirror image)."""
    hg, _, pg, _, _, _ = jax_case("halo2")
    ct = np.random.RandomState(5).randn(pg.n_pad, F)
    a = np.zeros((pg.n_pad, pg.n_pad))  # a[dst, src]
    np.add.at(a, (hg.csc_dsts, hg.csc_srcs), hg.csc_weights)
    want = a.T @ ct.astype(np.float32)
    got = port["backward"][path].numpy().reshape(pg.n_pad, F)
    # a row's cotangent is a sum of per-rank float32 partial sums (the
    # reduce-scatter's, or the own and halo parts): each rounded once
    atol = D * np.finfo(np.float32).eps * (np.abs(a).T @ np.abs(ct)).max()
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=atol)


def test_overlap_runs_the_own_sum_while_the_exchange_is_in_flight(port):
    """``halo_spmm(overlap=True)`` and its backward: the all-to-all starts,
    the sum over the rank's own rows runs, and only then does the rank
    wait for the slabs and sum the halo rows; the backward sums the halo
    edges' cotangents first, sends them back, sums the own edges while
    they travel, then waits and scatters the slabs to their rows."""
    order, n_loc, slab_rows = port["overlap_order"]
    own, halo = f"sum of {n_loc} rows", f"sum of {slab_rows} rows"
    assert order == ["start", own, "wait", halo, "backward",
                     f"sum of {n_loc} rows", "start", own, "wait",
                     halo], order
