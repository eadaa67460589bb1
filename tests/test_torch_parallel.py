"""Port parity of ``mini_tpu_torch.parallel``'s traversals against
``mini_tpu.parallel`` on the graph of tests/test_distributed.py:31, at D=8:
JAX on its 8 virtual CPU devices in this process, the port in 8 ``gloo``
ranks (``run_ranks``, spawned once for the file: ``_rank_cases`` computes
every case and rank 0 returns the all-gathered blocks).  Integer results
bitwise JAX's (BFS labels and preds, SSSP dists, CC, k-core, coloring with
JAX's salts injected, L-Spar's mask, sims and count, and the round
counts), with and without a ``HaloPlan``; PageRank at
tests/test_distributed.py:127's tolerance (rtol 1e-4, atol 1e-7).  Also:
``partition_graph`` and ``build_halo_plan`` bitwise JAX's, the return
convention (a rank's blocks; replicated values equal on every rank), one
device-to-host read a round, and ``make_mesh`` refusing a device count
that is not the world size.

JAX is imported inside the tests only: the ranks import this module."""

import functools

import numpy as np
import pytest
import torch

from mini_tpu_torch.graph import GraphSlice
from mini_tpu_torch.parallel import (
    build_halo_plan,
    dist_bfs,
    dist_lspar,
    dist_sssp,
    make_mesh,
    partition_graph,
    shard_to_mesh,
)
from mini_tpu_torch.parallel import distributed as pdist
from mini_tpu_torch.parallel.launch import run_ranks

D = 8
PR_TOL = dict(rtol=1e-4, atol=1e-7)  # tests/test_distributed.py:127
COLOR_SEED = 3  # tests/test_distributed.py:177
SALT_ROUNDS = 64
HOST_READS = ("tolist", "item", "__bool__", "__int__", "__float__",
              "__index__", "numpy", "cpu")


def block_graph(pkg):
    """tests/test_halo.py:41's ring of 8 dense 50-vertex blocks."""
    n_blocks, bs = 8, 50
    srcs, dsts = [], []
    rng = np.random.RandomState(1)
    for b in range(n_blocks):
        base = b * bs
        for _ in range(300):
            u, v = rng.randint(0, bs, 2)
            if u != v:
                srcs.append(base + u)
                dsts.append(base + v)
        srcs.append(base)
        dsts.append(((b + 1) % n_blocks) * bs)
    return pkg.from_edges(np.array(srcs), np.array(dsts),
                          num_nodes=n_blocks * bs, make_undirected=True)


def graphs(pkg):
    """The JAX tests' graphs, by ``pkg``'s generators (bitwise equal)."""
    return {
        "dist": pkg.erdos_renyi(500, 4000, seed=11, undirected=True,
                                weighted=True),  # test_distributed.py:31
        "halo": pkg.erdos_renyi(400, 3000, seed=31, undirected=True,
                                weighted=True),  # test_halo.py:34
        "block": block_graph(pkg),  # test_halo.py:41
        "halo2": pkg.erdos_renyi(400, 3000, seed=13, undirected=True,
                                 weighted=True),  # test_halo.py:91
        "gcn": pkg.erdos_renyi(300, 2500, seed=21,
                               undirected=True),  # test_dist_gcn.py:21
        "gcn_halo": pkg.erdos_renyi(240, 2000, seed=41,
                                    undirected=True),  # test_dist_gcn_halo:21
        "gcn_halo2": pkg.erdos_renyi(
            240, 2000, seed=43, undirected=True),  # test_dist_gcn_halo:112
        "models": pkg.erdos_renyi(240, 2000, seed=11,
                                  undirected=True),  # test_dist_models.py:26
        "models13": pkg.erdos_renyi(240, 2000, seed=13,
                                    undirected=True),  # test_dist_models:99
    }


def full(t: torch.Tensor) -> torch.Tensor:
    """Every rank's block, stacked in shard order (on every rank)."""
    return pdist.all_gather(t.contiguous(), None)


def count_reads(fn):
    """``fn()`` and the number of times it read a tensor on the host
    (tests/test_torch_sssp.py's count, without pytest's monkeypatch)."""
    count = [0]
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def counting(orig):
        def read(self, *a, **k):
            count[0] += 1
            return orig(self, *a, **k)
        return read

    try:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, counting(orig))
        out = fn()
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
    return out, count[0]


def _rank_cases(salts):
    """Every case of this file on one rank (8 gloo ranks)."""
    import mini_tpu_torch.graph as tg
    from mini_tpu_torch.parallel.distributed import (
        _dist_coloring,
        dist_cc,
        dist_kcore,
        dist_pagerank,
    )

    mesh = make_mesh(D, device="cpu")
    hg = graphs(tg)["dist"]
    pg = partition_graph(hg, D)
    shards = shard_to_mesh(pg, mesh)
    plan = build_halo_plan(pg)
    out = {}
    for name, pl in (("ag", None), ("plan", plan)):
        for src in (0, 7):
            labels, preds = dist_bfs(pg, shards, src, mesh, plan=pl)
            out[f"bfs{src}_{name}"] = (full(labels), full(preds))
        out[f"sssp_{name}"] = full(dist_sssp(pg, shards, 0, mesh, plan=pl))
        ranks, it = dist_pagerank(pg, shards, mesh, plan=pl)
        out[f"pr_{name}"] = (full(ranks), it)
        comp, it = dist_cc(pg, shards, mesh, plan=pl)
        out[f"cc_{name}"] = (full(comp), it)
        colors, it = _dist_coloring(pg, shards, mesh, "graph",
                                    lambda it: salts[it], 16, None, pl)
        out[f"coloring_{name}"] = (full(colors), it)
        colors, it = pdist.dist_coloring(pg, shards, mesh, seed=COLOR_SEED,
                                         plan=pl)
        out[f"coloring_torch_{name}"] = (full(colors), it)
        cores, it = dist_kcore(pg, shards, mesh, plan=pl)
        out[f"kcore_{name}"] = (full(cores), it)

    # L-Spar on tests/test_dist_models.py:26's graph
    hg_m = graphs(tg)["models"]
    pg_m = partition_graph(hg_m, D)
    shards_m = shard_to_mesh(pg_m, mesh)
    for name, pl in (("ag", None), ("plan", build_halo_plan(pg_m))):
        sel, sims, cnt = dist_lspar(pg_m, shards_m, mesh, prime=999983,
                                    e=0.5, seed=0, plan=pl)
        out[f"lspar_{name}"] = (full(sel), full(sims), cnt)

    # the return convention: blocks, and replicated values on every rank
    labels, preds = dist_bfs(pg, shards, 0, mesh)
    ranks, pr_it = dist_pagerank(pg, shards, mesh)
    sel, sims, cnt = dist_lspar(pg_m, shards_m, mesh)
    out["shapes"] = {"labels": tuple(labels.shape), "preds": tuple(
        preds.shape), "ranks": tuple(ranks.shape), "sel": tuple(sel.shape),
        "sims": tuple(sims.shape), "types": (type(pr_it), type(cnt))}
    out["replicated"] = full(torch.tensor([[pr_it, cnt]]))
    out["n_loc"], out["m_loc"] = pg.n_loc, pg_m.m_loc

    # one read a round: the all-reduced count
    (_, it), reads = count_reads(lambda: dist_cc(pg, shards, mesh))
    out["cc_reads"] = (it, reads)
    (_, it), reads = count_reads(lambda: dist_kcore(pg, shards, mesh))
    out["kcore_reads"] = (it, reads)
    (_, it), reads = count_reads(lambda: dist_pagerank(pg, shards, mesh))
    out["pr_reads"] = (it, reads)
    labels, reads = count_reads(lambda: dist_bfs(pg, shards, 0, mesh)[0])
    out["bfs_reads"] = (int(full(labels).max()), reads)

    with pytest.raises(ValueError, match="world size|ranks"):
        make_mesh(D // 2, device="cpu")
    out["mesh_refused"] = True
    return out


@pytest.fixture(scope="module")
def port():
    """The port's results, from one spawn of 8 gloo ranks."""
    import jax

    key = jax.random.PRNGKey(COLOR_SEED)
    salts = [int(jax.random.bits(jax.random.fold_in(key, it), (),
                                 jax.numpy.uint32))
             for it in range(SALT_ROUNDS)]
    return run_ranks(functools.partial(_rank_cases, salts), D,
                     device="cpu", timeout_s=600)


@pytest.fixture(scope="module")
def jax_setup():
    """JAX's mesh, partition, shards and halo plan of the same graph."""
    import mini_tpu.graph as jg
    from mini_tpu.parallel import make_mesh as jmesh
    from mini_tpu.parallel import partition_graph as jpart
    from mini_tpu.parallel import shard_to_mesh as jshard
    from mini_tpu.parallel.halo import build_halo_plan as jplan

    hg = graphs(jg)["dist"]
    mesh = jmesh(D)
    pg = jpart(hg, D)
    return hg, mesh, pg, jshard(pg, mesh), {"ag": None, "plan": jplan(pg)}


PLANS = ["ag", "plan"]


@pytest.mark.parametrize("name", ["dist", "halo", "block", "halo2", "gcn",
                                  "gcn_halo", "gcn_halo2", "models",
                                  "models13"])
def test_partition_and_halo_plan_bitwise(name):
    """``partition_graph`` and ``build_halo_plan`` build JAX's arrays, bit
    for bit, on every graph of the parity tests."""
    import dataclasses

    import mini_tpu.graph as jg
    import mini_tpu_torch.graph as tg
    from mini_tpu.parallel import partition_graph as jpart
    from mini_tpu.parallel.halo import build_halo_plan as jplan

    jpg, tpg = jpart(graphs(jg)[name], D), partition_graph(graphs(tg)[name], D)
    for a, b in ((jpg, tpg), (jplan(jpg), build_halo_plan(tpg))):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


def test_partition_covers_all_edges():
    """tests/test_distributed.py's partition invariants, on the port's."""
    import mini_tpu_torch.graph as tg

    hg = graphs(tg)["dist"]
    pg = partition_graph(hg, D)
    assert pg.edge_mask.sum() == hg.m and pg.n_pad == D * pg.n_loc
    for s in range(D):
        em = pg.edge_mask[s]
        dst = pg.csc_dsts_local[s][em] + s * pg.n_loc
        assert np.all((dst >= s * pg.n_loc) & (dst < (s + 1) * pg.n_loc))
        np.testing.assert_array_equal(
            np.diff(pg.col_offsets[s]),
            np.bincount(pg.csc_dsts_local[s][em], minlength=pg.n_loc))


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("src", [0, 7])
def test_dist_bfs_bitwise(port, jax_setup, plan, src):
    """Labels and preds bitwise JAX's (all-gather and boundary exchange),
    and the labels bitwise ``bfs_cpu`` and the single-device ``bfs``."""
    from mini_tpu.parallel import dist_bfs as jbfs
    from mini_tpu_torch.algorithms import bfs, bfs_cpu

    hg, mesh, pg, shards, plans = jax_setup
    labels, preds = port[f"bfs{src}_{plan}"]
    jl, jp = jbfs(pg, shards, src=src, mesh=mesh, plan=plans[plan])
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(labels.numpy()[: hg.n], bfs_cpu(hg, src))
    single = bfs(GraphSlice.from_host(hg, device="cpu"), src)
    np.testing.assert_array_equal(labels.numpy()[: hg.n],
                                  single.labels.numpy()[: hg.n])


@pytest.mark.parametrize("plan", PLANS)
def test_dist_sssp_bitwise(port, jax_setup, plan):
    from mini_tpu.parallel import dist_sssp as jsssp
    from mini_tpu_torch.algorithms import sssp_cpu

    hg, mesh, pg, shards, plans = jax_setup
    got = port[f"sssp_{plan}"].numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsssp(pg, shards, src=0, mesh=mesh,
                              plan=plans[plan])))
    np.testing.assert_array_equal(got[: hg.n], sssp_cpu(hg, 0)[0])


@pytest.mark.parametrize("plan", PLANS)
def test_dist_pagerank(port, jax_setup, plan):
    """Within tests/test_distributed.py:127's tolerance of JAX's and of the
    single-device port's; the boundary exchange bitwise the all-gather
    (the same sums) with the same round count."""
    from mini_tpu.parallel.distributed import dist_pagerank as jpr
    from mini_tpu_torch.algorithms import pagerank

    hg, mesh, pg, shards, plans = jax_setup
    ranks, it = port[f"pr_{plan}"]
    jr, jit = jpr(pg, shards, mesh, plan=plans[plan])
    assert it > 1 and it == int(jit)
    np.testing.assert_allclose(ranks.numpy(), np.asarray(jr), **PR_TOL)
    single = pagerank(GraphSlice.from_host(hg, device="cpu"),
                      variant="standard")
    np.testing.assert_allclose(ranks.numpy()[: hg.n],
                               single.ranks.numpy()[: hg.n], **PR_TOL)
    np.testing.assert_array_equal(ranks.numpy(), port["pr_ag"][0].numpy())
    assert it == port["pr_ag"][1]


@pytest.mark.parametrize("plan", PLANS)
def test_dist_cc_bitwise(port, jax_setup, plan):
    from mini_tpu.parallel.distributed import dist_cc as jcc
    from mini_tpu_torch.algorithms import cc_cpu

    hg, mesh, pg, shards, plans = jax_setup
    comp, it = port[f"cc_{plan}"]
    jc, jit = jcc(pg, shards, mesh, plan=plans[plan])
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jc))
    assert it == int(jit)
    np.testing.assert_array_equal(comp.numpy()[: hg.n], cc_cpu(hg))


@pytest.mark.parametrize("plan", PLANS)
def test_dist_coloring_bitwise(port, jax_setup, plan):
    """With JAX's salts injected: JAX's colors and rounds, bitwise, and a
    proper coloring; the public entry (its own draws) proper and equal to
    the single-device ``coloring`` of the same seed."""
    from mini_tpu.parallel.distributed import dist_coloring as jcol
    from mini_tpu_torch.algorithms import coloring, validate_coloring

    hg, mesh, pg, shards, plans = jax_setup
    colors, it = port[f"coloring_{plan}"]
    jc, jit = jcol(pg, shards, mesh, seed=COLOR_SEED, plan=plans[plan])
    np.testing.assert_array_equal(colors.numpy(), np.asarray(jc))
    assert it == int(jit) < SALT_ROUNDS
    assert validate_coloring(colors.numpy(), hg)
    own, _ = port[f"coloring_torch_{plan}"]
    assert validate_coloring(own.numpy(), hg)
    single = coloring(GraphSlice.from_host(hg, device="cpu"),
                      seed=COLOR_SEED)
    np.testing.assert_array_equal(own.numpy()[: hg.n],
                                  single.colors.numpy()[: hg.n])


@pytest.mark.parametrize("plan", PLANS)
def test_dist_kcore_bitwise(port, jax_setup, plan):
    from mini_tpu.parallel.distributed import dist_kcore as jkc
    from mini_tpu_torch.algorithms import kcore_cpu_true

    hg, mesh, pg, shards, plans = jax_setup
    cores, it = port[f"kcore_{plan}"]
    jcores, jit = jkc(pg, shards, mesh, plan=plans[plan])
    np.testing.assert_array_equal(cores.numpy(), np.asarray(jcores))
    assert it == int(jit)
    np.testing.assert_array_equal(cores.numpy()[: hg.n],
                                  kcore_cpu_true(hg)[0])


@pytest.mark.parametrize("plan", PLANS)
def test_dist_lspar_bitwise(port, plan):
    """tests/test_dist_models.py's L-Spar case: the mask, sims and count
    bitwise JAX's, and the count the single-device ``lspar``'s."""
    import mini_tpu.graph as jg
    from mini_tpu.parallel import build_halo_plan as jplan
    from mini_tpu.parallel import dist_lspar as jlspar
    from mini_tpu.parallel import make_mesh as jmesh
    from mini_tpu.parallel import partition_graph as jpart
    from mini_tpu.parallel import shard_to_mesh as jshard
    import mini_tpu_torch.graph as tg
    from mini_tpu_torch.algorithms import lspar

    mesh = jmesh(D)
    pg = jpart(graphs(jg)["models"], D)
    sel, sims, cnt = port[f"lspar_{plan}"]
    js, jsims, jcnt = jlspar(pg, jshard(pg, mesh), mesh, prime=999983,
                             e=0.5, seed=0,
                             plan=jplan(pg) if plan == "plan" else None)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    np.testing.assert_array_equal(sims.numpy(), np.asarray(jsims))
    assert cnt == int(jcnt)
    single = lspar(GraphSlice.from_host(graphs(tg)["models"], device="cpu"),
                   prime=999983, e=0.5, seed=0)
    assert cnt == int(single.num_selected)


def test_return_convention(port):
    """A rank's outputs are its blocks (``[n_loc]`` where JAX reshapes the
    sharded ``[D, n_loc]`` to ``[n_pad]``, ``[1, m_loc]`` where JAX keeps
    ``[D, m_loc]``); the round count and L-Spar's count are Python ints,
    the same on every rank."""
    n_loc, m_loc = port["n_loc"], port["m_loc"]
    shapes = port["shapes"]
    assert shapes["labels"] == shapes["preds"] == shapes["ranks"] == (n_loc,)
    assert shapes["sel"] == shapes["sims"] == (1, m_loc)
    assert shapes["types"] == (int, int)
    rep = port["replicated"].numpy()
    assert rep.shape == (D, 2) and (rep == rep[0]).all()


def test_one_read_a_round(port):
    """Each round reads one all-reduced count on the host; CC and k-core
    read it after their body (``rounds`` reads), PageRank before it and
    once more at the end, BFS once a level and once to find no frontier."""
    it, reads = port["cc_reads"]
    assert reads == it
    it, reads = port["kcore_reads"]
    assert reads == it
    it, reads = port["pr_reads"]
    assert reads == it + 1
    depth, reads = port["bfs_reads"]
    assert reads == depth + 2


def test_make_mesh_refuses_another_device_count(port):
    """``make_mesh(4)`` in a group of 8 raises where JAX would take the
    first 4 devices: one rank a device, and the group decides the count."""
    assert port["mesh_refused"]
