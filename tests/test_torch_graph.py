"""Port parity: host graph, device GraphSlice and banded layouts of
``mini_tpu_torch`` against ``mini_tpu``, bitwise, on the same inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.graph import banded as jbanded
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded

TINY_EDGES = [
    (1, 0), (2, 0), (3, 0), (0, 1), (4, 1), (2, 1), (3, 2), (4, 2),
    (5, 2), (5, 3), (6, 3), (2, 4), (5, 4), (6, 4), (6, 5),
]
MTX = os.path.join(os.path.dirname(__file__), "fixtures", "test_bfs.mtx")


def build(pkg, name):
    """The same graph from either package (``pkg`` = its graph module),
    with the arguments of tests/conftest.py's fixtures."""
    if name == "tiny":
        s, d = zip(*TINY_EDGES)
        return pkg.from_edges(np.array(s), np.array(d), num_nodes=7,
                              make_undirected=True)
    if name == "random":
        return pkg.erdos_renyi(200, 1200, seed=3, undirected=True,
                               weighted=True)
    if name == "random_directed":
        return pkg.erdos_renyi(150, 900, seed=7, undirected=False,
                               weighted=True)
    if name == "rmat8":
        return pkg.rmat(8, seed=0, weighted=True)
    if name == "grid":
        return pkg.grid2d(5, 7, seed=1, weighted=True)
    if name == "delaunay":
        return pkg.delaunay(6, seed=2)
    raise KeyError(name)


GRAPHS = ["tiny", "random", "random_directed", "rmat8"]
HOST_FIELDS = ("row_offsets", "csr_dsts", "csr_srcs", "csr_weights",
               "col_offsets", "csc_srcs", "csc_dsts", "csc_weights",
               "csc_eids")


def assert_host_equal(hj, ht):
    assert (hj.n, hj.m, hj.directed) == (ht.n, ht.m, ht.directed)
    for f in HOST_FIELDS:
        a, b = getattr(hj, f), getattr(ht, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", GRAPHS + ["grid", "delaunay"])
def test_from_edges_matches(name):
    assert_host_equal(build(jg, name), build(tg, name))


def test_mtx_load_and_roundtrip(tmp_path):
    """load_mtx (undirected, transposed) and save_mtx agree with the JAX
    package's NumPy loader."""
    for kw in (dict(undirected=True), dict(transpose=True)):
        hj = jg.load_mtx(MTX, use_native=False, **kw)
        ht = tg.load_mtx(MTX, **kw)
        assert_host_equal(hj, ht)
    path = str(tmp_path / "g.mtx")
    ht = build(tg, "random_directed")
    tg.save_mtx(ht, path, weights=True)
    assert_host_equal(jg.load_mtx(path, use_native=False), tg.load_mtx(path))
    assert_host_equal(ht, tg.load_mtx(path))


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_slice_matches(name):
    gj = jg.GraphSlice.from_host(build(jg, name))
    gt = tg.GraphSlice.from_host(build(tg, name))
    for f in jg.GraphSlice._META_FIELDS:
        assert getattr(gj, f) == getattr(gt, f), f
    assert tg.GraphSlice._DATA_FIELDS == jg.GraphSlice._DATA_FIELDS
    for f in jg.GraphSlice._DATA_FIELDS:
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(np.asarray(gj.csc_ranks()),
                                  gt.csc_ranks().numpy())
    np.testing.assert_array_equal(np.asarray(gj.csr_ranks()),
                                  gt.csr_ranks().numpy())


@pytest.mark.parametrize("direction", ["pull", "push"])
@pytest.mark.parametrize("bands", ["K1", "K2"])
@pytest.mark.parametrize("name", ["random", "random_directed"])
def test_banded_layout_matches(name, bands, direction):
    # K2: row_bytes = FAST_TABLE_BYTES // 128 gives band_rows 128, so the
    # 256-row padded graphs split into 2 bands
    row_bytes = 512 if bands == "K1" else tbanded.FAST_TABLE_BYTES // 128
    gj = jg.GraphSlice.from_host(build(jg, name))
    gt = tg.GraphSlice.from_host(build(tg, name))
    lj = jbanded.get_layout(gj, direction, row_bytes=row_bytes)
    lt = tbanded.get_layout(gt, direction, row_bytes=row_bytes)
    assert lt.K == lj.K == (1 if bands == "K1" else 2)
    assert (lt.band_rows, lt.n_pad, lt.m_pad, lt.lens) == (
        lj.band_rows, lj.n_pad, lj.m_pad, lj.lens)
    for f in ("ids", "weights", "offsets", "eids", "valid"):
        for a, b in zip(getattr(lj, f), getattr(lt, f)):
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("bounds", "offs2d", "banded_rank"):
        np.testing.assert_array_equal(getattr(lj, f), getattr(lt, f),
                                      err_msg=f)
    # the kernel-facing device arrays, offs2d transposed to [n_tiles, K, 128]
    dj, dt = lj.dev(), lt.dev("cpu")
    for f in ("bounds", "offs2d", "inv_rank"):
        np.testing.assert_array_equal(np.asarray(dj[f]), dt[f].numpy())
    # the gather-based reorder equals the JAX sort-based one, both ways
    vals = np.random.RandomState(5).rand(gt.m_pad).astype(np.float32)
    bj = lj.permute_to_bands(jnp.asarray(vals))
    bt = lt.permute_to_bands(torch.from_numpy(vals))
    for a, b in zip(bj, bt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(lt.permute_from_bands(bt).numpy(), vals)
