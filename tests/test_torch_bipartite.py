"""Relation graphs: sources and destinations in two vertex sets.

``from_edges_bipartite`` and ``GraphSlice.from_host`` pad each side on its
own; ``graph.banded``'s layouts of such a graph have the rows of one side
and the bands of the other, and the SpMM over them (the banded path and
the plain one, pull and push, and the pull's backward) equals a float64
sum edge by edge, at fewer sources than destinations and at more.  A
square graph's device arrays and layouts are byte for byte what
``build_banded_layout`` gave before relation graphs existed (a digest of
them, frozen).  No JAX: the JAX package has no relation graph."""

import hashlib

import numpy as np
import pytest
import torch

from mini_tpu_torch.graph import banded, csr
from mini_tpu_torch.ops import spmm

# n_src, n_dst: fewer sources than destinations, and more
SIDES = [(150, 460), (520, 200)]


def _edges(n_src, n_dst, m, seed):
    rng = np.random.RandomState(seed)
    src = rng.zipf(1.5, m) % n_src  # a few hub sources
    dst = rng.randint(0, n_dst, m)
    dst[: m // 8] = 3  # a hub destination
    return src, dst, rng.rand(m).astype(np.float32)


def _relation(n_src, n_dst, seed=0, m=3000):
    src, dst, w = _edges(n_src, n_dst, m, seed)
    hg = csr.from_edges_bipartite(src, dst, n_src, n_dst, w)
    return src, dst, w, csr.GraphSlice.from_host(hg, device="cpu")


@pytest.fixture
def small_bands(monkeypatch):
    """Bands of 128 rows at 128 float32 columns: K = 2 to 5 here."""
    monkeypatch.setattr(banded, "FAST_TABLE_BYTES", 128 * 512)


def test_relation_graph_pads_each_side():
    src, dst, w, g = _relation(150, 460)
    assert (g.n_src, g.n_dst, g.n_src_pad, g.n_dst_pad) == (150, 460, 256,
                                                            512)
    assert g.n is None and g.n_pad is None
    assert g.row_offsets.shape == (257,) and g.col_offsets.shape == (513,)
    assert int(g.out_degrees[:150].sum()) == int(g.in_degrees[:460].sum())
    assert g.in_degrees[3] >= 3000 // 8
    # pad edges join the two ghosts
    pad = ~g.edge_mask
    assert (g.csr_srcs[pad] == 255).all() and (g.csr_dsts[pad] == 511).all()
    assert "n_src=150, n_dst=460" in repr(g)
    with pytest.raises(ValueError, match="destination id"):
        csr.from_edges_bipartite(src, dst, 150, 400)


@pytest.mark.parametrize("n_src,n_dst", SIDES)
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_rectangular_layout_sums(small_bands, n_src, n_dst, direction):
    """The layout's rows are the output side's and its K bands cut the
    gathered side; the banded sum equals a float64 sum over the edges."""
    src, dst, w, g = _relation(n_src, n_dst)
    lay = banded.get_layout(g, direction, row_bytes=512)
    rows, table = ((g.n_dst_pad, g.n_src_pad) if direction == "pull"
                   else (g.n_src_pad, g.n_dst_pad))
    assert lay.n_pad == rows and lay.table_rows == table
    assert lay.K == -(-table // 128) and lay.K > 1
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.rand(table, 40) - 0.5).astype(np.float32))
    want = torch.zeros(rows, 40, dtype=torch.float64)
    frm, to = (src, dst) if direction == "pull" else (dst, src)
    want.index_add_(0, torch.from_numpy(to),
                    x.double()[torch.from_numpy(frm)]
                    * torch.from_numpy(w).double()[:, None])
    for impl in ("banded", "xla"):
        got = spmm(g, x, direction=direction, impl=impl)
        assert got.shape == (rows, 40)
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_src,n_dst", SIDES)
def test_pull_backward_pushes_into_sources(small_bands, n_src, n_dst):
    """The pull's x-gradient has the sources' rows: the push of the
    cotangent, on the banded path as on the plain one."""
    _, _, _, g = _relation(n_src, n_dst, seed=2)
    rng = np.random.RandomState(3)
    x0 = torch.from_numpy((rng.rand(g.n_src_pad, 24) - 0.5)
                          .astype(np.float32))
    go = torch.from_numpy((rng.rand(g.n_dst_pad, 24) - 0.5)
                          .astype(np.float32))
    grads = []
    for impl in ("banded", "xla"):
        x = x0.clone().requires_grad_()
        (spmm(g, x, impl=impl) * go).sum().backward()
        grads.append(x.grad)
    assert grads[0].shape == (g.n_src_pad, 24)
    want = spmm(g, go, direction="push", impl="xla")
    for got in grads:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_typed_graph_pads_a_type_alike():
    rng = np.random.RandomState(4)
    counts = {"a": 200, "b": 70}
    edges = {"ab": ("a", "b", rng.randint(0, 200, 500),
                    rng.randint(0, 70, 500)),
             "ba": ("b", "a", rng.randint(0, 70, 300),
                    rng.randint(0, 200, 300)),
             "aa": ("a", "a", rng.randint(0, 200, 400),
                    rng.randint(0, 200, 400))}
    tg = csr.TypedGraph(counts, tuple(
        csr.Relation(name, st, dt, csr.GraphSlice.from_host(
            csr.from_edges_bipartite(s, d, counts[st], counts[dt]),
            device="cpu"))
        for name, (st, dt, s, d) in edges.items()))
    assert [r.name for r in tg.relations] == ["ab", "ba", "aa"]
    assert tg.n_pad("a") == 256 and tg.n_pad("b") == 128
    aa = tg.relations[2].graph
    assert aa.n == 200 and aa.n_pad == 256  # a square relation
    with pytest.raises(KeyError):
        tg.n_pad("c")


# blake2b of a seeded square graph's device arrays and of its pull and
# push layouts at 256-row bands, as `build_banded_layout` gave them before
# relation graphs (K = 3 each)
SQUARE_DIGEST = "21e4d267194c34bb3a6bc475cfab43ab"


def test_square_layouts_are_unchanged(monkeypatch):
    rng = np.random.RandomState(20240)
    n, m = 700, 5000
    src = rng.zipf(1.6, m) % n
    dst = rng.randint(0, n, m)
    w = rng.rand(m).astype(np.float32)
    g = csr.GraphSlice.from_host(csr.from_edges(src, dst, w, num_nodes=n),
                                 device="cpu")
    h = hashlib.blake2b(digest_size=16)
    h.update(g.fingerprint.encode())
    for f in g._DATA_FIELDS:
        h.update(getattr(g, f).numpy().tobytes())
    monkeypatch.setattr(banded, "FAST_TABLE_BYTES", 256 * 512)
    for d in ("pull", "push"):
        lay = banded.get_layout(g, d, row_bytes=512)
        assert (lay.K, lay.band_rows, lay.n_pad, lay.table_rows) == (
            3, 256, 768, 768)
        for name in ("ids", "weights", "eids", "offsets", "valid"):
            for a in getattr(lay, name):
                h.update(a.tobytes())
        for name in ("bounds", "offs2d", "banded_rank"):
            h.update(np.ascontiguousarray(getattr(lay, name)).tobytes())
        h.update(repr(lay.lens).encode())
    assert h.hexdigest() == SQUARE_DIGEST
