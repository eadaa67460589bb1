"""Deterministic synthetic graph generators (NumPy, host-side).

The same code as ``mini_tpu.graph.generators``: the same seed gives the
same graph in both packages.  Erdos-Renyi for uniform-degree sanity, RMAT
(Graph500-style) for the power-law degree distributions that stress load
balancing, a 2-D grid for high diameter, Delaunay for planar low degree.
"""

from __future__ import annotations

import numpy as np

from mini_tpu_torch.graph.csr import HostGraph, from_edges


def erdos_renyi(
    n: int,
    m: int,
    seed: int = 0,
    undirected: bool = False,
    weighted: bool = False,
    max_weight: int = 64,
) -> HostGraph:
    """G(n, m): m edges sampled uniformly (with replacement, no self-loops)."""
    rng = np.random.RandomState(seed)
    srcs = rng.randint(0, n, size=m).astype(np.int64)
    dsts = rng.randint(0, n, size=m).astype(np.int64)
    loop = srcs == dsts
    dsts[loop] = (dsts[loop] + 1) % n
    weights = (
        rng.randint(1, max_weight, size=m).astype(np.float32)
        if weighted
        else None
    )
    return from_edges(
        srcs, dsts, weights, num_nodes=n, make_undirected=undirected
    )


def delaunay(
    scale: int,
    seed: int = 0,
    weighted: bool = False,
    max_weight: int = 64,
) -> HostGraph:
    """Delaunay triangulation of 2**scale uniform random points (the
    SuiteSparse ``delaunay_nXX`` family: planar, low uniform degree ~6).
    Deterministic per seed."""
    from scipy.spatial import Delaunay

    rng = np.random.RandomState(seed)
    n = 1 << scale
    pts = rng.rand(n, 2)
    tri = Delaunay(pts)
    # each simplex contributes its 3 edges; dedup via from_edges doubling
    s = tri.simplices
    srcs = np.concatenate([s[:, 0], s[:, 1], s[:, 2]]).astype(np.int64)
    dsts = np.concatenate([s[:, 1], s[:, 2], s[:, 0]]).astype(np.int64)
    # dedup undirected pairs so the doubled graph is a simple graph
    lo = np.minimum(srcs, dsts)
    hi = np.maximum(srcs, dsts)
    uniq = np.unique(lo * np.int64(n) + hi)
    srcs, dsts = uniq // n, uniq % n
    weights = (
        rng.randint(1, max_weight, size=srcs.shape[0]).astype(np.float32)
        if weighted
        else None
    )
    return from_edges(srcs, dsts, weights, num_nodes=n,
                      make_undirected=True)


def grid2d(
    rows: int,
    cols: int,
    seed: int = 0,
    weighted: bool = False,
    max_weight: int = 64,
) -> HostGraph:
    """rows x cols 4-neighbor lattice (road-network-like: huge diameter,
    degree <= 4 — the worst case for frontier-synchronous traversal)."""
    rng = np.random.RandomState(seed)
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    e = np.concatenate([right, down])
    weights = (
        rng.randint(1, max_weight, size=e.shape[0]).astype(np.float32)
        if weighted
        else None
    )
    return from_edges(e[:, 0], e[:, 1], weights, num_nodes=rows * cols,
                      make_undirected=True)


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    undirected: bool = True,
    weighted: bool = False,
    max_weight: int = 64,
) -> HostGraph:
    """RMAT generator: n = 2**scale vertices, n * edge_factor edges.

    Vectorized recursive quadrant sampling (Graph500 Kronecker style).
    """
    rng = np.random.RandomState(seed)
    n = 1 << scale
    m = n * edge_factor
    srcs = np.zeros(m, dtype=np.int64)
    dsts = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for bit in range(scale):
        r1 = rng.random_sample(m)
        r2 = rng.random_sample(m)
        src_bit = (r1 > ab).astype(np.int64)
        dst_bit = np.where(
            src_bit == 0, r2 > a_norm, r2 > c_norm
        ).astype(np.int64)
        srcs |= src_bit << bit
        dsts |= dst_bit << bit
    # permute vertex ids to break the generator's degree/id correlation
    perm = rng.permutation(n)
    srcs, dsts = perm[srcs], perm[dsts]
    loop = srcs == dsts
    dsts[loop] = (dsts[loop] + 1) % n
    weights = (
        rng.randint(1, max_weight, size=m).astype(np.float32)
        if weighted
        else None
    )
    return from_edges(
        srcs, dsts, weights, num_nodes=n, make_undirected=undirected
    )
