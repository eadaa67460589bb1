"""Edge partitioning of the graph across the ranks of a mesh (host side).

1D destination-vertex range partitioning of the CSC: each shard owns a
contiguous vertex range and *all* edges pointing into it, so every
per-dst segment reduction is shard-local and only the frontier / feature
slabs cross between ranks.

Because CSC edges are sorted by dst, each shard's edge set is a contiguous
range; shards are padded to the max per-shard edge count so arrays stack to
``[D, m_loc]``.  NumPy only, the same arrays as ``mini_tpu``'s
``parallel/partition.py`` (the port keeps its own copy: that package
imports jax).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mini_tpu_torch.graph.csr import HostGraph, _round_up


@dataclasses.dataclass
class PartitionedGraph:
    """Host-side stacked shard arrays; leading axis = shard."""

    n: int  # real vertices
    n_pad: int  # == num_shards * n_loc
    m: int
    num_shards: int
    n_loc: int
    m_loc: int
    # per-shard CSC over local dsts [D, ...]:
    col_offsets: np.ndarray  # int32[D, n_loc+1]
    csc_srcs: np.ndarray  # int32[D, m_loc] — GLOBAL source ids
    csc_dsts_local: np.ndarray  # int32[D, m_loc] — dst - shard*n_loc
    csc_weights: np.ndarray  # float32[D, m_loc]
    edge_mask: np.ndarray  # bool[D, m_loc]
    in_degrees: np.ndarray  # int32[D, n_loc]
    out_degrees: np.ndarray  # int32[D, n_loc] (global out-degree per vertex)


def partition_graph(
    hg: HostGraph,
    num_shards: int,
    n_multiple: int = 8,
    m_multiple: int = 8,
) -> PartitionedGraph:
    """1D dst-range partition into ``num_shards`` equal vertex blocks."""
    D = num_shards
    n_loc = _round_up(hg.n + 1, D * n_multiple) // D
    n_pad = n_loc * D

    # shard s owns dsts [s*n_loc, (s+1)*n_loc); CSC edges are dst-sorted so
    # each shard's edges are hg.csc_* [lo, hi)
    bounds = np.searchsorted(
        hg.csc_dsts, np.arange(D + 1) * n_loc, side="left"
    )
    m_loc = _round_up(int(np.max(np.diff(bounds))), m_multiple)
    ghost_local = n_loc - 1  # pad edges attach to the shard's last vertex

    csc_srcs = np.full((D, m_loc), hg.n, dtype=np.int32)
    csc_dsts_local = np.full((D, m_loc), ghost_local, dtype=np.int32)
    csc_weights = np.zeros((D, m_loc), dtype=np.float32)
    edge_mask = np.zeros((D, m_loc), dtype=bool)
    col_offsets = np.zeros((D, n_loc + 1), dtype=np.int32)
    in_degrees = np.zeros((D, n_loc), dtype=np.int32)
    out_degrees = np.zeros((D, n_loc), dtype=np.int32)

    out_deg_global = np.zeros(n_pad, dtype=np.int32)
    out_deg_global[: hg.n] = hg.out_degrees
    in_deg_global = np.zeros(n_pad, dtype=np.int32)
    in_deg_global[: hg.n] = hg.in_degrees

    for s in range(D):
        lo, hi = bounds[s], bounds[s + 1]
        cnt = hi - lo
        csc_srcs[s, :cnt] = hg.csc_srcs[lo:hi]
        csc_dsts_local[s, :cnt] = hg.csc_dsts[lo:hi] - s * n_loc
        csc_weights[s, :cnt] = hg.csc_weights[lo:hi]
        edge_mask[s, :cnt] = True
        col_offsets[s] = np.searchsorted(
            hg.csc_dsts[lo:hi], s * n_loc + np.arange(n_loc + 1)
        ).astype(np.int32)
        in_degrees[s] = in_deg_global[s * n_loc : (s + 1) * n_loc]
        out_degrees[s] = out_deg_global[s * n_loc : (s + 1) * n_loc]

    return PartitionedGraph(
        n=hg.n,
        n_pad=n_pad,
        m=hg.m,
        num_shards=D,
        n_loc=n_loc,
        m_loc=m_loc,
        col_offsets=col_offsets,
        csc_srcs=csc_srcs,
        csc_dsts_local=csc_dsts_local,
        csc_weights=csc_weights,
        edge_mask=edge_mask,
        in_degrees=in_degrees,
        out_degrees=out_degrees,
    )
