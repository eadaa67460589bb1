"""k-core decomposition by iterative peeling.

gunrock's recipe (`kcore/kcore_enactor.hxx:41-84`): for k = 1..n,
repeatedly filter out the vertices with ``0 < degree < k`` (recording core
number k-1 and zeroing their degree), then advance over the removed set,
decrementing each out-neighbour's degree with atomicAdd
(`kcore/kcore_functor.hxx:31-35`); when no vertex with degree >= k
survives, the largest k-core is k-1.

Two variants, as in ``mini_tpu``:

* ``variant="mini"``: the recipe above, bitwise ``kcore_cpu``.  Degrees
  carry over between values of k and may go negative, as the reference's
  do, so a vertex whose degree parallel edges drive to 0 or below keeps
  core 0 (the multigraph artifact ``tests/test_algorithms.py`` pins).  k
  jumps to ``max(k + 1, min surviving degree + 1)``: the levels between
  peel nothing.  The peel loop runs on the host with one device-to-host
  read a round (the peel set's size and out-edge total, and the least
  positive degree), plus the one read that finds the level's peel set
  empty and so gives the next k.  A round takes the sparse tier
  (``ops/sparse.py``: the compact peel set's out-edges and an int32
  ``index_add_``) when the peel set fits it, else the dense sweep: the
  peel bit gathered by every CSC edge's source and one launch of the
  segment-reduce kernel's int32 ``sum``.
* ``variant="hindex"`` (undirected graphs; the ``"auto"`` default picks
  it): true core numbers as the fixpoint of ``h(v) = H({h(u) : u ~ v})``
  from ``h = degree`` (Lu et al. 2016), bitwise ``kcore_cpu_true``.  A
  step gathers ``h[src]`` per CSR edge, sorts the edges by (dst asc, h
  desc) with one sort of a packed int64 key, and counts per dst the
  positions whose value is at least their 1-based rank in the segment:
  one launch of the int32 ``sum``.  One read a step, whether h changed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mini_tpu_torch.algorithms._loop import _read, _tier
from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.engine import (
    reduce_csc_by_dst,
    src_vals_to_csc,
    src_vals_to_csr,
)
from mini_tpu_torch.ops.sparse import (
    compact_frontier,
    default_tiers,
    expand_frontier,
    frontier_edge_count,
)

_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class KCoreResult:
    num_cores: torch.Tensor  # int32[n_pad]: core number per vertex
    largest_k_core: int
    num_iterations: int  # peel rounds (mini) or h-index steps (hindex)


def _peel_dense(g: GraphSlice, peel: torch.Tensor) -> torch.Tensor:
    """Per dst, its in-edges from peeled sources: the peel bit in CSC order
    and one launch of the int32 segment sum."""
    return reduce_csc_by_dst(g, src_vals_to_csc(g, peel.to(torch.int32)),
                             "sum")


def _peel_sparse(g: GraphSlice, peel: torch.Tensor, capv: int,
                 cape: int) -> torch.Tensor:
    """The same count over the compact peel set's out-edges.  Edges into
    vertices already removed count too, as in the dense sweep: their
    degree goes negative, as the reference's atomicAdd makes it."""
    idx, cnt, _ = compact_frontier(peel, capv)
    _, dst, _, valid, _ = expand_frontier(g, idx, cnt, cape)
    dec = torch.zeros(g.n_pad + 1, dtype=torch.int32, device=peel.device)
    dec.index_add_(0, torch.where(valid, dst, g.n_pad),
                   valid.to(torch.int32))
    return dec[: g.n_pad]


def _kcore_mini(g: GraphSlice) -> KCoreResult:
    # k never needs to pass the largest degree + 1 (the metadata's bound
    # may be larger, through the ghost's pad edges: the loop ends first)
    max_k = g.max_out_degree + 1
    deg = g.out_degrees.clone()
    cores = torch.zeros_like(deg)
    tiers = default_tiers(g)
    k, largest, iters = 1, -1, 0
    while largest < 0 and k <= max_k:
        while True:
            peel = (deg < k) & (deg > 0)
            fe, fl, min_deg = _read(
                frontier_edge_count(g, peel), peel.sum(dtype=torch.int32),
                torch.where(deg > 0, deg, _INT_MAX).min())
            if fl == 0:
                break
            cores = torch.where(peel, k - 1, cores)
            tier = _tier(tiers, fe, fl)
            dec = (_peel_dense(g, peel) if tier is None
                   else _peel_sparse(g, peel, *tier))
            deg = torch.where(peel, 0, deg - dec)
            iters += 1
        # nothing peels at level k, so every positive degree is >= k: the
        # survivors are the vertices of positive degree
        if min_deg == _INT_MAX:
            largest = k - 1
        else:  # the levels in (k, min_deg] peel nothing
            k = max(k + 1, min_deg + 1)
    return KCoreResult(cores, largest, iters)


def _kcore_hindex(g: GraphSlice) -> KCoreResult:
    maxd = g.max_out_degree
    # each CSC position's 1-based rank in its segment; the sorted edges
    # group by dst exactly on the CSC segments (the same counts per dst)
    rank1 = (torch.arange(g.m_pad, dtype=torch.int32, device=g.device)
             - g.col_offsets[:-1][g.csc_dsts.long()] + 1)
    dst_key = g.csr_dsts.long() << 32

    def step(h):
        key = dst_key | (maxd - src_vals_to_csr(g, h)).long()
        sval = maxd - (torch.sort(key).values & 0xFFFFFFFF).to(torch.int32)
        return reduce_csc_by_dst(g, (sval >= rank1).to(torch.int32), "sum")

    h = g.out_degrees
    iters, changed = 0, True
    while changed:
        new = step(h)
        changed = bool((new != h).any())  # the step's one read
        h = new
        iters += 1
    largest = int(torch.where(g.vertex_mask(), h, 0).max())
    return KCoreResult(h, largest, iters)


def kcore(g: GraphSlice, variant: str = "auto") -> KCoreResult:
    """``variant``: "mini" = the reference's peeling (oracle:
    ``kcore_cpu``); "hindex" = true core numbers, undirected only (oracle:
    ``kcore_cpu_true``); "auto" = hindex when undirected, else mini."""
    if variant == "auto":
        variant = "mini" if g.directed else "hindex"
    if variant == "hindex":
        if g.directed:
            raise ValueError(
                "variant='hindex' requires an undirected graph (the "
                "h-index fixpoint equals coreness only when in- and "
                "out-neighborhoods coincide)"
            )
        return _kcore_hindex(g)
    return _kcore_mini(g)


def kcore_cpu(hg: HostGraph) -> tuple[np.ndarray, int]:
    """NumPy oracle of the reference's CPU peeling
    (`kcore/kcore_problem.hxx:54-105`), except that the k loop runs to
    max_degree+1 rather than the reference's num_nodes cap
    (`kcore/kcore_enactor.hxx:45`), which silently under-peels multigraphs
    whose core numbers exceed n."""
    deg = hg.out_degrees.astype(np.int64).copy()
    cores = np.zeros(hg.n, dtype=np.int32)
    largest = -1
    for k in range(1, int(max(deg.max(initial=0), 0)) + 2):
        while True:
            peel = (deg < k) & (deg > 0)
            if not peel.any():
                break
            cores[peel] = k - 1
            dec = np.zeros(hg.n, dtype=np.int64)
            active = peel[hg.csr_srcs]
            np.add.at(dec, hg.csr_dsts[active], 1)
            deg = np.where(peel, 0, deg - dec)
        if (deg >= k).sum() == 0:
            largest = k - 1
            break
    return cores, largest


def kcore_cpu_true(hg: HostGraph) -> tuple[np.ndarray, int]:
    """True core numbers (multigraph-aware peeling): at level k remove
    every live vertex whose degree among LIVE vertices is < k; core = k-1
    at removal.  Unlike the reference semantics (``kcore_cpu``), edges into
    already-removed vertices never decrement, so parallel edges cannot
    drive a degree past 0 and rob a vertex of its core number."""
    n = hg.n
    srcs, dsts = hg.csr_srcs, hg.csr_dsts
    deg = hg.out_degrees.astype(np.int64).copy()
    alive = np.ones(n, bool)
    cores = np.zeros(n, np.int32)
    for k in range(1, int(deg.max(initial=0)) + 2):
        while True:
            peel = alive & (deg < k)
            if not peel.any():
                break
            cores[peel] = k - 1
            alive[peel] = False
            sel = peel[srcs] & alive[dsts]
            deg -= np.bincount(dsts[sel], minlength=n)
        if not alive.any():
            break
    return cores, int(cores.max(initial=0))
