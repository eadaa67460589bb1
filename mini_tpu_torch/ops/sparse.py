"""Sparse (compact-frontier) advance: bounded-shape frontier expansion.

The dense engine sweeps all m edges a round: right for large frontiers,
wasteful for tiny ones (high-diameter graphs pay diameter x m).  This is
gunrock's load-balanced sparse advance (`advance.hxx:21-67`): an exclusive
cumsum of the frontier's degrees, then each edge slot's vertex by a search
of those offsets (``torch.searchsorted``, the merge-path search of
``transform_lbs``), over a slot array of static capacity.  Work is
O(capacity), not O(m), and nothing here reads the device from the host:
the capacities are the caller's, chosen before the round from counts it
read once (``frontier_edge_count``).

Every function returns what ``mini_tpu.ops.sparse``'s twin returns, in the
same shapes and dtypes, bit for bit.  The twin's position-coded ``top_k``
compactions (a TPU workaround) are a cumsum and a scatter here
(``ops/frontier.compact_values``), which keeps the same order.
"""

from __future__ import annotations

import torch

from mini_tpu_torch.graph.csr import GraphSlice
from mini_tpu_torch.ops.frontier import compact, compact_values
from mini_tpu_torch.ops.segment import exclusive_cumsum


def default_tiers(
    g: GraphSlice,
    max_capv: int | None = None,
    max_cape: int | None = None,
) -> list[tuple[int, int]]:
    """Ascending ``(capv, cape)`` capacity tiers for the sparse path: one
    tier, capped at ``m_pad`` edges and ``n_pad`` vertices (the defaults of
    ``mini_tpu``; re-measuring them on the H100 is queued work)."""
    if max_cape is None:
        max_cape = max(2048, g.m_pad // 64)
    if max_capv is None:
        max_capv = min(g.n_pad, max_cape)
    cape = min(max_cape, g.m_pad)
    return [(min(max_capv, cape, g.n_pad), cape)]


def default_chain_cap(g: GraphSlice, sparse_cape: int) -> int:
    """Capacity of the chained reentry rounds: a factor 4 below the bitmap
    tier's m/64, floored at 4096 (``mini_tpu``'s default)."""
    return int(min(sparse_cape, max(4096, g.m_pad // 256)))


def frontier_edge_count(g: GraphSlice, mask: torch.Tensor) -> torch.Tensor:
    """Total out-edges of the frontier's vertices (gunrock's degree-scan
    total), an int32 tensor on the device."""
    return torch.where(mask, g.out_degrees, 0).sum(dtype=torch.int32)


def compact_frontier(mask: torch.Tensor, capv: int):
    """Bounded compaction of a bitmap: ``(indices int32[capv] ascending,
    count, overflowed)``, zero-filled (so later gathers stay in bounds,
    where ``ops/frontier.compact_mask`` leaves -1 holes).  ``overflowed``
    is True when entries were dropped; the algorithms check the fit before
    they route here."""
    return compact(mask, capv, 0)


def expand_frontier(
    g: GraphSlice,
    indices: torch.Tensor,  # int32[capv]
    count,  # int32
    cape: int,
):
    """Expand the compact frontier into up to ``cape`` edge slots:
    ``(src, dst, eid, valid, total)``, the first four of shape ``[cape]``.
    Slots past the total edge count are invalid.  The caller guarantees
    ``frontier_edge_count <= cape``.

    Slot ``s`` falls in the frontier position with the last start offset
    ``<= s`` (a zero-degree vertex shares its start with the next, and the
    later one wins); positions past ``count`` start at ``cape``, so never."""
    capv = indices.shape[0]
    dev = indices.device
    in_range = torch.arange(capv, device=dev) < count
    idx = torch.where(in_range, indices, 0)
    degs = torch.where(in_range, torch.index_select(g.out_degrees, 0, idx), 0)
    pos = exclusive_cumsum(degs)
    total = pos[-1] + degs[-1]
    starts = torch.where(in_range, torch.clamp(pos, 0, cape), cape)
    slots = torch.arange(cape, dtype=torch.int32, device=dev)
    vslot = torch.clamp(torch.searchsorted(starts, slots, right=True,
                                           out_int32=True) - 1, 0, capv - 1)
    src = torch.index_select(idx, 0, vslot)
    rank = slots - torch.index_select(pos, 0, vslot)
    eid = torch.clamp(torch.index_select(g.row_offsets, 0, src) + rank,
                      0, g.m_pad - 1)
    dst = torch.index_select(g.csr_dsts, 0, eid)
    valid = ((slots < total) & (rank >= 0)
             & (rank < torch.index_select(degs, 0, vslot)))
    return src, dst, eid, valid, total


def scatter_min(dist: torch.Tensor, dst: torch.Tensor,
                cand: torch.Tensor) -> torch.Tensor:
    """``dist`` lowered to ``cand`` at ``dst`` (an ``amin`` scatter; a dst
    of ``n_pad`` lands in a spare slot that is cut off)."""
    ext = torch.cat([dist, dist.new_full((1,), float("inf"))])
    return ext.scatter_reduce_(0, dst.long(), cand, "amin")[:dist.shape[0]]


def _candidates(g: GraphSlice, dist, weights, idx, cnt, cape: int):
    """The expanded slots' dsts and relax candidates ``dist[src] + w``
    (``n_pad`` and inf in the invalid slots), and the edge total."""
    src, dst, eid, valid, total = expand_frontier(g, idx, cnt, cape)
    cand = (torch.index_select(dist, 0, src)
            + torch.index_select(weights, 0, eid))
    return (torch.where(valid, dst, g.n_pad),
            torch.where(valid, cand, float("inf")), total)


def relax(g: GraphSlice, dist: torch.Tensor, idx: torch.Tensor, cnt,
          cape: int):
    """The plain bounded relax: expand the compact frontier, then lower each
    out-neighbour's dist to ``dist[src] + w``.  ``(d2, overflowed)``."""
    dstw, candw, total = _candidates(g, dist, g.csr_weights, idx, cnt, cape)
    return scatter_min(dist, dstw, candw), total > cape


def _chain_next(g, keep, sdst, capv_next: int, cape: int):
    """The chained frontier: the deduped dsts that ``keep`` marks, in slot
    order, bounded by ``k = min(capv_next, cape)`` and zero-padded to
    ``capv_next``; with its count, total out-degree and whether it is
    usable (non-empty, nothing dropped)."""
    k = min(capv_next, cape)
    nidx = compact_values(keep, sdst, k, 0)
    if k < capv_next:
        nidx = torch.cat([nidx, nidx.new_zeros(capv_next - k)])
    ncnt = keep.sum(dtype=torch.int32)
    live = torch.arange(capv_next, device=keep.device) < torch.clamp(ncnt,
                                                                     max=k)
    nfe = torch.where(live, torch.index_select(g.out_degrees, 0, nidx),
                      0).sum(dtype=torch.int32)
    nok = (ncnt <= k) & (ncnt > 0)
    return nidx, torch.clamp(ncnt, max=k), nfe, nok


def _first_of_run(sdst: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Each sorted slot that starts a run of one real dst."""
    prev = torch.cat([sdst.new_full((1,), -1), sdst[:-1]])
    return (sdst != prev) & (sdst < n_pad)


def relax_and_chain(
    g: GraphSlice,
    dist: torch.Tensor,  # float32[n_pad]
    weights: torch.Tensor,  # float32[m_pad] CSR-ordered edge weights
    idx: torch.Tensor,  # int32[capv] compact frontier (deduped, real ids)
    cnt,  # int32
    cape: int,  # expansion capacity (caller guarantees fit)
    capv_next: int,  # capacity of the derived next frontier
    bound=None,  # optional f32 scalar: chain only dsts with d2 < bound
):
    """One sparse SSSP round: expand and relax the compact frontier, and
    derive the next compact frontier from the same ``cape``-sized arrays,
    indices to indices, with no bitmap round trip.

    Returns ``(d2, sdst, imp_first, next_idx, next_cnt, next_fe, next_ok,
    ovf)``:

    * ``d2``: post-relax distances, the scatter-min of every candidate (an
      ``amin`` scatter: float32 min is exact and order-free, so the bits
      are those of any other order);
    * ``sdst``/``imp_first``: the slots' dsts sorted by ``(dst, cand)`` and
      the mask of each improved dst's first slot;
    * ``next_*``: the improved dsts (with ``d2 < bound`` when given),
      deduped, their count, total out-degree and whether the chain is
      usable (non-empty and nothing dropped);
    * ``ovf``: expansion overflow.
    """
    n_pad = g.n_pad
    dstw, candw, total = _candidates(g, dist, weights, idx, cnt, cape)
    d2 = scatter_min(dist, dstw, candw)

    # the two-key sort (dst, cand) as two stable sorts, the minor key first:
    # each dst's relax minimum comes to its first slot, invalid slots last
    by_cand = torch.sort(candw, stable=True).indices
    order = by_cand[torch.sort(dstw[by_cand], stable=True).indices]
    sdst, scand = dstw[order], candw[order]
    first = _first_of_run(sdst, n_pad)
    dold = torch.index_select(dist, 0, torch.where(first, sdst, 0))
    imp_first = first & (scand < dold)
    keep = imp_first
    if bound is not None:
        keep = keep & (torch.minimum(scand, dold) < bound)
    nidx, ncnt, nfe, nok = _chain_next(g, keep, sdst, capv_next, cape)
    return d2, sdst, imp_first, nidx, ncnt, nfe, nok, total > cape


def visit_and_chain(
    g: GraphSlice,
    labels: torch.Tensor,  # int32[n_pad], -1 = unvisited
    idx: torch.Tensor,  # int32[capv] compact frontier (deduped, real ids)
    cnt,  # int32
    cape: int,  # expansion capacity (caller guarantees fit)
    capv_next: int,  # capacity of the derived next frontier
    new_label,  # int32 scalar: depth stamp for newly visited dsts
):
    """One sparse BFS round: visit the compact frontier's unvisited
    out-neighbours and derive the next compact frontier from the same
    ``cape``-sized arrays (the BFS twin of :func:`relax_and_chain`).

    Returns ``(labels2, next_idx, next_cnt, next_fe, next_ok, ovf)``;
    ``next_ok`` is False when the round found nothing or the next frontier
    overflows ``capv_next``."""
    n_pad = g.n_pad
    _, dst, _, valid, total = expand_frontier(g, idx, cnt, cape)
    sel = valid & (torch.index_select(labels, 0, dst) == -1)

    dstw = torch.where(sel, dst, n_pad)
    stamp = torch.as_tensor(new_label, dtype=torch.int32, device=labels.device)
    labels2 = torch.cat([labels, labels.new_full((1,), -1)]).index_put_(
        (dstw.long(),), stamp)[:n_pad]  # duplicate dsts write one stamp

    sdst = torch.sort(dstw).values
    first = _first_of_run(sdst, n_pad)
    nidx, ncnt, nfe, nok = _chain_next(g, first, sdst, capv_next, cape)
    return labels2, nidx, ncnt, nfe, nok, total > cape
