"""The frontier-to-frontier operators: advance / filter / neighborhood /
compute.

gunrock/mini semantics being re-expressed:

* ``advance`` (`advance.hxx:21-160`): expand each frontier vertex's
  neighbors, evaluate a per-edge condition, emit the touched destinations
  as the next frontier.  gunrock does a degree scan + host readback +
  ``transform_lbs``; here, as in ``mini_tpu``, it is one edge sweep in CSC
  order, masked by frontier membership, with the next frontier folded per
  destination by the segment-reduce kernel.
* ``filter`` (`filter.hxx:12-31`): stream compaction by predicate — a mask
  AND on bitmap frontiers.
* ``neighborhood`` (`neighborhood.hxx:13-70`): a segmented reduce of
  per-neighbor values, one launch of the segment-reduce kernel.
* ``compute``: a per-element map over the frontier (listed in gunrock's
  design doc, never implemented there).

Per-edge functors are plain Python callables taking an :class:`EdgeView`
and returning tensors over edges.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mini_tpu_torch.graph.csr import GraphSlice, segment_ranks
from mini_tpu_torch.ops.engine import (
    dst_vals_to_csc,
    reduce_csc_by_dst,
    reduce_csr_by_src,
    src_vals_to_csc,
)
from mini_tpu_torch.ops.frontier import Frontier
from mini_tpu_torch.ops.segment import identity_for


@dataclasses.dataclass(frozen=True)
class EdgeView:
    """Per-edge tensors handed to functors.

    ``rank`` is the edge's position within its segment (gunrock's ``rank``
    argument from transform_lbs, `advance.hxx:53-62`); ``eid`` is the CSR
    edge id (stable across CSR/CSC views).
    """

    src: torch.Tensor  # int32[m_pad]
    dst: torch.Tensor  # int32[m_pad]
    weight: torch.Tensor  # float32[m_pad]
    eid: torch.Tensor  # int32[m_pad]
    mask: torch.Tensor  # bool[m_pad] — real (non-ghost) edges
    seg: torch.Tensor  # int32[m_pad]: segment id (dst in CSC, src in CSR)
    seg_offsets: torch.Tensor  # int32[n_pad+1]: the segments' offsets

    @property
    def rank(self) -> torch.Tensor:
        """int32[m_pad], computed when a functor asks: torch runs eagerly,
        so a rank no functor reads would cost two passes over the edges
        on every advance."""
        return segment_ranks(self.seg_offsets, self.seg)


def edges_by_dst(g: GraphSlice) -> EdgeView:
    """Edge view in CSC order (segment ids = dst, sorted)."""
    return EdgeView(
        src=g.csc_srcs,
        dst=g.csc_dsts,
        weight=g.csc_weights,
        eid=g.csc_eids,
        mask=g.edge_mask_csc,
        seg=g.csc_dsts,
        seg_offsets=g.col_offsets,
    )


def edges_by_src(g: GraphSlice) -> EdgeView:
    """Edge view in CSR order (segment ids = src, sorted)."""
    return EdgeView(
        src=g.csr_srcs,
        dst=g.csr_dsts,
        weight=g.csr_weights,
        eid=torch.arange(g.m_pad, dtype=torch.int32, device=g.device),
        mask=g.edge_mask,
        seg=g.csr_srcs,
        seg_offsets=g.row_offsets,
    )


def advance(
    g: GraphSlice,
    frontier: Frontier,
    cond: Optional[Callable[[EdgeView], torch.Tensor]] = None,
    direction: str = "push",
) -> tuple[Frontier, EdgeView, torch.Tensor]:
    """Expand the frontier one hop.

    push: active edges are out-edges of frontier vertices; the next frontier
    is the set of destinations whose ``cond`` passed (gunrock's
    ``advance_forward_kernel``, `advance.hxx:21-67`).

    pull: gunrock's ``advance_backward_kernel`` contract
    (`advance.hxx:109-159`): the caller passes the unvisited set as the
    frontier and ``cond`` checks the source bitmap; the next frontier is the
    set of frontier vertices with a qualifying in-neighbor.

    Returns (next_frontier, edge_view, active_edge_mask) so callers can run
    further per-edge updates over the same sweep.
    """
    ev = edges_by_dst(g)  # reduce by dst: CSC order
    if direction == "push":
        member = src_vals_to_csc(g, frontier.mask)
    elif direction == "pull":
        member = dst_vals_to_csc(g, frontier.mask)
    else:
        raise ValueError(f"unknown direction {direction!r}")
    active = member & ev.mask
    if cond is not None:
        active = active & cond(ev)
    nxt = reduce_csc_by_dst(g, active, "or")
    return Frontier(nxt), ev, active


def apply_to_dst(
    g: GraphSlice,
    ev: EdgeView,
    active: torch.Tensor,
    values: torch.Tensor,
    op: str,
) -> torch.Tensor:
    """Reduce per-edge ``values`` (masked by ``active``) into per-dst slots:
    the deterministic replacement for gunrock's atomic applies
    (`bfs/bfs_functor.hxx:30-33`, `sssp/sssp_functor.hxx:20-28`)."""
    masked = torch.where(active, values, identity_for(op, values.dtype))
    return reduce_csc_by_dst(g, masked, op)


def filter_frontier(frontier: Frontier, pred: torch.Tensor) -> Frontier:
    """Keep frontier elements where ``pred`` holds (per-vertex bool array):
    on bitmaps gunrock's compaction (`filter.hxx:12-31`) is a mask AND."""
    return Frontier(frontier.mask & pred)


def neighborhood_reduce(
    g: GraphSlice,
    frontier: Optional[Frontier],
    value_fn: Callable[[EdgeView], torch.Tensor],
    op: str = "sum",
    direction: str = "pull",
    identity=None,
) -> torch.Tensor:
    """Per-frontier-vertex reduction over neighbor values
    (`neighborhood.hxx:23-58`).

    pull: for each frontier vertex v, reduce ``value_fn`` over v's in-edges
    (CSC, keyed by dst); push: over v's out-edges (CSR, keyed by src).  One
    launch of the segment-reduce kernel either way.  ``frontier=None`` is
    every vertex (PageRank's rank sum); vertices outside the frontier, and
    those with no edge, get the reduce's identity, which ``identity``
    replaces where given.  Returns ``[n_pad]``."""
    if direction == "pull":
        ev, reducer, order_ids = edges_by_dst(g), reduce_csc_by_dst, g.csc_dsts
    elif direction == "push":
        ev, reducer, order_ids = edges_by_src(g), reduce_csr_by_src, g.csr_srcs
    else:
        raise ValueError(f"unknown direction {direction!r}")
    vals = value_fn(ev)
    sel = ev.mask
    if frontier is not None:  # the segment's own vertex is in the frontier
        sel = sel & torch.index_select(frontier.mask, 0, order_ids)
    ident = identity_for(op, vals.dtype)
    out = reducer(g, torch.where(sel, vals, ident), op)
    if identity is not None:
        out = torch.where(out == ident, torch.as_tensor(
            identity, dtype=out.dtype, device=out.device), out)
    return out


def compute(
    frontier: Frontier,
    fn: Callable[[torch.Tensor], torch.Tensor],
    state: torch.Tensor,
) -> torch.Tensor:
    """Per-vertex map applied only on frontier members."""
    return torch.where(frontier.mask, fn(state), state)
