"""The engine: moves per-vertex values onto edges and reduces per-edge
values back onto vertices, in either edge order.

Edge-order conventions: "csc" = edges sorted by (dst, src), per-dst
segments contiguous; "csr" = sorted by (src, dst).  A mover is one gather
by the order's vertex ids (``csc_srcs``, ``csc_dsts``, ``csr_srcs``,
``csr_dsts``); pad edges gather the ghost vertex, as in the JAX engine.
A reduce is one launch of the contiguous-segment kernel
(ops/kernels/segreduce_kernel.py) over the order's offsets.
"""

from __future__ import annotations

import torch

from mini_tpu_torch.graph.csr import GraphSlice
from mini_tpu_torch.ops.kernels.segreduce_kernel import segment_reduce


def _gather(idx: torch.Tensor, vals: tuple):
    out = tuple(torch.index_select(v, 0, idx) for v in vals)
    return out[0] if len(out) == 1 else out


def src_vals_to_csc(g: GraphSlice, vertex_vals: torch.Tensor, *more):
    """per-edge value[src(e)] in CSC order; extra arrays ride along and
    come back as a tuple."""
    return _gather(g.csc_srcs, (vertex_vals,) + more)


def dst_vals_to_csc(g: GraphSlice, vertex_vals: torch.Tensor) -> torch.Tensor:
    """per-edge value[dst(e)] in CSC order."""
    return _gather(g.csc_dsts, (vertex_vals,))


def src_vals_to_csr(g: GraphSlice, vertex_vals: torch.Tensor) -> torch.Tensor:
    """per-edge value[src(e)] in CSR order."""
    return _gather(g.csr_srcs, (vertex_vals,))


def dst_vals_to_csr(g: GraphSlice, vertex_vals: torch.Tensor, *more):
    """per-edge value[dst(e)] in CSR order; extra arrays ride along."""
    return _gather(g.csr_dsts, (vertex_vals,) + more)


def _reduce(offsets, seg_ids, edge_vals, op, identity):
    if op == "or":
        return segment_reduce(
            offsets, seg_ids, edge_vals.to(torch.int32), "max"
        ) > 0
    if op == "sum" and not edge_vals.dtype.is_floating_point:
        return segment_reduce(offsets, seg_ids, edge_vals, "sum")
    if op not in ("min", "max", "sum"):
        raise ValueError(f"unknown op {op!r}")
    out = segment_reduce(offsets, seg_ids, edge_vals, op)
    if identity is not None:  # the value of empty segments
        out = torch.where(offsets[1:] > offsets[:-1], out, identity)
    return out


def reduce_csc_by_dst(
    g: GraphSlice,
    edge_vals: torch.Tensor,
    op: str,
    identity=None,
) -> torch.Tensor:
    """Segmented reduce of CSC-ordered per-edge values into [n_pad] dst
    slots.  ``op``: ``or`` (bool result), ``min``, ``max``, ``sum``;
    ``identity`` (min/max/float sum) replaces the default value of empty
    segments."""
    return _reduce(g.col_offsets, g.csc_dsts, edge_vals, op, identity)


def reduce_csr_by_src(
    g: GraphSlice,
    edge_vals: torch.Tensor,
    op: str,
    identity=None,
) -> torch.Tensor:
    """Segmented reduce of CSR-ordered per-edge values into [n_pad] src
    slots (see :func:`reduce_csc_by_dst`)."""
    return _reduce(g.row_offsets, g.csr_srcs, edge_vals, op, identity)
