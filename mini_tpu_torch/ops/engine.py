"""The engine: moves per-vertex values onto edges and reduces per-edge
values back onto vertices, in either edge order.

Edge-order conventions: "csc" = edges sorted by (dst, src), per-dst
segments contiguous; "csr" = sorted by (src, dst).  A mover is one gather
by the order's vertex ids (``csc_srcs``, ``csc_dsts``, ``csr_srcs``,
``csr_dsts``); pad edges gather the ghost vertex, as in the JAX engine.
A reduce is one launch of the contiguous-segment kernel
(ops/kernels/segreduce_kernel.py) over the order's offsets, ``[m, H]``
values (up to 8 columns) included.
"""

from __future__ import annotations

import torch

from mini_tpu_torch.graph.csr import GraphSlice
from mini_tpu_torch.ops.kernels.segreduce_kernel import (
    MAX_COLS,
    segment_reduce,
)


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
    if edge_vals.ndim == 2 and edge_vals.shape[1] > MAX_COLS:
        return torch.cat([  # more columns than one launch takes
            _reduce(offsets, seg_ids, edge_vals[:, j: j + MAX_COLS], op,
                    identity)
            for j in range(0, edge_vals.shape[1], MAX_COLS)
        ], dim=-1)
    if op == "or":
        return segment_reduce(
            offsets, seg_ids, edge_vals.to(torch.int32), "max"
        ) > 0
    if op == "sum" and not edge_vals.dtype.is_floating_point:
        return segment_reduce(offsets, seg_ids, edge_vals, "sum")
    if op not in ("min", "max", "sum", "bor"):
        raise ValueError(f"unknown op {op!r}")
    out = segment_reduce(offsets, seg_ids, edge_vals, op)
    if identity is not None:  # the value of empty segments
        nonempty = offsets[1:] > offsets[:-1]
        out = torch.where(nonempty if out.ndim == 1 else nonempty[:, None],
                          out, identity)
    return out


class _SegmentSum(torch.autograd.Function):
    """The float segment sum with its gradient: the transpose of a sum
    per segment is the expansion of the cotangent onto the segment's
    edges, a gather by the segment id (JAX ``engine.py``'s ``rsum``)."""

    @staticmethod
    def forward(ctx, offsets, seg_ids, edge_vals):
        ctx.save_for_backward(seg_ids)
        return _reduce(offsets, seg_ids, edge_vals, "sum", None)

    @staticmethod
    def backward(ctx, ct):
        (seg_ids,) = ctx.saved_tensors
        return None, None, torch.index_select(ct, 0, seg_ids)


def _reduce_op(offsets, seg_ids, edge_vals, op, identity):
    if (op == "sum" and identity is None
            and edge_vals.dtype.is_floating_point):
        return _SegmentSum.apply(offsets, seg_ids, edge_vals)
    return _reduce(offsets, seg_ids, edge_vals, op, identity)


def reduce_csc_by_dst(
    g: GraphSlice,
    edge_vals: torch.Tensor,
    op: str,
    identity=None,
) -> torch.Tensor:
    """Segmented reduce of CSC-ordered per-edge values (``[m_pad]``, or
    ``[m_pad, H]`` reduced column by column) into ``[n_pad]`` (``[n_pad,
    H]``) dst slots.  ``op``: ``or`` (bool result), ``min``, ``max``,
    ``sum``, ``bor`` (the bitwise or of int32 words, bit 31 included;
    other dtypes raise ``TypeError``); ``identity`` (min/max/bor/float
    sum) replaces the default value of empty segments.  The float ``sum``
    with no identity is differentiable; the other reduces take no
    gradient."""
    return _reduce_op(g.col_offsets, g.csc_dsts, edge_vals, op, identity)


def reduce_csr_by_src(
    g: GraphSlice,
    edge_vals: torch.Tensor,
    op: str,
    identity=None,
) -> torch.Tensor:
    """Segmented reduce of CSR-ordered per-edge values into [n_pad] src
    slots (see :func:`reduce_csc_by_dst`)."""
    return _reduce_op(g.row_offsets, g.csr_srcs, edge_vals, op, identity)
