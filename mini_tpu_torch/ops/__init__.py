import torch

from mini_tpu_torch.ops.segment import (  # noqa: F401
    segment_reduce,
    segment_argmin_by,
    identity_for,
    exclusive_cumsum,
)
from mini_tpu_torch.ops.frontier import (  # noqa: F401
    Frontier,
    compact_mask,
    uniquify,
)
from mini_tpu_torch.ops.operators import (  # noqa: F401
    EdgeView,
    edges_by_dst,
    edges_by_src,
    advance,
    apply_to_dst,
    filter_frontier,
    neighborhood_reduce,
    compute,
)
from mini_tpu_torch.ops.spmm import sddmm, spmm  # noqa: F401
from mini_tpu_torch.ops.engine import (  # noqa: F401
    src_vals_to_csc,
    dst_vals_to_csc,
    src_vals_to_csr,
    dst_vals_to_csr,
    reduce_csc_by_dst,
    reduce_csr_by_src,
)


def _reduce_masked(g, reducer, edge_mask, vals, op, mask):
    """``op`` over each segment's values where both the caller's ``mask``
    and the graph's edge mask hold, one launch of the engine's segment
    reduce.  ``or`` and ``and`` are JAX's: the int32 max > 0 and the int32
    min > 0 (for bool values, ``and`` is the negation of ``or`` over the
    negated values)."""
    m = edge_mask if mask is None else (mask & edge_mask)
    if op == "and":
        return reducer(g, torch.where(m, vals.to(torch.int32), 2**31 - 1),
                       "min") > 0
    return reducer(g, torch.where(m, vals, identity_for(op, vals.dtype)), op)


def reduce_by_dst(g, vals, op="sum", mask=None):
    """Segmented reduce of CSC-ordered per-edge values into per-dst slots
    (``op``: sum, min, max, or, and); pad edges and ``mask``-ed ones
    contribute the identity."""
    return _reduce_masked(g, reduce_csc_by_dst, g.edge_mask_csc, vals, op,
                          mask)


def reduce_by_src(g, vals, op="sum", mask=None):
    """Segmented reduce of CSR-ordered per-edge values into per-src slots
    (see :func:`reduce_by_dst`)."""
    return _reduce_masked(g, reduce_csr_by_src, g.edge_mask, vals, op, mask)
