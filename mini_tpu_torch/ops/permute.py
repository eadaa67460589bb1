"""Fixed-permutation apply: ``out[rank[i]] = payload[i]``.

The JAX package moves per-edge values between static orders (CSR <-> CSC,
edge order <-> banded order, pull bands <-> push bands) with one
``lax.sort`` keyed by the rank, because the TPU has no fast scatter
(``mini_tpu/ops/permute.py``).  On Hopper the permutation is the
``permute`` kernel (ops/kernels/permute_kernel.py).  :func:`apply_fixed_perm`
keeps JAX's signature: a scatter by the rank, the payloads of one element
size moved as the columns of one table.  :func:`permute_rows` permutes the
rows of one ``[m, P]`` table for the callers that hold their columns as one
stack and the rank's inverse (the banded permutes, GAT's backward): every
direction is then a gather, which the card runs faster than the scatter.

JAX's two other movers are ported as their results, not their TPU
mechanisms: :func:`expand_to_edges` (a delta-cumsum broadcast of
per-vertex values onto sorted segments there) is a row gather by the
segment id of each slot (``ops/kernels/gather_rows.py``), and
:func:`segmented_scan_reduce` (a Hillis-Steele segmented scan there) is
the contiguous-segment reduce (``ops/kernels/segreduce_kernel.py``).  The
sort-key salting and ``apply_fixed_perm_bit`` are TPU workarounds and are
not ported.
"""

from __future__ import annotations

import torch

from mini_tpu_torch.ops.kernels import permute_kernel as _kernel
from mini_tpu_torch.ops.kernels.gather_rows import gather_rows
from mini_tpu_torch.ops.kernels.segreduce_kernel import (
    MAX_COLS,
    _row_segments,
    segment_reduce,
)


def expand_to_edges(
    vertex_vals: torch.Tensor,  # [n_pad, ...]
    offsets: torch.Tensor,  # int[n_pad + 1] contiguous segment boundaries
    m_pad: int,
) -> torch.Tensor:
    """``out[e] = vertex_vals[seg(e)]`` for ``e < m_pad``, ``seg(e)`` the
    last segment that begins at or before ``e`` (so slots past
    ``offsets[-1]`` take the last segment), as JAX's ``expand_to_edges``:
    one row gather of ``vertex_vals``' rows, trailing dims moved whole, by
    the segment ids built from ``offsets`` on their device (no host sync).
    ``offsets[0]`` must be 0."""
    ids = _row_segments(None, offsets.to(torch.int32), m_pad)
    rows = gather_rows(vertex_vals.reshape(vertex_vals.shape[0], -1), ids)
    return rows.reshape((m_pad,) + tuple(vertex_vals.shape[1:]))


def segmented_scan_reduce(
    vals: torch.Tensor,  # [m_pad, ...] in sorted-segment order
    seg_ids: torch.Tensor,  # int32[m_pad] sorted
    offsets: torch.Tensor,  # int[n + 1]
    op: str,  # 'min' | 'max' | 'sum' | 'bor'
    identity,
    max_seg_len: int | None = None,
) -> torch.Tensor:
    """``out[v] = op(vals[offsets[v]:offsets[v+1]])`` over contiguous
    sorted segments, ``identity`` for an empty one, trailing dims reduced
    column by column, as JAX's ``segmented_scan_reduce``: the
    contiguous-segment reduce, one launch for every 8 columns.
    ``max_seg_len`` bounds JAX's scan depth; it is checked and changes
    nothing.  Values are int32 or float32 (``bor`` int32 only): any other
    dtype raises, on the card as on the CPU."""
    from mini_tpu_torch.algorithms.bfs import check_caps

    check_caps(max_seg_len=max_seg_len)
    offsets = offsets.to(torch.int32)
    n = offsets.shape[0] - 1
    tail = tuple(vals.shape[1:])
    if tail:
        flat = vals.reshape(vals.shape[0], -1)
        out = torch.cat([
            segment_reduce(offsets, seg_ids, flat[:, c: c + MAX_COLS], op)
            for c in range(0, flat.shape[1], MAX_COLS)], dim=1)
    else:
        out = segment_reduce(offsets, seg_ids, vals, op)
    nonempty = (offsets[1:] > offsets[:-1]).reshape((n,) + (1,) * (
        out.ndim - 1))
    ident = torch.as_tensor(identity, dtype=out.dtype, device=out.device)
    return torch.where(nonempty, out, ident).reshape((n,) + tail)


class _FixedPerm(torch.autograd.Function):
    """Float payloads through the permutation kernel; the gradient is the
    inverse permutation (a permutation's transpose), the same kernel run
    with ``inverse=True``."""

    @staticmethod
    def forward(ctx, rank, *payloads):
        ctx.save_for_backward(rank)
        return tuple(_kernel.permute(rank, payloads))

    @staticmethod
    def backward(ctx, *cts):
        (rank,) = ctx.saved_tensors
        return (None, *_kernel.permute(rank, cts, inverse=True))


def _rows(rank, rank_inv, table, inverse):
    """``table`` permuted by ``rank`` (``inverse``: by its transpose), as a
    gather: by ``rank`` for the inverse, by ``rank_inv`` for the forward."""
    return _kernel.permute_rows(rank if inverse else rank_inv, table,
                                inverse=True)


class _PermuteRows(torch.autograd.Function):
    """A float table's rows through the permutation kernel; the gradient
    is the permutation the other way."""

    @staticmethod
    def forward(ctx, rank, rank_inv, table, inverse):
        ctx.ranks = (rank, rank_inv)
        ctx.inverse = inverse
        return _rows(rank, rank_inv, table, inverse)

    @staticmethod
    def backward(ctx, ct):
        rank, rank_inv = ctx.ranks
        return None, None, _rows(rank, rank_inv, ct, not ctx.inverse), None


def apply_fixed_perm(rank: torch.Tensor, *payloads: torch.Tensor):
    """Return the payloads permuted so ``output[rank[i]] = payload[i]``
    (one tensor for one payload, else a tuple), as JAX's
    ``apply_fixed_perm``.  ``rank`` must be an int32 permutation of
    ``[0, m)`` and every payload ``[m]``.  Float payloads are
    differentiable: the gradient is the inverse permutation."""
    if payloads and all(p.dtype.is_floating_point for p in payloads):
        outs = _FixedPerm.apply(rank, *payloads)
    else:
        outs = tuple(_kernel.permute(rank, payloads))
    return outs[0] if len(outs) == 1 else tuple(outs)


def permute_rows(rank: torch.Tensor, table: torch.Tensor,
                 inverse: bool = False, *,
                 rank_inv: torch.Tensor) -> torch.Tensor:
    """The rows of a ``[m, P]`` table permuted: ``out[rank[i]] =
    table[i]``, or with ``inverse`` ``out[i] = table[rank[i]]``; one
    launch, each row moved whole.  ``rank_inv``, the inverse permutation
    of ``rank``, makes the forward (and the inverse's gradient) a gather
    by it: coalesced stores and scattered loads, which the card runs
    faster than the scatter (PERF.md).  Float tables are
    differentiable."""
    if table.dtype.is_floating_point:
        return _PermuteRows.apply(rank, rank_inv, table, inverse)
    return _rows(rank, rank_inv, table, inverse)
