"""Segmented reductions in plain torch.

gunrock resolves concurrent per-destination updates with atomics
(`intrinsics.hxx:12-22`) and folds neighbor values with moderngpu's
``lbs_segreduce`` (`neighborhood.hxx:58`).  Here a reduction over an edge
array whose segment ids are sorted (CSR order sorts by src, CSC order by
dst) takes both roles.  The engine's per-vertex reduces run on the
contiguous-segment kernel (ops/kernels/segreduce_kernel.py); the functions
below are the general torch forms, used by the ``xla`` SpMM path and as
references.
"""

from __future__ import annotations

import torch

_SCATTER_OPS = {"sum": "sum", "min": "amin", "max": "amax"}


def identity_for(op: str, dtype: torch.dtype):
    """The reduction identity of ``op`` for ``dtype``, as a Python scalar."""
    if op == "sum":
        return False if dtype == torch.bool else 0
    if op in ("min", "max"):
        if dtype.is_floating_point:
            return float("inf") if op == "min" else float("-inf")
        info = torch.iinfo(dtype)
        return int(info.max) if op == "min" else int(info.min)
    if op == "or":
        return False
    if op == "and":
        return True
    raise ValueError(f"unknown op {op!r}")


def contiguous_segment_sum(
    vals: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment sum for CONTIGUOUS segments given boundary offsets:
    ``out[v] = sum(vals[offsets[v]:offsets[v+1]])``.

    One cumsum + two gathers.  Exact for integer inputs (wrapping like the
    int32 sum); for floats the cumsum accumulates over the whole array, so
    only use where that precision is acceptable.
    """
    if mask is not None:
        vals = torch.where(mask, vals, torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device))
    c = torch.cat(
        [
            torch.zeros((1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                        device=vals.device),
            torch.cumsum(vals, 0, dtype=vals.dtype),
        ]
    )
    off = offsets.long()
    return c[off[1:]] - c[off[:-1]]


def segment_reduce(
    vals: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    op: str = "sum",
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = True,
    offsets: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reduce ``vals`` ([m] or [m, F]) into ``num_segments`` buckets keyed
    by ``seg_ids``.  ``mask`` elements set to False contribute the
    identity; empty segments get the identity.  ``or``/``and`` reduce bool
    values and return bool.

    ``indices_are_sorted`` and ``offsets`` are ``mini_tpu``'s: there they
    choose a route (a sorted scatter, or a cumsum difference over the
    contiguous segments) and never change the result.  One scatter serves
    every case here, so they change nothing."""
    if op in ("or", "and"):
        red = segment_reduce(
            vals.to(torch.int32), seg_ids, num_segments,
            "max" if op == "or" else "min", mask=mask,
        )
        return red > 0
    if op not in _SCATTER_OPS:
        raise ValueError(f"unknown op {op!r}")
    ident = identity_for(op, vals.dtype)
    if mask is not None:
        vals = torch.where(mask, vals, torch.full((), ident, dtype=vals.dtype,
                                                  device=vals.device))
    out = torch.full(
        (num_segments,) + tuple(vals.shape[1:]), ident, dtype=vals.dtype,
        device=vals.device,
    )
    idx = seg_ids.long()
    if vals.ndim > 1:
        idx = idx.view((-1,) + (1,) * (vals.ndim - 1)).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, _SCATTER_OPS[op],
                               include_self=True)


def segment_argmin_by(
    keys: torch.Tensor,
    payload: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per segment, ``(min key, min payload among the key-minimizers)``:
    a reproducible choice among ties, in place of gunrock's benign-race
    predecessor writes (`sssp/sssp_functor.hxx:30-33`)."""
    min_keys = segment_reduce(keys, seg_ids, num_segments, "min", mask=mask)
    at_min = keys == min_keys[seg_ids.long()]
    if mask is not None:
        at_min = at_min & mask
    min_payload = segment_reduce(payload, seg_ids, num_segments, "min",
                                 mask=at_min)
    return min_keys, min_payload


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along axis 0 (gunrock's ``transform_scan``,
    `advance.hxx:40`), kept on the device."""
    c = torch.cumsum(x, 0, dtype=x.dtype)
    return torch.cat(
        [torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                     device=x.device), c[:-1]]
    )
