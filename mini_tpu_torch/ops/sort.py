"""Segmented sort: moderngpu's ``segmented_sort`` (gunrock's
`lspar/lspar_enactor.hxx:85`), as in ``mini_tpu.ops.sort``.

Segments are contiguous, so a sort within each segment is one global
stable sort keyed by (segment id, key).  ``torch.sort`` takes one key, so
the two-key sort is two stable sorts, the minor key first.  Descending
order flips the key (``bitwise_not`` for integers, negation for floats)
and keeps one ascending sort, as ``mini_tpu`` does; ties keep their input
order either way.  ``torch.sort`` and XLA's sort both order ``-0.0`` and
``0.0`` as equal and NaN last, so the outputs are ``mini_tpu``'s bit for
bit.
"""

from __future__ import annotations

import torch


def _order(keys: torch.Tensor, seg_ids: torch.Tensor,
           descending: bool) -> torch.Tensor:
    """The stable (segment id, key) order of the positions."""
    k = keys
    if descending:
        k = -k if k.dtype.is_floating_point else torch.bitwise_not(k)
    by_key = torch.sort(k, stable=True).indices
    return by_key[torch.sort(seg_ids[by_key], stable=True).indices]


def segment_sort(
    keys: torch.Tensor,  # [m]
    seg_ids: torch.Tensor,  # int32[m] sorted (CSR srcs / CSC dsts)
    *payloads: torch.Tensor,
    descending: bool = False,
):
    """Sort keys (and payloads) within each contiguous segment.

    Returns ``sorted_keys``, or ``(sorted_keys, *sorted_payloads)`` when
    payloads are given.  Stable."""
    order = _order(keys, seg_ids, descending)
    sorted_k = keys[order]
    return (sorted_k,) + tuple(p[order] for p in payloads) if payloads \
        else sorted_k


def segment_argsort(
    keys: torch.Tensor,
    seg_ids: torch.Tensor,
    descending: bool = False,
) -> torch.Tensor:
    """int32 positions (into the original array) of the within-segment
    sort."""
    return _order(keys, seg_ids, descending).to(torch.int32)
