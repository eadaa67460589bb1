"""Frontiers: dense bitmap first, compact index form second.

gunrock's ``frontier_t<T>`` (`frontier.hxx:13-99`) is a fixed-capacity
index vector with sparse<->dense converters bolted onto advance.  Here, as
in ``mini_tpu``, the dense bitmap is the primary form: fixed shape and
duplicate-free by construction.  The compact form is a bounded index
tensor with an on-device count, made without a host sync by a cumsum and a
scatter (moderngpu's ``transform_compact``, `filter.hxx:18-30`).
"""

from __future__ import annotations

import dataclasses

import torch

from mini_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Frontier:
    """Dense vertex (or edge) frontier over a padded id space."""

    mask: torch.Tensor  # bool[n_pad]

    @staticmethod
    def empty(n_pad: int, device=None) -> "Frontier":
        """No vertex set, on ``device`` (``None``: the card)."""
        return Frontier(torch.zeros(n_pad, dtype=torch.bool,
                                    device=resolve_device(device)))

    @staticmethod
    def full(n_pad: int, n: int, device=None) -> "Frontier":
        """The ``n`` real vertices, on ``device`` (``None``: the card)."""
        return Frontier(torch.arange(n_pad, device=resolve_device(device))
                        < n)

    @staticmethod
    def from_indices(indices: torch.Tensor, n_pad: int) -> "Frontier":
        """Set the bits of ``indices``; out-of-range entries (e.g. -1
        holes) are dropped."""
        valid = (indices >= 0) & (indices < n_pad)
        # out-of-range entries land in a spare slot past the end: no sync
        mask = torch.zeros(n_pad + 1, dtype=torch.bool, device=indices.device)
        mask[torch.where(valid, indices, n_pad).long()] = True
        return Frontier(mask[:n_pad])

    def size(self) -> torch.Tensor:
        """On-device element count (no host sync)."""
        return self.mask.sum(dtype=torch.int32)

    def to_indices(self, capacity: int):
        """Compact to a bounded index list: ``(indices int32[capacity],
        count, overflowed)``, -1 past ``count`` (gunrock's -1 holes,
        `advance.hxx:60`); see :func:`compact_mask`."""
        return compact_mask(self.mask, capacity)

    def __and__(self, other: "Frontier") -> "Frontier":
        return Frontier(self.mask & other.mask)

    def __or__(self, other: "Frontier") -> "Frontier":
        return Frontier(self.mask | other.mask)


def compact_values(mask: torch.Tensor, values: torch.Tensor, capacity: int,
                   fill) -> torch.Tensor:
    """``values`` at the first ``capacity`` set positions of ``mask``, in
    order, then ``fill``: each set position's rank among the set ones (a
    cumsum) is its slot, and the values are scattered there; positions past
    ``capacity`` go to a spare slot that is cut off.  No host sync."""
    rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < capacity), rank, capacity).long()
    out = torch.full((capacity + 1,), fill, dtype=values.dtype,
                     device=mask.device)
    return out.scatter_(0, slot, values)[:capacity]


def compact(mask: torch.Tensor, capacity: int, fill: int):
    """``(indices int32[capacity], count, overflowed)``: the set positions
    of ``mask`` ascending, ``fill`` past them; ``count`` is at most
    ``capacity`` and ``overflowed`` says that positions were dropped."""
    n = mask.shape[0]
    count = mask.sum(dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=mask.device)
    idx = compact_values(mask, pos, capacity, fill)
    return idx, torch.clamp(count, max=capacity), count > capacity


def compact_mask(mask: torch.Tensor, capacity: int):
    """Indices of set bits, bounded by ``capacity``; -1 padded.

    Returns ``(indices, count, overflowed)``: ``overflowed`` is a bool
    tensor set when the population exceeds ``capacity``; entries past it
    are dropped (gunrock's frontier exits the process instead,
    `frontier.hxx:85-93`)."""
    return compact(mask, capacity, -1)


def uniquify(indices: torch.Tensor, n_pad: int, capacity: int | None = None):
    """Exact dedup of an index frontier by a bitmap round trip, in place of
    gunrock's heuristic culls (`filter.hxx:33-119`).  Negative and
    out-of-range indices (holes) are dropped.  Returns ``(indices, count,
    overflowed)`` as :func:`compact_mask`, ascending."""
    capacity = capacity or indices.shape[0]
    return Frontier.from_indices(indices, n_pad).to_indices(capacity)
