"""Frontiers as dense bitmaps.

gunrock's ``frontier_t<T>`` (`frontier.hxx:13-99`) is a fixed-capacity
index vector with sparse<->dense converters bolted onto advance.  Here, as
in ``mini_tpu``, the dense bitmap is the primary form: fixed shape and
duplicate-free by construction.
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
        mask = torch.zeros(n_pad, dtype=torch.bool, device=indices.device)
        mask[indices[valid].long()] = True
        return Frontier(mask)

    def size(self) -> torch.Tensor:
        """On-device element count (no host sync)."""
        return self.mask.sum(dtype=torch.int32)

    def __and__(self, other: "Frontier") -> "Frontier":
        return Frontier(self.mask & other.mask)

    def __or__(self, other: "Frontier") -> "Frontier":
        return Frontier(self.mask | other.mask)
