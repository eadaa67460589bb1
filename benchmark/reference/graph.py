"""The graph as the program is handed it: every generated edge in both
directions when the configuration is undirected, duplicates kept."""

from __future__ import annotations

import torch


def both_directions(src: torch.Tensor, dst: torch.Tensor,
                    undirected: bool = True):
    """(src, dst) of the graph the program builds from the generated edges
    (``from_edges(..., make_undirected=True)`` doubles each edge)."""
    if not undirected:
        return src, dst
    return torch.cat([src, dst]), torch.cat([dst, src])
