"""Breadth-first search levels and minimum-id parents, edge by edge.

The program's guarantee (``mini_tpu_torch.algorithms.bfs``): ``labels[v]``
is the hop distance from the root (-1 unreached), ``preds[v]`` the
smallest-id vertex ``u`` with an edge ``(u, v)`` and ``labels[u] ==
labels[v] - 1`` (-1 for the root and the unreached).  Here each level is
one sweep over the whole edge list.
"""

from __future__ import annotations

import torch

_NONE = torch.iinfo(torch.int64).max


def levels(src: torch.Tensor, dst: torch.Tensor, n: int,
           root: int) -> torch.Tensor:
    """int64 ``[n]`` hop distances from ``root`` over directed edges
    ``src -> dst``, -1 where unreached."""
    labels = torch.full((n,), -1, dtype=torch.int64, device=src.device)
    labels[root] = 0
    level = 0
    while True:
        hit = (labels[src] == level) & (labels[dst] == -1)
        nxt = dst[hit]
        if nxt.numel() == 0:
            return labels
        labels[nxt] = level + 1
        level += 1


def parents(src: torch.Tensor, dst: torch.Tensor, labels: torch.Tensor,
            largest: bool = False) -> torch.Tensor:
    """int64 ``[n]``: per vertex at depth >= 1 the smallest-id (``largest``:
    the largest-id) in-neighbour one level up; -1 elsewhere.  Any of them
    makes a valid BFS tree; the program promises the smallest."""
    n = labels.numel()
    cand = (labels[src] == labels[dst] - 1) & (labels[dst] > 0)
    if largest:
        out = torch.full((n,), -1, dtype=torch.int64, device=src.device)
        return out.scatter_reduce(0, dst[cand], src[cand], "amax")
    out = torch.full((n,), _NONE, dtype=torch.int64, device=src.device)
    out = out.scatter_reduce(0, dst[cand], src[cand], "amin")
    return torch.where(out == _NONE, -1, out)
