"""Single-source shortest paths and minimum-id parents, edge by edge.

The program's guarantee (``mini_tpu_torch.algorithms.sssp``): ``dists[v]``
is the least sum of edge weights over the paths from the root (inf where
unreached), ``preds[v]`` the smallest-id vertex ``u`` with an edge ``(u,
v)`` of weight ``w`` and ``dists[u] + w == dists[v]`` (-1 for the root and
the unreached).  Here each round relaxes every edge at once with a
``scatter_reduce`` ``amin``, until no distance falls.  The weights are
integers and every sum stays below 2**24, so float32 sums are exact and
float64 ones equal them.
"""

from __future__ import annotations

import torch

_NONE = torch.iinfo(torch.int64).max


def distances(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              n: int, root: int) -> torch.Tensor:
    """float64 ``[n]`` shortest-path distances from ``root`` over directed
    edges ``src -> dst`` of weights ``w``, inf where unreached."""
    w = w.to(torch.float64)
    dist = torch.full((n,), float("inf"), dtype=torch.float64,
                      device=src.device)
    dist[root] = 0.0
    while True:
        new = dist.scatter_reduce(0, dst, dist[src] + w, "amin")
        if bool((new == dist).all()):
            return dist
        dist = new


def parents(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
            dist: torch.Tensor, root: int) -> torch.Tensor:
    """int64 ``[n]``: per reached vertex but the root the smallest-id
    in-neighbour ``u`` with ``dist[u] + w == dist[v]``; -1 elsewhere."""
    n = dist.numel()
    cand = (dist[src] + w.to(torch.float64) == dist[dst]) & torch.isfinite(
        dist[dst])
    out = torch.full((n,), _NONE, dtype=torch.int64, device=src.device)
    out = out.scatter_reduce(0, dst[cand], src[cand], "amin")
    out[root] = _NONE
    return torch.where(out == _NONE, -1, out)
