"""PageRank ("standard": each in-neighbour contributes rank / out-degree,
the dangling mass spread evenly) with the program's stopping rule: a
vertex whose rank moved by no more than ``tol_rel`` of itself freezes and
keeps contributing; the iteration ends when none is active or after
``max_iter`` rounds.

``dtype`` holds the vectors, ``acc_dtype`` the per-vertex sums: float64
both for the reference; bfloat16 vectors with float32 sums for the
lower-precision control.
"""

from __future__ import annotations

import torch


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int,
             damping: float = 0.85, tol_rel: float = 1e-3,
             max_iter: int = 100, dtype=torch.float64, acc_dtype=None,
             block: int = 1 << 24) -> tuple[torch.Tensor, int]:
    """``(ranks [n] in dtype, rounds)`` over directed edges ``src -> dst``
    (multi-edges count their multiplicity)."""
    acc_dtype = dtype if acc_dtype is None else acc_dtype
    dev = src.device
    out_deg = torch.bincount(src, minlength=n).to(dtype)
    has_out = out_deg > 0
    ranks = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter and bool(active.any()):
        contrib = torch.where(has_out, ranks / torch.where(has_out, out_deg,
                                                           1), 0)
        summed = torch.zeros(n, dtype=acc_dtype, device=dev)
        for lo in range(0, src.numel(), block):
            s, d = src[lo:lo + block], dst[lo:lo + block]
            summed.index_add_(0, d, contrib[s].to(acc_dtype))
        dangling = ranks[~has_out].to(acc_dtype).sum()
        new = ((1.0 - damping) / n
               + damping * (summed + dangling / n)).to(dtype)
        new = torch.where(active, new, ranks)
        moved = (new - ranks).abs() > tol_rel * ranks.abs()
        ranks, active = new, active & moved
        it += 1
    return ranks, it
