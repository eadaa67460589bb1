"""PageRank by neighborhood reduce (the SpMV shape).

gunrock's recipe (`pr/pr_enactor.hxx:41-79`): ``neighborhood_kernel(pull,
plus)`` sums the in-neighbors' ranks, then a filter applies the update and
keeps the vertices whose rank moved more than ``tol_rel`` of itself
(`pr/pr_functor.hxx:11-17`).  Converged vertices freeze and keep
contributing.  Each round is one launch of the segment-reduce kernel's
float32 ``sum`` (through ``ops/operators.neighborhood_reduce``) and one
device-to-host read, whether any vertex is still active.

Two variants, as in ``mini_tpu``:

* ``mini``: gunrock's semantics, the sum of raw in-neighbor ranks over the
  vertex's own out-degree, ``0.15 + damping * sum / out_degree``, indexed by
  vertex id (gunrock's frontier/segment misalignment after round 0 is a bug,
  not a behavior);
* ``standard``: textbook PageRank, each neighbor contributing
  ``rank / out_degree``, the dangling mass spread evenly.

The kernel sums in another order than ``jax.ops.segment_sum``, so ranks
agree with ``mini_tpu``'s and the oracle's to float32 rounding, not bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.engine import src_vals_to_csc
from mini_tpu_torch.ops.operators import neighborhood_reduce
from mini_tpu_torch.utils.profiling import annotate, scope


@dataclasses.dataclass(frozen=True)
class PageRankResult:
    ranks: torch.Tensor  # float32[n_pad]
    num_iterations: int


@annotate("pagerank.query")
def pagerank(
    g: GraphSlice,
    variant: str = "standard",
    damping: float = 0.85,
    tol_rel: float = 0.001,
    max_iter: int = 100,
) -> PageRankResult:
    """PageRank on ``g``'s device until no vertex moves by more than
    ``tol_rel`` of its rank, or ``max_iter`` rounds.  While a profiler
    runs, the query is the span ``pagerank.query``, and inside it each
    round's read is ``loop.read`` and its launches ``pagerank.round``."""
    if variant not in ("standard", "mini"):
        raise ValueError(f"unknown variant {variant!r}")
    damping, tol_rel, max_iter = float(damping), float(tol_rel), int(max_iter)
    real = g.vertex_mask()
    out_deg = g.out_degrees.to(torch.float32)
    start = 0.15 if variant == "mini" else 1.0 / g.n
    ranks = torch.where(real, start, 0.0).to(torch.float32)
    active = real

    def nbr_sum(vertex_vals):  # gunrock's neighborhood_kernel(pull, plus)
        return neighborhood_reduce(
            g, None, lambda ev: src_vals_to_csc(g, vertex_vals),
            op="sum", direction="pull")

    it = 0
    while it < max_iter:
        with scope("loop.read"):  # the round's one read
            if not bool(active.any()):
                break
        with scope("pagerank.round"):
            if variant == "mini":
                reduced = nbr_sum(torch.where(real, ranks, 0.0))
                new = torch.where(out_deg > 0,
                                  0.15 + damping * reduced / out_deg, 0.15)
                new = torch.where(torch.isfinite(new), new, 0.0)
            else:
                contrib = torch.where(out_deg > 0, ranks / out_deg, 0.0)
                reduced = nbr_sum(contrib)
                dangling = torch.where(real & (out_deg == 0), ranks,
                                       0.0).sum()
                new = (1.0 - damping) / g.n + damping * (reduced
                                                         + dangling / g.n)
            new = torch.where(real, new, 0.0)
            new = torch.where(active, new, ranks)  # converged vertices freeze
            moved = (new - ranks).abs() > tol_rel * ranks.abs()
            ranks, active = new, active & moved & real
        it += 1
    return PageRankResult(ranks, it)


def pagerank_cpu(
    hg: HostGraph,
    variant: str = "standard",
    damping: float = 0.85,
    tol_rel: float = 0.001,
    max_iter: int = 100,
) -> np.ndarray:
    """NumPy oracle of the same iteration in float64 (an edge-list
    bincount, so it runs at rmat16 and beyond; multi-edges count their
    multiplicity)."""
    n = hg.n
    out_deg = hg.out_degrees.astype(np.float64)
    src, dst = hg.csr_srcs, hg.csr_dsts

    def pull_sum(vals: np.ndarray) -> np.ndarray:
        return np.bincount(dst, weights=vals[src], minlength=n)

    ranks = np.full(n, 0.15 if variant == "mini" else 1.0 / n)
    active = np.ones(n, dtype=bool)
    for _ in range(max_iter):
        if not active.any():
            break
        if variant == "mini":
            reduced = pull_sum(ranks)
            new = np.where(
                out_deg > 0, 0.15 + damping * reduced / np.maximum(out_deg, 1),
                0.15,
            )
        else:
            contrib = np.where(out_deg > 0, ranks / np.maximum(out_deg, 1), 0)
            reduced = pull_sum(contrib)
            dangling = ranks[out_deg == 0].sum()
            new = (1 - damping) / n + damping * (reduced + dangling / n)
        new = np.where(active, new, ranks)
        moved = np.abs(new - ranks) > tol_rel * np.abs(ranks)
        ranks, active = new, active & moved
    return ranks.astype(np.float32)
