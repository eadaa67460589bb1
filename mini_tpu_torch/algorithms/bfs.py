"""Breadth-first search.

gunrock's recipe (`bfs/bfs_enactor.hxx:41-117`): per round, advance from
the frontier to unvisited neighbors, stamp their labels, and go on until
the frontier is empty.  As in gunrock, the loop runs on the host with one
device-to-host sync per round (`advance.hxx:43`); each round is one dense
sweep over every edge through the operator layer (``advance`` +
``compute``), whose next-frontier or-reduce is the segment-reduce kernel.

``bfs_batch`` runs the same loop once per source (Graph500's batch of
searches) and stacks the results.

Predecessors: gunrock records *some* improving parent via a benign race
(`bfs/bfs_functor.hxx:30-33`); here, as in ``mini_tpu``, one post-pass
records the minimum-id parent at the minimal depth (the segment-reduce
kernel's ``min``).
"""

from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.engine import (
    dst_vals_to_csc,
    reduce_csc_by_dst,
    src_vals_to_csc,
)
from mini_tpu_torch.ops.frontier import Frontier
from mini_tpu_torch.ops.operators import advance, compute

_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class BfsResult:
    labels: torch.Tensor  # int32[n_pad]: hop distance, -1 unreachable
    preds: torch.Tensor  # int32[n_pad]: min-id parent, -1 for src/unreached
    num_iterations: int  # first round with an empty frontier
    # The JAX package's direction and sparse-tier counters.  This port runs
    # every round as the dense sweep, so they stay 0 / False.  In
    # ``bfs_batch``'s result every field has a leading ``[len(srcs)]`` axis
    # (the counters as int32 tensors, the flag as a bool tensor).
    num_pull_iterations: int = 0
    num_sparse_iterations: int = 0
    sparse_overflowed: bool = False
    num_chained_iterations: int = 0


def check_caps(**caps) -> None:
    """Each cap is an integer >= 0 or None (TypeError, ValueError)."""
    for name, cap in caps.items():
        if cap is None:
            continue
        if isinstance(cap, bool) or not isinstance(cap, numbers.Integral):
            raise TypeError(f"{name} must be an integer or None, got "
                            f"{type(cap).__name__}")
        if cap < 0:
            raise ValueError(f"{name} must be >= 0, got {cap}")


def _check_bfs_args(alpha, max_iter, sparse_capv, sparse_cape, chain_cap):
    if alpha is not None and (isinstance(alpha, bool)
                              or not isinstance(alpha, numbers.Real)):
        raise TypeError(f"alpha must be a real number or None, got "
                        f"{type(alpha).__name__}")
    check_caps(max_iter=max_iter, sparse_capv=sparse_capv,
               sparse_cape=sparse_cape, chain_cap=chain_cap)


def bfs(
    g: GraphSlice,
    src: int,
    alpha: float | None = None,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    chain_cap: int | None = None,
) -> BfsResult:
    """Run BFS from ``src`` on ``g``'s device.  ``num_iterations`` is the
    first ``it`` with no vertex at depth ``it`` (or ``max_iter``, default
    ``n_pad``), as in ``mini_tpu.algorithms.bfs``.

    The parameters are those of ``mini_tpu.algorithms.bfs.bfs``, in its
    order.  ``alpha`` (the push->pull switch threshold) and ``sparse_capv``,
    ``sparse_cape``, ``chain_cap`` (the caps of the compact tiers) choose
    between schedules that give the same labels and preds; this port runs
    every round as the dense sweep, so they are checked (a real number,
    non-negative integers) and change nothing."""
    _check_bfs_args(alpha, max_iter, sparse_capv, sparse_cape, chain_cap)
    return _bfs(g, src, g.n_pad if max_iter is None else max_iter, True)


def _bfs(g: GraphSlice, src: int, max_iter: int, with_preds: bool):
    labels = torch.full((g.n_pad,), -1, dtype=torch.int32, device=g.device)
    labels[src] = 0
    it = 0
    frontier = labels == 0
    while it < max_iter and bool(frontier.any()):  # the round's one sync
        unvisited = dst_vals_to_csc(g, labels == -1)
        nxt, _, _ = advance(
            g, Frontier(frontier), cond=lambda ev: unvisited,
            direction="push",
        )
        labels = compute(nxt, lambda l, d=it + 1: torch.full_like(l, d),
                         labels)
        it += 1
        frontier = labels == it

    if not with_preds:  # depths only: no post-pass
        return BfsResult(labels, torch.full_like(labels, -1), it)
    # pred[v] = min{u : (u,v) in E, labels[u] == labels[v] - 1}
    lab_src_csc = src_vals_to_csc(g, labels)
    lab_dst_csc = dst_vals_to_csc(g, labels)
    cand = (lab_src_csc == lab_dst_csc - 1) & (lab_dst_csc > 0) \
        & g.edge_mask_csc
    pred_min = reduce_csc_by_dst(
        g, torch.where(cand, g.csc_srcs, _INT_MAX), "min"
    )
    preds = torch.where(
        (labels > 0) & (pred_min != _INT_MAX), pred_min, -1
    ).to(torch.int32)
    return BfsResult(labels, preds, it)


def bfs_batch(
    g: GraphSlice,
    srcs,
    alpha: float | None = None,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    with_preds: bool = True,
    chain_cap: int | None = None,
) -> BfsResult:
    """Multi-source BFS (Graph500-style): :func:`bfs` once per source, in a
    loop on the host.  ``labels`` and ``preds`` are ``[len(srcs), n_pad]``
    tensors and the counters int32 tensors of shape ``[len(srcs)]``, each
    row bitwise :func:`bfs`'s.  ``with_preds=False`` skips the pred
    post-pass and fills ``preds`` with -1.  The parameters are
    ``mini_tpu.algorithms.bfs.bfs_batch``'s, in its order; ``alpha`` and
    the caps are checked and change nothing, as in :func:`bfs`."""
    _check_bfs_args(alpha, max_iter, sparse_capv, sparse_cape, chain_cap)
    if max_iter is None:
        max_iter = g.n_pad
    runs = [_bfs(g, s, max_iter, bool(with_preds))
            for s in torch.as_tensor(srcs).reshape(-1).tolist()]
    return stack_results(BfsResult, runs, g.device)


def stack_results(cls, runs, device):
    """One result of ``cls`` from per-source ``runs``: tensors stacked on a
    leading axis, Python counters as int32 (flags as bool) tensors
    ``[len(runs)]`` on ``device``."""
    def stack(vals):
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals)
        dtype = torch.bool if isinstance(vals[0], bool) else torch.int32
        return torch.tensor(vals, dtype=dtype, device=device)

    return cls(**{f.name: stack([getattr(r, f.name) for r in runs])
                  for f in dataclasses.fields(cls)})


def bfs_cpu(hg: HostGraph, src: int) -> np.ndarray:
    """NumPy oracle: level-synchronous BFS (gunrock's queue BFS with label
    relaxation, `bfs/bfs_problem.hxx:52-72`)."""
    labels = np.full(hg.n, -1, dtype=np.int32)
    labels[src] = 0
    frontier = np.zeros(hg.n, dtype=bool)
    frontier[src] = True
    level = 0
    while frontier.any():
        nxt = np.zeros(hg.n, dtype=bool)
        active = frontier[hg.csr_srcs] & (labels[hg.csr_dsts] == -1)
        np.logical_or.at(nxt, hg.csr_dsts[active], True)
        labels[nxt] = level + 1
        frontier = nxt
        level += 1
    return labels


def validate_preds(
    labels: np.ndarray, preds: np.ndarray, hg: HostGraph, src: int
) -> bool:
    """Check the predecessor array encodes a valid BFS tree."""
    adj = set(zip(hg.csr_srcs.tolist(), hg.csr_dsts.tolist()))
    for v in range(hg.n):
        if v == src or labels[v] <= 0:
            continue
        p = int(preds[v])
        if p < 0 or labels[p] != labels[v] - 1 or (p, v) not in adj:
            return False
    return True
