"""The numbers that decide ``correct`` where answers are floats."""

from __future__ import annotations

import statistics

import torch


def rel_gap(got: float, want: float) -> float:
    """``|got - want| / |want|``."""
    return abs(got - want) / abs(want)


def leaf_norms(leaves) -> list:
    """The float64 Frobenius norm of each tensor of a list of
    ``{"w", "b"}`` dicts, in order."""
    return [float(torch.linalg.vector_norm(v.to(torch.float64)))
            for p in leaves for v in p.values()]


def worst_norm_gap(got: list, want: list, keep: list) -> float:
    """The worst leaf's gap between two norms, ``|got - want|``, over the
    larger of ``want`` and the median leaf's ``want``: leaves with ``keep``
    False are left out."""
    kept = [w for w, k in zip(want, keep) if k]
    median = statistics.median(kept)
    return max(abs(g - w) / max(w, median)
               for g, w, k in zip(got, want, keep) if k)


def moving_leaves(ref_grads: list, share: float = 1e-3) -> list:
    """Which leaves count: those whose reference gradient norm is at least
    ``share`` of the median leaf's (a leaf the loss barely depends on moves
    under the optimizer by round-off alone)."""
    median = statistics.median(ref_grads)
    return [g >= share * median for g in ref_grads]
