"""Graph500 kernel 1: ``bfs(g, root)`` with the port's defaults, labels and
predecessors, from the configuration's search roots in turn.

Checked: every sampled query's labels and predecessors against the plain
reference from its root (``reference/bfs.py``), exactly: the count of
vertices whose label, and whose predecessor, differ."""

from __future__ import annotations

import torch

from benchmark.reference import bfs as ref
from benchmark.reference.graph import both_directions
from benchmark.tasks import _graph


def setup(inputs, cell, spans, device) -> dict:
    from mini_tpu_torch.algorithms import bfs

    g = _graph.build(inputs, spans, device, inputs["weights"],
                     cell.config["undirected"])
    with spans("warmup"):
        for root in args(inputs, cell):  # every root once: its tiers
            bfs(g, root)
    return {"g": g}


def args(inputs, cell) -> list:
    return inputs["roots"].tolist()


def call(state, root):
    from mini_tpu_torch.algorithms import bfs

    return bfs(state["g"], root)


def rounds(res) -> int:
    return int(res.num_iterations)


def keep(res):
    return res.labels, res.preds


def release(state) -> None:
    state.clear()


def shapes(inputs, cell, state) -> dict:
    g = state["g"]
    return dict(n=g.n, m=g.m)


def _edges(inputs, cell):
    return both_directions(inputs["src"], inputs["dst"],
                           cell.config["undirected"])


def check(inputs, cell, kept) -> dict:
    """``label_mismatches``, ``pred_mismatches`` over the sampled
    queries; empty when no query completed."""
    if not kept:
        return {}
    src, dst = _edges(inputs, cell)
    n = inputs["n"]
    bad_l = bad_p = 0
    for root, (labels, preds) in kept:
        want = ref.levels(src, dst, n, root)
        bad_l += int((labels[:n].to(torch.int64) != want).sum())
        bad_p += int((preds[:n].to(torch.int64)
                      != ref.parents(src, dst, want)).sum())
    return {"label_mismatches": bad_l, "pred_mismatches": bad_p}


def control(inputs, cell, roots) -> dict:
    """The control: the reference's levels with the largest-id parent (a
    valid BFS tree that breaks the smallest-id guarantee) in the
    program's place, from ``roots``."""
    src, dst = _edges(inputs, cell)
    kept = []
    for root in roots:
        want = ref.levels(src, dst, inputs["n"], root)
        kept.append((root, (want, ref.parents(src, dst, want,
                                              largest=True))))
    return check(inputs, cell, kept)


def work(inputs, cell, queries) -> tuple[float, float]:
    """(bytes, operations) the ``queries`` (``[(root, rounds)]``) need:
    each edge of the root's component read once as a 4-byte id, each
    vertex's 4-byte offset read and its 4-byte label and predecessor
    written."""
    src, dst = _edges(inputs, cell)
    n = inputs["n"]
    out_deg = torch.bincount(src, minlength=n)
    comp = {}
    total = 0.0
    for root, _ in queries:
        if root not in comp:
            comp[root] = int(out_deg[ref.levels(src, dst, n, root)
                                     >= 0].sum())
        total += 4.0 * comp[root] + 12.0 * n
    return total, 0.0
