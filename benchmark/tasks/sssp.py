"""Graph500 kernel 2: ``sssp(g, root)`` with the port's defaults (the
``bellman`` variant, with predecessors) over the configuration's integer
edge weights, from its search roots in turn.

Checked: every sampled query's distances and predecessors against the
plain reference from its root (``reference/sssp.py``), exactly: the count
of vertices whose distance, and whose predecessor, differ."""

from __future__ import annotations

import torch

from benchmark.reference import sssp as ref
from benchmark.reference.graph import both_directions
from benchmark.tasks import _graph


def setup(inputs, cell, spans, device) -> dict:
    from mini_tpu_torch.algorithms import sssp

    g = _graph.build(inputs, spans, device, inputs["weights"],
                     cell.config["undirected"])
    with spans("warmup"):
        for root in args(inputs, cell):  # every root once: its tiers
            sssp(g, root)
    return {"g": g}


def args(inputs, cell) -> list:
    return inputs["roots"].tolist()


def call(state, root):
    from mini_tpu_torch.algorithms import sssp

    return sssp(state["g"], root)


def rounds(res) -> int:
    return int(res.num_iterations)


def keep(res):
    return res.dists, res.preds


def release(state) -> None:
    state.clear()


def shapes(inputs, cell, state) -> dict:
    g = state["g"]
    return dict(n=g.n, m=g.m)


def _edges(inputs, cell):
    src, dst = both_directions(inputs["src"], inputs["dst"],
                               cell.config["undirected"])
    w = inputs["weights"]
    if cell.config["undirected"]:
        w = torch.cat([w, w])
    return src, dst, w


def check(inputs, cell, kept) -> dict:
    """``dist_mismatches``, ``pred_mismatches`` over the sampled queries;
    empty when no query completed."""
    if not kept:
        return {}
    src, dst, w = _edges(inputs, cell)
    n = inputs["n"]
    bad_d = bad_p = 0
    for root, (dists, preds) in kept:
        want = ref.distances(src, dst, w, n, root)
        bad_d += int((dists[:n].to(torch.float64) != want).sum())
        bad_p += int((preds[:n].to(torch.int64)
                      != ref.parents(src, dst, w, want, root)).sum())
    return {"dist_mismatches": bad_d, "pred_mismatches": bad_p}


def control(inputs, cell, roots) -> dict:
    """The control: the reference's distances with every weight taken as 1
    (hop counts, the BFS a weighted search must not fall back to) and
    their minimum-id parents in the program's place, from ``roots``."""
    src, dst, w = _edges(inputs, cell)
    ones = torch.ones_like(w)
    kept = []
    for root in roots:
        hops = ref.distances(src, dst, ones, inputs["n"], root)
        kept.append((root, (hops.to(torch.float32),
                            ref.parents(src, dst, ones, hops, root))))
    return check(inputs, cell, kept)

