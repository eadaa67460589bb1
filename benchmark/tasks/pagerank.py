"""PageRank as a query: ``pagerank(g, variant, damping, tol_rel,
max_iter)`` with the workload's parameters, repeated.  The cell runs a
fixed 20 rounds (``max_iter`` 20, the GAP benchmark suite's cap; a
negative ``tol_rel``, so that no vertex ever freezes): under the port's
default stopping rule the rounds a query takes depend on the graph, and
so on the seed (2x between seeds); with ``tol_rel`` 0 a vertex whose
float32 rank repeats exactly freezes while the float64 reference's moves
on, and sound runs read up to 2.3% apart at one vertex.

Checked: the sampled queries' ranks against the float64 reference with the
program's stopping rule (``reference/pagerank.py``): the L1 gap over the
L1 norm (``rank_l1_rel``), which a lower precision moves, and the worst
vertex's relative gap (``rank_max_rel``), which one wrong rank moves."""

from __future__ import annotations

import torch

from benchmark.reference import pagerank as ref
from benchmark.reference.graph import both_directions
from benchmark.tasks import _graph


def setup(inputs, cell, spans, device) -> dict:
    from mini_tpu_torch.algorithms import pagerank

    g = _graph.build(inputs, spans, device, inputs["weights"],
                     cell.config["undirected"])
    with spans("warmup"):
        pagerank(g, **_params(cell))
    return {"g": g, "params": _params(cell)}


def _params(cell) -> dict:
    w = cell.workload
    return {k: w[k] for k in ("variant", "damping", "tol_rel", "max_iter")}


def args(inputs, cell) -> list:
    return [None]


def call(state, _arg):
    from mini_tpu_torch.algorithms import pagerank

    return pagerank(state["g"], **state["params"])


def rounds(res) -> int:
    return int(res.num_iterations)


def keep(res):
    return res.ranks


def release(state) -> None:
    state.clear()


def shapes(inputs, cell, state) -> dict:
    g = state["g"]
    return dict(n=g.n, m=g.m)


def _reference(inputs, cell, **kw):
    params = _params(cell)
    if params.pop("variant") != "standard":
        raise ValueError("the reference computes the standard variant")
    src, dst = both_directions(inputs["src"], inputs["dst"],
                               cell.config["undirected"])
    return ref.pagerank(src, dst, inputs["n"], **params, **kw)[0]


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    got = got[: want.numel()].to(torch.float64)
    diff = (got - want).abs()
    return {"rank_l1_rel": float(diff.sum() / want.abs().sum()),
            "rank_max_rel": float((diff / want.abs()).max())}


def check(inputs, cell, kept) -> dict:
    if not kept:
        return {}
    want = _reference(inputs, cell)
    worst: dict = {}
    for _, ranks in kept:
        for k, v in compare(ranks, want).items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def control(inputs, cell, roots=None) -> dict:
    """The control: the reference with bfloat16 vectors and float32 sums
    in the program's place."""
    low = _reference(inputs, cell, dtype=torch.bfloat16,
                     acc_dtype=torch.float32)
    return compare(low, _reference(inputs, cell))


def work(inputs, cell, queries) -> tuple[float, float]:
    """(bytes, operations) of ``queries`` (``[(None, rounds)]``): a round
    reads each edge's 4-byte source id and its source's 4-byte share once,
    reads each vertex's 4-byte offset and rank and writes its rank; one
    multiply-add an edge."""
    n = inputs["n"]
    m = inputs["src"].numel() * (2 if cell.config["undirected"] else 1)
    r = sum(rounds for _, rounds in queries)
    return r * (8.0 * m + 12.0 * n), r * 2.0 * m
