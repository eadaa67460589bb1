"""Direction-optimal breadth-first search.

gunrock's recipe (`bfs/bfs_enactor.hxx:41-117`): per round, advance from
the frontier to unvisited neighbours and stamp their labels, until the
frontier is empty; switch to a pull round when
``num_unvisited < frontier_len * alpha``.  As in gunrock, the loop runs on
the host with one device-to-host read a round (`advance.hxx:43`), which
brings the round's counts in one transfer; from them the host picks the
round's form, as ``mini_tpu.algorithms.bfs`` picks it on the device, so
the round counters are its own:

* a chained round, when the round before derived this round's frontier
  (``ops/sparse.visit_and_chain``): every term O(``chain_cap``);
* a pull round, on the alpha rule (in float32): the dense sweep, counted
  apart;
* a sparse round, when the frontier fits the capacity tier: the compact
  frontier's out-edges in a bounded slot array (``ops/sparse.py``);
* the dense sweep over every edge through the operator layer
  (``advance`` + ``compute``), whose next-frontier or-reduce is the
  segment-reduce kernel.

Every form stamps the same labels.  ``bfs_batch`` runs the same loop once
per source (Graph500's batch of searches) and stacks the results.

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

from mini_tpu_torch.algorithms._loop import (
    _mean_degree,
    _read,
    _tier,
    check_caps,
    stack_results,
)
from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.engine import (
    dst_vals_to_csc,
    reduce_csc_by_dst,
    src_vals_to_csc,
)
from mini_tpu_torch.ops.frontier import Frontier
from mini_tpu_torch.ops.operators import advance, compute
from mini_tpu_torch.ops.sparse import (
    compact_frontier,
    default_chain_cap,
    default_tiers,
    expand_frontier,
    frontier_edge_count,
    visit_and_chain,
)
from mini_tpu_torch.utils.profiling import annotate, scope

_INT_MAX = 2**31 - 1
# mean out-degree below which the chained rounds are on by default
# (``mini_tpu``'s grid and road-network family)
_CHAIN_DEGREE_THRESHOLD = 5.0


@dataclasses.dataclass(frozen=True)
class BfsResult:
    """``bfs_batch``'s result has a leading ``[len(srcs)]`` axis on every
    field: the counters as int32 tensors, the flag as a bool tensor."""

    labels: torch.Tensor  # int32[n_pad]: hop distance, -1 unreachable
    preds: torch.Tensor  # int32[n_pad]: min-id parent, -1 for src/unreached
    num_iterations: int  # first round with an empty frontier
    num_pull_iterations: int = 0  # rounds run in pull mode
    num_sparse_iterations: int = 0  # rounds on the compact frontier
    sparse_overflowed: bool = False  # any sparse round dropped work (stays
    # False: a tier or the chain runs only when the frontier fits it)
    num_chained_iterations: int = 0  # sparse rounds that rode the chain


# the four round counters, in field order
COUNTERS = tuple(f.name for f in dataclasses.fields(BfsResult)
                 if f.name.startswith("num_"))


def _auto_chain_cap(g: GraphSlice, sparse_cape: int) -> int:
    """The default chain capacity: ``default_chain_cap`` for a mean
    out-degree below ``_CHAIN_DEGREE_THRESHOLD`` (grids, road networks,
    whose wavefronts stay narrow), else 0 (no chaining), as ``mini_tpu``
    chooses it."""
    if _mean_degree(g) < _CHAIN_DEGREE_THRESHOLD:
        return default_chain_cap(g, sparse_cape)
    return 0


def _plan(g, alpha, max_iter, sparse_capv, sparse_cape, chain_cap):
    """Check the arguments, fill in ``mini_tpu``'s defaults and return the
    search from one source, ``run(src, with_preds)``."""
    if alpha is not None and (isinstance(alpha, bool)
                              or not isinstance(alpha, numbers.Real)):
        raise TypeError(f"alpha must be a real number or None, got "
                        f"{type(alpha).__name__}")
    check_caps(max_iter=max_iter, sparse_capv=sparse_capv,
               sparse_cape=sparse_cape, chain_cap=chain_cap)
    if alpha is None:
        alpha = 1.0 / max(g.n, 1)  # gunrock's default, `test_bfs.cu:30`
    if max_iter is None:
        max_iter = g.n_pad
    if sparse_capv is None:
        sparse_capv = min(g.n_pad, max(2048, g.m_pad // 64))
    if sparse_cape is None:
        sparse_cape = min(g.m_pad, max(2048, g.m_pad // 64))
    if chain_cap is None:
        chain_cap = _auto_chain_cap(g, int(sparse_cape))
    tiers = default_tiers(g, sparse_capv, sparse_cape) \
        if sparse_cape > 1 else []
    ccap = int(chain_cap) if tiers else 0
    # the alpha rule in float32, as ``mini_tpu`` evaluates it
    alpha32 = np.float32(alpha)
    return lambda src, with_preds: _bfs(g, int(src), alpha32, int(max_iter),
                                        tiers, ccap, bool(with_preds))


def bfs(
    g: GraphSlice,
    src: int,
    alpha: float | None = None,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    chain_cap: int | None = None,
) -> BfsResult:
    """Run BFS from ``src`` on ``g``'s device, with ``mini_tpu.algorithms.
    bfs.bfs``'s parameters in its order and its defaults.
    ``num_iterations`` is the first ``it`` with no vertex at depth ``it``
    (or ``max_iter``, default ``n_pad``).  ``alpha`` is the push->pull
    threshold (default ``1 / n``); ``sparse_capv``/``sparse_cape`` size the
    sparse tier (a ``sparse_cape`` of 0 or 1 disables it); ``chain_cap``
    sizes the chained rounds (0 disables them; None: :func:`_auto_chain_cap`).
    The labels and preds are the same whichever rounds ran.

    The defaults are ``mini_tpu``'s, so the counters are its own; they are
    not the fastest on an H100.  There the loop is host-bound and a sparse
    or chained round launches more device ops than a dense one, so dense
    rounds only (``sparse_cape=0``) took 0.18-0.39x the defaults' time on
    the rmat16 hub and on ``grid2d(2048, 256)`` (NVIDIA H100 80GB HBM3,
    700 W; ``PERF.md`` section 5, ``chip_smoke.py`` phases 3 and 12b)."""
    run = _plan(g, alpha, max_iter, sparse_capv, sparse_cape, chain_cap)
    return run(src, True)


def _dense_round(g: GraphSlice, labels, frontier, it: int):
    """Every edge swept (push and pull alike): the frontier's unvisited
    out-neighbours, one or-reduce launch, stamped ``it + 1``."""
    unvisited = dst_vals_to_csc(g, labels == -1)
    nxt, _, _ = advance(g, Frontier(frontier), cond=lambda ev: unvisited,
                        direction="push")
    return compute(nxt, lambda l, d=it + 1: torch.full_like(l, d), labels)


def _sparse_round(g: GraphSlice, labels, frontier, it: int, tier):
    """The tier's bounded push: the frontier's out-edges in ``tier[1]``
    slots, their unvisited dsts stamped ``it + 1`` (duplicates write one
    stamp).  ``(labels, overflowed)``."""
    idx, cnt, v_ovf = compact_frontier(frontier, tier[0])
    _, dst, _, valid, total = expand_frontier(g, idx, cnt, tier[1])
    sel = valid & (torch.index_select(labels, 0, dst) == -1)
    ext = torch.cat([labels, labels.new_full((1,), -1)])
    ext[torch.where(sel, dst, g.n_pad).long()] = it + 1
    return ext[: g.n_pad], v_ovf | (total > tier[1])


def _chain_round(g: GraphSlice, labels, idx, cnt, cape: int, ccap: int,
                 it: int):
    """A sparse round that also derives the next round's compact frontier
    (``visit_and_chain``): ``(labels, nidx, ncnt, nok, overflowed)``, with
    ``nok`` (int32) set when the next round can ride the chain."""
    labels, nidx, ncnt, cfe, cok, e_ovf = visit_and_chain(
        g, labels, idx, cnt, cape, ccap, it + 1)
    return labels, nidx, ncnt, (cok & (cfe <= ccap)).int(), e_ovf


@annotate("bfs.query")
def _bfs(g: GraphSlice, src: int, alpha32, max_iter: int, tiers, ccap: int,
         with_preds: bool) -> BfsResult:
    """The search: each round reads its counts once (the frontier's size,
    whether the chain holds it, the overflow flag, with a tier its
    out-edge total), then runs the chained round if the round before
    derived its frontier, else a pull round on the alpha rule, else the
    smallest tier that fits, else the dense sweep.

    While a profiler runs, the search is the span ``bfs.query``, and
    inside it each read is ``loop.read``, the launches of each round
    ``bfs.round.<kind>`` (its kind as the counters count it: ``chained``,
    ``pull``, ``sparse`` or ``dense``) and the predecessor pass
    ``bfs.preds``."""
    dev = g.device
    labels = torch.full((g.n_pad,), -1, dtype=torch.int32, device=dev)
    labels[src] = 0
    no_chain = (torch.zeros(max(ccap, 1), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    nidx, ncnt, nok = no_chain
    ovf = torch.zeros((), dtype=torch.int32, device=dev)
    # the real vertices visited: each is in exactly one round's frontier,
    # so the alpha rule's unvisited count needs no read of its own (a ghost
    # source is no real vertex)
    seen = 0 if src < g.n else -1
    it = pulls = sparses = chained = 0
    while it < max_iter:
        frontier = labels == it
        counts = [frontier.sum(dtype=torch.int32), nok, ovf]
        if tiers:
            counts.append(frontier_edge_count(g, frontier))
        fl, chain, overflowed, *fe = _read(*counts)
        if fl == 0:
            break
        seen += fl
        if chain:
            with scope("bfs.round.chained"):
                labels, nidx, ncnt, nok, e_ovf = _chain_round(
                    g, labels, nidx, ncnt, ccap, ccap, it)
                ovf = ovf | e_ovf
            sparses += 1
            chained += 1
        else:
            nidx, ncnt, nok = no_chain
            pull = bool(np.float32(g.n - seen) < np.float32(fl) * alpha32)
            tier = None if pull or not fe else _tier(tiers, fe[0], fl)
            if tier is None:
                with scope("bfs.round.pull" if pull else "bfs.round.dense"):
                    labels = _dense_round(g, labels, frontier, it)
                pulls += pull
            elif ccap == 0:
                with scope("bfs.round.sparse"):
                    labels, r_ovf = _sparse_round(g, labels, frontier, it,
                                                  tier)
                    ovf = ovf | r_ovf
                sparses += 1
            else:
                with scope("bfs.round.sparse"):
                    idx, cnt, v_ovf = compact_frontier(frontier, tier[0])
                    labels, nidx, ncnt, nok, e_ovf = _chain_round(
                        g, labels, idx, cnt, tier[1], ccap, it)
                    ovf = ovf | v_ovf | e_ovf
                sparses += 1
        it += 1
    else:  # the round cap ended the search: one read of the flag
        overflowed = int(ovf)
    preds = _preds(g, labels) if with_preds else torch.full_like(labels, -1)
    return BfsResult(labels, preds, it, pulls, sparses, bool(overflowed),
                     chained)


@annotate("bfs.preds")
def _preds(g: GraphSlice, labels: torch.Tensor) -> torch.Tensor:
    """pred[v] = min{u : (u,v) in E, labels[u] == labels[v] - 1}: one
    ``min`` launch of the segment-reduce kernel."""
    lab_src_csc = src_vals_to_csc(g, labels)
    lab_dst_csc = dst_vals_to_csc(g, labels)
    cand = (lab_src_csc == lab_dst_csc - 1) & (lab_dst_csc > 0) \
        & g.edge_mask_csc
    pred_min = reduce_csc_by_dst(
        g, torch.where(cand, g.csc_srcs, _INT_MAX), "min"
    )
    return torch.where(
        (labels > 0) & (pred_min != _INT_MAX), pred_min, -1
    ).to(torch.int32)


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
    ``mini_tpu.algorithms.bfs.bfs_batch``'s, in its order, with its
    defaults."""
    run = _plan(g, alpha, max_iter, sparse_capv, sparse_cape, chain_cap)
    runs = [run(s, with_preds)
            for s in torch.as_tensor(srcs).reshape(-1).tolist()]
    return stack_results(BfsResult, runs, g.device)


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
