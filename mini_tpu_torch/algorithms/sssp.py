"""Single-source shortest paths: frontier Bellman-Ford and delta-stepping.

gunrock's recipe (`sssp/sssp_enactor.hxx:40-72`): advance relaxes
``dist[dst] = atomicMin(dist[dst], dist[src] + w)``, then a filter drops
holes and duplicates, until the frontier empties.  As in ``mini_tpu``, each
round takes one of two forms, chosen on the host from counts it reads once
before the round (the frontier's size and out-edge total, and whether work
is left, in one transfer):

* the sparse tier (``ops/sparse.py``): the compact frontier's out-edges in a
  bounded slot array, relaxed by an ``amin`` scatter;
* the dense sweep: ``dist`` gathered by every edge's source in CSC order,
  plus its weight, reduced per dst by the segment-reduce kernel's float32
  ``min``.

float32 ``min`` is exact and order-free, so the distances have the same bits
whichever form ran, and the same as the Dijkstra oracle's.  Predecessors
are the minimum-id parent among the distance-minimizing edges (the kernel's
int32 ``min``), in place of gunrock's benign-race write
(`sssp/sssp_functor.hxx:30-33`).

``variant="delta"`` is delta-stepping (Meyer & Sanders) on the same tiers,
with ``mini_tpu``'s bucket rule kept in float32 on the device and its
compact-chained reentry rounds (``ops/sparse.relax_and_chain``), so the
round counters equal ``mini_tpu``'s.

While a profiler runs, a search is the span ``sssp.query``; inside it
each round's read is ``loop.read``, its launches ``sssp.round.<kind>``
(``dense``, ``sparse`` or ``chained``, as the counters count them) and
the predecessor pass ``sssp.preds``.
"""

from __future__ import annotations

import dataclasses
import heapq
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
from mini_tpu_torch.ops.engine import reduce_csc_by_dst
from mini_tpu_torch.ops.sparse import (
    compact_frontier,
    default_chain_cap,
    default_tiers,
    frontier_edge_count,
    relax,
    relax_and_chain,
)
from mini_tpu_torch.utils.profiling import annotate, scope

_INT_MAX = 2**31 - 1
# mean out-degree below which ``variant="auto"`` picks delta-stepping
# (``mini_tpu``'s threshold: the low-degree mesh and road families)
_AUTO_DEGREE_THRESHOLD = 8.0


@dataclasses.dataclass(frozen=True)
class SsspResult:
    """``sssp_batch``'s result has a leading ``[len(srcs)]`` axis on every
    field: the counters as int32 tensors, the flag as a bool tensor."""

    dists: torch.Tensor  # float32[n_pad], inf = unreachable
    preds: torch.Tensor  # int32[n_pad], -1 for src/unreached
    num_iterations: int
    num_sparse_iterations: int
    sparse_overflowed: bool  # any sparse tier dropped work (stays False:
    # a tier runs only when the frontier fits it)
    num_chained_iterations: int = 0  # delta rounds that rode the chain


def _start(g: GraphSlice, src: int):
    dist = torch.full((g.n_pad,), float("inf"), dtype=torch.float32,
                      device=g.device)
    dist[src] = 0.0
    frontier = torch.zeros(g.n_pad, dtype=torch.bool, device=g.device)
    frontier[src] = True
    return dist, frontier


def _dense_relax(g: GraphSlice, dist: torch.Tensor) -> torch.Tensor:
    """Per dst, the min over its in-edges of ``dist[src] + w``: one gather
    and one float32 ``min`` launch of the segment-reduce kernel."""
    cand = torch.index_select(dist, 0, g.csc_srcs) + g.csc_weights
    return reduce_csc_by_dst(
        g, torch.where(g.edge_mask_csc, cand, float("inf")), "min")


@annotate("sssp.query")
def _bellman(g, src, max_iter, capv, cape, with_preds):
    dist, frontier = _start(g, src)
    tiers = default_tiers(g, capv, cape) if cape > 1 else []
    ovf = torch.zeros((), dtype=torch.bool, device=g.device)
    it = sparses = 0
    while it < max_iter:
        fe, fl = _read(frontier_edge_count(g, frontier),
                       frontier.sum(dtype=torch.int32))
        if fl == 0:
            break
        tier = _tier(tiers, fe, fl)
        if tier is None:
            with scope("sssp.round.dense"):
                best = _dense_relax(g, dist)
                frontier = best < dist
                dist = torch.minimum(dist, best)
        else:
            with scope("sssp.round.sparse"):
                idx, cnt, v_ovf = compact_frontier(frontier, tier[0])
                d2, e_ovf = relax(g, dist, idx, cnt, tier[1])
                frontier = d2 < dist
                dist = d2
                ovf = ovf | v_ovf | e_ovf
            sparses += 1
        it += 1
    return _finish(g, dist, src, it, sparses, ovf, with_preds)


@annotate("sssp.query")
def _delta(g, src, max_iter, capv, cape, delta, with_preds, chain_cap):
    """Delta-stepping: the pending set (improved, not yet relaxed) is worked
    off in buckets ``dist < B``; ``B`` moves to the next pending bucket's
    edge when the bucket drains.  A reentry round whose frontier was derived
    by the round before (``relax_and_chain``) rides the chain: its pending
    bitmap is kept by two bounded scatters.  Bucket edges and chain
    overflows take the bitmap round."""
    n_pad, dev = g.n_pad, g.device
    dist, pending = _start(g, src)
    tiers = default_tiers(g, capv, cape) if cape > 1 else []
    ccap = int(chain_cap) if tiers else 0
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    dlt = torch.tensor(delta, dtype=torch.float32, device=dev)
    B = dlt
    no_chain = (torch.zeros(max(ccap, 1), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    nidx, ncnt, nok = no_chain
    chain_slots = torch.arange(ccap, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    it = sparses = chained = 0
    while it < max_iter:
        # The bitmap round's bucket and counts, made every round so that one
        # read decides the round; a chained round leaves them unused.  A
        # drained bucket moves B to the next pending bucket's edge, in
        # float32, and strictly past the least pending dist.
        active = pending & (dist < B)
        min_pend = torch.where(pending, dist, inf).min()
        b_next = torch.maximum((torch.floor(min_pend / dlt) + 1.0) * dlt,
                               torch.nextafter(min_pend, inf))
        b_round = torch.where(active.any(), B, b_next)
        active = pending & (dist < b_round)
        more, chain, fe, fl = _read(pending.any(), nok,
                                    frontier_edge_count(g, active),
                                    active.sum(dtype=torch.int32))
        if not more:
            break
        if chain:
            with scope("sssp.round.chained"):
                d2, sdst, imp_first, cidx, ccnt, cfe, cok, e_ovf = \
                    relax_and_chain(g, dist, g.csr_weights, nidx, ncnt,
                                    ccap, ccap, bound=B)
                # the expanded actives leave pending, then the improved
                # dsts (re)enter: an active improved again stays pending
                ext = torch.cat([pending, pending.new_zeros(1)])
                ext[torch.where(chain_slots < ncnt, nidx,
                                n_pad).long()] = False
                ext[torch.where(imp_first, sdst, n_pad).long()] = True
                pending, dist = ext[:n_pad], d2
                nidx, ncnt, nok = cidx, ccnt, cok & (cfe <= ccap)
                ovf = ovf | e_ovf
            sparses += 1
            chained += 1
        else:
            B = b_round
            nidx, ncnt, nok = no_chain
            tier = _tier(tiers, fe, fl)
            if tier is None:
                with scope("sssp.round.dense"):
                    d2 = torch.minimum(
                        dist, _dense_relax(g, torch.where(active, dist, inf)))
            else:
                with scope("sssp.round.sparse"):
                    idx, cnt, v_ovf = compact_frontier(active, tier[0])
                    if ccap == 0:
                        d2, e_ovf = relax(g, dist, idx, cnt, tier[1])
                    else:
                        d2, _, _, nidx, ncnt, cfe, cok, e_ovf = \
                            relax_and_chain(g, dist, g.csr_weights, idx, cnt,
                                            tier[1], ccap, bound=B)
                        nok = cok & (cfe <= ccap)
                    ovf = ovf | v_ovf | e_ovf
                sparses += 1
            # the bucket's settled vertices leave pending; improvements
            # (re)enter, into this bucket or a later one
            pending = (pending & ~active) | (d2 < dist)
            dist = d2
        it += 1
    return _finish(g, dist, src, it, sparses, ovf, with_preds, chained)


def _finish(g, dist, src, it, sparses, ovf, with_preds, chained=0):
    if not with_preds:  # distances only: no post-pass
        preds = torch.full((g.n_pad,), -1, dtype=torch.int32, device=g.device)
        return SsspResult(dist, preds, it, sparses, bool(ovf), chained)
    return SsspResult(dist, _preds(g, dist, src), it, sparses, bool(ovf),
                      chained)


@annotate("sssp.preds")
def _preds(g, dist, src):
    """int32 ``[n_pad]``: ``pred[v] = min{u : dist[u] + w == dist[v]}``,
    the float32 sum recomputed as the relax computed it; -1 for ``src``
    and the unreached."""
    d_src = torch.index_select(dist, 0, g.csc_srcs)
    d_dst = torch.index_select(dist, 0, g.csc_dsts)
    ok = ((d_src + g.csc_weights == d_dst) & torch.isfinite(d_dst)
          & g.edge_mask_csc)
    pred_min = reduce_csc_by_dst(
        g, torch.where(ok, g.csc_srcs, _INT_MAX), "min")
    preds = torch.where(torch.isfinite(dist) & (pred_min != _INT_MAX),
                        pred_min, -1).to(torch.int32)
    preds[src] = -1
    return preds


def _default_delta(g: GraphSlice) -> float:
    """Default bucket width: a degree-keyed multiple of the mean edge
    weight (64x below mean degree 4.5, 4x below 8, else 16x), the numpy
    float32 mean of the real weights, as ``mini_tpu`` computes it, so the
    buckets and round counts are its own."""
    w = g.csc_weights.cpu().numpy()
    mask = g.edge_mask_csc.cpu().numpy()
    if not mask.any():
        return 1.0
    deg = _mean_degree(g)
    mult = 64.0 if deg < 4.5 else (4.0 if deg < 8.0 else 16.0)
    return float(max(mult * w[mask].mean(), 1e-6))


def _auto_variant(g: GraphSlice) -> str:
    """``delta`` for a mean out-degree below ``_AUTO_DEGREE_THRESHOLD``
    (grids, road networks, meshes), else ``bellman``."""
    return "delta" if _mean_degree(g) < _AUTO_DEGREE_THRESHOLD else "bellman"


def _plan(g, max_iter, sparse_capv, sparse_cape, sync_cape, variant, delta,
          chain_cap):
    """Check the arguments, fill in ``mini_tpu``'s defaults and return the
    run of one source, ``run(src, with_preds)``."""
    check_caps(max_iter=max_iter, sparse_capv=sparse_capv,
               sparse_cape=sparse_cape, sync_cape=sync_cape,
               chain_cap=chain_cap)
    if delta is not None and (isinstance(delta, bool)
                              or not isinstance(delta, numbers.Real)):
        raise TypeError(f"delta must be a real number or None, got "
                        f"{type(delta).__name__}")
    if max_iter is None:
        max_iter = g.n_pad  # Bellman-Ford converges in <= n - 1 rounds
    if sparse_capv is None:
        sparse_capv = min(g.n_pad, max(2048, g.m_pad // 64))
    if sparse_cape is None:
        sparse_cape = min(g.m_pad, max(2048, g.m_pad // 64))
    if variant == "auto":
        variant = _auto_variant(g)
    if variant == "delta":
        delta = _default_delta(g) if delta is None else float(delta)
        if chain_cap is None:
            chain_cap = default_chain_cap(g, sparse_cape)
        return lambda s, wp: _delta(g, s, max_iter, sparse_capv, sparse_cape,
                                    delta, wp, chain_cap)
    if variant != "bellman":
        raise ValueError(f"unknown variant {variant!r}")
    return lambda s, wp: _bellman(g, s, max_iter, sparse_capv, sparse_cape,
                                  wp)


def sssp(
    g: GraphSlice,
    src: int,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    sync_cape: int | None = None,
    variant: str = "bellman",
    delta: float | None = None,
    with_preds: bool = True,
    chain_cap: int | None = None,
) -> SsspResult:
    """SSSP from ``src`` on ``g``'s device, with ``mini_tpu.algorithms.
    sssp.sssp``'s parameters in its order.  ``variant``: ``bellman``,
    ``delta`` (bucket width ``delta``, default :func:`_default_delta`) or
    ``auto`` (:func:`_auto_variant`).  ``sparse_capv``/``sparse_cape`` size
    the sparse tier (0 disables it), ``chain_cap`` the chained rounds of
    ``delta`` (0 disables chaining).  ``sync_cape`` sizes a cache that
    ``mini_tpu`` keeps to avoid a TPU sort; a gather needs none, so it is
    checked and changes nothing.  ``with_preds=False`` skips the pred
    post-pass (preds all -1)."""
    run = _plan(g, max_iter, sparse_capv, sparse_cape, sync_cape, variant,
                delta, chain_cap)
    return run(int(src), bool(with_preds))


def sssp_batch(
    g: GraphSlice,
    srcs,
    max_iter: int | None = None,
    sparse_capv: int | None = None,
    sparse_cape: int | None = None,
    sync_cape: int | None = None,
    variant: str = "bellman",
    delta: float | None = None,
    with_preds: bool = True,
    chain_cap: int | None = None,
) -> SsspResult:
    """:func:`sssp` from each of ``srcs``, in a loop on the host; every
    field gains a leading ``[len(srcs)]`` axis, each row bitwise
    :func:`sssp`'s."""
    run = _plan(g, max_iter, sparse_capv, sparse_cape, sync_cape, variant,
                delta, chain_cap)
    runs = [run(s, bool(with_preds))
            for s in torch.as_tensor(srcs).reshape(-1).tolist()]
    return stack_results(SsspResult, runs, g.device)


def sssp_cpu(hg: HostGraph, src: int) -> tuple[np.ndarray, np.ndarray]:
    """NumPy/heapq oracle: Dijkstra in float32.  Relaxations compute
    ``dist[u] + w`` in float32 as the device does, so the distances are
    bitwise comparable."""
    dist = np.full(hg.n, np.inf, dtype=np.float32)
    preds = np.full(hg.n, -1, dtype=np.int64)
    dist[src] = 0.0
    pq = [(np.float32(0.0), src)]
    done = np.zeros(hg.n, dtype=bool)
    while pq:
        d, u = heapq.heappop(pq)
        if done[u]:
            continue
        done[u] = True
        for e in range(hg.row_offsets[u], hg.row_offsets[u + 1]):
            v = hg.csr_dsts[e]
            nd = np.float32(dist[u] + hg.csr_weights[e])
            if nd < dist[v]:
                dist[v] = nd
                preds[v] = u
                heapq.heappush(pq, (nd, int(v)))
    return dist, preds


def validate_pred_tree(
    dists: np.ndarray, preds: np.ndarray, hg: HostGraph, src: int
) -> bool:
    """preds must form a shortest-path tree: ``dist[v] == dist[pred] + w``
    for some edge (pred, v).  (Shortest paths can tie, so this checks the
    tree rather than comparing with Dijkstra's preds.)"""
    edge_w: dict[tuple[int, int], float] = {}
    for s, d, w in zip(hg.csr_srcs, hg.csr_dsts, hg.csr_weights):
        key = (int(s), int(d))
        edge_w[key] = min(edge_w.get(key, np.inf), float(w))
    for v in range(hg.n):
        if v == src or not np.isfinite(dists[v]):
            continue
        p = int(preds[v])
        if p < 0 or (p, v) not in edge_w:
            return False
        if np.float32(dists[p] + np.float32(edge_w[(p, v)])) != dists[v]:
            return False
    return True
