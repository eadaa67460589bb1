"""L-Spar local-similarity graph sparsification (one-shot pipeline).

gunrock's recipe (`lspar/lspar_enactor.hxx:49-111`): (1) a neighborhood
min-reduce of universal-hash vertex hashes gives each vertex its minwise
hash; (2) an advance writes per-edge ``sim = (minhash[src] ==
minhash[dst])``; (3) moderngpu's ``segmented_sort`` orders each vertex's
adjacency by sim, descending; (4) an advance tags the top ``⌊deg^e⌋``
edges of each vertex; (5) ``transform_compact`` gathers them.

As in ``mini_tpu``: the hashes ``(b + a*i) mod p`` and the thresholds
``⌊deg^e⌋`` are made on the host with NumPy (`lspar/lspar_problem.hxx:
58-99`), so they are ``mini_tpu``'s bit for bit; the minwise hash is one
launch of the segment-reduce kernel's int32 ``min``; and since the sims
are binary, an edge's rank under the stable sort is a prefix count (one
cumsum and gathers by the segment id), so nothing is sorted.  The
selection is a mask over CSR edge ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.engine import (
    dst_vals_to_csr,
    reduce_csr_by_src,
    src_vals_to_csr,
)

_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class LsparResult:
    selected_mask: torch.Tensor  # bool[m_pad] over CSR edge ids
    sims: torch.Tensor  # int32[m_pad]: per-edge minhash similarity (CSR)
    num_selected: torch.Tensor  # int32 scalar


def is_prime(number: int) -> bool:
    """Host-side primality test (gunrock's `lspar/lspar_problem.hxx:80-89`)."""
    if number < 2:
        return False
    if number in (2, 3):
        return True
    if number % 2 == 0 or number % 3 == 0:
        return False
    k = 1
    while 36 * k * k - 12 * k < number:
        if number % (6 * k + 1) == 0 or number % (6 * k - 1) == 0:
            return False
        k += 1
    return True


def _lspar(g: GraphSlice, hashs: torch.Tensor,
           thresholds: torch.Tensor) -> LsparResult:
    emask = g.edge_mask
    # (1) the minwise hash over out-neighbours: one kernel launch
    minwise = reduce_csr_by_src(
        g, torch.where(emask, dst_vals_to_csr(g, hashs), _INT_MAX), "min")
    # (2) per-edge similarity
    sims = (emask & (src_vals_to_csr(g, minwise)
                     == dst_vals_to_csr(g, minwise))).to(torch.int32)
    # (3-5) the stable (src, sim desc) rank as a prefix count: a sim-1 edge
    # ranks by the sim-1 edges before it in its segment, a sim-0 edge after
    # all of its segment's sim-1 edges
    c1 = torch.cumsum(sims, 0, dtype=torch.int32)
    c1_ext = torch.cat([c1.new_zeros(1), c1])
    off = g.row_offsets.long()
    start_c1 = c1_ext[off[:-1]]  # sim-1 edges before each segment
    n1 = c1_ext[off[1:]] - start_c1  # sim-1 edges in each segment
    p1 = (c1 - sims) - src_vals_to_csr(g, start_c1)
    local = (torch.arange(g.m_pad, dtype=torch.int32, device=sims.device)
             - src_vals_to_csr(g, g.row_offsets[:-1]))
    rank = torch.where(sims == 1, p1, src_vals_to_csr(g, n1) + (local - p1))
    selected = (rank < src_vals_to_csr(g, thresholds)) & emask
    return LsparResult(selected_mask=selected, sims=sims,
                       num_selected=selected.sum(dtype=torch.int32))


def lspar(
    g: GraphSlice,
    prime: int = 999983,
    e: float = 0.5,
    seed: int = 0,
) -> LsparResult:
    """Sparsify ``g`` on its device: keep each vertex's top ``⌊deg^e⌋``
    out-edges by minhash similarity.  Raises ``ValueError`` when ``prime``
    is not prime."""
    if not is_prime(prime):
        raise ValueError(f"{prime} is not prime")
    rng = np.random.RandomState(seed)
    a = rng.randint(1, prime)  # `lspar/lspar_problem.hxx:95-99`
    b = rng.randint(0, prime)
    idx = np.arange(g.n_pad, dtype=np.int64)
    hashs = torch.from_numpy(((b + a * idx) % prime).astype(np.int32))
    # the thresholds on the host: a device pow may land an ulp below an
    # exact root and drop the floor by one
    deg = g.out_degrees.cpu().numpy().astype(np.float64)
    thresholds = torch.from_numpy(
        np.floor(np.power(deg, e)).astype(np.int32))
    return _lspar(g, hashs.to(g.device), thresholds.to(g.device))


def lspar_cpu(
    hg: HostGraph, hashs: np.ndarray, e: float
) -> tuple[np.ndarray, int]:
    """NumPy oracle (gunrock ships none; `tests/lspar/test_lspar.cu:37-39`
    prints the count only).  Returns (selected bool[m] over CSR edges,
    count)."""
    minwise = np.full(hg.n, np.iinfo(np.int32).max, dtype=np.int64)
    np.minimum.at(minwise, hg.csr_srcs, hashs[hg.csr_dsts])
    sims = (minwise[hg.csr_srcs] == minwise[hg.csr_dsts]).astype(np.int32)
    thres = np.floor(np.power(hg.out_degrees.astype(np.float64), e)).astype(
        np.int64
    )
    selected = np.zeros(hg.m, dtype=bool)
    for v in range(hg.n):
        lo, hi = hg.row_offsets[v], hg.row_offsets[v + 1]
        seg = np.arange(lo, hi)
        order = seg[np.argsort(-sims[lo:hi], kind="stable")]
        selected[order[: thres[v]]] = True
    return selected, int(selected.sum())
