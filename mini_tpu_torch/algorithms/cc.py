"""Connected components (beyond gunrock/mini's primitives; built from the
same engine).

Min-label propagation with pointer jumping: each round every vertex takes
the least label among itself and its in- and out-neighbors (two launches of
the segment-reduce kernel's int32 ``min``, one per edge order), then
shortens chains by two ``label[label]`` hops (n-sized gathers).  On a
directed graph this gives the weakly connected components.  The loop runs
on the host with one device-to-host read a round, whether a label changed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.engine import (
    dst_vals_to_csr,
    reduce_csc_by_dst,
    reduce_csr_by_src,
    src_vals_to_csc,
)

_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class CCResult:
    components: torch.Tensor  # int32[n_pad]: min vertex id in the component
    num_components: int  # over real vertices
    num_iterations: int


def connected_components(
    g: GraphSlice, max_iter: int | None = None
) -> CCResult:
    """Components of ``g`` on its device, in at most ``max_iter`` rounds
    (default ``max(32, ceil(log2 n) + 8)``, ``mini_tpu``'s)."""
    if max_iter is None:
        max_iter = max(32, int(np.ceil(np.log2(max(g.n, 2)))) + 8)
    ids = torch.arange(g.n_pad, dtype=torch.int32, device=g.device)
    labels = ids
    it, changed = 0, True
    while changed and it < max_iter:
        nb_in = reduce_csc_by_dst(g, torch.where(
            g.edge_mask_csc, src_vals_to_csc(g, labels), _INT_MAX), "min")
        nb_out = reduce_csr_by_src(g, torch.where(
            g.edge_mask, dst_vals_to_csr(g, labels), _INT_MAX), "min")
        new = torch.minimum(labels, torch.minimum(nb_in, nb_out))
        new = torch.index_select(new, 0, new)  # pointer jumping
        new = torch.index_select(new, 0, new)
        changed = bool((new != labels).any())  # the round's one read
        labels = new
        it += 1
    num = int(((labels == ids) & g.vertex_mask()).sum())
    return CCResult(labels, num, it)


def cc_cpu(hg: HostGraph) -> np.ndarray:
    """Union-find oracle; component id = min vertex id."""
    parent = np.arange(hg.n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for u, v in zip(hg.csr_srcs, hg.csr_dsts):
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(v) for v in range(hg.n)], dtype=np.int32)
