"""SpMM over the graph slice: the feature-valued generalization of
neighborhood-reduce (gunrock's `neighborhood.hxx:13-70` is the F=1 case),
the aggregation of GNN message passing.

    pull:  out[v, :] = sum_{e=(u,v) in E} w[e] * X[u, :]
    push:  out[u, :] = sum_{e=(u,v) in E} w[e] * X[v, :]

Implementations:

* ``banded`` (the default for a CUDA ``x``): K band gathers of the
  weighted messages (graph/banded.py) folded per destination by the
  ``banded_segment_sum`` kernel (ops/kernels/spmm_banded.py).  On CUDA a
  graph with no banded layout raises; nothing falls back.
* ``xla`` (the name the JAX package gives it): one whole-graph gather and
  a scatter-add in plain torch, the reference path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mini_tpu_torch.graph.banded import BandedLayout, get_layout
from mini_tpu_torch.graph.csr import GraphSlice
from mini_tpu_torch.ops.kernels.spmm_banded import banded_segment_sum
from mini_tpu_torch.ops.segment import segment_reduce


def spmm(
    g: GraphSlice,
    x: torch.Tensor,
    direction: str = "pull",
    weights: Optional[torch.Tensor] = None,
    op: str = "sum",
    impl: str = "auto",
    weights_banded: Optional[Sequence[torch.Tensor]] = None,
    precision: str = "auto",
) -> torch.Tensor:
    """Sparse (adjacency) times dense (features): [n_pad, F] -> [n_pad, F].

    ``weights`` overrides the graph's edge weights; it must be in the edge
    order of the chosen direction (CSC for pull, CSR for push).
    ``weights_banded`` (a K-tuple in the banded layout's order, e.g. from
    ``BandedLayout.permute_to_bands``) skips the per-call reorder.
    ``precision`` (banded only): ``split``/``highest``/``auto`` accumulate
    float32 messages exactly in float32; ``fast`` casts float32 ``x`` to
    bfloat16 before the gather.  The banded result is float32.
    """
    if x.ndim == 1:
        return spmm(
            g, x[:, None], direction=direction, weights=weights, op=op,
            impl=impl, weights_banded=weights_banded, precision=precision,
        )[:, 0]
    if direction not in ("pull", "push"):
        raise ValueError(f"unknown direction {direction!r}")
    if impl == "auto":
        impl = "banded" if (op == "sum" and x.is_cuda) else "xla"
    if impl == "banded":
        if op != "sum":
            raise ValueError(f"impl='banded' sums; op={op!r} needs 'xla'")
        return _spmm_banded(g, x, direction, weights, weights_banded,
                            precision)
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r}")

    if direction == "pull":
        seg, gather_ids = g.csc_dsts, g.csc_srcs
        w = g.csc_weights if weights is None else weights
        mask = g.edge_mask_csc
    else:
        seg, gather_ids = g.csr_srcs, g.csr_dsts
        w = g.csr_weights if weights is None else weights
        mask = g.edge_mask
    msgs = torch.index_select(x, 0, gather_ids) * w[:, None].to(x.dtype)
    return segment_reduce(msgs, seg, g.n_pad, op, mask=mask[:, None])


# -- banded path -------------------------------------------------------------


def _apply_banded(x, layout: BandedLayout, w_list, precision):
    """K band gathers of the weighted messages, then the banded kernel.
    ``w_list``: K per-band weight tensors in the layout's order."""
    dev = layout.dev(x.device)
    if precision == "fast" and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    msgs = []
    for k in range(layout.K):
        lo = k * layout.band_rows
        hi = min(lo + layout.band_rows, layout.n_pad)
        xg = torch.index_select(x[lo:hi], 0, dev["ids"][k])
        msgs.append(xg * w_list[k][:, None].to(x.dtype))
    return banded_segment_sum(
        dev["bounds"], dev["offs2d"], msgs, precision=precision,
        edge_chunk=layout.edge_chunk,
    )


def _spmm_banded(g, x, direction, weights, weights_banded, precision):
    # band height follows the lane-padded float32 row, whatever x's dtype
    # and width: one layout (and the weights pre-banded on it) serves the
    # float32 and bf16 paths and every F up to the next multiple of 128
    F = x.shape[-1]
    row_bytes = ((F + 127) // 128) * 128 * 4
    layout = get_layout(g, direction, row_bytes=row_bytes)
    if layout is None:
        raise ValueError(
            "this GraphSlice has no banded layout (it was not built by "
            "GraphSlice.from_host); use impl='xla'"
        )
    if x.shape[0] != layout.n_pad:
        raise ValueError(f"x has {x.shape[0]} rows, the graph {layout.n_pad}")
    if weights_banded is not None and (
        len(weights_banded) != layout.K
        or any(
            int(w.shape[0]) != len(i)
            for w, i in zip(weights_banded, layout.ids)
        )
    ):
        # pre-banded weights were built for another layout
        weights_banded = None
    if weights_banded is not None:
        w_list = list(weights_banded)
    elif weights is not None:
        mask = g.edge_mask_csc if direction == "pull" else g.edge_mask
        w_list = layout.permute_to_bands(torch.where(mask, weights, 0))
    else:
        w_list = layout.dev(x.device)["weights"]
    if precision == "auto":
        precision = "split"
    return _apply_banded(x, layout, w_list, precision)
