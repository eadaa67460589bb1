"""SpMM and SDDMM over the graph slice: the feature-valued generalization
of neighborhood-reduce (gunrock's `neighborhood.hxx:13-70` is the F=1
case), the aggregation of GNN message passing and its edge scoring.

    pull:  out[v, :] = sum_{e=(u,v) in E} w[e] * X[u, :]
    push:  out[u, :] = sum_{e=(u,v) in E} w[e] * X[v, :]

SpMM implementations:

* ``banded`` (the default for a CUDA ``x``; ``pallas`` is an alias): K
  band gathers (the ``gather_rows`` kernel, ops/kernels/gather_rows.py) of
  the weighted messages (graph/banded.py) folded per destination by the
  ``banded_segment_sum`` kernel (ops/kernels/spmm_banded.py).
  Differentiable in ``x`` (the backward is the opposite-direction banded
  SpMM) and in the edge weights (the ``banded_sddmm`` kernel: ``dw[e] =
  <go[dst e], x[src e]>``), through one ``torch.autograd.Function``.  On
  CUDA a graph with no banded layout raises; nothing falls back.
  ``heads > 1`` is GAT's blockwise form: x is the head concat ``[n_pad,
  H d]``, the weights ``[m_pad, H]``, and head h's columns are scaled by
  its own weight column, all heads in one set of gathers and one kernel
  launch.
* ``pallas_onehot``: one whole-graph gather, then the contiguous
  ``segment_sum`` kernel (ops/kernels/spmm_kernel.py), the JAX package's
  round-1 route, kept for comparison.  Not differentiable on CUDA.
* ``xla`` (the name the JAX package gives it): one whole-graph gather and
  a scatter-add in plain torch, the reference path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mini_tpu_torch.graph.banded import BandedLayout, get_layout
from mini_tpu_torch.graph.csr import GraphSlice
from mini_tpu_torch.ops.kernels.gather_rows import gather_rows
from mini_tpu_torch.ops.kernels.segreduce_kernel import segment_reduce_bands
from mini_tpu_torch.ops.kernels.spmm_banded import (
    banded_sddmm,
    banded_segment_sum,
)
from mini_tpu_torch.ops.kernels.spmm_kernel import spmm_pallas
from mini_tpu_torch.ops.segment import segment_reduce
from mini_tpu_torch.utils.profiling import scope, scope_of


def spmm(
    g: GraphSlice,
    x: torch.Tensor,
    direction: str = "pull",
    weights: Optional[torch.Tensor] = None,
    op: str = "sum",
    impl: str = "auto",
    weights_banded: Optional[Sequence[torch.Tensor]] = None,
    weights_banded_bwd: Optional[Sequence[torch.Tensor]] = None,
    precision: str = "auto",
    interpret: bool = False,
    heads: int = 1,
) -> torch.Tensor:
    """Sparse (adjacency) times dense (features): [n_pad, F] -> [n_pad, F].

    ``weights`` overrides the graph's edge weights; it must be in the edge
    order of the chosen direction (CSC for pull, CSR for push).
    ``weights_banded`` (a K-tuple in the banded layout's order, e.g. from
    ``BandedLayout.permute_to_bands``) skips the per-call reorder;
    ``weights_banded_bwd`` is the same weights in the opposite direction's
    banded order, which the x-gradient needs (without it, pre-banded
    weights give a forward that raises ``NotImplementedError`` when x's
    gradient is asked for).
    ``precision`` (banded only): ``split``/``highest``/``auto`` accumulate
    float32 messages exactly in float32; ``fast`` casts float32 ``x`` to
    bfloat16 before the gather.  The banded and ``pallas_onehot`` results
    are float32.
    ``interpret`` stands where ``mini_tpu.ops.spmm.spmm`` has it, so the
    same positional arguments mean the same in both packages; it is
    accepted and has no effect here (a CUDA kernel has no interpret mode:
    CPU tensors take the plain versions, CUDA tensors the kernels).

    ``heads > 1`` is the blockwise multi-head form (GAT): x is the head
    concat ``[n_pad, H d]``, the weights ``[m_pad, H]`` (or K pre-banded
    ``[mk, H]`` tensors), and

        out[v, h d:(h+1) d] = sum_e w[e, h] * x[src e, h d:(h+1) d]
    """
    if heads > 1:
        if weights_banded is None and (weights is None
                                       or weights.ndim != 2):
            raise ValueError("heads > 1 needs [m_pad, H] per-head weights")
        if x.ndim != 2 or x.shape[-1] % heads:
            raise ValueError(f"x {tuple(x.shape)} is not {heads} head "
                             "blocks")
        if impl == "pallas_onehot":
            raise ValueError("pallas_onehot takes scalar weights; use "
                             "impl='banded' or 'xla' for heads > 1")
    if x.ndim == 1:
        return spmm(
            g, x[:, None], direction=direction, weights=weights, op=op,
            impl=impl, weights_banded=weights_banded,
            weights_banded_bwd=weights_banded_bwd, precision=precision,
        )[:, 0]
    if direction not in ("pull", "push"):
        raise ValueError(f"unknown direction {direction!r}")
    if impl == "auto":
        impl = "banded" if (op == "sum" and x.is_cuda) else "xla"
    if impl == "pallas":  # the JAX package's alias
        impl = "banded"
    if impl in ("banded", "pallas_onehot") and op != "sum":
        raise ValueError(f"impl={impl!r} sums; op={op!r} needs 'xla'")
    if impl == "banded":
        return _spmm_banded(g, x, direction, weights, weights_banded,
                            weights_banded_bwd, precision, heads)
    if impl not in ("xla", "pallas_onehot"):
        raise ValueError(f"unknown impl {impl!r}")

    if direction == "pull":
        seg, gather_ids, offsets = g.csc_dsts, g.csc_srcs, g.col_offsets
        w = g.csc_weights if weights is None else weights
        mask = g.edge_mask_csc
    else:
        seg, gather_ids, offsets = g.csr_srcs, g.csr_dsts, g.row_offsets
        w = g.csr_weights if weights is None else weights
        mask = g.edge_mask
    if impl == "pallas_onehot":
        # masked like the xla path, so pad edges add nothing even under a
        # weight override (the twin leaves that to the caller)
        return spmm_pallas(offsets, gather_ids, torch.where(mask, w, 0), x,
                           seg_ids=seg)
    msgs = _weigh(torch.index_select(x, 0, gather_ids), w, heads)
    return segment_reduce(msgs, seg, g.n_pad, op, mask=mask[:, None])


# -- banded path -------------------------------------------------------------


def _weigh(xg, w, heads):
    """Messages times their weights: ``[m]`` scalars, or ``[m, H]``
    columns each scaling its head's block of ``xg``'s columns."""
    if heads == 1:
        return xg * w[:, None].to(xg.dtype)
    m, F = xg.shape
    return (xg.reshape(m, heads, F // heads)
            * w[:, :, None].to(xg.dtype)).reshape(m, F)


def _band(x, layout: BandedLayout, k):
    """Band ``k``'s rows of ``x``."""
    lo = k * layout.band_rows
    return x[lo: min(lo + layout.band_rows, layout.n_pad)]


def _gather_bands(x, layout: BandedLayout, precision):
    """The K unweighted band gathers ``x[band k][ids[k]]`` (the
    ``gather_rows`` kernel), in bfloat16 under ``fast``."""
    dev = layout.dev(x.device)
    if precision == "fast" and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    bands = []
    for k in range(layout.K):
        with scope_of("spmm.band_gather_{}", k):
            bands.append(gather_rows(_band(x, layout, k), dev["ids"][k]))
    return bands


def _apply_banded(x, layout: BandedLayout, w_list, precision, heads=1):
    """K band gathers of the weighted messages, then the banded kernel.
    ``w_list``: K per-band weight tensors in the layout's order (``[mk]``,
    or ``[mk, H]`` per-head columns)."""
    bands = _gather_bands(x, layout, precision)
    msgs = [_weigh(xg, w, heads) for xg, w in zip(bands, w_list)]
    dev = layout.dev(x.device)
    with scope("spmm.banded_kernel"):
        return banded_segment_sum(
            dev["bounds"], dev["offs2d"], msgs, precision=precision,
            edge_chunk=layout.edge_chunk, row_prefix=dev["row_prefix"],
        )


def _weight_cotangent(x, go, layout: BandedLayout, precision, heads=1):
    """``dw[slot] = <go[dst], x_band[ids[slot]]>`` for every slot of the
    layout (per head over its column block with ``heads > 1``), by one
    launch of the banded SDDMM kernel; the K per-band ``[mk]`` (or
    ``[mk, H]``) tensors."""
    msgs = _gather_bands(x, layout, precision)
    dev = layout.dev(x.device)
    flat = banded_sddmm(
        dev["bounds"], dev["offs2d"], msgs, go,
        precision="split" if precision == "fast" else precision,
        edge_chunk=layout.edge_chunk, heads=heads, seg=dev["seg"],
    )
    return torch.split(flat, [int(m.shape[0]) for m in msgs])


def banded_heads_segment_sum(
    layout: BandedLayout,
    bands: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Per-segment float32 sums of banded per-slot columns (K ``[mk, H]``
    tensors in this layout's order) -> ``[n_pad, H]``.

    Each band's stream is segment-contiguous (``layout.offsets[k]``), so
    this is the contiguous-segment kernel (ops/kernels/segreduce_kernel.py)
    over the K bands' offsets: one launch for every band and column, the
    bands added in order; JAX runs a segmented scan per band.  Pad slots
    lie past the last segment end and never count."""
    dev = layout.dev(bands[0].device)
    return segment_reduce_bands(dev["offsets"], list(bands), "sum",
                                seg=dev["seg"])


class _BandedSpmm(torch.autograd.Function):
    """The banded SpMM with its backward: d/dx of a pull SpMM is the push
    SpMM of the cotangent with the same per-edge weights (and vice versa),
    d/dw is the banded SDDMM of (cotangent, x).  ``w_b``, the weights in
    the opposite direction's order, never enters the forward value, so it
    gets no gradient.  Inputs: ``x, layout_f, layout_b, precision, K, *w_f,
    *w_b``."""

    @staticmethod
    def forward(ctx, x, layout_f, layout_b, precision, heads, K, *ws):
        ctx.layouts = (layout_f, layout_b)
        ctx.precision = precision
        ctx.heads = heads
        ctx.K = K
        ctx.w_dtype = ws[0].dtype
        # x, not its band gathers: those are the size of the edge stream
        ctx.save_for_backward(x, *ws[K:])
        return _apply_banded(x, layout_f, ws[:K], precision, heads)

    @staticmethod
    def backward(ctx, go):
        x, *w_b = ctx.saved_tensors
        layout_f, layout_b = ctx.layouts
        K = ctx.K
        need_x = ctx.needs_input_grad[0]
        need_w = any(ctx.needs_input_grad[6:6 + K])
        gx = None
        if need_x:
            if layout_b is None:
                raise NotImplementedError(
                    "backward banded SpMM needs the opposite-direction "
                    "layout: pass weights_banded_bwd with weights_banded"
                )
            gx = _apply_banded(go, layout_b, w_b, ctx.precision,
                               ctx.heads).to(x.dtype)
        dw_f = [None] * K
        if need_w:  # GCN's weights are constants: no SDDMM there
            dw_f = [d.to(ctx.w_dtype) for d in _weight_cotangent(
                x, go, layout_f, ctx.precision, ctx.heads)]
        return (gx, None, None, None, None, None, *dw_f,
                *[None] * len(w_b))


def _other_order(g: GraphSlice, direction: str, w: torch.Tensor):
    """Per-edge values of ``direction``'s edge order in the opposite
    order: a gather by the static CSR <-> CSC rank."""
    if direction == "pull":  # CSC -> CSR: w_csr[e] = w_csc[rank[e]]
        return w[g.csr_to_csc_rank.long()]
    # CSR -> CSC by csc_eids; its pad slots all read the last pad edge,
    # whose value is masked to 0 like theirs
    return w[g.csc_eids.long()]


def _spmm_banded(g, x, direction, weights, weights_banded,
                 weights_banded_bwd, precision, heads=1):
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
    opposite = "push" if direction == "pull" else "pull"
    layout_b = get_layout(g, opposite, row_bytes=row_bytes)
    if weights_banded is not None and (
        len(weights_banded) != layout.K
        or any(
            int(w.shape[0]) != len(i)
            for w, i in zip(weights_banded, layout.ids)
        )
    ):
        # pre-banded weights were built for another layout
        weights_banded = weights_banded_bwd = None
    if weights_banded is not None:
        w_f = list(weights_banded)
        if weights_banded_bwd is not None:
            w_b = list(weights_banded_bwd)
        else:  # the backward order of pre-banded weights is unknown
            w_b, layout_b = [], None
    elif weights is not None:
        # [m] or [m, H] weights: permute_to_bands takes H columns in one
        # permutation launch
        mask = g.edge_mask_csc if direction == "pull" else g.edge_mask
        w = torch.where(mask if heads == 1 else mask[:, None], weights, 0)
        w_f = layout.permute_to_bands(w)
        w_b = layout_b.permute_to_bands(_other_order(g, direction, w))
    else:
        w_f = layout.dev(x.device)["weights"]
        w_b = layout_b.dev(x.device)["weights"]
    if precision == "auto":
        precision = "split"
    return _BandedSpmm.apply(x, layout, layout_b, precision, heads, len(w_f),
                             *w_f, *w_b)


# -- SDDMM -------------------------------------------------------------------


def sddmm(
    g: GraphSlice,
    xl: torch.Tensor,
    xr: Optional[torch.Tensor] = None,
    order: str = "csr",
    impl: str = "auto",
    precision: str = "split",
    interpret: bool = False,
) -> torch.Tensor:
    """Sampled dense-dense product: per-edge ``<xl[src], xr[dst]>`` over
    the sparsity pattern, the shape of L-Spar's per-edge similarity step
    (`lspar/lspar_functor.hxx:28-33`) and of GNN edge scoring.  Returns
    float ``[m_pad]`` in the requested edge order (``csr`` or ``csc``),
    masked edges 0.

    ``impl="banded"`` (the default for CUDA tensors) gathers one side per
    band of the ``order``'s layout and runs the ``banded_sddmm`` kernel
    against the other side's rows, then one gather back to edge order.
    ``xla`` is two whole-graph gathers and a row sum in plain torch.
    ``interpret`` is accepted for ``mini_tpu.ops.spmm.sddmm``'s argument
    list and has no effect here.
    """
    xr = xl if xr is None else xr
    if order not in ("csr", "csc"):
        raise ValueError(f"unknown order {order!r}")
    if impl == "auto":
        impl = ("banded" if xl.is_cuda and xl.ndim == 2
                and xl.shape == xr.shape else "xla")
    if impl == "banded":
        return _sddmm_banded(g, xl, xr, order, precision)
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r}")
    if order == "csr":
        src, dst, mask = g.csr_srcs, g.csr_dsts, g.edge_mask
    else:
        src, dst, mask = g.csc_srcs, g.csc_dsts, g.edge_mask_csc
    a, b = xl[src.long()], xr[dst.long()]
    vals = a * b if xl.ndim == 1 else (a * b).sum(-1)
    return torch.where(mask, vals, 0)


def _sddmm_banded(g, xl, xr, order, precision):
    """The ``order``'s layout has that edge order as its base order, so one
    ``permute_from_bands`` finishes.  pull layout (CSC base): messages
    gather ``xl`` by source band, the kernel's rows are ``xr`` by dst; push
    layout (CSR base): messages gather ``xr`` by dst band, rows are ``xl``
    by src.  Both compute ``<xl[src e], xr[dst e]>``.  The kernel takes any
    F; the layout is the one a lane-padded row picks, as for the SpMM."""
    if xl.ndim != 2 or xl.shape != xr.shape:
        raise ValueError("impl='banded' needs xl and xr of one [n_pad, F] "
                         "shape")
    direction = "pull" if order == "csc" else "push"
    row_bytes = ((xl.shape[-1] + 127) // 128) * 128 * 4
    layout = get_layout(g, direction, row_bytes=row_bytes)
    if layout is None:
        raise ValueError(
            "this GraphSlice has no banded layout (it was not built by "
            "GraphSlice.from_host); use impl='xla'"
        )
    if xl.shape[0] != layout.n_pad:
        raise ValueError(f"x has {xl.shape[0]} rows, the graph "
                         f"{layout.n_pad}")
    gathered, rows = (xl, xr) if direction == "pull" else (xr, xl)
    msgs = _gather_bands(gathered, layout, precision)
    if msgs[0].dtype == torch.bfloat16:
        rows = rows.to(torch.bfloat16)
    dev = layout.dev(xl.device)
    flat = banded_sddmm(
        dev["bounds"], dev["offs2d"], msgs, rows,
        precision="split" if precision == "fast" else precision,
        edge_chunk=layout.edge_chunk, seg=dev["seg"],
    )
    vals = layout.permute_from_bands(flat)
    mask = g.edge_mask if order == "csr" else g.edge_mask_csc
    return torch.where(mask, vals, 0)
