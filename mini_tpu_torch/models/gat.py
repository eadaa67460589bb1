"""Graph Attention Network on the graph slice: forward and training.

Per head:  h = X W;  e_uv = LeakyReLU(a_s.h_u + a_d.h_v);
           alpha = softmax of e over v's in-edges;  out_v = sum alpha_uv h_u.

Parameters keep the JAX package's layout, a list of ``{"w", "a_src",
"a_dst"}`` dicts with ``w`` ``[H, fan_in, d]``, so
:func:`params_from_jax` carries them across; each layer has its own H.
Hidden layers concat their heads (then ELU), the last layer averages them.
``skip`` names the layers that add their input to that result before the
activation (an identity skip, where the input is as wide as the output),
as the GAT paper's deep PPI model does across its middle layer.

``attn`` picks the attention layer:

* ``"banded"`` (``"auto"`` on CUDA): :func:`_gat_layer_banded`, weights
  born in banded order (each slot's source score gathered from the
  per-vertex scores by the band's ids), the messages aggregated by the
  banded SpMM's own route (``ops/spmm._apply_banded``: one
  ``banded_segment_sum`` launch that reads the rows by the bands' ids),
  the softmax denominators the per-segment sums of the weights
  themselves (one launch of :func:`banded_heads_segment_sum`), so a head
  needs no spare lane in its padding.  While a profiler runs the forward is the span ``gat.attn`` and
  the backward ``gat.attn.backward``.  :class:`_GatBandedLayer` makes it
  trainable with the JAX package's native banded backward: the weight
  cotangent by the banded SDDMM with heads, ``ds_dst`` and ``ds_src`` by
  :func:`banded_heads_segment_sum` straight off the pull and push bands,
  one fixed permutation (``permute_rows`` of the ``[w | g_e]`` rows) by
  the composite pull-to-push rank moving the weights and score cotangents
  between them,
  and ``g_h`` by the push-direction banded SpMM.
* ``"fused"`` (``"auto"`` on the CPU): :func:`_gat_fused_heads`, engine
  movers and one multi-head SpMM, differentiated by autograd.  It is the
  gradient reference of the banded layer (JAX's round-4 ``"fused"``
  backward switch is not ported as a switch).
* ``"softmax"``: per-segment max and explicit normalization
  (:func:`segment_softmax_by_dst`).

The products ``h @ W`` and the per-vertex scores ``hw @ a`` are
``torch.matmul`` in full float32 (no TF32), as JAX computes them outside
any Pallas kernel.  JAX's banded layer multiplies every gathered row by
the score projector (a product the TPU's MXU carries); the port gathers
the per-vertex source scores instead, the same float32 numbers without
re-reading the rows.
"""

from __future__ import annotations

import importlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F_

from mini_tpu_torch.graph.banded import get_pull_to_push_rank, layout_for
from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.models._sgd import init_opt, sgd_momentum_step
from mini_tpu_torch.models.gcn import params_from_jax  # noqa: F401
from mini_tpu_torch.ops.engine import (
    dst_vals_to_csc,
    reduce_csc_by_dst,
    src_vals_to_csc,
)
from mini_tpu_torch.ops.permute import permute_rows
from mini_tpu_torch.ops.spmm import banded_heads_segment_sum, spmm
from mini_tpu_torch.utils.device import resolve_device
from mini_tpu_torch.utils.profiling import scope

# the module, looked up at each call, so that one patch of its
# ``_apply_banded`` reroutes every kernel-2 launch of GCN and GAT alike
# (``ops/__init__`` exports the function ``spmm`` under the module's name)
spmm_ops = importlib.import_module("mini_tpu_torch.ops.spmm")

# attention layers that ``auto`` or ``banded`` sent off the banded layer
# (to the fused path), since the last reset
fused_layers = 0


def _head_pad(n_heads: int, d: int) -> int:
    """Each head's width padded so the head concat is a multiple of 128."""
    step = 128 // math.gcd(n_heads, 128)
    return -(-d // step) * step


def _on_card(g: GraphSlice) -> bool:
    return g.device.type == "cuda"


def _concat_heads(hws, d: int, d_pad: int, ones: bool) -> torch.Tensor:
    """``[hw_h | 1 | 0 ...]`` per head (the ones column only with
    ``ones``): ``[n_pad, H d_pad]``, built by concatenation."""
    n_pad = hws[0].shape[0]
    parts = []
    for hw in hws:
        parts.append(hw)
        if ones:
            parts.append(hw.new_ones(n_pad, 1))
        parts.append(hw.new_zeros(n_pad, d_pad - d - int(ones)))
    return torch.cat(parts, dim=-1)


def _gat_layer_banded(
    g: GraphSlice,
    hws: list,
    s_src_l: list,  # per-head [n_pad] vertex src scores
    s_dst_l: list,  # per-head [n_pad] vertex dst scores
    d: int,
    negative_slope: float,
    message_dtype,
):
    """The banded-native attention layer (JAX ``gat.py:30-165``).

    Per band k: the source scores ``sc = s_src[band k][ids[k]]`` gathered
    from the ``[n_pad, H]`` vertex scores (``ops/spmm._gather_bands``; pad
    slots take id 0, in range, and weigh 0; the kernel moves a slot's 16
    or 24 bytes by a thread, where ``index_select`` spends a block on
    each), the dst scores expanded by the band's segment ids, the
    unnormalized weight ``w = exp(LRelu(sc + ed) - LRelu(gmax + ed))``
    (``gmax`` the global max of the source scores, an exact stabilizer
    because LeakyReLU is monotone, so every weight lies in (0, 1]).  The
    head concat, cast to ``message_dtype``, then runs the banded SpMM's
    aggregation (``ops/spmm._apply_banded``): one ``banded_segment_sum``,
    which reads each slot's row of the head concat by the band's ids and
    weighs each head block by its ``w`` column as it adds it.  Each head's denominator is the per-segment sum
    of its weights as the kernel rounds them (to ``message_dtype``
    first), by one launch of :func:`banded_heads_segment_sum` over the K
    ``[mk, H]`` bands: no column of the messages carries it, so a head's
    padding may be empty (``_head_pad(H, d) == d``).

    Returns the per-head normalized outputs and the residuals of the
    backward: the per-band ``w`` and LeakyReLU sign bits and the ``[n_pad,
    H]`` denominators.  The caller has checked
    :func:`_banded_layer_supported`.  Not differentiable itself:
    :class:`_GatBandedLayer` is."""
    H = len(hws)
    d_pad = _head_pad(H, d)
    layout = layout_for(g, "pull", H * d_pad)
    s_src = torch.stack(s_src_l, dim=-1)  # [n_pad, H]
    s_dst = torch.stack(s_dst_l, dim=-1)
    gmax = s_src.amax(dim=0)
    dev = layout.dev(s_src.device)
    w_bands, pos_bands = [], []
    for sc, seg, valid in zip(
            spmm_ops._gather_bands(s_src, layout, "split"), dev["seg"],
            dev["valid"]):  # sc: [mk, H]
        ed = torch.index_select(s_dst, 0, seg)
        e = F_.leaky_relu(sc + ed, negative_slope)
        bound = F_.leaky_relu(gmax[None, :] + ed, negative_slope)
        w_bands.append(torch.where(valid[:, None], torch.exp(e - bound), 0.0))
        pos_bands.append(sc + ed > 0)  # LeakyReLU' sign bits

    hw_cat = _concat_heads(hws, d, d_pad, ones=False)
    if message_dtype is not None:
        hw_cat = hw_cat.to(message_dtype)
    out = spmm_ops._apply_banded(hw_cat, layout, w_bands, "split")
    w_sum = (w_bands if message_dtype is None
             else [w.to(message_dtype).float() for w in w_bands])
    denom = banded_heads_segment_sum(layout, w_sum).clamp(min=1e-30)
    heads = [out[:, hd * d_pad: hd * d_pad + d] / denom[:, hd, None]
             for hd in range(H)]
    return heads, {
        "w_bands": w_bands,
        "pos_bands": pos_bands,
        "denom": denom,
    }


class _GatBandedLayer(torch.autograd.Function):
    """The banded layer with JAX's native banded backward (``gat.py:358-488``).

    Inputs ``g, d, negative_slope, message_dtype, H`` and the H-tuples
    ``hws, s_src, s_dst``; outputs the H normalized heads.  The
    forward saves the per-band weights ``w``, the LeakyReLU sign bits, the
    denominators and the outputs.  With ``q = ct / W`` and ``r = <ct, y> /
    W`` per head, a dst-side matrix ``Q`` of blocks ``[q, 0]`` makes the
    banded SDDMM ``<Q_dst, h_u>`` emit ``<q, h>``, and the weight
    cotangent ``g_w = <q, h> - r`` takes ``r`` off each band by its slots'
    segment ids; the push-direction banded SpMM of ``Q`` with the saved
    weights emits ``g_h``.  The score
    cotangent ``g_e = w g_w LRelu'`` is summed per dst off the pull bands
    (``ds_dst``) and per src off the push bands (``ds_src``), the weights
    and ``g_e`` moved to push order by one fixed permutation.  The
    stabilizer's cotangent is exactly zero; ``a_src`` takes its gradient
    through ``s_src = h a_src`` outside."""

    @staticmethod
    def forward(ctx, g, d, negative_slope, message_dtype, H, *args):
        hws, s_src_l, s_dst_l = (
            list(args[i * H:(i + 1) * H]) for i in range(3))
        with scope("gat.attn"):
            heads, aux = _gat_layer_banded(
                g, hws, s_src_l, s_dst_l, d, negative_slope, message_dtype,
            )
        ctx.g, ctx.d, ctx.slope, ctx.mdt, ctx.H = (
            g, d, negative_slope, message_dtype, H)
        ctx.K = len(aux["w_bands"])
        ctx.save_for_backward(*hws, *aux["w_bands"], *aux["pos_bands"],
                              aux["denom"], *heads)
        return tuple(heads)

    @staticmethod
    def backward(ctx, *ct):
        with scope("gat.attn.backward"):
            return _GatBandedLayer._backward(ctx, *ct)

    @staticmethod
    def _backward(ctx, *ct):
        g, d, H, K, mdt = ctx.g, ctx.d, ctx.H, ctx.K, ctx.mdt
        saved = ctx.saved_tensors
        hws = saved[:H]
        w_bands = saved[H:H + K]
        pos_bands = saved[H + K:H + 2 * K]
        denom = saved[H + 2 * K]
        ys = saved[H + 2 * K + 1:]
        d_pad = _head_pad(H, d)
        layout = layout_for(g, "pull", H * d_pad)
        layout_b = layout_for(g, "push", H * d_pad)
        comp = get_pull_to_push_rank(g, layout, layout_b)
        dev = layout.dev(hws[0].device)

        Q = _concat_heads([c / denom[:, h, None] for h, c in enumerate(ct)],
                          d, d_pad, ones=False)  # [n_pad, H d_pad] float32
        r = torch.stack([(c * y).sum(-1) for c, y in zip(ct, ys)],
                        dim=-1) / denom  # [n_pad, H]
        hw_cat = _concat_heads(hws, d, d_pad, ones=False)
        x_sd = hw_cat if mdt is None else hw_cat.to(mdt)
        # [mk, H] per band; the SDDMM gives one head's as [mk]
        gw_bands = [gw.view(-1, H) - torch.index_select(r, 0, seg)
                    for gw, seg in zip(spmm_ops._weight_cotangent(
                        x_sd, Q, layout, "split", heads=H), dev["seg"])]

        # the score chain from the residuals: g_e = w g_w LRelu'
        g_bands = [
            wb * gw * torch.where(pb, 1.0, ctx.slope)
            for wb, gw, pb in zip(w_bands, gw_bands, pos_bands)
        ]  # K x [mk, H]
        ds_dst = banded_heads_segment_sum(layout, g_bands)

        # one permutation moves w and g_e from pull-band to push-band
        # order, as the rows [w | g_e] of one table; ghost and pad slots
        # are zeroed first, so they come out as no-ops in the push streams
        valid = torch.cat(dev["valid"])[:, None]
        n_pull = valid.shape[0]
        table = hws[0].new_empty(comp.shape[0], 2 * H)
        table[n_pull:] = 0
        torch.where(valid, torch.cat([torch.cat(wg, dim=1) for wg in
                                      zip(w_bands, g_bands)]),
                    table.new_zeros(()), out=table[:n_pull])
        push = permute_rows(comp, table, rank_inv=get_pull_to_push_rank(
            g, layout, layout_b, inverse=True))
        w_push = layout_b._split_bands(push[:, :H])
        g_push = layout_b._split_bands(push[:, H:])
        ds_src = banded_heads_segment_sum(layout_b, g_push)

        go_sd = Q if mdt is None else Q.to(mdt)
        gx = spmm_ops._apply_banded(go_sd, layout_b, w_push,
                                    "split").to(torch.float32)
        g_hws = [gx[:, h * d_pad: h * d_pad + d] for h in range(H)]
        g_ss = [ds_src[:, h] for h in range(H)]
        g_sd = [ds_dst[:, h] for h in range(H)]
        return (None, None, None, None, None, *g_hws, *g_ss, *g_sd)


def segment_softmax_by_dst(g: GraphSlice,
                           scores: torch.Tensor) -> torch.Tensor:
    """Softmax of CSC-ordered per-edge scores (``[m_pad]`` or ``[m_pad,
    H]``) within each dst segment; masked (ghost) edges get weight 0.  The
    per-segment max only stabilizes (its cotangent is exactly zero), so it
    is taken without a gradient."""
    mask = g.edge_mask_csc.reshape(
        g.edge_mask_csc.shape + (1,) * (scores.ndim - 1))
    s = torch.where(mask, scores, -1e30)
    smax = reduce_csc_by_dst(g, s.detach(), "max", identity=0.0)
    e = torch.where(mask, torch.exp(s - dst_vals_to_csc(g, smax)), 0.0)
    denom = reduce_csc_by_dst(g, e, "sum")
    return e / dst_vals_to_csc(g, denom.clamp(min=1e-30))


def _gat_fused_heads(
    g: GraphSlice,
    hws,
    s_src_l,
    s_dst_l,
    d: int,
    negative_slope: float,
    message_dtype,
):
    """The fused engine-ops attention layer (differentiable by autograd):
    unnormalized weights from the global-max-stabilized scores, the
    denominator by a ones column in the padding (or a per-head segment
    sum), a divide per vertex.  Returns the tuple of normalized heads."""
    n_heads = len(hws)
    mask = g.edge_mask_csc
    ws = []
    for s_src, s_dst in zip(s_src_l, s_dst_l):
        ed = dst_vals_to_csc(g, s_dst)
        e = F_.leaky_relu(src_vals_to_csc(g, s_src) + ed, negative_slope)
        bound = F_.leaky_relu(s_src.max() + ed, negative_slope)
        ws.append(torch.where(mask, torch.exp(e - bound), 0.0))
    alpha = torch.stack(ws, dim=-1)  # unnormalized, in (0, 1]

    # all heads in one blockwise SpMM: each head padded so the concat is
    # a multiple of 128 columns, the denominator in the padding's first
    # column where there is one
    d_pad = _head_pad(n_heads, d)
    ones_col = d_pad > d
    hw_cat = _concat_heads(hws, d, d_pad, ones=ones_col)
    if message_dtype is not None:
        hw_cat = hw_cat.to(message_dtype)
    # one head's weights go in as spmm's [m_pad] scalar weights
    out = spmm(g, hw_cat, direction="pull", weights=alpha.squeeze(-1),
               heads=n_heads).to(torch.float32)
    heads = []
    for hd in range(n_heads):
        denom = (out[:, hd * d_pad + d] if ones_col
                 else reduce_csc_by_dst(g, alpha[:, hd], "sum"))
        heads.append(out[:, hd * d_pad: hd * d_pad + d]
                     / denom.clamp(min=1e-30)[:, None])
    return tuple(heads)


def _banded_layer_supported(
    g, n_heads: int, d: int, force: bool, n_rows: int
) -> bool:
    """The preconditions of :func:`_gat_layer_banded`: on the card (or
    ``force``), a banded layout, and ``n_rows`` matching it.  Where they
    fail, ``auto`` and ``banded`` take the fused path."""
    if not (_on_card(g) or force):
        return False
    layout = layout_for(g, "pull", n_heads * _head_pad(n_heads, d))
    if layout is None:
        return False
    return n_rows == layout.n_pad


def gat_init(
    generator: torch.Generator,
    dims: Sequence[int],
    heads: int | Sequence[int] = 2,
    dtype=torch.float32,
    device=None,
) -> list[dict]:
    """Layers project to dims[i+1] per head; hidden layers concat heads,
    the final layer averages them.  ``heads``: one count for every layer,
    or one a layer; a hidden layer's output is ``dims[i+1]`` times its
    heads wide.  Glorot-uniform draws from ``generator`` (a CPU
    generator; the tensors then move to ``device``, ``None`` for the
    card)."""
    n_layers = len(dims) - 1
    heads = ([heads] * n_layers if isinstance(heads, int)
             else [int(h) for h in heads])
    if len(heads) != n_layers:
        raise ValueError(f"{len(heads)} head counts for {n_layers} layers")
    device = resolve_device(device)
    params = []
    for i in range(n_layers):
        fan_in = dims[i] * (heads[i - 1] if i > 0 else 1)
        scale = math.sqrt(6.0 / (fan_in + dims[i + 1]))

        def u(*shape):
            r = torch.rand(*shape, generator=generator, dtype=dtype)
            return ((r * 2 - 1) * scale).to(device)

        params.append({
            "w": u(heads[i], fan_in, dims[i + 1]),
            "a_src": u(heads[i], dims[i + 1]),
            "a_dst": u(heads[i], dims[i + 1]),
        })
    return params


def gat_forward(
    params: list[dict],
    g: GraphSlice,
    x: torch.Tensor,
    negative_slope: float = 0.2,
    message_dtype=None,
    batch_softmax: bool = False,
    attn: str = "auto",
    skip: Sequence[int] = (),
) -> torch.Tensor:
    """Forward pass; returns ``[n_pad, dims[-1]]``.

    ``message_dtype=torch.bfloat16`` casts the aggregated head features to
    bf16 for the attention SpMM (float32 accumulation; scores and softmax
    stay float32).  ``attn``: ``auto`` (banded on CUDA, fused on the CPU),
    ``banded``, ``fused`` or ``softmax`` (see module doc).
    ``batch_softmax`` (softmax only) runs the score/softmax phase once
    over ``[m_pad, H]`` instead of per head.  ``skip``: the indices of
    the layers whose input is added to their heads' concat (or mean)
    before the ELU; such a layer's input and output widths must agree.
    Each layer that ``auto`` or ``banded`` cannot run on the banded layer
    adds one to the module's ``fused_layers``."""
    global fused_layers
    if attn not in ("auto", "banded", "fused", "softmax"):
        raise ValueError(f"unknown attn {attn!r}")
    h = x
    n_layers = len(params)
    skip = {int(i) for i in skip}
    if not skip <= set(range(n_layers)):
        raise ValueError(f"skip {sorted(skip)} names no layer of "
                         f"{n_layers}")
    for i, layer in enumerate(params):
        n_heads = layer["w"].shape[0]
        d = layer["w"].shape[2]
        hws = [torch.matmul(h, layer["w"][hd]) for hd in range(n_heads)]
        s_src_l = [hws[hd] @ layer["a_src"][hd] for hd in range(n_heads)]
        s_dst_l = [hws[hd] @ layer["a_dst"][hd] for hd in range(n_heads)]

        if attn in ("auto", "banded") and _banded_layer_supported(
            g, n_heads, d, force=attn == "banded", n_rows=hws[0].shape[0],
        ):
            heads = _GatBandedLayer.apply(
                g, d, negative_slope, message_dtype, n_heads, *hws,
                *s_src_l, *s_dst_l,
            )
        elif attn in ("auto", "banded", "fused"):
            fused_layers += attn != "fused"
            heads = _gat_fused_heads(g, hws, s_src_l, s_dst_l, d,
                                     negative_slope, message_dtype)
        else:
            heads = _softmax_heads(g, hws, s_src_l, s_dst_l, d,
                                   negative_slope, message_dtype,
                                   batch_softmax)
        out = (torch.cat(heads, dim=-1) if i < n_layers - 1
               else sum(heads) / len(heads))
        if i in skip:
            if out.shape != h.shape:
                raise ValueError(f"layer {i} maps {h.shape[-1]} to "
                                 f"{out.shape[-1]} columns: no identity "
                                 "skip")
            out = out + h
        h = F_.elu(out) if i < n_layers - 1 else out
    return h


def _softmax_heads(g, hws, s_src_l, s_dst_l, d, negative_slope,
                   message_dtype, batch_softmax):
    """The explicit-softmax layer: per-edge scores, the exact per-segment
    softmax, then a plain weighted SpMM of all heads."""
    n_heads = len(hws)
    e_src = [src_vals_to_csc(g, s) for s in s_src_l]
    if batch_softmax:
        s_dst = torch.stack(s_dst_l, dim=-1)
        e = torch.stack(e_src, dim=-1) + dst_vals_to_csc(g, s_dst)
        alpha = segment_softmax_by_dst(
            g, F_.leaky_relu(e, negative_slope))  # [m_pad, H]
    else:
        alpha = torch.stack([
            segment_softmax_by_dst(g, F_.leaky_relu(
                e_src[hd] + dst_vals_to_csc(g, s_dst_l[hd]),
                negative_slope))
            for hd in range(n_heads)
        ], dim=-1)

    # the weights are normalized: a plain weighted SpMM
    d_pad = _head_pad(n_heads, d)
    hw_cat = _concat_heads(hws, d, d_pad, ones=False)
    if message_dtype is not None:
        hw_cat = hw_cat.to(message_dtype)
    # one head's weights go in as spmm's [m_pad] scalar weights
    out = spmm(g, hw_cat, direction="pull", weights=alpha.squeeze(-1),
               heads=n_heads).to(torch.float32)
    return [out[:, hd * d_pad: hd * d_pad + d] for hd in range(n_heads)]


# ------------------------------------------------------------------ oracle
def _segment_max_csc(vals: np.ndarray, col_offsets: np.ndarray, n: int):
    """Per-dst max of CSC-ordered per-edge values (-inf for vertices with
    no in-edge)."""
    deg = np.diff(col_offsets)
    nonempty = deg > 0
    out = np.full(n, -np.inf)
    if nonempty.any():
        out[nonempty] = np.maximum.reduceat(
            vals, col_offsets[:-1][nonempty])
    return out


def gat_forward_cpu(
    params_np: list[dict],
    hg: HostGraph,
    x: np.ndarray,
    negative_slope: float = 0.2,
) -> np.ndarray:
    """Sparse NumPy/scipy oracle of the forward in float64: a vectorized
    segment softmax over the CSC edge order and a scipy SpMM."""
    import scipy.sparse as sp

    n = hg.n
    src, dst = hg.csc_srcs, hg.csc_dsts
    off = hg.col_offsets
    h = x[:n].astype(np.float64)
    n_layers = len(params_np)
    for i, layer in enumerate(params_np):
        heads = []
        for hd in range(layer["w"].shape[0]):
            hw = h @ layer["w"][hd]
            s_src = hw @ layer["a_src"][hd]
            s_dst = hw @ layer["a_dst"][hd]
            scores = s_src[src] + s_dst[dst]
            scores = np.where(scores > 0, scores, negative_slope * scores)
            smax = _segment_max_csc(scores, off, n)
            e = np.exp(scores - smax[dst])
            denom = np.bincount(dst, weights=e, minlength=n)
            alpha = e / np.maximum(denom[dst], 1e-300)
            att = sp.csr_matrix((alpha, (dst, src)), shape=(n, n),
                                dtype=np.float64)
            heads.append(att @ hw)
        if i < n_layers - 1:
            h = np.concatenate(heads, axis=-1)
            h = np.where(h > 0, h, np.exp(np.minimum(h, 0)) - 1)  # elu
        else:
            h = sum(heads) / len(heads)
    return h


# ------------------------------------------------------------- training
def gat_loss(
    params, g: GraphSlice, x, labels, label_mask,
    negative_slope: float = 0.2, message_dtype=None, attn: str = "auto",
    skip: Sequence[int] = (),
) -> torch.Tensor:
    """Masked softmax cross-entropy over labeled vertices (the
    ``gcn_loss`` contract on the GAT forward)."""
    logits = gat_forward(params, g, x, negative_slope=negative_slope,
                         message_dtype=message_dtype, attn=attn, skip=skip)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    nll = torch.where(label_mask, nll, 0.0)
    return nll.sum() / label_mask.sum().clamp(min=1)


def gat_train_step(
    params, opt_state, g: GraphSlice, x, batch, lr: float = 1e-2,
    negative_slope: float = 0.2, message_dtype=None, attn: str = "auto",
    skip: Sequence[int] = (),
):
    """One SGD-with-momentum step on the GAT, ``batch = (labels,
    label_mask)``.  With ``attn="auto"`` on CUDA the forward runs the
    banded layer and the backward its native banded chain; ``"fused"``
    differentiates the fused path.  ``skip`` as in :func:`gat_forward`.
    Returns ``(new_params, new_opt, loss)``; the inputs are left as they
    were."""
    labels, label_mask = batch
    return sgd_momentum_step(
        params, opt_state,
        lambda p: gat_loss(p, g, x, labels, label_mask, negative_slope,
                           message_dtype, attn, skip),
        lr,
    )


def gat_init_opt(params):
    """SGD-momentum state: zeros like the params."""
    return init_opt(params)
