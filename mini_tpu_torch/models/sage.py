"""GraphSAGE (mean aggregator) on the SpMM path: forward and training.

    out = act( [h ; mean_{u in N_in(v)} h_u] @ W + b )

The mean is the pull SpMM with each edge weighed by ``1 / in_deg(dst)``,
so the banded kernel weighs the messages as it sums them.  Without a
normalization the weights are banded in every call; with
:func:`sage_normalize`'s ``SAGENorm`` they are pre-banded once per width
(the GCN's ``GCNNorm`` route), and a step re-bands nothing.  Parameters
keep the JAX package's layout, a list of ``{"w", "b"}`` dicts, so
:func:`params_from_jax` carries them across; ``[h ; agg] @ W`` is taken
as ``h @ W[:F] + agg @ W[F:]`` over row slices of the same ``w``, so no
``[n, 2F]`` concat is written or kept for the backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from mini_tpu_torch.graph.banded import layout_for
from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.models._sgd import init_opt, sgd_momentum_step
from mini_tpu_torch.models.gcn import params_from_jax  # noqa: F401
from mini_tpu_torch.ops.spmm import spmm
from mini_tpu_torch.utils.device import resolve_device
from mini_tpu_torch.utils.profiling import scope


@dataclasses.dataclass(frozen=True)
class SAGENorm:
    """The mean aggregator's per-edge weights, ``1 / in_deg(dst)`` on real
    edges and 0 on pad edges, in CSC order, and pre-banded: ``banded``
    maps a layout's band height to the weights in its pull order and in
    its push order (the SpMM's backward), each a K-tuple."""

    edge_weights_csc: torch.Tensor  # float32[m_pad]
    banded: dict  # band_rows -> (pull K-tuple, push K-tuple)

    def bands_for(self, g: GraphSlice, width: int) -> tuple:
        """``(pull, push)`` pre-banded weights of the layout that rows
        ``width`` wide take (``graph.banded.layout_for``), or ``(None,
        None)`` where none were built for it."""
        lay = layout_for(g, "pull", width)
        if lay is None:
            return None, None
        return self.banded.get(lay.band_rows, (None, None))


def _mean_weights(g: GraphSlice) -> torch.Tensor:
    """float32 ``[m_pad]`` in CSC order: ``1 / in_deg(dst)`` on real edges,
    0 on pad edges."""
    deg = g.in_degrees.to(torch.float32)
    inv_deg = torch.where(g.in_degrees > 0, 1.0 / deg.clamp(min=1), 0.0)
    return torch.where(g.edge_mask_csc, inv_deg[g.csc_dsts.long()], 0.0)


def sage_normalize(g: GraphSlice, widths: Sequence[int] = (128,)) -> SAGENorm:
    """The mean's weights of ``g``, banded once for each layout that rows
    of the given ``widths`` take (a model's aggregated widths, its
    ``dims[:-1]``: every width up to the next multiple of 128 shares one
    layout), in pull and in push order."""
    w = _mean_weights(g)
    # the same per-edge values in CSR order: a gather by the static rank
    w_csr = w[g.csr_to_csc_rank.long()]
    banded = {}
    for width in widths:
        lp = layout_for(g, "pull", width)
        lb = layout_for(g, "push", width)
        if lp is None or lb is None or lp.band_rows in banded:
            continue
        banded[lp.band_rows] = (tuple(lp.permute_to_bands(w)),
                                tuple(lb.permute_to_bands(w_csr)))
    return SAGENorm(edge_weights_csc=w, banded=banded)


def sage_init(
    generator: torch.Generator,
    dims: Sequence[int],
    dtype=torch.float32,
    device=None,
) -> list[dict]:
    """Glorot-uniform ``w`` ``[2 dims[i], dims[i+1]]`` and zero ``b`` per
    layer, drawn from ``generator`` (a CPU generator; the tensors then
    move to ``device``, ``None`` for the card)."""
    device = resolve_device(device)
    params = []
    for i in range(len(dims) - 1):
        fan_in = 2 * dims[i]
        scale = math.sqrt(6.0 / (fan_in + dims[i + 1]))
        u = torch.rand(fan_in, dims[i + 1], generator=generator, dtype=dtype)
        params.append({
            "w": ((u * 2 - 1) * scale).to(device),
            "b": torch.zeros(dims[i + 1], dtype=dtype, device=device),
        })
    return params


def _mean(g: GraphSlice, h: torch.Tensor, impl: str,
          norm: Optional[SAGENorm]) -> torch.Tensor:
    """The mean of ``h`` over each vertex's in-edges, float32: the pull
    SpMM with the mean's weights, pre-banded where ``norm`` has them for
    ``h``'s width, else banded in the call."""
    if norm is None:
        w, pull, push = _mean_weights(g), None, None
    else:
        w = norm.edge_weights_csc
        pull, push = norm.bands_for(g, h.shape[-1])
    return spmm(g, h, direction="pull", weights=w, weights_banded=pull,
                weights_banded_bwd=push, impl=impl).to(torch.float32)


def sage_forward(
    params: list[dict], g: GraphSlice, x: torch.Tensor, impl: str = "auto",
    norm: Optional[SAGENorm] = None,
) -> torch.Tensor:
    """Forward pass; returns ``[n_pad, dims[-1]]``.  ``impl`` selects the
    SpMM (``auto``: banded on CUDA, ``xla`` on the CPU); ``norm``
    (:func:`sage_normalize` at the model's widths) gives the mean's
    pre-banded weights.  Under a profiler each layer's aggregation is
    the span ``sage.aggregate``."""
    h = x
    for i, layer in enumerate(params):
        with scope("sage.aggregate"):
            agg = _mean(g, h, impl, norm)
        F = h.shape[-1]
        w = layer["w"]
        h = torch.matmul(h, w[:F]) + torch.matmul(agg, w[F:]) + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def sage_forward_cpu(
    params_np: list[dict], hg: HostGraph, x: np.ndarray
) -> np.ndarray:
    """NumPy/scipy oracle in float64: the mean over in-edges as a sparse
    multiplicity matrix (``mini_tpu``'s dense ``n x n`` one, which holds
    only small graphs, summed the same way up to float64 rounding)."""
    import scipy.sparse as sp

    n = hg.n
    # pull: row = dst, col = src; duplicate edges sum to their multiplicity
    mult_t = sp.csr_matrix(
        (np.ones(hg.m), (hg.csr_dsts, hg.csr_srcs)), shape=(n, n),
        dtype=np.float64,
    )
    inv_deg = np.where(
        hg.in_degrees > 0, 1.0 / np.maximum(hg.in_degrees, 1), 0.0
    )
    h = x[:n].astype(np.float64)
    for i, layer in enumerate(params_np):
        agg = (mult_t @ h) * inv_deg[:, None]
        h = np.concatenate([h, agg], axis=-1) @ layer["w"] + layer["b"]
        if i < len(params_np) - 1:
            h = np.maximum(h, 0)
    return h


# ------------------------------------------------------------- training
def sage_loss(
    params, g: GraphSlice, x, labels, label_mask, impl: str = "auto",
    norm: Optional[SAGENorm] = None,
) -> torch.Tensor:
    """Masked softmax cross-entropy over labeled vertices (the
    ``gcn_loss`` contract on the SAGE forward)."""
    logits = sage_forward(params, g, x, impl=impl, norm=norm)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    nll = torch.where(label_mask, nll, 0.0)
    return nll.sum() / label_mask.sum().clamp(min=1)


def sage_train_step(
    params, opt_state, g: GraphSlice, x, batch, lr: float = 1e-2,
    impl: str = "auto", norm: Optional[SAGENorm] = None,
):
    """One SGD-with-momentum step (the ``gcn_train_step`` contract);
    ``batch = (labels, label_mask)``; ``norm`` as in
    :func:`sage_forward`."""
    labels, label_mask = batch
    return sgd_momentum_step(
        params, opt_state,
        lambda p: sage_loss(p, g, x, labels, label_mask, impl, norm), lr)


def sage_init_opt(params):
    """SGD-momentum state: zeros like the params."""
    return init_opt(params)
