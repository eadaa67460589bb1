"""Graph Convolutional Network on the graph slice: forward and training.

Each layer computes

    H' = act( Â @ H @ W + b ),   Â = D̂^{-1/2} (A + I) D̂^{-1/2}

where the sparse product Â @ (H W) is the pull SpMM (ops/spmm.py) with
normalized edge weights, and the self-loop diagonal is an elementwise
rescale.  The dense H @ W is ``torch.matmul`` in full float32.  Parameters
keep the JAX package's layout, a list of ``{"w", "b"}`` dicts, so
:func:`params_from_jax` carries them (and the momentum) across unchanged.
Training is plain functions on tensors: :func:`gcn_train_step` takes the
gradient with ``torch.autograd.grad`` through the banded SpMM's backward
(ops/spmm.py), which is the opposite-direction SpMM; the edge weights are
constants, so no SDDMM runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from mini_tpu_torch.graph.banded import layout_for
from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.models._sgd import init_opt, sgd_momentum_step
from mini_tpu_torch.ops.spmm import spmm
from mini_tpu_torch.utils.device import resolve_device

# H @ W in full float32, as the JAX reference computes it: no TF32 on the
# card (PyTorch's default; pinned here so a caller's setting cannot change
# the model's numbers).
torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class GCNNorm:
    """Symmetric-normalized adjacency, split into sparse + diagonal parts.

    ``banded_pull``/``banded_push`` hold the normalized edge weights
    pre-reordered into the banded pull and push layouts (graph/banded.py),
    once at normalize time instead of per layer; the push order feeds the
    SpMM's backward.  None when the graph has no banded layout.
    """

    edge_weights_csc: torch.Tensor  # float32[m_pad]
    self_coeff: torch.Tensor  # float32[n_pad]: 1/deg_hat diagonal
    banded_pull: tuple | None = None
    banded_push: tuple | None = None


def gcn_normalize(g: GraphSlice, band_for_f: int = 128) -> GCNNorm:
    """Â = D̂^-1/2 (A + I) D̂^-1/2 with deg_hat = in_deg + 1.

    For undirected graphs in/out degrees coincide; for directed graphs this
    is the standard pull-aggregation normalization.  ``band_for_f`` sizes
    the banded layout the weights are pre-reordered into: ``layout_for``'s
    at that width, the one the SpMM takes for every F up to the next
    multiple of 128.
    """
    real = g.vertex_mask()
    deg_hat = torch.where(real, g.in_degrees + 1, 1).to(torch.float32)
    inv_sqrt = torch.rsqrt(deg_hat)
    w = inv_sqrt[g.csc_srcs.long()] * inv_sqrt[g.csc_dsts.long()]
    w = torch.where(g.edge_mask_csc, w, 0.0)
    self_coeff = torch.where(real, 1.0 / deg_hat, 0.0)

    banded_pull = banded_push = None
    lp = layout_for(g, "pull", band_for_f)
    lb = layout_for(g, "push", band_for_f)
    if lp is not None:
        banded_pull = tuple(lp.permute_to_bands(w))
    if lb is not None:
        # the same per-edge values in CSR order (w is symmetric in src and
        # dst only on undirected graphs): a gather by the static rank
        w_csr = w[g.csr_to_csc_rank.long()]
        banded_push = tuple(lb.permute_to_bands(w_csr))
    return GCNNorm(
        edge_weights_csc=w, self_coeff=self_coeff, banded_pull=banded_pull,
        banded_push=banded_push,
    )


def gcn_init(
    generator: torch.Generator,
    dims: Sequence[int],
    dtype=torch.float32,
    device=None,
) -> list[dict]:
    """Glorot-uniform layer parameters for dims[0] -> ... -> dims[-1],
    drawn from ``generator`` (a CPU generator; the tensors then move to
    ``device``, ``None`` for the card)."""
    device = resolve_device(device)
    params = []
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        scale = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(fan_in, fan_out, generator=generator, dtype=dtype)
        params.append(
            {
                "w": ((u * 2 - 1) * scale).to(device),
                "b": torch.zeros(fan_out, dtype=dtype, device=device),
            }
        )
    return params


def params_from_jax(params_np: list[dict], device=None) -> list[dict]:
    """The JAX package's GCN parameters (a list of ``{"w", "b"}`` dicts of
    arrays, e.g. from ``mini_tpu.models.gcn.gcn_init`` via
    ``np.asarray``) as torch tensors on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return [
        {k: torch.from_numpy(np.array(v)).to(device) for k, v in p.items()}
        for p in params_np
    ]


def gcn_forward(
    params: list[dict],
    g: GraphSlice,
    norm: GCNNorm,
    x: torch.Tensor,
    impl: str = "auto",
    message_dtype=None,
) -> torch.Tensor:
    """Forward pass; returns logits [n_pad, dims[-1]].

    ``message_dtype=torch.bfloat16`` halves the bytes the aggregation
    gathers and sums (float32 accumulation; about 1e-3 relative error).
    """
    h = x
    for i, layer in enumerate(params):
        hw = torch.matmul(h, layer["w"])
        hw_msg = hw if message_dtype is None else hw.to(message_dtype)
        agg = spmm(
            g,
            hw_msg,
            direction="pull",
            weights=norm.edge_weights_csc,
            weights_banded=norm.banded_pull,
            weights_banded_bwd=norm.banded_push,
            impl=impl,
        ).to(torch.float32)
        h = agg + norm.self_coeff[:, None] * hw + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def gcn_loss(
    params: list[dict],
    g: GraphSlice,
    norm: GCNNorm,
    x: torch.Tensor,
    labels: torch.Tensor,
    label_mask: torch.Tensor,
    impl: str = "auto",
    message_dtype=None,
) -> torch.Tensor:
    """Masked softmax cross-entropy over labeled vertices."""
    logits = gcn_forward(params, g, norm, x, impl=impl,
                         message_dtype=message_dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    nll = torch.where(label_mask, nll, 0.0)
    return nll.sum() / label_mask.sum().clamp(min=1)


def gcn_init_opt(params: list[dict]) -> list[dict]:
    """SGD-momentum state: zeros like the params."""
    return init_opt(params)


def gcn_train_step(
    params: list[dict],
    opt_state: list[dict],
    g: GraphSlice,
    norm: GCNNorm,
    x: torch.Tensor,
    batch,
    lr: float = 1e-2,
    impl: str = "auto",
    message_dtype=None,
):
    """One SGD-with-momentum step, ``m = 0.9 m + grad; p = p - lr m``.
    ``batch = (labels, label_mask)``; ``impl``/``message_dtype`` select
    the aggregation path as in :func:`gcn_forward`.  Returns
    ``(new_params, new_opt, loss)``; the inputs are left as they were."""
    labels, label_mask = batch
    return sgd_momentum_step(
        params, opt_state,
        lambda p: gcn_loss(p, g, norm, x, labels, label_mask, impl=impl,
                           message_dtype=message_dtype),
        lr,
    )


# ----------------------------------------------------------------- oracles
def gcn_forward_cpu(
    params_np: list[dict], hg: HostGraph, x: np.ndarray
) -> np.ndarray:
    """NumPy/scipy sparse oracle of the forward pass in float64:
    out[v] = sum_{(u,v)} d[u] d[v] h[u] + d[v]^2 h[v] with
    d = deg_hat^-1/2, deg_hat = in_deg + 1 (multi-edges keep multiplicity).
    """
    import scipy.sparse as sp

    n = hg.n
    deg_hat = (hg.in_degrees.astype(np.float64) + 1.0)
    d = 1.0 / np.sqrt(deg_hat)
    src, dst = hg.csr_srcs, hg.csr_dsts
    # pull aggregation operator: row = dst, col = src (A_hat^T off-diagonal)
    agg = sp.csr_matrix(
        (d[src] * d[dst], (dst, src)), shape=(n, n), dtype=np.float64
    )
    self_coeff = (d * d)[:, None]
    h = x[:n].astype(np.float64)
    for i, layer in enumerate(params_np):
        hw = h @ layer["w"]
        h = agg @ hw + self_coeff * hw + layer["b"]
        if i < len(params_np) - 1:
            h = np.maximum(h, 0)
    return h
