"""Graph Convolutional Network forward on the graph slice.

Each layer computes

    H' = act( Â @ H @ W + b ),   Â = D̂^{-1/2} (A + I) D̂^{-1/2}

where the sparse product Â @ (H W) is the pull SpMM (ops/spmm.py) with
normalized edge weights, and the self-loop diagonal is an elementwise
rescale.  The dense H @ W is ``torch.matmul`` in full float32.  Parameters
keep the JAX package's layout, a list of ``{"w", "b"}`` dicts, so
:func:`params_from_jax` carries them across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from mini_tpu_torch.graph.banded import get_layout
from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.spmm import spmm

# H @ W in full float32, as the JAX reference computes it: no TF32 on the
# card (PyTorch's default; pinned here so a caller's setting cannot change
# the model's numbers).
torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class GCNNorm:
    """Symmetric-normalized adjacency, split into sparse + diagonal parts.

    ``banded_pull`` holds the normalized edge weights pre-reordered into
    the banded pull layout (graph/banded.py), once at normalize time
    instead of per layer; None when the graph has no banded layout.
    """

    edge_weights_csc: torch.Tensor  # float32[m_pad]
    self_coeff: torch.Tensor  # float32[n_pad]: 1/deg_hat diagonal
    banded_pull: tuple | None = None


def gcn_normalize(g: GraphSlice, band_for_f: int = 128) -> GCNNorm:
    """Â = D̂^-1/2 (A + I) D̂^-1/2 with deg_hat = in_deg + 1.

    For undirected graphs in/out degrees coincide; for directed graphs this
    is the standard pull-aggregation normalization.  ``band_for_f`` sizes
    the banded layout the weights are pre-reordered into; the SpMM uses the
    same layout for every F up to the next multiple of 128.
    """
    real = g.vertex_mask()
    deg_hat = torch.where(real, g.in_degrees + 1, 1).to(torch.float32)
    inv_sqrt = torch.rsqrt(deg_hat)
    w = inv_sqrt[g.csc_srcs.long()] * inv_sqrt[g.csc_dsts.long()]
    w = torch.where(g.edge_mask_csc, w, 0.0)
    self_coeff = torch.where(real, 1.0 / deg_hat, 0.0)

    lp = get_layout(g, "pull", row_bytes=band_for_f * 4)
    banded_pull = tuple(lp.permute_to_bands(w)) if lp is not None else None
    return GCNNorm(
        edge_weights_csc=w, self_coeff=self_coeff, banded_pull=banded_pull
    )


def gcn_init(
    generator: torch.Generator,
    dims: Sequence[int],
    dtype=torch.float32,
    device="cpu",
) -> list[dict]:
    """Glorot-uniform layer parameters for dims[0] -> ... -> dims[-1],
    drawn from ``generator`` (a CPU generator; the tensors then move to
    ``device``)."""
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


def params_from_jax(params_np: list[dict], device="cpu") -> list[dict]:
    """The JAX package's GCN parameters (a list of ``{"w", "b"}`` dicts of
    arrays, e.g. from ``mini_tpu.models.gcn.gcn_init`` via
    ``np.asarray``) as torch tensors on ``device``."""
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
            impl=impl,
        ).to(torch.float32)
        h = agg + norm.self_coeff[:, None] * hw + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


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
