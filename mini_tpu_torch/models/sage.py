"""GraphSAGE (mean aggregator) on the SpMM path: forward and training.

    out = act( [h ; mean_{u in N_in(v)} h_u] @ W + b )

The mean is the pull SpMM with unit weights on the real edges, scaled by
the inverse in-degree.  Parameters keep the JAX package's layout, a list
of ``{"w", "b"}`` dicts, so :func:`params_from_jax` carries them across.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.models._sgd import init_opt, sgd_momentum_step
from mini_tpu_torch.models.gcn import params_from_jax  # noqa: F401
from mini_tpu_torch.ops.spmm import spmm
from mini_tpu_torch.utils.device import resolve_device


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


def sage_forward(
    params: list[dict], g: GraphSlice, x: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """Forward pass; returns ``[n_pad, dims[-1]]``.  ``impl`` selects the
    SpMM (``auto``: banded on CUDA, ``xla`` on the CPU)."""
    unit_w = torch.where(g.edge_mask_csc, 1.0, 0.0)
    deg = g.in_degrees.to(torch.float32)
    inv_deg = torch.where(g.in_degrees > 0, 1.0 / deg.clamp(min=1), 0.0)
    h = x
    for i, layer in enumerate(params):
        agg = spmm(g, h, direction="pull", weights=unit_w, impl=impl)
        agg = agg.to(torch.float32) * inv_deg[:, None]
        h = torch.matmul(torch.cat([h, agg], dim=-1), layer["w"]) + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def sage_forward_cpu(
    params_np: list[dict], hg: HostGraph, x: np.ndarray
) -> np.ndarray:
    """Dense NumPy oracle in float64 (an ``n x n`` multiplicity matrix:
    small graphs only)."""
    n = hg.n
    mult = np.zeros((n, n))
    np.add.at(mult, (hg.csr_srcs, hg.csr_dsts), 1.0)
    inv_deg = np.where(
        hg.in_degrees > 0, 1.0 / np.maximum(hg.in_degrees, 1), 0.0
    )
    h = x[:n].astype(np.float64)
    for i, layer in enumerate(params_np):
        agg = (mult.T @ h) * inv_deg[:, None]
        h = np.concatenate([h, agg], axis=-1) @ layer["w"] + layer["b"]
        if i < len(params_np) - 1:
            h = np.maximum(h, 0)
    return h


# ------------------------------------------------------------- training
def sage_loss(
    params, g: GraphSlice, x, labels, label_mask, impl: str = "auto"
) -> torch.Tensor:
    """Masked softmax cross-entropy over labeled vertices (the
    ``gcn_loss`` contract on the SAGE forward)."""
    logits = sage_forward(params, g, x, impl=impl)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    nll = torch.where(label_mask, nll, 0.0)
    return nll.sum() / label_mask.sum().clamp(min=1)


def sage_train_step(
    params, opt_state, g: GraphSlice, x, batch, lr: float = 1e-2,
    impl: str = "auto",
):
    """One SGD-with-momentum step (the ``gcn_train_step`` contract);
    ``batch = (labels, label_mask)``."""
    labels, label_mask = batch
    return sgd_momentum_step(
        params, opt_state,
        lambda p: sage_loss(p, g, x, labels, label_mask, impl), lr)


def sage_init_opt(params):
    """SGD-momentum state: zeros like the params."""
    return init_opt(params)
