"""R-GCN (Schlichtkrull et al. 2018) on a typed graph: forward and training.

For a vertex ``v`` of type ``t``, layer by layer::

    h'_v = h_v @ W_root[t] + b[t]
           + sum_{relations r into t} mean_{u in N_r(v)} h_u @ W_r

with the mean over an empty neighbourhood 0, no bias on ``W_r``, and a
ReLU between layers, as OGB's ogbn-mag example runs it.  Each relation's
mean is the pull SpMM over its relation graph (``graph/csr.py``) from the
source type's rows into the destination type's, weighed by ``1 /
in_deg(dst)``: ``models/sage.py``'s mean, with its weights pre-banded
once per relation by :func:`rgcn_normalize`, so a step re-bands nothing.
Types without features take a learned embedding table as their first
layer's input.

Parameters are a list of dicts for ``models/_sgd.sgd_momentum_step``:
first the embedding tables ``{"emb.<type>": [n_type, d]}``, then one dict
a layer of ``"root.<type>"`` ``[d_in, d_out]``, ``"bias.<type>"``
``[d_out]`` and ``"rel.<relation>"`` ``[d_in, d_out]``.  The last layer
gives every type's outputs, as published; a loss reads one type's, and
the parameters that only the others reach take a zero gradient.

While a profiler runs, each relation's forward mean and product is the
span ``rgcn.relation`` and the typed root products the span
``rgcn.root``; ``relation_sums`` counts the relation means launched in
forward passes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from mini_tpu_torch.graph.csr import TypedGraph
from mini_tpu_torch.models._sgd import init_opt, sgd_momentum_step
from mini_tpu_torch.models.sage import _mean, sage_normalize
from mini_tpu_torch.utils.device import resolve_device
from mini_tpu_torch.utils.profiling import scope

# relation means launched by rgcn_forward since the last reset
relation_sums = 0


def rgcn_normalize(tg: TypedGraph,
                   widths: Sequence[int] = (128,)) -> dict:
    """Relation name -> its mean's weights (``sage_normalize``), banded
    once for each layout that rows of the given ``widths`` take (the
    model's aggregated widths, its ``dims[:-1]``), in pull and push
    order."""
    return {r.name: sage_normalize(r.graph, widths) for r in tg.relations}


def _glorot(generator, rows, cols, dtype):
    u = torch.rand(rows, cols, generator=generator, dtype=dtype)
    return (u * 2 - 1) * math.sqrt(6.0 / (rows + cols))


def rgcn_init(
    generator: torch.Generator,
    tg: TypedGraph,
    dims: Sequence[int],
    embedded: Sequence[str],
    dtype=torch.float32,
    device=None,
) -> list[dict]:
    """Glorot-uniform embedding tables ``[n_type, dims[0]]`` for the
    ``embedded`` types, Glorot-uniform root and relation weights and zero
    biases per layer, drawn from ``generator`` (a CPU generator; the
    tensors then move to ``device``, ``None`` for the card)."""
    device = resolve_device(device)
    params = [{f"emb.{t}": _glorot(generator, tg.num_nodes[t], dims[0],
                                   dtype).to(device) for t in embedded}]
    for fi, fo in zip(dims[:-1], dims[1:]):
        layer = {}
        for t in tg.num_nodes:
            layer[f"root.{t}"] = _glorot(generator, fi, fo, dtype).to(device)
            layer[f"bias.{t}"] = torch.zeros(fo, dtype=dtype, device=device)
        for r in tg.relations:
            layer[f"rel.{r.name}"] = _glorot(generator, fi, fo,
                                             dtype).to(device)
        params.append(layer)
    return params


def rgcn_forward(
    params: list[dict], tg: TypedGraph, x: dict, impl: str = "auto",
    norm: Optional[dict] = None,
) -> dict:
    """Forward pass: type -> ``[n_pad(type), dims[-1]]`` outputs.  ``x``
    maps each featured type to its padded ``[n_pad(type), dims[0]]``
    rows; the embedded types' tables are padded with zero rows here.
    ``impl`` selects the SpMM (``auto``: banded on CUDA, ``xla`` on the
    CPU); ``norm`` (:func:`rgcn_normalize` at the model's widths) gives
    each relation's pre-banded mean weights."""
    global relation_sums
    h = dict(x)
    for key, table in params[0].items():
        t = key.split(".", 1)[1]
        h[t] = F.pad(table, (0, 0, 0, tg.n_pad(t) - table.shape[0]))
    layers = params[1:]
    for i, layer in enumerate(layers):
        out = {}
        with scope("rgcn.root"):
            for t in tg.num_nodes:
                out[t] = torch.addmm(layer[f"bias.{t}"], h[t],
                                     layer[f"root.{t}"])
        for r in tg.relations:
            with scope("rgcn.relation"):
                agg = _mean(r.graph, h[r.src], impl,
                            None if norm is None else norm[r.name])
                out[r.dst] = torch.addmm(out[r.dst], agg,
                                         layer[f"rel.{r.name}"])
            relation_sums += 1
        if i < len(layers) - 1:
            out = {t: torch.relu(v) for t, v in out.items()}
        h = out
    return h


# ------------------------------------------------------------- training
def rgcn_loss(
    params, tg: TypedGraph, x: dict, labels, label_mask, target: str,
    impl: str = "auto", norm: Optional[dict] = None,
) -> torch.Tensor:
    """Masked softmax cross-entropy over the labeled vertices of type
    ``target`` (the ``gcn_loss`` contract on that type's outputs)."""
    logits = rgcn_forward(params, tg, x, impl=impl, norm=norm)[target]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    nll = torch.where(label_mask, nll, 0.0)
    return nll.sum() / label_mask.sum().clamp(min=1)


def rgcn_train_step(
    params, opt_state, tg: TypedGraph, x: dict, batch, target: str,
    lr: float = 1e-2, impl: str = "auto", norm: Optional[dict] = None,
):
    """One SGD-with-momentum step (the ``gcn_train_step`` contract) over
    every parameter, the embedding tables included; ``batch = (labels,
    label_mask)`` of the ``target`` type's padded rows; ``norm`` as in
    :func:`rgcn_forward`."""
    labels, label_mask = batch
    return sgd_momentum_step(
        params, opt_state,
        lambda p: rgcn_loss(p, tg, x, labels, label_mask, target, impl,
                            norm), lr)


def rgcn_init_opt(params):
    """SGD-momentum state: zeros like the params."""
    return init_opt(params)
