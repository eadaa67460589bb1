"""Distributed GCN over the edge-partitioned graph (2-layer GCN,
edge-partitioned across N >= 2 devices).

Sharding layout: activations row-sharded by the dst-range vertex
partition (``parallel/partition.py``); parameters replicated on every
rank.  Each layer computes the dense ``H @ W`` locally, exchanges the
projected feature slab (an all-gather over the graph axis, or with a
``HaloPlan`` the boundary-only all-to-all, optionally overlapped with the
own-edge aggregation), and reduces its own in-edges locally with the
one-band segment sum (``distributed.EdgeSum``).

The gradient.  Every rank differentiates its share of the global loss
(its masked NLL sum over the global label count); the collectives'
backwards (the reduce-scatter, the reverse exchange) carry each share's
cotangents to the rows' owners, and the ranks' parameter gradients are
summed (``all_reduce``): the result is the single-device gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from mini_tpu_torch.models._sgd import sgd_momentum_step
from mini_tpu_torch.parallel.distributed import (
    DeviceShards,
    _AllGather,
    all_reduce,
    axis_group,
    csc_edge_sum,
)
from mini_tpu_torch.parallel.halo import rank_halo
from mini_tpu_torch.parallel.partition import PartitionedGraph
from mini_tpu_torch.utils.device import resolve_device

# H @ W in full float32, as JAX computes it (no TF32 on the card)
torch.backends.cuda.matmul.allow_tf32 = False


def gcn_norm_arrays(pg: PartitionedGraph, *, device=None):
    """Global inv-sqrt(deg_hat) ``[n_pad]`` (replicated) and the
    per-shard self coefficients ``[D, n_loc]``, on ``device`` (``None``:
    the card).  deg_hat = in_degree + 1 (the single-device
    ``models/gcn.gcn_normalize``)."""
    device = resolve_device(device)
    deg_hat = np.ones(pg.n_pad, np.float32)
    deg_hat[: pg.n] += pg.in_degrees.reshape(-1)[: pg.n]
    inv_sqrt = 1.0 / np.sqrt(deg_hat)
    real = np.arange(pg.n_pad) < pg.n
    self_coeff = np.where(real, 1.0 / deg_hat, 0.0).astype(np.float32)
    return (torch.from_numpy(inv_sqrt).to(device),
            torch.from_numpy(self_coeff.reshape(pg.num_shards, pg.n_loc)).to(
                device))


def masked_xent(logits, labels_loc, mask_loc, group):
    """This rank's share of the global mean masked cross-entropy: its NLL
    sum over the global label count."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels_loc.long()[:, None])[:, 0]
    nll = torch.where(mask_loc, nll, 0.0)
    count = all_reduce(mask_loc.sum(dtype=torch.int32).reshape(1), group)
    return nll.sum() / count.clamp(min=1).to(nll.dtype)[0]


def dist_sgd_step(params, opt, share_fn, lr, group):
    """One momentum-SGD step (``models/_sgd.py``) on the ranks' summed
    gradients of ``share_fn(params)``, each rank's share of the loss.
    Returns (params, opt, the global loss)."""
    def summed(grads):  # one all-reduce of every gradient, flattened
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
        return [f.view(g.shape) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)]

    params, opt, share = sgd_momentum_step(params, opt, share_fn, lr,
                                           summed)
    return params, opt, all_reduce(share.reshape(1), group)[0]


def dist_gcn_train_step_fn(
    pg: PartitionedGraph,
    mesh,
    axis="graph",
    lr: float = 0.05,
    halo_plan=None,
    overlap: bool = False,
):
    """Build the training step.

    Returns ``step(shards, params, opt, x, labels, mask, inv_sqrt,
    self_coeff) -> (params, opt, loss)``; ``x``/``labels``/``mask``/
    ``self_coeff`` are this rank's ``[1, n_loc, ...]`` blocks,
    ``params``/``opt``/``inv_sqrt`` replicated, ``loss`` the global loss
    as a float.  With ``halo_plan`` the feature exchange is the
    boundary-only all-to-all instead of a full all-gather;
    ``overlap=True`` additionally splits the aggregation so the own-edge
    part runs while the collective is in flight (forward and backward).
    ``axis`` may be a ("dcn", "ici") pair for the hierarchical 2-level
    exchange on a 2-level mesh."""
    n_loc = pg.n_loc
    group = axis_group(mesh, axis)
    state: dict = {}

    def setup(g: DeviceShards, inv_sqrt):
        """The rank's edge sums and edge weights, made at its first step."""
        if state:
            return state
        s = g.shard
        esrc, edst, emask = g.csc_srcs[0], g.csc_dsts_local[0], g.edge_mask[0]
        # symmetric normalization: w_e = inv_sqrt[src] * inv_sqrt[dst]
        ew = torch.where(
            emask, inv_sqrt[esrc.long()] * inv_sqrt[edst.long() + s * n_loc],
            0.0)
        state["ew"] = ew[: g.m_real]
        if halo_plan is None:
            state["es"] = csc_edge_sum(pg, g)
            return state
        rh = state["rh"] = rank_halo(pg, halo_plan, g, mesh, axis)
        if overlap:
            for part in ("own", "halo"):
                es = getattr(rh, part)
                srcg = rh.plan_row(f"{part}_src_global", es).long()
                dst = rh.plan_row(f"{part}_dst", es).long()
                state[f"ew_{part}"] = (inv_sqrt[srcg]
                                       * inv_sqrt[dst + s * n_loc])
        return state

    def forward(st, params, x_loc, self_c):
        h = x_loc
        for i, layer in enumerate(params):
            hw = torch.matmul(h, layer["w"])
            if halo_plan is None:
                agg = st["es"].apply(_AllGather.apply(hw, group), st["ew"])
            elif overlap:
                agg = st["rh"].overlap_sum(hw, st["ew_own"], st["ew_halo"])
            else:
                agg = st["rh"].buf.apply(st["rh"].table(hw), st["ew"])
            h = agg + self_c[:, None] * hw + layer["b"]
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    def step(g, params, opt, x, labels, mask, inv_sqrt, self_c):
        st = setup(g, inv_sqrt)
        return dist_sgd_step(params, opt, lambda p: masked_xent(
            forward(st, p, x[0], self_c[0]), labels[0], mask[0], group),
            lr, group)

    return step


def dist_gcn_train(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh,
    params,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's block
    labels: torch.Tensor,  # [1, n_loc]
    mask: torch.Tensor,  # [1, n_loc]
    steps: int = 1,
    lr: float = 0.05,
    axis="graph",
    halo_plan=None,
    overlap: bool = False,
):
    """Run ``steps`` distributed training steps; returns (params, losses),
    the same on every rank."""
    inv_sqrt, self_c = gcn_norm_arrays(pg, device=shards.device)
    self_c = self_c[shards.shard: shards.shard + 1]
    params = [{k: v.to(shards.device) for k, v in p.items()} for p in params]
    opt = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    step = dist_gcn_train_step_fn(
        pg, mesh, axis=axis, lr=lr, halo_plan=halo_plan, overlap=overlap
    )
    losses = []
    for _ in range(steps):
        params, opt, loss = step(
            shards, params, opt, x, labels, mask, inv_sqrt, self_c
        )
        losses.append(float(loss))
    return params, losses
