"""Distributed GNN forwards and training beyond GCN: GAT and GraphSAGE
on the mesh.

Both follow ``parallel/gcn.py``: per-dst state and edges are shard-local
(``partition.py``), parameters are replicated, and the only cross-rank
traffic per layer is the feature slab (and for GAT the heads' source
scores): boundary-only slabs when a ``HaloPlan`` is given, a full
all-gather otherwise.  The aggregation is ``distributed.EdgeSum`` (the row
gather and the one-band segment sum, with their transposes as backward).

The GAT layer uses the fused-attention math of the single-device path
(``models/gat.py``, ``attn="fused"``): LeakyReLU's monotonicity makes
``LRelu(gmax + s_dst)`` an exact-form stabilizer bound (``gmax`` is one
``all_reduce(MAX)`` of a detached scalar a head: the bound cancels in the
normalized ratio, so its gradient is zero), the unnormalized weights
aggregate through the weighted edge sum, whose ones column per head
gives the denominator in the same launch, and the denominator divides per
vertex.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F_

from mini_tpu_torch.parallel.distributed import (
    _AllGather,
    _plan_args,
    axis_group,
    csc_edge_sum,
)
from mini_tpu_torch.parallel.gcn import dist_sgd_step, masked_xent
from mini_tpu_torch.parallel.halo import rank_halo
from mini_tpu_torch.parallel.partition import PartitionedGraph


class _Reader:
    """This rank's exchange of ``[n_loc, F]`` rows, differentiable:
    :meth:`table` is the all-gathered ``[n_pad, F]`` matrix, or with a
    plan the ``[D*H + n_loc, F]`` [halo | own] buffer; ``idx`` is each
    edge's row in it (``csc_srcs``, or the plan's ``src_slot``) and ``es``
    the edge sum over the real edges from it."""

    def __init__(self, pg, shards, mesh, axis, plan):
        self.group = axis_group(mesh, axis)
        self.rh = None
        if plan is None:
            self.idx = shards.csc_srcs[0].long()
            self.es = csc_edge_sum(pg, shards)
        else:
            self.rh = rank_halo(pg, plan, shards, mesh, axis)
            self.idx = _plan_args(pg, plan, shards)[1][0].long()
            self.es = self.rh.buf

    def table(self, x: torch.Tensor) -> torch.Tensor:
        if self.rh is None:
            return _AllGather.apply(x, self.group)
        return self.rh.table(x)


def _sage_invd(pg: PartitionedGraph, shard: int, device) -> torch.Tensor:
    invd = np.where(pg.in_degrees[shard] > 0,
                    1.0 / np.maximum(pg.in_degrees[shard], 1), 0.0)
    return torch.from_numpy(invd.astype(np.float32)).to(device)


def _sage_local(reader, x_loc, invd, params):
    """Per-shard SAGE forward body (shared by the forward and the train
    step)."""
    h = x_loc
    for i, layer in enumerate(params):
        agg = reader.es.apply(reader.table(h)) * invd[:, None]
        h = torch.matmul(torch.cat([h, agg], dim=-1), layer["w"]) + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def dist_sage_forward(
    pg: PartitionedGraph,
    shards,
    mesh,
    params: list,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's block
    axis: str = "graph",
    plan=None,
) -> torch.Tensor:
    """GraphSAGE mean-aggregator forward on the mesh: this rank's ``[1,
    n_loc, F_out]`` block of the single-device ``sage_forward``."""
    reader = _Reader(pg, shards, mesh, axis, plan)
    invd = _sage_invd(pg, shards.shard, shards.device)
    return _sage_local(reader, x[0], invd, params)[None]


def _gat_local(reader, shards, negative_slope, x_loc, params):
    """Per-shard fused-attention GAT forward body (shared by the forward
    and the train step): all heads of a layer in one exchange of the
    features, one of the source scores and one edge sum."""
    g = shards
    edst = g.csc_dsts_local[0].long()
    emask = g.edge_mask[0]
    m = reader.es.m
    h = x_loc
    n_layers = len(params)
    for i, layer in enumerate(params):
        n_heads, _, d = layer["w"].shape
        hws = [torch.matmul(h, layer["w"][hd]) for hd in range(n_heads)]
        s_src = torch.stack([hws[hd] @ layer["a_src"][hd]
                             for hd in range(n_heads)], dim=-1)  # [n_loc, H]
        s_dst = torch.stack([hws[hd] @ layer["a_dst"][hd]
                             for hd in range(n_heads)], dim=-1)
        gmax = s_src.detach().max(0).values
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=reader.group)
        e_src = reader.table(s_src).index_select(0, reader.idx)  # [m_loc, H]
        ed = s_dst.index_select(0, edst)
        e = F_.leaky_relu(e_src + ed, negative_slope)
        bound = F_.leaky_relu(gmax + ed, negative_slope)
        w = torch.where(emask[:, None], torch.exp(e - bound), 0.0)
        # each head's features beside a ones column: the sum's last column
        # is the head's denominator
        table = reader.table(torch.cat(hws, dim=-1))
        ones = table.new_ones(table.shape[0], 1)
        table = torch.cat([part for hd in range(n_heads)
                           for part in (table[:, hd * d: (hd + 1) * d], ones)],
                          dim=-1)
        out = reader.es.apply(table, w[:m]).view(-1, n_heads, d + 1)
        denom = out[:, :, d].clamp(min=1e-30)
        heads = [out[:, hd, :d] / denom[:, hd, None] for hd in range(n_heads)]
        if i < n_layers - 1:
            h = F_.elu(torch.cat(heads, dim=-1))
        else:
            h = sum(heads) / len(heads)
    return h


def dist_gat_forward(
    pg: PartitionedGraph,
    shards,
    mesh,
    params: list,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's block
    axis: str = "graph",
    negative_slope: float = 0.2,
    plan=None,
) -> torch.Tensor:
    """GAT forward on the mesh (fused-attention math, see module
    docstring): this rank's ``[1, n_loc, F_out]`` block of the
    single-device ``gat_forward`` to float tolerance."""
    reader = _Reader(pg, shards, mesh, axis, plan)
    return _gat_local(reader, shards, negative_slope, x[0], params)[None]


# ------------------------------------------------------------- training
def _train(local, pg, shards, mesh, params, labels, mask, steps, lr, axis):
    """``steps`` momentum-SGD steps on ``local(params) -> logits``; the
    gradient is the single-device one (see ``parallel/gcn.py``)."""
    group = axis_group(mesh, axis)
    params = [{k: v.to(shards.device) for k, v in p.items()} for p in params]
    opt = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    losses = []
    for _ in range(steps):
        params, opt, loss = dist_sgd_step(params, opt, lambda p: masked_xent(
            local(p), labels[0], mask[0], group), lr, group)
        losses.append(float(loss))
    return params, losses


def dist_sage_train(
    pg: PartitionedGraph,
    shards,
    mesh,
    params: list,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's block
    labels: torch.Tensor,  # [1, n_loc] int
    mask: torch.Tensor,  # [1, n_loc] bool
    steps: int = 1,
    lr: float = 0.05,
    axis: str = "graph",
    plan=None,
):
    """Distributed GraphSAGE training: the shared per-shard forward, the
    ranks' summed gradients on replicated params, momentum SGD (the
    ``dist_gcn_train`` recipe over the SAGE forward).  Returns (params,
    losses), the same on every rank."""
    reader = _Reader(pg, shards, mesh, axis, plan)
    invd = _sage_invd(pg, shards.shard, shards.device)
    return _train(lambda p: _sage_local(reader, x[0], invd, p), pg, shards,
                  mesh, params, labels, mask, steps, lr, axis)


def dist_gat_train(
    pg: PartitionedGraph,
    shards,
    mesh,
    params: list,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's block
    labels: torch.Tensor,  # [1, n_loc] int
    mask: torch.Tensor,  # [1, n_loc] bool
    steps: int = 1,
    lr: float = 0.05,
    axis: str = "graph",
    negative_slope: float = 0.2,
    plan=None,
):
    """Distributed GAT training: the fused-attention forward
    differentiated end to end (the stabilizer bound carries no
    gradient), the ranks' summed gradients, momentum SGD.  Returns
    (params, losses), the same on every rank."""
    reader = _Reader(pg, shards, mesh, axis, plan)
    return _train(
        lambda p: _gat_local(reader, shards, negative_slope, x[0], p), pg,
        shards, mesh, params, labels, mask, steps, lr, axis)
