"""The GCN train step over a 2-D ("graph", "feat") mesh: graph-parallel
rows, tensor-parallel columns.

``mini_tpu`` runs ``models/gcn.gcn_train_step`` under GSPMD on a
``(graph_par, feat_par)`` mesh (part 2 of ``dryrun_multichip``): ``x``
row-sharded over ``graph``, each ``w`` and its momentum column-sharded
over ``feat``, each ``b`` replicated, the collectives inserted by XLA.
Here the same step is written out for one rank a device::

    mesh = make_mesh_2d(device="cpu")          # D ranks: (D / fp) x fp
    pg = partition_graph(hg, mesh.size(0))
    shards = shard_to_mesh(pg, mesh, axis="graph")
    params = shard_gcn_params_2d(params, mesh)  # and the momentum alike
    params, opt, loss = gcn_train_step_2d(params, opt, pg, shards, x,
                                          (labels, mask), mesh=mesh)

Rank ``(g, f)`` (consecutive ranks share a graph row, as JAX's
``devices.reshape(graph_par, feat_par)``) holds graph shard ``g``, with
its ``[1, n_loc, ...]`` rows of ``x``, the labels and the mask, and
column block ``f`` of every ``w`` and of its momentum; ``b`` and its
momentum are whole.  Each layer:

1. ``hw = h @ w[:, f-block]``, ``[n_loc, F / fp]``;
2. ``hw`` all-gathered over ``graph``;
3. the shard's in-edges summed (``distributed.EdgeSum``: the row gather
   and the one-band segment sum), so ``graph`` divides the edge work and
   ``feat`` its width;
4. ``+ self_coeff * hw + b[f-block]``, the ReLU but on the last layer;
5. the columns all-gathered over ``feat`` for the next matmul (the
   logits for the loss); the backward is the columns' reduce-scatter.

The loss and the gradient.  Every feat rank of a graph row computes the
same share of the loss from the gathered logits, so each back-propagates
``1 / fp`` of it and the columns' reduce-scatter adds the ``fp`` copies
into one.  A ``w`` block's gradient is summed over ``graph``; ``b``'s
over the whole mesh (a rank's ``b`` gradient is its own block's).  One
all-reduce each gives every replica the same bits, so the replicas stay
bitwise equal after the momentum update.
"""

from __future__ import annotations

import torch

from mini_tpu_torch.models._sgd import sgd_momentum_step
from mini_tpu_torch.parallel.distributed import (
    DeviceShards,
    _AllGather,
    _world,
    all_gather_cols,
    all_reduce,
    csc_edge_sum,
    make_mesh_2level,
)
from mini_tpu_torch.parallel.gcn import (
    gcn_norm_arrays,
    masked_xent,
    shard_edge_weights,
    sum_over,
)
from mini_tpu_torch.parallel.partition import PartitionedGraph
from mini_tpu_torch.utils.device import resolve_device

AXES = ("graph", "feat")


def feat_par_for(n_devices: int) -> int:
    """The ``feat`` axis's size for ``n_devices`` ranks: 2 when even, else
    1 (``__graft_entry__.dryrun_multichip``'s rule)."""
    return 2 if n_devices % 2 == 0 else 1


def make_mesh_2d(num_devices: int | None = None, *, device=None):
    """The ``("graph", "feat")`` mesh over every rank of the default group,
    ``feat`` of :func:`feat_par_for` ranks, on the card (NCCL) unless
    ``device="cpu"`` (gloo).  ``num_devices`` must equal the world size."""
    world = _world(resolve_device(device))
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}: the process group has "
                         f"{world} ranks, one a device")
    fp = feat_par_for(world)
    return make_mesh_2level(world // fp, fp, axes=AXES, device=device)


def _feat(mesh) -> tuple[int, int]:
    """This rank's column block and the number of blocks."""
    return mesh.get_local_rank("feat"), mesh.size(AXES.index("feat"))


def shard_gcn_params_2d(params: list[dict], mesh) -> list[dict]:
    """This rank's blocks of GCN parameters (or of their momentum, the same
    layout): ``w[:, f-block]`` (``[F_in, F_out / fp]``) and ``b`` whole.
    Parameters from the JAX package go through ``models/gcn.params_from_jax``
    first."""
    f, fp = _feat(mesh)
    out = []
    for p in params:
        F = p["w"].shape[1]
        if F % fp:
            raise ValueError(f"{F} columns do not split into {fp} blocks")
        blk = F // fp
        out.append({"w": p["w"][:, f * blk: (f + 1) * blk].contiguous(),
                    "b": p["b"]})
    return out


def gather_gcn_params_2d(blocks: list[dict], mesh) -> list[dict]:
    """The whole parameters (or momentum) from every rank's blocks: the
    inverse of :func:`shard_gcn_params_2d`, the same on every rank."""
    group = mesh.get_group("feat")
    return [{"w": all_gather_cols(p["w"].contiguous(), group), "b": p["b"]}
            for p in blocks]


def _setup(pg: PartitionedGraph, shards: DeviceShards):
    """The shard's edge sum, edge weights and self coefficients, made once
    (kept on the shards)."""
    def build():
        inv_sqrt, self_c = gcn_norm_arrays(pg, device=shards.device)
        return (csc_edge_sum(pg, shards),
                shard_edge_weights(pg, shards, inv_sqrt),
                self_c[shards.shard])

    return shards.cached("gcn_2d", build, pg)


def gcn_train_step_2d(
    params: list[dict],
    opt: list[dict],
    pg: PartitionedGraph,
    shards: DeviceShards,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's rows
    batch,  # (labels [1, n_loc], mask [1, n_loc])
    lr: float = 0.05,
    *,
    mesh,
):
    """One SGD-with-momentum step (``m = 0.9 m + grad; p = p - lr m``) of
    the GCN over the ``("graph", "feat")`` mesh (module doc).  ``params``
    and ``opt`` are this rank's blocks (:func:`shard_gcn_params_2d`),
    ``shards`` its graph shard (``shard_to_mesh(pg, mesh, axis="graph")``).
    Returns ``(params, opt, loss)`` as ``models/gcn.gcn_train_step`` does:
    the new blocks and the global loss, the same on every rank."""
    graph, feat, world = mesh.get_group("graph"), mesh.get_group("feat"), None
    f, fp = _feat(mesh)
    es, ew, self_c = _setup(pg, shards)
    labels, mask = batch

    def share(p):
        h = x[0]
        for i, layer in enumerate(p):
            blk = layer["w"].shape[1]
            hw = torch.matmul(h, layer["w"])
            agg = es.apply(_AllGather.apply(hw, graph), ew)
            h = agg + self_c[:, None] * hw + layer["b"][f * blk:
                                                        (f + 1) * blk]
            if i < len(p) - 1:
                h = torch.relu(h)
            h = _AllGather.apply(h, feat, 1)
        return masked_xent(h, labels[0], mask[0], graph) / fp

    keys = [k for p in params for k in p]

    def summed(grads):
        w = sum_over([g for k, g in zip(keys, grads) if k == "w"], graph)
        b = sum_over([g for k, g in zip(keys, grads) if k != "w"], world)
        w, b = iter(w), iter(b)
        return [next(w) if k == "w" else next(b) for k in keys]

    params, opt, loss = sgd_momentum_step(params, opt, share, lr, summed)
    return params, opt, all_reduce(loss.reshape(1), world)[0]
