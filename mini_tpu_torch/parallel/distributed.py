"""Multi-device execution: one ``torch.distributed`` rank a device.

``mini_tpu``'s ``shard_map`` over a ``jax.sharding.Mesh`` becomes a
program that every rank of a process group runs on its own device (one
NCCL rank a card; ``gloo`` ranks when the caller asks for the CPU).  The
body of each JAX ``shard_map`` is the rank's code here, line for line:

* ``DeviceShards`` holds THIS rank's block of the partitioned graph, with
  the leading shard axis kept at size 1, so ``g.csc_srcs[0]`` reads as in
  JAX.  Inputs that JAX shards over the mesh axis (features, labels,
  masks, weights) are passed as the rank's block, ``[1, n_loc, ...]``.
* Outputs that JAX shards over the mesh axis come back as this rank's
  block: ``dist_bfs``'s labels (JAX: ``labels.reshape(-1)``, ``[n_pad]``)
  are ``[n_loc]``, ``dist_spmm``'s ``[D, n_loc, F]`` is ``[1, n_loc, F]``.
  Replicated outputs (params, losses, L-Spar's count, the round counts)
  are the same on every rank.
* Collectives: ``all_gather(tiled=True)`` is ``all_gather_into_tensor``,
  ``psum`` is ``all_reduce(SUM)``, ``all_to_all(split_axis=0,
  tiled=True)`` is ``all_to_all_single`` (``halo.exchange_slabs``).
  Under autograd they are this module's own ``torch.autograd.Function``s
  over those c10d calls (:class:`_AllGather`, whose backward is the
  reduce-scatter; ``halo._Exchange``, whose backward is the exchange
  itself), not ``torch.distributed._functional_collectives`` nor
  ``torch.distributed.nn``: a c10d call returns with its result ordered
  on the stream, so a kernel that reads a raw pointer reads it, where a
  functional collective returns a tensor that waits only at its next
  torch op; and ``torch.distributed.nn`` is deprecated in torch 2.13.
* ``lax.while_loop`` with a psum'd ``alive``/``changed`` becomes a host
  loop with one device-to-host read a round: the all-reduced count.

The per-shard reductions run on the port's kernels, because every
shard's edges are CSC-sorted by local destination with ``col_offsets``:
the traversal reductions on the contiguous-segment reduce
(``segreduce_kernel.segment_reduce``), the feature aggregations on the
one-band segment sum (``spmm_kernel.segment_sum``, through
:class:`EdgeSum`), the exchanged slabs' and the edges' source rows on the
row gather (``gather_rows``).  On CPU tensors the wrappers take their
plain versions.

Every traversal here takes an optional ``plan`` (a
``parallel.halo.HaloPlan``): with it, the per-iteration exchange is
**boundary-only** (one all-to-all of D x H slabs, H = max boundary rows)
instead of all-gathering the full n-vector; edges then read from the
[halo | own] buffer through the plan's static ``src_slot`` map.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from mini_tpu_torch.graph.csr import _round_up
from mini_tpu_torch.ops.kernels.gather_rows import gather_rows
from mini_tpu_torch.ops.kernels.segreduce_kernel import segment_reduce
from mini_tpu_torch.ops.kernels.spmm_kernel import segment_sum
from mini_tpu_torch.parallel.partition import PartitionedGraph
from mini_tpu_torch.utils.device import resolve_device

TILE = 128  # the segment-sum kernel's row tile and edge chunk
INT_MAX = int(torch.iinfo(torch.int32).max)

# the c10d names of torch 2.13 (the older ones warn there) and of 2.11
_all_gather_base = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# ------------------------------------------------------------------ mesh
def _world(device: torch.device) -> int:
    """The default group's size, after checking that its backend serves
    ``device`` (NCCL for the card, gloo for the CPU): nothing falls back."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start the ranks with "
            "mini_tpu_torch.parallel.launch.run_ranks or torchrun")
    backend = str(dist.get_backend())
    want = "nccl" if device.type == "cuda" else "gloo"
    if want not in backend:
        raise RuntimeError(f"the process group's backend is {backend!r}; "
                           f"a {device.type} mesh needs {want}")
    return dist.get_world_size()


def make_mesh(num_devices: int | None = None, axis: str = "graph", *,
              device=None):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the default
    group, on the card (NCCL) unless ``device="cpu"`` (gloo).  JAX takes a
    prefix of ``jax.devices()``; here ``num_devices`` must equal the
    group's world size, or this raises."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    world = _world(device)
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}: the process group has "
                         f"{world} ranks, one a device")
    return init_device_mesh(device.type, (world,), mesh_dim_names=(axis,))


def make_mesh_2level(
    num_slices: int,
    per_slice: int | None = None,
    axes: tuple[str, str] = ("dcn", "ici"),
    *,
    device=None,
):
    """(DCN, ICI) 2-level mesh: ``num_slices`` groups of ``per_slice``
    ranks.  Consecutive ranks form a slice, so collectives over
    ``axes[1]`` stay inside a slice and those over ``axes[0]`` cross
    slices.  Graph shards flatten as ``slice_idx * per_slice + idx``.
    The slices must cover the group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    world = _world(device)
    if per_slice is None:
        per_slice = world // num_slices
    if num_slices * per_slice != world:
        raise ValueError(f"{num_slices} x {per_slice} ranks for a process "
                         f"group of {world}")
    return init_device_mesh(device.type, (num_slices, per_slice),
                            mesh_dim_names=tuple(axes))


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axis_size(mesh, axis) -> int:
    return int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                        for a in _axes(axis)]))


def _shard_index(mesh, axis) -> int:
    """This rank's flat position on ``axis`` (one name or a pair)."""
    idx = 0
    for a in _axes(axis):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return idx


def axis_group(mesh, axis):
    """The process group of ``axis``; for a pair of axes that spans the
    mesh, the default group (None)."""
    if isinstance(axis, str):
        return mesh.get_group(axis)
    if (tuple(axis) != tuple(mesh.mesh_dim_names)
            or mesh.size() != dist.get_world_size()):
        raise ValueError(f"axes {axis} must be the mesh's "
                         f"{mesh.mesh_dim_names} over every rank")
    return None


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class DeviceShards:
    """This rank's block of the shard arrays, leading axis of size 1, on
    the mesh's device; ``shard`` is the block's index and ``m_real`` its
    real (unpadded) edge count.  ``cache`` keeps what the operators build
    from the shards once (edge sums, a plan's index maps on the device),
    as JAX keeps a jitted program."""

    col_offsets: torch.Tensor
    csc_srcs: torch.Tensor
    csc_dsts_local: torch.Tensor
    csc_weights: torch.Tensor
    edge_mask: torch.Tensor
    in_degrees: torch.Tensor
    out_degrees: torch.Tensor
    shard: int = 0
    m_real: int = 0
    cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def device(self) -> torch.device:
        return self.csc_srcs.device

    def cached(self, name: str, build, *owners):
        """``build()``, made once for ``name`` and the objects ``owners``
        (held with it, so their ids cannot be reused while it lives)."""
        key = (name,) + tuple(id(o) for o in owners)
        hit = self.cache.get(key)
        if hit is None:
            hit = self.cache[key] = (owners, build())
        return hit[1]


def shard_to_mesh(pg: PartitionedGraph, mesh, axis="graph") -> DeviceShards:
    """This rank's rows of ``pg`` on the mesh's device.  ``axis`` may be
    one mesh axis name or a ("dcn", "ici") pair; the shard is then the
    rank's flat position (``dcn_idx * D_ici + ici``)."""
    D = _axis_size(mesh, axis)
    if D != pg.num_shards:
        raise ValueError(f"{pg.num_shards} shards for a mesh axis of {D}")
    s = _shard_index(mesh, axis)
    device = mesh_device(mesh)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[s: s + 1])).to(device)

    return DeviceShards(
        col_offsets=put(pg.col_offsets),
        csc_srcs=put(pg.csc_srcs),
        csc_dsts_local=put(pg.csc_dsts_local),
        csc_weights=put(pg.csc_weights),
        edge_mask=put(pg.edge_mask),
        in_degrees=put(pg.in_degrees),
        out_degrees=put(pg.out_degrees),
        shard=s,
        m_real=int(pg.col_offsets[s, -1]),
    )


# ------------------------------------------------------ collectives
def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-gather along axis 0."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] * dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    _all_gather_base(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``psum`` (or another ``op``) of a tensor, out of place."""
    x = x.clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-gather of ``[n, b]`` blocks along axis 1: ``[n, D b]``,
    the ranks' column blocks in rank order."""
    k = dist.get_world_size(group)
    return all_gather(x, group).view((k,) + tuple(x.shape)).transpose(
        0, 1).reshape(x.shape[0], k * x.shape[1])


class _AllGather(torch.autograd.Function):
    """:func:`all_gather` (``dim=0``, the rows) or :func:`all_gather_cols`
    (``dim=1``) with its transpose, the reduce-scatter (a sum over the
    ranks of each rank's block's cotangents), as its backward."""

    @staticmethod
    def forward(ctx, x, group, dim=0):
        ctx.group, ctx.dim = group, dim
        return all_gather_cols(x, group) if dim else all_gather(x, group)

    @staticmethod
    def backward(ctx, ct):
        k = dist.get_world_size(ctx.group)
        if ctx.dim:  # [n, k b] -> the ranks' blocks stacked, [k n, b]
            n = ct.shape[0]
            ct = ct.view(n, k, -1).transpose(0, 1).reshape(k * n, -1)
        ct = ct.contiguous()
        out = ct.new_empty((ct.shape[0] // k,) + tuple(ct.shape[1:]))
        _reduce_scatter_base(out, ct, group=ctx.group)
        return out, None, None


# ------------------------------------------------- per-shard kernels
def gather_vec(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals[idx]`` for a vector, by the row gather (rows of one value)."""
    return gather_rows(vals.reshape(-1, 1), idx).reshape(-1)


def shard_reduce(g: DeviceShards, vals: torch.Tensor, op: str):
    """``segment_reduce(vals, edst, n_loc, op)`` over this shard's CSC
    segments: one launch of the contiguous-segment kernel over
    ``col_offsets`` (pad edges lie past the last offset; the plain
    version folds them into the last segment, so they must hold the
    identity, as every caller's mask makes them).  ``or`` reduces int32
    0/1 values by ``max`` and returns bool."""
    off, edst = g.col_offsets[0], g.csc_dsts_local[0]
    if op == "or":
        return segment_reduce(off, edst, vals.to(torch.int32), "max") > 0
    return segment_reduce(off, edst, vals, op)


class EdgeSum:
    """``out[v] = sum_e w_e * table[idx_e]`` over edges sorted by ``v``
    (the row of ``out`` each adds into): one row gather and one launch of
    the one-band segment sum, whose row tile the rows are padded to (empty
    segments, sliced off) and whose edge chunk the edges are padded to.
    ``w`` is ``[m]``, or ``[m, Hh]`` for ``Hh`` heads of ``F / Hh``
    columns each, or None (unit weights).  Built once on the host from
    the real edges; :meth:`transpose` (the same sum by source row, for a
    backward) is built at its first use."""

    def __init__(self, idx, rows, n_out: int, n_table: int, device):
        idx = np.asarray(idx, np.int64)
        rows = np.asarray(rows, np.int64)
        self.m, self.n_out, self.n_table = len(idx), n_out, n_table
        self.device = device
        self._host = (idx, rows)
        self._t = None
        m_k = _round_up(max(self.m, 1), TILE)
        idx_k = np.zeros(m_k, np.int32)
        idx_k[: self.m] = idx
        offsets = np.searchsorted(
            rows, np.arange(_round_up(max(n_out, 1), TILE) + 1)
        ).astype(np.int32)
        self.idx = torch.from_numpy(idx_k).to(device)
        self.rows = torch.from_numpy(rows.astype(np.int32)).to(device)
        self.offsets = torch.from_numpy(offsets).to(device)

    @classmethod
    def of_gather(cls, idx, n_table: int, device) -> "EdgeSum":
        """The transpose of the row gather ``table[idx]``: the scatter-add
        of ``[len(idx), F]`` rows into the ``n_table`` rows they came
        from."""
        idx = np.asarray(idx, np.int64)
        perm = np.argsort(idx, kind="stable")
        return cls(perm, idx[perm], n_table, len(idx), device)

    def transpose(self) -> "EdgeSum":
        """The same edges summed into the table's rows; its ``perm`` maps
        its edges to this sum's (weights follow as ``w[perm]``)."""
        if self._t is None:
            idx, rows = self._host
            perm = np.argsort(idx, kind="stable")
            t = EdgeSum(rows[perm], idx[perm], self.n_table, self.n_out,
                        self.device)
            t.perm = torch.from_numpy(perm).to(self.device)
            self._t = t
        return self._t

    def __call__(self, table: torch.Tensor, w=None) -> torch.Tensor:
        """The sum, without a gradient (see :meth:`apply`)."""
        msgs = gather_rows(table.contiguous(), self.idx)
        if w is not None:
            m_k, F = msgs.shape
            wp = w.new_zeros((m_k,) + tuple(w.shape[1:]))
            wp[: self.m] = w
            hh = 1 if w.ndim == 1 else w.shape[1]
            msgs = (msgs.view(m_k, hh, F // hh) * wp.view(m_k, hh, 1)).view(
                m_k, F)
        return segment_sum(self.offsets, None, msgs)[: self.n_out]

    def apply(self, table: torch.Tensor, w=None) -> torch.Tensor:
        """The sum with its gradient to ``table`` (and to ``w``)."""
        return _EdgeSumFn.apply(table, w, self)


class _EdgeSumFn(torch.autograd.Function):
    """:class:`EdgeSum` with its transpose as the table's backward; the
    weights' cotangent, a dot of each edge's table row with its output
    row's cotangent, is plain torch (JAX computes it in XLA)."""

    @staticmethod
    def forward(ctx, table, w, es):
        ctx.es = es
        ctx.save_for_backward(table, w)
        return es(table, w)

    @staticmethod
    def backward(ctx, ct):
        table, w = ctx.saved_tensors
        es = ctx.es
        ct = ct.contiguous()
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            t = es.transpose()
            d_table = t(ct, None if w is None else w[t.perm])
        if ctx.needs_input_grad[1]:
            hh = 1 if w.ndim == 1 else w.shape[1]
            src = gather_rows(table.contiguous(), es.idx)[: es.m]
            dst = ct.index_select(0, es.rows.long())
            d_w = (src * dst).view(es.m, hh, -1).sum(-1).view(w.shape)
        return d_table, d_w, None


# ------------------------------------------------------- the exchange
def _plan_args(pg: PartitionedGraph, plan, shards: DeviceShards):
    """This rank's rows of the halo plan's static index maps on the
    shards' device, made once (or 1-wide dummies when no plan is given;
    the branch that would read them is never taken)."""
    def build():
        D, s = pg.num_shards, shards.shard
        if plan is None:
            send_idx = np.zeros((D, 1, 1), np.int32)
            src_slot = np.zeros((D, 1), np.int32)
        else:
            send_idx, src_slot = plan.send_idx, plan.src_slot
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a[s: s + 1])).to(
                shards.device) for a in (send_idx, src_slot))

    return shards.cached("plan_args", build, pg, plan)


def _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot, *, mesh):
    """Per-iteration exchange: returns read(vals_loc) -> per-edge values.

    With a plan: gather this shard's boundary rows, one all-to-all of
    [D, H] slabs (``halo.exchange_slabs``), read edges from [halo | own]
    through the static src_slot map (wire traffic D*H rows).  Without:
    all-gather the full n-vector and read by global source id.  Values are
    int32 or float32 vectors (a bool frontier goes as int32)."""
    from mini_tpu_torch.parallel.halo import exchange_slabs

    if not use_plan:
        group = axis_group(mesh, axis)

        def read(vals_loc):
            return gather_vec(all_gather(vals_loc, group), esrc)
        return read

    D, H = send_idx.shape[1], send_idx.shape[2]
    send, slot = send_idx[0].reshape(-1), src_slot[0]

    def read(vals_loc):
        rows = gather_vec(vals_loc, send).reshape(D, H, 1)
        halo = exchange_slabs(rows, axis, mesh=mesh)  # sender-major
        return gather_vec(torch.cat([halo.reshape(D * H), vals_loc]), slot)

    return read


def _start(n_loc: int, shard: int, src: int, value, fill, dtype, device):
    """A ``[n_loc]`` block filled with ``fill``, ``value`` at ``src`` when
    this shard owns it."""
    out = torch.full((n_loc,), fill, dtype=dtype, device=device)
    if src // n_loc == shard:
        out[src % n_loc] = value
    return out


def _count(x: torch.Tensor, group) -> int:
    """``psum(sum(x))`` read on the host: the round's one read."""
    return int(all_reduce(x.sum(dtype=torch.int32).reshape(1), group))


# ---------------------------------------------------------- traversals
def make_dist_bfs(
    pg: PartitionedGraph,
    mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Build-once factory: returns ``call(shards, src) -> (labels,
    preds)``, this rank's ``[n_loc]`` blocks."""
    n_pad, n_loc = pg.n_pad, pg.n_loc
    if max_iter is None:
        max_iter = n_pad
    use_plan = plan is not None
    group = axis_group(mesh, axis)

    def call(shards: DeviceShards, src: int):
        g = shards
        esrc, edst = g.csc_srcs[0], g.csc_dsts_local[0]
        emask = g.edge_mask[0]
        send_idx, src_slot = _plan_args(pg, plan, g)
        read = _make_edge_reader(use_plan, axis, esrc, send_idx, src_slot,
                                 mesh=mesh)
        edst_l = edst.long()
        big = torch.full_like(esrc, INT_MAX)
        labels = _start(n_loc, g.shard, src, 0, -1, torch.int32, g.device)
        preds = torch.full_like(labels, -1)
        vis = _start(n_loc, g.shard, src, True, False, torch.bool, g.device)
        it = 0
        while it < max_iter and _count(vis, group) > 0:
            unvisited = labels == -1
            active = ((read(vis.to(torch.int32)) > 0)
                      & unvisited[edst_l] & emask)
            new_vis = shard_reduce(g, active, "or")
            new_pred = shard_reduce(g, torch.where(active, esrc, big), "min")
            labels = torch.where(new_vis, it + 1, labels)
            preds = torch.where(new_vis, new_pred, preds)
            vis = new_vis
            it += 1
        return labels, preds

    return call


def dist_bfs(
    pg: PartitionedGraph,
    shards: DeviceShards,
    src: int,
    mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed BFS: labels sharded by dst range; per iteration each
    shard reduces its local in-edges against the exchanged frontier
    (boundary-only slabs with a ``plan``, full all-gather without).
    Returns this rank's ``(labels, preds)`` blocks; preds are the
    min-id parent."""
    return make_dist_bfs(pg, mesh, axis, max_iter, plan)(shards, src)


def dist_sssp(
    pg: PartitionedGraph,
    shards: DeviceShards,
    src: int,
    mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed Bellman-Ford: distances sharded by dst range; per
    iteration each shard relaxes its local in-edges against the exchanged
    improved-distance vector (float32 segmented min, bitwise the
    single-device result).  Returns this rank's ``[n_loc]`` block."""
    n_pad, n_loc = pg.n_pad, pg.n_loc
    if max_iter is None:
        max_iter = n_pad
    group = axis_group(mesh, axis)
    g = shards
    esrc, ew, emask = g.csc_srcs[0], g.csc_weights[0], g.edge_mask[0]
    send_idx, src_slot = _plan_args(pg, plan, g)
    read = _make_edge_reader(plan is not None, axis, esrc, send_idx,
                             src_slot, mesh=mesh)
    inf = float("inf")
    dist_ = _start(n_loc, g.shard, src, 0.0, inf, torch.float32, g.device)
    masked = dist_.clone()
    it = 0
    while it < max_iter and _count(torch.isfinite(masked), group) > 0:
        cand = torch.where(emask, read(masked) + ew, inf)
        best = shard_reduce(g, cand, "min")
        improved = best < dist_
        dist_ = torch.minimum(dist_, best)
        masked = torch.where(improved, dist_, inf)
        it += 1
    return dist_


def make_dist_spmm(
    pg: PartitionedGraph,
    mesh,
    axis: str = "graph",
    with_weights: bool = False,
):
    """Build-once factory for the all-gather distributed pull-SpMM:
    returns ``call(shards, x[, weights]) -> [1, n_loc, F]``, ``x`` this
    rank's ``[1, n_loc, F]`` block, ``weights`` its ``[1, m_loc]`` block in
    CSC order."""
    group = axis_group(mesh, axis)

    def call(shards, x, weights=None):
        es = csc_edge_sum(pg, shards)
        w = weights[0] if with_weights else shards.csc_weights[0]
        x_full = all_gather(x[0], group)  # [n_pad, F]
        return es(x_full, w[: es.m])[None]

    return call


def csc_edge_sum(pg: PartitionedGraph, shards: DeviceShards) -> EdgeSum:
    """The shard's real CSC edges as an :class:`EdgeSum` from the
    all-gathered ``[n_pad, F]`` table (global source ids), made once."""
    s, m = shards.shard, shards.m_real
    return shards.cached("csc", lambda: EdgeSum(
        pg.csc_srcs[s, :m], pg.csc_dsts_local[s, :m], pg.n_loc, pg.n_pad,
        shards.device), pg)


def dist_spmm(
    pg: PartitionedGraph,
    shards: DeviceShards,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's block
    mesh,
    axis: str = "graph",
    weights: torch.Tensor | None = None,  # [1, m_loc]: this rank's block
) -> torch.Tensor:
    """Distributed pull-SpMM: all-gather the feature slab, local gather +
    segment-sum into the owned dst rows.  Returns this rank's ``[1, n_loc,
    F]`` block."""
    return make_dist_spmm(pg, mesh, axis, weights is not None)(
        shards, x, weights
    )


def dist_pagerank(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh,
    axis: str = "graph",
    damping: float = 0.85,
    tol_rel: float = 0.001,
    max_iter: int = 100,
    plan=None,
):
    """Distributed standard PageRank: ranks sharded by dst range; per
    iteration each shard sums in-neighbor contributions locally after one
    exchange of the (rank/out_degree) contribution vector, with the
    single-device ``standard`` variant's update and freeze-on-convergence
    semantics.  Returns (this rank's ``[n_loc]`` ranks, rounds)."""
    n_loc, n = pg.n_loc, pg.n
    inv_n = 1.0 / n
    group = axis_group(mesh, axis)
    g = shards
    esrc, emask = g.csc_srcs[0], g.edge_mask[0]
    out_deg = g.out_degrees[0].to(torch.float32)
    real = (torch.arange(n_loc, device=g.device) + g.shard * n_loc) < n
    send_idx, src_slot = _plan_args(pg, plan, g)
    read = _make_edge_reader(plan is not None, axis, esrc, send_idx,
                             src_slot, mesh=mesh)
    ranks = torch.where(real, inv_n, 0.0).to(torch.float32)
    active = real
    it = 0
    while _count(active, group) > 0 and it < max_iter:
        contrib = torch.where(out_deg > 0, ranks / out_deg, 0.0)
        reduced = shard_reduce(g, torch.where(emask, read(contrib), 0.0),
                               "sum")
        dangling = all_reduce(
            torch.where(real & (out_deg == 0), ranks, 0.0).sum().reshape(1),
            group)
        new = (1.0 - damping) * inv_n + damping * (
            reduced + dangling * inv_n)
        new = torch.where(real, new, 0.0)
        new = torch.where(active, new, ranks)
        moved = torch.abs(new - ranks) > tol_rel * torch.abs(ranks)
        ranks, active = new, active & moved & real
        it += 1
    return ranks, it


def dist_cc(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed connected components (weakly connected for directed
    input): min-label propagation over in-edges with the label vector
    exchanged per round (boundary-only with ``plan``); the single-device
    fixpoint (min vertex id per component).  Returns (this rank's
    ``[n_loc]`` labels, rounds)."""
    n_pad, n_loc = pg.n_pad, pg.n_loc
    if max_iter is None:
        max_iter = n_pad
    group = axis_group(mesh, axis)
    g = shards
    esrc, emask = g.csc_srcs[0], g.edge_mask[0]
    send_idx, src_slot = _plan_args(pg, plan, g)
    read = _make_edge_reader(plan is not None, axis, esrc, send_idx,
                             src_slot, mesh=mesh)
    labels = (torch.arange(n_loc, dtype=torch.int32, device=g.device)
              + g.shard * n_loc)
    changed, it = 1, 0
    while changed > 0 and it < max_iter:
        nb_min = shard_reduce(g, torch.where(emask, read(labels), INT_MAX),
                              "min")
        new = torch.minimum(labels, nb_min)
        changed = _count(new != labels, group)
        labels = new
        it += 1
    return labels, it


def dist_coloring(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh,
    axis: str = "graph",
    seed: int = 0,
    hashes_per_round: int = 16,
    max_iter: int | None = None,
    plan=None,
):
    """Distributed Jones-Plassmann hash coloring (undirected graphs), the
    single-device fast path's colors for the same salts: priorities derive
    from static global vertex ids (``mix(id ^ salt_round, j)``), so the
    only exchanged state per round is the uncolored bit (boundary slabs
    with ``plan``).  The K hash orders' 2K min/max blocker bits pack into
    one int32 word per edge, reduced by one ``bor`` launch.  One salt a
    round from ``torch.Generator().manual_seed(seed)``, drawn as the
    single-device ``coloring`` draws them (JAX draws from
    ``jax.random``).  Returns (this rank's ``[n_loc]`` colors, rounds)."""
    gen = torch.Generator().manual_seed(seed)
    return _dist_coloring(
        pg, shards, mesh, axis,
        lambda it: int(torch.randint(2**32, (), generator=gen)),
        hashes_per_round, max_iter, plan)


def _dist_coloring(pg, shards, mesh, axis, salt, hashes_per_round,
                   max_iter, plan):
    """:func:`dist_coloring` with round ``it``'s uint32 salt ``salt(it)``
    (called once a round, in order, the same on every rank)."""
    from mini_tpu_torch.algorithms.coloring import _Slots

    n_pad, n_loc, n = pg.n_pad, pg.n_loc, pg.n
    K = int(hashes_per_round)
    if not 1 <= K <= 16:
        raise ValueError(f"hashes_per_round={K}: the 2K blocker bits must "
                         "fit one 32-bit word (1 <= K <= 16)")
    if max_iter is None:
        max_iter = max(2 * n, 64)
    group = axis_group(mesh, axis)
    g = shards
    esrc, edst, emask = g.csc_srcs[0], g.csc_dsts_local[0], g.edge_mask[0]
    send_idx, src_slot = _plan_args(pg, plan, g)
    read = _make_edge_reader(plan is not None, axis, esrc, send_idx,
                             src_slot, mesh=mesh)
    slots = _Slots(K, g.device)
    ids = torch.arange(n_pad, dtype=torch.int64, device=g.device)
    edst_global = edst + g.shard * n_loc
    real = (torch.arange(n_loc, device=g.device) + g.shard * n_loc) < n
    colors = torch.zeros(n_loc, dtype=torch.int32, device=g.device)
    it = 0
    while it < max_iter:
        uncolored = (colors == 0) & real
        if _count(uncolored, group) == 0:
            break
        unc_e = (read(uncolored.to(torch.int32)) > 0) & emask
        table = slots.mix(ids ^ salt(it))  # [n_pad, K] priorities
        pe = gather_rows(table, esrc)
        po = gather_rows(table, edst_global)
        claims = torch.stack([pe <= po, pe >= po], dim=2).view(-1, 2 * K)
        acc = torch.where(claims & unc_e[:, None], slots.bits, 0).sum(
            1, dtype=torch.int32)  # distinct bits: the sum is the or
        blocked = shard_reduce(g, acc, "bor")
        colors = slots.assign(colors, uncolored, blocked, it)
        it += 1
    return colors, it


def dist_kcore(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh,
    axis: str = "graph",
    max_iter: int | None = None,
    plan=None,
):
    """Distributed k-core via the h-index fixpoint (undirected graphs;
    bitwise the single-device ``hindex`` variant: the synchronous fixpoint
    iteration is partition-invariant).  Per round each shard exchanges
    its h vector (boundary slabs with ``plan``), sorts its local in-edges
    by (dst, h desc) as one int64 key, and counts positions whose value
    >= within-segment rank.  Returns (this rank's ``[n_loc]`` cores,
    rounds)."""
    n_pad = pg.n_pad
    if max_iter is None:
        max_iter = n_pad
    maxd = int(pg.out_degrees.max(initial=0))
    bits_v = max(1, (maxd + 1).bit_length())
    group = axis_group(mesh, axis)
    g = shards
    esrc, edst, emask = g.csc_srcs[0], g.csc_dsts_local[0], g.edge_mask[0]
    off = g.col_offsets[0].long()
    send_idx, src_slot = _plan_args(pg, plan, g)
    read = _make_edge_reader(plan is not None, axis, esrc, send_idx,
                             src_slot, mesh=mesh)
    idx = torch.arange(esrc.shape[0], device=g.device)
    key_dst = edst.long() << bits_v

    def h_step(h):
        val = torch.where(emask, read(h), -1)  # pads sort last, never count
        skey = torch.sort(key_dst + (maxd - val).long()).values
        s_dst = skey >> bits_v
        sval = maxd - (skey & ((1 << bits_v) - 1))
        rank1 = idx - off[s_dst] + 1
        ok = ((sval >= rank1) & (sval >= 0)).to(torch.int32)
        return segment_reduce(g.col_offsets[0], s_dst.to(torch.int32), ok,
                              "sum")

    h = g.out_degrees[0].to(torch.int32)
    changed, it = 1, 0
    while changed > 0 and it < max_iter:
        newh = h_step(h)
        changed = _count(newh != h, group)
        h = newh
        it += 1
    return h, it


def dist_lspar(
    pg: PartitionedGraph,
    shards: DeviceShards,
    mesh,
    axis: str = "graph",
    prime: int = 999983,
    e: float = 0.5,
    seed: int = 0,
    plan=None,
):
    """Distributed L-Spar sparsification (undirected graphs).

    On an undirected (doubled) graph the dst-partitioned CSC segment of a
    vertex is its adjacency list in the single-device CSR order, so every
    stage is shard-local except one exchange, of the minwise-hash vector
    (boundary slabs with ``plan``).  Per shard: (1) minwise[v] = min over
    the segment of hash(src), the universal hashes from static global ids
    (gunrock's ``lspar/lspar_problem.hxx:95-99``); (2) exchange minwise;
    (3) binary sims and their stable (sim desc) rank by prefix counts
    within the local segments.  Returns (this rank's ``[1, m_loc]``
    selected mask over the partitioned CSC edges, its ``[1, m_loc]`` sims,
    the total count): edge (u -> v) is selected here iff the
    single-device run selects CSR edge (v -> u)."""
    from mini_tpu_torch.algorithms.lspar import is_prime

    if not is_prime(prime):
        raise ValueError(f"{prime} is not prime")
    m_loc = pg.m_loc
    group = axis_group(mesh, axis)
    g = shards
    dev = g.device

    rng = np.random.RandomState(seed)
    a = rng.randint(1, prime)
    b = rng.randint(0, prime)
    idx = np.arange(pg.n_pad, dtype=np.int64)
    hashs = torch.from_numpy(((b + a * idx) % prime).astype(np.int32)).to(dev)
    # thresholds in float64 on the host, as the single-device entry computes
    thr = torch.from_numpy(np.floor(np.power(
        pg.out_degrees[g.shard].astype(np.float64), e)).astype(np.int32)).to(
        dev)

    esrc, edst, emask = g.csc_srcs[0], g.csc_dsts_local[0], g.edge_mask[0]
    edst_l = edst.long()
    off = g.col_offsets[0].long()
    send_idx, src_slot = _plan_args(pg, plan, g)
    read = _make_edge_reader(plan is not None, axis, esrc, send_idx,
                             src_slot, mesh=mesh)

    h_e = torch.where(emask, gather_vec(hashs, esrc), INT_MAX)
    minwise = shard_reduce(g, h_e, "min")
    mw_src_e = read(minwise)
    sims = (emask & (mw_src_e == minwise[edst_l])).to(torch.int32)

    # stable (sim desc) rank via prefix counts within local segments
    c1 = torch.cumsum(sims, 0, dtype=torch.int32)
    c1_ext = torch.cat([c1.new_zeros(1), c1])
    start_c1 = c1_ext[off[:-1]]
    n1 = c1_ext[off[1:]] - start_c1
    p1 = (c1 - sims) - start_c1[edst_l]
    local = torch.arange(m_loc, dtype=torch.int32, device=dev) \
        - off[:-1][edst_l].to(torch.int32)
    rank = torch.where(sims == 1, p1, n1[edst_l] + (local - p1))
    sel = (rank < thr[edst_l]) & emask
    cnt = _count(sel, group)
    return sel[None], sims[None], cnt
