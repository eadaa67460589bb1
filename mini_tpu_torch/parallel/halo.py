"""Boundary (halo) feature exchange: the all-to-all refinement of the
all-gather slab exchange (exchanging boundary frontier/feature slabs
all-to-all, overlapped with the local segmented aggregation).

Host side (once per graph, NumPy, the same arrays as ``mini_tpu``'s
``parallel/halo.py``): for every shard pair (owner t -> consumer s), the
set of t's rows that s's in-edges read is static.  We precompute

* ``send_idx[t, s, H]``: local row ids shard t sends to shard s (padded),
* ``src_slot[s, m_loc]``: for each of s's edges, the position of its source
  row in s's receive buffer (halo slabs, t-major) or in s's own rows.

Device side per SpMM, on each rank: gather its send rows (the row
gather), one ``all_to_all_single`` moves the halo slabs, and the local
segmented aggregation (the one-band segment sum, ``distributed.EdgeSum``)
reads from [halo | own]; total wire traffic is the boundary set, not the
full feature matrix.

Two refinements on top of the basic exchange:

* **Collective/compute overlap** (``overlap=True``): edges are split
  host-side into *own* (source row lives on this shard) and *halo*
  (source row arrives in the exchange).  The own-edge aggregation reads
  only local rows, so it has no data dependency on the ``all_to_all``:
  the exchange is started with ``async_op=True``, the own-edge sum runs
  while it is in flight (on NCCL the collective runs on its own stream),
  and only the halo-edge sum waits.  The backward does the mirror image.
* **Hierarchical 2-level exchange** (``axes=("dcn", "ici")``): the flat
  D-way all-to-all is replaced by one over the slice axis (messages
  bundled per slice) then one over the intra-slice axis.
  ``all_to_all_single`` splits dim 0 only, so the second phase moves
  through a transposed contiguous copy.  Same rows moved; the ``[s, s]``
  self-slab stays in the buffer, so ``slot = t*H + rank`` stays uniform.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from mini_tpu_torch.graph.csr import _round_up
from mini_tpu_torch.ops.kernels.gather_rows import gather_rows
from mini_tpu_torch.parallel.distributed import (
    DeviceShards,
    EdgeSum,
    mesh_device,
)
from mini_tpu_torch.parallel.partition import PartitionedGraph


@dataclasses.dataclass
class HaloPlan:
    """Host-side exchange plan; arrays stack on the shard axis."""

    halo_width: int  # H: max rows any shard sends to any other
    send_idx: np.ndarray  # int32[D, D, H]: [sender t, receiver s, slot]
    send_mask: np.ndarray  # bool[D, D, H]
    src_slot: np.ndarray  # int32[D, m_loc]: buffer position per edge
    boundary_rows: int  # total real (unpadded) halo rows
    # split-edge layout for collective/compute overlap (own = source row
    # on this shard; halo = source row arrives in the exchange).  Pad
    # entries carry weight 0 and slot/dst 0.
    m_own: int = 0
    m_halo: int = 0
    own_slot: np.ndarray | None = None  # int32[D, m_own] local row id
    own_dst: np.ndarray | None = None  # int32[D, m_own] local dst
    own_w: np.ndarray | None = None  # float32[D, m_own]
    own_src_global: np.ndarray | None = None  # int32[D, m_own]
    own_mask: np.ndarray | None = None  # bool[D, m_own]
    halo_slot: np.ndarray | None = None  # int32[D, m_halo] pos in halo buf
    halo_dst: np.ndarray | None = None  # int32[D, m_halo]
    halo_w: np.ndarray | None = None  # float32[D, m_halo]
    halo_src_global: np.ndarray | None = None  # int32[D, m_halo]
    halo_mask: np.ndarray | None = None  # bool[D, m_halo]


def build_halo_plan(pg: PartitionedGraph, h_multiple: int = 8) -> HaloPlan:
    D, n_loc, m_loc = pg.num_shards, pg.n_loc, pg.m_loc
    needed: list[list[np.ndarray]] = []  # needed[s][t] = t's local rows
    total_boundary = 0
    for s in range(D):
        em = pg.edge_mask[s]
        srcs = np.unique(pg.csc_srcs[s][em])
        per_owner = []
        for t in range(D):
            if t == s:
                per_owner.append(np.zeros(0, np.int32))
                continue
            rows = srcs[(srcs >= t * n_loc) & (srcs < (t + 1) * n_loc)]
            per_owner.append((rows - t * n_loc).astype(np.int32))
            total_boundary += len(rows)
        needed.append(per_owner)

    H = max(
        (len(needed[s][t]) for s in range(D) for t in range(D)), default=0
    )
    H = _round_up(max(H, 1), h_multiple)

    send_idx = np.zeros((D, D, H), np.int32)
    send_mask = np.zeros((D, D, H), bool)
    # position lookup: for consumer s, owner t, global src -> halo slot
    src_slot = np.zeros((D, m_loc), np.int32)
    for s in range(D):
        for t in range(D):
            rows = needed[s][t]
            send_idx[t, s, : len(rows)] = rows
            send_mask[t, s, : len(rows)] = True
        # map each edge's source to its buffer position:
        # halo slabs are t-major: slot = t * H + rank(row in needed[s][t]);
        # own rows sit after the halo: D * H + local_row
        em = pg.edge_mask[s]
        gsrc = pg.csc_srcs[s]
        owner = np.clip(gsrc // n_loc, 0, D - 1)
        slot = np.zeros(m_loc, np.int64)
        own = owner == s
        slot[own] = D * H + (gsrc[own] - s * n_loc)
        for t in range(D):
            if t == s:
                continue
            sel = (owner == t) & em
            if not sel.any():
                continue
            ranks = np.searchsorted(needed[s][t], gsrc[sel] - t * n_loc)
            slot[sel] = t * H + ranks
        slot[~em] = D * H  # ghost edges read own row 0 (weight 0 anyway)
        src_slot[s] = slot.astype(np.int32)

    # split-edge layout (own vs halo) for collective/compute overlap
    own_sel = [
        pg.edge_mask[s]
        & (pg.csc_srcs[s] >= s * n_loc)
        & (pg.csc_srcs[s] < (s + 1) * n_loc)
        for s in range(D)
    ]
    halo_sel = [pg.edge_mask[s] & ~own_sel[s] for s in range(D)]
    m_own = _round_up(max(int(o.sum()) for o in own_sel) or 1, 8)
    m_halo = _round_up(max(int(h.sum()) for h in halo_sel) or 1, 8)
    own_slot = np.zeros((D, m_own), np.int32)
    own_dst = np.zeros((D, m_own), np.int32)
    own_w = np.zeros((D, m_own), np.float32)
    own_srcg = np.zeros((D, m_own), np.int32)
    own_mask = np.zeros((D, m_own), bool)
    halo_slot = np.zeros((D, m_halo), np.int32)
    halo_dst = np.zeros((D, m_halo), np.int32)
    halo_w = np.zeros((D, m_halo), np.float32)
    halo_srcg = np.zeros((D, m_halo), np.int32)
    halo_mask = np.zeros((D, m_halo), bool)
    for s in range(D):
        o, hsel = own_sel[s], halo_sel[s]
        no, nh = int(o.sum()), int(hsel.sum())
        own_slot[s, :no] = pg.csc_srcs[s][o] - s * n_loc
        own_dst[s, :no] = pg.csc_dsts_local[s][o]
        own_w[s, :no] = pg.csc_weights[s][o]
        own_srcg[s, :no] = pg.csc_srcs[s][o]
        own_mask[s, :no] = True
        halo_slot[s, :nh] = src_slot[s][hsel]  # positions in the halo buf
        halo_dst[s, :nh] = pg.csc_dsts_local[s][hsel]
        halo_w[s, :nh] = pg.csc_weights[s][hsel]
        halo_srcg[s, :nh] = pg.csc_srcs[s][hsel]
        halo_mask[s, :nh] = True

    return HaloPlan(
        halo_width=H,
        send_idx=send_idx,
        send_mask=send_mask,
        src_slot=src_slot,
        boundary_rows=total_boundary,
        m_own=m_own,
        m_halo=m_halo,
        own_slot=own_slot,
        own_dst=own_dst,
        own_w=own_w,
        own_src_global=own_srcg,
        own_mask=own_mask,
        halo_slot=halo_slot,
        halo_dst=halo_dst,
        halo_w=halo_w,
        halo_src_global=halo_srcg,
        halo_mask=halo_mask,
    )


# ------------------------------------------------------------ device half
class Exchanger:
    """This rank's slab exchange over ``axis``: one mesh axis name (flat
    D-way ``all_to_all_single``) or a ("dcn", "ici") pair (one all-to-all
    over the slice axis moving per-slice super-slabs, one over the
    intra-slice axis).  Flat target/sender ids are ``dcn_idx * D_ici +
    ici_idx``, the mesh's rank order.

    The exchange maps every rank's ``[D, H, F]`` target-major slabs to
    ``[D, H, F]`` sender-major ones: ``out_t[s] = in_s[t]``, a permutation
    that is its own inverse, so it is also its own transpose."""

    def __init__(self, mesh, axis):
        if isinstance(axis, str):
            self.groups = (mesh.get_group(axis),)
        else:
            a_dcn, a_ici = axis
            self.groups = (mesh.get_group(a_dcn), mesh.get_group(a_ici))
            self.dims = (mesh.size(mesh.mesh_dim_names.index(a_dcn)),
                         mesh.size(mesh.mesh_dim_names.index(a_ici)))

    def start(self, out_rows: torch.Tensor):
        """Start the exchange of ``out_rows`` (``[D, H, F]``); returns a
        function that waits for it and returns the received slabs.  The
        last (or only) all-to-all is in flight until then."""
        D, H, F = out_rows.shape
        x = out_rows.contiguous()
        if len(self.groups) == 2:
            Dd, Di = self.dims
            x = x.reshape(Dd, Di, H, F)
            y = torch.empty_like(x)
            # phase 1 (slices): axis 0 becomes the SENDER dcn index
            dist.all_to_all_single(y, x, group=self.groups[0])
            # phase 2 (within a slice) splits axis 1: move it to axis 0
            x = y.transpose(0, 1).contiguous()  # [target ici, sender dcn]
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.groups[-1],
                                      async_op=True)

        def wait(sent=x):  # holds the input until the exchange is done
            work.wait()
            if len(self.groups) == 2:  # [sender ici, sender dcn] back
                return out.transpose(0, 1).reshape(D, H, F)
            return out
        return wait

    def __call__(self, out_rows: torch.Tensor) -> torch.Tensor:
        return self.start(out_rows)()


def exchange_slabs(out_rows: torch.Tensor, axis, *, mesh) -> torch.Tensor:
    """Move per-target slabs to their owners: ``out_rows`` is ``[D, H, F]``
    target-major on every rank; the result is ``[D, H, F]`` sender-major.
    ``axis`` is one mesh axis name or a ("dcn", "ici") pair (see
    :class:`Exchanger`)."""
    return Exchanger(mesh, axis)(out_rows)


class _Exchange(torch.autograd.Function):
    """The exchange with its transpose, the exchange itself, as backward."""

    @staticmethod
    def forward(ctx, out_rows, ex):
        ctx.ex = ex
        return ex(out_rows)

    @staticmethod
    def backward(ctx, ct):
        return ctx.ex(ct), None


class _Gather(torch.autograd.Function):
    """The row gather ``table[idx]`` with its transpose, the scatter-add
    by ``t`` (``EdgeSum.of_gather``), as backward."""

    @staticmethod
    def forward(ctx, table, idx, t):
        ctx.t = t
        return gather_rows(table.contiguous(), idx)

    @staticmethod
    def backward(ctx, ct):
        return ctx.t(ct.contiguous()), None, None


def rank_halo(pg: PartitionedGraph, plan: HaloPlan, shards: DeviceShards,
              mesh, axis) -> "RankHalo":
    """This rank's :class:`RankHalo` of ``plan``, made once per shards."""
    return shards.cached(f"halo {axis}", lambda: RankHalo(
        pg, plan, shards.shard, mesh, axis), pg, plan, mesh)


class RankHalo:
    """This rank's part of a :class:`HaloPlan` on its device: the send
    rows, the exchange, and the edge sums over the [halo | own] buffer
    (``buf``), and for the overlap over own rows (``own``) and over the
    received slabs (``halo``), each from its real edges, with their
    weights (``own_w``, ``halo_w``)."""

    def __init__(self, pg: PartitionedGraph, plan: HaloPlan, shard: int,
                 mesh, axis):
        self.pg, self.plan, self.s = pg, plan, shard
        self.D, self.H = pg.num_shards, plan.halo_width
        self.device = mesh_device(mesh)
        self.exchange = Exchanger(mesh, axis)
        self._send = plan.send_idx[shard].reshape(-1)
        self.send = torch.from_numpy(self._send.astype(np.int32)).to(
            self.device)

    @functools.cached_property
    def send_t(self) -> EdgeSum:
        return EdgeSum.of_gather(self._send, self.pg.n_loc, self.device)

    @functools.cached_property
    def buf(self) -> EdgeSum:
        pg, s = self.pg, self.s
        m = int(pg.col_offsets[s, -1])
        return EdgeSum(self.plan.src_slot[s, :m], pg.csc_dsts_local[s, :m],
                       pg.n_loc, self.D * self.H + pg.n_loc, self.device)

    def _split(self, part: str, n_table: int) -> EdgeSum:
        p, s = self.plan, self.s
        k = int(getattr(p, f"{part}_mask")[s].sum())
        return EdgeSum(getattr(p, f"{part}_slot")[s, :k],
                       getattr(p, f"{part}_dst")[s, :k], self.pg.n_loc,
                       n_table, self.device)

    @functools.cached_property
    def own(self) -> EdgeSum:
        return self._split("own", self.pg.n_loc)

    @functools.cached_property
    def halo(self) -> EdgeSum:
        return self._split("halo", self.D * self.H)

    def plan_row(self, name: str, es: EdgeSum) -> torch.Tensor:
        """The plan's ``{name}`` row of this shard's real own or halo
        edges, on the device."""
        a = getattr(self.plan, name)[self.s, : es.m]
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @functools.cached_property
    def own_w(self) -> torch.Tensor:
        return self.plan_row("own_w", self.own)

    @functools.cached_property
    def halo_w(self) -> torch.Tensor:
        return self.plan_row("halo_w", self.halo)

    def table(self, x: torch.Tensor) -> torch.Tensor:
        """The [halo | own] buffer ``[D*H + n_loc, F]`` of ``x``
        (``[n_loc, F]``), differentiable."""
        rows = _Gather.apply(x, self.send, self.send_t)
        halo = _Exchange.apply(rows.view(self.D, self.H, -1), self.exchange)
        return torch.cat([halo.reshape(self.D * self.H, -1), x], dim=0)

    def overlap_sum(self, x, w_own, w_halo) -> torch.Tensor:
        """``own(x, w_own) + halo(exchange(x[send]), w_halo)``, the own-edge
        sum run while the exchange is in flight; differentiable in ``x``
        (the weights are constants)."""
        return _OverlapSum.apply(x, w_own, w_halo, self)


class _OverlapSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_own, w_halo, rh):
        ctx.rh = rh
        ctx.save_for_backward(w_own, w_halo)
        rows = gather_rows(x.contiguous(), rh.send)
        wait = rh.exchange.start(rows.view(rh.D, rh.H, -1))
        # local aggregation first: reads only x, overlaps with the
        # in-flight collective
        out = rh.own(x, w_own)
        halo = wait().reshape(rh.D * rh.H, -1)
        return out + rh.halo(halo, w_halo)

    @staticmethod
    def backward(ctx, ct):
        rh = ctx.rh
        w_own, w_halo = ctx.saved_tensors
        ct = ct.contiguous()
        th, to = rh.halo.transpose(), rh.own.transpose()
        d_halo = th(ct, w_halo[th.perm])  # [D*H, F]
        wait = rh.exchange.start(d_halo.view(rh.D, rh.H, -1))
        d_x = to(ct, w_own[to.perm])  # while the slabs travel back
        back = wait().reshape(rh.D * rh.H, -1)
        return d_x + rh.send_t(back), None, None, None


def make_halo_spmm(
    pg: PartitionedGraph,
    plan: HaloPlan,
    mesh,
    axis="graph",
    overlap: bool = False,
):
    """Build-once factory for the boundary-exchange pull-SpMM: returns
    ``call(shards, x) -> [1, n_loc, F]`` (``x`` this rank's ``[1, n_loc,
    F]`` block) with the plan's index maps and edge sums on the device."""
    def call(shards: DeviceShards, x):
        rh = rank_halo(pg, plan, shards, mesh, axis)
        xs = x[0]  # [n_loc, F]
        if overlap:
            out = rh.overlap_sum(xs, rh.own_w, rh.halo_w)
        else:
            # rows this rank sends to every other: [D, H, F]; the [s, s]
            # diagonal slab (zero rows, send_mask False) stays in the buffer
            # to keep the t-major slot arithmetic (slot = t*H + rank) uniform
            rows = gather_rows(xs.contiguous(), rh.send)
            halo = rh.exchange(rows.view(rh.D, rh.H, -1))
            buf = torch.cat([halo.reshape(rh.D * rh.H, -1), xs], dim=0)
            out = rh.buf(buf, shards.csc_weights[0, : rh.buf.m])
        return out[None]

    return call


def halo_spmm(
    pg: PartitionedGraph,
    shards: DeviceShards,
    plan: HaloPlan,
    x: torch.Tensor,  # [1, n_loc, F]: this rank's block
    mesh,
    axis="graph",
    overlap: bool = False,
) -> torch.Tensor:
    """Pull-SpMM with boundary-only all-to-all exchange; returns this
    rank's ``[1, n_loc, F]`` block.

    ``axis`` may be one mesh axis name or a ("dcn", "ici") pair for the
    hierarchical 2-level exchange.  ``overlap=True`` uses the split-edge
    layout: the own-edge sum runs while the exchange is in flight."""
    return make_halo_spmm(pg, plan, mesh, axis, overlap)(shards, x)
