"""Static banded edge layout for the SpMM aggregation.

Vertices are cut into K bands of ``band_rows`` rows.  Edges, in the
direction's segment order (CSC for pull: sorted by dst; CSR for push:
sorted by src), are regrouped by the band of the vertex whose features
they gather, keeping the segment order inside each band.  On a relation
graph (``graph/csr.py``) the gathered side is another vertex set than
the rows': a pull layout has the destinations' rows and the sources'
bands, a push layout the other way round.  The
``banded_segment_sum`` kernel (ops/kernels/spmm_banded.py) then reads each
band's messages from one slice of ``x`` by the band's ids and folds the K
segment-sorted message streams into one output through per-band offset
staircases, with no per-edge destination array.

The builder gives ``mini_tpu.graph.banded``'s layouts bitwise, with the
same ``FAST_TABLE_BYTES`` band-height rule (one sort by band where that
builder loops over the bands).  Everything here is host-side and cached by the
GraphSlice fingerprint; :meth:`BandedLayout.dev` moves the arrays to a
device once.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from mini_tpu_torch.utils.device import resolve_device

ROW_TILE = 128  # output rows per kernel tile
EDGE_CHUNK = 512  # per-band stream padding multiple
FAST_TABLE_BYTES = 16 * 1024 * 1024  # band height: one band's feature table


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class BandedLayout:
    """One direction's banded edge layout (host arrays; see module doc).

    ``pull`` layouts band by source vertex over CSC order (segments = dst);
    ``push`` layouts band by destination over CSR order (segments = src).
    """

    direction: str  # "pull" | "push"
    band_rows: int
    n_pad: int  # rows (segments) of the output
    m_pad: int  # original (unbanded) padded edge count
    # per band (lists of length K):
    ids: list  # np.int32[mk_pad] — band-local gather indices
    weights: list  # np.float32[mk_pad] — graph edge weights, banded order
    lens: list  # int: un-padded edge count per band
    # kernel metadata:
    bounds: np.ndarray  # int32[K, n_tiles+1] — per-band tile edge bounds
    offs2d: np.ndarray  # int32[K, n_tiles, ROW_TILE] — per-dst offsets
    # CSC/CSR position -> flat banded position, padded with the free slots
    # of the flat stream so it is a permutation of [0, total_padded):
    banded_rank: np.ndarray  # int32[total_padded]
    eids: list  # np.int32[mk_pad] — original edge id per banded slot
    # per-band segment offsets over all n_pad segments
    offsets: Optional[list] = None  # np.int32[n_pad+1] per band
    valid: Optional[list] = None  # np.bool_[mk_pad] — real (non-ghost) edges
    edge_chunk: int = EDGE_CHUNK  # per-band stream padding multiple
    # rows of the table the ids index, the gathered side: K bands of
    # band_rows cover them (n_pad on a square graph)
    table_rows: int = 0

    # device-array cache, keyed by device
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def K(self) -> int:
        return len(self.ids)

    @property
    def n_tiles(self) -> int:
        return self.n_pad // ROW_TILE

    @property
    def total_padded(self) -> int:
        return int(sum(len(i) for i in self.ids))

    def dev(self, device=None) -> dict:
        """The layout's arrays as tensors on ``device`` (``None``: the
        card), cached with the layout, so they are dropped with its graph.

        ``offs2d`` is transposed to the kernel-facing ``[n_tiles, K,
        ROW_TILE]``: one tile's offsets for every band are contiguous.
        ``seg[k]`` is the segment (row) of every slot of band ``k``, pad
        slots included (they take the last row): the result of JAX's
        ``expand_to_edges`` over ``offsets[k]``, as gather indices.
        ``row_prefix`` is the segment sum's schedule (:func:`row_prefix`),
        built on the device once."""
        device = resolve_device(device)
        key = str(device)
        if key not in self._dev:
            inv = np.empty_like(self.banded_rank)
            inv[self.banded_rank] = np.arange(
                self.banded_rank.shape[0], dtype=self.banded_rank.dtype
            )
            seg = [
                (np.searchsorted(o[:-1], np.arange(len(i)), side="right")
                 - 1).astype(np.int32)
                for o, i in zip(self.offsets, self.ids)
            ]

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            bounds, offs2d = t(self.bounds), t(self.offs2d.transpose(1, 0, 2))
            self._dev[key] = dict(
                ids=[t(i) for i in self.ids],
                weights=[t(w) for w in self.weights],
                bounds=bounds,
                offs2d=offs2d,
                row_prefix=row_prefix(bounds, offs2d),
                banded_rank=t(self.banded_rank),
                inv_rank=t(inv),
                offsets=[t(o) for o in self.offsets],
                valid=[t(v) for v in self.valid],
                seg=[t(s) for s in seg],
            )
        return self._dev[key]

    def _split_bands(self, flat: torch.Tensor) -> list:
        """The flat banded stream (or its leading ``total_padded`` rows) as
        the K per-band tensors."""
        return list(torch.split(flat[: self.total_padded],
                                [len(i) for i in self.ids]))

    def _to_flat(self, table: torch.Tensor) -> torch.Tensor:
        """Per-edge ``[m, H]`` rows in the base order -> the flat banded
        ``[total_padded, H]`` stream (pad slots 0): padded once, permuted
        in one launch, each row moved whole."""
        from mini_tpu_torch.ops.permute import permute_rows

        d = self.dev(table.device)
        pad = table.new_zeros(self.total_padded - table.shape[0],
                              table.shape[1])
        return permute_rows(d["banded_rank"], torch.cat([table, pad]),
                            rank_inv=d["inv_rank"])

    def permute_to_bands(self, edge_vals: torch.Tensor) -> list:
        """Reorder per-edge values (in this layout's base order: CSC for
        pull, CSR for push) into the banded order: one fixed-permutation
        apply by the banded rank (differentiable for float values).
        Returns the K per-band tensors (pad slots 0); ``[m, H]`` values
        give ``[mk, H]`` bands."""
        if edge_vals.ndim == 2:
            return self._split_bands(self._to_flat(edge_vals))
        return self._split_bands(self._to_flat(edge_vals[:, None])[:, 0])

    def permute_to_bands_multi(self, *cols: torch.Tensor) -> list:
        """H per-edge columns through ONE permutation launch; returns the K
        per-band ``[mk, H]`` stacks (JAX ``permute_to_bands_multi``)."""
        return self.permute_to_bands(torch.stack(cols, dim=1))

    def permute_from_bands(self, band_vals) -> torch.Tensor:
        """Inverse of :meth:`permute_to_bands`: per-band tensors (or the
        flat banded stream) back to the base edge order, length m_pad: a
        gather by the banded rank."""
        from mini_tpu_torch.ops.permute import permute_rows

        if not isinstance(band_vals, torch.Tensor):
            band_vals = torch.cat(list(band_vals))
        d = self.dev(band_vals.device)
        return permute_rows(d["banded_rank"], band_vals[:, None], inverse=True,
                            rank_inv=d["inv_rank"])[: self.m_pad, 0]


def row_prefix(bounds: torch.Tensor, offs2d: torch.Tensor) -> torch.Tensor:
    """The banded segment sum's schedule: int32 ``[n_pad + 1]``, entry
    ``v`` the number of real slots of rows ``< v`` over all K bands.

    The kernel (``csrc/spmm_banded.cu``) walks the slots in this row-major
    virtual order (row v's segment in band 0, then band 1, ...) cut into
    equal chunks, so a hub row spans many chunks.  Built from the layout's
    kernel arrays (``bounds [K, n_tiles+1]``, ``offs2d [n_tiles, K, 128]``)
    on their device, with no host sync."""
    starts = offs2d.long()
    ends = torch.cat([starts[:, :, 1:], bounds.t()[1:, :, None].long()],
                     dim=2)
    lens = (ends - starts).sum(1).reshape(-1)  # [n_pad], all bands
    out = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                      device=lens.device)
    torch.cumsum(lens, 0, out=out[1:])
    return out.to(torch.int32)


def build_banded_layout(
    offsets: np.ndarray,  # int[n_pad+1] segment offsets (CSC for pull)
    gather_ids: np.ndarray,  # int32[m_pad] source-of-message per edge
    weights: np.ndarray,  # float32[m_pad]
    edge_valid: np.ndarray,  # bool[m_pad] — False for ghost/pad edges
    band_rows: int,
    direction: str,
    edge_chunk: int = EDGE_CHUNK,
    table_rows: Optional[int] = None,
) -> BandedLayout:
    """Group edges by gather-id band, preserving segment order within each
    band.  Pad/ghost edges keep weight 0 and id 0 so they are no-ops.
    ``table_rows`` counts the gathered side's padded rows, which the
    bands cut, where they are another vertex set than the ``n_pad``
    segments (a relation graph); None: ``n_pad``, a square graph's.

    One stable sort by band (a radix sort of 16-bit keys) groups every
    band at once, and a count of each band's run of the sorted segments
    gives its offsets: the layout of the JAX package's band-by-band loop,
    array for array, in passes over the edges that do not grow with K
    (ogbn-products' graph has 150 bands at 256 float32 columns), and in
    no host array of K x n_pad but the int32 offsets the layout keeps."""
    n_pad = offsets.shape[0] - 1
    m_pad = gather_ids.shape[0]
    table_rows = n_pad if table_rows is None else int(table_rows)
    assert n_pad % ROW_TILE == 0 and table_rows % ROW_TILE == 0
    band_rows = min(_round_up(band_rows, ROW_TILE), table_rows)
    K = (table_rows + band_rows - 1) // band_rows

    offsets = offsets.astype(np.int64)
    gid = gather_ids.astype(np.int64)
    # segment id of every edge (offsets are for contiguous sorted segments)
    seg = np.repeat(np.arange(n_pad, dtype=np.int32), np.diff(offsets))
    band = gid // band_rows
    band = np.where(edge_valid, band, K - 1)  # pad edges -> last band

    # the edges band by band, each band in segment order
    key = band.astype(np.uint16) if K <= 1 << 16 else band
    order = np.argsort(key, kind="stable")
    del key
    band_o = band[order]
    valid_o = edge_valid[order]
    lens = np.bincount(band, minlength=K)
    mk_pad = np.maximum(-(-lens // edge_chunk) * edge_chunk, edge_chunk)
    flat_base = np.zeros(K + 1, np.int64)
    np.cumsum(mk_pad, out=flat_base[1:])
    first = np.zeros(K + 1, np.int64)
    np.cumsum(lens, out=first[1:])
    # each edge's slot in the flat banded stream
    slot = flat_base[band_o] + np.arange(m_pad) - first[band_o]
    total = int(flat_base[-1])

    def flat(values, dtype):
        out = np.zeros(total, dtype)
        out[slot] = values
        return np.split(out, flat_base[1:-1])

    ids = flat(np.where(valid_o, gid[order] - band_o * band_rows, 0), np.int32)
    w_b = flat(np.where(valid_o, weights[order], 0.0), np.float32)
    eids = flat(order, np.int32)
    band_valid = flat(valid_o, bool)
    banded_rank = np.empty(m_pad, np.int64)
    banded_rank[order] = slot
    del slot, valid_o

    # per-dst offsets within each band's stream, band by band: band k's
    # edges are the sorted run first[k]:first[k + 1], in segment order
    seg_o = seg[order]
    del seg, band_o, order
    offk = np.zeros((K, n_pad + 1), np.int32)
    for k in range(K):
        cnt = np.bincount(seg_o[first[k]:first[k + 1]], minlength=n_pad)
        np.cumsum(cnt, out=offk[k, 1:], dtype=np.int32)
    del seg_o
    bounds = offk[:, ::ROW_TILE].copy()
    offs2d = offk[:, :n_pad].reshape(K, -1, ROW_TILE)  # a view of offk
    band_offsets = list(offk)

    # the flat stream's pad slots are the ranks no edge took; appending
    # them makes the rank a permutation of the whole padded stream
    used = np.zeros(total, bool)
    used[banded_rank] = True
    free = np.nonzero(~used)[0]
    banded_rank_full = np.concatenate([banded_rank, free]).astype(np.int32)

    return BandedLayout(
        direction=direction,
        band_rows=band_rows,
        n_pad=n_pad,
        m_pad=m_pad,
        ids=ids,
        weights=w_b,
        lens=[int(x) for x in lens],
        bounds=bounds,
        offs2d=offs2d,
        banded_rank=banded_rank_full,
        eids=eids,
        offsets=band_offsets,
        valid=band_valid,
        edge_chunk=edge_chunk,
        table_rows=table_rows,
    )


# ---------------------------------------------------------------------------
# Per-graph caches, keyed by the GraphSlice fingerprint.  Both are LRU-bounded
# so long-lived processes loading many graphs don't grow host memory without
# bound (each layout holds ~3x the graph's edge bytes).  The bounds hold one
# typed model's relations with room to spare: ogbn-mag's R-GCN has 7
# relation graphs and 14 layouts (pull and push at one band height), and an
# eviction would rebuild a layout inside a training step.

MAX_HOST_GRAPHS = 16
MAX_LAYOUTS = 32

_HOST_CACHE: OrderedDict = OrderedDict()  # fingerprint -> host arrays
_LAYOUT_CACHE: OrderedDict = OrderedDict()  # (fp, dir, rows, chunk) -> layout
# (fp, pull rows, pull chunk, push rows, push chunk, device) -> int32 rank
# and its inverse
_COMPOSITE_CACHE: OrderedDict = OrderedDict()


def _lru_touch(cache: OrderedDict, key, limit: int):
    cache.move_to_end(key)
    while len(cache) > limit:
        cache.popitem(last=False)


def register_host_graph(fingerprint: str, host_arrays: dict) -> None:
    """Called by GraphSlice.from_host with the padded host-side arrays
    needed to build layouts later (col/row offsets, srcs/dsts, weights,
    edge masks)."""
    _HOST_CACHE[fingerprint] = host_arrays
    _lru_touch(_HOST_CACHE, fingerprint, MAX_HOST_GRAPHS)
    # layouts and composite ranks of evicted graphs are keyed by
    # fingerprint prefix: drop them (JAX keeps its composite ranks)
    live = set(_HOST_CACHE)
    for cache in (_LAYOUT_CACHE, _COMPOSITE_CACHE):
        for k in [k for k in cache if k[0] not in live]:
            del cache[k]


def forget_host_graph(fingerprint: str) -> None:
    """Drop what is cached for the graph ``fingerprint``: its host arrays,
    its layouts with their device arrays, and its composite ranks, as an
    eviction drops them; a later layout of it raises nothing and is None,
    as for a graph never registered."""
    _HOST_CACHE.pop(fingerprint, None)
    for cache in (_LAYOUT_CACHE, _COMPOSITE_CACHE):
        for k in [k for k in cache if k[0] == fingerprint]:
            del cache[k]


def get_pull_to_push_rank(g, pull: BandedLayout, push: BandedLayout,
                          inverse: bool = False):
    """Composite static rank: flat pull-band slot -> flat push-band slot of
    the same edge, composed on the host once per layout pair (JAX
    ``get_pull_to_push_rank``): pull slot -> CSC position -> CSR position
    (the host ``csr_to_csc_rank``) -> push slot.  Pad slots map one to one
    onto push pad slots, so zero-padded pull streams come out as
    zero-padded push streams.

    Returns an int32 tensor on ``g``'s device of length ``max(total_pull,
    total_push)``: apply it to inputs padded to that length and cut the
    result to ``push.total_padded``.  ``inverse=True`` returns its inverse
    permutation (push slot -> pull slot), built beside it on the host and
    cached with it, so the permutation can run as a gather.  None when the
    host arrays of this graph are unknown."""
    fp = getattr(g, "fingerprint", None)
    if fp is None or fp not in _HOST_CACHE:
        return None
    h = _HOST_CACHE[fp]
    device = str(g.device)
    key = (fp, pull.band_rows, pull.edge_chunk, push.band_rows,
           push.edge_chunk, device)
    if key not in _COMPOSITE_CACHE:
        m_pad = pull.m_pad
        assert push.m_pad == m_pad
        csr_to_csc = np.asarray(h["csr_to_csc_rank"], np.int64)
        n_total = max(pull.total_padded, push.total_padded)
        comp = np.full(n_total, -1, np.int64)
        pull_rank = np.asarray(pull.banded_rank, np.int64)
        push_rank = np.asarray(push.banded_rank, np.int64)
        # CSR edge i lives at pull slot pull_rank[csr_to_csc[i]] and at
        # push slot push_rank[i]
        comp[pull_rank[:m_pad][csr_to_csc]] = push_rank[:m_pad]
        used = np.zeros(n_total, bool)
        used[push_rank[:m_pad]] = True
        comp[comp < 0] = np.nonzero(~used)[0]  # the n_total - m_pad pads
        inv = np.empty_like(comp)
        inv[comp] = np.arange(n_total)
        _COMPOSITE_CACHE[key] = tuple(
            torch.from_numpy(a.astype(np.int32)).to(device)
            for a in (comp, inv))
    _lru_touch(_COMPOSITE_CACHE, key, MAX_LAYOUTS)
    return _COMPOSITE_CACHE[key][int(inverse)]


def get_layout(
    g, direction: str = "pull", row_bytes: int = 512,
    edge_chunk: int = EDGE_CHUNK,
) -> Optional[BandedLayout]:
    """Banded layout for a GraphSlice, or None when the host data for this
    graph is unknown (e.g. a GraphSlice built from raw arrays).

    ``row_bytes`` = bytes per gathered feature row; the band height is
    ``FAST_TABLE_BYTES // row_bytes`` rows, rounded up to ``ROW_TILE``.
    A relation graph's pull layout has its destinations' rows and bands
    over its sources; its push layout the other way round.
    """
    fp = getattr(g, "fingerprint", None)
    if fp is None or fp not in _HOST_CACHE:
        return None
    if direction not in ("pull", "push"):
        raise ValueError(f"unknown direction {direction!r}")
    table, rows = ((g.n_src_pad, g.n_dst_pad) if direction == "pull"
                   else (g.n_dst_pad, g.n_src_pad))
    if table % ROW_TILE or rows % ROW_TILE:
        return None  # oddly padded slices: no banded layout
    band_rows = max(ROW_TILE, FAST_TABLE_BYTES // max(row_bytes, 1))
    band_rows = min(_round_up(band_rows, ROW_TILE), table)
    key = (fp, direction, band_rows, edge_chunk)
    if key not in _LAYOUT_CACHE:
        h = _HOST_CACHE[fp]
        if direction == "pull":
            _LAYOUT_CACHE[key] = build_banded_layout(
                h["col_offsets"], h["csc_srcs"], h["csc_weights"],
                h["edge_mask"], band_rows, "pull", edge_chunk=edge_chunk,
                table_rows=table,
            )
        else:
            _LAYOUT_CACHE[key] = build_banded_layout(
                h["row_offsets"], h["csr_dsts"], h["csr_weights"],
                h["edge_mask"], band_rows, "push", edge_chunk=edge_chunk,
                table_rows=table,
            )
    _lru_touch(_LAYOUT_CACHE, key, MAX_LAYOUTS)
    return _LAYOUT_CACHE[key]


def layout_for(g, direction: str, width: int) -> Optional[BandedLayout]:
    """The banded layout of rows ``width`` columns wide: the one the SpMM,
    the SDDMM, GAT's banded layer and ``gcn_normalize`` all take.

    Band height follows the lane-padded float32 row (``width`` rounded up
    to 128 columns of 4 bytes), whatever the rows' dtype, so one layout,
    and the weights pre-banded on it, serves float32 and bf16 rows and
    every width up to the next multiple of 128."""
    return get_layout(g, direction, row_bytes=-(-width // 128) * 128 * 4)
