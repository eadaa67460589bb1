"""Static banded edge layout for the SpMM aggregation.

Vertices are cut into K bands of ``band_rows`` rows.  Edges, in the
direction's segment order (CSC for pull: sorted by dst; CSR for push:
sorted by src), are regrouped by the band of the vertex whose features
they gather, keeping the segment order inside each band.  The SpMM then
gathers each band's messages from one slice of ``x`` and the
``banded_segment_sum`` kernel (ops/kernels/spmm_banded.py) folds the K
segment-sorted message streams into one output through per-band offset
staircases, with no per-edge destination array.

The builder is the same NumPy code as ``mini_tpu.graph.banded``, with the
same ``FAST_TABLE_BYTES`` band-height rule, so both packages build
bitwise-identical layouts.  Everything here is host-side and cached by the
GraphSlice fingerprint; :meth:`BandedLayout.dev` moves the arrays to a
device once.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

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
    n_pad: int
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

    def dev(self, device="cpu") -> dict:
        """The layout's arrays as tensors on ``device`` (cached).

        ``offs2d`` is transposed to the kernel-facing ``[n_tiles, K,
        ROW_TILE]``: one tile's offsets for every band are contiguous."""
        device = torch.device(device)
        key = str(device)
        if key not in self._dev:
            inv = np.empty_like(self.banded_rank)
            inv[self.banded_rank] = np.arange(
                self.banded_rank.shape[0], dtype=self.banded_rank.dtype
            )

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            self._dev[key] = dict(
                ids=[t(i) for i in self.ids],
                weights=[t(w) for w in self.weights],
                bounds=t(self.bounds),
                offs2d=t(self.offs2d.transpose(1, 0, 2)),
                banded_rank=t(self.banded_rank),
                inv_rank=t(inv),
            )
        return self._dev[key]

    def permute_to_bands(self, edge_vals: torch.Tensor) -> list:
        """Reorder per-edge values (in this layout's base order: CSC for
        pull, CSR for push) into the banded order: one gather by the
        inverse rank.  Returns the K per-band tensors (pad slots 0)."""
        d = self.dev(edge_vals.device)
        padded = torch.zeros(
            (self.total_padded,) + tuple(edge_vals.shape[1:]),
            dtype=edge_vals.dtype, device=edge_vals.device,
        )
        padded[: edge_vals.shape[0]] = edge_vals
        flat = padded[d["inv_rank"]]
        return list(torch.split(flat, [len(i) for i in self.ids]))

    def permute_from_bands(self, band_vals) -> torch.Tensor:
        """Inverse of :meth:`permute_to_bands`: per-band tensors (or the
        flat banded stream) back to the base edge order, length m_pad."""
        if not isinstance(band_vals, torch.Tensor):
            band_vals = torch.cat(list(band_vals))
        d = self.dev(band_vals.device)
        return band_vals[d["banded_rank"][: self.m_pad]]


def build_banded_layout(
    offsets: np.ndarray,  # int[n_pad+1] segment offsets (CSC for pull)
    gather_ids: np.ndarray,  # int32[m_pad] source-of-message per edge
    weights: np.ndarray,  # float32[m_pad]
    edge_valid: np.ndarray,  # bool[m_pad] — False for ghost/pad edges
    band_rows: int,
    direction: str,
    edge_chunk: int = EDGE_CHUNK,
) -> BandedLayout:
    """Group edges by gather-id band, preserving segment order within each
    band.  Pad/ghost edges keep weight 0 and id 0 so they are no-ops."""
    n_pad = offsets.shape[0] - 1
    m_pad = gather_ids.shape[0]
    assert n_pad % ROW_TILE == 0
    band_rows = min(_round_up(band_rows, ROW_TILE), n_pad)
    K = (n_pad + band_rows - 1) // band_rows

    offsets = offsets.astype(np.int64)
    gid = gather_ids.astype(np.int64)
    # segment id of every edge (offsets are for contiguous sorted segments)
    seg = np.repeat(np.arange(n_pad), np.diff(offsets))
    band = gid // band_rows
    band = np.where(edge_valid, band, K - 1)  # pad edges -> last band

    ids, w_b, lens, eids = [], [], [], []
    band_offsets, band_valid = [], []
    bounds = np.zeros((K, n_pad // ROW_TILE + 1), np.int32)
    offs2d = np.zeros((K, n_pad // ROW_TILE, ROW_TILE), np.int32)
    banded_rank = np.empty(m_pad, np.int64)
    flat_base = 0
    for k in range(K):
        sel = band == k  # segment order is kept by the filter
        idx = np.nonzero(sel)[0]
        mk = int(idx.shape[0])
        mk_pad = max(_round_up(mk, edge_chunk), edge_chunk)
        local = (gid[idx] - k * band_rows).astype(np.int32)
        local = np.where(edge_valid[idx], local, 0).astype(np.int32)
        wk = np.where(edge_valid[idx], weights[idx], 0.0).astype(np.float32)
        pad = mk_pad - mk
        ids.append(np.concatenate([local, np.zeros(pad, np.int32)]))
        w_b.append(np.concatenate([wk, np.zeros(pad, np.float32)]))
        eids.append(
            np.concatenate([idx.astype(np.int32),
                            np.zeros(pad, np.int32)])
        )
        band_valid.append(
            np.concatenate([edge_valid[idx], np.zeros(pad, bool)])
        )
        lens.append(mk)
        # per-dst offsets within this band's stream
        cnt = np.bincount(seg[idx], minlength=n_pad)
        offk = np.zeros(n_pad + 1, np.int64)
        np.cumsum(cnt, out=offk[1:])
        bounds[k] = offk[::ROW_TILE].astype(np.int32)
        offs2d[k] = offk[:n_pad].reshape(-1, ROW_TILE).astype(np.int32)
        band_offsets.append(offk.astype(np.int32))
        banded_rank[idx] = flat_base + np.arange(mk)
        flat_base += mk_pad

    # the flat stream's pad slots are the ranks no edge took; appending
    # them makes the rank a permutation of the whole padded stream
    used = np.zeros(flat_base, bool)
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
        lens=lens,
        bounds=bounds,
        offs2d=offs2d,
        banded_rank=banded_rank_full,
        eids=eids,
        offsets=band_offsets,
        valid=band_valid,
        edge_chunk=edge_chunk,
    )


# ---------------------------------------------------------------------------
# Per-graph caches, keyed by the GraphSlice fingerprint.  Both are LRU-bounded
# so long-lived processes loading many graphs don't grow host memory without
# bound (each layout holds ~3x the graph's edge bytes).

MAX_HOST_GRAPHS = 8
MAX_LAYOUTS = 16

_HOST_CACHE: OrderedDict = OrderedDict()  # fingerprint -> host arrays
_LAYOUT_CACHE: OrderedDict = OrderedDict()  # (fp, dir, rows, chunk) -> layout


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
    # layouts of evicted graphs are keyed by fingerprint prefix — drop them
    live = set(_HOST_CACHE)
    for k in [k for k in _LAYOUT_CACHE if k[0] not in live]:
        del _LAYOUT_CACHE[k]


def get_layout(
    g, direction: str = "pull", row_bytes: int = 512,
    edge_chunk: int = EDGE_CHUNK,
) -> Optional[BandedLayout]:
    """Banded layout for a GraphSlice, or None when the host data for this
    graph is unknown (e.g. a GraphSlice built from raw arrays).

    ``row_bytes`` = bytes per gathered feature row; the band height is
    ``FAST_TABLE_BYTES // row_bytes`` rows, rounded up to ``ROW_TILE``.
    """
    fp = getattr(g, "fingerprint", None)
    if fp is None or fp not in _HOST_CACHE:
        return None
    if g.n_pad % ROW_TILE != 0:  # oddly padded slices: no banded layout
        return None
    band_rows = max(ROW_TILE, FAST_TABLE_BYTES // max(row_bytes, 1))
    band_rows = min(_round_up(band_rows, ROW_TILE), g.n_pad)
    key = (fp, direction, band_rows, edge_chunk)
    if key not in _LAYOUT_CACHE:
        h = _HOST_CACHE[fp]
        if direction == "pull":
            _LAYOUT_CACHE[key] = build_banded_layout(
                h["col_offsets"], h["csc_srcs"], h["csc_weights"],
                h["edge_mask"], band_rows, "pull", edge_chunk=edge_chunk,
            )
        elif direction == "push":
            _LAYOUT_CACHE[key] = build_banded_layout(
                h["row_offsets"], h["csr_dsts"], h["csr_weights"],
                h["edge_mask"], band_rows, "push", edge_chunk=edge_chunk,
            )
        else:
            raise ValueError(f"unknown direction {direction!r}")
    _lru_touch(_LAYOUT_CACHE, key, MAX_LAYOUTS)
    return _LAYOUT_CACHE[key]
