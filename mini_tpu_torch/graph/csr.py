"""Host- and device-side graph storage.

The host graph (:class:`HostGraph`, :func:`from_edges`) is NumPy and is the
same code as ``mini_tpu.graph.csr``: both packages build bitwise-identical
arrays from the same edge list.  The device graph (:class:`GraphSlice`)
holds the same padded CSR + CSC arrays as torch tensors on one device:

* ``n_pad = roundup(n + 1, n_multiple)``: at least one ghost vertex;
* ``m_pad = roundup(m, m_multiple)``: pad edges connect the last ghost
  vertex ``n_pad - 1`` to itself with weight 0 and ``edge_mask == False``.

Ghost vertices have zero degree.  Operators mask every per-edge value with
``edge_mask`` (CSR order) / ``edge_mask_csc`` (CSC order).

A relation graph (:func:`from_edges_bipartite`) has its sources and its
destinations in two vertex sets, of ``n_src`` and ``n_dst`` vertices: its
CSR rows are the sources', its CSC rows the destinations', each side
padded as above with its own ghost.  A :class:`TypedGraph` holds the
vertex counts of its types and its relations between them.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from mini_tpu_torch.utils.device import resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class HostGraph:
    """Host-side (NumPy) graph in both CSR and CSC form.

    CSR arrays are in (src, dst) sorted edge order; CSC arrays in (dst, src)
    sorted order.  ``csc_eids`` maps each CSC-position edge back to its CSR
    edge id so per-edge values can be carried between the two views.
    """

    n: int
    m: int
    directed: bool
    # CSR (edges sorted by (src, dst)):
    row_offsets: np.ndarray  # int64[n+1]
    csr_dsts: np.ndarray  # int32[m]
    csr_srcs: np.ndarray  # int32[m]
    csr_weights: np.ndarray  # float32[m]
    # CSC (edges sorted by (dst, src)):
    col_offsets: np.ndarray  # int64[n+1]
    csc_srcs: np.ndarray  # int32[m]
    csc_dsts: np.ndarray  # int32[m]
    csc_weights: np.ndarray  # float32[m]
    csc_eids: np.ndarray  # int32[m] -> CSR edge id
    # the destinations' count where they are another vertex set than the
    # sources (a relation graph: col_offsets has n_dst + 1 entries and n
    # counts the sources); None: the square graph's n
    n_dst: Optional[int] = None

    @property
    def out_degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int32)

    @property
    def in_degrees(self) -> np.ndarray:
        return np.diff(self.col_offsets).astype(np.int32)

    def edge_list(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(srcs, dsts, weights) in CSR order."""
        return self.csr_srcs, self.csr_dsts, self.csr_weights


def from_edges(
    srcs: np.ndarray,
    dsts: np.ndarray,
    weights: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    directed: bool = True,
    make_undirected: bool = False,
) -> HostGraph:
    """Build a :class:`HostGraph` from an edge list.

    ``make_undirected=True`` doubles every edge (u,v) into (u,v),(v,u) —
    gunrock's ``_undir`` loader flag (`graph.hxx:129-133`).  Duplicate and
    self-loop edges are kept as-is, as gunrock keeps them.
    """
    srcs = np.asarray(srcs, dtype=np.int64)
    dsts = np.asarray(dsts, dtype=np.int64)
    if weights is None:
        weights = np.ones(srcs.shape[0], dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    if make_undirected:
        srcs, dsts = np.concatenate([srcs, dsts]), np.concatenate([dsts, srcs])
        weights = np.concatenate([weights, weights])
        directed = False
    if num_nodes is None:
        num_nodes = int(max(srcs.max(initial=-1), dsts.max(initial=-1)) + 1)
    n = int(num_nodes)
    m = int(srcs.shape[0])

    # Large edge lists take the native C++ radix-sort builder (bitwise the
    # NumPy path below; mini_tpu's threshold, which keeps small graphs off
    # the ctypes round trip).  Without the library it returns None, having
    # warned why, and the NumPy path builds the same arrays.
    if m >= (1 << 20) and n < (1 << 31):
        from mini_tpu_torch.native import native_from_edges

        hg = native_from_edges(srcs, dsts, weights, n, directed=directed)
        if hg is not None:
            return hg
    return from_edges_numpy(srcs, dsts, weights, n, directed)


def from_edges_bipartite(
    srcs: np.ndarray,
    dsts: np.ndarray,
    n_src: int,
    n_dst: int,
    weights: Optional[np.ndarray] = None,
) -> HostGraph:
    """The relation graph of directed edges ``srcs -> dsts`` from a set of
    ``n_src`` vertices into one of ``n_dst``: :func:`from_edges`' arrays
    over ``max(n_src, n_dst)`` ids, with the CSR offsets cut to the
    sources' ``n_src + 1`` and the CSC offsets to the destinations'
    ``n_dst + 1`` (past its own side's ids an offset is ``m``).
    Duplicates are kept."""
    srcs = np.asarray(srcs, dtype=np.int64)
    dsts = np.asarray(dsts, dtype=np.int64)
    n_src, n_dst = int(n_src), int(n_dst)
    if srcs.size and not (0 <= srcs.min() and srcs.max() < n_src):
        raise ValueError(f"a source id lies outside [0, {n_src})")
    if dsts.size and not (0 <= dsts.min() and dsts.max() < n_dst):
        raise ValueError(f"a destination id lies outside [0, {n_dst})")
    hg = from_edges(srcs, dsts, weights, num_nodes=max(n_src, n_dst))
    return dataclasses.replace(
        hg, n=n_src, n_dst=n_dst, row_offsets=hg.row_offsets[: n_src + 1],
        col_offsets=hg.col_offsets[: n_dst + 1])


def from_edges_numpy(
    srcs: np.ndarray,
    dsts: np.ndarray,
    weights: np.ndarray,
    n: int,
    directed: bool,
) -> HostGraph:
    """:func:`from_edges`'s NumPy path (the native builder's oracle) on a
    normalized edge list: int64 ids in ``[0, n)``, float32 weights."""
    m = int(srcs.shape[0])
    # CSR: sort by (src, dst); CSC: sort by (dst, src).  np.lexsort is stable,
    # last key is primary.
    csr_order = np.lexsort((dsts, srcs))
    csc_order = np.lexsort((srcs, dsts))

    csr_srcs = srcs[csr_order].astype(np.int32)
    csr_dsts = dsts[csr_order].astype(np.int32)
    csr_weights = weights[csr_order]
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(csr_srcs, minlength=n), out=row_offsets[1:])

    csc_srcs = srcs[csc_order].astype(np.int32)
    csc_dsts = dsts[csc_order].astype(np.int32)
    csc_weights = weights[csc_order]
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(csc_dsts, minlength=n), out=col_offsets[1:])

    # Map CSC positions back to CSR edge ids: csr_order[i] is the original
    # edge at CSR slot i; invert then compose.
    inv_csr = np.empty(m, dtype=np.int64)
    inv_csr[csr_order] = np.arange(m)
    csc_eids = inv_csr[csc_order].astype(np.int32)

    return HostGraph(
        n=n,
        m=m,
        directed=directed,
        row_offsets=row_offsets,
        csr_dsts=csr_dsts,
        csr_srcs=csr_srcs,
        csr_weights=csr_weights,
        col_offsets=col_offsets,
        csc_srcs=csc_srcs,
        csc_dsts=csc_dsts,
        csc_weights=csc_weights,
        csc_eids=csc_eids,
    )


class GraphSlice:
    """Device-resident graph ("gslice", cf. gunrock's `graph.hxx:37-58`).

    Data fields are tensors on one device; meta fields are Python values.
    On a GPU the CSR <-> CSC order switch is a gather: ``csc_eids`` (CSR
    position of each CSC edge) and ``csr_to_csc_rank`` (its inverse) are
    the indices.

    ``n_src``/``n_src_pad`` count the CSR rows (the sources) and
    ``n_dst``/``n_dst_pad`` the CSC rows (the destinations).  On a square
    graph both are ``n``/``n_pad``; on a relation graph whose two sides
    differ ``n`` and ``n_pad`` are None, since the square graph's
    operators do not apply to it: the SpMM and the banded layouts take
    each side's count.
    """

    _DATA_FIELDS = (
        "row_offsets",
        "csr_dsts",
        "csr_srcs",
        "csr_weights",
        "col_offsets",
        "csc_srcs",
        "csc_dsts",
        "csc_weights",
        "csc_eids",
        "csr_to_csc_rank",
        "out_degrees",
        "in_degrees",
        "edge_mask",
        "edge_mask_csc",
    )
    _META_FIELDS = (
        "n",
        "m",
        "n_pad",
        "m_pad",
        "directed",
        "max_out_degree",
        "max_in_degree",
        "fingerprint",  # stable id of the host graph; keys the banded-
        # layout cache (graph/banded.py)
        "n_src",
        "n_dst",
        "n_src_pad",
        "n_dst_pad",
    )
    _SIDE_OF = {"n_src": "n", "n_dst": "n", "n_src_pad": "n_pad",
                "n_dst_pad": "n_pad"}

    def __init__(self, **kw):
        for f in self._DATA_FIELDS + self._META_FIELDS:
            if f == "fingerprint":
                setattr(self, f, kw.get(f))
            elif f in self._SIDE_OF:  # a square graph's sides: n, n_pad
                setattr(self, f, kw.get(f, kw[self._SIDE_OF[f]]))
            else:
                setattr(self, f, kw[f])

    @staticmethod
    def from_host(
        hg: HostGraph,
        n_multiple: int = 128,
        m_multiple: int = 1024,
        device=None,
    ) -> "GraphSlice":
        """The padded device graph of ``hg`` on ``device`` (``None``: the
        card; ``"cpu"`` for the plain torch versions).  A relation graph
        (``hg.n_dst`` set) pads each side with its own ghost, and its pad
        edges join the two ghosts."""
        device = resolve_device(device)
        n_src, m = hg.n, hg.m
        # a host graph of another make (the JAX package's) is square
        bipartite = getattr(hg, "n_dst", None) is not None
        n_dst = hg.n_dst if bipartite else n_src
        src_pad = _round_up(n_src + 1, n_multiple)
        dst_pad = _round_up(n_dst + 1, n_multiple)
        m_pad = _round_up(max(m, 1), m_multiple)
        src_ghost, dst_ghost = src_pad - 1, dst_pad - 1
        pad_e = m_pad - m

        def pad_edges(a, fill):
            return np.concatenate(
                [a, np.full(pad_e, fill, dtype=a.dtype)]
            ) if pad_e else a

        def pad_offsets(off, n, n_pad):
            # Real vertices keep their offsets; ghost vertices [n, ghost)
            # have zero degree (offset m); the last ghost absorbs pad edges.
            out = np.full(n_pad + 1, m, dtype=np.int32)
            out[: n + 1] = off.astype(np.int32)
            out[n_pad] = m_pad
            return out

        # position of CSR edge e in CSC order (inverse of csc_eids); pad
        # edges map to themselves.
        csc_eids_pad = pad_edges(hg.csc_eids, 0)
        csr_to_csc = np.arange(m_pad, dtype=np.int32)
        csr_to_csc[csc_eids_pad[:m]] = np.arange(m, dtype=np.int32)

        arrays = dict(
            csr_to_csc_rank=csr_to_csc,
            row_offsets=pad_offsets(hg.row_offsets, n_src, src_pad),
            csr_dsts=pad_edges(hg.csr_dsts, dst_ghost),
            csr_srcs=pad_edges(hg.csr_srcs, src_ghost),
            csr_weights=pad_edges(hg.csr_weights, 0.0),
            col_offsets=pad_offsets(hg.col_offsets, n_dst, dst_pad),
            csc_srcs=pad_edges(hg.csc_srcs, src_ghost),
            csc_dsts=pad_edges(hg.csc_dsts, dst_ghost),
            csc_weights=pad_edges(hg.csc_weights, 0.0),
            csc_eids=pad_edges(hg.csc_eids, m_pad - 1 if pad_e else 0),
            out_degrees=np.concatenate(
                [hg.out_degrees, np.zeros(src_pad - n_src, np.int32)]
            ),
            in_degrees=np.concatenate(
                [hg.in_degrees, np.zeros(dst_pad - n_dst, np.int32)]
            ),
            edge_mask=np.concatenate(
                [np.ones(m, bool), np.zeros(pad_e, bool)]
            ),
            edge_mask_csc=np.concatenate(
                [np.ones(m, bool), np.zeros(pad_e, bool)]
            ),
        )
        # Fingerprint the host graph and register the padded host arrays so
        # banded SpMM layouts (graph/banded.py) can be built lazily.
        from mini_tpu_torch.graph import banded as _banded

        hsh = hashlib.blake2b(digest_size=16)
        hsh.update(np.int64(n_src).tobytes())
        hsh.update(np.int64(m).tobytes())
        if bipartite:  # a square graph's print is unchanged
            hsh.update(np.int64(n_dst).tobytes())
        hsh.update(arrays["row_offsets"].tobytes())
        hsh.update(arrays["csr_dsts"].tobytes())
        hsh.update(arrays["csr_weights"].tobytes())
        fingerprint = hsh.hexdigest()
        _banded.register_host_graph(
            fingerprint,
            {
                k: arrays[k]
                for k in (
                    "row_offsets", "csr_dsts", "csr_weights",
                    "col_offsets", "csc_srcs", "csc_weights", "edge_mask",
                    "csr_to_csc_rank",  # composes the pull-to-push rank
                )
            },
        )

        square = n_src == n_dst
        return GraphSlice(
            fingerprint=fingerprint,
            n=n_src if square else None,
            m=m,
            n_pad=src_pad if square else None,
            m_pad=m_pad,
            directed=hg.directed,
            n_src=n_src,
            n_dst=n_dst,
            n_src_pad=src_pad,
            n_dst_pad=dst_pad,
            # the ghost vertex absorbs m_pad - m pad edges, so its segment
            # can exceed the real max degree
            max_out_degree=int(
                max(hg.out_degrees.max(initial=0), m_pad - m)
            ),
            max_in_degree=int(
                max(hg.in_degrees.max(initial=0), m_pad - m)
            ),
            **{
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()
            },
        )

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    def __repr__(self):
        sides = (f"n={self.n}" if self.n is not None else
                 f"n_src={self.n_src}, n_dst={self.n_dst}")
        pads = (f"n_pad={self.n_pad}" if self.n_pad is not None else
                f"n_src_pad={self.n_src_pad}, n_dst_pad={self.n_dst_pad}")
        return (
            f"GraphSlice({sides}, m={self.m}, {pads}, "
            f"m_pad={self.m_pad}, directed={self.directed}, "
            f"device={self.device})"
        )

    # -- convenience -------------------------------------------------------
    def vertex_mask(self) -> torch.Tensor:
        """bool[n_pad] — True for real vertices."""
        return torch.arange(self.n_pad, device=self.device) < self.n

    def csr_ranks(self) -> torch.Tensor:
        """Per-edge rank within its source segment (CSR order)."""
        return segment_ranks(self.row_offsets, self.csr_srcs)

    def csc_ranks(self) -> torch.Tensor:
        """Per-edge rank within its destination segment (CSC order)."""
        return segment_ranks(self.col_offsets, self.csc_dsts)


def segment_ranks(offsets: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """int32 position of each edge within its contiguous segment."""
    return torch.arange(
        seg.shape[0], dtype=torch.int32, device=seg.device
    ) - offsets[seg]


@dataclasses.dataclass(frozen=True)
class Relation:
    """One edge type of a :class:`TypedGraph`: its edges run from vertices
    of type ``src`` to vertices of type ``dst`` (ids local to each type),
    held as the relation graph ``graph``."""

    name: str
    src: str
    dst: str
    graph: GraphSlice


@dataclasses.dataclass(frozen=True)
class TypedGraph:
    """A heterogeneous graph: the vertex count of each type, in order, and
    its relations, each a relation graph (:func:`from_edges_bipartite`,
    then :meth:`GraphSlice.from_host`).  A type's vertices carry ids
    ``0..n-1`` of their own, and every relation pads a type's rows alike
    (:meth:`n_pad`)."""

    num_nodes: dict  # type -> vertex count
    relations: tuple  # Relation, in order

    def n_pad(self, node_type: str) -> int:
        """The padded row count of ``node_type`` in every relation."""
        for r in self.relations:
            if r.src == node_type:
                return r.graph.n_src_pad
            if r.dst == node_type:
                return r.graph.n_dst_pad
        raise KeyError(f"no relation touches type {node_type!r}")

    @property
    def device(self) -> torch.device:
        return self.relations[0].graph.device
