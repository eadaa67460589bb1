"""MatrixMarket-style graph loading (NumPy, host-side).

Parity with gunrock/mini's loader (`src/graph.hxx:96-223`):
``%`` comment lines skipped, header ``rows cols nnz``, 1-based indices,
optional undirected doubling, optional random integer weights in [0, 64)
(default weight 1.0).  Column 1 is the source by default;
``transpose=True`` reproduces gunrock's column-2-as-source CSR
(`graph.hxx:166-171`).  The same code as ``mini_tpu.graph.io``: the native
C++ parser first (``mini_tpu_torch.native``), the NumPy path as its
fallback and oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mini_tpu_torch.graph.csr import HostGraph, from_edges


def parse_mtx_edges(
    path: str,
    random_weights: bool = False,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]:
    """Parse an .mtx file into (srcs, dsts, weights, num_nodes), 0-based."""
    with open(path, "r") as f:
        line = f.readline()
        while line and line.startswith("%"):
            line = f.readline()
        parts = line.split()
        if len(parts) != 3:
            raise ValueError(f"bad mtx header in {path}: {line!r}")
        height, _width, num_edges = (int(p) for p in parts)
        data = np.loadtxt(f, ndmin=2, max_rows=num_edges)
    if data.shape[0] != num_edges:
        raise ValueError(
            f"{path}: expected {num_edges} edges, got {data.shape[0]}"
        )
    srcs = data[:, 0].astype(np.int64) - 1
    dsts = data[:, 1].astype(np.int64) - 1
    if data.shape[1] >= 3:
        weights = data[:, 2].astype(np.float32)
    elif random_weights:
        rng = np.random.RandomState(seed)
        weights = rng.randint(0, 64, size=num_edges).astype(np.float32)
    else:
        weights = np.ones(num_edges, dtype=np.float32)
    return srcs, dsts, weights, height


def load_mtx(
    path: str,
    undirected: bool = False,
    random_weights: bool = False,
    seed: int = 0,
    transpose: bool = False,
    use_native: bool = True,
) -> HostGraph:
    """Load a graph from an .mtx file into a :class:`HostGraph`:
    ``use_native`` tries the native parser first (``mini_tpu_torch.native``,
    bitwise the NumPy path, which it falls back to when the library is
    unavailable or declines the request)."""
    if use_native:
        from mini_tpu_torch.native import native_load_mtx

        hg = native_load_mtx(
            path,
            undirected=undirected,
            random_weights=random_weights,
            seed=seed,
            transpose=transpose,
        )
        if hg is not None:
            return hg
    srcs, dsts, weights, n = parse_mtx_edges(
        path, random_weights=random_weights, seed=seed
    )
    if transpose:
        srcs, dsts = dsts, srcs
    return from_edges(
        srcs, dsts, weights, num_nodes=n, make_undirected=undirected
    )


def save_mtx(hg: HostGraph, path: str, weights: bool = False) -> None:
    """Write a HostGraph's CSR edge list as a 1-based .mtx file."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{hg.n} {hg.n} {hg.m}\n")
        for s, d, w in zip(hg.csr_srcs, hg.csr_dsts, hg.csr_weights):
            if weights:
                f.write(f"{s + 1} {d + 1} {w}\n")
            else:
                f.write(f"{s + 1} {d + 1}\n")
