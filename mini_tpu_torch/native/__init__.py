"""ctypes bindings for the native C++ graph loader (``src/loader.cpp``),
with ``mini_tpu.native``'s names and semantics.

The library is built with g++ at first use into ``mini_tpu_torch/build/``
under a name that carries the hash of the source and the flags, through a
private name and a rename (``ops/kernels/_build.compile_library``), so
processes that build at once each load a whole library.  Its arrays are
bitwise those of the NumPy path of ``graph.csr.from_edges`` and
``graph.io.load_mtx``, so a caller that gets ``None`` (no library, or a
request the library declines) takes the NumPy path with the same result.
A failed build is not hidden: it warns once, and
:func:`native_build_error` returns the compiler's message.
Random-weight generation stays in NumPy (RandomState parity), so
:func:`native_load_mtx` declines those requests.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import warnings
from typing import Optional

import numpy as np

from mini_tpu_torch.ops.kernels import _build

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "loader.cpp")
BUILD_DIR = _build.BUILD_DIR
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mg_load_mtx.restype = ctypes.c_int
    lib.mg_load_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                _i64p]
    lib.mg_build.restype = ctypes.c_int
    lib.mg_build.argtypes = [ctypes.c_int64, ctypes.c_int64, _i32p, _i32p,
                             _f32p, _i64p]
    lib.mg_fill.restype = ctypes.c_int
    lib.mg_fill.argtypes = [ctypes.c_int, _i64p, _i32p, _i32p, _f32p, _i64p,
                            _i32p, _i32p, _f32p, _i32p]
    lib.mg_free.restype = None
    lib.mg_free.argtypes = [ctypes.c_int]
    return lib


def _get_lib():
    """The loaded library, built at first use; None after a failed build
    (which is then not tried again in this process)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ was not found on $PATH")
            path, _ = _build.compile_library(SRC, "mini_graph", gxx,
                                             GXX_FLAGS, BUILD_DIR)
            _lib = _bind(ctypes.CDLL(path))
        except (RuntimeError, OSError) as e:
            _error = f"the native graph loader is unavailable: {e}"
            warnings.warn(_error + "; the NumPy path builds the same arrays",
                          RuntimeWarning, stacklevel=3)
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def native_build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's message), or None
    when it built or has not been asked for yet."""
    return _error


def _extract(lib, handle: int, n: int, m: int, directed: bool):
    from mini_tpu_torch.graph.csr import HostGraph

    arrays = dict(
        row_offsets=np.empty(n + 1, np.int64),
        csr_dsts=np.empty(m, np.int32),
        csr_srcs=np.empty(m, np.int32),
        csr_weights=np.empty(m, np.float32),
        col_offsets=np.empty(n + 1, np.int64),
        csc_srcs=np.empty(m, np.int32),
        csc_dsts=np.empty(m, np.int32),
        csc_weights=np.empty(m, np.float32),
        csc_eids=np.empty(m, np.int32),
    )
    types = (_i64p, _i32p, _i32p, _f32p, _i64p, _i32p, _i32p, _f32p, _i32p)
    ok = lib.mg_fill(handle, *(a.ctypes.data_as(t)
                               for a, t in zip(arrays.values(), types)))
    lib.mg_free(handle)
    if not ok:
        return None
    return HostGraph(n=n, m=m, directed=directed, **arrays)


def native_load_mtx(
    path: str,
    undirected: bool = False,
    random_weights: bool = False,
    seed: int = 0,
    transpose: bool = False,
):
    """Load an .mtx via the native parser; None if unavailable/declined
    (a file the parser refuses included: the NumPy path then says why)."""
    if random_weights:
        return None  # RandomState parity requires the NumPy path
    lib = _get_lib()
    if lib is None:
        return None
    dims = np.zeros(2, np.int64)
    handle = lib.mg_load_mtx(os.fsencode(path), int(undirected),
                             int(transpose), dims.ctypes.data_as(_i64p))
    if handle <= 0:
        return None
    return _extract(lib, handle, int(dims[0]), int(dims[1]),
                    directed=not undirected)


def native_from_edges(
    srcs: np.ndarray,
    dsts: np.ndarray,
    weights: Optional[np.ndarray],
    num_nodes: int,
    directed: bool = True,
):
    """Native CSR/CSC build from an edge list; None if unavailable.
    Raises ValueError on a vertex id outside ``[0, num_nodes)`` or a
    weight count other than the edge count (the NumPy path raises too)."""
    srcs = np.ascontiguousarray(srcs)
    dsts = np.ascontiguousarray(dsts)
    m = srcs.shape[0]
    if dsts.shape != (m,) or (weights is not None
                              and np.shape(weights) != (m,)):
        raise ValueError(f"{m} sources, {dsts.shape} destinations and "
                         f"{np.shape(weights)} weights: one each per edge")
    if m and (min(srcs.min(), dsts.min()) < 0
              or max(srcs.max(), dsts.max()) >= num_nodes):
        raise ValueError(f"vertex ids must lie in [0, {num_nodes})")
    lib = _get_lib()
    if lib is None:
        return None
    srcs = np.ascontiguousarray(srcs, np.int32)
    dsts = np.ascontiguousarray(dsts, np.int32)
    w = (None if weights is None
         else np.ascontiguousarray(weights, np.float32))
    dims = np.zeros(2, np.int64)
    handle = lib.mg_build(
        num_nodes, m, srcs.ctypes.data_as(_i32p), dsts.ctypes.data_as(_i32p),
        None if w is None else w.ctypes.data_as(_f32p),
        dims.ctypes.data_as(_i64p),
    )
    if handle <= 0:
        return None
    return _extract(lib, handle, int(dims[0]), int(dims[1]), directed)
