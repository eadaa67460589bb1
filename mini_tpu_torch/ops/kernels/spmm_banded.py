"""Banded segment sum (the SpMM core): the CUDA kernel
``csrc/spmm_banded.cu`` and its plain torch version.

``out[v] = sum_k sum msgs[k][offs2d[t,k,r] : next]`` for ``v = 128 t + r``,
where ``next`` is ``offs2d[t,k,r+1]``, or ``bounds[k,t+1]`` for ``r = 127``.
Inputs are those of the TPU twin
``mini_tpu.ops.pallas.spmm_banded.banded_segment_sum``: ``bounds``
int32 ``[K, n_tiles+1]``, ``offs2d`` int32 ``[n_tiles, K, 128]`` and K
streams ``msgs[k]`` of shape ``[mk_pad, F]``, float32 or bfloat16.  The
result is float32 ``[n_tiles*128, F]``, accumulated in float32.

``precision``: ``"split"`` and ``"highest"`` both mean an exact float32
accumulate of the messages as given; ``"fast"`` first rounds float32
messages to bfloat16, as the twin's fast path does.

:func:`banded_segment_sum` dispatches by device: a CPU tensor takes
:func:`banded_segment_sum_plain`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mini_tpu_torch.graph.banded import EDGE_CHUNK, ROW_TILE
from mini_tpu_torch.ops.kernels import _build

PRECISIONS = ("split", "highest", "fast")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    # (msg_ptrs, K, bounds, offs2d, out, n_tiles, F, dtype, stream) -> error
    "banded_segment_sum_launch": (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "banded_max_bands": ([], ctypes.c_int),
}

launches = 0  # kernel launches since the last reset (see chip_smoke.py)


def _prepare(bounds, offs2d, msgs, precision, edge_chunk) -> list:
    """Check shapes and types; apply ``precision``; return the streams."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    msgs = list(msgs)
    K = len(msgs)
    if K == 0 or bounds.shape[0] != K or offs2d.shape[1] != K:
        raise ValueError(
            f"{K} streams for bounds {tuple(bounds.shape)} and offs2d "
            f"{tuple(offs2d.shape)}"
        )
    if offs2d.shape[0] != bounds.shape[1] - 1 or offs2d.shape[2] != ROW_TILE:
        raise ValueError(f"offs2d must be [n_tiles, K, {ROW_TILE}]")
    dtype, F = msgs[0].dtype, msgs[0].shape[-1]
    for m in msgs:
        if m.ndim != 2 or m.shape[1] != F or m.dtype != dtype:
            raise ValueError("streams must be [mk_pad, F] of one F and dtype")
        if m.shape[0] % edge_chunk:
            raise ValueError(
                f"stream length {m.shape[0]} is not a multiple of "
                f"edge_chunk={edge_chunk}"
            )
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"messages must be float32 or bfloat16, got {dtype}")
    if precision == "fast" and dtype == torch.float32:
        msgs = [m.to(torch.bfloat16) for m in msgs]
    return msgs


def banded_segment_sum_plain(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
) -> torch.Tensor:
    """Plain torch version: per band, an ``index_add_`` of the stream's
    messages into their segments' rows, accumulated in float64 and
    rounded once, so it is a deterministic reference for the kernel."""
    msgs = _prepare(bounds, offs2d, msgs, precision, edge_chunk)
    n_pad = offs2d.shape[0] * ROW_TILE
    device = msgs[0].device
    out = torch.zeros(n_pad, msgs[0].shape[1], dtype=torch.float64,
                      device=device)
    rows = torch.arange(n_pad, device=device)
    for k, m in enumerate(msgs):
        starts = offs2d[:, k, :].reshape(-1).long()
        ends = torch.cat([starts[1:], bounds[k, -1:].long()])
        seg = torch.repeat_interleave(rows, ends - starts)  # stream starts at 0
        out.index_add_(0, seg, m[: seg.numel()].double())
    return out.to(torch.float32)


def banded_segment_sum(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
) -> torch.Tensor:
    """Sum K segment-sorted message streams into float32 ``[n_tiles*128,
    F]`` rows (see module doc).  On CUDA tensors this launches
    ``csrc/spmm_banded.cu``."""
    device = msgs[0].device
    if device.type == "cpu":
        return banded_segment_sum_plain(bounds, offs2d, msgs, precision,
                                        edge_chunk)
    if device.type != "cuda":
        raise RuntimeError(f"no banded_segment_sum kernel for {device}")
    msgs = [m.contiguous() for m in _prepare(bounds, offs2d, msgs,
                                             precision, edge_chunk)]
    for a in (bounds, offs2d):
        if a.device != device or a.dtype != torch.int32:
            raise TypeError("bounds and offs2d must be int32 on the "
                            "messages' device")
    bounds = bounds.contiguous()
    offs2d = offs2d.contiguous()
    lib = _build.load("spmm_banded", _SIGNATURES)
    K = len(msgs)
    if K > lib.banded_max_bands():
        raise ValueError(
            f"{K} bands exceed the kernel's {lib.banded_max_bands()}"
        )
    n_tiles = offs2d.shape[0]
    F = msgs[0].shape[1]
    out = torch.empty(n_tiles * ROW_TILE, F, dtype=torch.float32,
                      device=device)
    ptrs = (ctypes.c_void_p * K)(*[m.data_ptr() for m in msgs])
    rc = lib.banded_segment_sum_launch(
        ptrs, K, bounds.data_ptr(), offs2d.data_ptr(), out.data_ptr(),
        n_tiles, F, _DTYPE_CODE[msgs[0].dtype],
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"banded_segment_sum kernel launch failed: CUDA error {rc}"
        )
    global launches
    launches += 1
    return out
