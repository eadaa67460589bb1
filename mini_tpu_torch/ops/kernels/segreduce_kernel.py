"""Contiguous-segment min/max/sum/bor: the CUDA kernel
``csrc/segreduce.cu`` and its plain torch version.

``out[v] = op(vals[offsets[v]:offsets[v+1]])``; empty segments get the
identity.  The argument list is that of the TPU twin
``mini_tpu.ops.pallas.segreduce_kernel.segment_reduce_pallas``, so a test
can feed both the same arrays; the CUDA kernel reads only ``offsets`` and
``vals``.  Any edge count is accepted.

:func:`segment_reduce` dispatches by device: a CPU tensor takes
:func:`segment_reduce_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from mini_tpu_torch.ops.kernels import _build
from mini_tpu_torch.ops.segment import identity_for

OPS = ("min", "max", "sum", "bor")
_OP_CODE = {"min": 0, "max": 1, "sum": 2, "bor": 3}
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
_SIGNATURES = {
    # (offsets, vals, out, n, dtype, op, ident_f, ident_i, stream) -> error
    "segreduce_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_longlong,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
}

launches = 0  # kernel launches since the last reset (see chip_smoke.py)


def default_identity(op: str, dtype: torch.dtype):
    """The twin's ``_default_identity``: 0 for bor, else the reduction
    identity of ``op``."""
    return identity_for("sum" if op == "bor" else op, dtype)


def _check(offsets, vals, op):
    if op not in _OP_CODE:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"vals must be int32 or float32, got {vals.dtype}")
    if op == "bor" and vals.dtype != torch.int32:
        raise TypeError("bor reduces int32 values only")
    if vals.ndim != 1 or offsets.ndim != 1:
        raise ValueError("offsets and vals must be 1-D")


def segment_reduce_plain(
    offsets: torch.Tensor,
    dsts: torch.Tensor,
    vals: torch.Tensor,
    op: str,
    identity=None,
) -> torch.Tensor:
    """Plain torch version: a scatter-reduce by segment id (``dsts``, the
    sorted segment id of each value); ``bor`` folds bit by bit, and the
    float32 sum accumulates in float64, so it is a deterministic
    reference for the kernel's float32 sum."""
    _check(offsets, vals, op)
    if identity is None:
        identity = default_identity(op, vals.dtype)
    n_pad = offsets.shape[0] - 1
    out = torch.full((n_pad,), identity, dtype=vals.dtype,
                     device=vals.device)
    if op == "bor":
        seg = dsts.long()
        bits = torch.zeros(n_pad, dtype=torch.int64, device=vals.device)
        for b in range(32):
            hit = torch.zeros(n_pad, dtype=torch.int32, device=vals.device)
            hit.scatter_reduce_(0, seg, (vals >> b) & 1, "amax")
            bits |= hit.long() << b
        bits -= (bits >= 2**31).long() << 32  # back into int32 range
        nonempty = offsets[1:] > offsets[:-1]
        return torch.where(nonempty, bits.to(torch.int32) | identity, out)
    if op == "sum" and vals.dtype == torch.float32:
        out64 = out.double().scatter_reduce_(0, dsts.long(), vals.double(),
                                             "sum")
        return out64.to(torch.float32)
    reduce = {"min": "amin", "max": "amax", "sum": "sum"}[op]
    return out.scatter_reduce_(0, dsts.long(), vals, reduce)


def segment_reduce(
    offsets: torch.Tensor,
    dsts: torch.Tensor,
    vals: torch.Tensor,
    op: str,
    identity=None,
) -> torch.Tensor:
    """out[v] = op(vals[offsets[v]:offsets[v+1]]) for contiguous sorted
    segments, ``op`` in min/max/sum/bor, int32 or float32 values.  On a
    CUDA tensor this launches ``csrc/segreduce.cu``."""
    if vals.device.type == "cpu":
        return segment_reduce_plain(offsets, dsts, vals, op, identity)
    if vals.device.type != "cuda":
        raise RuntimeError(f"no segment_reduce kernel for {vals.device}")
    _check(offsets, vals, op)
    if offsets.device != vals.device or offsets.dtype != torch.int32:
        raise TypeError("offsets must be int32 on the values' device")
    if identity is None:
        identity = default_identity(op, vals.dtype)
    offsets = offsets.contiguous()
    vals = vals.contiguous()
    n_pad = offsets.shape[0] - 1
    out = torch.empty(n_pad, dtype=vals.dtype, device=vals.device)
    lib = _build.load("segreduce", _SIGNATURES)
    rc = lib.segreduce_launch(
        offsets.data_ptr(), vals.data_ptr(), out.data_ptr(), n_pad,
        _DTYPE_CODE[vals.dtype], _OP_CODE[op], float(identity),
        int(identity) if vals.dtype == torch.int32 else 0,
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segreduce kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
