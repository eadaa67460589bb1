"""Fixed permutation of 1-D payloads: the CUDA kernel ``csrc/permute.cu``
and its plain torch version.

``permute(rank, payloads)`` returns ``out[rank[i]] = payload[i]`` for each
payload; ``inverse=True`` returns ``out[i] = payload[rank[i]]``, the
transpose.  ``rank`` is int32 ``[m]``, a permutation of ``[0, m)``; each
payload is a 1-D ``[m]`` tensor of any dtype of 1, 2, 4 or 8 bytes
(bool, bfloat16, float32, int64, ...).  All payloads move in one launch
(up to 16 per launch), whatever their dtypes.

The Hopper form of ``scratch/probe_butterfly.py``'s Benes-stage kernel,
whose production counterpart is ``mini_tpu.ops.permute.apply_fixed_perm``
(one ``lax.sort``).  :func:`permute` dispatches by device: a CPU tensor
takes :func:`permute_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mini_tpu_torch.ops.kernels import _build, refuse_grad

_SIGNATURES = {
    # (rank, in_ptrs, out_ptrs, sizes, P, m, inverse, stream) -> error
    "permute_launch": (
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
         ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "permute_max_payloads": ([], ctypes.c_int),
}

launches = 0  # kernel launches since the last reset (see chip_smoke.py)


def _check(rank, payloads):
    if rank.ndim != 1 or rank.dtype != torch.int32:
        raise TypeError(f"rank must be 1-D int32, got {rank.dtype} "
                        f"{tuple(rank.shape)}")
    if not payloads:
        raise ValueError("no payloads")
    for p in payloads:
        if tuple(p.shape) != tuple(rank.shape):
            raise ValueError(f"payload {tuple(p.shape)} does not match rank "
                             f"{tuple(rank.shape)}")


def permute_plain(rank: torch.Tensor, payloads: Sequence[torch.Tensor],
                  inverse: bool = False) -> list:
    """Plain torch version: an indexed store by ``rank`` (forward) or an
    ``index_select`` by it (inverse)."""
    payloads = list(payloads)
    _check(rank, payloads)
    idx = rank.long()
    if inverse:
        return [torch.index_select(p, 0, idx) for p in payloads]
    outs = []
    for p in payloads:
        out = torch.empty_like(p)
        out[idx] = p
        outs.append(out)
    return outs


def permute(rank: torch.Tensor, payloads: Sequence[torch.Tensor],
            inverse: bool = False) -> list:
    """Permute every payload by ``rank`` (see module doc); returns the list
    of outputs.  On CUDA tensors this launches ``csrc/permute.cu``, once
    per 16 payloads."""
    payloads = list(payloads)
    if rank.device.type == "cpu":
        return permute_plain(rank, payloads, inverse)
    if rank.device.type != "cuda":
        raise RuntimeError(f"no permute kernel for {rank.device}")
    refuse_grad("apply_fixed_perm", *payloads)
    _check(rank, payloads)
    for p in payloads:
        if p.device != rank.device:
            raise ValueError(f"all inputs must lie on {rank.device}")
        if p.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"no permute kernel for {p.dtype} payloads")
    rank = rank.contiguous()
    payloads = [p.contiguous() for p in payloads]
    outs = [torch.empty_like(p) for p in payloads]
    m = rank.shape[0]
    if m == 0:
        return outs
    lib = _build.load("permute", _SIGNATURES)
    per_launch = lib.permute_max_payloads()
    stream = torch.cuda.current_stream(rank.device).cuda_stream
    global launches
    for lo in range(0, len(payloads), per_launch):
        ins, dsts = payloads[lo:lo + per_launch], outs[lo:lo + per_launch]
        P = len(ins)
        rc = lib.permute_launch(
            rank.data_ptr(), (ctypes.c_void_p * P)(*[p.data_ptr()
                                                    for p in ins]),
            (ctypes.c_void_p * P)(*[o.data_ptr() for o in dsts]),
            (ctypes.c_int * P)(*[p.element_size() for p in ins]), P, m,
            int(inverse), stream,
        )
        if rc != 0:
            raise RuntimeError(f"permute kernel launch failed: CUDA error "
                               f"{rc}")
        launches += 1
    return outs
