"""Fixed permutation of payloads and of table rows: the CUDA kernel
``csrc/permute.cu`` and its plain torch versions.

``permute(rank, payloads)`` returns ``out[rank[i]] = payload[i]`` for each
payload; ``inverse=True`` returns ``out[i] = payload[rank[i]]``, the
transpose.  ``rank`` is int32 ``[m]``, a permutation of ``[0, m)``; each
payload is a 1-D ``[m]`` tensor of any dtype of 1, 2, 4 or 8 bytes
(bool, bfloat16, float32, int64, ...).  ``permute_rows(rank, table)`` does
the same to the rows of one contiguous ``[m, P]`` table.

The kernel moves the rows of one table, each in its widest aligned words
(:func:`word_bytes`, up to 16 bytes).  :func:`permute` stacks the
payloads of one element size into one ``[m, n]`` table and moves it with
:func:`permute_rows`, so a scattered access moves 8 or 16 bytes where it
moved 4: one launch per element size.  On the card a payload's result is
a column of its table (a strided view).

The Hopper form of ``scratch/probe_butterfly.py``'s Benes-stage kernel,
whose production counterpart is ``mini_tpu.ops.permute.apply_fixed_perm``
(one ``lax.sort``).  :func:`permute` and :func:`permute_rows` dispatch by
device: a CPU tensor takes :func:`permute_plain` or
:func:`permute_rows_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mini_tpu_torch.ops.kernels import _build, refuse_grad

RECORD_BYTES = 16  # the widest access a thread makes
# the integer dtype a payload of each element size travels as
_WORD_DTYPES = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}

launches = 0  # kernel launches since the last reset (see chip_smoke.py)
_launch = None  # the bound C entry, set at the first launch


def word_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest access, a power of two up to ``RECORD_BYTES``, that
    divides a row and every address."""
    align = row_bytes
    for p in ptrs:
        align |= p
    w = RECORD_BYTES
    while align % w:
        w //= 2
    return w


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


def _check_table(rank, table):
    if rank.ndim != 1 or rank.dtype != torch.int32:
        raise TypeError(f"rank must be 1-D int32, got {rank.dtype} "
                        f"{tuple(rank.shape)}")
    if table.ndim != 2 or table.shape[0] != rank.shape[0]:
        raise ValueError(f"table {tuple(table.shape)} is not [m, P] for rank "
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


def permute_rows_plain(rank: torch.Tensor, table: torch.Tensor,
                       inverse: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`permute_rows`."""
    _check_table(rank, table)
    idx = rank.long()
    if inverse:
        return torch.index_select(table, 0, idx)
    out = torch.empty_like(table)
    out[idx] = table
    return out


def _on_card(rank, tensors, name) -> bool:
    """True for CUDA inputs (checked to share the rank's card), False for
    CPU ones; raises for other devices."""
    if not rank.is_cuda:
        if rank.device.type == "cpu":
            return False
        raise RuntimeError(f"no permute kernel for {rank.device}")
    refuse_grad(name, *tensors)
    dev = rank.get_device()
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"all inputs must lie on {rank.device}")
    return True


def permute(rank: torch.Tensor, payloads: Sequence[torch.Tensor],
            inverse: bool = False) -> list:
    """Permute every payload by ``rank`` (see module doc); returns the list
    of outputs.  On CUDA tensors the payloads of one element size are
    stacked into one table and moved by :func:`permute_rows`."""
    payloads = list(payloads)
    if not _on_card(rank, payloads, "apply_fixed_perm"):
        return permute_plain(rank, payloads, inverse)
    _check(rank, payloads)
    by_size: dict = {}
    for i, p in enumerate(payloads):
        if p.element_size() not in _WORD_DTYPES:
            raise TypeError(f"no permute kernel for {p.dtype} payloads")
        by_size.setdefault(p.element_size(), []).append(i)
    outs = [None] * len(payloads)
    for size, idx in by_size.items():
        word = _WORD_DTYPES[size]
        table = torch.stack([payloads[i].view(word) for i in idx], dim=1)
        moved = permute_rows(rank, table, inverse)
        for j, i in enumerate(idx):
            outs[i] = moved[:, j].view(payloads[i].dtype)
    return outs


def permute_rows(rank: torch.Tensor, table: torch.Tensor,
                 inverse: bool = False) -> torch.Tensor:
    """``out[rank[i], :] = table[i, :]`` for a ``[m, P]`` table;
    ``inverse=True``: ``out[i, :] = table[rank[i], :]``, the transpose.
    On CUDA tensors this launches ``csrc/permute.cu``, one row a thread."""
    if not _on_card(rank, [table], "permute_rows"):
        return permute_rows_plain(rank, table, inverse)
    _check_table(rank, table)
    rank = rank.contiguous()
    table = table.contiguous()
    out = torch.empty_like(table)
    m, row_bytes = table.shape[0], table.shape[1] * table.element_size()
    if m and row_bytes:
        global _launch, launches
        if _launch is None:
            # (rank, in, out, word, words, m, inverse, stream) -> error
            P = ctypes.c_void_p
            _launch = _build.bind("permute", "permute_launch", [
                P, P, P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, P])
        word = word_bytes(row_bytes, table.data_ptr(), out.data_ptr())
        rc = _launch(rank.data_ptr(), table.data_ptr(), out.data_ptr(), word,
                     row_bytes // word, m, int(inverse),
                     _build.stream(rank.get_device()))
        if rc:
            raise RuntimeError(f"permute kernel launch failed: CUDA error "
                               f"{rc}")
        launches += 1
    return out
