"""Row gather ``out[j] = table[idx[j]]``: the CUDA kernel
``csrc/gather_rows.cu`` and its plain torch version.

The Hopper form of the scratch probes' TPU row gathers
(``scratch/probe_dma_gather.py`` ``dma_gather``/``dma_gather_idxdma``,
``scratch/probe_dma_bisect.py``, ``scratch/probe_hbm_and_gather.py``
``dyn_gather``), which all compute this one function.  ``idx`` is int32
``[M]``; ``table`` is ``[W, F]`` of any dtype (float32 and bfloat16 on the
SpMM path; the kernel moves bytes), and the result is ``[M, F]`` of the
table's dtype.  Every band gather of the banded SDDMM and of the GAT
layer's slot scores runs it (the banded SpMM's kernel reads its rows by
id and gathers no band).

The kernel moves 16-byte (or narrower) vectors by threads, with
streaming stores (see the source).

:func:`gather_rows` dispatches by device: a CPU tensor takes
:func:`gather_rows_plain` (``torch.index_select``); a CUDA tensor launches
the kernel or raises.  Indices must lie in ``[0, W)``: the plain version
raises on others, the kernel writes a zero row for them.
"""

from __future__ import annotations

import ctypes

import torch

from mini_tpu_torch.ops.kernels import _build, refuse_grad

_I32 = torch.int32

launches = 0  # kernel launches since the last reset (see chip_smoke.py)
_launch = None  # the bound C entry, set at the first launch


def _check(table, idx):
    if table.ndim != 2:
        raise ValueError(f"table must be [W, F], got {tuple(table.shape)}")
    if idx.ndim != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be 1-D int32, got {idx.dtype} "
                        f"{tuple(idx.shape)}")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``torch.index_select(table, 0, idx)``."""
    _check(table, idx)
    return torch.index_select(table, 0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[j] = table[idx[j]]`` (see module doc).  On CUDA tensors this
    launches ``csrc/gather_rows.cu``.  The per-call path of every band
    gather: only the checks that guard memory, each in its cheapest
    form."""
    if not table.is_cuda:
        if table.device.type == "cpu":
            return gather_rows_plain(table, idx)
        raise RuntimeError(f"no gather_rows kernel for {table.device}")
    if table.requires_grad and torch.is_grad_enabled():
        refuse_grad("gather_rows", table)
    dev = table.get_device()
    if (table.ndim != 2 or idx.dtype != _I32 or idx.ndim != 1
            or idx.get_device() != dev):
        _check(table, idx)
        raise ValueError(f"idx must lie on {table.device}")
    table = table.contiguous()
    idx = idx.contiguous()
    M = idx.shape[0]
    W, F = table.shape
    out = table.new_empty((M, F))
    if M and F:
        global _launch, launches
        if _launch is None:
            # (idx, table, out, M, W, row_bytes, stream) -> error
            _launch = _build.bind("gather_rows", "gather_rows_launch", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p])
        rc = _launch(idx.data_ptr(), table.data_ptr(), out.data_ptr(), M, W,
                     F * table.element_size(), _build.stream(dev))
        if rc:
            raise RuntimeError(f"gather_rows kernel launch failed: CUDA "
                               f"error {rc}")
        launches += 1
    return out
