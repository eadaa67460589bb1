"""Contiguous-segment sum of feature rows (the round-1 SpMM core) and the
``spmm_pallas`` route built on it.

``out[v] = sum(msgs[offsets[v] : offsets[v+1]])`` with the argument list
of the TPU twin ``mini_tpu.ops.pallas.spmm_kernel.segment_sum_pallas``:
``offsets`` int32 ``[n_pad+1]``, ``dsts`` int32 ``[m_pad]`` (the sorted
segment ids; taken for parity and not read) and ``msgs`` ``[m_pad, F]``,
float32 or bfloat16, with ``n_pad % 128 == 0`` and ``m_pad % 128 == 0``;
the result is float32 ``[n_pad, F]``.

On Hopper this is the banded segment sum with one band: ``bounds =
offsets[::128]``, ``offs2d = offsets[:-1]`` cut into 128-row tiles, and
its schedule is ``offsets - offsets[0]``.  So a CUDA tensor launches
``csrc/spmm_banded.cu``'s segment-sum kernel with K = 1 (no second
source); a CPU tensor takes the plain version.  Unlike
the twin, any F is taken.
"""

from __future__ import annotations

from typing import Optional

import torch

from mini_tpu_torch.graph.banded import ROW_TILE
from mini_tpu_torch.ops.kernels import spmm_banded

EDGE_CHUNK = 128  # the twin's m_pad multiple

launches = 0  # kernel launches since the last reset (see chip_smoke.py)


def _one_band(offsets: torch.Tensor):
    """The segment offsets as a one-band layout: (bounds, offs2d)."""
    n_pad = offsets.shape[0] - 1
    if offsets.ndim != 1 or n_pad % ROW_TILE:
        raise ValueError(f"offsets must be [n_pad+1] with n_pad a multiple "
                         f"of {ROW_TILE}, got {tuple(offsets.shape)}")
    bounds = offsets[::ROW_TILE].reshape(1, -1)
    offs2d = offsets[:-1].reshape(n_pad // ROW_TILE, 1, ROW_TILE)
    return bounds, offs2d


def segment_sum_plain(
    offsets: torch.Tensor, dsts: torch.Tensor, msgs: torch.Tensor
) -> torch.Tensor:
    """Plain torch version: the one-band ``banded_segment_sum_plain``
    (float64 accumulation, rounded once)."""
    bounds, offs2d = _one_band(offsets)
    return spmm_banded.banded_segment_sum_plain(
        bounds, offs2d, [msgs], edge_chunk=EDGE_CHUNK)


def segment_sum(
    offsets: torch.Tensor, dsts: torch.Tensor, msgs: torch.Tensor
) -> torch.Tensor:
    """``out[v] = sum(msgs[offsets[v]:offsets[v+1]])`` in float32 (see
    module doc).  On a CUDA tensor this launches the one-band segment
    sum of ``csrc/spmm_banded.cu``."""
    if not msgs.is_cuda:
        if msgs.device.type == "cpu":
            return segment_sum_plain(offsets, dsts, msgs)
        raise RuntimeError(f"no segment_sum kernel for {msgs.device}")
    bounds, offs2d = _one_band(offsets)
    # with one band the schedule's row prefix is the offsets from 0
    out = spmm_banded.segment_sum_cuda("segment_sum", bounds, offs2d, [msgs],
                                       edge_chunk=EDGE_CHUNK,
                                       row_prefix=offsets - offsets[:1])
    global launches
    launches += 1
    return out


def spmm_pallas(
    offsets: torch.Tensor,
    gather_ids: torch.Tensor,
    w: torch.Tensor,
    x: torch.Tensor,
    seg_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pull SpMM as the twin's ``spmm_pallas`` computes it: gather the
    weighted messages ``x[gather_ids] * w`` in torch, then
    :func:`segment_sum`.  Pass bfloat16 ``x`` for half the message
    bytes; the sum stays float32.  ``seg_ids`` is the twin's and unused."""
    msgs = torch.index_select(x, 0, gather_ids) * w[:, None].to(x.dtype)
    if msgs.dtype not in (torch.float32, torch.bfloat16):
        msgs = msgs.to(torch.float32)
    return segment_sum(offsets, seg_ids, msgs)
