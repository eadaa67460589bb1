"""Contiguous-segment min/max/sum/bor: the CUDA kernel
``csrc/segreduce.cu`` and its plain torch versions.

:func:`segment_reduce`: ``out[v] = op(vals[offsets[v]:offsets[v+1]])``;
empty segments get the identity.  ``vals`` is ``[m]``, or ``[m, H]``
row-major with H in 1..8, reduced column by column into ``[n, H]`` in the
same launch.  The argument list is that of the TPU twin
``mini_tpu.ops.pallas.segreduce_kernel.segment_reduce_pallas``, so a test
can feed both the same arrays; the CUDA kernel reduces by ``offsets`` and
reads of ``dsts`` only the segments of each chunk's first and last row
(ids that are not int32, one a row, are built from the offsets in the
call).  Any edge count is accepted.

:func:`segment_reduce_bands`: the same over K segment-sorted streams, each
with its own offsets over the same n segments, the streams combined in
order 0..K-1: ``out[v, h] = op_k op(vals[k][offsets[k][v]:offsets[k][v+1],
h])``, one launch for all bands and columns (GAT's per-head score
cotangent off the bands of a banded layout).

The kernel cuts each stream into chunks of :func:`chunk_rows` rows, one
warp a chunk, with carries for the segments that cross a chunk edge and a
fix-up launch that folds them (see ``csrc/segreduce.cu``).
:func:`segment_reduce_scheduled_plain` repeats that schedule in plain
torch, with its order of float32 additions.

Each public wrapper dispatches by device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mini_tpu_torch.ops.kernels import _build, refuse_grad
from mini_tpu_torch.ops.segment import identity_for

OPS = ("min", "max", "sum", "bor")
MAX_COLS = 8  # columns of [m, H] values the kernel reduces in one launch
_OP_CODE = {"min": 0, "max": 1, "sum": 2, "bor": 3}
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
launches = 0  # kernel launches since the last reset (see chip_smoke.py)
# the bound C entries (one stream, K streams) and the kernel's band limit,
# set at the first launch
_launch = _bands_launch = None
_max_bands = 0


def default_identity(op: str, dtype: torch.dtype):
    """The twin's ``_default_identity``: 0 for bor, else the reduction
    identity of ``op``."""
    return identity_for("sum" if op == "bor" else op, dtype)


def rows_per_lane(H: int) -> int:
    """Rows a lane of the kernel folds: 16 values for 1, 2, 4 or 8
    columns, else 4 rows (a whole number of 16-byte loads either way)."""
    return 16 // H if H & (H - 1) == 0 else 4


def chunk_rows(H: int) -> int:
    """Rows of one warp's chunk for ``[m, H]`` values."""
    return 32 * rows_per_lane(H)


def _check(offsets, vals, op):
    if op not in _OP_CODE:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"vals must be int32 or float32, got {vals.dtype}")
    if op == "bor" and vals.dtype != torch.int32:
        raise TypeError("bor reduces int32 values only")
    if vals.ndim not in (1, 2) or offsets.ndim != 1:
        raise ValueError("offsets must be 1-D and vals [m] or [m, H]")
    if vals.ndim == 2 and not 1 <= vals.shape[1] <= MAX_COLS:
        raise ValueError(f"vals has {vals.shape[1]} columns; the reduce "
                         f"takes 1 to {MAX_COLS}")


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
    reference for the kernel's float32 sum.  ``[m, H]`` values reduce
    column by column."""
    _check(offsets, vals, op)
    if vals.ndim == 2:
        return torch.stack([
            segment_reduce_plain(offsets, dsts, vals[:, h], op, identity)
            for h in range(vals.shape[1])], dim=-1)
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


def _segment_ids(offsets: torch.Tensor) -> torch.Tensor:
    """The segment of every row below ``offsets[-1]``."""
    n = offsets.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, device=offsets.device), torch.diff(offsets.long()))


def _check_bands(offsets, vals, op) -> None:
    if len(offsets) != len(vals) or not vals:
        raise ValueError(f"{len(offsets)} offset arrays for {len(vals)} "
                         "value streams")
    for o, v in zip(offsets, vals):
        _check(o, v, op)
        if (v.shape[1:] != vals[0].shape[1:] or v.dtype != vals[0].dtype
                or o.shape != offsets[0].shape):
            raise ValueError("streams must share one width, dtype and "
                             "segment count")


def segment_reduce_bands_plain(
    offsets: Sequence[torch.Tensor],
    vals: Sequence[torch.Tensor],
    op: str = "sum",
    identity=None,
) -> torch.Tensor:
    """Plain torch version of :func:`segment_reduce_bands`: per band a
    scatter-reduce by the segment ids its offsets give; min, max, bor and
    the int32 sum combine the bands' results as they are, the float32 sum
    adds every band in float64 and rounds once."""
    _check_bands(offsets, vals, op)
    dtype = vals[0].dtype
    if identity is None:
        identity = default_identity(op, dtype)
    wide = op == "sum" and dtype == torch.float32
    n = offsets[0].shape[0] - 1
    out = torch.full((n,) + tuple(vals[0].shape[1:]), identity,
                     dtype=torch.float64 if wide else dtype,
                     device=vals[0].device)
    for o, v in zip(offsets, vals):
        seg = _segment_ids(o)
        v = v[: seg.numel()]
        if wide:
            out.index_add_(0, seg, v.double())
        else:
            out = _FOLD[op](out, segment_reduce_plain(
                o, seg, v, op, _neutral(op, dtype)))
    return out.to(dtype)


_FOLD = {
    "min": torch.minimum,
    "max": torch.maximum,
    "sum": torch.add,  # int32 tensors wrap like the kernel's unsigned sum
    "bor": torch.bitwise_or,
}


def _neutral(op: str, dtype: torch.dtype):
    """The value that changes nothing under ``op`` (the kernel's
    ``neutral``)."""
    if op in ("sum", "bor"):
        return 0
    if dtype == torch.int32:
        return 2**31 - 1 if op == "min" else -2**31
    return float("inf") if op == "min" else -float("inf")


def segment_reduce_scheduled_plain(
    offsets: Sequence[torch.Tensor],
    vals: Sequence[torch.Tensor],
    op: str = "sum",
    identity=None,
) -> torch.Tensor:
    """The kernel's schedule in plain torch, for K streams (lists of one
    for :func:`segment_reduce`): the same result as ``csrc/segreduce.cu``
    bit for bit, for the CPU tests of its index arithmetic and for the
    card's check of the kernel's float32 sum.

    Stream k is cut into chunks of :func:`chunk_rows` rows, a chunk into 32
    lanes of :func:`rows_per_lane` rows.  A lane folds its rows in order,
    one run per segment.  Runs that begin and end inside a lane are whole
    segments.  The lanes' last runs go through a segmented scan over the
    lanes (steps 1, 2, 4, 8, 16: a lane takes the value ``d`` lanes below
    it when that lane's run is of the same segment); a lane's first run,
    when another follows it, closes its segment with the scanned value of
    the lane before.  A segment inside one chunk is then done; one that
    crosses a chunk edge leaves carries (side 0: it began before the chunk;
    side 1: it goes on past it), which the fix-up folds: the later chunks'
    side 0 strided over 32 lanes, each lane in order, a butterfly over the
    lanes, then added to side 1 of the first chunk.  The streams' values
    combine in order, and last the identity."""
    _check_bands(offsets, vals, op)
    one_column = vals[0].ndim == 1
    vals = [v[:, None] if one_column else v for v in vals]
    dtype, device = vals[0].dtype, vals[0].device
    H = vals[0].shape[1]
    E, C = rows_per_lane(H), chunk_rows(H)
    fold = _FOLD[op]
    zero = _neutral(op, dtype)
    if identity is None:
        identity = default_identity(op, dtype)
    n = offsets[0].shape[0] - 1
    lanes = torch.arange(32, device=device)

    def full(*shape):
        return torch.full(shape, zero, dtype=dtype, device=device)

    tot = full(n, H)
    for offs, v in zip(offsets, vals):
        offs = offs.long()
        total = min(int(offs[-1]), v.shape[0])
        n_chunks = -(-v.shape[0] // C)
        part = full(n, H)
        carry = full(max(n_chunks, 1), 2, H)
        if total:
            _walk(offs, v[:total], part, carry, fold, full, E, C)
        # the fix-up: a crossing segment's carries
        s, e = offs[:-1], offs[1:]
        b0 = s // C
        b1 = torch.where(e > s, (e - 1) // C, b0)
        rows = torch.nonzero(b1 > b0)[:, 0]
        if rows.numel():
            c0, c1 = b0[rows], b1[rows]
            acc = full(rows.numel(), 32, H)
            for step in range(-(-int((c1 - c0).max()) // 32)):
                b = c0[:, None] + 1 + lanes + 32 * step
                on = b <= c1[:, None]
                acc[on] = fold(acc[on], carry[b[on], 0])
            o = 16
            while o >= 1:
                acc = fold(acc, acc[:, lanes ^ o])
                o //= 2
            part[rows] = fold(carry[c0, 1], acc[:, 0])
        nonempty = (e > s)[:, None]
        tot = torch.where(nonempty, fold(tot, part), tot)
    out = fold(torch.full_like(tot, identity), tot)
    return out[:, 0] if one_column else out


def _walk(offs, v, part, carry, fold, full, E, C) -> None:
    """The walkers of one stream (see
    :func:`segment_reduce_scheduled_plain`): fills ``part`` (segments inside
    one chunk) and ``carry``."""
    device = v.device
    total, H = v.shape
    n = offs.shape[0] - 1
    p = torch.arange(total, device=device)
    seg = torch.searchsorted(offs[:n].contiguous(), p, right=True) - 1
    # a run: consecutive rows of one segment inside one lane
    new = torch.ones(total, dtype=torch.bool, device=device)
    new[1:] = (seg[1:] != seg[:-1]) | (p[1:] % E == 0)
    start = torch.nonzero(new)[:, 0]
    length = torch.diff(start, append=start.new_tensor([total]))
    acc = full(start.numel(), H)
    for i in range(E):  # a lane adds its rows in order
        on = length > i
        acc[on] = fold(acc[on], v[start[on] + i])
    run_seg = seg[start]
    slot = start // E  # the run's lane, counted over the whole stream
    first = torch.ones_like(new[: start.numel()])
    first[1:] = slot[1:] != slot[:-1]
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    chunk, lane = slot // 32, slot % 32
    n_chunks = carry.shape[0]

    def emit(sel, x):
        """Finished values ``x`` of the runs ``sel``: into ``part`` when
        the segment lies inside the chunk, else into the chunk's carry."""
        sg, ch = run_seg[sel], chunk[sel]
        began_before = offs[sg] < ch * C
        inside = ~began_before & (offs[sg + 1] <= torch.clamp(
            (ch + 1) * C, max=total))
        part[sg[inside]] = x[inside]
        out = ~inside
        carry[ch[out], (~began_before[out]).long()] = x[out]

    middle = ~first & ~last
    part[run_seg[middle]] = acc[middle]
    # the lanes' last runs, scanned over the lanes of their chunk
    key = torch.full((n_chunks, 32), -1, dtype=torch.long, device=device)
    val = full(n_chunks, 32, H)
    key[chunk[last], lane[last]] = run_seg[last]
    val[chunk[last], lane[last]] = acc[last]
    d = 1
    while d < 32:
        join = torch.zeros_like(key, dtype=torch.bool)
        join[:, d:] = (key[:, d:] == key[:, :-d]) & (key[:, d:] >= 0)
        up = torch.zeros_like(val)
        up[:, d:] = val[:, :-d]
        val = torch.where(join[:, :, None], fold(up, val), val)
        d *= 2
    # a lane's first run, when another follows, closes its segment
    head = first & ~last
    hc, hl = chunk[head], lane[head]
    below = torch.clamp(hl - 1, min=0)
    joined = (hl > 0) & (key[hc, below] == run_seg[head])
    emit(head, torch.where(joined[:, None], fold(val[hc, below], acc[head]),
                           acc[head]))
    # a last run whose segment does not go on into the next lane
    first_seg = torch.full((n_chunks, 33), -1, dtype=torch.long,
                           device=device)
    first_seg[chunk[first], lane[first]] = run_seg[first]
    lc, ll = chunk[last], lane[last]
    ends = first_seg[lc, ll + 1] != run_seg[last]
    sel = torch.nonzero(last)[:, 0][ends]
    emit(sel, val[lc[ends], ll[ends]])


def _bind_entries() -> None:
    global _launch, _bands_launch, _max_bands
    if _launch is None:
        P, I, V = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
        L, D = ctypes.c_longlong, ctypes.c_double
        # (offsets, dsts, vals, rows, n, H, dtype, op, ident_f, ident_i,
        #  out, carry, n_chunks, stream) -> error
        _launch = _build.bind("segreduce", "segreduce_launch", [
            V, V, V, L, I, I, I, I, D, L, V, V, I, V])
        # (offs_ptrs, seg_ptrs, val_ptrs, rows, K, n, H, dtype, op, ident_f,
        #  ident_i, out, part, carry, n_chunks, stream) -> error
        _bands_launch = _build.bind("segreduce", "segreduce_bands_launch", [
            ctypes.POINTER(P), ctypes.POINTER(P), ctypes.POINTER(P),
            ctypes.POINTER(L), I, I, I, I, I, D, L, V, V, V, I, V])
        _max_bands = _build.bind("segreduce", "segreduce_max_bands", [])()


def _aligned(vals: torch.Tensor) -> torch.Tensor:
    """``vals`` contiguous and 16-byte aligned, as the kernel's loads need
    it: a view into the middle of a storage is copied."""
    if not vals.is_contiguous():
        vals = vals.contiguous()
    return vals if vals.data_ptr() % 16 == 0 else vals.clone()


def _check_offsets(offsets, device) -> torch.Tensor:
    if offsets.device != device or offsets.dtype != torch.int32:
        raise TypeError("offsets must be int32 on the values' device")
    return offsets if offsets.is_contiguous() else offsets.contiguous()


def _row_segments(seg, offsets, rows: int) -> torch.Tensor:
    """The segment of each of a stream's ``rows`` rows as the kernel reads
    it: ``seg`` where it is that (int32, one id a row, on the offsets'
    device), else built from the offsets here, with no host sync (rows past
    the last segment end take the last segment)."""
    if (seg is not None and seg.dtype == torch.int32 and seg.ndim == 1
            and seg.device == offsets.device and seg.shape[0] >= rows):
        return seg if seg.is_contiguous() else seg.contiguous()
    at = torch.arange(rows, dtype=torch.int32, device=offsets.device)
    return (torch.searchsorted(offsets[:-1], at, right=True) - 1).to(
        torch.int32)


def _launch_bands(offsets, vals, op, identity, seg=None) -> torch.Tensor:
    """Launch the kernel on K CUDA streams ``vals[k]`` of ``[m_k, H]`` (see
    module doc): the walkers and the fix-up, one launch counted; returns
    ``[n, H]``."""
    device = vals[0].device
    refuse_grad("segment_reduce_bands", *vals)
    _check_bands(offsets, vals, op)
    if any(v.device != device for v in vals):
        raise ValueError(f"all inputs must lie on {device}")
    offsets = [_check_offsets(o, device) for o in offsets]
    vals = [_aligned(v) for v in vals]
    dtype = vals[0].dtype
    if identity is None:
        identity = default_identity(op, dtype)
    K, H = len(vals), vals[0].shape[1]
    n = offsets[0].shape[0] - 1
    _bind_entries()
    if K > _max_bands:
        raise ValueError(f"{K} bands exceed the kernel's {_max_bands}")
    rows = [int(v.shape[0]) for v in vals]
    if seg is not None and len(seg) != K:
        raise ValueError(f"{len(seg)} row-segment arrays for {K} streams")
    seg = [_row_segments(s, o, r)
           for s, o, r in zip(seg or [None] * K, offsets, rows)]
    C = chunk_rows(H)
    n_chunks = sum(-(-r // C) for r in rows)
    out = torch.empty(n, H, dtype=dtype, device=device)
    part = torch.empty(K, n, H, dtype=dtype, device=device)
    carry = torch.empty(max(n_chunks, 1) * 2 * H, dtype=dtype, device=device)
    rc = _bands_launch(
        (ctypes.c_void_p * K)(*[o.data_ptr() for o in offsets]),
        (ctypes.c_void_p * K)(*[s.data_ptr() for s in seg]),
        (ctypes.c_void_p * K)(*[v.data_ptr() for v in vals]),
        (ctypes.c_longlong * K)(*rows), K, n, H, _DTYPE_CODE[dtype],
        _OP_CODE[op], float(identity),
        int(identity) if dtype == torch.int32 else 0,
        out.data_ptr(), part.data_ptr(), carry.data_ptr(), n_chunks,
        _build.stream(device.index),
    )
    if rc != 0:
        raise RuntimeError(f"segreduce kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def _on_card(vals, name: str) -> bool:
    if vals.is_cuda:
        return True
    if vals.device.type != "cpu":
        raise RuntimeError(f"no {name} kernel for {vals.device}")
    return False


def segment_reduce(
    offsets: torch.Tensor,
    dsts: torch.Tensor,
    vals: torch.Tensor,
    op: str,
    identity=None,
) -> torch.Tensor:
    """out[v] = op(vals[offsets[v]:offsets[v+1]]) for contiguous sorted
    segments, ``op`` in min/max/sum/bor, int32 or float32 values ``[m]``
    or ``[m, H]`` (H columns reduced in one launch into ``[n, H]``).  On a
    CUDA tensor this launches ``csrc/segreduce.cu``."""
    if not _on_card(vals, "segment_reduce"):
        return segment_reduce_plain(offsets, dsts, vals, op, identity)
    refuse_grad("segment_reduce", vals)
    _check(offsets, vals, op)
    offsets = _check_offsets(offsets, vals.device)
    vals = _aligned(vals)
    dtype = vals.dtype
    if identity is None:
        identity = default_identity(op, dtype)
    rows = vals.shape[0]
    n = offsets.shape[0] - 1
    H = 1 if vals.ndim == 1 else vals.shape[1]
    n_chunks = -(-rows // chunk_rows(H))
    out = vals.new_empty((n,) if vals.ndim == 1 else (n, H))
    carry = vals.new_empty(max(n_chunks, 1) * 2 * H)
    dsts = _row_segments(dsts, offsets, rows)
    _bind_entries()
    rc = _launch(
        offsets.data_ptr(), dsts.data_ptr(), vals.data_ptr(), rows, n, H,
        _DTYPE_CODE[dtype],
        _OP_CODE[op], float(identity),
        int(identity) if dtype == torch.int32 else 0, out.data_ptr(),
        carry.data_ptr(), n_chunks, _build.stream(vals.get_device()),
    )
    if rc != 0:
        raise RuntimeError(f"segreduce kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def segment_reduce_bands(
    offsets: Sequence[torch.Tensor],
    vals: Sequence[torch.Tensor],
    op: str = "sum",
    identity=None,
    seg: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """K segment-sorted ``[m_k, H]`` streams, each with its own int32
    ``[n + 1]`` offsets over the same n segments, reduced per segment and
    combined in band order into ``[n, H]``; rows at or past
    ``offsets[k][-1]`` belong to no segment.  On CUDA tensors this is one
    launch of ``csrc/segreduce.cu`` for all bands and columns, which reads
    each chunk's first and last segment from ``seg``: K int32 ``[m_k]``
    tensors, the segment of every row as the offsets give it
    (``BandedLayout.dev()["seg"]``; built from the offsets in the call
    when None)."""
    offsets, vals = list(offsets), list(vals)
    if not vals or vals[0].ndim != 2:
        raise ValueError("vals must be K [m_k, H] streams")
    if not _on_card(vals[0], "segment_reduce_bands"):
        return segment_reduce_bands_plain(offsets, vals, op, identity)
    return _launch_bands(offsets, vals, op, identity, seg)
