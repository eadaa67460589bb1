"""Banded segment sum (the SpMM core) and banded SDDMM (its weight
gradient): the CUDA kernels of ``csrc/spmm_banded.cu`` and their plain
torch versions.

``banded_segment_sum``:
``out[v] = sum_k sum_j w[k][j] msgs[k][j]`` over the slots ``j`` in
``[offs2d[t,k,r], next)`` for ``v = 128 t + r``, where ``next`` is
``offs2d[t,k,r+1]``, or ``bounds[k,t+1]`` for ``r = 127``.  The weights
are optional (``weights=None``: ``w = 1``, nothing multiplied): K
per-slot tensors ``[mk_pad]``, or ``[mk_pad, H]`` whose column ``h``
scales columns ``[h F/H, (h+1) F/H)`` (GAT's heads).  A weighted message
is ``fl(m * w)``, the product in float32 rounded to the messages' dtype
with ``w`` first cast to it, the bits of ``ops.spmm._weigh``; the kernel
forms it in registers and never writes it.  The messages come as K
gathered streams (the stream form), or, with ``ids`` and ``band_rows``,
as a table: ``msgs`` is then the source rows ``x`` (``[n_src, F]``) and
``msgs[k][j] = x[k band_rows + ids[k][j]]`` for the K band-local int32 id
streams ``ids[k]`` (``[mk_pad]``, ``BandedLayout.dev()["ids"]``), which
the kernel reads in place of a gathered copy (the indexed form).  Both
forms give the same bits.  The K pointers travel in the kernel's
parameters: the stream form takes up to 128 bands, the indexed form up to
1,024, as a graph of ogbn-products' size needs at 256 float32 columns
(150 bands; launches past 128 are counted in ``wide_launches``).

``banded_sddmm``: ``dw[base_k + j] = <y[v], msgs[k][j]>`` for every slot
``j`` of band ``k`` in row ``v``'s segment; the flat float32 result has
one entry per stream slot, and slots at or past ``bounds[k, -1]`` are 0.
With ``heads=H`` it is ``[total, H]``, head ``h`` the dot over columns
``[h F/H, (h+1) F/H)`` (GAT's per-head weight cotangent).

Inputs are those of the TPU twins ``banded_segment_sum`` and
``banded_sddmm`` of ``mini_tpu.ops.pallas.spmm_banded``: ``bounds``
int32 ``[K, n_tiles+1]``, ``offs2d`` int32 ``[n_tiles, K, 128]`` and K
streams ``msgs[k]`` of shape ``[mk_pad, F]``, float32 or bfloat16 (and for
the SDDMM ``y`` ``[n_tiles*128, F]``, float32 or bfloat16).  Both
accumulate in float32.

``precision``: ``"split"`` and ``"highest"`` both mean an exact float32
accumulate of the inputs as given; ``"fast"`` first rounds float32
messages (and the SDDMM's ``y``) to bfloat16, as the twins' fast paths do.

The segment-sum kernel walks the slots in a row-major virtual order cut
into equal chunks (:func:`kernel_plan`), with per-chunk carries for
the rows that cross a chunk edge and a fix-up launch that adds them (see
``csrc/spmm_banded.cu``).  Its schedule is the row prefix of that order
(``graph.banded.row_prefix``), cached by ``BandedLayout.dev()`` as
``row_prefix``; without it the wrapper builds it on the device in the
call.  :func:`banded_segment_sum_scheduled_plain` repeats the kernel's
schedule in plain torch, with its order of float32 additions.

Each public wrapper dispatches by device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from mini_tpu_torch.graph.banded import EDGE_CHUNK, ROW_TILE
from mini_tpu_torch.graph.banded import row_prefix as _row_prefix
from mini_tpu_torch.ops.kernels import _build, refuse_grad

PRECISIONS = ("split", "highest", "fast")
MIN_CHUNK = 128  # fewest slots of the virtual order per walker
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# kernel launches since the last reset (see chip_smoke.py), per wrapper
launches = 0  # banded_segment_sum
weighted_launches = 0  # those of them that scaled by weights
indexed_launches = 0  # those of them that read rows of a table by ids
wide_launches = 0  # those of them past the stream form's bands (128)
scanned_launches = 0  # those whose walker scans a row's bands G at a time
bipartite_launches = 0  # indexed ones whose table's rows are not the output's
sddmm_launches = 0  # banded_sddmm
# the bound C entries and the kernel's band limits, set at the first
# launch: the stream form's and the SDDMM's, and the indexed form's
_sum_launch = _sddmm_launch = None
_max_bands = _max_indexed_bands = 0


def _check_layout(bounds, offs2d, K, what, precision) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if K == 0 or bounds.shape[0] != K or offs2d.shape[1] != K:
        raise ValueError(
            f"{K} {what} for bounds {tuple(bounds.shape)} and offs2d "
            f"{tuple(offs2d.shape)}"
        )
    if offs2d.shape[0] != bounds.shape[1] - 1 or offs2d.shape[2] != ROW_TILE:
        raise ValueError(f"offs2d must be [n_tiles, K, {ROW_TILE}]")


def _prepare(bounds, offs2d, msgs, precision, edge_chunk) -> list:
    """Check shapes and types; apply ``precision``; return the streams."""
    msgs = list(msgs)
    _check_layout(bounds, offs2d, len(msgs), "streams", precision)
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


def _prepare_table(bounds, offs2d, x, ids, band_rows, precision,
                   edge_chunk) -> tuple:
    """The indexed form's :func:`_prepare`: check the table, the id
    streams and ``band_rows`` against the layout; apply ``precision`` to
    the table; return the table and the id streams."""
    ids = list(ids)
    K = len(ids)
    _check_layout(bounds, offs2d, K, "id streams", precision)
    if x.ndim != 2:
        raise ValueError(f"the table must be [n_src, F], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the table must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if band_rows is None or band_rows < 1 or (K - 1) * band_rows >= len(x):
        raise ValueError(f"band_rows={band_rows} does not cut the table's "
                         f"{len(x)} rows into {K} bands")
    for i in ids:
        if i.ndim != 1 or i.dtype != torch.int32:
            raise ValueError("ids must be K int32 [mk_pad] tensors")
        if i.shape[0] % edge_chunk:
            raise ValueError(
                f"stream length {i.shape[0]} is not a multiple of "
                f"edge_chunk={edge_chunk}"
            )
    if precision == "fast" and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    return x, ids


def _gathered(x, ids, band_rows) -> list:
    """The K streams the indexed form reads: row ``k band_rows +
    ids[k][j]`` of the table as slot ``j`` of band ``k``."""
    return [x[k * band_rows + i.long()] for k, i in enumerate(ids)]


def _streams(bounds, offs2d, msgs, precision, edge_chunk, ids,
             band_rows) -> tuple:
    """The prepared message streams of either form (the indexed form's
    gathered in plain torch, for the plain versions), and whether the
    kernel reads what it is given by 16-byte vectors (:func:`_vector_ok`
    of the streams, or of the table)."""
    if ids is None:
        msgs = _prepare(bounds, offs2d, msgs, precision, edge_chunk)
        return msgs, _vector_ok(msgs)
    x, ids = _prepare_table(bounds, offs2d, msgs, ids, band_rows, precision,
                            edge_chunk)
    return _gathered(x, ids, band_rows), _vector_ok([x])


def _prepare_weights(F, lengths, dtype, weights) -> tuple:
    """Check the per-slot weights against F columns and the streams'
    ``lengths``; return them cast to the messages' ``dtype``, and the head
    count (1 without weights)."""
    if weights is None:
        return None, 1
    weights = list(weights)
    ndim = weights[0].ndim if weights else 0
    heads = weights[0].shape[1] if ndim == 2 else 1
    if (len(weights) != len(lengths) or ndim not in (1, 2) or heads < 1
            or F % heads):
        raise ValueError(f"weights must be {len(lengths)} tensors [mk_pad] "
                         f"or [mk_pad, H], H dividing F={F}")
    for w, n in zip(weights, lengths):
        if w.shape != (n, heads)[:ndim] or not w.is_floating_point():
            raise ValueError(f"weights {tuple(w.shape)} for a stream of "
                             f"{n} slots and {heads} heads")
    return [w.to(dtype) for w in weights], heads


def _stream_weights(msgs, weights) -> tuple:
    """:func:`_prepare_weights` against prepared streams."""
    return _prepare_weights(msgs[0].shape[1], [m.shape[0] for m in msgs],
                            msgs[0].dtype, weights)


def _weighted(m, w, heads) -> torch.Tensor:
    """``m`` times its slots' weights as the kernel forms them: the product
    in float32, rounded to ``m``'s dtype (``w`` already of that dtype)."""
    n, F = m.shape
    prod = (m.float().reshape(n, heads, F // heads)
            * w.float().reshape(n, heads, 1))
    return prod.reshape(n, F).to(m.dtype)


def _prepare_y(offs2d, msgs, y, precision, heads=1) -> torch.Tensor:
    """Check the SDDMM's dense side against the layout and the head count;
    apply ``precision``."""
    shape = (offs2d.shape[0] * ROW_TILE, msgs[0].shape[1])
    if tuple(y.shape) != shape:
        raise ValueError(f"y is {tuple(y.shape)}, the layout needs {shape}")
    if heads < 1 or shape[1] % heads:
        raise ValueError(f"{heads} heads do not divide F={shape[1]}")
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    if precision == "fast" and y.dtype == torch.float32:
        y = y.to(torch.bfloat16)
    return y


def _segment_ids(bounds, offs2d, k) -> torch.Tensor:
    """Row of every real slot of band ``k``'s stream (the stream starts at
    0): the staircase ``offs2d[:, k, :]`` expanded by segment length."""
    starts = offs2d[:, k, :].reshape(-1).long()
    ends = torch.cat([starts[1:], bounds[k, -1:].long()])
    rows = torch.arange(starts.shape[0], device=starts.device)
    return torch.repeat_interleave(rows, ends - starts)


def _on_card(msgs, name: str) -> bool:
    """True for CUDA streams (a kernel launch), False for CPU ones (the
    plain version); raises for other devices."""
    if msgs[0].is_cuda:
        return True
    if msgs[0].device.type != "cpu":
        raise RuntimeError(f"no {name} kernel for {msgs[0].device}")
    return False


def _check_cuda(bounds, offs2d, tensors, device) -> None:
    for a in (bounds, offs2d):
        if a.device != device or a.dtype != torch.int32:
            raise TypeError("bounds and offs2d must be int32 on the "
                            "messages' device")
    for a in tensors:
        if a.device != device:
            raise ValueError(f"all inputs must lie on {device}")


def _bind(K: int, indexed: bool = False) -> None:
    """Bind the library's entries at the first launch; check K against the
    kernel's limit: the stream form's and the SDDMM's, or the indexed
    form's (``indexed``)."""
    global _sum_launch, _sddmm_launch, _max_bands, _max_indexed_bands
    if _sum_launch is None:
        P, I, V = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
        # (msg_ptrs, K, bounds, offs2d, prefix, out, carry, n_tiles, F,
        #  dtype, vector, lanes, chunk, n_walkers, fix_lanes, wt_ptrs,
        #  heads, table, band_rows, stream)
        _sum_launch = _build.bind(
            "spmm_banded", "banded_segment_sum_launch",
            [ctypes.POINTER(P), I, V, V, V, V, V, I, I, I, I, I, I, I, I,
             ctypes.POINTER(P), I, V, I, V])
        # (msg_ptrs, seg_ptrs, lens, K, bounds, y, out, n_tiles, F, H,
        #  msg_dtype, y_dtype, lanes, head_lanes, stream)
        _sddmm_launch = _build.bind(
            "spmm_banded", "banded_sddmm_launch",
            [ctypes.POINTER(P), ctypes.POINTER(P),
             ctypes.POINTER(ctypes.c_longlong), I, V, V, V, I, I, I, I, I, I,
             I, V])
        _max_bands = _build.bind("spmm_banded", "banded_max_bands", [])()
        _max_indexed_bands = _build.bind("spmm_banded",
                                         "banded_max_indexed_bands", [])()
    limit = max(_max_bands, _max_indexed_bands) if indexed else _max_bands
    if K > limit:
        form = "indexed form" if indexed else "stream form and SDDMM"
        raise ValueError(f"{K} bands exceed the kernel's {limit} "
                         f"({form})")


def banded_segment_sum_plain(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
    weights: Optional[Sequence[torch.Tensor]] = None,
    ids: Optional[Sequence[torch.Tensor]] = None,
    band_rows: Optional[int] = None,
) -> torch.Tensor:
    """Plain torch version: per band, an ``index_add_`` of the stream's
    (weighted) messages into their segments' rows, accumulated in float64
    and rounded once, so it is a deterministic reference for the kernel.
    With ``ids`` ``msgs`` is the table, its streams gathered here."""
    msgs, _ = _streams(bounds, offs2d, msgs, precision, edge_chunk, ids,
                       band_rows)
    weights, heads = _stream_weights(msgs, weights)
    n_pad = offs2d.shape[0] * ROW_TILE
    out = torch.zeros(n_pad, msgs[0].shape[1], dtype=torch.float64,
                      device=msgs[0].device)
    for k, m in enumerate(msgs):
        seg = _segment_ids(bounds, offs2d, k)
        m = m[: seg.numel()]
        if weights is not None:
            m = _weighted(m, weights[k][: seg.numel()], heads)
        out.index_add_(0, seg, m.double())
    return out.to(torch.float32)


def _vector_ok(msgs) -> bool:
    """The kernel's 16-byte loads: every row a whole number of 16-byte
    vectors and every stream 16-byte aligned."""
    return (msgs[0].shape[1] * msgs[0].element_size()) % 16 == 0 and all(
        m.data_ptr() % 16 == 0 for m in msgs)


def _lanes(F: int, per_lane: int) -> int:
    """The fewest lanes, a power of two up to a warp's 32, that cover F
    columns at ``per_lane`` columns a lane."""
    lanes = 1
    while lanes < 32 and lanes * per_lane < F:
        lanes *= 2
    return lanes


def kernel_plan(F: int, element_size: int, vector: bool) -> tuple:
    """``(lanes, chunk, fix_lanes)`` of the segment-sum kernel for rows of
    F elements.  A walker's lanes cover F in 16-byte vectors (single
    elements off the vector path); its chunk is ``16 lanes`` slots, at
    least ``MIN_CHUNK``, enough walkers to fill the card whatever F.  The
    fix-up's lanes cover F in float32 vectors of 4 (or 1), and its warp's
    ``32 / fix_lanes`` lane groups split a long row's carries.  The chunk
    and the fix-up's lanes fix the order of additions; weights never
    change them (see :func:`segment_sum_cuda`)."""
    lanes = _lanes(F, 16 // element_size if vector else 1)
    return lanes, max(MIN_CHUNK, 16 * lanes), _lanes(F, 4 if vector else 1)


def banded_segment_sum_scheduled_plain(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
    row_prefix: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
    weights: Optional[Sequence[torch.Tensor]] = None,
    ids: Optional[Sequence[torch.Tensor]] = None,
    band_rows: Optional[int] = None,
) -> torch.Tensor:
    """The segment-sum kernel's schedule in plain torch: the same result as
    ``csrc/spmm_banded.cu`` bit for bit, for the CPU tests of the partition
    and for the card's check of the kernel.  With ``weights`` each slot's
    message is first weighted as the kernel weighs it (module doc).  With
    ``ids`` ``msgs`` is the table (the indexed form), whose rows the
    schedule reads by id in the same order.

    Every real slot gets its place in the virtual order (row by row, band
    0 to K-1 in a row); chunk ``b`` holds places ``[b chunk, (b+1)
    chunk)``.  A slot adds into its row when the row lies inside one chunk,
    else into carry ``(b, 0)`` (its row began in an earlier chunk) or ``(b,
    1)`` (it goes on past the chunk).  Each of these sums is taken in
    float32 in the virtual order, as a walker adds.  The fix-up splits a
    crossing row's later carries into ``groups`` consecutive runs (the
    fix-up warp's lane groups), sums each run in chunk order, and adds the
    runs' sums in order to side 1 of the row's first chunk.  Rows with no
    slot are 0.  ``chunk`` defaults to the kernel's (:func:`kernel_plan`).
    """
    msgs, vector = _streams(bounds, offs2d, msgs, precision, edge_chunk,
                            ids, band_rows)
    weights, heads = _stream_weights(msgs, weights)
    _, kernel_chunk, fix_lanes = kernel_plan(
        msgs[0].shape[1], msgs[0].element_size(), vector)
    chunk = kernel_chunk if chunk is None else chunk
    groups = 32 // fix_lanes
    device = msgs[0].device
    K, F = len(msgs), msgs[0].shape[1]
    n_rows = offs2d.shape[0] * ROW_TILE
    prefix = (_row_prefix(bounds, offs2d) if row_prefix is None
              else row_prefix).long()
    total = int(prefix[-1])
    out = torch.zeros(n_rows, F, dtype=torch.float32, device=device)
    if total == 0:
        return out
    # per (row, band): segment start, and the slots of the row's earlier
    # bands
    starts = offs2d.long().permute(0, 2, 1).reshape(n_rows, K)
    ends = torch.cat([offs2d.long()[:, :, 1:],
                      bounds.t()[1:, :, None].long()], dim=2)
    lens = ends.permute(0, 2, 1).reshape(n_rows, K) - starts
    before = torch.cumsum(lens, 1) - lens
    place, rows, vals = [], [], []
    for k, m in enumerate(msgs):
        seg = _segment_ids(bounds, offs2d, k)
        j = torch.arange(seg.numel(), device=device)
        place.append(prefix[seg] + before[seg, k] + j - starts[seg, k])
        rows.append(seg)
        vals.append(m[: seg.numel()] if weights is None else _weighted(
            m[: seg.numel()], weights[k][: seg.numel()], heads))
    order = torch.empty(total, dtype=torch.long, device=device)
    order[torch.cat(place)] = torch.arange(total, device=device)
    rows = torch.cat(rows)[order]
    vals = torch.cat(vals)[order].float()

    # each place's sum: its row, or a carry (n_rows + 2 b + side)
    b = torch.arange(total, device=device) // chunk
    p0, p1 = prefix[rows], prefix[rows + 1]
    inside = p0 // chunk == (p1 - 1) // chunk
    dest = torch.where(inside, rows, n_rows + 2 * b + (p0 >= b * chunk))
    # a sum's places are consecutive: run r adds vals[run_start[r]:...] in
    # order, step i adding the i-th place of every run longer than i
    new = torch.ones(total, dtype=torch.bool, device=device)
    new[1:] = dest[1:] != dest[:-1]
    run_start = torch.nonzero(new)[:, 0]
    run_len = torch.diff(run_start, append=run_start.new_tensor([total]))
    by_len = torch.argsort(run_len, descending=True, stable=True)
    run_start, run_len = run_start[by_len], run_len[by_len]
    n_longer = _count_longer(run_len)
    acc = torch.zeros(run_start.shape[0], F, dtype=torch.float32,
                      device=device)
    for i, n in enumerate(n_longer):
        acc[:n] += vals[run_start[:n] + i]
    n_chunks = -(-total // chunk)
    sums = torch.zeros(n_rows + 2 * n_chunks, F, dtype=torch.float32,
                       device=device)
    sums[dest[run_start]] = acc
    out = sums[:n_rows]
    carry = sums[n_rows:].reshape(n_chunks, 2, F)

    # the fix-up: side 0 of the later chunks in `groups` runs, each summed
    # in order, then added in order to side 1 of the row's first chunk
    p0, p1 = prefix[:-1], prefix[1:]
    b0 = p0 // chunk
    span = torch.where(p1 > p0, (p1 - 1) // chunk - b0, 0)
    crossing = torch.nonzero(span > 0)[:, 0]
    if crossing.numel():
        cb0, cspan = b0[crossing], span[crossing]
        per = (cspan + groups - 1) // groups
        fix = carry[cb0, 1].clone()
        for g in range(groups):
            lo = cb0 + 1 + g * per
            n = torch.clamp(torch.minimum(per, cb0 + cspan + 1 - lo), min=0)
            part = torch.zeros_like(fix)
            for step in range(int(n.max())):
                on = n > step
                part[on] += carry[lo[on] + step, 0]
            fix += part
        out[crossing] = fix
    return out


def _count_longer(lengths: torch.Tensor) -> list:
    """For non-increasing ``lengths``: at step i, how many are > i."""
    desc = lengths.cpu().numpy()
    steps = np.arange(int(desc[0]))
    return np.searchsorted(-desc, -steps, side="left").tolist()


def segment_sum_cuda(
    name: str,
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
    row_prefix: Optional[torch.Tensor] = None,
    weights: Optional[Sequence[torch.Tensor]] = None,
    ids: Optional[Sequence[torch.Tensor]] = None,
    band_rows: Optional[int] = None,
) -> torch.Tensor:
    """Launch the segment-sum kernel on CUDA tensors (see module doc):
    the walkers and the fix-up.  ``row_prefix`` is the cached schedule;
    without it this call builds it on the device.  ``weights``: the
    optional per-slot weights, cast here to the messages' dtype.  With
    ``ids``, ``msgs`` is the table that the indexed form reads by them.
    ``name`` is the calling wrapper's, for errors; the caller counts the
    launch."""
    if ids is None:
        refuse_grad(name, *msgs, *(weights or ()))
        srcs = [m.contiguous() for m in _prepare(bounds, offs2d, msgs,
                                                 precision, edge_chunk)]
        table, reads = None, srcs
    else:
        refuse_grad(name, msgs, *(weights or ()))
        table, srcs = _prepare_table(bounds, offs2d, msgs, ids, band_rows,
                                     precision, edge_chunk)
        table = table.contiguous()
        srcs = [i.contiguous() for i in srcs]
        reads = [table]
    device = reads[0].device
    F, dtype = reads[0].shape[1], reads[0].dtype
    lengths = [int(m.shape[0]) for m in srcs]
    weights, heads = _prepare_weights(F, lengths, dtype, weights)
    if weights is not None:
        weights = [w.contiguous() for w in weights]
    _check_cuda(bounds, offs2d, [*srcs, *reads, *(weights or ())], device)
    bounds = bounds.contiguous()
    offs2d = offs2d.contiguous()
    n_tiles = offs2d.shape[0]
    if row_prefix is None:
        row_prefix = _row_prefix(bounds, offs2d)
    if (row_prefix.device != device or row_prefix.dtype != torch.int32
            or tuple(row_prefix.shape) != (n_tiles * ROW_TILE + 1,)):
        raise ValueError(f"row_prefix must be int32 [{n_tiles * ROW_TILE + 1}]"
                         f" on {device}")
    row_prefix = row_prefix.contiguous()
    K = len(srcs)
    _bind(K, indexed=table is not None)
    elem = reads[0].element_size()
    vector = _vector_ok(reads)
    lanes, chunk, fix_lanes = kernel_plan(F, elem, vector)
    if vector and (F // heads) % (16 // elem):
        # a head's columns end inside a lane's 16-byte vector: the scalar
        # form, one weight an element, on the same chunks and fix-up
        # groups, so the same order of additions as without weights
        vector, lanes = False, kernel_plan(F, elem, False)[0]
    n_walkers = -(-sum(lengths) // chunk)
    out = torch.empty(n_tiles * ROW_TILE, F, dtype=torch.float32,
                      device=device)
    carry = torch.empty(n_walkers * 2 * F, dtype=torch.float32,
                        device=device)
    ptrs = (ctypes.c_void_p * K)(*[m.data_ptr() for m in srcs])
    wt_ptrs = None if weights is None else (ctypes.c_void_p * K)(
        *[w.data_ptr() for w in weights])
    rc = _sum_launch(
        ptrs, K, bounds.data_ptr(), offs2d.data_ptr(), row_prefix.data_ptr(),
        out.data_ptr(), carry.data_ptr(), n_tiles, F, _DTYPE_CODE[dtype],
        int(vector), lanes, chunk, n_walkers, fix_lanes, wt_ptrs, heads,
        None if table is None else table.data_ptr(),
        0 if table is None else band_rows, _build.stream(device.index),
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def banded_segment_sum(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
    row_prefix: Optional[torch.Tensor] = None,
    weights: Optional[Sequence[torch.Tensor]] = None,
    ids: Optional[Sequence[torch.Tensor]] = None,
    band_rows: Optional[int] = None,
) -> torch.Tensor:
    """Sum K segment-sorted message streams, each message scaled by its
    slot's weight where ``weights`` are given, into float32
    ``[n_tiles*128, F]`` rows (see module doc).  ``msgs``: the K streams;
    or, where ``ids`` (the layout's K id streams) are given, the table
    ``x`` whose row ``k band_rows + ids[k][j]`` is slot ``j`` of band
    ``k`` (the indexed form: no stream is gathered).  On CUDA tensors this
    launches ``csrc/spmm_banded.cu`` with ``row_prefix`` as its schedule
    (``BandedLayout.dev()["row_prefix"]``; built in the call when None);
    on CPU tensors it is the plain version, which needs no schedule."""
    if not _on_card([msgs] if ids is not None else msgs,
                    "banded_segment_sum"):
        return banded_segment_sum_plain(bounds, offs2d, msgs, precision,
                                        edge_chunk, weights, ids, band_rows)
    out = segment_sum_cuda("banded_segment_sum", bounds, offs2d, msgs,
                           precision, edge_chunk, row_prefix, weights, ids,
                           band_rows)
    global launches, weighted_launches, indexed_launches, wide_launches
    global scanned_launches, bipartite_launches
    launches += 1
    weighted_launches += weights is not None
    indexed_launches += ids is not None
    wide_launches += len(ids if ids is not None else msgs) > _max_bands
    scanned_launches += 1
    bipartite_launches += ids is not None and msgs.shape[0] != out.shape[0]
    return out


def _slot_rows(bounds, offs2d, k, length) -> torch.Tensor:
    """int32 ``[length]``: the row of every slot of band ``k``'s stream, pad
    slots included (they take the last row), as ``BandedLayout.dev()``
    keeps it in ``seg[k]``; built on the staircase's device with no host
    sync."""
    starts = offs2d[:, k, :].reshape(-1)
    slots = torch.arange(length, dtype=starts.dtype, device=starts.device)
    return (torch.searchsorted(starts, slots, right=True) - 1).to(torch.int32)


def sddmm_plan(F: int, heads: int, element_size: int, aligned: bool) -> tuple:
    """``(lanes, head_lanes)`` of the SDDMM kernel for message rows of F
    elements and ``heads`` heads.  The vector form: a lane holds ``V = 16 /
    element_size`` columns in one load, ``lanes`` lanes (a power of two up
    to 32) cover a row and ``head_lanes`` of them one head.  ``lanes == 0``
    is the scalar form: rows that are not whole 16-byte vectors or are
    wider than 32 of them, heads whose lanes are no power of two, or
    pointers that are not 16-byte aligned."""
    V = 16 // element_size
    scalar = (0, 0)
    if not aligned or F % V or F // V > 32:
        return scalar
    lanes = _lanes(F, V)
    if heads == 1:
        return lanes, lanes
    d = F // heads
    head_lanes = d // V
    if d % V or head_lanes & (head_lanes - 1):
        return scalar
    return lanes, head_lanes


def _sddmm_plan_for(msgs, y, heads) -> tuple:
    aligned = y.data_ptr() % 16 == 0 and all(
        m.data_ptr() % 16 == 0 for m in msgs)
    return sddmm_plan(msgs[0].shape[1], heads, msgs[0].element_size(),
                      aligned)


SCALAR_COLS = 256  # columns a warp of the scalar form covers per pass


def _xor_fold(p: torch.Tensor) -> torch.Tensor:
    """A warp's butterfly sum over the last axis (a power of two of lanes):
    offsets n/2 ... 1, every lane adding its partner's value; lane 0's
    result (every lane holds the same bits)."""
    n = p.shape[-1]
    lane = torch.arange(n, device=p.device)
    o = n // 2
    while o >= 1:
        p = p + p[..., lane ^ o]
        o //= 2
    return p[..., 0]


def banded_sddmm_scheduled_plain(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    y: torch.Tensor,
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
    heads: int = 1,
    plan: Optional[tuple] = None,
) -> torch.Tensor:
    """The SDDMM kernel's schedule in plain torch: the same result as
    ``csrc/spmm_banded.cu`` bit for bit (its products and sums are single
    float32 operations), for the CPU tests of the lane arithmetic and for
    the card's check of the kernel.  ``plan`` defaults to the kernel's
    (:func:`sddmm_plan`).

    Vector form: lane ``l`` of a slot's lane group holds columns ``[l V, (l
    + 1) V)`` and sums its V products in order; the ``head_lanes`` lanes of
    a head fold by a butterfly (offsets ``head_lanes / 2 ... 1``).  Scalar
    form: per head and per pass of 256 columns, lane ``l`` sums the
    products of columns ``c0 + l + 32 i`` in order, the 32 lanes fold by a
    butterfly, and the passes' sums add up in order."""
    msgs = _prepare(bounds, offs2d, msgs, precision, edge_chunk)
    y = _prepare_y(offs2d, msgs, y, precision, heads)
    F = msgs[0].shape[1]
    lanes, head_lanes = (_sddmm_plan_for(msgs, y, heads)
                         if plan is None else plan)
    V = 16 // msgs[0].element_size()
    d = F // heads
    out = []
    for k, m in enumerate(msgs):
        seg = _segment_ids(bounds, offs2d, k)
        real = seg.numel()
        prod = y[seg].float() * m[:real].float()  # float32 products
        dw = torch.zeros(m.shape[0], heads, dtype=torch.float32,
                         device=m.device)
        if lanes:
            wide = prod.new_zeros(real, lanes * V)
            wide[:, :F] = prod
            wide = wide.reshape(real, lanes, V)
            p = wide[..., 0]
            for i in range(1, V):
                p = p + wide[..., i]
            p = p[:, :heads * head_lanes].reshape(real, heads, head_lanes)
            dw[:real] = _xor_fold(p)
        else:
            lane = torch.arange(32, device=m.device)
            for h in range(heads):
                acc = prod.new_zeros(real)
                for c0 in range(h * d, (h + 1) * d, SCALAR_COLS):
                    p = prod.new_zeros(real, 32)
                    for i in range(SCALAR_COLS // 32):
                        c = c0 + lane + 32 * i
                        on = c < (h + 1) * d
                        p[:, on] = p[:, on] + prod[:, c[on]]
                    acc = acc + _xor_fold(p)
                dw[:real, h] = acc
        out.append(dw)
    out = torch.cat(out)
    return out[:, 0] if heads == 1 else out


def banded_sddmm_plain(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    y: torch.Tensor,
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
    heads: int = 1,
) -> torch.Tensor:
    """Plain torch version: per band, each real slot's row ``y[seg]``
    (``seg`` from the staircase) dotted with its message, per head, in
    float64 and rounded once; pad slots 0.  A deterministic reference for
    the kernel."""
    msgs = _prepare(bounds, offs2d, msgs, precision, edge_chunk)
    y = _prepare_y(offs2d, msgs, y, precision, heads)
    out = []
    for k, m in enumerate(msgs):
        seg = _segment_ids(bounds, offs2d, k)
        dw = torch.zeros(m.shape[0], heads, dtype=torch.float64,
                         device=m.device)
        prod = y[seg].double() * m[: seg.numel()].double()
        # explicit widths: a band may hold no real slot
        dw[: seg.numel()] = prod.reshape(seg.numel(), heads,
                                         m.shape[1] // heads).sum(-1)
        out.append(dw)
    out = torch.cat(out).to(torch.float32)
    return out[:, 0] if heads == 1 else out


def banded_sddmm(
    bounds: torch.Tensor,
    offs2d: torch.Tensor,
    msgs: Sequence[torch.Tensor],
    y: torch.Tensor,
    precision: str = "split",
    edge_chunk: int = EDGE_CHUNK,
    heads: int = 1,
    seg: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Per-slot dot products ``<y[dst], msgs[k][j]>`` over the banded
    layout: the flat float32 ``[sum mk_pad]`` stream (``[sum mk_pad, H]``
    with ``heads=H``), pad slots 0 (see module doc);
    ``BandedLayout.permute_from_bands`` maps it to edge order.  Float32
    inputs give an exact float32 dot product (float32 products and sums),
    tighter than the TPU twin's 3-pass bf16 hi/lo ``split`` (about 1e-5
    relative).  On CUDA tensors this launches ``csrc/spmm_banded.cu``'s
    ``banded_sddmm_launch``, one launch for all heads, which reads each
    slot's row from ``seg`` (K int32 ``[mk_pad]`` tensors,
    ``BandedLayout.dev()["seg"]``; built from the staircase in the call
    when None).  The CPU's plain version needs no ``seg``."""
    if not _on_card(msgs, "banded_sddmm"):
        return banded_sddmm_plain(bounds, offs2d, msgs, y, precision,
                                  edge_chunk, heads)
    device = msgs[0].device
    refuse_grad("banded_sddmm", y, *msgs)
    msgs = [m.contiguous() for m in _prepare(bounds, offs2d, msgs,
                                             precision, edge_chunk)]
    y = _prepare_y(offs2d, msgs, y, precision, heads).contiguous()
    _check_cuda(bounds, offs2d, [*msgs, y], device)
    bounds = bounds.contiguous()
    K = len(msgs)
    lens = [int(m.shape[0]) for m in msgs]
    if seg is None:
        seg = [_slot_rows(bounds, offs2d, k, n) for k, n in enumerate(lens)]
    seg = [s.contiguous() for s in seg]
    if len(seg) != K or any(
            s.device != device or s.dtype != torch.int32
            or tuple(s.shape) != (n,) for s, n in zip(seg, lens)):
        raise ValueError("seg must be K int32 [mk_pad] tensors on the "
                         "messages' device")
    _bind(K)
    lanes, head_lanes = _sddmm_plan_for(msgs, y, heads)
    out = torch.empty(sum(lens), heads, dtype=torch.float32, device=device)
    ptrs = (ctypes.c_void_p * K)(*[m.data_ptr() for m in msgs])
    seg_ptrs = (ctypes.c_void_p * K)(*[s.data_ptr() for s in seg])
    rc = _sddmm_launch(
        ptrs, seg_ptrs, (ctypes.c_longlong * K)(*lens), K, bounds.data_ptr(),
        y.data_ptr(), out.data_ptr(), offs2d.shape[0], msgs[0].shape[1],
        heads, _DTYPE_CODE[msgs[0].dtype], _DTYPE_CODE[y.dtype], lanes,
        head_lanes, _build.stream(device.index),
    )
    if rc != 0:
        raise RuntimeError(f"banded_sddmm kernel launch failed: CUDA error "
                           f"{rc}")
    global sddmm_launches
    sddmm_launches += 1
    return out[:, 0] if heads == 1 else out
