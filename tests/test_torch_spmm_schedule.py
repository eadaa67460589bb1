"""The banded segment sum's load-balanced schedule (csrc/spmm_banded.cu),
on the CPU.

The CUDA kernel cannot run here, so its partition is reached three ways
(with and without the per-slot weights it scales the messages by):
``banded_segment_sum_scheduled_plain`` (the schedule in plain torch) is
held against the plain version and the JAX twin; a line-by-line Python
transcription of the kernel's walker and fix-up (``_walk_like_the_kernel``)
must give the emulation's result bit for bit, since both add in float32
in the same order; and the schedule cached by ``BandedLayout.dev()`` is
reused by the model path and dropped with its graph.  The tests marked
``cuda`` launch the kernel itself on the card against the emulation, and
skip without one.

Tolerance: the emulation and the plain version sum the same terms, in
float32 and in float64, so they differ by float32 rounding of sums of up
to a few thousand terms: ``SUM_TOL = 1e-5`` of the largest output, the
bound ``chip_smoke.py`` holds the kernel to.
"""

import gc
import sys
import weakref

import numpy as np
import pytest
import torch

from mini_tpu_torch.graph import GraphSlice, erdos_renyi, from_edges, rmat
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.graph.banded import build_banded_layout, row_prefix
from mini_tpu_torch.ops.kernels import spmm_banded as k2
from mini_tpu_torch.ops.spmm import _weigh, spmm

SUM_TOL = 1e-5  # max |scheduled - plain| <= SUM_TOL * max |plain|


def _kernel_args(lay):
    return (torch.from_numpy(lay.bounds),
            torch.from_numpy(np.ascontiguousarray(
                lay.offs2d.transpose(1, 0, 2))))


def _msgs(lay, F, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(len(i), F).astype(np.float32) - 0.5)
            .to(dtype) for i in lay.ids]


def _pull_layout(hg, band_rows):
    gs = GraphSlice.from_host(hg, device="cpu")
    return build_banded_layout(
        gs.col_offsets.numpy(), gs.csc_srcs.numpy(), gs.csc_weights.numpy(),
        gs.edge_mask_csc.numpy(), band_rows, "pull",
    )


def _rmat_layout(K):
    """rmat(10) (1152 padded rows, isolated vertices included) cut into K
    bands, as FAST_TABLE_BYTES would cut it at 512-byte rows."""
    lay = _pull_layout(rmat(10, edge_factor=8, seed=K, undirected=True,
                            weighted=True), -(-1152 // K))
    assert lay.K == K
    return lay


def _star_layout():
    """One row (vertex 0) holds every edge: 3000 in-edges, 2 bands, so it
    spans many chunks; every other row is empty."""
    n = 3000
    srcs = np.arange(1, n)
    lay = _pull_layout(from_edges(srcs, np.zeros(n - 1, np.int64),
                                  num_nodes=n), 1536)
    assert lay.K == 2 and lay.lens[0] > 1000 and lay.lens[1] > 1000
    return lay


def _empty_band_layout():
    """4 bands of 128 rows (385 rows padded to 512); no edge gathers from
    band 1, so its stream has pad slots only."""
    rng = np.random.RandomState(2)
    n = 384
    srcs = np.concatenate([rng.randint(0, 128, 900),
                           rng.randint(256, n, 900)])
    dsts = rng.randint(0, n, srcs.shape[0])
    lay = _pull_layout(from_edges(srcs, dsts, num_nodes=n), 128)
    assert lay.K == 4 and lay.lens[1] == 0 and lay.bounds[1, -1] == 0
    return lay


def _regular_layout():
    """Every row has 4 in-edges and one band: with chunk = 8 every cut
    falls exactly on a row end."""
    n = 256
    v = np.arange(n)
    srcs = np.concatenate([(v + s) % n for s in (1, 2, 3, 5)])
    dsts = np.concatenate([v] * 4)
    lay = _pull_layout(from_edges(srcs, dsts, num_nodes=n), 512)
    assert lay.K == 1
    return lay


LAYOUTS = {
    "rmat_K1": lambda: _rmat_layout(1),
    "rmat_K3": lambda: _rmat_layout(3),
    "rmat_K9": lambda: _rmat_layout(9),
    "star": _star_layout,
    "empty_band": _empty_band_layout,
    "regular": _regular_layout,
}


@pytest.fixture(scope="module")
def layouts():
    return {name: build() for name, build in LAYOUTS.items()}


def _assert_close(got, want):
    err = float((got - want).abs().max())
    assert err <= SUM_TOL * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 32, 33, 128])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_scheduled_matches_plain(layouts, name, F, dtype):
    lay = layouts[name]
    args = _kernel_args(lay)
    msgs = _msgs(lay, F, dtype)
    want = k2.banded_segment_sum_plain(*args, msgs)
    for chunk in (8, 61, 512, None):  # None: the kernel's own
        got = k2.banded_segment_sum_scheduled_plain(*args, msgs, chunk=chunk)
        assert got.dtype == torch.float32 and got.shape == want.shape
        _assert_close(got, want)


def _round_bf16(a):
    """float32 to bfloat16, nearest even, and back (finite values), as
    ``__float2bfloat16_rn``."""
    b = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def _weigh_like_the_kernel(m, w, heads):
    """A stream's messages scaled as the weighted walker scales them: the
    weight cast to the messages' dtype, one float32 product an element,
    rounded to bf16 for bf16 messages; in numpy."""
    x = m.float().numpy()
    wf = w.to(m.dtype).float().numpy().reshape(m.shape[0], heads)
    prod = x * np.repeat(wf, m.shape[1] // heads, axis=1)
    return _round_bf16(prod) if m.dtype == torch.bfloat16 else prod


def _scan_slots(bounds, offs2d, prefix, K, G, start):
    """The slots ``(v, k, j)`` of the virtual order from ``start`` on, as
    a walker of csrc/spmm_banded.cu finds them, transcribed statement by
    statement: ``first_slot``, then ``next_segment`` at each segment's
    end.  Its G lanes load a window of G bands of row v at once, lane i
    band k0 + i (``scan_window``); ``todo`` is their vote, bit i set where
    band k0 + i holds a slot; ``rest`` counts the row's slots in bands past
    the one taken, so a row's later windows load only while it has some."""
    n_rows = offs2d.shape[0] * 128

    def segment(v, k):
        t, r = divmod(v, 128)
        e = offs2d[t, k, r + 1] if r + 1 < 128 else bounds[k, t + 1]
        return int(offs2d[t, k, r]), int(e)

    def window(v, k0):  # scan_window
        ws, we = np.zeros(G, np.int64), np.zeros(G, np.int64)
        for lane in range(G):
            if k0 + lane < K:
                ws[lane], we[lane] = segment(v, k0 + lane)
        return ws, we, sum(1 << i for i in range(G) if we[i] > ws[i])

    def lowest(bits):  # __ffs - 1
        return (bits & -bits).bit_length() - 1

    # first_slot: the row, then the window whose lanes' running count of
    # slots passes start's place in the row
    v = int(np.searchsorted(prefix[:n_rows], start, side="right")) - 1
    p0 = int(prefix[v])
    o, rest, k0 = start - p0, int(prefix[v + 1]) - p0, 0
    while True:
        ws, we, todo = window(v, k0)
        upto = np.cumsum(we - ws)
        if o < upto[G - 1]:
            i = lowest(sum(1 << x for x in range(G) if upto[x] > o))
            todo &= ~((2 << i) - 1)
            k = k0 + i
            j = int(ws[i] - (upto[i] - (we[i] - ws[i]))) + o
            e = int(we[i])
            rest -= int(upto[i])
            break
        o -= int(upto[G - 1])
        rest -= int(upto[G - 1])
        k0 += G
    while True:
        if j == e:  # next_segment
            while todo == 0:
                if rest == 0 or k0 + G >= K:  # the next row with a slot
                    v += 1
                    p0, p1 = int(prefix[v]), int(prefix[v + 1])
                    for _ in range(4):
                        if p1 != p0:
                            break
                        v += 1
                        p1 = int(prefix[v + 1])
                    if p1 == p0:
                        v = int(np.searchsorted(prefix[:n_rows], p0,
                                                "right")) - 1
                        p1 = int(prefix[v + 1])
                    k0, rest = 0, p1 - p0
                else:
                    k0 += G
                ws, we, todo = window(v, k0)
            i = lowest(todo)  # take
            todo &= todo - 1
            k, j, e = k0 + i, int(ws[i]), int(we[i])
            rest -= e - j
        yield v, k, j
        j += 1


def _walk_like_the_kernel(bounds, offs2d, msgs, prefix, chunk, fix_lanes,
                          weights=None, heads=1, ids=None, band_rows=None,
                          lanes=None):
    """``banded_segment_sum_kernel`` and ``banded_fixup_kernel`` of
    csrc/spmm_banded.cu, transcribed statement by statement (one walker at
    a time, all columns at once), in numpy float32, each message first
    scaled by its weight where ``weights`` are given; each walker finds
    its slots by :func:`_scan_slots` with ``lanes`` lanes (default: the
    kernel's lanes for these rows).  With ``ids`` (the indexed walker)
    ``msgs`` is the table, and the walker reads slot ``j`` of band ``k``
    as its row ``k band_rows + ids[k][j]``, weighted there.  Unwritten
    outputs and carries are NaN, so a row written by nobody, or a carry
    read before it was written, shows."""
    bounds, offs2d = bounds.numpy(), offs2d.numpy()
    prefix = prefix.numpy().astype(np.int64)
    rows_of = msgs if ids is None else [msgs]
    if lanes is None:
        lanes = k2.kernel_plan(rows_of[0].shape[1], rows_of[0].element_size(),
                               k2._vector_ok(rows_of))[0]
    if ids is None:
        msgs = ([m.float().numpy() for m in msgs] if weights is None else
                [_weigh_like_the_kernel(m, w, heads)
                 for m, w in zip(msgs, weights)])
        lengths = [m.shape[0] for m in msgs]

        def message(k, j):
            return msgs[k][j]
    else:
        table, lengths = msgs, [len(i) for i in ids]
        ids = [i.numpy() for i in ids]

        def message(k, j):  # the slot's id, then its row of the table
            row = table[k * band_rows + int(ids[k][j])][None]
            if weights is None:
                return row[0].float().numpy()
            return _weigh_like_the_kernel(row, weights[k][j][None],
                                          heads)[0]
    K, n_tiles = len(lengths), offs2d.shape[0]
    F = msgs[0].shape[1] if ids is None else table.shape[1]
    n_rows = n_tiles * 128
    total = int(prefix[n_rows])
    n_walkers = -(-sum(lengths) // chunk)
    out = np.full((n_rows, F), np.nan, np.float32)
    carry = np.full((n_walkers, 2, F), np.nan, np.float32)

    def flush(row, acc, start, stop, walker):
        p0, p1 = prefix[row], prefix[row + 1]
        if p0 >= start and p1 <= stop:
            assert np.isnan(out[row]).all(), "a row written twice"
            out[row] = acc
        else:
            carry[walker, 0 if p0 < start else 1] = acc

    for walker in range(n_walkers):
        start = walker * chunk
        if start >= total:
            continue
        stop = start + chunk
        end = min(stop, total)
        slots = _scan_slots(bounds, offs2d, prefix, K, lanes, start)
        acc, row = np.zeros(F, np.float32), None
        for _, (v, k, j) in zip(range(start, end), slots):
            if row is None:
                row = v
            if v != row:
                flush(row, acc, start, stop, walker)
                row, acc = v, np.zeros(F, np.float32)
            acc = acc + message(k, j)
        flush(row, acc, start, stop, walker)

    groups = 32 // fix_lanes  # the fix-up warp's lane groups
    for v in range(n_rows):
        p0, p1 = int(prefix[v]), int(prefix[v + 1])
        if p0 == p1:
            out[v] = 0.0
            continue
        b0, b1 = p0 // chunk, (p1 - 1) // chunk
        if b0 == b1:
            continue
        per = -(-(b1 - b0) // groups)
        parts = []
        for group in range(groups):
            part = np.zeros(F, np.float32)
            lo = b0 + 1 + group * per
            for b in range(lo, min(lo + per, b1 + 1)):
                part = part + carry[b, 0]
            parts.append(part)
        acc = carry[b0, 1].copy()
        for part in parts:
            acc = acc + part
        out[v] = acc
    assert not np.isnan(out).any()
    return torch.from_numpy(out)


@pytest.mark.parametrize("name,F,dtype,chunk", [
    ("rmat_K3", 33, torch.float32, 61),
    ("rmat_K9", 8, torch.bfloat16, 512),
    ("star", 8, torch.float32, 64),
    ("empty_band", 5, torch.float32, 40),
    ("regular", 3, torch.bfloat16, 8),
])
def test_kernel_walk_matches_scheduled_bitwise(layouts, name, F, dtype,
                                               chunk):
    lay = layouts[name]
    args = _kernel_args(lay)
    msgs = _msgs(lay, F, dtype, seed=1)
    prefix = row_prefix(*args)
    want = k2.banded_segment_sum_scheduled_plain(*args, msgs,
                                                 row_prefix=prefix,
                                                 chunk=chunk)
    fix_lanes = k2.kernel_plan(F, msgs[0].element_size(),
                               k2._vector_ok(msgs))[2]
    got = _walk_like_the_kernel(*args, msgs, prefix, chunk, fix_lanes)
    assert torch.equal(got, want)
    _assert_close(got, k2.banded_segment_sum_plain(*args, msgs))


@pytest.mark.parametrize("F,elem,vector,plan", [
    (128, 4, True, (32, 512, 32)),   # one warp a float32 row
    (128, 2, True, (16, 256, 32)),   # two bf16 walkers a warp
    (32, 4, True, (8, 128, 8)),      # four walkers, 4 fix-up lane groups
    (32, 2, True, (4, 128, 8)),
    (33, 4, False, (32, 512, 32)),   # scalar path, two column blocks
    (1, 4, False, (1, 128, 1)),      # 32 walkers a warp
])
def test_kernel_plan(F, elem, vector, plan):
    assert k2.kernel_plan(F, elem, vector) == plan


def _weights(lay, heads, seed=2):
    """Per-slot weights in [-1, 1), ``[mk_pad]`` or ``[mk_pad, heads]``."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, (len(i), heads))
                             .astype(np.float32)).reshape(
                                 (len(i), heads)[:1 if heads == 1 else 2])
            for i in lay.ids]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("F", [40, 128, 256])
@pytest.mark.parametrize("name", ["star", "rmat_K3", "empty_band"])
def test_weighted_sum_is_the_sum_of_weighed_messages(layouts, name, F,
                                                     heads, dtype):
    """The weights the kernel takes give, bit for bit, what the SpMM's
    unfused route gave: the same sum of ``_weigh``-ed messages without
    weights, in the plain version and in the kernel's schedule.  The star
    holds a hub over many walkers and empty rows, rmat isolated vertices,
    every layout pad slots."""
    lay = layouts[name]
    args = _kernel_args(lay)
    msgs, w = _msgs(lay, F, dtype), _weights(lay, heads)
    weighed = [_weigh(m, wk, heads) for m, wk in zip(msgs, w)]
    got = k2.banded_segment_sum_plain(*args, msgs, weights=w)
    assert torch.equal(got, k2.banded_segment_sum_plain(*args, weighed))
    prefix = row_prefix(*args)
    got = k2.banded_segment_sum_scheduled_plain(*args, msgs,
                                                row_prefix=prefix, weights=w)
    assert torch.equal(got, k2.banded_segment_sum_scheduled_plain(
        *args, weighed, row_prefix=prefix))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["star", "rmat_K3", "empty_band"])
def test_unit_weights_and_none_give_the_unweighted_sum(layouts, name, dtype):
    """``weights=None`` leaves the sum as it was without weights (the
    unweighted walker's transcription, bit for bit), and weights of 1 give
    its bits too (x * 1 is exact), with and without heads."""
    lay = layouts[name]
    args = _kernel_args(lay)
    msgs = _msgs(lay, 40, dtype)
    prefix = row_prefix(*args)
    _, chunk, fix_lanes = k2.kernel_plan(40, msgs[0].element_size(),
                                         k2._vector_ok(msgs))
    walked = _walk_like_the_kernel(*args, msgs, prefix, chunk, fix_lanes)
    assert torch.equal(k2.banded_segment_sum_scheduled_plain(
        *args, msgs, row_prefix=prefix, weights=None), walked)
    for fn in (k2.banded_segment_sum_plain,
               k2.banded_segment_sum_scheduled_plain):
        want = fn(*args, msgs)
        assert torch.equal(fn(*args, msgs, weights=None), want)
        for heads in (1, 4):
            ones = [torch.ones_like(w) for w in _weights(lay, heads)]
            assert torch.equal(fn(*args, msgs, weights=ones), want)


@pytest.mark.parametrize("name,F,heads,dtype,chunk", [
    ("rmat_K3", 40, 1, torch.float32, 61),
    ("rmat_K9", 16, 1, torch.bfloat16, 512),
    ("star", 12, 3, torch.float32, 64),      # a head a lane vector
    ("star", 40, 4, torch.float32, 100),     # heads split the vectors
    ("empty_band", 24, 3, torch.bfloat16, 40),
    ("regular", 5, 1, torch.bfloat16, 8),
])
def test_weighted_kernel_walk_matches_scheduled_bitwise(layouts, name, F,
                                                        heads, dtype, chunk):
    """The weighted walker, transcribed with the product and its bf16
    rounding in numpy, gives the scheduled emulation's bits."""
    lay = layouts[name]
    args = _kernel_args(lay)
    msgs, w = _msgs(lay, F, dtype, seed=3), _weights(lay, heads, seed=4)
    prefix = row_prefix(*args)
    want = k2.banded_segment_sum_scheduled_plain(
        *args, msgs, row_prefix=prefix, chunk=chunk, weights=w)
    fix_lanes = k2.kernel_plan(F, msgs[0].element_size(),
                               k2._vector_ok(msgs))[2]
    got = _walk_like_the_kernel(*args, msgs, prefix, chunk, fix_lanes,
                                weights=w, heads=heads)
    assert torch.equal(got, want)


def _table(lay, F, dtype, seed=5):
    """A source table ``[n_pad, F]`` for the indexed form."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.rand(lay.n_pad, F).astype(np.float32)
                            - 0.5).to(dtype)


def _ids(lay):
    return [torch.from_numpy(i) for i in lay.ids]


def _gather_then(lay, x):
    """The stream form's streams: the K band gathers ``x[band k][ids[k]]``,
    as ``ops.spmm._gather_bands`` makes them."""
    return [x[k * lay.band_rows: (k + 1) * lay.band_rows][i.long()]
            for k, i in enumerate(_ids(lay))]


@pytest.mark.parametrize("precision", ["split", "fast"])
@pytest.mark.parametrize("heads", [None, 1, 4])
@pytest.mark.parametrize("F", [40, 128])
@pytest.mark.parametrize("name", ["star", "rmat_K3", "rmat_K9",
                                  "empty_band"])
def test_indexed_plain_is_the_gathered_sum(layouts, name, F, heads,
                                           precision):
    """The table and its ids give, bit for bit, the sum of the band
    gathers: in the plain version and in the kernel's schedule, without
    weights and with ``[mk]`` or ``[mk, H]`` ones, and under ``fast``
    (the table rounded to bfloat16, as the gathers were).  The star's hub
    crosses many chunks; band 1 of ``empty_band`` has no slot."""
    lay = layouts[name]
    args = _kernel_args(lay)
    x = _table(lay, F, torch.float32)
    w = None if heads is None else _weights(lay, heads)
    streams = _gather_then(lay, x)
    for fn in (k2.banded_segment_sum_plain,
               k2.banded_segment_sum_scheduled_plain):
        got = fn(*args, x, precision=precision, weights=w, ids=_ids(lay),
                 band_rows=lay.band_rows)
        assert torch.equal(got, fn(*args, streams, precision=precision,
                                   weights=w))


@pytest.mark.parametrize("name,F,heads,dtype,chunk", [
    ("rmat_K3", 40, None, torch.float32, 61),
    ("rmat_K9", 16, 1, torch.bfloat16, 512),
    ("star", 12, 3, torch.float32, 64),
    ("star", 40, 4, torch.float32, 100),
    ("empty_band", 24, 3, torch.bfloat16, 40),
    ("regular", 5, None, torch.bfloat16, 8),
])
def test_indexed_kernel_walk_matches_scheduled_bitwise(layouts, name, F,
                                                       heads, dtype, chunk):
    """The indexed walker, transcribed with its id load in front of every
    row, gives the bits of the stream form's scheduled emulation on the
    gathered streams, and of the indexed schedule."""
    lay = layouts[name]
    args = _kernel_args(lay)
    x = _table(lay, F, dtype, seed=6)
    w = None if heads is None else _weights(lay, heads, seed=7)
    prefix = row_prefix(*args)
    want = k2.banded_segment_sum_scheduled_plain(
        *args, _gather_then(lay, x), row_prefix=prefix, chunk=chunk,
        weights=w)
    assert torch.equal(want, k2.banded_segment_sum_scheduled_plain(
        *args, x, row_prefix=prefix, chunk=chunk, weights=w, ids=_ids(lay),
        band_rows=lay.band_rows))
    fix_lanes = k2.kernel_plan(F, x.element_size(), k2._vector_ok([x]))[2]
    got = _walk_like_the_kernel(*args, x, prefix, chunk, fix_lanes,
                                weights=w, heads=heads or 1, ids=_ids(lay),
                                band_rows=lay.band_rows)
    assert torch.equal(got, want)


# bands at the edges of a walker's windows of 8 and of 32 bands
EDGE_BANDS = (7, 8, 15, 16, 31, 32, 63, 64, 127, 128)
EDGE_ROWS = 4  # band_rows of the window-edge layouts' tables


def _window_edge_layout(K, hub=40, seed=0):
    """A layout of K bands over 3 tiles (384 rows) whose slots lie only in
    bands at window edges (7/8, 15/16, 31/32, 63/64, 127/128) and in band
    K-1: rows with a few such segments; rows whose only segment is in band
    K-1; rows at r = 127, whose segments end at ``bounds``; a hub with
    ``hub`` slots in each such band, so that chunks start inside its later
    windows; and runs of empty rows (stepped over, then searched).  Slot j
    of band k reads row ``k EDGE_ROWS + ids[k][j]`` of a table.  Returns
    ``(bounds, offs2d, ids)``, int32, the id streams padded to 8 slots."""
    rng = np.random.RandomState(seed + K)
    n_tiles, n_rows = 3, 384
    edge = [b for b in EDGE_BANDS if b < K - 1] + [K - 1]
    counts = np.zeros((n_rows, K), np.int64)
    for v in range(0, n_rows, 3):
        bands = rng.choice(edge, size=min(len(edge), rng.randint(1, 4)),
                           replace=False)
        counts[v, bands] = rng.randint(1, 4, len(bands))
    counts[1::7] = 0
    counts[1::7, K - 1] = rng.randint(1, 3, len(counts[1::7]))
    for v in (127, 255, 383):  # r = 127
        counts[v, edge] = rng.randint(0, 3, len(edge))
        counts[v, K - 1] = 1
    counts[200:240] = 0
    counts[130, edge] = hub
    starts = np.cumsum(counts, axis=0) - counts
    offs2d = starts.reshape(n_tiles, 128, K).transpose(0, 2, 1)
    lens = counts.sum(axis=0)
    bounds = np.concatenate([offs2d[:, :, 0].T, lens[:, None]], axis=1)
    ids = [np.zeros(max(8, -(-n // 8) * 8), np.int32) for n in lens]
    for i, n in zip(ids, lens):
        i[:n] = rng.randint(0, EDGE_ROWS, n)
    return (torch.from_numpy(bounds.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(offs2d).astype(np.int32)),
            [torch.from_numpy(i) for i in ids])


def _window_edge_inputs(K, F, dtype, hub=40, device="cpu"):
    """:func:`_window_edge_layout`'s arrays with a table ``[K EDGE_ROWS,
    F]`` of ``dtype`` and per-slot weights, on ``device``."""
    bounds, offs2d, ids = _window_edge_layout(K, hub)
    rng = np.random.RandomState(K + F)
    x = torch.from_numpy(rng.rand(K * EDGE_ROWS, F).astype(np.float32)
                         - 0.5).to(dtype)
    w = [torch.from_numpy(rng.uniform(-1, 1, len(i)).astype(np.float32))
         for i in ids]
    return [a.to(device) for a in (bounds, offs2d, x)], dict(
        ids=[i.to(device) for i in ids], weights=[v.to(device) for v in w],
        band_rows=EDGE_ROWS, edge_chunk=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [11, 42, 150, 513])
@pytest.mark.parametrize("lanes", [8, 32])
def test_scanned_walk_matches_scheduled_bitwise(lanes, K, dtype):
    """The walker that scans a row's bands a window of ``lanes`` at a time
    visits the slots of the virtual order in order from any start (every
    chunk's start, inside the hub's later windows too), and its walk gives
    the scheduled emulation's bits, on layouts whose non-empty bands sit at
    window edges and in band K-1, with rows at r = 127."""
    (bounds, offs2d, x), kw = _window_edge_inputs(K, 8, dtype)
    prefix = row_prefix(bounds, offs2d)
    counts = (torch.cat([offs2d[:, :, 1:], bounds.t()[1:, :, None]], 2)
              - offs2d).permute(0, 2, 1).reshape(-1, K).numpy()
    order = [(v, k, int(offs2d[v // 128, k, v % 128]) + j)
             for v, k in zip(*np.nonzero(counts))
             for j in range(counts[v, k])]
    for start in range(0, len(order), 5):
        slots = _scan_slots(bounds.numpy(), offs2d.numpy(),
                            prefix.numpy().astype(np.int64), K, lanes, start)
        want = order[start:start + 5]
        assert [s for _, s in zip(want, slots)] == want
    fix_lanes = k2.kernel_plan(8, x.element_size(), k2._vector_ok([x]))[2]
    for chunk in (5, 64):
        want = k2.banded_segment_sum_scheduled_plain(
            bounds, offs2d, x, row_prefix=prefix, chunk=chunk, **kw)
        got = _walk_like_the_kernel(
            bounds, offs2d, x, prefix, chunk, fix_lanes, kw["weights"],
            ids=kw["ids"], band_rows=EDGE_ROWS, lanes=lanes)
        assert torch.equal(got, want), chunk


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 2 runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [32, 100, 256])
@pytest.mark.parametrize("K", [11, 42, 150, 513])
def test_scanned_walk_on_card(card, K, F, dtype):
    """Kernel 2's indexed, weighted launch on the window-edge layouts (a
    hub of 400 slots a band, so that many walkers start inside it) is
    bitwise its scheduled emulation, at F = 32 (walkers of 8 lanes in
    float32, 4 in bf16), 100 and 256 (two column blocks in float32); the
    launch counts as one that scans."""
    (bounds, offs2d, x), kw = _window_edge_inputs(K, F, dtype, hub=400,
                                                  device=card)
    prefix = row_prefix(bounds, offs2d)
    before = (k2.launches, k2.scanned_launches)
    got = k2.banded_segment_sum(bounds, offs2d, x, row_prefix=prefix, **kw)
    assert (k2.launches - before[0], k2.scanned_launches - before[1]) == (
        1, 1)
    want = k2.banded_segment_sum_scheduled_plain(bounds, offs2d, x,
                                                 row_prefix=prefix, **kw)
    assert torch.equal(got, want)
    torch.cuda.synchronize()


def test_indexed_inputs_checked(layouts):
    lay = layouts["rmat_K3"]
    args = _kernel_args(lay)
    x, ids = _table(lay, 16, torch.float32), _ids(lay)
    bad = [
        (x, ids[:2], lay.band_rows, "2 id streams for bounds"),
        (x, [i.long() for i in ids], lay.band_rows, "int32"),
        (x, [i[:-1] for i in ids], lay.band_rows, "edge_chunk"),
        (x, ids, None, "band_rows"),
        (x, ids, lay.n_pad, "band_rows"),
        (x[:, 0], ids, lay.band_rows, r"\[n_src, F\]"),
    ]
    for table, i, rows, match in bad:
        with pytest.raises(ValueError, match=match):
            k2.banded_segment_sum_plain(*args, table, ids=i, band_rows=rows)
    with pytest.raises(TypeError, match="table"):
        k2.banded_segment_sum_plain(*args, x.double(), ids=ids,
                                    band_rows=lay.band_rows)


def test_weights_checked():
    lay = _rmat_layout(3)
    args = _kernel_args(lay)
    msgs, w = _msgs(lay, 16, torch.float32), _weights(lay, 1)
    for bad in (w[:2], [x[:-1] for x in w], [x[:, None].expand(-1, 3)
                                             for x in w],
                [x.long() for x in w]):
        with pytest.raises(ValueError, match="weights"):
            k2.banded_segment_sum_plain(*args, msgs, weights=bad)


def test_schedule_shapes(layouts):
    """The row prefix counts every real slot once; the star's row spans
    many chunks; the regular layout's rows end on every cut at chunk 8."""
    for name, lay in layouts.items():
        prefix = row_prefix(*_kernel_args(lay))
        assert prefix.dtype == torch.int32
        assert prefix.shape == (lay.n_pad + 1,) and int(prefix[0]) == 0
        assert int(prefix[-1]) == int(lay.bounds[:, -1].sum()), name
        assert bool((prefix[1:] >= prefix[:-1]).all())
    star = row_prefix(*_kernel_args(layouts["star"])).long()
    assert int(star[1] - star[0]) // k2.MIN_CHUNK >= 5
    reg = row_prefix(*_kernel_args(layouts["regular"])).long()
    assert bool((reg[::2] % 8 == 0).all())
    # empty rows: RMAT isolated vertices and the star's leaves
    assert bool((star[1:] == star[:-1]).any())


def test_scheduled_matches_pallas(layouts):
    """The emulation against the TPU twin in interpret mode (two bands of
    128 rows)."""
    import jax.numpy as jnp

    from mini_tpu.ops.pallas.spmm_banded import (
        banded_segment_sum as jax_banded_segment_sum,
    )

    hg = erdos_renyi(200, 1200, seed=3, undirected=True, weighted=True)
    lay = _pull_layout(hg, 128)
    assert lay.K == 2
    bounds, offs2d = _kernel_args(lay)
    msgs = _msgs(lay, 128, torch.float32, seed=4)
    want = np.asarray(jax_banded_segment_sum(
        jnp.asarray(lay.bounds), jnp.asarray(offs2d.numpy()),
        [jnp.asarray(m.numpy()) for m in msgs], precision="highest",
        interpret=True,
    ))
    got = k2.banded_segment_sum_scheduled_plain(bounds, offs2d, msgs,
                                                chunk=64)
    err = np.abs(got.numpy() - want).max()
    assert err <= SUM_TOL * np.abs(want).max(), err


def test_scheduled_precision_and_checks(layouts):
    lay = layouts["rmat_K3"]
    args = _kernel_args(lay)
    msgs = _msgs(lay, 16, torch.float32)
    # "fast" rounds float32 messages to bf16 first, as the kernel's does
    fast = k2.banded_segment_sum_scheduled_plain(*args, msgs,
                                                 precision="fast")
    assert torch.equal(fast, k2.banded_segment_sum_scheduled_plain(
        *args, [m.bfloat16() for m in msgs]))
    with pytest.raises(ValueError):
        k2.banded_segment_sum_scheduled_plain(*args, msgs[:2])
    with pytest.raises(ValueError, match="precision"):
        k2.banded_segment_sum_scheduled_plain(*args, msgs, precision="x")
    # a layout with no real slot sums to zeros
    zero = [m[:0] for m in msgs]
    bounds = torch.zeros_like(args[0])
    offs2d = torch.zeros_like(args[1])
    out = k2.banded_segment_sum_scheduled_plain(bounds, offs2d, zero)
    assert out.shape == (lay.n_pad, 16) and not out.any()


def test_schedule_cached_reused_and_dropped_with_graph():
    g = GraphSlice.from_host(erdos_renyi(300, 2000, seed=7, undirected=True),
                             device="cpu")
    lay = tbanded.get_layout(g, "pull")
    d = lay.dev("cpu")
    assert lay.dev("cpu")["row_prefix"] is d["row_prefix"]
    assert torch.equal(d["row_prefix"], row_prefix(d["bounds"], d["offs2d"]))

    # the banded SpMM hands the cached schedule to the kernel's wrapper
    seen = []
    real = k2.banded_segment_sum
    mod = sys.modules["mini_tpu_torch.ops.spmm"]

    def spy(*args, **kw):
        seen.append(kw.get("row_prefix"))
        return real(*args, **kw)

    mod.banded_segment_sum = spy
    try:
        x = torch.rand(g.n_pad, 8, generator=torch.Generator().manual_seed(0))
        spmm(g, x, impl="banded")
        spmm(g, x, impl="banded")
    finally:
        mod.banded_segment_sum = real
    assert len(seen) == 2 and all(p is d["row_prefix"] for p in seen)

    ref = weakref.ref(d["row_prefix"])
    del d, lay, seen
    for s in range(tbanded.MAX_HOST_GRAPHS):  # evict the graph
        GraphSlice.from_host(erdos_renyi(50, 100, seed=1000 + s),
                             device="cpu")
    gc.collect()
    assert ref() is None


# -- the banded SDDMM's schedule (lane groups, heads, the scalar form) --------

DOT_TOL = 1e-5  # |scheduled - plain| <= DOT_TOL * (|y| . |msgs|) per slot


def _y(lay, F, dtype, seed=1):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.rand(lay.n_pad, F).astype(np.float32)
                            - 0.5).to(dtype)


def _assert_dots_close(args, msgs, y, H, got):
    """Every slot within DOT_TOL of the float64 dot, scaled by the slot's
    magnitude; pad slots exactly 0."""
    want = k2.banded_sddmm_plain(*args, msgs, y, heads=H)
    mag = k2.banded_sddmm_plain(*args, [m.abs() for m in msgs], y.abs(),
                                heads=H)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(((got - want).abs() / mag.clamp(min=1e-30)).max()) <= DOT_TOL
    assert torch.all(got[mag == 0] == 0)


@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,H", [(32, 1), (32, 2), (32, 4), (33, 1), (33, 3),
                                 (128, 1), (128, 2), (128, 4), (96, 3),
                                 (512, 2)])
@pytest.mark.parametrize("name", ["rmat_K3", "star", "empty_band"])
def test_sddmm_scheduled_matches_plain(layouts, name, F, H, dtype, ydt):
    """The kernel's order of operations, in the form its plan picks and in
    the scalar form, against the plain version."""
    lay = layouts[name]
    args = _kernel_args(lay)
    msgs, y = _msgs(lay, F, dtype), _y(lay, F, ydt)
    plan = k2._sddmm_plan_for(msgs, y, H)
    assert (plan == (0, 0)) == (F in (33, 512))  # the scalar form's widths
    for form in {plan, (0, 0)}:
        got = k2.banded_sddmm_scheduled_plain(*args, msgs, y, heads=H,
                                              plan=form)
        _assert_dots_close(args, msgs, y, H, got)


@pytest.mark.parametrize("F,H,elem,plan", [
    (128, 1, 4, (32, 32)),   # one float32 row a warp instruction
    (128, 2, 4, (32, 16)),   # GAT: two heads, two groups of 16 lanes
    (128, 1, 2, (16, 16)),   # two bf16 rows an instruction
    (128, 4, 2, (16, 4)),
    (32, 1, 4, (8, 8)),      # four rows an instruction
    (32, 4, 2, (4, 1)),      # a lane holds a whole head
    (96, 3, 4, (32, 8)),     # 24 of 32 lanes hold columns
    (96, 1, 4, (32, 32)),
    (96, 2, 4, (0, 0)),      # 12 lanes a head: no power of two
    (33, 1, 4, (0, 0)),      # no whole 16-byte vectors
    (256, 2, 4, (0, 0)),     # wider than 32 vectors
    (130, 1, 2, (0, 0)),
])
def test_sddmm_plan(F, H, elem, plan):
    assert k2.sddmm_plan(F, H, elem, True) == plan
    assert k2.sddmm_plan(F, H, elem, False) == (0, 0)  # unaligned pointers


def test_sddmm_slot_rows_match_the_layout(layouts):
    """The per-slot rows the wrapper builds when given none are the
    layout's cached ``seg`` (pad slots take the last row)."""
    for name in ("rmat_K3", "star", "empty_band"):
        lay = layouts[name]
        bounds, offs2d = _kernel_args(lay)
        dev = lay.dev("cpu")
        for k in range(lay.K):
            got = k2._slot_rows(bounds, offs2d, k, len(lay.ids[k]))
            assert got.dtype == torch.int32
            assert torch.equal(got, dev["seg"][k]), (name, k)


def fake_sddmm_launch(msg_ptrs, seg_ptrs, lens, K, bounds_p, y_p, out_p,
                      n_tiles, F, H, msg_dtype, y_dtype, lanes, head_lanes,
                      stream):
    """``csrc/spmm_banded.cu``'s banded_sddmm_launch in NumPy, on the host
    memory its pointers name: the entry's argument checks, then per real
    slot and head the dot of the message row with the row ``seg`` names."""
    import ctypes

    def mem(ptr, n, ct):
        return np.ctypeslib.as_array((ct * max(n, 1)).from_address(ptr))[:n]

    def rows(ptr, n, code):
        if code == 0:
            return mem(ptr, n * F, ctypes.c_float).reshape(n, F).astype(
                np.float64)
        raw = mem(ptr, n * F, ctypes.c_uint16).astype(np.uint32) << 16
        return raw.view(np.float32).reshape(n, F).astype(np.float64)

    V = 4 if msg_dtype == 0 else 8
    if lanes and (F % V or F > lanes * V or lanes % head_lanes or (
            head_lanes * V * H != F if H > 1 else head_lanes != lanes)):
        return 1
    bounds = mem(bounds_p, K * (n_tiles + 1), ctypes.c_int32).reshape(K, -1)
    y = rows(y_p, n_tiles * 128, y_dtype)
    out = mem(out_p, sum(lens[k] for k in range(K)) * H, ctypes.c_float)
    out = out.reshape(-1, H)
    out[:] = 0
    base = 0
    for k in range(K):
        if lens[k] % 32:
            return 1
        real = bounds[k, -1]
        seg = mem(seg_ptrs[k], lens[k], ctypes.c_int32)[:real]
        prod = rows(msg_ptrs[k], lens[k], msg_dtype)[:real] * y[seg]
        out[base: base + real] = prod.reshape(real, H, F // H).sum(-1)
        base += lens[k]
    return 0


@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,H", [(128, 1), (128, 2), (32, 4), (33, 3)])
def test_sddmm_launch_arguments(monkeypatch, layouts, F, H, dtype, ydt):
    """The launch path's arguments to the C entry (stream, row-id and length
    arrays, the plan, the dtype codes), with the entry emulated on CPU
    memory; with and without the layout's ``seg``; one launch counted."""
    from mini_tpu_torch.ops.kernels import _build
    from test_torch_gather import on_card

    monkeypatch.setattr(k2, "_sum_launch", object())
    monkeypatch.setattr(k2, "_sddmm_launch", fake_sddmm_launch)
    monkeypatch.setattr(k2, "_max_bands", 128)
    monkeypatch.setattr(_build, "stream", lambda device_index: 0)
    lay = layouts["rmat_K3"]
    args = _kernel_args(lay)
    msgs, y = _msgs(lay, F, dtype), _y(lay, F, ydt)
    card = [on_card(a) for a in args]
    for seg in (None, [on_card(s) for s in lay.dev("cpu")["seg"]]):
        before = k2.sddmm_launches
        got = k2.banded_sddmm(*card, [on_card(m) for m in msgs], on_card(y),
                              heads=H, seg=seg)
        assert k2.sddmm_launches == before + 1
        _assert_dots_close(args, msgs, y, H, got)
    with pytest.raises(ValueError, match="seg must be"):
        k2.banded_sddmm(*card, [on_card(m) for m in msgs], on_card(y),
                        heads=H, seg=[on_card(s.long())
                                      for s in lay.dev("cpu")["seg"]])


def fake_sum_launch(msg_ptrs, K, bounds_p, offs2d_p, prefix_p, out_p,
                    carry_p, n_tiles, F, dtype, vector, lanes, chunk,
                    n_walkers, fix_lanes, wt_ptrs, heads, table_p, band_rows,
                    stream):
    """``csrc/spmm_banded.cu``'s banded_segment_sum_launch on the host
    memory its pointers name: the entry's checks of the heads against the
    walker's form, then the walker and fix-up transcription on the real
    slots and their weights; with a table, on the rows of it that the id
    streams (``msg_ptrs``) name.  Records its arguments in ``calls``."""
    import ctypes

    def mem(ptr, n, ct):
        return np.ctypeslib.as_array((ct * max(n, 1)).from_address(ptr))[:n]

    def stream_of(ptr, n, cols):
        if dtype == 0:
            return torch.from_numpy(mem(ptr, n * cols, ctypes.c_float)
                                    .reshape(n, cols).copy())
        raw = mem(ptr, n * cols, ctypes.c_int16).reshape(n, cols).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)

    fake_sum_launch.calls.append(dict(vector=vector, lanes=lanes,
                                      chunk=chunk, fix_lanes=fix_lanes,
                                      heads=heads,
                                      weighted=wt_ptrs is not None,
                                      indexed=table_p is not None,
                                      band_rows=band_rows))
    V = (4 if dtype == 0 else 8) if vector else 1
    if heads < 1 or F % heads or (F // heads) % V:
        return 1
    bounds = torch.from_numpy(mem(bounds_p, K * (n_tiles + 1),
                                  ctypes.c_int32).reshape(K, -1).copy())
    offs2d = torch.from_numpy(mem(offs2d_p, n_tiles * K * 128,
                                  ctypes.c_int32).reshape(n_tiles, K, 128)
                              .copy())
    prefix = torch.from_numpy(mem(prefix_p, n_tiles * 128 + 1,
                                  ctypes.c_int32).copy())
    real = [int(b) for b in bounds[:, -1]]
    weights = None if wt_ptrs is None else [
        stream_of(wt_ptrs[k], real[k], heads) for k in range(K)]
    if table_p is None:
        msgs = [stream_of(msg_ptrs[k], real[k], F) for k in range(K)]
        got = _walk_like_the_kernel(bounds, offs2d, msgs, prefix, chunk,
                                    fix_lanes, weights, heads, lanes=lanes)
    else:
        ids = [torch.from_numpy(mem(msg_ptrs[k], real[k], ctypes.c_int32)
                                .copy()) for k in range(K)]
        n_src = 1 + max(k * band_rows + int(i.max()) for k, i in
                        enumerate(ids) if len(i))
        got = _walk_like_the_kernel(bounds, offs2d,
                                    stream_of(table_p, n_src, F), prefix,
                                    chunk, fix_lanes, weights, heads, ids,
                                    band_rows, lanes)
    out = mem(out_p, n_tiles * 128 * F, ctypes.c_float)
    out[:] = got.reshape(-1).numpy()
    return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,heads", [(40, None), (40, 1), (128, 4),
                                     (40, 4), (33, 3)])
def test_weighted_launch_arguments(monkeypatch, layouts, F, heads, dtype):
    """The launch path with weights: the weight pointers and heads reach
    the C entry (emulated on CPU memory), cast to the messages' dtype; a
    head width that splits a lane vector takes the scalar form on the
    vector form's chunk and fix-up lanes; the result is the scheduled
    emulation's, bit for bit; both counters move."""
    from mini_tpu_torch.ops.kernels import _build
    from test_torch_gather import on_card

    monkeypatch.setattr(k2, "_sum_launch", fake_sum_launch)
    monkeypatch.setattr(k2, "_sddmm_launch", object())
    monkeypatch.setattr(k2, "_max_bands", 128)
    monkeypatch.setattr(_build, "stream", lambda device_index: 0)
    monkeypatch.setattr(fake_sum_launch, "calls", [], raising=False)
    lay = layouts["star"]
    args = _kernel_args(lay)
    prefix = row_prefix(*args)
    msgs = _msgs(lay, F, dtype)
    w = None if heads is None else _weights(lay, heads)
    before = (k2.launches, k2.weighted_launches)
    got = k2.banded_segment_sum(
        *[on_card(a) for a in args], [on_card(m) for m in msgs],
        row_prefix=on_card(prefix),
        weights=None if w is None else [on_card(x) for x in w])
    assert (k2.launches, k2.weighted_launches) == (
        before[0] + 1, before[1] + (w is not None))
    assert torch.equal(got, k2.banded_segment_sum_scheduled_plain(
        *args, msgs, row_prefix=prefix, weights=w))
    call, = fake_sum_launch.calls
    rows = k2._vector_ok(msgs)
    lanes, chunk, fix_lanes = k2.kernel_plan(F, msgs[0].element_size(), rows)
    assert (call["chunk"], call["fix_lanes"]) == (chunk, fix_lanes)
    split = heads is not None and (F // heads) % (16 // msgs[0].element_size())
    assert call["vector"] == int(rows and not split)
    assert call["heads"] == (heads or 1)
    assert call["weighted"] == (w is not None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,heads", [(40, None), (40, 1), (128, 4),
                                     (40, 4), (33, 3)])
def test_indexed_launch_arguments(monkeypatch, layouts, F, heads, dtype):
    """The launch path of the indexed form: the table, its band height and
    the K id streams reach the C entry (emulated on CPU memory) in place
    of streams, with the stream form's plan for the same rows; the result
    is the stream form's scheduled emulation on the gathered streams, bit
    for bit; ``launches``, ``indexed_launches`` and ``scanned_launches``
    move (and ``weighted_launches`` with weights)."""
    from mini_tpu_torch.ops.kernels import _build
    from test_torch_gather import on_card

    monkeypatch.setattr(k2, "_sum_launch", fake_sum_launch)
    monkeypatch.setattr(k2, "_sddmm_launch", object())
    monkeypatch.setattr(k2, "_max_bands", 128)
    monkeypatch.setattr(_build, "stream", lambda device_index: 0)
    monkeypatch.setattr(fake_sum_launch, "calls", [], raising=False)
    lay = layouts["star"]
    args = _kernel_args(lay)
    prefix = row_prefix(*args)
    x = _table(lay, F, dtype)
    w = None if heads is None else _weights(lay, heads)
    before = (k2.launches, k2.weighted_launches, k2.indexed_launches,
              k2.scanned_launches)
    got = k2.banded_segment_sum(
        *[on_card(a) for a in args], on_card(x), row_prefix=on_card(prefix),
        weights=None if w is None else [on_card(v) for v in w],
        ids=[on_card(i) for i in _ids(lay)], band_rows=lay.band_rows)
    assert (k2.launches, k2.weighted_launches, k2.indexed_launches,
            k2.scanned_launches) == (
        before[0] + 1, before[1] + (w is not None), before[2] + 1,
        before[3] + 1)
    streams = _gather_then(lay, x)
    assert torch.equal(got, k2.banded_segment_sum_scheduled_plain(
        *args, streams, row_prefix=prefix, weights=w))
    call, = fake_sum_launch.calls
    rows = k2._vector_ok([x])
    assert rows == k2._vector_ok(streams)
    lanes, chunk, fix_lanes = k2.kernel_plan(F, x.element_size(), rows)
    assert (call["chunk"], call["fix_lanes"]) == (chunk, fix_lanes)
    split = heads is not None and (F // heads) % (16 // x.element_size())
    assert call["vector"] == int(rows and not split)
    assert (call["indexed"], call["band_rows"]) == (True, lay.band_rows)
    assert call["weighted"] == (w is not None)


def _wide_layout():
    """153 bands of 128 rows (19,501 rows padded to 19,584) over 3,000
    edges: past the 128 bands that the stream form takes."""
    rng = np.random.RandomState(4)
    n = 19_500
    lay = _pull_layout(from_edges(rng.randint(0, n, 3000),
                                  rng.randint(0, n, 3000), num_nodes=n), 128)
    assert lay.K == 153
    return lay


@pytest.mark.parametrize("heads", [None, 1, 4])
def test_wide_launch_arguments(monkeypatch, heads):
    """A layout of 153 bands through the indexed form's launch path: the
    153 id streams reach the C entry (emulated on CPU memory) under the
    indexed form's limit; the result is the stream form's scheduled
    emulation on the gathered streams bit for bit, and the plain sum within
    SUM_TOL; ``wide_launches`` counts the launch beside ``launches`` and
    ``indexed_launches``.  The stream form is refused past its 128 bands,
    the indexed form past its own limit."""
    from mini_tpu_torch.ops.kernels import _build
    from test_torch_gather import on_card

    monkeypatch.setattr(k2, "_sum_launch", fake_sum_launch)
    monkeypatch.setattr(k2, "_sddmm_launch", object())
    monkeypatch.setattr(k2, "_max_bands", 128)
    monkeypatch.setattr(k2, "_max_indexed_bands", 1024)
    monkeypatch.setattr(_build, "stream", lambda device_index: 0)
    monkeypatch.setattr(fake_sum_launch, "calls", [], raising=False)
    lay = _wide_layout()
    args = _kernel_args(lay)
    card = [on_card(a) for a in args]
    prefix = row_prefix(*args)
    x = _table(lay, 40, torch.float32)
    w = None if heads is None else _weights(lay, heads)
    kw = dict(row_prefix=on_card(prefix),
              weights=None if w is None else [on_card(v) for v in w])

    def indexed():
        return k2.banded_segment_sum(
            *card, on_card(x), ids=[on_card(i) for i in _ids(lay)],
            band_rows=lay.band_rows, **kw)

    before = (k2.launches, k2.indexed_launches, k2.wide_launches)
    got = indexed()
    assert (k2.launches, k2.indexed_launches, k2.wide_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    call, = fake_sum_launch.calls
    assert call["indexed"] and call["band_rows"] == 128
    streams = _gather_then(lay, x)
    assert torch.equal(got, k2.banded_segment_sum_scheduled_plain(
        *args, streams, row_prefix=prefix, weights=w))
    _assert_close(got, k2.banded_segment_sum_plain(
        *args, x, weights=w, ids=_ids(lay), band_rows=lay.band_rows))
    with pytest.raises(ValueError, match="153 bands exceed the kernel's "
                                         "128"):
        k2.banded_segment_sum(*card, [on_card(s) for s in streams], **kw)
    monkeypatch.setattr(k2, "_max_indexed_bands", 150)
    with pytest.raises(ValueError, match="153 bands exceed the kernel's "
                                         "150"):
        indexed()
    assert k2.wide_launches == before[2] + 1
