"""The contiguous-segment reduce of ``mini_tpu_torch`` with ``[m, H]``
values and over the K bands of a banded layout, on the CPU.

The CUDA kernel (csrc/segreduce.cu) cannot run here, so it is reached
three ways.  The plain versions, which a CPU tensor takes, are held against
the JAX package on the same numpy-seeded arrays: ``segment_reduce_pallas``
in interpret mode under ``jax.jit``, column by column, and
``mini_tpu.ops.spmm.banded_heads_segment_sum``, the per-band scan of GAT's
native backward.  ``segment_reduce_scheduled_plain``, the kernel's schedule
in plain torch (chunks, lanes, the scan over the lanes, carries and the
fix-up), is held against the plain versions on offsets drawn by hypothesis,
with empty segments, a hub and a ghost segment of pad values.  And the
launch path runs with the C entries emulated in NumPy on the host memory
their pointers name, on CPU tensors that say they are CUDA ones.

Tolerances: min, max, bor and the int32 sum are bitwise.  A float32 sum of
the same terms in another order, or in float64 rounded once, differs by
float32 rounding: ``SUM_TOL = 1e-5`` of the largest reference value, the
bound ``chip_smoke.py`` holds the kernel to.
"""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import mini_tpu.graph as jg
from mini_tpu.graph import banded as jbanded
from mini_tpu.ops.pallas.segreduce_kernel import segment_reduce_pallas
from mini_tpu.ops.spmm import banded_heads_segment_sum as j_heads_sum
import mini_tpu_torch.graph as tg
import mini_tpu_torch.ops.engine as tengine
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.ops.kernels import _build
from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
from mini_tpu_torch.ops.spmm import banded_heads_segment_sum as t_heads_sum

from test_torch_gather import on_card

SUM_TOL = 1e-5  # max |got - want| <= SUM_TOL * max |want|
N_PAD, M_PAD = 256, 1024
CASES = [("min", np.int32), ("max", np.int32), ("sum", np.int32),
         ("bor", np.int32), ("min", np.float32), ("max", np.float32),
         ("sum", np.float32)]


def _values(rng, shape, dtype):
    if dtype == np.float32:
        return (rng.rand(*shape) * 100 - 50).astype(np.float32)
    return rng.randint(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(
        np.int32)


def _hub_segments(seed):
    """Hub-heavy sorted segment ids (one vertex owns half the values) with
    empty segments, and their offsets (tests/test_torch_kernels.py's)."""
    rng = np.random.RandomState(seed)
    parts = np.concatenate(
        [np.full(M_PAD // 2, 17), rng.randint(0, N_PAD, M_PAD // 2)])
    dsts = np.sort(parts).astype(np.int32)
    offsets = np.searchsorted(dsts, np.arange(N_PAD + 1)).astype(np.int32)
    assert (np.diff(offsets) == 0).any()
    return rng, offsets, dsts


def _assert_reduced(got, want, op, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    if op == "sum" and dtype == np.float32:
        assert np.abs(got - want).max() <= SUM_TOL * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _pallas(op):
    return jax.jit(functools.partial(segment_reduce_pallas, op=op,
                                     interpret=True))


@pytest.mark.parametrize("H", [2, 5])
@pytest.mark.parametrize("op,dtype", CASES)
def test_columns_match_pallas(op, dtype, H):
    """``[m, H]`` values through the wrapper (the plain version on the CPU)
    against the Pallas twin, which takes one column a call."""
    rng, offsets, dsts = _hub_segments(seed=11 + H)
    vals = _values(rng, (M_PAD, H), dtype)
    want = np.stack([np.asarray(_pallas(op)(
        jnp.asarray(offsets), jnp.asarray(dsts), jnp.asarray(vals[:, h])))
        for h in range(H)], axis=-1)
    before = k1.launches
    got = k1.segment_reduce(torch.from_numpy(offsets), torch.from_numpy(dsts),
                            torch.from_numpy(vals), op)
    assert k1.launches == before  # a CPU tensor launches nothing
    assert got.shape == (N_PAD, H)
    _assert_reduced(got.numpy(), want, op, dtype)


def test_bad_arguments():
    _, offsets, dsts = _hub_segments(seed=1)
    o, d = torch.from_numpy(offsets), torch.from_numpy(dsts)
    with pytest.raises(ValueError, match="columns"):
        k1.segment_reduce(o, d, torch.zeros(M_PAD, 9), "sum")
    with pytest.raises(ValueError):
        k1.segment_reduce(o, d, torch.zeros(M_PAD, 2, 2), "sum")
    with pytest.raises(TypeError, match="bor"):
        k1.segment_reduce(o, d, torch.zeros(M_PAD, 2), "bor")
    with pytest.raises(TypeError):
        k1.segment_reduce(o, d, torch.zeros(M_PAD, 2).double(), "sum")
    with pytest.raises(ValueError, match="unknown op"):
        k1.segment_reduce(o, d, torch.zeros(M_PAD), "prod")
    with pytest.raises(ValueError, match="streams"):
        k1.segment_reduce_bands([o], [torch.zeros(M_PAD)])
    with pytest.raises(ValueError, match="offset arrays"):
        k1.segment_reduce_bands([o, o], [torch.zeros(M_PAD, 2)])
    with pytest.raises(ValueError, match="share"):
        k1.segment_reduce_bands([o, o], [torch.zeros(M_PAD, 2),
                                         torch.zeros(M_PAD, 3)])


@pytest.mark.parametrize("order", ["csc", "csr"])
def test_engine_reduces_columns_in_one_call(order, monkeypatch):
    """``reduce_csc_by_dst`` / ``reduce_csr_by_src`` hand ``[m, H]`` values
    to the kernel wrapper whole (up to 8 columns a call), and give what the
    column-by-column reduce gives, identity included."""
    gt = tg.GraphSlice.from_host(
        tg.erdos_renyi(150, 900, seed=7, undirected=False, weighted=True),
        device="cpu")
    red = tengine.reduce_csc_by_dst if order == "csc" \
        else tengine.reduce_csr_by_src
    calls = []
    real = k1.segment_reduce
    monkeypatch.setattr(tengine, "segment_reduce",
                        lambda *a, **k: calls.append(a[2].shape) or real(
                            *a, **k))
    rng = np.random.RandomState(3)
    for H in (2, 8, 11):
        vf = torch.from_numpy((rng.rand(gt.m_pad, H) * 10 - 5).astype(
            np.float32))
        vi = torch.from_numpy(rng.randint(-99, 99, (gt.m_pad, H)).astype(
            np.int32))
        for vals, op, ident in ((vf, "sum", None), (vf, "max", 0.0),
                                (vi, "min", -7), (vi, "sum", None),
                                (vi > 0, "or", None)):
            calls.clear()
            got = red(gt, vals, op, identity=ident)
            assert [c[1] for c in calls] == ([H] if H <= 8 else [8, H - 8])
            want = torch.stack([red(gt, vals[:, h].contiguous(), op,
                                    identity=ident) for h in range(H)], -1)
            assert got.dtype == want.dtype and torch.equal(got, want)


# -- the K-band entry against JAX's heads sum ---------------------------------


@pytest.mark.parametrize("H", [1, 2, 4])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_heads_sum_matches_jax(monkeypatch, direction, H):
    """``banded_heads_segment_sum`` (K=3 bands of 128 rows): the plain K-band
    reduce against JAX's per-band segmented scan on the same bands."""
    small = 128 * 128 * 4
    monkeypatch.setattr(jbanded, "FAST_TABLE_BYTES", small)
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", small)
    kw = dict(seed=4, undirected=True)
    hg = tg.erdos_renyi(300, 2400, **kw)
    gj = jg.GraphSlice.from_host(jg.erdos_renyi(300, 2400, **kw))
    gt = tg.GraphSlice.from_host(hg, device="cpu")
    lj = jbanded.get_layout(gj, direction, row_bytes=512)
    lt = tbanded.get_layout(gt, direction, row_bytes=512)
    assert lt.K == lj.K == 3
    rng = np.random.RandomState(H)
    bands = [(rng.rand(len(i), H) - 0.5).astype(np.float32) * v[:, None]
             for i, v in zip(lt.ids, lt.valid)]  # pad slots carry zeros
    deg = hg.in_degrees if direction == "pull" else hg.out_degrees
    want = np.asarray(j_heads_sum(lj, [jnp.asarray(b) for b in bands],
                                  int(deg.max())))
    before = k1.launches
    got = t_heads_sum(lt, [torch.from_numpy(b) for b in bands])
    assert k1.launches == before
    assert got.dtype == torch.float32 and got.shape == (gt.n_pad, H)
    assert np.abs(got.numpy() - want).max() <= SUM_TOL * np.abs(want).max()


# -- the kernel's schedule, emulated ------------------------------------------


@st.composite
def streams(draw):
    """K offset arrays over n segments and their row counts: random cuts
    with empty segments at both ends, optionally a hub that takes half the
    rows (it crosses several chunks) and a ghost tail of pad rows past the
    last segment end."""
    n = draw(st.integers(1, 400))
    K = draw(st.integers(1, 3))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(K):
        m = draw(st.integers(0, 3000))
        empty_head = draw(st.integers(0, min(3, n - 1)))
        empty_tail = draw(st.integers(0, min(3, n - 1 - empty_head)))
        cuts = np.sort(rng.randint(0, m + 1, n - 1 - empty_head - empty_tail))
        if draw(st.booleans()) and cuts.size > 2:  # a hub
            lo = cuts.size // 3
            cuts[lo + 1: lo + 1 + cuts.size // 2] = cuts[lo + 1]
            cuts = np.sort(cuts)
        offs = np.concatenate([np.zeros(1 + empty_head, np.int64), cuts,
                               np.full(1 + empty_tail, m)]).astype(np.int32)
        assert offs.shape == (n + 1,)
        out.append((offs, m + draw(st.integers(0, 600))))  # the ghost tail
    return out, seed


@pytest.mark.parametrize("op,dtype", CASES)
@settings(max_examples=30, deadline=None)
@given(data=streams(), H=st.integers(1, 8))
def test_scheduled_matches_plain(op, dtype, data, H):
    (bands, seed) = data
    rng = np.random.RandomState(seed)
    offsets = [torch.from_numpy(o) for o, _ in bands]
    vals = [torch.from_numpy(_values(rng, (rows, H), dtype))
            for _, rows in bands]
    ident = {"min": 3, "max": -3, "sum": 1, "bor": 5}[op] if seed % 2 else None
    got = k1.segment_reduce_scheduled_plain(offsets, vals, op, ident)
    want = k1.segment_reduce_bands_plain(offsets, vals, op, ident)
    _assert_reduced(got.numpy(), want.numpy(), op, dtype)
    if len(bands) == 1:  # the one-stream wrapper's plain version
        seg = k1._segment_ids(offsets[0]).int()
        one = k1.segment_reduce_plain(offsets[0], seg,
                                      vals[0][: seg.numel()], op, ident)
        _assert_reduced(got.numpy(), one.numpy(), op, dtype)


@pytest.mark.parametrize("H", [1, 2, 3, 8])
def test_scheduled_star_and_order(H):
    """One segment of 9,999 values (the hub case: it crosses every chunk
    and its carries span more than the fix-up's 32 lanes at H = 8), 1-D
    values in and out, and a sum whose value depends on the order: the
    emulation adds in float32 in the kernel's order, so it is close to, and
    in general not equal to, the float64 sum."""
    n, m = 40, 9999
    offs = torch.zeros(n + 1, dtype=torch.int32)
    offs[4:] = m
    rng = np.random.RandomState(H)
    vals = torch.from_numpy((rng.rand(m + 13, H) * 100 - 50).astype(
        np.float32))
    got = k1.segment_reduce_scheduled_plain([offs], [vals], "sum")
    want = k1.segment_reduce_bands_plain([offs], [vals], "sum")
    assert got.shape == (n, H) and torch.all(got[:3] == 0) \
        and torch.all(got[4:] == 0)
    assert float((got - want).abs().max()) <= SUM_TOL * float(
        want.abs().max())
    assert -(-m // k1.chunk_rows(H)) > (32 if H == 8 else 1)
    flat = k1.segment_reduce_scheduled_plain([offs], [vals[:, 0]], "sum")
    assert flat.shape == (n,) and torch.equal(flat, (
        got[:, 0] if H == 1 else k1.segment_reduce_scheduled_plain(
            [offs], [vals[:, :1].contiguous()], "sum")[:, 0]))


def test_chunk_sizes():
    """A lane's values are a whole number of 16-byte loads, 16 values where
    the column count allows."""
    for H in range(1, k1.MAX_COLS + 1):
        E = k1.rows_per_lane(H)
        assert (E * H) % 4 == 0 and k1.chunk_rows(H) == 32 * E
        assert E * H == 16 or H in (3, 5, 6, 7)


# -- the launch path, the C entries emulated ----------------------------------

_NP_FOLD = {0: np.minimum, 1: np.maximum, 2: np.add, 3: np.bitwise_or}


def _mem(ptr, n, ct):
    if n == 0:  # an empty tensor's pointer is null
        return np.empty(0, ct)
    return np.ctypeslib.as_array((ct * n).from_address(ptr))


def fake_bands_launch(offs_ptrs, seg_ptrs, val_ptrs, rows, K, n, H, dtype,
                      op, ident_f, ident_i, out_p, part_p, carry_p, n_chunks,
                      stream):
    """``csrc/segreduce.cu``'s segreduce_bands_launch in NumPy, on the host
    memory its pointers name: the argument checks of the C entry, then a
    per-segment fold, bands in order, then the identity.  A stream's row
    segments must be the ones its offsets give."""
    ct = ctypes.c_int32 if dtype == 0 else ctypes.c_float
    C = k1.chunk_rows(H)
    if n_chunks != sum(-(-rows[k] // C) for k in range(K)):
        return 1
    if any((val_ptrs[k] or 0) % 16 for k in range(K)):
        return 1
    for k in range(K):
        if not seg_ptrs[k]:  # an empty tensor's pointer is null
            if rows[k]:
                return 1
            continue
        offs = _mem(offs_ptrs[k], n + 1, ctypes.c_int32)
        ids = _mem(seg_ptrs[k], rows[k], ctypes.c_int32)[: offs[n]]
        if not np.array_equal(ids, np.repeat(np.arange(n), np.diff(offs))):
            return 1
    fold = _NP_FOLD[op]
    ident = ident_i if dtype == 0 else ident_f
    out = _mem(out_p, n * H, ct).reshape(n, H)
    with np.errstate(over="ignore"):
        for v in range(n):
            acc = None
            for k in range(K):
                offs = _mem(offs_ptrs[k], n + 1, ctypes.c_int32)
                vals = _mem(val_ptrs[k], rows[k] * H, ct).reshape(rows[k], H)
                for row in vals[offs[v]: offs[v + 1]]:
                    acc = row.copy() if acc is None else fold(acc, row)
            full = np.full(H, ident, out.dtype)
            out[v] = full if acc is None else fold(full, acc)
    _mem(carry_p, max(n_chunks, 1) * 2 * H, ct)[:] = 0  # the scratch exists
    return 0


def fake_launch(offsets, dsts, vals, rows, n, H, dtype, op, ident_f, ident_i,
                out_p, carry_p, n_chunks, stream):
    """segreduce_launch: one stream, out as its own scratch."""
    return fake_bands_launch([offsets], [dsts], [vals], [rows], 1, n, H,
                             dtype, op, ident_f, ident_i, out_p, out_p,
                             carry_p, n_chunks, stream)



@pytest.fixture
def faked(monkeypatch):
    monkeypatch.setattr(k1, "_launch", fake_launch)
    monkeypatch.setattr(k1, "_bands_launch", fake_bands_launch)
    monkeypatch.setattr(k1, "_max_bands", 128)
    monkeypatch.setattr(_build, "stream", lambda device_index: 0)


@pytest.mark.parametrize("H", [None, 1, 2, 7])
@pytest.mark.parametrize("op,dtype", CASES)
def test_launch_arguments(faked, op, dtype, H):
    """The one-stream launch path's arguments (pointers, sizes, codes, the
    identity, the carry's size): the emulated entry gives the plain
    version's result, and one launch is counted."""
    rng = np.random.RandomState(5)
    m, n = 777, 60
    dsts = np.sort(rng.randint(2, n - 2, m)).astype(np.int32)
    offsets = np.searchsorted(dsts, np.arange(n + 1)).astype(np.int32)
    vals = torch.from_numpy(_values(rng, (m,) if H is None else (m, H),
                                    dtype))
    o, d = torch.from_numpy(offsets), torch.from_numpy(dsts)
    # row segments that are not int32 ids of every row are built from the
    # offsets in the call; the emulated entry refuses wrong ones
    for ident, ids in ((None, d), (4, d), (4, d.long()), (None, d[:-1]),
                       (None, None)):
        before = k1.launches
        got = k1.segment_reduce(on_card(o), ids if ids is None else
                                on_card(ids), on_card(vals), op, ident)
        assert k1.launches == before + 1
        want = k1.segment_reduce_plain(o, d, vals, op, ident)
        _assert_reduced(got.numpy(), want.numpy(), op, dtype)
    with pytest.raises(TypeError, match="int32"):
        k1.segment_reduce(on_card(o.long()), on_card(d), on_card(vals), op)
    with pytest.raises(RuntimeError, match="cannot carry gradients"):
        k1.segment_reduce(on_card(o), on_card(d),
                          on_card(vals.float()).requires_grad_(), "sum")


def test_launch_takes_a_stream_of_no_rows(faked):
    """An empty band (its tensors' pointers are null) among full ones, and
    alone: every segment gets the identity."""
    o = torch.tensor([0, 3, 3, 10], dtype=torch.int32)
    d = torch.tensor([0] * 3 + [2] * 7, dtype=torch.int32)
    v = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    none = torch.zeros(4, dtype=torch.int32)
    got = k1.segment_reduce_bands(
        [on_card(o), on_card(none)], [on_card(v), on_card(v[:0])],
        seg=[on_card(d), on_card(d[:0])])
    assert got.tolist() == [[6, 9], [0, 0], [84, 91]]
    empty = k1.segment_reduce(on_card(none), on_card(d[:0]),
                              on_card(v[:0, 0]), "max", -1.0)
    assert empty.tolist() == [-1, -1, -1]


def test_launch_moves_unaligned_values(faked):
    """A view into the middle of a storage is not 16-byte aligned: the
    wrapper copies it, the entry refuses it."""
    o = torch.tensor([0, 3, 3, 10], dtype=torch.int32)
    d = torch.tensor([0] * 3 + [2] * 7, dtype=torch.int32)
    store = torch.arange(11, dtype=torch.int32)
    vals = store[1:]
    assert vals.data_ptr() % 16
    got = k1.segment_reduce(on_card(o), on_card(d), on_card(vals), "sum")
    assert got.tolist() == [6, 0, 49]
    assert fake_launch(o.data_ptr(), d.data_ptr(), vals.data_ptr(), 10, 3, 1,
                       0, 2, 0.0, 0, got.data_ptr(), 0, 1, 0) == 1


@pytest.mark.parametrize("op,dtype", [("sum", np.float32), ("max", np.int32),
                                      ("bor", np.int32)])
@pytest.mark.parametrize("K,H", [(1, 2), (3, 2), (4, 5)])
def test_bands_launch_arguments(faked, K, H, op, dtype):
    """The K-band launch path: K offset and value pointers, the rows, the
    scratch sizes; one launch for all bands and columns."""
    rng = np.random.RandomState(K * 10 + H)
    n = 50
    offsets, vals = [], []
    for k in range(K):
        m = 300 + 111 * k
        dsts = np.sort(rng.randint(0, n, m))
        offsets.append(torch.from_numpy(np.searchsorted(
            dsts, np.arange(n + 1)).astype(np.int32)))
        vals.append(torch.from_numpy(_values(rng, (m + 20 * k, H), dtype)))
    want = k1.segment_reduce_bands_plain(offsets, vals, op)
    ids = [torch.cat([k1._segment_ids(o).int(),
                      torch.full((v.shape[0] - int(o[-1]),), n - 1,
                                 dtype=torch.int32)])
           for o, v in zip(offsets, vals)]  # pad rows take the last segment
    for seg in (None, [on_card(i) for i in ids]):
        before = k1.launches
        got = k1.segment_reduce_bands([on_card(o) for o in offsets],
                                      [on_card(v) for v in vals], op, seg=seg)
        assert k1.launches == before + 1
        _assert_reduced(got.numpy(), want.numpy(), op, dtype)
    with pytest.raises(ValueError, match="row-segment arrays"):
        k1.segment_reduce_bands([on_card(o) for o in offsets],
                                [on_card(v) for v in vals], op,
                                seg=[on_card(ids[0])] * (K + 1))
    with pytest.raises(ValueError, match="exceed"):
        k1.segment_reduce_bands([on_card(offsets[0])] * 129,
                                [on_card(vals[0])] * 129, op)


def test_heads_sum_is_one_launch(faked, monkeypatch):
    """``banded_heads_segment_sum`` on card tensors launches kernel 1 once
    for K=3 bands and 2 heads (a launch per band and head made 6).  GAT's
    banded layer calls it three times a layer (``models/gat.py``: the
    softmax denominators in the forward; ``ds_dst`` off the pull bands and
    ``ds_src`` off the push bands in the backward), so a 2-layer step
    launches kernel 1 six times; ``chip_smoke.py`` asserts that count on
    the card, where the step's other kernels run too."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)
    gt = tg.GraphSlice.from_host(
        tg.erdos_renyi(300, 2400, seed=4, undirected=True), device="cpu")
    lay = tbanded.get_layout(gt, "pull", row_bytes=512)
    assert lay.K == 3
    rng = np.random.RandomState(0)
    bands = [torch.from_numpy((rng.rand(len(i), 2) - 0.5).astype(np.float32))
             for i in lay.ids]
    want = t_heads_sum(lay, bands)
    before = k1.launches
    got = t_heads_sum(lay, [on_card(b) for b in bands])
    assert k1.launches == before + 1
    assert float((got - want).abs().max()) <= SUM_TOL * float(
        want.abs().max())


def test_cuda_bands_call_without_nvcc_raises(monkeypatch, tmp_path):
    """The K-band entry on a CUDA tensor launches or raises: with no nvcc
    the build fails and the error reaches the caller."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(k1, "_launch", None)
    o = torch.tensor([0, 2, 4], dtype=torch.int32)
    v = torch.ones(4, 2)
    before = k1.launches
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        k1.segment_reduce_bands([on_card(o)], [on_card(v)])
    assert k1.launches == before
