"""Port parity: segment reduces, engine movers and reduces, operators and
SpMM of ``mini_tpu_torch`` against ``mini_tpu`` on the same inputs (on the
CPU, where every kernel wrapper runs its plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
import mini_tpu.ops.engine as jengine
import mini_tpu.ops.operators as jops
from mini_tpu.ops.frontier import Frontier as JFrontier
from mini_tpu.ops.segment import segment_reduce as jsegment_reduce
from mini_tpu.ops.spmm import spmm as jspmm
import mini_tpu_torch.graph as tg
import mini_tpu_torch.ops.engine as tengine
import mini_tpu_torch.ops.operators as tops
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.ops.frontier import Frontier as TFrontier
from mini_tpu_torch.ops.segment import (
    contiguous_segment_sum,
    exclusive_cumsum,
    segment_reduce as tsegment_reduce,
)
from mini_tpu_torch.ops.spmm import spmm as tspmm

from test_torch_graph import build

GRAPHS = ["tiny", "random", "random_directed"]


@pytest.fixture(scope="module", params=GRAPHS)
def slices(request):
    """(JAX GraphSlice, port GraphSlice) of the same graph."""
    return (jg.GraphSlice.from_host(build(jg, request.param)),
            tg.GraphSlice.from_host(build(tg, request.param), device="cpu"))


def t(a):
    return torch.from_numpy(np.array(a))


def eq(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["sum", "min", "max", "or"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_segment_reduce_matches(slices, op, dtype):
    gj, gt = slices
    rng = np.random.RandomState(1)
    if op == "or":
        vals = rng.rand(gt.m_pad) < 0.3
    elif dtype == "int32":
        vals = rng.randint(-1000, 1000, gt.m_pad).astype(np.int32)
    else:
        vals = (rng.rand(gt.m_pad) * 10 - 5).astype(np.float32)
    mask = np.asarray(gj.edge_mask_csc)
    want = jsegment_reduce(jnp.asarray(vals), gj.csc_dsts, gj.n_pad, op,
                           mask=jnp.asarray(mask))
    got = tsegment_reduce(t(vals), gt.csc_dsts, gt.n_pad, op, mask=t(mask))
    if op == "sum" and dtype == "float32":
        # float sums in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    else:
        eq(want, got)


def test_segment_helpers(slices):
    gj, gt = slices
    rng = np.random.RandomState(2)
    vals = rng.randint(0, 50, (gt.m_pad, 3)).astype(np.int32)
    got = contiguous_segment_sum(t(vals), gt.col_offsets)
    want = tsegment_reduce(t(vals), gt.csc_dsts, gt.n_pad, "sum")
    assert torch.equal(got, want)
    x = t(vals[:, 0])
    assert torch.equal(exclusive_cumsum(x)[1:], torch.cumsum(x, 0)[:-1]
                       .to(torch.int32))


def test_engine_movers_match(slices):
    gj, gt = slices
    rng = np.random.RandomState(3)
    vi = rng.randint(-100, 100, gt.n_pad).astype(np.int32)
    vf = rng.rand(gt.n_pad).astype(np.float32)
    for fn in ("src_vals_to_csc", "dst_vals_to_csc", "src_vals_to_csr",
               "dst_vals_to_csr"):
        for v in (vi, vf):
            eq(getattr(jengine, fn)(gj, jnp.asarray(v)),
               getattr(tengine, fn)(gt, t(v)))
    for fn in ("src_vals_to_csc", "dst_vals_to_csr"):  # extra payloads
        wi, wf = getattr(jengine, fn)(gj, jnp.asarray(vi), jnp.asarray(vf))
        ti, tf = getattr(tengine, fn)(gt, t(vi), t(vf))
        eq(wi, ti)
        eq(wf, tf)


@pytest.mark.parametrize("order", ["csc", "csr"])
def test_engine_reduces_match(slices, order):
    gj, gt = slices
    jred = jengine.reduce_csc_by_dst if order == "csc" \
        else jengine.reduce_csr_by_src
    tred = tengine.reduce_csc_by_dst if order == "csc" \
        else tengine.reduce_csr_by_src
    rng = np.random.RandomState(4)
    bits = rng.rand(gt.m_pad) < 0.2
    vi = rng.randint(-1000, 1000, gt.m_pad).astype(np.int32)
    vf = (rng.rand(gt.m_pad) * 10 - 5).astype(np.float32)
    eq(jred(gj, jnp.asarray(bits), "or"), tred(gt, t(bits), "or"))
    for op in ("sum", "min", "max"):
        eq(jred(gj, jnp.asarray(vi), op), tred(gt, t(vi), op))
    for op in ("min", "max"):
        eq(jred(gj, jnp.asarray(vf), op), tred(gt, t(vf), op))
    eq(jred(gj, jnp.asarray(vi), "min", identity=-7),
       tred(gt, t(vi), "min", identity=-7))
    # float sums in another order
    np.testing.assert_allclose(tred(gt, t(vf), "sum").numpy(),
                               jred(gj, jnp.asarray(vf), "sum"),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", ["push", "pull"])
def test_advance_matches(slices, direction):
    gj, gt = slices
    rng = np.random.RandomState(5)
    for _ in range(3):
        fr = rng.rand(gt.n_pad) < 0.3
        keep = rng.rand(gt.m_pad) < 0.7
        nj, _, aj = jops.advance(gj, JFrontier(jnp.asarray(fr)),
                                 cond=lambda ev: jnp.asarray(keep),
                                 direction=direction)
        nt, ev, at = tops.advance(gt, TFrontier(t(fr)),
                                  cond=lambda ev: t(keep),
                                  direction=direction)
        eq(nj.mask, nt.mask)
        eq(aj, at)
    eq(jops.edges_by_dst(gj).rank, ev.rank)
    eq(jops.edges_by_src(gj).eid, tops.edges_by_src(gt).eid)


def test_apply_filter_compute_match(slices):
    gj, gt = slices
    rng = np.random.RandomState(6)
    active = rng.rand(gt.m_pad) < 0.5
    vals = rng.randint(0, 1000, gt.m_pad).astype(np.int32)
    eq(jops.apply_to_dst(gj, jops.edges_by_dst(gj), jnp.asarray(active),
                         jnp.asarray(vals), "min"),
       tops.apply_to_dst(gt, tops.edges_by_dst(gt), t(active), t(vals),
                         "min"))
    fr = rng.rand(gt.n_pad) < 0.5
    pred = rng.rand(gt.n_pad) < 0.5
    state = rng.randint(0, 9, gt.n_pad).astype(np.int32)
    eq(jops.filter_frontier(JFrontier(jnp.asarray(fr)),
                            jnp.asarray(pred)).mask,
       tops.filter_frontier(TFrontier(t(fr)), t(pred)).mask)
    eq(jops.compute(JFrontier(jnp.asarray(fr)), lambda s: s * 3 + 1,
                    jnp.asarray(state)),
       tops.compute(TFrontier(t(fr)), lambda s: s * 3 + 1, t(state)))
    idx = np.array([3, -1, 0, gt.n_pad + 5, 3], np.int32)
    eq(JFrontier.from_indices(jnp.asarray(idx), gt.n_pad).mask,
       TFrontier.from_indices(t(idx), gt.n_pad).mask)
    assert int(TFrontier.full(gt.n_pad, gt.n, device="cpu").size()) == gt.n
    assert not TFrontier.empty(gt.n_pad, device="cpu").mask.any()


@pytest.fixture
def two_bands(monkeypatch):
    """Shrink the band-height table so a 256-row graph splits into K=2
    bands of 128 rows at F <= 128."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)


@pytest.mark.parametrize("impl", ["xla", "banded"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_spmm_matches(two_bands, impl, direction):
    gj = jg.GraphSlice.from_host(build(jg, "random_directed"))
    gt = tg.GraphSlice.from_host(build(tg, "random_directed"), device="cpu")
    if impl == "banded":
        assert tbanded.get_layout(gt, direction, row_bytes=512).K == 2
    rng = np.random.RandomState(7)
    for F in (128, 32):
        x = (rng.rand(gt.n_pad, F) - 0.5).astype(np.float32)
        want = np.asarray(jspmm(gj, jnp.asarray(x), direction=direction,
                                impl="xla"))
        got = tspmm(gt, t(x), direction=direction, impl=impl)
        assert got.dtype == torch.float32 and got.shape == want.shape
        # float32 sums in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a weight override (in the direction's edge order), and a 1-D x
    w = rng.rand(gt.m_pad).astype(np.float32)
    want = np.asarray(jspmm(gj, jnp.asarray(x[:, 0]), direction=direction,
                            weights=jnp.asarray(w), impl="xla"))
    got = tspmm(gt, t(x[:, 0]), direction=direction, weights=t(w),
                impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_spmm_banded_weights_and_precision(two_bands):
    gt = tg.GraphSlice.from_host(build(tg, "random"), device="cpu")
    lay = tbanded.get_layout(gt, "pull", row_bytes=512)
    rng = np.random.RandomState(8)
    x = t((rng.rand(gt.n_pad, 64) - 0.5).astype(np.float32))
    w = t(rng.rand(gt.m_pad).astype(np.float32))
    ref = tspmm(gt, x, weights=w, impl="xla")
    # pre-banded weights come masked (pad edges 0), as gcn_normalize's
    w_banded = lay.permute_to_bands(torch.where(gt.edge_mask_csc, w, 0))
    pre = tspmm(gt, x, weights_banded=w_banded, impl="banded")
    np.testing.assert_allclose(pre.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    # bf16 messages: about 3 significant digits
    fast = tspmm(gt, x, weights=w, impl="banded", precision="fast")
    assert fast.dtype == torch.float32
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=3e-2,
                               atol=3e-2)
    raw = tg.GraphSlice(**{f: getattr(gt, f) for f in
                           gt._DATA_FIELDS + gt._META_FIELDS
                           if f != "fingerprint"})
    with pytest.raises(ValueError, match="no banded layout"):
        tspmm(raw, x, impl="banded")
