"""Kernel 2 (``banded_segment_sum``) scaling the messages by their edge
weights, against the SpMM's unfused route: the band gathers, a weighted
copy of every stream (``_weigh``), then kernel 2 without weights.  The two
must agree bit for bit, in float32 and bf16, with and without heads, down
to a GCN and a GAT train step's loss, gradients and new parameters.

Kernel 2 also reads its messages' rows of ``x`` by the layout's ids (the
indexed form, ``ops.spmm._apply_banded``'s), in place of the band
gathers' streams: the two forms agree bit for bit at GCN and GAT layouts,
and the route to kernel 2 gathers no band (the SDDMM's route still does).

The CPU tests reach both routes through the plain versions; the tests
marked ``cuda`` run the kernel on the card and skip without one:

    python -m pytest tests/test_torch_fused_weights.py -m cuda -q

This file imports no JAX: the card's tests compare within the port.
"""

import importlib

import numpy as np
import pytest
import torch

from mini_tpu_torch.graph import GraphSlice, from_edges, rmat
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.graph.banded import layout_for
from mini_tpu_torch.models import gat as gat_mod
from mini_tpu_torch.models.gcn import (
    gcn_init, gcn_init_opt, gcn_normalize, gcn_train_step,
)
from mini_tpu_torch.ops.kernels import spmm_banded as k2

# the module (the package exports its function under the same name)
spmm_mod = importlib.import_module("mini_tpu_torch.ops.spmm")

ARXIV_N, ARXIV_M = 169_343, 2_332_486  # ogbn-arxiv's vertices, edges
GCN_DIMS = [128, 256, 256, 40]  # OGB's example GCN on ogbn-arxiv


def unfused_sum(bounds, offs2d, msgs, *args, weights=None, **kw):
    """Kernel 2 as it was called before it took weights: on the weighted
    copy ``_weigh`` of each stream, without weights."""
    if weights is not None:
        heads = 1 if weights[0].ndim == 1 else weights[0].shape[1]
        msgs = [spmm_mod._weigh(m, w, heads) for m, w in zip(msgs, weights)]
    return k2.banded_segment_sum(bounds, offs2d, msgs, *args, **kw)


def unfused(x, layout, w_list, precision):
    """The SpMM's route before kernel 2 took weights: the band gathers,
    the weighted copies, kernel 2 without weights."""
    bands = spmm_mod._gather_bands(x, layout, precision)
    dev = layout.dev(x.device)
    return unfused_sum(
        dev["bounds"], dev["offs2d"], bands, precision=precision,
        edge_chunk=layout.edge_chunk, row_prefix=dev["row_prefix"],
        weights=w_list)


def _layout(g, F):
    """The pull layout the banded SpMM picks for F columns."""
    return layout_for(g, "pull", F)


def _routes_agree(g, F, heads, dtype, seed):
    """``_apply_banded`` (fused) and :func:`unfused` on the same x and
    banded weights: equal bits; the launches they add."""
    gen = torch.Generator().manual_seed(seed)
    layout = _layout(g, F)
    x = (torch.rand(layout.n_pad, F, generator=gen) - 0.5).to(
        device=g.device, dtype=dtype)
    w = torch.rand(g.m_pad, *((heads,) if heads > 1 else ()),
                   generator=gen).to(g.device)
    w_bands = layout.permute_to_bands(w)
    before = (k2.launches, k2.weighted_launches)
    got = spmm_mod._apply_banded(x, layout, w_bands, "split")
    fused = (k2.launches - before[0], k2.weighted_launches - before[1])
    want = unfused(x, layout, w_bands, "split")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    return fused


def _train_step(monkeypatch, g, inputs, dims, mdt, route=None):
    """One GCN step from fixed parameters, on the fused route or, with
    ``route``, on that ``_apply_banded``; the launches of kernel 2."""
    params = gcn_init(torch.Generator().manual_seed(2), dims,
                      device=g.device)
    x, labels, mask = inputs
    before = (k2.launches, k2.weighted_launches)
    with monkeypatch.context() as mp:
        if route is not None:
            mp.setattr(spmm_mod, "_apply_banded", route)
        out = gcn_train_step(params, gcn_init_opt(params), g,
                             gcn_normalize(g), x, (labels, mask), 1e-2,
                             impl="banded", message_dtype=mdt)
    return out, (k2.launches - before[0], k2.weighted_launches - before[1])


def _gat_step(monkeypatch, g, inputs, mdt, unfused_route=False):
    """One step of the GAT [dims[0], 32, dims[-1]] with 2 heads on its
    banded layer, fused or on the unfused route (its forward's sum and
    its backward's x-gradient, both through ``ops.spmm._apply_banded``);
    the launches of kernel 2."""
    x, labels, mask = inputs
    dims = [x.shape[1], 32, int(labels.max()) + 1]
    params = gat_mod.gat_init(torch.Generator().manual_seed(3), dims,
                              heads=2, device=g.device)
    before = (k2.launches, k2.weighted_launches)
    with monkeypatch.context() as mp:
        if unfused_route:
            mp.setattr(spmm_mod, "_apply_banded", unfused)
        out = gat_mod.gat_train_step(params, gat_mod.gat_init_opt(params),
                                     g, x, (labels, mask), 0.1,
                                     message_dtype=mdt, attn="banded")
    return out, (k2.launches - before[0], k2.weighted_launches - before[1])


def _assert_steps_equal(a, b):
    (pa, oa, la), (pb, ob, lb) = a, b
    assert torch.equal(la, lb)
    for xa, xb in zip(pa + oa, pb + ob):  # new params; momenta = grads
        for k in xa:
            assert torch.equal(xa[k], xb[k]), k


def _inputs(g, dims, seed=0):
    """Features ``[n_pad, dims[0]]``, labels and the real vertices."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(g.n_pad, dims[0]).astype(np.float32)
                         - 0.5)
    labels = torch.from_numpy(rng.randint(0, dims[-1], g.n_pad))
    mask = torch.arange(g.n_pad) < g.n
    return x.to(g.device), labels.to(g.device), mask.to(g.device)


# -- on the CPU: the plain versions ------------------------------------------


@pytest.fixture(scope="module")
def small():
    return GraphSlice.from_host(
        rmat(9, edge_factor=8, seed=1, undirected=True, weighted=True),
        device="cpu")


@pytest.mark.parametrize("mdt", [None, torch.bfloat16])
def test_gcn_step_matches_unfused_route_on_cpu(monkeypatch, small, mdt):
    """A GCN step through the weights kernel 2 takes is the unfused
    route's step, bit for bit, forward and backward."""
    dims = [16, 32, 32, 8]
    inputs = _inputs(small, dims)
    fused, _ = _train_step(monkeypatch, small, inputs, dims, mdt)
    ref, _ = _train_step(monkeypatch, small, inputs, dims, mdt, unfused)
    _assert_steps_equal(fused, ref)


@pytest.mark.parametrize("mdt", [None, torch.bfloat16])
def test_gat_step_matches_unfused_route_on_cpu(monkeypatch, small, mdt):
    """GAT's banded layer, whose forward hands kernel 2 the attention
    weights (``[mk, H]``) and whose backward's x-gradient is the banded
    SpMM: the unfused route's step, bit for bit."""
    inputs = _inputs(small, [16, 8])
    fused, _ = _gat_step(monkeypatch, small, inputs, mdt)
    ref, _ = _gat_step(monkeypatch, small, inputs, mdt, unfused_route=True)
    _assert_steps_equal(fused, ref)


def test_heads_spmm_matches_unfused_route_on_cpu(monkeypatch, small):
    """The multi-head SpMM (GAT's form) and its x-gradient."""
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(small.n_pad, 128, generator=gen, requires_grad=True)
    w = torch.rand(small.m_pad, 2, generator=gen)

    def run():
        out = spmm_mod.spmm(small, x, weights=w, impl="banded", heads=2)
        return out, torch.autograd.grad(torch.sin(out).sum(), x)[0]

    fused = run()
    monkeypatch.setattr(spmm_mod, "_apply_banded", unfused)
    ref = run()
    assert all(torch.equal(a, b) for a, b in zip(fused, ref))


def gathered(x, layout, w_list, precision):
    """Kernel 2 as ``_apply_banded`` called it before it read rows by id:
    the K band gathers (``_gather_bands``), then kernel 2 on the gathered
    streams, weighted."""
    bands = spmm_mod._gather_bands(x, layout, precision)
    dev = layout.dev(x.device)
    return k2.banded_segment_sum(
        dev["bounds"], dev["offs2d"], bands, precision=precision,
        edge_chunk=layout.edge_chunk, row_prefix=dev["row_prefix"],
        weights=w_list)


# band heights that cut the small graph into several bands at these widths
SMALL_TABLE = 128 * 1024
INDEXED_CASES = {  # case -> (F, heads, weights, precision)
    "gcn128": (128, 1, "gcn", "split"),
    "gcn256": (256, 1, "gcn", "split"),
    "gat4x64": (256, 4, "heads", "split"),
    "unweighted": (128, 1, None, "split"),
    "fast": (128, 1, "gcn", "fast"),
    "fast_gat": (256, 4, "heads", "fast"),
}


@pytest.mark.parametrize("case", list(INDEXED_CASES))
def test_indexed_form_is_the_gathered_form_on_cpu(monkeypatch, small, case):
    """The table and its ids against the band gathers, bit for bit: at the
    GCN's layouts (F = 128, 256) with ``gcn_normalize``'s pre-banded
    weights, at a GAT layout with ``[mk, 4]`` weights, without weights,
    and under ``fast`` (the table rounded to bfloat16 as the gathers
    rounded it); through ``_apply_banded`` and both plain versions."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    F, heads, kind, precision = INDEXED_CASES[case]
    layout = _layout(small, F)
    assert layout.K > 1
    gen = torch.Generator().manual_seed(F + heads)
    x = torch.rand(layout.n_pad, F, generator=gen) - 0.5
    if kind == "gcn":
        w = list(gcn_normalize(small, band_for_f=F).banded_pull)
    elif kind == "heads":
        w = layout.permute_to_bands(torch.rand(small.m_pad, heads,
                                               generator=gen))
    else:
        w = None
    want = gathered(x, layout, w, precision)
    assert torch.equal(spmm_mod._apply_banded(x, layout, w, precision),
                       want)
    dev = layout.dev("cpu")
    args = (dev["bounds"], dev["offs2d"])
    streams = spmm_mod._gather_bands(x, layout, precision)
    got = k2.banded_segment_sum_scheduled_plain(
        *args, x, precision=precision, row_prefix=dev["row_prefix"],
        weights=w, ids=dev["ids"], band_rows=layout.band_rows)
    assert torch.equal(got, k2.banded_segment_sum_scheduled_plain(
        *args, streams, precision=precision, row_prefix=dev["row_prefix"],
        weights=w))


def test_kernel2_route_gathers_no_band(monkeypatch, small):
    """With ``gather_rows`` made to raise, a GCN step, the SpMM with heads
    and its x-gradient all run: ``_apply_banded`` gathers nothing.  The
    SDDMM's route, and the SpMM's weight gradient through it, still
    gather their bands.  In a GAT step every ``gather_rows`` call lies
    outside ``_apply_banded`` (the slot scores and the SDDMM)."""
    dims = [16, 32, 32, 8]
    inputs = _inputs(small, dims)
    real = spmm_mod.gather_rows
    calls = {"inside": 0, "outside": 0, "in_seam": False}

    def refuse(*a, **k):
        raise AssertionError("a band gather on kernel 2's route")

    with monkeypatch.context() as mp:
        mp.setattr(spmm_mod, "gather_rows", refuse)
        _train_step(mp, small, inputs, dims, None)
        x = torch.rand(small.n_pad, 128, requires_grad=True)
        w = torch.rand(small.m_pad, 2)
        out = spmm_mod.spmm(small, x, weights=w, impl="banded", heads=2)
        torch.autograd.grad(out.sum(), x)
        with pytest.raises(AssertionError, match="band gather"):
            spmm_mod.sddmm(small, x.detach(), impl="banded")
        w.requires_grad_()
        out = spmm_mod.spmm(small, x, weights=w, impl="banded", heads=2)
        with pytest.raises(AssertionError, match="band gather"):
            torch.autograd.grad(out.sum(), w)

    seam = spmm_mod._apply_banded

    def counting(*a, **k):
        calls["inside" if calls["in_seam"] else "outside"] += 1
        return real(*a, **k)

    def in_seam(*a, **k):
        calls["in_seam"] = True
        try:
            return seam(*a, **k)
        finally:
            calls["in_seam"] = False

    monkeypatch.setattr(spmm_mod, "gather_rows", counting)
    monkeypatch.setattr(spmm_mod, "_apply_banded", in_seam)
    _gat_step(monkeypatch, small, _inputs(small, [16, 8]), None)
    assert calls["inside"] == 0 and calls["outside"] > 0


# -- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 2 runs only on the card")
    return torch.device("cuda", 0)


def _arxiv_size(device):
    """A directed graph of ogbn-arxiv's size with skewed in-degrees (hubs
    that span many walkers, and vertices with no in-edge)."""
    rng = np.random.RandomState(0)
    srcs = rng.randint(0, ARXIV_N, ARXIV_M)
    dsts = (ARXIV_N * rng.rand(ARXIV_M) ** 3).astype(np.int64)
    return GraphSlice.from_host(from_edges(srcs, dsts, num_nodes=ARXIV_N),
                                device=device)


@pytest.fixture(scope="module")
def graphs(card):
    return {
        "rmat16": GraphSlice.from_host(
            rmat(16, edge_factor=16, seed=0, undirected=True, weighted=True),
            device=card),
        "arxiv": _arxiv_size(card),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,heads", [(40, 1), (128, 1), (256, 1), (128, 2),
                                     (128, 4)])
@pytest.mark.parametrize("graph", ["rmat16", "arxiv"])
def test_routes_agree_on_card(graphs, graph, F, heads, dtype):
    """The fused kernel against the unfused route, bit for bit: at F = 40,
    128, 256 and GAT's head shapes (2 and 4 heads of 64 and 32 columns)."""
    g = graphs[graph]
    if graph == "rmat16" and F == 128:
        assert _layout(g, F).K == 3
    fused = _routes_agree(g, F, heads, dtype, seed=F + heads)
    assert fused == (1, 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", [None, torch.bfloat16])
def test_gcn_step_matches_unfused_route_on_card(monkeypatch, graphs, mdt):
    """OGB's GCN at ogbn-arxiv's size: one step's loss, gradients and new
    parameters equal the unfused route's, bit for bit; the step's six
    aggregations (three forward, three backward) are all weighted
    launches."""
    g = graphs["arxiv"]
    inputs = _inputs(g, GCN_DIMS)
    fused, counts = _train_step(monkeypatch, g, inputs, GCN_DIMS, mdt)
    assert counts == (6, 6)
    ref, counts = _train_step(monkeypatch, g, inputs, GCN_DIMS, mdt,
                              unfused)
    assert counts == (6, 0)
    _assert_steps_equal(fused, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", [None, torch.bfloat16])
def test_gat_step_matches_unfused_route_on_card(monkeypatch, graphs, mdt):
    """The GAT [128, 32, 32] with 2 heads at rmat16 on its banded layer:
    the unfused route's step, bit for bit; every launch of kernel 2 in
    the fused step is a weighted one."""
    g = graphs["rmat16"]
    inputs = _inputs(g, [128, 32])
    fused, counts = _gat_step(monkeypatch, g, inputs, mdt)
    assert counts[0] > 0 and counts[0] == counts[1]
    ref, counts = _gat_step(monkeypatch, g, inputs, mdt, unfused_route=True)
    assert counts[1] == 0
    _assert_steps_equal(fused, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,heads", [(128, 1), (256, 1), (1024, 4),
                                     (40, 1)])
@pytest.mark.parametrize("graph", ["rmat16", "arxiv"])
def test_indexed_form_is_the_gathered_form_on_card(graphs, graph, F, heads,
                                                   dtype):
    """Kernel 2 reading rows of x by the layout's ids against kernel 2 on
    the band gathers, bit for bit, weighted as the models weigh: one
    launch each, one of them indexed."""
    g = graphs[graph]
    layout = _layout(g, F)
    gen = torch.Generator().manual_seed(F)
    x = (torch.rand(layout.n_pad, F, generator=gen) - 0.5).to(
        device=g.device, dtype=dtype)
    w = layout.permute_to_bands(torch.rand(
        g.m_pad, *((heads,) if heads > 1 else ()), generator=gen).to(
            g.device))
    before = (k2.launches, k2.indexed_launches)
    got = spmm_mod._apply_banded(x, layout, w, "split")
    assert (k2.launches - before[0], k2.indexed_launches - before[1]) == (
        1, 1)
    assert torch.equal(got, gathered(x, layout, w, "split"))
    torch.cuda.synchronize()

