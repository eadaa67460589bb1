"""``mini_tpu_torch.utils.profiling``: ``trace`` writes a Chrome trace that
holds ``mini_tpu``'s five scope names at their counterparts (the banded
SpMM's kernel, the band gathers, which the banded SDDMM runs, the
engine's src and dst expansions and its dst reduce); ``scope`` is one shared no-op context while no profiler
runs; ``annotate`` is its decorator form; ``wall_timer`` times a block.

The program's spans: a BFS's query, rounds by kind (as many of each as
its counters count), reads and predecessor pass, nested in its query; a
PageRank's query, rounds and reads; a training step's forward, backward
and update, in that order; ``ops.spmm.rebanded``, the count of
banded calls that re-band their weights; a GAT step's ``gat.attn`` and
``gat.attn.backward`` spans, one a layer, and ``models.gat.fused_layers``,
the count of layers that left the banded layer."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import mini_tpu_torch.graph as tg
from mini_tpu_torch.algorithms import bfs, pagerank
from mini_tpu_torch.graph import GraphSlice, erdos_renyi
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models import (gat_init, gat_init_opt, gat_train_step,
                                   gcn_init, gcn_init_opt, gcn_normalize,
                                   gcn_train_step)
from mini_tpu_torch.models import gat as gat_mod
from mini_tpu_torch.ops.spmm import spmm
from mini_tpu_torch.utils import annotate, scope, trace, wall_timer
from mini_tpu_torch.utils import profiling

from test_torch_bfs import build_case

# the module, not the function ``ops/__init__`` exports by its name
spmm_mod = sys.modules["mini_tpu_torch.ops.spmm"]

SCOPES = ("spmm.band_gather_0", "spmm.band_gather_1", "spmm.banded_kernel",
          "engine.src_to_csc", "engine.expand_dst", "engine.segreduce_dst.or")


def trace_names(dir_path):
    with open(os.path.join(dir_path, "trace.json")) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def trace_spans(dir_path, prefixes) -> list:
    """``(name, start, end)`` of the trace's spans whose name starts with
    one of ``prefixes``, in order of start."""
    with open(os.path.join(dir_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(prefixes)),
                  key=lambda s: s[1])


def count(spans, name) -> int:
    return sum(s[0] == name for s in spans)


def test_trace_holds_the_five_scopes(tmp_path, monkeypatch):
    # 128-row bands: the 256-row padded graph splits into K=2
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)
    g = GraphSlice.from_host(erdos_renyi(200, 1200, seed=3, undirected=True),
                             device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(g.n_pad, 128)
                         .astype(np.float32))
    with trace(str(tmp_path / "t")) as d:
        spmm(g, x, impl="banded")
        spmm_mod.sddmm(g, x, impl="banded")  # the band gathers' route
        bfs(g, 0)
    assert d == str(tmp_path / "t")
    names = trace_names(d)
    for name in SCOPES:
        assert name in names, name
    assert "engine.segreduce_dst.min" in names  # BFS's pred pass


def test_scope_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = scope("a"), scope("b")
    class Unformatted:
        def __format__(self, spec):
            raise AssertionError("a scope's name was made off-profiler")

    c = profiling.scope_of("c.{}", Unformatted())
    assert a is b is c is profiling._NO_SCOPE
    with a as v:
        assert v is None
    with torch.profiler.profile() as prof:
        with scope("inside"):
            torch.ones(2).sum()
        with profiling.scope_of("seg.{}", "min"):
            torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert "inside" in names and "seg.min" in names


def test_annotate_and_wall_timer():
    @annotate("tagged")
    def f(x, y=1):
        """doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(1, y=2) == 3
    with torch.profiler.profile() as prof:
        f(torch.ones(1))
    assert "tagged" in {e.name for e in prof.events()}
    with wall_timer() as t:
        time.sleep(0.01)
    assert 0.01 <= t.elapsed < 5


# families and schedules of tests/test_torch_bfs.py that, between them,
# run every kind of round: the grid's chain, rmat10's tier and dense
# rounds, the random graph's last pull round
ROUND_CASES = [("grid", {}), ("rmat10", {}), ("random", {}),
               ("grid", dict(chain_cap=0)), ("rmat10", dict(sparse_cape=0)),
               ("random", dict(sparse_cape=0))]
ROUND_KINDS = ("dense", "pull", "sparse", "chained")


def round_kinds(r) -> dict:
    """The rounds of each kind that ``r``'s counters count."""
    return dict(
        dense=r.num_iterations - r.num_pull_iterations
        - r.num_sparse_iterations,
        pull=r.num_pull_iterations,
        sparse=r.num_sparse_iterations - r.num_chained_iterations,
        chained=r.num_chained_iterations)


@pytest.mark.parametrize("name,kw", ROUND_CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}"
                              for n, k in ROUND_CASES])
def test_bfs_spans_follow_its_counters(tmp_path, name, kw):
    g = GraphSlice.from_host(build_case(tg, name), device="cpu")
    with trace(str(tmp_path)) as d:
        r = bfs(g, 0, **kw)
    spans = trace_spans(d, ("bfs.", "loop."))
    for kind, n in round_kinds(r).items():
        assert count(spans, f"bfs.round.{kind}") == n, kind
    assert count(spans, "loop.read") == r.num_iterations + 1
    assert count(spans, "bfs.query") == count(spans, "bfs.preds") == 1
    assert len(spans) == 2 * r.num_iterations + 3  # nothing else
    (_, q0, q1), = [s for s in spans if s[0] == "bfs.query"]
    assert all(q0 <= a and b <= q1 for _, a, b in spans)


def test_the_round_cases_run_every_kind():
    seen = set()
    for name, kw in ROUND_CASES:
        g = GraphSlice.from_host(build_case(tg, name), device="cpu")
        seen |= {k for k, n in round_kinds(bfs(g, 0, **kw)).items() if n}
    assert seen == set(ROUND_KINDS)


def test_pagerank_spans_a_round_each(tmp_path):
    g = GraphSlice.from_host(erdos_renyi(200, 1200, seed=3, undirected=True),
                             device="cpu")
    with trace(str(tmp_path)) as d:
        r = pagerank(g)
    assert 0 < r.num_iterations < 100  # it converged: one read more
    spans = trace_spans(d, ("pagerank.", "loop."))
    assert count(spans, "pagerank.round") == r.num_iterations
    assert count(spans, "loop.read") == r.num_iterations + 1
    assert count(spans, "pagerank.query") == 1
    (_, q0, q1), = [s for s in spans if s[0] == "pagerank.query"]
    assert all(q0 <= a and b <= q1 for _, a, b in spans)


def _gcn_case(dims, impl="auto"):
    g = GraphSlice.from_host(erdos_renyi(200, 1200, seed=3, undirected=True),
                             device="cpu")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(g.n_pad, dims[0]).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, dims[-1], g.n_pad)
                              .astype(np.int32))
    params = gcn_init(torch.Generator().manual_seed(0), dims, device="cpu")
    return lambda: gcn_train_step(
        params, gcn_init_opt(params), g, gcn_normalize(g), x,
        (labels, g.vertex_mask()), impl=impl)


def test_a_train_step_spans_its_three_phases(tmp_path):
    step = _gcn_case([16, 32, 8])
    with trace(str(tmp_path)) as d:
        step()
    spans = trace_spans(d, ("step.",))
    assert [s[0] for s in spans] == ["step.forward", "step.backward",
                                     "step.update"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("hidden,rebands", [(256, 1), (128, 0)])
def test_rebanded_counts_the_weights_a_step_re_bands(monkeypatch, hidden,
                                                     rebands):
    """``gcn_normalize`` pre-bands the weights for F=128: 256-row bands
    here, so an F=256 layer's 128-row bands re-band them in its forward
    call, and an F=128 layer's reuse them."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 256 * 128 * 4)
    step = _gcn_case([16, hidden, 128], impl="banded")
    before = spmm_mod.rebanded
    step()
    step()
    assert spmm_mod.rebanded - before == 2 * rebands


def _gat_case(attn, heads=(2, 2), dims=(16, 64, 8)):
    g = GraphSlice.from_host(erdos_renyi(200, 1200, seed=3, undirected=True),
                             device="cpu")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(g.n_pad, dims[0]).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, dims[-1], g.n_pad))
    params = gat_init(torch.Generator().manual_seed(0), list(dims),
                      heads=list(heads), device="cpu")
    return lambda: gat_train_step(
        params, gat_init_opt(params), g, x, (labels, g.vertex_mask()),
        attn=attn)


@pytest.mark.parametrize("heads", [(2, 2), (2, 3)])
def test_a_gat_step_spans_its_attention_layers(tmp_path, heads):
    """On the banded layer (2 heads of 64: no spare lane; 3 heads of 8: a
    lane) a step holds one ``gat.attn`` span a layer inside
    ``step.forward`` and one ``gat.attn.backward`` a layer, and no layer
    leaves the banded layer."""
    step = _gat_case("banded", heads)
    before = gat_mod.fused_layers
    with trace(str(tmp_path)) as d:
        step()
    assert gat_mod.fused_layers == before
    spans = trace_spans(d, ("gat.", "step."))
    assert count(spans, "gat.attn") == 2
    assert count(spans, "gat.attn.backward") == 2
    (_, f0, f1), = [s for s in spans if s[0] == "step.forward"]
    assert all(f0 <= a and b <= f1 for n, a, b in spans if n == "gat.attn")


@pytest.mark.parametrize("attn,fused", [("auto", 2), ("fused", 0),
                                        ("banded", 0)])
def test_fused_layers_counts_the_layers_that_leave_the_banded_layer(
        attn, fused):
    """``auto`` on the CPU sends every layer to the fused path and counts
    each; ``fused``, asked for, counts none, nor does the banded layer."""
    step = _gat_case(attn)
    before = gat_mod.fused_layers
    step()
    assert gat_mod.fused_layers - before == fused
