"""``mini_tpu_torch.utils.profiling``: ``trace`` writes a Chrome trace that
holds ``mini_tpu``'s five scope names at their counterparts (the banded
SpMM's band gathers and kernel, the engine's src and dst expansions and
its dst reduce); ``scope`` is one shared no-op context while no profiler
runs; ``annotate`` is its decorator form; ``wall_timer`` times a block."""

import json
import os
import time

import numpy as np
import torch

from mini_tpu_torch.algorithms import bfs
from mini_tpu_torch.graph import GraphSlice, erdos_renyi
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.ops.spmm import spmm
from mini_tpu_torch.utils import annotate, scope, trace, wall_timer
from mini_tpu_torch.utils import profiling

SCOPES = ("spmm.band_gather_0", "spmm.band_gather_1", "spmm.banded_kernel",
          "engine.src_to_csc", "engine.expand_dst", "engine.segreduce_dst.or")


def trace_names(dir_path):
    with open(os.path.join(dir_path, "trace.json")) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_holds_the_five_scopes(tmp_path, monkeypatch):
    # 128-row bands: the 256-row padded graph splits into K=2
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)
    g = GraphSlice.from_host(erdos_renyi(200, 1200, seed=3, undirected=True),
                             device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(g.n_pad, 128)
                         .astype(np.float32))
    with trace(str(tmp_path / "t")) as d:
        spmm(g, x, impl="banded")
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
