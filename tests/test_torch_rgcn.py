"""R-GCN on a typed graph (``models/rgcn.py``) against the plain float64
reference that decides the benchmark's ``correct``
(``benchmark/reference/rgcn.py``), at a small size on the CPU: 4 vertex
types of 40-300 vertices and 7 relations made by the benchmark's
generator (a destination with no in-edge of a relation and hub
destinations among them), the forward, the loss, every gradient (the
embedding tables included) and one SGD-momentum step, on the banded path
(rectangular layouts forced into several bands; every kernel wrapper runs
its plain version here) and on ``xla``.  Two steps in a row build no
layout and re-band no weight.  No JAX."""

import contextlib
import functools
import sys

import numpy as np
import pytest
import torch

from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models import rgcn as trgcn

from benchmark.gen import mag_like
from benchmark.harness import registry
from benchmark.reference import rgcn as ref
from benchmark.tasks import rgcn_train

CELL = "mag-rgcn-train"
SMALL = {
    "node_types": {"paper": 300, "author": 250, "institution": 40,
                   "field_of_study": 60},
    "edge_types": {"writes": ["author", "paper", 900],
                   "cites": ["paper", "paper", 700],
                   "has_topic": ["paper", "field_of_study", 800],
                   "affiliated_with": ["author", "institution", 200]},
    "feature_dim": 16, "num_classes": 8,
    "split": {"train": 150, "valid": 50, "test": 100}, "dims": [16, 12, 8],
}
SMALL_TABLE = 128 * 128 * 4  # bands of 128 rows: K = 3 at 384 rows
# The port's float32 against float64, relative to the largest entry of
# what is compared: about ten times the float32 gaps of a sum of a few
# dozen terms in another order (the GraphSAGE test's tolerances).
TOL = {"logits": 3e-6, "loss": 1e-6, "grads": 3e-6, "params": 1e-6}


def _spans(name):
    return contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def case():
    """The benchmark's inputs at the small size, the initial parameters,
    and the reference's relations."""
    cfg = {**registry.load_cell(CELL).config, **SMALL}
    inputs = mag_like.generate(cfg, 11, "cpu")
    params0 = rgcn_train.init_params(cfg, 11, "cpu")
    types = inputs["num_nodes"]
    rels = [(name, st, dt, ref.RelationMean(s, d, types[st], types[dt],
                                            torch.float64))
            for name, (st, dt, s, d)
            in rgcn_train.relation_edges(cfg, inputs["edges"]).items()]
    p64 = [{k: v.double() for k, v in p.items()} for p in params0]
    want = ref.train(p64, list(types), rels,
                     {"paper": inputs["x"].double()}, inputs["labels"],
                     inputs["train_mask"], "paper", 0.01, 0.9, 1)
    hs, _ = ref.forward(p64, list(types), rels,
                        {"paper": inputs["x"].double()})
    return cfg, inputs, params0, want, hs[-1]["paper"]


def _program(cfg, inputs):
    tg = rgcn_train.build(inputs, cfg, _spans, "cpu")
    rows = tg.n_pad("paper")
    x = {"paper": rgcn_train._padded(inputs["x"], rows)}
    batch = (rgcn_train._padded(inputs["labels"], rows),
             rgcn_train._padded(inputs["train_mask"], rows, False))
    return tg, x, batch


def _gap(got, want):
    want = want.double()
    scale = float(want.abs().max())
    diff = float((got.double() - want).abs().max())
    return diff if scale == 0 else diff / scale


def test_init_has_the_tasks_layout():
    """``rgcn_init``'s leaves: the benchmark's, in order and shape."""
    cfg, inputs, params0, _, _ = case()
    tg, _, _ = _program(cfg, inputs)
    got = trgcn.rgcn_init(torch.Generator().manual_seed(0), tg,
                          cfg["dims"], cfg["embedded"], device="cpu")
    assert [{k: v.shape for k, v in p.items()} for p in got] == \
        [{k: v.shape for k, v in p.items()} for p in params0]
    assert not got[1]["bias.paper"].any()


def test_the_graph_has_empty_and_hub_destinations():
    cfg, inputs, *_ = case()
    tg, _, _ = _program(cfg, inputs)
    assert len(tg.relations) == 7
    empty = hub = False
    for r in tg.relations:
        deg = r.graph.in_degrees[: r.graph.n_dst].double()
        empty |= bool((deg == 0).any())
        hub |= bool(deg.max() >= 5 * deg.mean())
    assert empty and hub


@pytest.mark.parametrize("impl", ["banded", "xla"])
def test_step_matches_reference(monkeypatch, impl):
    """Forward, loss, every gradient and one step against float64."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    cfg, inputs, params0, want, logits = case()
    tg, x, batch = _program(cfg, inputs)
    norm = (trgcn.rgcn_normalize(tg, cfg["dims"][:-1]) if impl == "banded"
            else None)
    if impl == "banded":
        r = next(r for r in tg.relations if r.name == "writes")
        assert tbanded.layout_for(r.graph, "pull", 16).K == 2  # author
        assert tbanded.layout_for(r.graph, "push", 16).K == 3  # paper
    got = trgcn.rgcn_forward(params0, tg, x, impl=impl, norm=norm)
    assert set(got) == set(cfg["node_types"])
    assert _gap(got["paper"][:300], logits) < TOL["logits"]
    params, opt = params0, trgcn.rgcn_init_opt(params0)
    params, opt, loss = trgcn.rgcn_train_step(params, opt, tg, x, batch,
                                              "paper", lr=0.01, impl=impl,
                                              norm=norm)
    assert abs(float(loss) - want["losses"][0]) / want["losses"][0] < \
        TOL["loss"]
    # the momentum after one step from zero is the gradient
    for g_p, w_p in zip(opt, want["grads"]):
        assert list(g_p) == list(w_p)
        for k in g_p:
            assert _gap(g_p[k], w_p[k]) < TOL["grads"], k
    assert float(opt[0]["emb.author"].abs().max()) > 0
    # the last layer's non-paper outputs reach no loss: zero gradients
    assert float(opt[2]["root.author"].abs().max()) == 0
    for p_p, w_p in zip(params, want["params"]):
        for k in p_p:
            assert _gap(p_p[k], w_p[k]) < TOL["params"], k


def test_two_steps_build_no_layout_and_reband_nothing(monkeypatch):
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    cfg, inputs, params0, _, _ = case()
    tg, x, batch = _program(cfg, inputs)
    norm = trgcn.rgcn_normalize(tg, cfg["dims"][:-1])
    built = []
    real = tbanded.build_banded_layout
    monkeypatch.setattr(tbanded, "build_banded_layout",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    spmm_mod = sys.modules["mini_tpu_torch.ops.spmm"]
    rebanded, sums = spmm_mod.rebanded, trgcn.relation_sums
    params, opt = params0, trgcn.rgcn_init_opt(params0)
    for _ in range(2):
        params, opt, loss = trgcn.rgcn_train_step(
            params, opt, tg, x, batch, "paper", impl="banded", norm=norm)
        assert np.isfinite(float(loss))
    assert built == [] and spmm_mod.rebanded == rebanded
    assert trgcn.relation_sums - sums == 2 * 7 * 2
