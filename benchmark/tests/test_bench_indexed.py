"""``indexed_sums_per_step.train``: kernel 2's launches that read rows by
id, a profiled step, from the program's counter; None without it."""

import importlib
import types

from benchmark.harness import registry

NAME = "indexed_sums_per_step.train"


def test_indexed_sums_per_step(monkeypatch):
    reader = registry.metric_reader(NAME)
    k2 = importlib.import_module("mini_tpu_torch.ops.kernels.spmm_banded")
    assert reader.counters() == k2.indexed_launches
    # a GCN of 3 layers: 3 aggregations forward and 3 backward a step
    ctx = types.SimpleNamespace(profiled={"items": 8},
                                counter_deltas={NAME: 48})
    assert reader.read(ctx) == 6.0
    ctx.counter_deltas = {}
    assert reader.read(ctx) == 0.0
    ctx.profiled = {}
    assert reader.read(ctx) is None
    # a program without the counter: 0 to count from, and nothing read
    ctx.profiled = {"items": 8}
    monkeypatch.delattr(k2, "indexed_launches")
    assert reader.counters() == 0
    assert reader.read(ctx) is None


def test_listed_for_both_training_cells():
    for cell in ("arxiv-gcn-train", "arxiv-gat-train"):
        names = [m["name"] for m in registry.load_cell(cell).per_layer]
        assert NAME in names, cell
    metric = next(m for m in registry.load_cell("arxiv-gcn-train").per_layer
                  if m["name"] == NAME)
    assert (metric["layer"], metric["moves"]) == ("kernels", "train_step_ms")
