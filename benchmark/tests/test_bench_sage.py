"""The GraphSAGE cell (``products-sage-train``) at small sizes on the CPU:
a sound run and the faults its check must catch (the controls, TF32
products and bf16 messages, and half the batch; an unchanged state planted
under a run), the operation and byte counts at hand-worked shapes, and the
readers of its four per-layer metrics."""

import sys
import time
import types

import pytest
import torch

from benchmark.harness import core, registry
from benchmark.tasks import sage_train
from benchmark.tests.conftest import SEED

CELL = "products-sage-train"
SMALL = {
    "config": {"num_nodes": 300, "num_edges": 1200, "feature_dim": 16,
               "num_classes": 8,
               "split": {"train": 150, "valid": 50, "test": 100},
               "dims": [16, 32, 32, 8]},
    "workload": {"profile_items": 2},
}


def _run(trace=False):
    return core.run(CELL, SEED, 0.3, trace, "cpu", time.perf_counter(),
                    overrides=SMALL, platform="cpu")


def test_cell_reports_its_metrics():
    cell = registry.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {
        "train_step_ms", "train_peak_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "sage_step_mfu", "sage_aggregate_ms.train",
        "sage_segment_sum_roofline", "wide_band_launches_per_step.train"}
    assert cell.workload["reference_steps"] == 3
    assert cell.workload["profile_items"] == 4


def test_sound_run_is_correct_and_names_its_setup():
    r = _run()
    assert r["correct"] and r["failed"] == 0
    spans = r["diag"]["setup_spans"]
    for name in ("generate", "graph.from_edges", "graph.from_host",
                 "graph.normalize", "warmup"):
        assert name in spans, name


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_controls_fail(seed):
    """TF32 products, bf16 messages and half the batch each fail a
    limit."""
    c = registry.load_cell(CELL, SMALL)
    inputs = registry.generator(c).generate(c.config, seed, "cpu")
    inputs["seed"] = seed
    readings = sage_train.control(inputs, c)
    limits = c.workload["limits"]
    for fault in ("", "bf16_messages.", "half_batch."):
        assert any(readings[fault + k] > v for k, v in limits.items()), fault


def test_unchanged_state_is_not_correct(monkeypatch):
    """Steps that leave the parameters as they were fail the check."""
    def still(state):
        return torch.tensor(1.0)

    def setup(inputs, cell, spans, device, real=sage_train.setup):
        monkeypatch.setattr(sage_train, "step", still)
        return real(inputs, cell, spans, device)

    monkeypatch.setattr(sage_train, "setup", setup)
    assert not _run()["correct"]


def test_counts_at_hand_worked_shapes():
    """n = 10, m = 40, dims [4, 8, 2]: the products 2*10*8*8*2 (layer 1:
    forward and weight gradient) + 2*10*16*2*3 (layer 2 with its input
    gradient), the means 2*40*4 + 2*40*8*2; bytes for widths 4 and 8
    forward, 8 backward, each 4 m F + 4 m + 4 n F."""
    assert sage_train.step_flops(10, 40, [4, 8, 2]) == (
        2 * 10 * 8 * 8 * 2 + 2 * 10 * 16 * 2 * 3 + 2 * 40 * 4
        + 2 * 40 * 8 * 2)
    assert sage_train.step_bytes(10, 40, [4, 8, 2]) == sum(
        4 * 40 * f + 4 * 40 + 4 * 10 * f for f in (4, 8, 8))


def _ctx(**kw):
    base = dict(profiled={"items": 4}, unprofiled={"items": 10,
                                                   "seconds": 2.0},
                shapes=dict(n=10, m=40, dims=[4, 8, 2]), trace=None,
                task=sage_train, counter_deltas={}, cell=None)
    return types.SimpleNamespace(**{**base, **kw})


def test_readers():
    mfu = registry.metric_reader("sage_step_mfu")
    want = 100 * 10 * sage_train.step_flops(10, 40, [4, 8, 2]) / 2.0 / 67e12
    assert mfu.read(_ctx()) == pytest.approx(want)
    assert mfu.read(_ctx(unprofiled={"items": 0, "seconds": 0.0})) is None
    wide = registry.metric_reader("wide_band_launches_per_step.train")
    assert wide.read(_ctx(counter_deltas={
        "wide_band_launches_per_step.train": 16})) == 4.0
    roof = registry.metric_reader("sage_segment_sum_roofline")
    assert roof.read(_ctx()) is None  # no trace: nothing timed
    trace = types.SimpleNamespace(kernel_seconds=lambda names: 1e-6)
    got = roof.read(_ctx(trace=trace))
    assert got == pytest.approx(
        100 * 4 * sage_train.step_bytes(10, 40, [4, 8, 2]) / 3.35e12 / 1e-6)
    agg = registry.metric_reader("sage_aggregate_ms.train")
    assert agg.read(_ctx()) is None


def test_program_without_the_counter_reads_none(monkeypatch):
    mod = sys.modules["mini_tpu_torch.ops.kernels.spmm_banded"]
    monkeypatch.delattr(mod, "wide_launches")
    wide = registry.metric_reader("wide_band_launches_per_step.train")
    assert wide.read(_ctx()) is None
    assert wide.counters() == 0


def test_traced_run_reports_the_counters():
    r = _run(trace=True)
    assert r["correct"]
    m = r["metrics"]
    assert m["wide_band_launches_per_step.train"]["value"] == 0.0
    assert m["sage_step_mfu"]["value"] > 0
