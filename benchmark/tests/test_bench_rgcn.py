"""The R-GCN cell (``mag-rgcn-train``) and the SSSP cell (``kron20-sssp``)
at small sizes on the CPU: the configuration's published counts, the
generator at a cut-down size, sound runs, the faults each check must
catch, the operation and byte counts at the published sizes, and the
readers of the R-GCN cell's four per-layer metrics."""

import json
import sys
import time
import types

import pytest
import torch

from benchmark.harness import core, registry
from benchmark.tasks import rgcn_train, sssp
from benchmark.tests.conftest import SEED

CELL = "mag-rgcn-train"
SMALL = {
    "config": {
        "node_types": {"paper": 300, "author": 250, "institution": 40,
                       "field_of_study": 60},
        "edge_types": {"writes": ["author", "paper", 900],
                       "cites": ["paper", "paper", 700],
                       "has_topic": ["paper", "field_of_study", 800],
                       "affiliated_with": ["author", "institution", 200]},
        "feature_dim": 16, "num_classes": 8,
        "split": {"train": 150, "valid": 50, "test": 100},
        "dims": [16, 12, 8]},
    "workload": {"profile_items": 2},
}
SSSP_CELL = "kron20-sssp"
SSSP_SMALL = {"config": {"scale": 9, "search_roots": 8},
              "workload": {"sample": 4, "profile_items": 4}}


def _run(trace=False, cell=CELL, small=SMALL):
    return core.run(cell, SEED, 0.3, trace, "cpu", time.perf_counter(),
                    overrides=small, platform="cpu")


def _published():
    """The configuration's counts as the metrics' ``shapes`` give them."""
    cfg = registry.load_cell(CELL).config
    rels = []
    for r in cfg["relations"]:
        st, dt, m = cfg["edge_types"][r["edges"]]
        if r.get("reverse"):
            st, dt = dt, st
        rels.append((r["name"], st, dt,
                     m * (2 if r.get("both_directions") else 1)))
    return dict(num_nodes=cfg["node_types"], relations=rels,
                dims=cfg["dims"], embedded=cfg["embedded"],
                target=cfg["target"])


def test_config_is_ogbs_rgcn_at_mags_size():
    cfg = registry.load_cell(CELL).config
    types_, dims = cfg["node_types"], cfg["dims"]
    assert sum(types_.values()) == cfg["num_nodes"] == 1939743
    assert sum(e[2] for e in cfg["edge_types"].values()) == \
        cfg["num_edges"] == 21111007
    s = _published()
    assert len(s["relations"]) == cfg["num_relations"] == 7
    assert sum(r[3] for r in s["relations"]) == cfg["relation_slots"] \
        == 42222014
    assert sum(cfg["split"].values()) == types_[cfg["target"]]
    emb = sum(types_[t] for t in cfg["embedded"]) * cfg["embedding_dim"]
    layers = sum(len(s["relations"]) * fi * fo + len(types_) * (fi * fo + fo)
                 for fi, fo in zip(dims[:-1], dims[1:]))
    assert emb == 154029312 and layers == 337460
    assert emb + layers == cfg["parameters"] == 154366772
    assert cfg["reduced"] == [] and dims == [128, 64, 349]
    spec = json.load(open(registry.SPEC))
    sources = [c["source"] for c in spec["configs"]]
    assert len(set(sources)) == len(sources)


def test_generator_gives_the_counts_it_is_given():
    """At a thousandth of the published counts: every edge type's count,
    ids inside each side, cites free of self loops, the split."""
    c = registry.load_cell(CELL)
    cfg = {**c.config,
           "node_types": {t: n // 1000 for t, n in
                          c.config["node_types"].items()},
           "edge_types": {k: [s, d, m // 1000] for k, (s, d, m) in
                          c.config["edge_types"].items()},
           "split": {"train": 629, "valid": 64, "test": 43}}
    inputs = registry.generator(c).generate(cfg, SEED, "cpu")
    for k, (s, d, m) in cfg["edge_types"].items():
        src, dst = inputs["edges"][k]
        assert src.numel() == dst.numel() == m
        assert 0 <= int(src.min()) and int(src.max()) < cfg["node_types"][s]
        assert 0 <= int(dst.min()) and int(dst.max()) < cfg["node_types"][d]
    src, dst = inputs["edges"]["cites"]
    assert not bool((src == dst).any())
    assert inputs["x"].shape == (736, 128)
    assert int(inputs["train_mask"].sum()) == 629
    rel = rgcn_train.relation_edges(cfg, inputs["edges"])
    assert sum(int(v[2].numel()) for v in rel.values()) == \
        2 * 7145 + 2 * 5416 + 2 * 7505 + 2 * 1043


def test_counts_at_the_published_sizes():
    """A step runs the 14 forward means and the 6 backward ones the loss
    reaches (3 at 128 columns into author, field_of_study and
    institution; 3 at 64 through the relations into paper): 52.59 GB of
    means; 827.52 GFLOP of products."""
    s = _published()
    plan = rgcn_train._plan(s["relations"], s["dims"], s["embedded"],
                            s["target"])
    assert plan == [({"paper", "author", "field_of_study"},
                     {"author", "institution", "field_of_study"}),
                    ({"paper"}, None)]
    assert rgcn_train.step_bytes(**s) == pytest.approx(52.593588192e9)
    assert rgcn_train.step_flops(**s) == pytest.approx(827.520545408e9)


def test_counts_at_hand_worked_shapes():
    """Types a (5, featured) and b (3, embedded), relations a -> b (m 7)
    and b -> a (m 4), dims [2, 4, 3], target a.  Layer 2 reaches a only:
    b -> a backward at 4 columns; layer 1 reaches a and b: a -> b has no
    backward (a's features), b -> a has one at 2."""
    s = dict(num_nodes={"a": 5, "b": 3},
             relations=[("ab", "a", "b", 7), ("ba", "b", "a", 4)],
             dims=[2, 4, 3], embedded=["b"], target="a")

    def mean(m, f, rows):
        return 4 * m * f + 8 * m + 4 * rows * f

    assert rgcn_train.step_bytes(**s) == (
        mean(7, 2, 3) + mean(4, 2, 5) + mean(4, 2, 3)
        + mean(7, 4, 3) + mean(4, 4, 5) + mean(4, 4, 3))
    assert rgcn_train._plan(s["relations"], s["dims"], s["embedded"],
                            "a") == [({"a", "b"}, {"b"}), ({"a"}, None)]
    l1 = 2 * 2 * 4  # per row
    l2 = 2 * 4 * 3
    forward = l1 * (5 + 3 + 3 + 5) + l2 * (5 + 3 + 3 + 5)
    # layer 2: root a and b -> a, weight and input gradients
    back2 = l2 * (5 + 5) * 2
    # layer 1: root a (weight only), root b (both), a -> b (weight only),
    # b -> a (both)
    back1 = l1 * (5 + 3 * 2 + 3 + 5 * 2)
    assert rgcn_train.step_flops(**s) == forward + back2 + back1


def test_cell_reports_its_metrics():
    cell = registry.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {
        "train_step_ms", "train_peak_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "rgcn_step_mfu", "rgcn_relation_ms.train",
        "rgcn_segment_sum_roofline", "bipartite_sums_per_step.train"}
    assert cell.workload["reference_steps"] == 3
    assert cell.workload["profile_items"] == 4
    cell = registry.load_cell(SSSP_CELL)
    assert {m["name"] for m in cell.end_to_end} == {
        "query_rate", "query_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle.query", "host_us_per_round.query"}


def test_sound_run_is_correct_and_names_its_setup():
    r = _run()
    assert r["correct"] and r["failed"] == 0
    spans = r["diag"]["setup_spans"]
    for name in ("generate", "graph.from_edges", "graph.from_host",
                 "graph.normalize", "warmup"):
        assert name in spans, name


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_controls_fail(seed):
    """TF32 products, bf16 messages, a relation left out, a relation
    summed and half the batch each fail a limit."""
    c = registry.load_cell(CELL, SMALL)
    inputs = registry.generator(c).generate(c.config, seed, "cpu")
    inputs["seed"] = seed
    readings = rgcn_train.control(inputs, c)
    limits = c.workload["limits"]
    for fault in ("", "bf16_messages.", "left_out.", "summed.",
                  "half_batch."):
        assert any(readings[fault + k] > v for k, v in limits.items()), fault


def test_unchanged_state_is_not_correct(monkeypatch):
    """Steps that leave the parameters as they were fail the check."""
    def still(state):
        return torch.tensor(1.0)

    def setup(inputs, cell, spans, device, real=rgcn_train.setup):
        monkeypatch.setattr(rgcn_train, "step", still)
        return real(inputs, cell, spans, device)

    monkeypatch.setattr(rgcn_train, "setup", setup)
    assert not _run()["correct"]


def _ctx(**kw):
    base = dict(profiled={"items": 4}, unprofiled={"items": 10,
                                                   "seconds": 2.0},
                shapes=_published(), trace=None, task=rgcn_train,
                counter_deltas={}, cell=None)
    return types.SimpleNamespace(**{**base, **kw})


def test_readers():
    mfu = registry.metric_reader("rgcn_step_mfu")
    want = 100 * 10 * 827.520545408e9 / 2.0 / 67e12
    assert mfu.read(_ctx()) == pytest.approx(want)
    assert mfu.read(_ctx(unprofiled={"items": 0, "seconds": 0.0})) is None
    bip = registry.metric_reader("bipartite_sums_per_step.train")
    assert bip.read(_ctx(counter_deltas={
        "bipartite_sums_per_step.train": 68})) == 17.0
    roof = registry.metric_reader("rgcn_segment_sum_roofline")
    assert roof.read(_ctx()) is None  # no trace: nothing timed
    trace = types.SimpleNamespace(kernel_seconds=lambda names: 0.1)
    assert roof.read(_ctx(trace=trace)) == pytest.approx(
        100 * 4 * 52.593588192e9 / 3.35e12 / 0.1)
    rel = registry.metric_reader("rgcn_relation_ms.train")
    assert rel.read(_ctx()) is None


def test_program_without_the_counter_reads_none(monkeypatch):
    mod = sys.modules["mini_tpu_torch.ops.kernels.spmm_banded"]
    monkeypatch.delattr(mod, "bipartite_launches")
    bip = registry.metric_reader("bipartite_sums_per_step.train")
    assert bip.read(_ctx()) is None
    assert bip.counters() == 0


def test_traced_run_reports_the_counters():
    """On the CPU kernel 2 never launches: the counter reads 0."""
    r = _run(trace=True)
    assert r["correct"]
    m = r["metrics"]
    assert m["bipartite_sums_per_step.train"]["value"] == 0.0
    assert m["rgcn_step_mfu"]["value"] > 0


def test_sssp_sound_run_is_correct_and_its_rounds_are_spans():
    r = _run(cell=SSSP_CELL, small=SSSP_SMALL)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["dist_mismatches"]["value"] == 0
    r = _run(True, cell=SSSP_CELL, small=SSSP_SMALL)
    assert r["correct"]
    assert r["metrics"]["host_us_per_round.query"]["value"] > 0


def test_sssp_control_fails():
    """Hop counts in place of weighted distances fail both counts."""
    c = registry.load_cell(SSSP_CELL, SSSP_SMALL)
    inputs = registry.generator(c).generate(c.config, SEED, "cpu")
    roots = inputs["roots"][:4].tolist()
    got = sssp.control(inputs, c, roots)
    assert got["dist_mismatches"] > 0 and got["pred_mismatches"] > 0
