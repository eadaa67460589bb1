"""The harness on the CPU at small sizes: cells and configurations found
by name, the result line's schema, the p95 over all queries, the idle
share as an interval union, the run's check of loaded modules."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark.harness import core, registry
from benchmark.harness import trace as tracing
from benchmark.tests.conftest import SEED, SMALL

CELLS = sorted(SMALL)


def test_every_benchmark_entry_has_its_files():
    spec = registry.spec()
    assert spec["paths"] == ["benchmark"]
    for c in spec["configs"]:
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    names = {w["name"] for w in spec["workloads"]}
    assert names == set(CELLS)
    for w in spec["workloads"]:
        cell = registry.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["chips"] == w["chips"]
        assert registry.task(cell) and registry.generator(cell)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in spec["per_layer"]:
        assert hasattr(registry.metric_reader(m["name"]), "read")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(cell, trace):
    r = core.run(cell, SEED, 0.3, bool(trace), "cpu", time.perf_counter(),
                 overrides=SMALL[cell], platform="cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    spec_cell = registry.load_cell(cell)
    listed = spec_cell.per_layer if trace else spec_cell.end_to_end
    units = {m["name"]: m["unit"] for m in listed}
    for name, m in r["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:  # every end-to-end metric but the card's memory
        assert set(r["metrics"]) >= set(units) - {"train_peak_gib"}
    else:
        assert "graph_build_s" in r["metrics"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def test_p95_is_over_every_query():
    lat = [float(i) for i in range(1, 101)]
    assert core.p95(lat) == pytest.approx(95.05)
    assert core.p95([3.0]) == 3.0
    assert core.p95([1.0] * 99 + [1000.0]) == pytest.approx(1.0)
    assert core.p95([1.0] * 90 + [1000.0] * 10) > 500


def test_reservoir_is_a_seeded_sample():
    a, b = core.Reservoir(4, 7), core.Reservoir(4, 7)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(set(a.items)) == 4 and a.seen == 100


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.summarize(str(path))


def test_idle_share_is_an_interval_union(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 45,
         "dur": 20, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k(int)", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k(int)", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 70,
         "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 5},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::walk<int, 1>(Bands, int)",
         "ts": 95, "dur": 1},
    ]
    s = _trace(tmp_path, ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(60e-6)  # [10, 40) and [70, 100)
    assert s.n_ops == 4
    assert s.op_seconds["k(int)"] == pytest.approx(50e-6)
    assert s.kernel_seconds(["k("]) == pytest.approx(50e-6)
    assert s.gap_seconds == pytest.approx({"host idle": 10e-6,
                                           "aten::add": 30e-6})
    assert s.kernel_seconds(["walk"]) == pytest.approx(1e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k", pytest.approx(50e-6)]
    assert ["void walk<int, 1>", pytest.approx(1e-6)] in b["device_ops"]


def test_no_window_no_summary(tmp_path):
    assert _trace(tmp_path, [{"ph": "X", "cat": "kernel", "name": "k",
                              "ts": 0, "dur": 1}]) is None


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["mini_tpu_torch", "mini_tpu_torch.ops", "jax_like", "numpy",
             "jax.numpy", "jaxlib", "mini_tpu.graph", "flax.linen"]
    assert core.forbidden_modules(names) == ["flax.linen", "jax.numpy",
                                             "jaxlib", "mini_tpu.graph"]


def test_a_run_loads_nothing_of_jax():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from benchmark.harness import core\n"
            "from benchmark.tests.conftest import SMALL\n"
            "for c in SMALL:\n"
            "    core.run(c, 3, 0.2, True, 'cpu', time.perf_counter(),"
            " overrides=SMALL[c], platform='cpu')\n"
            "print(core.forbidden_modules())\n") % registry.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kron20-bfs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=registry.ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
