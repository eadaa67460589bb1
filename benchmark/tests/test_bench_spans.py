"""``harness/spans.py`` and the four readers of the program's spans and
counter, on hand-written Chrome traces whose values are worked out by
hand: nested query, round and read spans with device-idle gaps inside
and outside the rounds, and a training step whose backward launches from
a second thread."""

import importlib
import json
import types

import pytest

from benchmark.harness import core, registry
from benchmark.harness import spans as spans_mod


def X(name, ts, dur, tid=1, cat="user_annotation", **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if args:
        e["args"] = args
    return e


def K(ts, dur, corr=None):
    """A kernel, with the correlation of the launch that issued it."""
    return X("k(int)", ts, dur, tid=7, cat="kernel",
             **({} if corr is None else {"correlation": corr}))


def L(ts, corr, tid=1):
    """A launch on the host thread ``tid``."""
    return X("cudaLaunchKernel", ts, 5, tid=tid, cat="cuda_runtime",
             correlation=corr)


WINDOW = X("bench.window", 0, 1000)

# two BFS queries.  Device ops [0, 100), [150, 250), [540, 560),
# [600, 700), [800, 900) leave the gaps [100, 150), [250, 540),
# [560, 600), [700, 800), [900, 1000).  Inside the rounds: dense
# [60, 160) 50, sparse [200, 300) 50, chained [520, 600) 20 + 40, pull
# [610, 680) none; 160 us over 2 queries.  Host outside the reads: the
# queries' 400 + 200 us less reads of 50 + 40 + 20 and 20 + 10 + 10, over
# 4 rounds: 112.5 us.
QUERIES = [
    WINDOW,
    X("bench.query", 0, 500),
    X("bfs.query", 10, 400),
    X("loop.read", 10, 50),
    X("bfs.round.dense", 60, 100),
    X("loop.read", 160, 40),
    X("bfs.round.sparse", 200, 100),
    X("loop.read", 300, 20),
    X("bfs.preds", 320, 80),
    X("bfs.query", 500, 200),
    X("loop.read", 500, 20),
    X("bfs.round.chained", 520, 80),
    X("loop.read", 600, 10),
    X("bfs.round.pull", 610, 70),
    X("loop.read", 680, 10),
    X("loop.read", 900, 50),  # in no query
    X("bfs.round.dense", 700, 300, tid=2),  # another thread's
    X("aten::add", 20, 10, cat="cpu_op"),
    K(0, 100), K(150, 100), K(540, 20), K(600, 100), K(800, 100),
]

# two steps.  Launched inside step.backward ([200, 400) and [650, 850)),
# the first from the main thread and the rest from autograd's (tid 3):
# kernels of 70, 20 and 100 us, 95 us a step.  Left out: a forward and
# an update launch, a launch on tid 3 after the backward, and a kernel
# with no launch in the trace.
STEPS = [
    WINDOW,
    X("step.forward", 0, 200), X("step.backward", 200, 200),
    X("step.update", 400, 50),
    X("step.forward", 450, 200), X("step.backward", 650, 200),
    X("step.update", 850, 50),
    L(100, 1), K(120, 60, 1),
    L(250, 2), K(260, 70, 2),
    L(390, 3, tid=3), K(400, 20, 3),
    L(420, 4), K(430, 10, 4),
    L(700, 5, tid=3), K(700, 100, 5),
    L(870, 6, tid=3), K(880, 10, 6),
    K(950, 40, 99),
]


def _write(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _ctx(tmp_path, monkeypatch, events, **kw):
    monkeypatch.setattr(core, "OUT_DIR", str(tmp_path))
    _write(tmp_path / "cell.trace.json", events)
    return types.SimpleNamespace(trace=object(),
                                 cell=types.SimpleNamespace(name="cell"),
                                 **kw)


def test_a_window_holds_the_program_spans_ops_and_gaps(tmp_path):
    w = spans_mod.load(_write(tmp_path / "t.json", QUERIES))
    assert (w.start, w.end) == (0.0, 1000.0)
    names = [s.name for s in w.spans]
    assert "bench.query" not in names and "aten::add" not in names
    assert names.count("bfs.round.dense") == 1  # tid 2's left out
    assert [s.start for s in w.spans] == sorted(s.start for s in w.spans)
    assert w.gaps == [(100, 150), (250, 540), (560, 600), (700, 800),
                      (900, 1000)]
    assert [s.name for s in w.named(spans_mod.is_round)] == [
        "bfs.round.dense", "bfs.round.sparse", "bfs.round.chained",
        "bfs.round.pull"]
    assert spans_mod.is_round("pagerank.round")
    assert not spans_mod.is_round("bfs.rounds")
    assert [s.name for s in w.named(spans_mod.is_query)] == ["bfs.query"] * 2


def test_launches_map_by_correlation(tmp_path):
    w = spans_mod.load(_write(tmp_path / "t.json", STEPS))
    assert [(op.start, op.launched) for op in w.ops] == [
        (120, 100), (260, 250), (400, 390), (430, 420), (700, 700),
        (880, 870), (950, None)]
    back = w.named(lambda n: n == "step.backward")
    assert [op.start for op in w.launched_inside(back)] == [260, 400, 700]


def test_no_window_no_spans(tmp_path):
    assert spans_mod.load(_write(tmp_path / "t.json", [K(0, 1)])) is None


@pytest.mark.parametrize("metric,events,want", [
    ("host_us_per_round.query", QUERIES, 112.5),
    ("round_idle_ms.query", QUERIES, 0.080),
    ("backward_ms.train", STEPS, 0.095),
])
def test_span_readers(tmp_path, monkeypatch, metric, events, want):
    reader = registry.metric_reader(metric)
    ctx = _ctx(tmp_path, monkeypatch, events)
    assert reader.read(ctx) == pytest.approx(want)
    # a program without the spans, and a run without a trace
    bare = _ctx(tmp_path, monkeypatch, [WINDOW, K(0, 100)])
    assert reader.read(bare) is None
    bare.trace = None
    assert reader.read(bare) is None


def test_rebands_per_step(monkeypatch):
    reader = registry.metric_reader("rebands_per_step.train")
    spmm = importlib.import_module("mini_tpu_torch.ops.spmm")
    assert reader.counters() == spmm.rebanded
    ctx = types.SimpleNamespace(
        profiled={"items": 8},
        counter_deltas={"rebands_per_step.train": 16})
    assert reader.read(ctx) == 2.0
    # a program without the counter: 0 to count from, and nothing read
    monkeypatch.delattr(spmm, "rebanded")
    assert reader.counters() == 0
    assert reader.read(ctx) is None
