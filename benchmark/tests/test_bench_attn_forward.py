"""The reader of ``attn_forward_ms.train`` on a planted Chrome trace: the
device time of the ops launched inside the ``gat.attn`` spans, on any
thread, over the profiled steps; a trace without the span, or a run
without a trace, reads None."""

import json
import types

import pytest

from benchmark.harness import core, registry


def _X(name, ts, dur, tid=1, cat="user_annotation", **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if args:
        e["args"] = args
    return e


def _K(ts, dur, corr):
    return _X("k(int)", ts, dur, tid=7, cat="kernel", correlation=corr)


def _L(ts, corr, tid):
    return _X("cudaLaunchKernel", ts, 5, tid=tid, cat="cuda_runtime",
              correlation=corr)


# two steps; the layers' forward spans [100, 200) on the main thread
# (tid 1) and [600, 700) on tid 3 launch kernels of 30, 20 and 50 us; the
# launches at 250 and 720 lie outside them, the one at 310 inside a
# ``gat.attn.backward`` span, which is not the forward's; a span after
# the window is left out: 100 us over 2 steps
STEPS = [
    _X("bench.window", 0, 1000),
    _X("step.forward", 50, 200), _X("step.forward", 550, 200),
    _X("gat.attn", 100, 100),
    _X("gat.attn", 600, 100, tid=3),
    _X("gat.attn.backward", 300, 100, tid=3),
    _X("gat.attn", 1100, 50),
    _L(110, 1, 1), _K(120, 30, 1),
    _L(150, 2, 1), _K(160, 20, 2),
    _L(250, 3, 1), _K(255, 40, 3),
    _L(310, 4, 3), _K(320, 60, 4),
    _L(620, 5, 3), _K(630, 50, 5),
    _L(720, 6, 1), _K(725, 10, 6),
    _L(1110, 7, 1), _K(1120, 5, 7),
]


def _ctx(tmp_path, monkeypatch, events, steps=2):
    monkeypatch.setattr(core, "OUT_DIR", str(tmp_path))
    (tmp_path / "cell.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(trace=object(), profiled={"items": steps},
                                 cell=types.SimpleNamespace(name="cell"))


def test_attn_forward_ms(tmp_path, monkeypatch):
    reader = registry.metric_reader("attn_forward_ms.train")
    assert reader.read(_ctx(tmp_path, monkeypatch, STEPS)) == (
        pytest.approx(0.050))
    assert reader.read(_ctx(tmp_path, monkeypatch, STEPS, steps=4)) == (
        pytest.approx(0.025))


def test_attn_forward_ms_without_the_span(tmp_path, monkeypatch):
    reader = registry.metric_reader("attn_forward_ms.train")
    bare = _ctx(tmp_path, monkeypatch,
                [e for e in STEPS if e["name"] != "gat.attn"])
    assert reader.read(bare) is None
    bare.trace = None
    assert reader.read(bare) is None
    assert reader.read(_ctx(tmp_path, monkeypatch, STEPS, steps=0)) is None
