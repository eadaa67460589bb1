"""The program's own spans in the profiled part's Chrome trace, beside the
device operations, for the readers of per-layer metrics that split the
part by what the program was doing.

The port marks its query rounds, reads and training-step phases with
``torch.profiler.record_function`` spans (``utils/profiling.scope``):
host events on the trace's clock, which the CUDA activity shares.  This
reopens the trace that ``trace.summarize`` reads and keeps, inside the
``bench.window`` span:

- the program's spans on the window's thread (the benchmark's own,
  ``bench.*``, left out);
- every device operation, with the host time of the launch that issued
  it: the ``cuda_runtime`` or ``cuda_driver`` event that carries the
  same ``args.correlation``, on whatever thread launched it (autograd
  launches the backward from a thread of its own);
- the device-idle gaps, as ``trace.summarize`` finds them.

A trace from a program without these spans gives a window with none, and
the readers then return None.  Times are microseconds on the trace's
clock.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import json
import os
import re

from benchmark.harness import core
from benchmark.harness import trace as tracing

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_ROUND = re.compile(r"\.round(\.|$)")


def is_query(name: str) -> bool:
    """A program span around one whole query (``bfs.query``,
    ``pagerank.query``)."""
    return name.endswith(".query")


def is_round(name: str) -> bool:
    """A program span around one round's launches (``bfs.round.<kind>``,
    ``pagerank.round``)."""
    return _ROUND.search(name) is not None


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start

    def holds(self, other) -> bool:
        return self.start <= other.start and other.end <= self.end


@dataclasses.dataclass(frozen=True)
class Op:
    """A device operation: its interval and its launch's host time (None
    when the trace holds no launch with its correlation)."""

    start: float
    end: float
    launched: float | None


@dataclasses.dataclass
class Window:
    start: float
    end: float
    spans: list  # the program's Spans on the window's thread, by start
    ops: list  # every device Op of the trace
    gaps: list  # (start, end) of the window's device-idle gaps

    def named(self, test) -> list:
        """The spans whose name passes ``test``."""
        return [s for s in self.spans if test(s.name)]

    def idle_inside(self, spans) -> float:
        """Device-idle time inside the union of ``spans``."""
        total, i, cover = 0.0, 0, _union(spans)
        for g0, g1 in self.gaps:  # both sorted and disjoint
            while i < len(cover) and cover[i][1] <= g0:
                i += 1
            j = i
            while j < len(cover) and cover[j][0] < g1:
                total += min(g1, cover[j][1]) - max(g0, cover[j][0])
                j += 1
        return total

    def launched_inside(self, spans) -> list:
        """The device ops whose launch falls inside one of ``spans``."""
        cover = _union(spans)
        starts = [lo for lo, _ in cover]

        def inside(t):
            k = bisect.bisect_right(starts, t) - 1
            return k >= 0 and t <= cover[k][1]

        return [op for op in self.ops
                if op.launched is not None and inside(op.launched)]


def _union(spans) -> list:
    """The union of ``spans``' intervals: sorted, disjoint ``(lo, hi)``."""
    out: list = []
    for s in sorted(spans, key=lambda s: s.start):
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return out


def load(path: str) -> Window | None:
    """The window of the Chrome trace at ``path``, or None when it holds
    no ``bench.window`` span."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == tracing.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    spans = sorted((Span(e["name"], float(e["ts"]),
                         float(e["ts"]) + float(e["dur"]))
                    for e in xs if e.get("cat") == "user_annotation"
                    and e.get("tid") == tid
                    and not e["name"].startswith("bench.")
                    and w0 <= float(e["ts"])
                    and float(e["ts"]) + float(e["dur"]) <= w1),
                   key=lambda s: s.start)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in xs
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    ops = [Op(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              launch.get(e.get("args", {}).get("correlation")))
           for e in xs if e.get("cat") in tracing.DEVICE_CATS]
    _, gaps = tracing._union_and_gaps(
        [(op.start, op.end) for op in ops if w0 <= op.start < w1], w0, w1)
    return Window(w0, w1, spans, ops, gaps)


def of(ctx) -> Window | None:
    """The window of this run's trace (``core.OUT_DIR/<cell>.trace.json``),
    or None when the run wrote none.  Parsed once for all the readers."""
    if ctx.trace is None:
        return None
    path = os.path.join(core.OUT_DIR, f"{ctx.cell.name}.trace.json")
    st = os.stat(path)
    return _cached(path, st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=1)
def _cached(path: str, mtime_ns: int, size: int) -> Window | None:
    return load(path)
