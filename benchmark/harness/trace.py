"""The device trace of a short profiled sub-window, reduced to what the
per-layer readers and the result line's ``breakdown`` need.

``torch.profiler`` records host operations and CUDA activity; the trace
is exported as Chrome JSON (overwritten each run) and read back.  The
window is the host span ``bench.window`` that the driver opens around
the profiled items and closes after a synchronize.  Device operations are
the kernels, copies and sets launched inside it.  Busy time is the union
of their intervals, clipped to the window, so overlapping operations are
not counted twice.  Each idle gap is named by the innermost host
operation running at its midpoint on the thread that drove the window.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    n_ops: int
    op_seconds: dict  # device op's full name -> summed seconds
    gap_seconds: dict  # host activity -> summed idle seconds

    def kernel_seconds(self, names) -> float:
        """Summed seconds of the device ops whose name holds any of
        ``names`` (CUDA function names)."""
        return sum(s for op, s in self.op_seconds.items()
                   if any(k in op for k in names))

    def breakdown(self, top: int = 10) -> dict:
        def most(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        ops: dict = {}
        for k, v in self.op_seconds.items():
            ops[short_name(k)] = ops.get(short_name(k), 0.0) + v
        return {"device_ops": most(ops), "idle_gaps": most(self.gap_seconds)}


@contextlib.contextmanager
def profile(path: str):
    """Profile the block (host, and CUDA where there is a card) and write
    the Chrome trace to ``path``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)


def short_name(name: str) -> str:
    """A device op's name for the breakdown: without ``(anonymous
    namespace)::`` and its parameter list, at most 160 characters."""
    name = name.replace("(anonymous namespace)::", "")
    return (re.sub(r"\(.*$", "", name) or name)[:160]


def summarize(path: str) -> Summary | None:
    """The window's summary, or None when the trace holds no window."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    op_seconds: dict = {}
    for e in dev:
        k = e.get("name", "?")
        op_seconds[k] = op_seconds.get(k, 0.0) + float(e["dur"]) * 1e-6
    busy, gaps = _union_and_gaps(
        [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev],
        w0, w1)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "?")) for e in spans
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != WINDOW),
                  key=lambda h: (h[0], -h[1]))
    gap_seconds: dict = {}
    for (g0, g1), name in zip(gaps, _innermost(host, [(a + b) / 2
                                                      for a, b in gaps])):
        gap_seconds[name] = gap_seconds.get(name, 0.0) + (g1 - g0) * 1e-6
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                   n_ops=len(dev), op_seconds=op_seconds,
                   gap_seconds=gap_seconds)


def _union_and_gaps(intervals, w0: float, w1: float):
    """(length of the union of ``intervals`` clipped to ``[w0, w1]``, the
    idle gaps inside the window)."""
    busy, gaps, cur = 0.0, [], w0
    for a, b in sorted(intervals):
        a, b = max(a, w0), min(b, w1)
        if b <= cur:
            continue
        if a > cur:
            gaps.append((cur, a))
        busy += b - max(a, cur)
        cur = b
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps


def _innermost(host, points):
    """For each of the sorted ``points``, the name of the latest-starting
    host span that contains it (spans of one thread nest), or ``host
    idle``."""
    out, stack, i = [], [], 0
    starts = [h[0] for h in host]
    for p in points:
        j = bisect.bisect_right(starts, p)
        while i < j:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else "host idle")
    return out
