"""Device time a training step spends in its attention layers' forward:
over the profiled steps, the summed durations of the device ops whose
launch falls inside a ``gat.attn`` span (``_GatBandedLayer``'s forward in
``models/gat.py``), over those steps, in milliseconds.

The spans are taken from every thread of the trace, as the backward's
reader takes its own (``harness/spans.py`` keeps the window's thread
only); the ops are matched to their launches by correlation there.  A
program without the span reads None."""

import json
import os

from benchmark.harness import core
from benchmark.harness import spans

NAME = "gat.attn"


def forward_spans(path: str, start: float, end: float) -> list:
    """The ``gat.attn`` spans inside ``[start, end]`` on any thread of the
    Chrome trace at ``path``."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out = []
    for e in events:
        if (e.get("ph") == "X" and e.get("name") == NAME
                and e.get("cat") == "user_annotation"):
            s = spans.Span(NAME, float(e["ts"]),
                           float(e["ts"]) + float(e["dur"]))
            if start <= s.start and s.end <= end:
                out.append(s)
    return out


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    w = spans.of(ctx)
    if w is None or not steps:
        return None
    path = os.path.join(core.OUT_DIR, f"{ctx.cell.name}.trace.json")
    fwd = forward_spans(path, w.start, w.end)
    if not fwd:
        return None
    ops = w.launched_inside(fwd)
    return 1e-3 * sum(op.end - op.start for op in ops) / steps
