"""Device time a training step spends in its relations' forward work:
over the profiled steps, the summed durations of the device ops whose
launch falls inside an ``rgcn.relation`` span (each relation's mean and
its product in ``models/rgcn.py``), over those steps, in milliseconds.
A program without the span reads None."""

from benchmark.harness import spans


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    w = spans.of(ctx)
    if w is None or not steps:
        return None
    rel = w.named(lambda n: n == "rgcn.relation")
    if not rel:
        return None
    ops = w.launched_inside(rel)
    return 1e-3 * sum(op.end - op.start for op in ops) / steps
