"""Device time a training step spends in its forward aggregations: over
the profiled steps, the summed durations of the device ops whose launch
falls inside a ``sage.aggregate`` span (each layer's mean in
``models/sage.py``), over those steps, in milliseconds.  A program
without the span reads None."""

from benchmark.harness import spans


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    w = spans.of(ctx)
    if w is None or not steps:
        return None
    agg = w.named(lambda n: n == "sage.aggregate")
    if not agg:
        return None
    ops = w.launched_inside(agg)
    return 1e-3 * sum(op.end - op.start for op in ops) / steps
