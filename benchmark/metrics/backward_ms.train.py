"""Device time a training step spends on its backward pass: over the
profiled steps, the summed durations of the device ops whose launch falls
inside a ``step.backward`` span, over those spans, in milliseconds.
Attributed by the launch's time, not its thread: ``torch.autograd.grad``
launches from autograd's own thread while the span stays on the
caller's."""

from benchmark.harness import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None:
        return None
    backward = w.named(lambda n: n == "step.backward")
    if not backward:
        return None
    ops = w.launched_inside(backward)
    return 1e-3 * sum(op.end - op.start for op in ops) / len(backward)
