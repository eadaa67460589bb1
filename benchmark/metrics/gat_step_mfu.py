"""The whole GAT training step's share of the float32 peak (67 TFLOP/s;
the port pins TF32 off): the steps' model operations
(``tasks/gat_train.step_flops``: projections, their gradients and the
three passes over the edge stream a layer) over the unprofiled part's
host-clock seconds, which end with a synchronize."""

from benchmark.harness.peaks import F32_FLOPS_PER_S


def read(ctx):
    steps = ctx.unprofiled.get("items", 0)
    seconds = ctx.unprofiled.get("seconds", 0.0)
    if not steps or seconds <= 0 or "heads" not in ctx.shapes:
        return None
    s = ctx.shapes
    flops = steps * ctx.task.step_flops(s["n"], s["m"], s["dims"],
                                        s["heads"])
    return 100.0 * flops / seconds / F32_FLOPS_PER_S
