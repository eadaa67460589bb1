"""The whole training step's share of the float32 peak (67 TFLOP/s; the
port pins TF32 off): the steps' model operations
(``tasks/gcn_train.step_flops``) over the unprofiled part's host-clock
seconds, which end with a synchronize."""

from benchmark.harness.peaks import F32_FLOPS_PER_S


def read(ctx):
    steps = ctx.unprofiled.get("items", 0)
    seconds = ctx.unprofiled.get("seconds", 0.0)
    if not steps or seconds <= 0:
        return None
    s = ctx.shapes
    flops = steps * ctx.task.step_flops(s["n"], s["m"], s["dims"])
    return 100.0 * flops / seconds / F32_FLOPS_PER_S
