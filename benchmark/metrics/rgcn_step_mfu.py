"""The whole R-GCN training step's share of the float32 peak (67 TFLOP/s;
the port pins TF32 off): the steps' matrix products
(``tasks/rgcn_train.step_flops``: every root and relation product
forward, and the weight and input gradients the loss reaches) over the
unprofiled part's host-clock seconds, which end with a synchronize."""

from benchmark.harness.peaks import F32_FLOPS_PER_S


def read(ctx):
    steps = ctx.unprofiled.get("items", 0)
    seconds = ctx.unprofiled.get("seconds", 0.0)
    if not steps or seconds <= 0:
        return None
    flops = steps * ctx.task.step_flops(**ctx.shapes)
    return 100.0 * flops / seconds / F32_FLOPS_PER_S
