"""The banded segment-sum kernel's share of its roofline in the R-GCN
step (``csrc/spmm_banded.cu`` through ``ops/spmm.py``, on each relation's
rectangular layouts), over the profiled steps: the bytes the steps'
relation means need (``tasks/rgcn_train.step_bytes``: ``4 m F + 8 m + 4
rows F`` a mean, the forward of every relation and the backward of those
the loss reaches) over the same kernels' device time, against the HBM
rate."""

from benchmark.harness.peaks import roofline_share
from benchmark.harness.registry import metric_reader

KERNELS = metric_reader("banded_segment_sum_roofline").KERNELS


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS) if ctx.trace else 0.0
    if not steps or not seconds:
        return None
    return roofline_share(steps * ctx.task.step_bytes(**ctx.shapes), 0.0,
                          seconds)
