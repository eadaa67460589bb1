"""The banded segment-sum kernel's share of its roofline in the GraphSAGE
step (``csrc/spmm_banded.cu`` through ``ops/spmm.py``), over the
profiled steps: the bytes the steps' aggregations need
(``tasks/sage_train.step_bytes``, counted as
``banded_segment_sum_roofline`` counts a GCN's, so the two compare) over
the same kernels' device time, against the HBM rate."""

from benchmark.harness.peaks import roofline_share
from benchmark.harness.registry import metric_reader

KERNELS = metric_reader("banded_segment_sum_roofline").KERNELS


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS) if ctx.trace else 0.0
    if not steps or not seconds:
        return None
    s = ctx.shapes
    return roofline_share(
        steps * ctx.task.step_bytes(s["n"], s["m"], s["dims"]), 0.0, seconds)
