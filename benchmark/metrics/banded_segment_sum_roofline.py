"""The banded segment-sum kernel's share of its roofline
(``csrc/spmm_banded.cu`` through ``ops/spmm.py``), over the profiled
steps: the bytes the steps' aggregations need over the kernel's device
time, against the HBM rate.

A GCN step aggregates each layer's ``[n, d_out]`` product over the ``m``
edges once forward and once, transposed, backward.  Each aggregation
needs its ``m`` float32 messages of ``d_out`` columns and its ``m`` edge
weights read once and its ``n`` output rows written once."""

from benchmark.harness.peaks import roofline_share

KERNELS = ("banded_segment_sum_kernel", "banded_fixup_kernel")


def step_bytes(n: int, m: int, dims) -> float:
    return float(sum(2 * (4 * m * f + 4 * m + 4 * n * f)
                     for f in dims[1:]))


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS) if ctx.trace else 0.0
    if not steps or not seconds:
        return None
    s = ctx.shapes
    return roofline_share(steps * step_bytes(s["n"], s["m"], s["dims"]),
                          0.0, seconds)
