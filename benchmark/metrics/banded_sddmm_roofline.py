"""The banded SDDMM kernel's share of its roofline (``csrc/spmm_banded.cu``
through ``ops/spmm._weight_cotangent``), over the profiled steps: the
bytes the steps' SDDMMs need over the kernel's device time (both its
forms), against the HBM rate.

A GAT step's backward runs one SDDMM a layer, the weight cotangent
``<Q[dst], h[src]>`` per edge and head: it needs the ``m`` gathered
float32 source rows of ``H d`` columns and the ``n`` rows of ``Q`` read
once, and the ``[m, H]`` float32 result written once.  Counted at the
heads' own width ``H d``: a head's padding and the denominator's lane
are the program's layout, not the layer's need."""

from benchmark.harness.peaks import roofline_share

KERNELS = ("banded_sddmm_kernel", "banded_sddmm_scalar_kernel")


def step_bytes(n: int, m: int, dims, heads) -> float:
    return float(sum(4 * m * h * d + 4 * n * h * d + 4 * m * h
                     for d, h in zip(dims[1:], heads)))


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS) if ctx.trace else 0.0
    if not steps or not seconds or "heads" not in ctx.shapes:
        return None
    s = ctx.shapes
    return roofline_share(steps * step_bytes(s["n"], s["m"], s["dims"],
                                             s["heads"]), 0.0, seconds)
