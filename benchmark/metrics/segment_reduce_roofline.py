"""The segment-reduce kernel's share of its roofline
(``csrc/segreduce.cu`` through ``ops/kernels/segreduce_kernel.py``), over
the profiled part: the bytes its launches need over its device time,
against the HBM rate.

Each launch of a query reduces one 4-byte value per edge of the graph
into one per vertex (a dense BFS round's frontier, the predecessors'
``min``, a PageRank round's ``sum``): it needs the values and the
``n + 1`` offsets read once and the ``n`` results written once."""

from benchmark.harness.peaks import roofline_share

KERNELS = ("segreduce_walk_kernel", "segreduce_fixup_kernel")


def counters() -> int:
    from mini_tpu_torch.ops.kernels import segreduce_kernel

    return segreduce_kernel.launches


def launch_bytes(n: int, m: int, value_bytes: int = 4) -> float:
    return float(value_bytes * m + 4 * (n + 1) + value_bytes * n)


def read(ctx):
    launches = ctx.counter_deltas.get("segment_reduce_roofline", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS) if ctx.trace else 0.0
    if not launches or not seconds:
        return None
    nbytes = launches * launch_bytes(ctx.shapes["n"], ctx.shapes["m"])
    return roofline_share(nbytes, 0.0, seconds)
