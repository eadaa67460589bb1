"""The whole query's share of the chip's roofline: what the unprofiled
part's queries need (the task's ``work``: bytes and operations) over its
host-clock seconds.  Graph queries are bound by bytes, so this is in
effect the share of the HBM rate that the queries' needed traffic
reaches."""

from benchmark.harness.peaks import roofline_share


def read(ctx):
    log = ctx.unprofiled
    if not log.get("latencies") or not hasattr(ctx.task, "work"):
        return None
    nbytes, flops = ctx.task.work(ctx.inputs, ctx.cell,
                                  list(zip(log["args"], log["rounds"])))
    return roofline_share(nbytes, flops, log["seconds"])
