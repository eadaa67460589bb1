"""Launches of kernel 2 a training step whose table has another row count
than its output, a relation graph's rectangular layout: the delta of
``mini_tpu_torch.ops.kernels.spmm_banded.bipartite_launches`` over the
profiled steps, over those steps.  A program without the counter reads
None."""

import importlib


def _kernel():
    return importlib.import_module("mini_tpu_torch.ops.kernels.spmm_banded")


def counters() -> int:
    return getattr(_kernel(), "bipartite_launches", 0)


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    if not steps or not hasattr(_kernel(), "bipartite_launches"):
        return None
    return ctx.counter_deltas.get("bipartite_sums_per_step.train",
                                  0) / steps
