"""Launches of kernel 2 a training step that read their messages' rows of
the source table by the layout's ids, in place of gathered streams: the
delta of ``mini_tpu_torch.ops.kernels.spmm_banded.indexed_launches`` over
the profiled steps, over those steps.  Each aggregation of a step is one
such launch when no band is gathered for it; a program without the
counter reads None."""

import importlib


def _kernel():
    return importlib.import_module("mini_tpu_torch.ops.kernels.spmm_banded")


def counters() -> int:
    return getattr(_kernel(), "indexed_launches", 0)


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    if not steps or not hasattr(_kernel(), "indexed_launches"):
        return None
    return ctx.counter_deltas.get("indexed_sums_per_step.train", 0) / steps
