"""Banded aggregations a training step that re-band their edge weights,
because no pre-banded weights fit their layout: the delta of
``mini_tpu_torch.ops.spmm.rebanded`` over the profiled steps, over those
steps.  A program without the counter reads None."""

import importlib


def _spmm():
    # the module: ``mini_tpu_torch.ops`` exports the function by its name
    return importlib.import_module("mini_tpu_torch.ops.spmm")


def counters() -> int:
    return getattr(_spmm(), "rebanded", 0)


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    if not steps or not hasattr(_spmm(), "rebanded"):
        return None
    return ctx.counter_deltas.get("rebands_per_step.train", 0) / steps
