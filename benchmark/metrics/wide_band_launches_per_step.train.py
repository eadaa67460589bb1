"""Launches of kernel 2 a training step whose layout has more than 128
bands, past what the kernel's stream form takes: the delta of
``mini_tpu_torch.ops.kernels.spmm_banded.wide_launches`` over the
profiled steps, over those steps.  A program without the counter reads
None."""

import importlib


def _kernel():
    return importlib.import_module("mini_tpu_torch.ops.kernels.spmm_banded")


def counters() -> int:
    return getattr(_kernel(), "wide_launches", 0)


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    if not steps or not hasattr(_kernel(), "wide_launches"):
        return None
    return ctx.counter_deltas.get("wide_band_launches_per_step.train",
                                  0) / steps
